// Fused fftshift, mask, argmax and centroid on raw correlation surfaces, for
// Hopper (sm_90a), each surface split over several thread blocks.
//
// Replaces the TPU kernel mrs_optic_flow_tpu/ops/pallas_kernels.py::
// peak_refine_raw_pallas (kernel body _peak_kernel, math
// _masked_peak_centroid).  What it computes is in peak_refine.cuh, whose
// reduction and centroid code it shares with kernels D and E.
//
// What bounds it on this card: device-memory bandwidth, one read of each
// surface (921.6 KB for the scale/rotation surface, N = 480: 0.28 us at
// 3.35 TB/s) and a few integer operations per element.  One block a surface,
// as before, left the scale/rotation surface to one of the 132 SMs.  Now:
//  - k blocks a surface (ops/cuda_kernels.py::peak_split picks k so that
//    P * k is about two blocks an SM, k = 1 once P alone is that many), each
//    a band of the window's raw rows: 240 blocks of 2 rows at P = 1, N = 480.
//  - Only the search window is read.  Its raw rows and columns are two runs,
//    0 .. hi and lo .. n - 1, so a block walks rows and chunks of columns
//    (4 columns, one float4 load, where n % 4 == 0; else 1) with no division
//    per element.  The masked entries all read as 0, and the smallest masked
//    shifted index is 0 (shifted (0, 0) is masked whenever n / 2 exceeds the
//    radius), so the candidate (0.0, 0) stands in for all of them.
//  - A merge that cannot depend on order.  Each block reduces its (value,
//    shifted index) candidate, a total order, and its NaN flag, and stores
//    them in the scratch the wrapper passes; the last block of a surface to
//    arrive, by an atomic counter it resets, merges the k candidates and runs
//    the centroid warp.
//
// Numerics: float32, IEEE division (built without --use_fast_math); the
// centroid code is kernel D's and E's, so the shifts keep its float order.
//
// Plain C interface, loaded with ctypes.  The kernel allocates nothing; the
// caller passes the outputs, the scratch, the counters (zero before the first
// launch, left zero by every launch) and the stream.

#include "peak_refine.cuh"

namespace {

constexpr int kSplitThreads = 256;

template <int V>
__global__ void __launch_bounds__(kSplitThreads)
    peak_split_kernel(const float* __restrict__ surf_g, int n, int search_radius,
                      int centroid_radius, int k, int band_rows, float* __restrict__ part_val,
                      int* __restrict__ part_idx, int* __restrict__ part_nan,
                      unsigned* __restrict__ counters, float* __restrict__ shift_out,
                      float* __restrict__ maxval_out, int* __restrict__ index_out) {
  __shared__ int is_last;
  const int p = blockIdx.x / k;
  const int b = blockIdx.x - p * k;
  const float* __restrict__ surf = surf_g + static_cast<size_t>(p) * n * n;
  const int half = n / 2;
  // the window's raw rows (and columns) are 0 .. hi and lo .. n - 1
  const bool masked = half > search_radius;
  const int hi = masked ? search_radius : n - 1;
  const int lo = masked ? n - search_radius : n;
  const int rows = masked ? 2 * search_radius + 1 : n;
  const int n_a = hi / V + 1;                // chunks meeting 0 .. hi
  const int c_b = n_a > lo / V ? n_a : lo / V;  // first chunk of lo .. n - 1 not among them
  const int chunks = n_a + n / V - c_b;

  float best = masked ? 0.0f : -INFINITY;
  int best_s = masked ? 0 : n * n;
  int has_nan = 0;
  const int v0 = b * band_rows;
  const int v1 = rows < v0 + band_rows ? rows : v0 + band_rows;
  // thread t takes items t, t + blockDim.x, ... of the band's rows x chunks
  int vr = v0 + threadIdx.x / chunks;
  int cc = threadIdx.x % chunks;
  const int step_r = blockDim.x / chunks;
  const int step_c = blockDim.x - step_r * chunks;
  while (vr < v1) {
    const int y = vr <= hi ? vr : vr + lo - hi - 1;
    const int sy = y + half < n ? y + half : y + half - n;
    const int x0 = (cc < n_a ? cc : cc - n_a + c_b) * V;
    float vals[V];
    if constexpr (V == 4) {
      const float4 f = *reinterpret_cast<const float4*>(surf + y * n + x0);
      vals[0] = f.x;
      vals[1] = f.y;
      vals[2] = f.z;
      vals[3] = f.w;
    } else {
      vals[0] = surf[y * n + x0];
    }
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const int x = x0 + t;
      if (x > hi && x < lo) continue;
      const float v = vals[t];
      if (v != v) {
        has_nan = 1;
      } else {
        const int s = sy * n + (x + half < n ? x + half : x + half - n);
        if (peak::better(v, s, best, best_s)) {
          best = v;
          best_s = s;
        }
      }
    }
    cc += step_c;
    vr += step_r;
    if (cc >= chunks) {
      cc -= chunks;
      ++vr;
    }
  }
  peak::block_argmax(best, best_s, has_nan);

  if (threadIdx.x == 0) {
    part_val[blockIdx.x] = best;
    part_idx[blockIdx.x] = best_s;
    part_nan[blockIdx.x] = has_nan;
    __threadfence();
    is_last = atomicAdd(counters + p, 1u) == static_cast<unsigned>(k - 1);
  }
  __syncthreads();
  if (!is_last || threadIdx.x >= 32) return;
  __threadfence();
  best = -INFINITY;
  best_s = n * n;
  has_nan = 0;
  for (int j = threadIdx.x; j < k; j += 32) {
    const float v = __ldcg(part_val + p * k + j);
    const int s = __ldcg(part_idx + p * k + j);
    has_nan |= __ldcg(part_nan + p * k + j);
    if (peak::better(v, s, best, best_s)) {
      best = v;
      best_s = s;
    }
  }
  peak::warp_argmax(best, best_s);
  has_nan = __any_sync(peak::kFull, has_nan);
  best = __shfl_sync(peak::kFull, best, 0);
  best_s = __shfl_sync(peak::kFull, best_s, 0);
  if (threadIdx.x == 0) counters[p] = 0u;
  peak::centroid_store(surf, n, search_radius, centroid_radius, best, best_s, has_nan, p,
                       shift_out, maxval_out, index_out);
}

}  // namespace

extern "C" {

// Launch on `stream` over `p` surfaces of n x n float32, k blocks a surface,
// each `band_rows` of the window's rows (k * band_rows covers them); vec != 0
// reads 4 columns at a time (n % 4 == 0, 16-byte aligned surfaces).  Scratch:
// p * k floats, then 2 p k ints; counters: p unsigned, zero on entry.
// `index` may be null; when given it receives the peak's fftshifted flat
// index.  Returns the CUDA error code of the launch (0 on success).
int prr_peak_refine_split(const void* surf, int p, int n, int search_radius, int centroid_radius,
                          int k, int band_rows, int vec, void* scratch, void* counters, void* shift,
                          void* maxval, void* index, void* stream) {
  const int rows = n / 2 > search_radius ? 2 * search_radius + 1 : n;
  if (k < 1 || band_rows < 1 || static_cast<long long>(k) * band_rows < rows ||
      (vec && n % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* part_val = static_cast<float*>(scratch);
  auto* part_idx = reinterpret_cast<int*>(part_val + static_cast<size_t>(p) * k);
  auto* part_nan = part_idx + static_cast<size_t>(p) * k;
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(p) * k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const float*>(surf);
  auto* c = static_cast<unsigned*>(counters);
  auto* sh = static_cast<float*>(shift);
  auto* mv = static_cast<float*>(maxval);
  auto* ix = static_cast<int*>(index);
  if (vec)
    peak_split_kernel<4><<<blocks, kSplitThreads, 0, st>>>(
        s, n, search_radius, centroid_radius, k, band_rows, part_val, part_idx, part_nan, c, sh,
        mv, ix);
  else
    peak_split_kernel<1><<<blocks, kSplitThreads, 0, st>>>(
        s, n, search_radius, centroid_radius, k, band_rows, part_val, part_idx, part_nan, c, sh,
        mv, ix);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
