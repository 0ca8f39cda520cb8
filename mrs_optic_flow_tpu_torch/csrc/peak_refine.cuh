// Peak stage on raw correlation surfaces: the device code of kernel B
// (peak_refine_raw.cu), shared with kernels D and E
// (phase_correlate_fullfused.cu, phase_correlate_fused.cu), which run it on
// the surfaces they leave in their scratch.
//
// For each [N, N] surface as the inverse DFT left it (zero shift at (0, 0),
// not fftshifted): the fftshift as an index offset (raw index i sits at
// shifted index (i + N/2) mod N), the zeroing of every entry beyond
// search_radius from the centre on either axis, the argmax over the whole
// masked surface (masked entries take part as zeros) with ties broken on the
// smaller fftshifted flat index, and the positive-only weighted centroid over
// the (2 * centroid_radius + 1)^2 window around the peak, clamped to the
// surface in shifted coordinates without wrap-around, with an FLT_EPSILON-
// seeded denominator.  The result is relative to the centre (N/2, N/2).  NaN
// anywhere inside the search window gives NaN maxval and NaN shifts; NaN
// outside it is masked to 0.  Kernel B and the staged designs of kernels D
// and E split each surface over several blocks (peak_split_kernel, launched
// by launch_split: k blocks a surface, as the wrapper's peak_split picks
// them); the one-block designs of D and E read their surface from shared
// memory (window_peak).

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace peak {

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFltEpsilon = 1.1920928955078125e-07f;  // FLT_EPSILON

// (value, shifted flat index) candidate: larger value wins, ties go to the
// smaller index.  NaN values never enter; they are counted in a flag.
__device__ __forceinline__ bool better(float v, int s, float bv, int bs) {
  return v > bv || (v == bv && s < bs);
}

__device__ __forceinline__ void warp_argmax(float& best, int& best_s) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, best, off);
    const int os = __shfl_down_sync(kFull, best_s, off);
    if (better(ov, os, best, best_s)) {
      best = ov;
      best_s = os;
    }
  }
}

// Reduce every thread's (value, shifted index) candidate and NaN flag over
// the block.  On return every lane of warp 0 holds the block's candidate and
// flag; the other warps' values are undefined.
__device__ __forceinline__ void block_argmax(float& best, int& best_s, int& has_nan) {
  __shared__ float warp_best[32];
  __shared__ int warp_s[32];
  __shared__ int warp_nan[32];
  warp_argmax(best, best_s);
  has_nan = __any_sync(kFull, has_nan);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  if (lane == 0) {
    warp_best[warp] = best;
    warp_s[warp] = best_s;
    warp_nan[warp] = has_nan;
  }
  __syncthreads();
  if (warp != 0) return;
  best = lane < n_warps ? warp_best[lane] : -INFINITY;
  best_s = lane < n_warps ? warp_s[lane] : 0x7fffffff;
  has_nan = __any_sync(kFull, lane < n_warps && warp_nan[lane]);
  warp_argmax(best, best_s);
  best = __shfl_sync(kFull, best, 0);
  best_s = __shfl_sync(kFull, best_s, 0);
}

// One warp, every lane holding surface p's peak (value, shifted index) and
// NaN flag: the positive-only weighted centroid around the peak, in shifted
// coordinates, one window entry per lane, then shift_out[2 p .. 2 p + 1],
// maxval_out[p] and, when index_out is not null, the peak's fftshifted flat
// index.
// `read(y, x)` gives the raw surface entry at raw row y, column x.
template <class Read>
__device__ __forceinline__ void centroid_store(Read read, int n, int search_radius,
                                               int centroid_radius, float best, int best_s,
                                               int has_nan, int p, float* __restrict__ shift_out,
                                               float* __restrict__ maxval_out,
                                               int* __restrict__ index_out) {
  const int lane = threadIdx.x % 32;
  const int half = n / 2;
  const int yc = best_s / n;
  const int xc = best_s - yc * n;
  const int win = 2 * centroid_radius + 1;
  float sw = 0.0f, swx = 0.0f, swy = 0.0f;
  for (int e = lane; e < win * win; e += 32) {
    const int sy = yc - centroid_radius + e / win;
    const int sx = xc - centroid_radius + e % win;
    if (sy < 0 || sy >= n || sx < 0 || sx >= n) continue;
    if (abs(sy - half) > search_radius || abs(sx - half) > search_radius) continue;
    const int y = sy >= half ? sy - half : sy + n - half;
    const int x = sx >= half ? sx - half : sx + n - half;
    const float v = read(y, x);
    if (v > 0.0f) {
      sw += v;
      swx += v * static_cast<float>(sx);
      swy += v * static_cast<float>(sy);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    sw += __shfl_xor_sync(kFull, sw, off);
    swx += __shfl_xor_sync(kFull, swx, off);
    swy += __shfl_xor_sync(kFull, swy, off);
  }
  if (lane != 0) return;
  const float denom = sw + kFltEpsilon;
  float cx = swx / denom - static_cast<float>(half);
  float cy = swy / denom - static_cast<float>(half);
  if (has_nan) {
    best = cx = cy = __int_as_float(0x7fc00000);  // quiet NaN
  }
  shift_out[2 * p] = cx;
  shift_out[2 * p + 1] = cy;
  maxval_out[p] = best;
  if (index_out != nullptr) index_out[p] = best_s;
}

// centroid_store on a row-major [n, n] surface in device memory
__device__ __forceinline__ void centroid_store(const float* __restrict__ surf, int n,
                                               int search_radius, int centroid_radius,
                                               float best, int best_s, int has_nan, int p,
                                               float* __restrict__ shift_out,
                                               float* __restrict__ maxval_out,
                                               int* __restrict__ index_out) {
  centroid_store([surf, n](int y, int x) { return surf[y * n + x]; }, n, search_radius,
                 centroid_radius, best, best_s, has_nan, p, shift_out, maxval_out, index_out);
}

// Rows (and columns) of an n x n surface inside the search window.
__host__ __device__ inline int window_rows(int n, int search_radius) {
  return n / 2 > search_radius ? 2 * search_radius + 1 : n;
}

// The raw row (or column) of window row v: the window's raw rows are the
// two runs 0 .. hi and lo .. n - 1 (hi = search_radius, lo = n -
// search_radius while n / 2 exceeds the radius, else one run 0 .. n - 1).
__host__ __device__ inline int window_raw(int v, int n, int search_radius) {
  return n / 2 > search_radius && v > search_radius ? v + n - 2 * search_radius - 1 : v;
}

// One block, every thread calling: the peak of a surface whose entry (y,
// x) is read(y, x), reading only the search window's raw rows and columns,
// one warp a window row; the masked entries stand as one seed candidate
// (0.0, shifted index 0) whenever n / 2 exceeds the radius.  Then the
// block's argmax and the centroid warp, which stores pair p's result.
template <class Read>
__device__ void window_peak(Read read, int n, int search_radius, int centroid_radius, int p,
                            float* __restrict__ shift_out, float* __restrict__ maxval_out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const int half = n / 2;
  const bool masked = half > search_radius;
  const int rows = window_rows(n, search_radius);
  float best = masked ? 0.0f : -INFINITY;
  int best_s = masked ? 0 : n * n;
  int has_nan = 0;
  for (int vr = warp; vr < rows; vr += warps) {
    const int y = window_raw(vr, n, search_radius);
    const int sy = y + half < n ? y + half : y + half - n;
    for (int vc = lane; vc < rows; vc += 32) {
      const int x = window_raw(vc, n, search_radius);
      const int sx = x + half < n ? x + half : x + half - n;
      const float v = read(y, x);
      if (v != v) {
        has_nan = 1;
      } else if (better(v, sy * n + sx, best, best_s)) {
        best = v;
        best_s = sy * n + sx;
      }
    }
  }
  block_argmax(best, best_s, has_nan);
  if (threadIdx.x >= 32) return;
  centroid_store(read, n, search_radius, centroid_radius, best, best_s, has_nan, p, shift_out,
                 maxval_out, nullptr);
}

// Whether k blocks of band_rows window rows each cover the window of an
// n x n surface, no block empty: the split that the wrappers of kernels B
// and D pass (ops/cuda_kernels.py::peak_split picks it).
__host__ __device__ inline bool valid_split(int n, int search_radius, int k, int band_rows) {
  const int rows = window_rows(n, search_radius);
  return k >= 1 && band_rows >= 1 && static_cast<long long>(k) * band_rows >= rows &&
         static_cast<long long>(k - 1) * band_rows < rows;
}

// Surface p = blockIdx.x / k (at surf_g + p * stride, [n, n] row-major), band
// b = blockIdx.x % k of its window rows: each block reduces its band's
// (value, shifted index) candidate and NaN flag into the part arrays, and the
// last block of a surface to arrive (an atomic counter it resets) merges the
// k candidates and runs the centroid warp.  V = 4 reads float4 columns
// (n % 4 == 0, 16-byte aligned surfaces), else 1.
constexpr int kSplitThreads = 256;

template <int V>
__global__ void __launch_bounds__(kSplitThreads)
    peak_split_kernel(const float* __restrict__ surf_g, size_t stride, int n, int search_radius,
                      int centroid_radius, int k, int band_rows, float* __restrict__ part_val,
                      int* __restrict__ part_idx, int* __restrict__ part_nan,
                      unsigned* __restrict__ counters, float* __restrict__ shift_out,
                      float* __restrict__ maxval_out, int* __restrict__ index_out) {
  __shared__ int is_last;
  const int p = blockIdx.x / k;
  const int b = blockIdx.x - p * k;
  const float* __restrict__ surf = surf_g + static_cast<size_t>(p) * stride;
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
        if (better(v, s, best, best_s)) {
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
  block_argmax(best, best_s, has_nan);

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
    if (better(v, s, best, best_s)) {
      best = v;
      best_s = s;
    }
  }
  warp_argmax(best, best_s);
  has_nan = __any_sync(kFull, has_nan);
  best = __shfl_sync(kFull, best, 0);
  best_s = __shfl_sync(kFull, best_s, 0);
  if (threadIdx.x == 0) counters[p] = 0u;
  centroid_store(surf, n, search_radius, centroid_radius, best, best_s, has_nan, p,
                       shift_out, maxval_out, index_out);
}

// Launch peak_split_kernel on `stream` over p surfaces `stride` floats
// apart, k blocks a surface of band_rows window rows each; vec reads 4
// columns at a time (n % 4 == 0, stride % 4 == 0, 16-byte aligned surf).
// The part arrays hold p * k entries each; the p counters are zero on entry
// and left zero.  Kernel B and the staged designs of D and E all launch it
// here.  Returns the launch's CUDA error code.
inline cudaError_t launch_split(const float* surf, size_t stride, int p, int n, int search_radius,
                                int centroid_radius, int k, int band_rows, bool vec,
                                float* part_val, int* part_idx, int* part_nan, unsigned* counters,
                                float* shift, float* maxval, int* index, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(p) * k);
  if (vec)
    peak_split_kernel<4><<<blocks, kSplitThreads, 0, stream>>>(
        surf, stride, n, search_radius, centroid_radius, k, band_rows, part_val, part_idx, part_nan,
        counters, shift, maxval, index);
  else
    peak_split_kernel<1><<<blocks, kSplitThreads, 0, stream>>>(
        surf, stride, n, search_radius, centroid_radius, k, band_rows, part_val, part_idx, part_nan,
        counters, shift, maxval, index);
  return cudaGetLastError();
}


}  // namespace peak
