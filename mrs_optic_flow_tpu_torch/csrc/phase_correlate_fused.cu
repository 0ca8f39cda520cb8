// Cross-power, full complex inverse FFT and peak of given forward spectra,
// for Hopper (sm_90a), any patch size n whose prime factors fit the FFT
// plan: kernel E.
//
// Replaces the TPU kernel mrs_optic_flow_tpu/ops/pallas_kernels.py::
// phase_correlate_fused_pallas (kernel _fused_kernel, peak stage
// _masked_peak_centroid).  The forward spectra come from the caller: the
// wrapper (ops/cuda_kernels.py::phase_correlate_fused) stacks the p curr and
// the p prev patches into one float32 matrix X [n, 2p, n], row y of patch b
// at X[y, b] (pcfu_stack below, uint8 converted exactly), and makes two
// float32 matrix products, as the JAX package left the forward transform to
// XLA.  The patches are real, so the row transform T = X W is Hermitian in
// kx and its columns kx <= n/2 carry it all: T = X [Ch | Sh] ([n * 2p, n]
// by [n, 2h], Ch and Sh the first n/2 + 1 columns of C and S, zero-padded
// to h = half_cols(n), an even count), then G = [C ; S] T ([2n, n] by
// [n, 2p * 2h]), half the operations of the full products.  Patch b's
// blocks are G00 = C Tr, G01 = C Ti, G10 = S Tr and G11 = S Ti (row ky or
// n + ky, columns 2 h b + kx or + h); its spectrum is F = (G00 - G11) +
// i (G01 + G10) for kx <= n/2, the products and sums of the JAX package's
// _dft2_real, and F(ky, kx) = conj F(-ky, -kx) beyond.  From those, for
// every pair, this kernel computes what _fused_kernel computes:
// the normalized cross-power R = F1 * conj(F2) * rsqrt(|F1 * conj(F2)|^2 +
// FLT_EPSILON), the full complex inverse Re(conj(W) R conj(W)) / n^2 (no
// Hermitian shortcut: R is Hermitian only up to the products' rounding), and
// kernel B's peak (peak_refine.cuh): fftshift and +-search_radius mask in
// index space, argmax with ties on the minimum fftshifted flat index, the
// positive-only centroid; NaN in the search window gives NaN.
//
// What bounds it on this card: after the forward products (outside), an
// inverse FFT of 5 n^2 log2(n^2) operations a pair, a few tenths of a
// microsecond of the card's float32 rate at n = 120, so the passes over
// shared memory and the launches do.  The design before this one ran the
// inverse as two direct O(n^3) DFTs (tiled products on the CUDA cores)
// through four launches a chunk.  Now the inverse is the mixed-radix FFT
// of fft_stages.cuh (kernel D's stages), in one of two designs by kernel D's
// route rule (fft::small_route):
//
// Small n (n <= 170), one launch, one block a pair, the pair's R in one
// n x n complex buffer of shared memory:
//   1. load: R(ky, kx) from the pair's eight words of G, written at
//      (perm(ky), perm(kx)), the order the inverse stages take; each thread
//      issues the loads of kLoad frequencies before it uses any;
//   2. the inverse FFT of every row, then of every column (natural order
//      out);
//   3. the peak of Re / n^2 over the search window's rows and columns only
//      (peak::window_peak, kernel D's tail).
//   n = 120, the size of the conformance diff, has a kernel with its plan
//   known to the compiler; other n read the plan at run time.
//
// Large n, staged through a scratch in device memory that the caller sizes
// to stay in the 50 MB L2 cache, three launches a chunk:
//   1. rows_inverse: R of `lines` rows, the inverse row FFTs, and the
//      window's columns only into U [n, wc] (wc = the window's width), row
//      perm(ky); it also zeroes the counters of 3;
//   2. cols_inverse: a band of U's columns, all n rows: the inverse column
//      FFTs, Re / n^2 of the window's rows into the surface [n, n];
//   3. kernel B's split peak (peak::launch_split), each surface over the k
//      blocks of band_rows window rows that the caller passes
//      (ops/cuda_kernels.py::peak_split), reading only the window.
//
// Numerics: float32 throughout, IEEE division and square roots (built
// without --use_fast_math); rsqrtf for the cross-power normalization.  The
// kernel's sums run in a fixed order; the library's forward products may
// sum in another for another batch size, so a pair's result can move in its
// last bits with the batch around it.
//
// Plain C interface, loaded with ctypes.  The kernels allocate nothing; the
// caller passes the scratch, the output buffers and the stream.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "fft_stages.cuh"
#include "peak_refine.cuh"

namespace {

constexpr int kThreads = fft::kThreads;  // a block of the staged passes and of pcfu_stack
constexpr int kSmallThreads = 512;       // a block of the one-block design
constexpr int kStackBlocks = 1024;       // blocks of pcfu_stack, at most
constexpr int kLoad = 4;                 // frequencies a thread loads at once

// Columns of a patch's half spectrum in G: n/2 + 1, rounded up to even so
// that every block of G starts 16-byte aligned.
__host__ __device__ inline int half_cols(int n) { return (n / 2 + 2) & ~1; }

__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// X[y, b, x] = patch b (curr 0 .. p - 1, then prev) at (y, x), as float32
template <typename T>
__global__ void __launch_bounds__(kThreads)
    stack_kernel(const T* __restrict__ curr, const T* __restrict__ prev, int p, int n,
                 float* __restrict__ out) {
  const size_t mat = static_cast<size_t>(n) * n, count = p * mat;
  for (size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; e < count;
       e += static_cast<size_t>(gridDim.x) * kThreads) {
    const size_t q = e / mat, r = e - q * mat, y = r / n, x = r - y * n;
    float* row = out + (y * 2 * p + q) * n + x;
    row[0] = to_f32(curr[e]);
    row[static_cast<size_t>(p) * n] = to_f32(prev[e]);
  }
}

// The eight words of G that give pair q's two spectra at (ky, kx): G00,
// G01, G10 and G11 of patches q (curr) and p + q (prev) at (ky, kx), or at
// (-ky, -kx) beyond kx = n/2 (then conj).
struct Bin {
  float w[8];
  bool conj;
};

__device__ __forceinline__ Bin load_bin(const float* __restrict__ g, int p, int n, int q, int ky,
                                        int kx) {
  const int h = half_cols(n);
  const size_t pitch = 4 * static_cast<size_t>(p) * h;  // floats of a row of G
  Bin b;
  b.conj = 2 * kx > n;
  if (b.conj) {
    ky = ky ? n - ky : 0;
    kx = n - kx;
  }
  const float* g1 = g + ky * pitch + 2 * static_cast<size_t>(q) * h + kx;
  const float* g2 = g1 + 2 * static_cast<size_t>(p) * h;
  const size_t g10 = n * pitch;  // from G00; G01 at h, G11 at g10 + h
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float* gs = s ? g2 : g1;
    b.w[4 * s] = __ldg(gs);
    b.w[4 * s + 1] = __ldg(gs + h);
    b.w[4 * s + 2] = __ldg(gs + g10);
    b.w[4 * s + 3] = __ldg(gs + g10 + h);
  }
  return b;
}

// R of one bin: F = (G00 - G11) + i (G01 + G10) of each patch
__device__ __forceinline__ float2 cross_power_of(const Bin& b) {
  const float2 r = fft::cross_power(make_float2(b.w[0] - b.w[3], b.w[1] + b.w[2]),
                                    make_float2(b.w[4] - b.w[7], b.w[5] + b.w[6]));
  return b.conj ? fft::conj(r) : r;
}

// The cross-power of `count` rows (ky = row0 + i) of pair q into buf, row
// i at buf + i * n, column perm(kx); row i's offset is rows[i] when rows is
// given (perm(row0 + i)), else i.  kLoad frequencies a thread in flight.
template <typename I>
__device__ __forceinline__ void load_cross_power(float2* __restrict__ buf, const I* __restrict__ pm,
                                                 const I* __restrict__ rows, const float* g, int p,
                                                 int n, int q, int row0, int count) {
  const int total = count * n;
  for (int e0 = threadIdx.x; e0 < total; e0 += kLoad * blockDim.x) {
    Bin b[kLoad];
#pragma unroll
    for (int i = 0; i < kLoad; ++i) {
      const int e = e0 + i * blockDim.x;
      const int r = e / n;
      if (e < total) b[i] = load_bin(g, p, n, q, row0 + r, e - r * n);
    }
#pragma unroll
    for (int i = 0; i < kLoad; ++i) {
      const int e = e0 + i * blockDim.x;
      const int r = e / n;
      if (e < total) buf[(rows ? rows[r] : r) * n + pm[e - r * n]] = cross_power_of(b[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// small n: one block a pair
// ---------------------------------------------------------------------------

// N > 0: the kernel for patch size N alone, every size and index division
// known to the compiler; N = 0: any n up to fft::kSmallMaxW, from `plan`.
template <int N>
__global__ void __launch_bounds__(kSmallThreads)
    small_kernel(const float* __restrict__ g, int p, fft::Plan plan, int search_radius,
                 int centroid_radius, const float2* __restrict__ tab, float* __restrict__ shift_out,
                 float* __restrict__ maxval_out) {
  extern __shared__ float2 buf[];          // [n, n]: R in perm order, then the inverse
  __shared__ short pm[fft::kSmallMaxW];    // perm of the plan
  const int n = N > 0 ? N : plan.n;
  fft::fill_perm(pm, plan);
  __syncthreads();
  // 1. the cross-power, R(ky, kx) at (perm(ky), perm(kx))
  load_cross_power(buf, pm, pm, g, p, n, blockIdx.x, 0, n);
  __syncthreads();
  // 2. inverse rows, then columns (each stage ends with a barrier)
  fft::inverse<N>(buf, n, n, 1, plan, tab);
  fft::inverse<N>(buf, n, 1, n, plan, tab);
  // 3. the peak of the real part, scaled
  const float scale = 1.0f / static_cast<float>(n * n);
  const float2* sb = buf;
  peak::window_peak([sb, scale, n](int y, int x) { return sb[y * n + x].x * scale; }, n,
                    search_radius, centroid_radius, blockIdx.x, shift_out, maxval_out);
}

// ---------------------------------------------------------------------------
// large n: three launches a chunk through the scratch
// ---------------------------------------------------------------------------

// scratch of a chunk of c pairs: U [c, n, wc] float2 (room for wc = n), the
// surfaces [c, n, n] float, then the peak's part values, indices, NaN flags
// (c * n each at most) and c counters.  The widest type comes first, so
// every array is aligned to its type for any c and n (U 8 bytes, each
// surface 16 where n % 4 == 0).
struct Layout {
  int wc;  // the search window's width, peak::window_rows
  float2* u;
  float* surf;
  float* part_val;
  int* part_idx;
  int* part_nan;
  unsigned* counters;
};

Layout layout(void* scratch, int c, int n, int search_radius) {
  const size_t mat = static_cast<size_t>(n) * n;
  Layout l;
  l.wc = peak::window_rows(n, search_radius);
  l.u = static_cast<float2*>(scratch);
  l.surf = reinterpret_cast<float*>(l.u + c * mat);
  l.part_val = l.surf + c * mat;
  l.part_idx = reinterpret_cast<int*>(l.part_val + static_cast<size_t>(c) * n);
  l.part_nan = l.part_idx + static_cast<size_t>(c) * n;
  l.counters = reinterpret_cast<unsigned*>(l.part_nan + static_cast<size_t>(c) * n);
  return l;
}

__host__ __device__ inline int row_lines(int n) { return fft::pass_lines(8LL * n + 4, fft::kLines); }
__host__ __device__ inline int col_band(int n) { return fft::pass_lines(8LL * n, fft::kBand); }

// 1. rows first .. first + lines - 1 (ky) of pair p0 + blockIdx.y of p:
// the cross-power in perm order, the inverse row FFTs, the window's columns
// into U's row perm(ky).  Block (0, 0) zeroes the c counters of 3.
__global__ void __launch_bounds__(kThreads)
    rows_inverse(const float* __restrict__ g, int p, int p0, fft::Plan plan, int lines,
                 int search_radius, const float2* __restrict__ tab, Layout lay, int c) {
  extern __shared__ float2 buf[];  // [lines, n], then the perm table
  const int n = plan.n;
  int* pm = reinterpret_cast<int*>(buf + lines * n);
  const int pair = blockIdx.y;
  const int first = blockIdx.x * lines;
  const int count = min(lines, n - first);
  if (blockIdx.x == 0 && blockIdx.y == 0)
    for (int i = threadIdx.x; i < c; i += kThreads) lay.counters[i] = 0u;
  fft::fill_perm(pm, plan);
  __syncthreads();
  load_cross_power(buf, pm, static_cast<const int*>(nullptr), g, p, n, p0 + pair, first, count);
  __syncthreads();
  fft::inverse(buf, count, n, 1, plan, tab);
  float2* u = lay.u + static_cast<size_t>(pair) * n * lay.wc;
  for (int e = threadIdx.x; e < count * lay.wc; e += kThreads) {
    const int li = e / lay.wc, v = e - li * lay.wc;
    u[pm[first + li] * lay.wc + v] = buf[li * n + peak::window_raw(v, n, search_radius)];
  }
}

// 2. U's columns v0 .. v0 + band - 1 of pair blockIdx.y, all n rows in
// shared memory as [row][column]: the inverse column FFTs, then Re / n^2 of
// the window's rows into the surface.
__global__ void __launch_bounds__(kThreads)
    cols_inverse(fft::Plan plan, int band, int search_radius, const float2* __restrict__ tab,
                 Layout lay) {
  extern __shared__ float2 buf[];  // [n, band]
  const int n = plan.n;
  const int pair = blockIdx.y;
  const int v0 = blockIdx.x * band;
  const int bw = min(band, lay.wc - v0);
  const float2* u = lay.u + static_cast<size_t>(pair) * n * lay.wc;
  for (int e = threadIdx.x; e < n * band; e += kThreads) {
    const int y = e / band, i = e - y * band;
    buf[e] = i < bw ? u[y * lay.wc + v0 + i] : make_float2(0.0f, 0.0f);
  }
  __syncthreads();
  fft::inverse(buf, band, 1, band, plan, tab);
  const float scale = 1.0f / static_cast<float>(n * n);
  float* surf = lay.surf + static_cast<size_t>(pair) * n * n;
  for (int e = threadIdx.x; e < lay.wc * bw; e += kThreads) {
    const int vr = e / bw, i = e - vr * bw;
    const int y = peak::window_raw(vr, n, search_radius);
    surf[y * n + peak::window_raw(v0 + i, n, search_radius)] = buf[y * band + i].x * scale;
  }
}

long long small_smem(int n) { return 8LL * n * n; }

long long large_smem(int n) {
  return std::max(8LL * row_lines(n) * n + 4LL * n, 8LL * col_band(n) * n);
}

template <int N>
int launch_small(const float* g, int p, const fft::Plan& plan, int search_radius,
                 int centroid_radius, const float2* tab, float* shift, float* maxval,
                 cudaStream_t stream) {
  const long long smem = small_smem(plan.n);
  const cudaError_t err = fft::allow_smem(reinterpret_cast<const void*>(small_kernel<N>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  small_kernel<N><<<p, kSmallThreads, smem, stream>>>(g, p, plan, search_radius, centroid_radius,
                                                      tab, shift, maxval);
  return static_cast<int>(cudaGetLastError());
}

int run_large(const float* g, int p, const fft::Plan& plan, int chunk,
              int search_radius, int centroid_radius, int k, int band_rows, const float2* tab,
              void* scratch, float* shift, float* maxval, cudaStream_t stream) {
  const int n = plan.n;
  const int lines = row_lines(n), band = col_band(n);
  const long long row_smem = 8LL * lines * n + 4LL * n;
  const long long col_smem = 8LL * band * n;
  cudaError_t err = fft::allow_smem(reinterpret_cast<const void*>(rows_inverse), row_smem);
  if (err == cudaSuccess) err = fft::allow_smem(reinterpret_cast<const void*>(cols_inverse), col_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int p0 = 0; p0 < p; p0 += chunk) {
    const int c = p - p0 < chunk ? p - p0 : chunk;
    const Layout lay = layout(scratch, c, n, search_radius);
    rows_inverse<<<dim3((n + lines - 1) / lines, c), kThreads, row_smem, stream>>>(
        g, p, p0, plan, lines, search_radius, tab, lay, c);
    cols_inverse<<<dim3((lay.wc + band - 1) / band, c), kThreads, col_smem, stream>>>(
        plan, band, search_radius, tab, lay);
    // n % 4 == 0: every surface 16-byte aligned, float4 reads
    err = peak::launch_split(lay.surf, static_cast<size_t>(n) * n, c, n, search_radius,
                             centroid_radius, k, band_rows, n % 4 == 0, lay.part_val, lay.part_idx,
                             lay.part_nan, lay.counters, shift + 2 * p0, maxval + p0, nullptr,
                             stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory of the largest block for patch size n, in bytes:
// the one-block design's n x n complex buffer, or the staged row or column
// pass.
long long pcfu_smem_bytes(int n) { return fft::small_route(n) ? small_smem(n) : large_smem(n); }

// Scratch bytes one patch pair needs for patch size n: none for the
// one-block design; for the staged one its surface, U at the widest window
// and its share of the peak's parts and counter.
long long pcfu_scratch_bytes(int n) {
  if (fft::small_route(n)) return 0;
  return 12LL * n * n + 12LL * n + 4;
}

// The wrapper's first forward launch: the p curr and p prev patches of
// side n (uint8 when is_u8 != 0, else float32) into X [n, 2p, n] float32.
// Returns the launch's CUDA error code.
int pcfu_stack(const void* curr, const void* prev, int is_u8, int p, int n, void* out,
               void* stream) {
  const long long count = static_cast<long long>(p) * n * n;
  if (count <= 0) return 0;
  const long long want = (count + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kStackBlocks ? want : kStackBlocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  if (is_u8)
    stack_kernel<<<blocks, kThreads, 0, st>>>(static_cast<const uint8_t*>(curr),
                                              static_cast<const uint8_t*>(prev), p, n, o);
  else
    stack_kernel<<<blocks, kThreads, 0, st>>>(static_cast<const float*>(curr),
                                              static_cast<const float*>(prev), p, n, o);
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream` over p pairs whose forward products are G [2n, 2p * 2h]
// float32 (`spec`, h = half_cols(n), the layout above); the staged design
// goes `chunk` pairs
// at a time (scratch: chunk * pcfu_scratch_bytes(n) bytes, 16-byte aligned;
// chunk <= 65535) and splits each surface's peak over k blocks of band_rows
// window rows (peak::valid_split; the one-block design ignores both).
// Returns the first CUDA error code of an attribute call or a launch (0 on
// success).
int pcfu_phase_correlate_fused(const void* spec, int p, int n, int chunk, int search_radius,
                               int centroid_radius, int k, int band_rows, const void* tab,
                               void* scratch, void* shift, void* maxval, void* stream) {
  const fft::Plan plan = fft::make_plan(n);
  const bool small = fft::small_route(n);
  if (plan.stages < 0 || p < 0 ||
      (!small && (chunk < 1 || !peak::valid_split(n, search_radius, k, band_rows))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p == 0) return 0;
  const auto* g = static_cast<const float*>(spec);
  const auto* w = static_cast<const float2*>(tab);
  auto* sh = static_cast<float*>(shift);
  auto* mv = static_cast<float*>(maxval);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!small)
    return run_large(g, p, plan, chunk, search_radius, centroid_radius, k, band_rows, w,
                     scratch, sh, mv, st);
  if (n == 120)
    return launch_small<120>(g, p, plan, search_radius, centroid_radius, w, sh, mv, st);
  return launch_small<0>(g, p, plan, search_radius, centroid_radius, w, sh, mv, st);
}

}  // extern "C"
