// Patch-batch phase correlation for Hopper (sm_90a), any patch size n.
//
// Replaces the TPU kernel mrs_optic_flow_tpu/ops/pallas_kernels.py::
// phase_correlate_fullfused_pallas (kernel _fullfused_kernel, bodies
// _phase_correlate_body_half / _phase_correlate_body, peak stage
// _masked_peak_centroid).  It computes the same thing as kernel A
// (phase_correlate_frames.cu), on patches already cut out: for every pair of
// [n, n] patches (uint8 or float32), the real 2-D DFT of both (Hermitian half
// spectrum), the normalized cross-power F1 * conj(F2) * rsqrt(|.|^2 +
// FLT_EPSILON), the inverse DFT with the {1, 2, ..., 2, 1} conjugate-fold
// weights scaled by 1/n^2, then the peak stage of kernel B (peak_refine.cuh):
// fftshift and +-search_radius mask in index space, argmax with ties on the
// minimum fftshifted flat index, positive-only radius-`centroid_radius`
// centroid with an FLT_EPSILON-seeded denominator, NaN in the search window
// giving NaN.
//
// What bounds it on this card: the DFT arithmetic on the CUDA cores (about
// 2 GFLOP for one 480 px pair, 4 MFLOP for a 60 px pair), and for the large
// patches the capacity of shared memory: one 480 px half spectrum is
// 480 x 241 complex, 925 KB, four times the 227 KB a block may hold, so kernel
// A's one-block-per-patch design ends at n = 168 (one n x n complex buffer,
// n a multiple of 8).  This kernel is staged
// instead: four tiled launches over (output tile, matrix), dft_stages.cuh,
//   1. rows_forward_real: both patches' real row pass -> half spectra T1, T2;
//   2. cols_dft<true>: the complex column pass of both, the cross-power and
//      the fold weights fused into its epilogue -> d * R;
//   3. cols_dft<false>: the inverse column pass (conj(W)) -> U;
//   4. rows_inverse_real: the inverse row pass, real part, 1/n^2 -> surface;
// then the peak kernel, one block per surface.  Intermediates live in a
// scratch buffer the caller allocates, 3 n (n/2 + 1) complex per pair (2.8 MB
// at n = 480), and the batch runs in chunks of `chunk` pairs so that a chunk's
// scratch stays in the 50 MB L2 cache.  Shared memory per block is 25 KB
// whatever n is.  Tensor cores (split bf16/TF32 passes), a mixed-radix FFT and
// fusing the stages are left for later work.
//
// uint8 patches are converted exactly on load and then take the same code as
// float32 ones, so both give bit-identical results.
//
// Numerics: float32 FMA throughout, IEEE division and square roots (built
// without --use_fast_math); rsqrtf for the cross-power normalization.
//
// Plain C interface, loaded with ctypes.  The kernels allocate nothing; the
// caller passes the scratch, the output buffers and the stream.

#include "dft_stages.cuh"
#include "peak_refine.cuh"

namespace {

template <typename T>
int run(const T* curr, const T* prev, int p, int n, int chunk, int search_radius,
        int centroid_radius, const float2* tab, float2* scratch, float* shift, float* maxval,
        cudaStream_t stream) {
  const int nh = n / 2 + 1;
  const size_t half = static_cast<size_t>(n) * nh;
  const float scale = 1.0f / static_cast<float>(n * n);
  for (int p0 = 0; p0 < p; p0 += chunk) {
    const int c = p - p0 < chunk ? p - p0 : chunk;
    const size_t off = static_cast<size_t>(p0) * n * n;
    float2* t = scratch;              // [c, 2, n, nh]: T1, T2 of each pair
    float2* r = scratch + 2 * c * half;  // [c, n, nh]: d * R
    float2* u = scratch;              // [c, n, nh]: U, over T once T is consumed
    float* surf = reinterpret_cast<float*>(scratch + c * half);  // [c, n, n] after U
    dft::rows_forward_real<T>
        <<<dim3(dft::num_tiles(n, nh), 2 * c), dft::kThreads, 0, stream>>>(curr + off, prev + off,
                                                                            n, nh, tab, t);
    dft::cols_dft<true><<<dim3(dft::num_tiles(n, nh), c), dft::kThreads, 0, stream>>>(
        t, n, nh, 1.0f, tab, r);
    dft::cols_dft<false><<<dim3(dft::num_tiles(n, nh), c), dft::kThreads, 0, stream>>>(
        r, n, nh, -1.0f, tab, u);
    dft::rows_inverse_real<<<dim3(dft::num_tiles(n, n), c), dft::kThreads, 0, stream>>>(
        u, n, nh, scale, tab, surf);
    peak::peak_refine_raw_kernel<<<c, peak::kThreads, 0, stream>>>(
        surf, n, search_radius, centroid_radius, shift + 2 * p0, maxval + p0, nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// Scratch bytes one patch pair needs for patch size n.
long long pcff_scratch_bytes(int n) {
  return 3LL * n * (n / 2 + 1) * static_cast<long long>(sizeof(float2));
}

// Launch on `stream` over p pairs of [n, n] patches, `chunk` pairs at a time
// (scratch: chunk * pcff_scratch_bytes(n) bytes; chunk <= 32767).  is_u8 != 0:
// uint8 patches, else float32.  Returns the first CUDA error code of a launch
// (0 on success).
int pcff_phase_correlate_fullfused(const void* curr, const void* prev, int is_u8, int p, int n,
                                   int chunk, int search_radius, int centroid_radius,
                                   const void* tab, void* scratch, void* shift, void* maxval,
                                   void* stream) {
  const auto* w = static_cast<const float2*>(tab);
  auto* s = static_cast<float2*>(scratch);
  auto* sh = static_cast<float*>(shift);
  auto* mv = static_cast<float*>(maxval);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_u8)
    return run(static_cast<const uint8_t*>(curr), static_cast<const uint8_t*>(prev), p, n, chunk,
               search_radius, centroid_radius, w, s, sh, mv, st);
  return run(static_cast<const float*>(curr), static_cast<const float*>(prev), p, n, chunk,
             search_radius, centroid_radius, w, s, sh, mv, st);
}

}  // extern "C"
