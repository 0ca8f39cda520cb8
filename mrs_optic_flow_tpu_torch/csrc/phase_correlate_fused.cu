// Cross-power, full inverse DFT and peak of given forward spectra, for Hopper
// (sm_90a), any patch size n.
//
// Replaces the TPU kernel mrs_optic_flow_tpu/ops/pallas_kernels.py::
// phase_correlate_fused_pallas (kernel _fused_kernel, peak stage
// _masked_peak_centroid).  The forward spectra come from the caller (the
// wrapper computes them with float32 matrix products, as the JAX package left
// them to XLA outside its kernel).  It computes what _fused_kernel computes:
// for every patch pair, from the full [n, n] spectra F1 = f1r + i f1i and
// F2 = f2r + i f2i, the normalized cross-power
// R = F1 * conj(F2) * rsqrt(|F1 * conj(F2)|^2 + FLT_EPSILON), the full complex
// inverse Re(conj(W) R conj(W)) / n^2 in float32 FMA (no TF32), then the peak
// stage of kernel B (peak_refine.cuh), one block a surface.
//
// What bounds it on this card: the inverse DFT on the CUDA cores (about
// 1.4 GFLOP for one 480 px pair) and, for large n, shared memory, in the
// tiled stages of dft_stages.cuh:
//   1. cross_power: elementwise over the chunk -> R;
//   2. cols_dft: the inverse column pass (conj(W)) -> U;
//   3. rows_inverse_real with nc = n: the inverse row pass, real part,
//      1/n^2 -> surface;
// then the peak kernel.  Scratch from the caller: 2 n^2 complex per pair,
// the batch in chunks of `chunk` pairs.
//
// Numerics: float32 FMA throughout, IEEE division and square roots (built
// without --use_fast_math); rsqrtf for the cross-power normalization.
//
// Plain C interface, loaded with ctypes.  The kernels allocate nothing; the
// caller passes the scratch, the output buffers and the stream.

#include "dft_stages.cuh"
#include "peak_refine.cuh"

namespace {

__global__ void __launch_bounds__(dft::kThreads)
    cross_power(const float* __restrict__ f1r, const float* __restrict__ f1i,
                const float* __restrict__ f2r, const float* __restrict__ f2i, size_t count,
                float2* __restrict__ out) {
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < count;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float rr = f1r[e] * f2r[e] + f1i[e] * f2i[e];
    const float ri = f1i[e] * f2r[e] - f1r[e] * f2i[e];
    const float den = rsqrtf(rr * rr + ri * ri + dft::kFltEpsilon);
    out[e] = make_float2(rr * den, ri * den);
  }
}

}  // namespace

extern "C" {

// Scratch bytes one patch pair needs for patch size n.
long long pcfu_scratch_bytes(int n) {
  return 2LL * n * n * static_cast<long long>(sizeof(float2));
}

// Launch on `stream` over p pairs of [n, n] float32 spectra (f1r, f1i, f2r,
// f2i), `chunk` pairs at a time (scratch: chunk * pcfu_scratch_bytes(n)
// bytes; chunk <= 65535).  Returns the first CUDA error code of a launch (0 on
// success).
int pcfu_phase_correlate_fused(const void* f1r, const void* f1i, const void* f2r,
                               const void* f2i, int p, int n, int chunk, int search_radius,
                               int centroid_radius, const void* tab, void* scratch, void* shift,
                               void* maxval, void* stream) {
  const auto* w = static_cast<const float2*>(tab);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t mat = static_cast<size_t>(n) * n;
  const float scale = 1.0f / static_cast<float>(n * n);
  for (int p0 = 0; p0 < p; p0 += chunk) {
    const int c = p - p0 < chunk ? p - p0 : chunk;
    const size_t off = static_cast<size_t>(p0) * mat;
    float2* r = static_cast<float2*>(scratch);  // [c, n, n]: R
    float2* u = r + c * mat;                     // [c, n, n]: U
    float* surf = reinterpret_cast<float*>(r);   // [c, n, n] over R once R is consumed
    const size_t count = c * mat;
    const int blocks = static_cast<int>((count + dft::kThreads - 1) / dft::kThreads < 4096
                                            ? (count + dft::kThreads - 1) / dft::kThreads
                                            : 4096);
    cross_power<<<blocks, dft::kThreads, 0, st>>>(
        static_cast<const float*>(f1r) + off, static_cast<const float*>(f1i) + off,
        static_cast<const float*>(f2r) + off, static_cast<const float*>(f2i) + off, count, r);
    dft::cols_dft<<<dim3(dft::num_tiles(n, n), c), dft::kThreads, 0, st>>>(
        r, n, n, -1.0f, w, u);
    dft::rows_inverse_real<<<dim3(dft::num_tiles(n, n), c), dft::kThreads, 0, st>>>(
        u, n, n, scale, w, surf);
    peak::peak_refine_raw_kernel<<<c, peak::kThreads, 0, st>>>(
        surf, n, search_radius, centroid_radius, static_cast<float*>(shift) + 2 * p0,
        static_cast<float*>(maxval) + p0, nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
