// Fused fftshift, mask, argmax and centroid on raw correlation surfaces, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel mrs_optic_flow_tpu/ops/pallas_kernels.py::
// peak_refine_raw_pallas (kernel body _peak_kernel, math
// _masked_peak_centroid).  The device code, and what it computes, is in
// peak_refine.cuh, which kernels D and E share.
//
// What bounds it on this card: device-memory bandwidth, one read of each
// surface (921.6 KB for the scale/rotation surface, N = 480) and a few
// integer operations per element; nothing is computed twice.  The design
// reads the surface once, straight from device memory: one thread block per
// surface, a grid-stride loop in which neighbouring threads read neighbouring
// words, a warp-shuffle then shared-memory reduction of (value, shifted
// index, NaN flag), and one warp for the centroid window.  Entries outside the
// search window are never loaded.  At the scale/rotation shape (one surface)
// this occupies one of the 132 SMs, so its time is one SM's share of the
// bandwidth; splitting a surface over several blocks is left for later work.
//
// Numerics: float32, IEEE division (built without --use_fast_math).
//
// Plain C interface, loaded with ctypes.  The kernel allocates nothing; the
// caller passes the output buffers and the stream.

#include "peak_refine.cuh"

extern "C" {

// Launch on `stream` over `p` surfaces of n x n float32.  `index` may be
// null; when given it receives the peak's fftshifted flat index.  Returns the
// CUDA error code of the launch (0 on success).
int prr_peak_refine_raw(const void* surf, int p, int n, int search_radius, int centroid_radius,
                        void* shift, void* maxval, void* index, void* stream) {
  peak::peak_refine_raw_kernel<<<p, peak::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(surf), n, search_radius, centroid_radius,
      static_cast<float*>(shift), static_cast<float*>(maxval), static_cast<int*>(index));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
