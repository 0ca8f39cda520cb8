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

extern "C" {

// Launch on `stream` over `p` surfaces of n x n float32, k blocks a surface,
// each `band_rows` of the window's rows (peak::valid_split); vec != 0
// reads 4 columns at a time (n % 4 == 0, 16-byte aligned surfaces).  Scratch:
// p * k floats, then 2 p k ints; counters: p unsigned, zero on entry.
// `index` may be null; when given it receives the peak's fftshifted flat
// index.  Returns the CUDA error code of the launch (0 on success).
int prr_peak_refine_split(const void* surf, int p, int n, int search_radius, int centroid_radius,
                          int k, int band_rows, int vec, void* scratch, void* counters, void* shift,
                          void* maxval, void* index, void* stream) {
  if (!peak::valid_split(n, search_radius, k, band_rows) || (vec && n % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* part_val = static_cast<float*>(scratch);
  auto* part_idx = reinterpret_cast<int*>(part_val + static_cast<size_t>(p) * k);
  auto* part_nan = part_idx + static_cast<size_t>(p) * k;
  return static_cast<int>(peak::launch_split(
      static_cast<const float*>(surf), static_cast<size_t>(n) * n, p, n, search_radius,
      centroid_radius, k, band_rows, vec != 0, part_val, part_idx, part_nan,
      static_cast<unsigned*>(counters), static_cast<float*>(shift), static_cast<float*>(maxval),
      static_cast<int*>(index), static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
