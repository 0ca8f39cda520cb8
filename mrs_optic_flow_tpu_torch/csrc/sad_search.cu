// Exhaustive block-matching SAD maps for Hopper (sm_90a).
//
// Replaces the TPU kernel mrs_optic_flow_tpu/ops/block_matching.py::
// sad_search_pallas (inner kernel `kernel`), the counterpart of the reference's
// OptFlow_C1_D0 workgroup kernel (src/FastSpacedBMMethod.cl:4-84).  It
// computes the same thing: for each grid cell g, an [S, S] current block and
// the [S + 2R, S + 2R] region of the previous frame around it, the map
// SAD[g, di, dj] = sum_{y, x} |curr[g, y, x] - region[g, y + di, x + dj]| over
// all D x D = (2R + 1)^2 shifts; rows are the y shift, columns the x shift.
//
// What bounds it on this card: shared-memory bandwidth.  At the default
// geometry (S = 120, R = 21, 3 x 3 cells) a frame costs 9 * 43 * 43 * 14,400
// = 240 M absolute differences, each needing two operands, against 1.5 MB of
// input: about 160 operations per input byte, so every operand must come
// from on-chip memory.  The design gives one thread block to each (cell, row
// shift di): 387 blocks at the defaults.  The block stages the current block
// (57.6 KB) and the S region rows from di on (S x (S + 2R) floats, 77.8 KB) in
// shared memory, 135 KB with the opt-in attribute set, and each warp takes a
// set of column shifts dj.  Lane l of a warp reads columns l, l + 32, ... of
// a row, so neighbouring lanes read neighbouring words with no bank
// conflicts.  Register tiling over several dj per thread, which would reuse
// each current-block operand, is left for later work.
//
// Numerics: a fixed summation order, so that repeated runs give identical
// maps.  Each lane sums its few columns of a row in float32 (at most
// ceil(S / 32) terms) and adds the row partial to a float64 accumulator; the
// warp then reduces in float64 with a fixed butterfly and rounds once to
// float32.  Integer-valued inputs therefore give exact sums whenever the sum
// is below 2^24 (at the defaults it is at most 14,400 * 255), and other
// inputs the correctly rounded sum of float32 row partials.
//
// Plain C interface, loaded with ctypes.  The kernel allocates nothing; the
// caller passes the output buffer and the stream.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads, 1)
    sad_search_kernel(const float* __restrict__ curr_g, const float* __restrict__ prev_g, int s,
                      int r, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int d = 2 * r + 1;
  const int w = s + 2 * r;  // region side
  const int g = blockIdx.x / d;
  const int di = blockIdx.x - g * d;
  float* cur = smem;        // [s][s]
  float* reg = smem + s * s;  // [s][w]: region rows di .. di + s - 1

  const float* __restrict__ cur_src = curr_g + static_cast<size_t>(g) * s * s;
  const float* __restrict__ reg_src =
      prev_g + static_cast<size_t>(g) * w * w + static_cast<size_t>(di) * w;
  for (int e = threadIdx.x; e < s * s; e += blockDim.x) cur[e] = cur_src[e];
  for (int e = threadIdx.x; e < s * w; e += blockDim.x) reg[e] = reg_src[e];
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int dj = warp; dj < d; dj += kWarps) {
    double acc = 0.0;
    for (int y = 0; y < s; ++y) {
      const float* c_row = cur + y * s;
      const float* r_row = reg + y * w + dj;
      float row = 0.0f;
      for (int x = lane; x < s; x += 32) row += fabsf(c_row[x] - r_row[x]);
      acc += static_cast<double>(row);
    }
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) out[(static_cast<size_t>(g) * d + di) * d + dj] = static_cast<float>(acc);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
long long sad_smem_bytes(int s, int r) {
  return static_cast<long long>(s) * (2 * s + 2 * r) * static_cast<long long>(sizeof(float));
}

// Launch on `stream` over g cells: curr [g, s, s], prev [g, s+2r, s+2r],
// out [g, 2r+1, 2r+1], all float32.  Returns the CUDA error code of the
// attribute call or of the launch (0 on success).
int sad_sad_search(const void* curr, const void* prev, int g, int s, int r, void* out,
                   void* stream) {
  const int smem = static_cast<int>(sad_smem_bytes(s, r));
  cudaError_t err =
      cudaFuncSetAttribute(sad_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int d = 2 * r + 1;
  sad_search_kernel<<<g * d, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(curr), static_cast<const float*>(prev), s, r,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
