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
// shift di): 387 blocks at the defaults.  The block walks the S block rows in
// tiles of `tile_rows`: it stages that many rows of the current block and the
// matching region rows (from row di on) in shared memory, and each warp takes
// a set of column shifts dj.  Lane l of a warp reads columns l, l + 32, ... of
// a row, so neighbouring lanes read neighbouring words with no bank
// conflicts.  Each lane's float64 accumulator of each dj lives in shared
// memory across the tiles, so the rows are summed in the same order whatever
// the tile, and every tile size gives the same maps.  The wrapper picks the
// tile so that two blocks share an SM (ops/cuda_kernels.py::sad_tile_rows):
// on an H100 (700 W limit) at S = 120, two tiles of 60 rows a block run in
// 0.22 ms where the whole block staged at once (135 KB, one block an SM) took
// 0.36 ms.  Any S takes this kernel; at S = 240 the block alone is 230 KB.  Register tiling over several dj per thread,
// which would reuse each current-block operand, is left for later work.
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

// Shared memory holds the per-lane accumulators [D][32] (float64), then
// `tile_rows` rows of the block and of the region.  (A launch bound of two
// blocks an SM cuts the registers from 54 to 49 and costs 10%; 54 already
// let two blocks share an SM.)
__global__ void __launch_bounds__(kThreads, 1)
    sad_search_kernel(const float* __restrict__ curr_g, const float* __restrict__ prev_g, int s,
                      int r, int tile_rows, float* __restrict__ out) {
  extern __shared__ double smem_acc[];
  const int d = 2 * r + 1;
  const int w = s + 2 * r;
  const int g = blockIdx.x / d;
  const int di = blockIdx.x - g * d;
  double* acc = smem_acc;                                   // [d][32]
  float* cur = reinterpret_cast<float*>(smem_acc + d * 32);  // [tile_rows][s]
  float* reg = cur + tile_rows * s;                         // [tile_rows][w]

  const float* __restrict__ cur_src = curr_g + static_cast<size_t>(g) * s * s;
  const float* __restrict__ reg_src =
      prev_g + static_cast<size_t>(g) * w * w + static_cast<size_t>(di) * w;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int dj = warp; dj < d; dj += kWarps) acc[dj * 32 + lane] = 0.0;

  for (int y0 = 0; y0 < s; y0 += tile_rows) {
    const int rows = s - y0 < tile_rows ? s - y0 : tile_rows;
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < rows * s; e += blockDim.x) cur[e] = cur_src[y0 * s + e];
    for (int e = threadIdx.x; e < rows * w; e += blockDim.x) reg[e] = reg_src[y0 * w + e];
    __syncthreads();
    for (int dj = warp; dj < d; dj += kWarps) {
      double a = acc[dj * 32 + lane];
      for (int y = 0; y < rows; ++y) {
        const float* c_row = cur + y * s;
        const float* r_row = reg + y * w + dj;
        float row = 0.0f;
        for (int x = lane; x < s; x += 32) row += fabsf(c_row[x] - r_row[x]);
        a += static_cast<double>(row);
      }
      acc[dj * 32 + lane] = a;
    }
  }
  for (int dj = warp; dj < d; dj += kWarps) {
    double a = acc[dj * 32 + lane];
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
    if (lane == 0) out[(static_cast<size_t>(g) * d + di) * d + dj] = static_cast<float>(a);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs with `tile_rows` rows a tile, in
// bytes.
long long sad_smem_bytes(int s, int r, int tile_rows) {
  return static_cast<long long>(2 * r + 1) * 32 * static_cast<long long>(sizeof(double)) +
         static_cast<long long>(tile_rows) * (2 * s + 2 * r) * static_cast<long long>(sizeof(float));
}

// Launch on `stream` over g cells: curr [g, s, s], prev [g, s+2r, s+2r],
// out [g, 2r+1, 2r+1], all float32, `tile_rows` block rows a tile (1 to s).
// Returns the CUDA error code of the attribute call or of the launch (0 on
// success).
int sad_sad_search(const void* curr, const void* prev, int g, int s, int r, int tile_rows,
                   void* out, void* stream) {
  const int smem = static_cast<int>(sad_smem_bytes(s, r, tile_rows));
  cudaError_t err =
      cudaFuncSetAttribute(sad_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int d = 2 * r + 1;
  sad_search_kernel<<<g * d, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(curr), static_cast<const float*>(prev), s, r, tile_rows,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
