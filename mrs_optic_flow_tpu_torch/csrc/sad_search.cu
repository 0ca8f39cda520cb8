// Exhaustive block-matching SAD maps for Hopper (sm_90a), register-tiled.
//
// Replaces the TPU kernel mrs_optic_flow_tpu/ops/block_matching.py::
// sad_search_pallas (inner kernel `kernel`), the counterpart of the reference's
// OptFlow_C1_D0 workgroup kernel (src/FastSpacedBMMethod.cl:4-84).  It
// computes the same thing: for each grid cell g, an [S, S] current block and
// the [S + 2R, S + 2R] region of the previous frame around it, the map
// SAD[g, di, dj] = sum_{y, x} |curr[g, y, x] - region[g, y + di, x + dj]| over
// all D x D = (2R + 1)^2 shifts; rows are the y shift, columns the x shift.
//
// What bounds it on this card: the FP32 pipe.  At the node's geometry (S =
// 120, R = 21, 3 x 3 cells) a frame costs 9 * 43 * 43 * 14,400 = 240 M
// absolute differences against 1.5 MB of input, about 160 differences per
// input byte, and each difference is two FP32 instructions (a subtract, then
// an add with the |.| operand modifier).  So every operand has to come from
// registers: a design that reads both operands of each difference from
// shared memory (as the one before did) is held to the SM's 128 B a clock of
// shared-memory loads, about 4x below the FP32 rate.
//
// The design:
//  - Register tile.  A warp owns kTI row shifts x kTJ column shifts (di0 ..,
//    dj0 ..) and 32 block rows, one row a lane.  A lane walks the columns x
//    of its row and keeps, for each of its kTI region rows, a sliding window
//    of kTJ region values in registers (rotated by unrolling x by kTJ): each
//    step loads one current-block value and kTI region values for kTI * kTJ
//    differences (3 loads for 22 at 2 x 11).  Lanes read neighbouring rows,
//    whose shared-memory pitches are odd, so a warp's loads hit 32 banks.
//  - Thread blocks.  A block stages kRows block rows (one column band of at
//    most kMaxBand columns) and the region rows that its ni x nj warps' tiles
//    need in shared memory, once, with coalesced loads.  Blocks run over
//    (cell, row-shift band, column-shift band) x parts, a part being one
//    32-row group and one column band: 396 blocks of 8 warps at the node's
//    geometry (3 an SM), and column bands split the work further when the
//    cells alone leave SMs idle (G = 1: 3 bands, 132 blocks).
//  - A fixed-order merge, no float atomics.  Each warp sums its lanes' float32
//    row partials in float64 (lane 0 first) and stores them in the scratch
//    the wrapper passes; the last block of a (cell, shift band) to arrive, by
//    an atomic counter it resets, adds the parts in part order and rounds once
//    to float32.  The result does not depend on which block is last.
//  - Staging by cp.async: every thread's copies are in flight at once, then
//    one wait, which matters most where blocks do little arithmetic (G = 1,
//    R = 0).  There is no double-buffered pipeline: a block stages once,
//    and at the node's geometry all 396 blocks are resident together (3 an
//    SM), so there is no next tile to overlap.
//
// Numerics: each lane sums its row's differences over a column band in
// float32, in column order; rows and parts add in float64, in a fixed order,
// so repeated runs give identical maps.  Integer-valued inputs give exact
// maps while a band's row sum stays below 2^24 (at most 256 * 255), which
// keeps them bit-identical to the plain twin's float32 sums (exact there up
// to a total of 2^24, S <= 256 at 8-bit pixels).
//
// Plain C interface, loaded with ctypes.  The kernel allocates nothing; the
// caller passes the output, the scratch, the counters (zero before the first
// launch, left zero by every launch) and the stream.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

// The register tile and the warps a block: -DSAD_TI=, -DSAD_TJ= and
// -DSAD_WARPS= build a tuning variant (scripts/tune_sad_kernel_torch.py;
// ops/cuda_kernels.py::sad_geometry takes the same three); without them the
// build is the shipped kernel.
#ifndef SAD_TI
#define SAD_TI 2
#endif
#ifndef SAD_TJ
#define SAD_TJ 11
#endif
#ifndef SAD_WARPS
#define SAD_WARPS 8
#endif
constexpr int kTI = SAD_TI;        // row shifts a warp
constexpr int kTJ = SAD_TJ;        // column shifts a warp
constexpr int kTT = kTI * kTJ;     // shifts a warp
constexpr int kRows = 32;          // block rows a warp: one a lane
constexpr int kWarps = SAD_WARPS;  // warps a block at most
constexpr int kMaxBand = 256;      // block columns a band at most
// one lane sums each of a warp's shifts over its rows
static_assert(kTT <= 32, "SAD_TI * SAD_TJ: at most 32 shifts a warp");
static_assert(kWarps >= 1 && kWarps <= 32, "SAD_WARPS: 1 to 32 warps a block");

__host__ __device__ constexpr int odd(int n) { return n | 1; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// Launch geometry of one call, as ops/cuda_kernels.py::sad_geometry derives it.
struct Geometry {
  int g, s, r, d, w;  // cells, block, radius, 2r + 1, s + 2r
  int xb, n_xb;       // band columns, bands
  int n_rg, parts;    // 32-row groups, parts = n_rg * n_xb
  int ni, nj;         // row-shift tiles, column-shift tiles a block (its warps)
  int n_dib, n_djb;   // row-shift bands, column-shift bands
};

Geometry make_geometry(int g, int s, int r, int xb) {
  Geometry q;
  q.g = g;
  q.s = s;
  q.r = r;
  q.d = 2 * r + 1;
  q.w = s + 2 * r;
  q.xb = xb;
  q.n_xb = cdiv(s, xb);
  q.n_rg = cdiv(s, kRows);
  q.parts = q.n_rg * q.n_xb;
  const int n_dit = cdiv(q.d, kTI), n_djt = cdiv(q.d, kTJ);
  q.nj = imin(n_djt, kWarps);
  q.ni = imin(n_dit, kWarps / q.nj);
  q.n_dib = cdiv(n_dit, q.ni);
  q.n_djb = cdiv(n_djt, q.nj);
  return q;
}

// Dynamic shared memory a block: the staged block rows and region rows, or
// the warps' row partials once the arithmetic is done, whichever is larger.
long long smem_bytes(int xb, int ni, int nj) {
  return 4LL * imax(kRows * odd(xb) + (kRows + ni * kTI - 1) * odd(xb + nj * kTJ),
                    ni * nj * kTT * (kRows + 1));
}

// (A bound of 3 blocks an SM caps the registers at 80; ptxas gives 79 with
// no spills, 44 of them the tile's window and partials.)
__global__ void __launch_bounds__(kWarps * 32, 3)
    sad_search_kernel(const float* __restrict__ curr_g, const float* __restrict__ prev_g,
                      Geometry q, double* __restrict__ scratch, unsigned* __restrict__ counters,
                      float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ int is_last;
  const int part = blockIdx.x % q.parts;
  int rest = blockIdx.x / q.parts;
  const int djb = rest % q.n_djb;
  rest /= q.n_djb;
  const int dib = rest % q.n_dib;
  const int g = rest / q.n_dib;
  const int region = (g * q.n_dib + dib) * q.n_djb + djb;  // counter of this block's shifts
  const int rg = part / q.n_xb;
  const int x0 = (part - rg * q.n_xb) * q.xb;
  const int y0 = rg * kRows;
  const int n_x = imin(q.xb, q.s - x0);
  const int di_lo = dib * q.ni * kTI;
  const int dj_lo = djb * q.nj * kTJ;

  const int pc = odd(q.xb);                   // pitch of the block rows
  const int rw = q.xb + q.nj * kTJ;           // region columns the block reads
  const int pr = odd(rw);                     // pitch of the region rows
  const int r_rows = kRows + q.ni * kTI - 1;  // region rows the block reads
  float* cs = smem;                           // [kRows][pc]
  float* rs = smem + kRows * pc;              // [r_rows][pr]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const float* __restrict__ cur = curr_g + static_cast<size_t>(g) * q.s * q.s;
  const float* __restrict__ reg = prev_g + static_cast<size_t>(g) * q.w * q.w;
  // every staging copy in flight at once (cp.async, zero-filled outside the
  // block and region), then one wait
  for (int rr = warp; rr < kRows; rr += n_warps) {
    const int y = y0 + rr;
    for (int cc = lane; cc < pc; cc += 32) {
      const bool in = y < q.s && cc < n_x;
      __pipeline_memcpy_async(cs + rr * pc + cc, in ? cur + y * q.s + x0 + cc : cur, 4, in ? 0 : 4);
    }
  }
  for (int rr = warp; rr < r_rows; rr += n_warps) {
    const int y = y0 + di_lo + rr;
    for (int cc = lane; cc < pr; cc += 32) {
      const int x = x0 + dj_lo + cc;
      const bool in = y < q.w && x < q.w && cc < rw;
      __pipeline_memcpy_async(rs + rr * pr + cc, in ? reg + y * q.w + x : reg, 4, in ? 0 : 4);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // this warp's tile: row shifts di0 + i, column shifts dj0 + j
  const int wi = warp / q.nj;
  const int wj = warp - wi * q.nj;
  const int di0 = di_lo + wi * kTI;
  const int dj0 = dj_lo + wj * kTJ;
  float part_sum[kTI][kTJ];
#pragma unroll
  for (int i = 0; i < kTI; ++i)
#pragma unroll
    for (int j = 0; j < kTJ; ++j) part_sum[i][j] = 0.0f;

  if (di0 < q.d && dj0 < q.d && y0 + lane < q.s) {
    const float* crow = cs + lane * pc;
    const float* rrow = rs + (lane + wi * kTI) * pr + wj * kTJ;
    // slot j holds region column x + j (relative to dj0) at the start of an
    // unrolled group; step u reads slot (j + u) % kTJ and then refills slot u
    // with column x + u + kTJ
    float win[kTI][kTJ];
#pragma unroll
    for (int i = 0; i < kTI; ++i)
#pragma unroll
      for (int j = 0; j < kTJ; ++j) win[i][j] = rrow[i * pr + j];
    int x = 0;
    for (; x + kTJ <= n_x; x += kTJ) {
#pragma unroll
      for (int u = 0; u < kTJ; ++u) {
        const float c = crow[x + u];
#pragma unroll
        for (int i = 0; i < kTI; ++i)
#pragma unroll
          for (int j = 0; j < kTJ; ++j) part_sum[i][j] += fabsf(c - win[i][(j + u) % kTJ]);
#pragma unroll
        for (int i = 0; i < kTI; ++i) win[i][u] = rrow[i * pr + x + u + kTJ];
      }
    }
#pragma unroll
    for (int u = 0; u < kTJ - 1; ++u) {
      if (x + u < n_x) {
        const float c = crow[x + u];
#pragma unroll
        for (int i = 0; i < kTI; ++i)
#pragma unroll
          for (int j = 0; j < kTJ; ++j) part_sum[i][j] += fabsf(c - win[i][(j + u) % kTJ]);
#pragma unroll
        for (int i = 0; i < kTI; ++i) win[i][u] = rrow[i * pr + x + u + kTJ];
      }
    }
  }

  // rows of the warp in float64, lane 0 first: the partials go through
  // shared memory (the staged rows are consumed), [warp][shift][33]
  __syncthreads();
  float* red = smem + warp * kTT * (kRows + 1);
#pragma unroll
  for (int i = 0; i < kTI; ++i)
#pragma unroll
    for (int j = 0; j < kTJ; ++j) red[(i * kTJ + j) * (kRows + 1) + lane] = part_sum[i][j];
  __syncwarp();
  const int tw = q.ni * kTI * q.nj * kTJ;  // shifts of the block
  const int tcols = q.nj * kTJ;
  double* mine = scratch + (static_cast<size_t>(region) * q.parts + part) * tw;
  if (lane < kTT) {
    double acc = 0.0;
    for (int l = 0; l < kRows; ++l) acc += static_cast<double>(red[lane * (kRows + 1) + l]);
    const int i = lane / kTJ;
    const int j = lane - i * kTJ;
    mine[(wi * kTI + i) * tcols + wj * kTJ + j] = acc;
  }

  // the last block of this region adds the parts in part order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counters + region, 1u) == static_cast<unsigned>(q.parts - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const double* all = scratch + static_cast<size_t>(region) * q.parts * tw;
  for (int t = threadIdx.x; t < tw; t += blockDim.x) {
    const int di = di_lo + t / tcols;
    const int dj = dj_lo + t % tcols;
    if (di >= q.d || dj >= q.d) continue;
    double acc = 0.0;
    for (int p = 0; p < q.parts; ++p) acc += __ldcg(all + static_cast<size_t>(p) * tw + t);
    out[(static_cast<size_t>(g) * q.d + di) * q.d + dj] = static_cast<float>(acc);
  }
  if (threadIdx.x == 0) counters[region] = 0u;
}

}  // namespace

extern "C" {

// Dynamic shared memory a block needs at radius r and band width xb, in
// bytes.
long long sad_smem_bytes(int r, int xb) {
  const Geometry q = make_geometry(1, xb, r, xb);
  return smem_bytes(xb, q.ni, q.nj);
}

// Float64 scratch entries and counters of a call over g cells.
long long sad_scratch_doubles(int g, int s, int r, int xb) {
  const Geometry q = make_geometry(g, s, r, xb);
  return static_cast<long long>(g) * q.n_dib * q.n_djb * q.parts * q.ni * kTI * q.nj * kTJ;
}

long long sad_counters(int g, int s, int r, int xb) {
  const Geometry q = make_geometry(g, s, r, xb);
  return static_cast<long long>(g) * q.n_dib * q.n_djb;
}

// Launch on `stream` over g cells: curr [g, s, s], prev [g, s+2r, s+2r],
// out [g, 2r+1, 2r+1], all float32, in column bands of xb (1 to kMaxBand)
// columns; scratch of sad_scratch_doubles float64 and sad_counters unsigned
// counters, zero on entry.  Returns the CUDA error code of the attribute call
// or of the launch (0 on success).
int sad_search_tiled(const void* curr, const void* prev, int g, int s, int r, int xb,
                     void* scratch, void* counters, void* out, void* stream) {
  if (xb < 1 || xb > kMaxBand) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry q = make_geometry(g, s, r, xb);
  const int smem = static_cast<int>(smem_bytes(xb, q.ni, q.nj));
  cudaError_t err =
      cudaFuncSetAttribute(sad_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = sad_counters(g, s, r, xb) * q.parts;
  sad_search_kernel<<<static_cast<unsigned>(blocks), q.ni * q.nj * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(curr), static_cast<const float*>(prev), q,
      static_cast<double*>(scratch), static_cast<unsigned*>(counters), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
