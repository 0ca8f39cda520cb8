// Tiled DFT stages for patch batches of any size n: the inverse of kernel E
// (phase_correlate_fused.cu).
//
// Each stage is one launch over a grid of (output tile, matrix): the DFT of
// every matrix of the batch as a small complex matrix product on the CUDA
// cores, with the DFT matrix generated tile by tile from a 1-D twiddle table
// W(m) = exp(-2 pi i m / n), read at m = j * k mod n.  The table is row 1 of
// the JAX package's float64-built _dft_matrices(n), cast to float32; the
// reduced angle differs from the float64 matrix entry by at most 5.9e-13
// absolute for every n <= 480, far below float32 resolution.
//
// Block tile: TM x TN outputs, 256 threads, each thread 4 x 4 outputs at rows
// ty + 16 i and columns tx + 16 j (tx = thread % 16, ty = thread / 16), so
// that a warp reads 16 neighbouring shared-memory words and broadcasts the
// rest.  The contraction runs in stages of KC: the block stages a KC-deep
// slice of both operands in shared memory (zero beyond the matrix), then
// every thread accumulates its 16 outputs in float32 FMA, in the order of the
// contraction index.  Shared memory is a few tens of KB whatever n is, so any
// n from 1 up takes the same code; intermediates go to scratch in device
// memory, which the caller sizes to stay in the 50 MB L2 cache.
//
// Sign conventions: tab[m] = (cos t, sin t), t = -2 pi m / n, so W = tab and
// conj(W) = (tab.x, -tab.y).  Spectra are stored interleaved (float2).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace dft {

constexpr int kThreads = 256;
constexpr int TM = 64;  // output rows per block tile
constexpr int TN = 64;  // output columns per block tile
constexpr int KC = 16;  // contraction depth per shared-memory stage
constexpr int RT = 4;   // output rows per thread
constexpr int CT = 4;   // output columns per thread
constexpr float kFltEpsilon = 1.1920928955078125e-07f;  // FLT_EPSILON

static_assert(TM == 16 * RT && TN == 16 * CT && kThreads == 256, "16 x 16 threads");

// W(j k) (sign = +1) or conj(W)(j k) (sign = -1)
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tab, int j, int k, int n,
                                          float sign) {
  const float2 w = __ldg(tab + (j * k) % n);
  return make_float2(w.x, sign * w.y);
}

// Tiles of a rows x cols output
__host__ __device__ inline int num_tiles(int rows, int cols) {
  return ((rows + TM - 1) / TM) * ((cols + TN - 1) / TN);
}

struct TileOrigin {
  int r0, c0;
  __device__ TileOrigin(int cols) {
    const int tiles_c = (cols + TN - 1) / TN;
    r0 = (blockIdx.x / tiles_c) * TM;
    c0 = (blockIdx.x % tiles_c) * TN;
  }
};

// Complex DFT along the first axis of [n, nc] complex matrices, matrix
// blockIdx.y of in -> matrix blockIdx.y of out:
// out[k][l] = sum_y tw(k y) in[y][l], tw = W (sign +1) or conj(W) (sign -1).
__global__ void __launch_bounds__(kThreads)
    cols_dft(const float2* __restrict__ in, int n, int nc, float sign,
             const float2* __restrict__ tab, float2* __restrict__ out) {
  constexpr int kMats = 1;
  __shared__ float2 as[KC][TM + 1];     // tw((r0 + m) (k0 + k)) at as[k][m]
  __shared__ float2 bs[kMats][KC][TN];  // in[k0 + k][c0 + c] at bs[s][k][c]
  const TileOrigin o(nc);
  const size_t mat_size = static_cast<size_t>(n) * nc;
  const float2* __restrict__ src = in + static_cast<size_t>(blockIdx.y) * kMats * mat_size;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float ar[kMats][RT][CT] = {}, ai[kMats][RT][CT] = {};
  for (int k0 = 0; k0 < n; k0 += KC) {
    for (int e = threadIdx.x; e < TM * KC; e += kThreads) {
      const int m = e / KC, k = e % KC;
      const int r = o.r0 + m, y = k0 + k;
      as[k][m] = (r < n && y < n) ? twiddle(tab, r, y, n, sign) : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int s = 0; s < kMats; ++s)
      for (int e = threadIdx.x; e < KC * TN; e += kThreads) {
        const int k = e / TN, c = e % TN;
        const int y = k0 + k, l = o.c0 + c;
        bs[s][k][c] = (y < n && l < nc) ? src[s * mat_size + static_cast<size_t>(y) * nc + l]
                                        : make_float2(0.0f, 0.0f);
      }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      float2 a[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int s = 0; s < kMats; ++s) {
        float2 b[CT];
#pragma unroll
        for (int j = 0; j < CT; ++j) b[j] = bs[s][k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j) {
            // (ax + i ay) * (bx + i by)
            ar[s][i][j] = fmaf(a[i].x, b[j].x, fmaf(-a[i].y, b[j].y, ar[s][i][j]));
            ai[s][i][j] = fmaf(a[i].x, b[j].y, fmaf(a[i].y, b[j].x, ai[s][i][j]));
          }
      }
    }
    __syncthreads();
  }
  float2* __restrict__ dst = out + static_cast<size_t>(blockIdx.y) * mat_size;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int r = o.r0 + ty + 16 * i, l = o.c0 + tx + 16 * j;
      if (r < n && l < nc) dst[static_cast<size_t>(r) * nc + l] = make_float2(ar[0][i][j], ai[0][i][j]);
    }
}

// Last stage, inverse DFT along x, real part only, of [n, nc] complex
// matrices: out[y][x] = scale * sum_l Re(in[y][l] conj(W)(l x))
//                     = scale * sum_l (in.x tab.x + in.y tab.y).
// With nc = n it is the full inverse of kernel E.
__global__ void __launch_bounds__(kThreads)
    rows_inverse_real(const float2* __restrict__ in, int n, int nc, float scale,
                      const float2* __restrict__ tab, float* __restrict__ out) {
  __shared__ float2 as[KC][TM + 1];  // in[r0 + m][k0 + k] at as[k][m]
  __shared__ float2 bs[KC][TN];      // tab[((k0 + k) (c0 + c)) mod n] at bs[k][c]
  const TileOrigin o(n);
  const float2* __restrict__ src = in + static_cast<size_t>(blockIdx.y) * n * nc;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[RT][CT] = {};
  for (int k0 = 0; k0 < nc; k0 += KC) {
    for (int e = threadIdx.x; e < TM * KC; e += kThreads) {
      const int m = e / KC, k = e % KC;
      const int y = o.r0 + m, l = k0 + k;
      as[k][m] = (y < n && l < nc) ? src[static_cast<size_t>(y) * nc + l] : make_float2(0.0f, 0.0f);
    }
    for (int e = threadIdx.x; e < KC * TN; e += kThreads) {
      const int k = e / TN, c = e % TN;
      const int l = k0 + k, x = o.c0 + c;
      bs[k][c] = (l < nc && x < n) ? twiddle(tab, l, x, n, 1.0f) : make_float2(0.0f, 0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      float2 a[RT], b[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CT; ++j) b[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, fmaf(a[i].y, b[j].y, acc[i][j]));
    }
    __syncthreads();
  }
  float* __restrict__ dst = out + static_cast<size_t>(blockIdx.y) * n * n;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int y = o.r0 + ty + 16 * i, x = o.c0 + tx + 16 * j;
      if (y < n && x < n) dst[static_cast<size_t>(y) * n + x] = acc[i][j] * scale;
    }
}

}  // namespace dft
