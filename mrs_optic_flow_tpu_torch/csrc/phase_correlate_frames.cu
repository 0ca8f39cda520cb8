// Whole-frame batched phase correlation for Hopper (sm_90a).
//
// Replaces the TPU kernel mrs_optic_flow_tpu/ops/pallas_kernels.py::
// phase_correlate_frames_pallas (kernel body _fullfused_frames_kernel with
// _pc_bands_body_half and the peak stage _masked_peak_centroid).  It computes
// the same thing: for every patch of a q x q grid cut straight out of
// [B, H, W] frame pairs (H = W = q * n), the real 2-D DFT of both patches
// (Hermitian half spectrum), the normalized cross-power
// F1 * conj(F2) * rsqrt(|.|^2 + FLT_EPSILON), the inverse DFT with the
// {1, 2, ..., 2, 1} conjugate-fold weights scaled by 1/n^2, the fftshift and
// the +-search_radius mask in index space, the argmax with ties broken on the
// minimum fftshifted flat index, and the positive-only weighted centroid over
// a (2 * centroid_radius + 1)^2 window with an FLT_EPSILON-seeded
// denominator.  NaN anywhere inside the search window gives NaN maxval and
// NaN shifts.  Output field order is i + q * j (i = column patch).
//
// What bounds it on this card: arithmetic on the CUDA cores.  The DFT as
// four small complex matrix products costs about 32 MFLOP per 120 px patch
// (the TPU cost estimate counts 55 MFLOP for its full-width products) against
// 28.8 KB of uint8 input, i.e. about 1,100 FLOP per input byte, far above
// the card's FP32 ridge point.  The design therefore keeps every intermediate
// on chip: one thread block per (pair, patch), the patch read straight out of
// the frame (no patchify copy in device memory), three n x (n/2 + 1) complex
// buffers in shared memory (176 KB at n = 120, reused across the stages), and
// register tiles of 4 x 4 outputs per thread so that each shared-memory load
// feeds several FMAs.  Twiddles come from a 1-D table W(m) = exp(-2 pi i m/n),
// m = j * k mod n, built in float64 on the host and cast to float32; it is
// row 1 of the JAX package's _dft_matrices(n).  Tensor cores (bf16/TF32
// split passes), TMA and a mixed-radix FFT are left for later work.
//
// Numerics: float32 throughout, IEEE division and square roots (built
// without --use_fast_math); rsqrtf for the cross-power normalization.
//
// Plain C interface, loaded with ctypes.  The kernel allocates nothing; the
// caller passes the output buffers and the stream.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int RT = 4;  // output rows per thread tile
constexpr int CT = 4;  // output columns per thread tile
constexpr float kFltEpsilon = 1.1920928955078125e-07f;  // FLT_EPSILON

__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// Column indices of a thread tile: strided by the tile count so that
// neighbouring threads touch neighbouring shared-memory words.
struct Tile {
  int rows[RT];
  int cols[CT];
  bool row_ok[RT];
  bool col_ok[CT];
  __device__ Tile(int tile, int nrows, int ncols) {
    const int tiles_r = (nrows + RT - 1) / RT;
    const int tiles_c = (ncols + CT - 1) / CT;
    const int tr = tile / tiles_c;
    const int tc = tile % tiles_c;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = tr + i * tiles_r;
      row_ok[i] = r < nrows;
      rows[i] = row_ok[i] ? r : nrows - 1;
    }
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int c = tc + j * tiles_c;
      col_ok[j] = c < ncols;
      cols[j] = col_ok[j] ? c : ncols - 1;
    }
  }
};

__device__ __forceinline__ int num_tiles(int nrows, int ncols) {
  return ((nrows + RT - 1) / RT) * ((ncols + CT - 1) / CT);
}

// m <- (m + step) mod n for 0 <= m, step < n
__device__ __forceinline__ int advance(int m, int step, int n) {
  m += step;
  return m >= n ? m - n : m;
}

// Stage 1, forward DFT along x of a real patch, half spectrum:
// T[y][l] = sum_x x[y][x] * W(x * l), 0 <= l < nh.
__device__ void row_dft_half(const float* __restrict__ x, float2* __restrict__ T,
                             const float2* __restrict__ tab, int n, int nh) {
  for (int tile = threadIdx.x; tile < num_tiles(n, nh); tile += blockDim.x) {
    const Tile tl(tile, n, nh);
    float ar[RT][CT] = {}, ai[RT][CT] = {};
    int m[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) m[j] = 0;
    for (int t = 0; t < n; ++t) {
      float xv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) xv[i] = x[tl.rows[i] * n + t];
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const float2 w = tab[m[j]];
        m[j] = advance(m[j], tl.cols[j], n);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          ar[i][j] = fmaf(xv[i], w.x, ar[i][j]);
          ai[i][j] = fmaf(xv[i], w.y, ai[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j)
        if (tl.row_ok[i] && tl.col_ok[j])
          T[tl.rows[i] * nh + tl.cols[j]] = make_float2(ar[i][j], ai[i][j]);
  }
}

// Complex DFT along the first axis of an [n][nh] complex array, for one tile:
// out[r][c] = sum_t tw(r * t) * in[t][c] with tw = W (sign = +1, forward) or
// conj(W) (sign = -1, inverse).  Accumulators are returned in ar/ai.
__device__ __forceinline__ void col_dft_tile(const Tile& tl, const float2* __restrict__ in,
                                             const float2* __restrict__ tab, int n, int nh,
                                             float sign, float (&ar)[RT][CT],
                                             float (&ai)[RT][CT]) {
  int m[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) m[i] = 0;
  for (int t = 0; t < n; ++t) {
    float2 v[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) v[j] = in[t * nh + tl.cols[j]];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float2 w = tab[m[i]];
      m[i] = advance(m[i], tl.rows[i], n);
      const float c = w.x;
      const float s = sign * w.y;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        // (c + i s) * (vr + i vi)
        ar[i][j] = fmaf(c, v[j].x, fmaf(-s, v[j].y, ar[i][j]));
        ai[i][j] = fmaf(c, v[j].y, fmaf(s, v[j].x, ai[i][j]));
      }
    }
  }
}

// Stage 2: F = W @ T (forward DFT along y) -> out.
__device__ void col_dft(const float2* __restrict__ in, float2* __restrict__ out,
                        const float2* __restrict__ tab, int n, int nh, float sign) {
  for (int tile = threadIdx.x; tile < num_tiles(n, nh); tile += blockDim.x) {
    const Tile tl(tile, n, nh);
    float ar[RT][CT] = {}, ai[RT][CT] = {};
    col_dft_tile(tl, in, tab, n, nh, sign, ar, ai);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j)
        if (tl.row_ok[i] && tl.col_ok[j])
          out[tl.rows[i] * nh + tl.cols[j]] = make_float2(ar[i][j], ai[i][j]);
  }
}

// Stage 2 for the second patch, fused with the cross-power: F2 = W @ T2 stays
// in registers and f1r_inout (holding F1) is overwritten in place with
// d_l * R, R = F1 * conj(F2) * rsqrt(|F1 * conj(F2)|^2 + FLT_EPSILON), where
// d_l is the conjugate-fold weight of x-frequency column l (1 for the
// self-conjugate columns 0 and n/2, 2 otherwise).
__device__ void col_dft_cross_power(const float2* __restrict__ t2, float2* __restrict__ f1_inout,
                                    const float2* __restrict__ tab, int n, int nh) {
  for (int tile = threadIdx.x; tile < num_tiles(n, nh); tile += blockDim.x) {
    const Tile tl(tile, n, nh);
    float ar[RT][CT] = {}, ai[RT][CT] = {};
    col_dft_tile(tl, t2, tab, n, nh, 1.0f, ar, ai);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        if (!(tl.row_ok[i] && tl.col_ok[j])) continue;
        const int idx = tl.rows[i] * nh + tl.cols[j];
        const float2 f1 = f1_inout[idx];
        const float rr = f1.x * ar[i][j] + f1.y * ai[i][j];
        const float ri = f1.y * ar[i][j] - f1.x * ai[i][j];
        const float den = rsqrtf(rr * rr + ri * ri + kFltEpsilon);
        const int l = tl.cols[j];
        const float d = (l == 0 || (n % 2 == 0 && l == n / 2)) ? 1.0f : 2.0f;
        f1_inout[idx] = make_float2(d * rr * den, d * ri * den);
      }
    }
  }
}

// Stage 4, inverse DFT along x of the folded half spectrum, real part only:
// surf[y][x] = scale * sum_l (Ur[y][l] * C(l x) + Ui[y][l] * S(l x)) where
// conj(W) = C - iS.  The fold weights are already in U.
__device__ void row_idft_fold(const float2* __restrict__ U, float* __restrict__ surf,
                              const float2* __restrict__ tab, int n, int nh, float scale) {
  for (int tile = threadIdx.x; tile < num_tiles(n, n); tile += blockDim.x) {
    const Tile tl(tile, n, n);
    float acc[RT][CT] = {};
    int m[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) m[j] = 0;
    for (int l = 0; l < nh; ++l) {
      float2 u[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) u[i] = U[tl.rows[i] * nh + l];
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const float2 w = tab[m[j]];
        m[j] = advance(m[j], tl.cols[j], n);
#pragma unroll
        for (int i = 0; i < RT; ++i)
          acc[i][j] = fmaf(u[i].x, w.x, fmaf(u[i].y, w.y, acc[i][j]));
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j)
        if (tl.row_ok[i] && tl.col_ok[j]) surf[tl.rows[i] * n + tl.cols[j]] = acc[i][j] * scale;
  }
}

template <typename T>
__device__ void stage_patch(const T* __restrict__ src, int width, float* __restrict__ dst, int n) {
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int y = e / n;
    const int x = e - y * n;
    dst[e] = to_f32(src[static_cast<size_t>(y) * width + x]);
  }
}

// (value, shifted flat index) candidate: larger value wins, ties go to the
// smaller index.  NaN values never enter; they are counted in a flag.
__device__ __forceinline__ bool better(float v, int s, float bv, int bs) {
  return v > bv || (v == bv && s < bs);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    phase_correlate_frames_kernel(const T* __restrict__ curr, const T* __restrict__ prev,
                                  int height, int width, int n, int q, int search_radius,
                                  int centroid_radius, const float2* __restrict__ tab_g,
                                  float* __restrict__ shift_out, float* __restrict__ maxval_out) {
  extern __shared__ float2 smem[];
  const int nh = n / 2 + 1;
  float2* buf_a = smem;
  float2* buf_b = buf_a + n * nh;
  float2* buf_c = buf_b + n * nh;
  float2* tab = buf_c + n * nh;

  const int row = blockIdx.x;  // b * q * q + (i + q * j)
  const int qq = q * q;
  const int b = row / qq;
  const int k = row - b * qq;
  const int pi = k % q;
  const int pj = k / q;
  const size_t offset = static_cast<size_t>(b) * height * width +
                        static_cast<size_t>(pj) * n * width + static_cast<size_t>(pi) * n;

  for (int e = threadIdx.x; e < n; e += blockDim.x) tab[e] = tab_g[e];
  float* staged = reinterpret_cast<float*>(buf_a);

  // forward transforms: T1 -> B, T2 -> C, F1 -> A, d * R -> A
  stage_patch(curr + offset, width, staged, n);
  __syncthreads();
  row_dft_half(staged, buf_b, tab, n, nh);
  __syncthreads();
  stage_patch(prev + offset, width, staged, n);
  __syncthreads();
  row_dft_half(staged, buf_c, tab, n, nh);
  __syncthreads();
  col_dft(buf_b, buf_a, tab, n, nh, 1.0f);
  __syncthreads();
  col_dft_cross_power(buf_c, buf_a, tab, n, nh);
  __syncthreads();

  // inverse: U = conj(W) @ (d * R) -> B, real surface -> C
  col_dft(buf_a, buf_b, tab, n, nh, -1.0f);
  __syncthreads();
  float* surf = reinterpret_cast<float*>(buf_c);
  row_idft_fold(buf_b, surf, tab, n, nh, 1.0f / static_cast<float>(n * n));
  __syncthreads();

  // peak: fftshift + mask in index space, argmax with min-shifted-index ties
  const int half = n / 2;
  float best = -INFINITY;
  int best_s = n * n;
  int has_nan = 0;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int y = e / n;
    const int x = e - y * n;
    const int sy = (y + half) % n;
    const int sx = (x + half) % n;
    const bool keep = abs(sy - half) <= search_radius && abs(sx - half) <= search_radius;
    const float v = keep ? surf[e] : 0.0f;
    if (v != v) {
      has_nan = 1;
    } else {
      const int s = sy * n + sx;
      if (better(v, s, best, best_s)) {
        best = v;
        best_s = s;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int os = __shfl_down_sync(0xffffffffu, best_s, off);
    if (better(ov, os, best, best_s)) {
      best = ov;
      best_s = os;
    }
  }
  has_nan = __any_sync(0xffffffffu, has_nan);
  __shared__ float warp_best[kWarps];
  __shared__ int warp_s[kWarps];
  __shared__ int warp_nan[kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    warp_best[warp] = best;
    warp_s[warp] = best_s;
    warp_nan[warp] = has_nan;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    if (better(warp_best[w], warp_s[w], best, best_s)) {
      best = warp_best[w];
      best_s = warp_s[w];
    }
    has_nan |= warp_nan[w];
  }

  // positive-only weighted centroid around the peak, in shifted coordinates
  const int yc = best_s / n;
  const int xc = best_s - yc * n;
  float sw = 0.0f, swx = 0.0f, swy = 0.0f;
  for (int sy = yc - centroid_radius; sy <= yc + centroid_radius; ++sy) {
    if (sy < 0 || sy >= n || abs(sy - half) > search_radius) continue;
    const int y = (sy + n - half) % n;
    for (int sx = xc - centroid_radius; sx <= xc + centroid_radius; ++sx) {
      if (sx < 0 || sx >= n || abs(sx - half) > search_radius) continue;
      const float v = surf[y * n + (sx + n - half) % n];
      if (v > 0.0f) {
        sw += v;
        swx += v * static_cast<float>(sx);
        swy += v * static_cast<float>(sy);
      }
    }
  }
  const float denom = sw + kFltEpsilon;
  float cx = swx / denom - static_cast<float>(half);
  float cy = swy / denom - static_cast<float>(half);
  if (has_nan) {
    best = cx = cy = __int_as_float(0x7fc00000);  // quiet NaN
  }
  shift_out[2 * row] = cx;
  shift_out[2 * row + 1] = cy;
  maxval_out[row] = best;
}

template <typename T>
int launch(const void* curr, const void* prev, int batch, int height, int width, int n, int q,
           int search_radius, int centroid_radius, const void* tab, void* shift, void* maxval,
           cudaStream_t stream, size_t smem) {
  auto* kernel = phase_correlate_frames_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch * q * q, kThreads, smem, stream>>>(
      static_cast<const T*>(curr), static_cast<const T*>(prev), height, width, n, q, search_radius,
      centroid_radius, static_cast<const float2*>(tab), static_cast<float*>(shift),
      static_cast<float*>(maxval));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for patch size n, in bytes.
long long pcf_smem_bytes(int n) {
  return static_cast<long long>(3 * n * (n / 2 + 1) + n) * static_cast<long long>(sizeof(float2));
}

// Launch on `stream`.  is_u8 != 0: uint8 frames, else float32.  Returns the
// CUDA error code of the attribute call or of the launch (0 on success).
int pcf_phase_correlate_frames(const void* curr, const void* prev, int is_u8, int batch, int height,
                               int width, int n, int q, int search_radius, int centroid_radius,
                               const void* tab, void* shift, void* maxval, void* stream) {
  const size_t smem = static_cast<size_t>(pcf_smem_bytes(n));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_u8)
    return launch<uint8_t>(curr, prev, batch, height, width, n, q, search_radius, centroid_radius,
                           tab, shift, maxval, s, smem);
  return launch<float>(curr, prev, batch, height, width, n, q, search_radius, centroid_radius, tab,
                       shift, maxval, s, smem);
}

}  // extern "C"
