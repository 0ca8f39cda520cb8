// Patch-batch phase correlation for Hopper (sm_90a), any patch size n:
// kernel D.
//
// Replaces the TPU kernel mrs_optic_flow_tpu/ops/pallas_kernels.py::
// phase_correlate_fullfused_pallas (kernel _fullfused_kernel, bodies
// _phase_correlate_body_half / _phase_correlate_body, peak stage
// _masked_peak_centroid).  For every pair of [n, n] patches (uint8 or
// float32): the real 2-D transform of both, the normalized cross-power
// F1 * conj(F2) * rsqrt(|.|^2 + FLT_EPSILON), the inverse (real part, scaled
// by 1/n^2), then kernel B's peak (peak_refine.cuh): fftshift and
// +-search_radius mask in index space, argmax with ties on the minimum
// fftshifted flat index, the positive-only radius-`centroid_radius` centroid
// with an FLT_EPSILON-seeded denominator; NaN in the search window gives NaN.
//
// What bounds it on this card.  An FFT phase correlation of one n x n pair
// is 7.5 n^2 log2(n^2) + 12 n (n/2 + 1) operations (0.34 MFLOP at n = 60,
// 32 MFLOP at n = 480) against 2 n^2 input bytes: arithmetic bounds it, a
// few tenths of a microsecond at the node's shapes, so in practice the
// passes over shared memory and the launch floor do.  The design before
// this one ran direct DFTs as tiled matrix products, 12 to 62 times the FFT's
// operations, through five launches a chunk.  Now every 1-D transform is the
// mixed-radix FFT of fft_stages.cuh (radices 8, 4, 2, 3, 5, then a direct sum
// for any larger prime factor), in one of two designs chosen by n:
//
// Small n (W = n + n % 2, 8 W^2 bytes of shared memory plus the static
// reserve within the 232,448 B a block may opt into: n <= 170), one block a
// pair, the whole pair in one W x W complex buffer, as kernel A
// (phase_correlate_frames.cu) does for n a multiple of 8:
//   1. load: buffer row 2p holds curr rows (2p, 2p + 1) as the real and
//      imaginary parts of one complex row, row 2p + 1 the same of prev; for
//      odd n the last row goes alone with a zero imaginary part (rows of one
//      patch only, never curr with prev: a zero patch then stays exactly
//      zero, and a one-sided zero pair gives a surface of exact zeros, every
//      entry a tie).  The self-conjugate bins, F(0, 0) and for even n also
//      F(n/2, 0), F(0, n/2) and F(n/2, n/2), are summed directly on the way:
//      exact for integer pixels, so a bin that is exactly zero stays zero
//      (the FFT's rounding would make it a unit after the normalization);
//   2. the forward FFT of every buffer row;
//   3. the Hermitian split of each row pair into the half spectra of its real
//      rows: row r then holds [T1_r | T2_r], W/2 slots each (even n: slot 0
//      packs the real bins 0 and n/2; odd n: slots 0 .. (n-1)/2);
//   4. the forward FFT of every column;
//   5. the cross-power into the curr half (even n: the packed column 0 split
//      and packed again, as in kernel A), the direct sums in place of the
//      self-conjugate bins;
//   6. the inverse FFT of the curr half's columns;
//   7. each row pair packed into one complex row, Hermitian-extended (the
//      {1, 2, ..., 2, 1} fold weights) and scaled by 1/n^2;
//   8. the inverse row FFTs: row 2p holds surface rows 2p and 2p + 1;
//   9. the peak over the search window's rows and columns only, one warp a
//      row, read from shared memory, then the centroid warp.
//
// Large n (n >= 171), staged through a scratch in device memory that the
// caller sizes to stay in the 50 MB L2 cache, four launches a chunk:
//   1. rows_forward: the packed row FFTs of both patches and the Hermitian
//      split into half spectra T [2, n, n/2 + 1] a pair;
//   2. cols_fused: a block holds all n rows of a band of kBand columns of
//      both patches: their forward column FFTs, the cross-power and the
//      inverse column FFTs, back into the curr half of T;
//   3. rows_inverse: row pairs Hermitian-extended and packed, the inverse row
//      FFTs, the real surface into the prev half of T (dead by then); it also
//      zeroes the counters of 4;
//   4. kernel B's split peak (peak::peak_split_kernel): each surface over
//      the k blocks of band_rows window rows that the caller passes
//      (ops/cuda_kernels.py::peak_split, kernel B's rule), reading only the
//      search window.
//
// uint8 patches are converted exactly on load and then take the same code as
// float32 ones, so both give bit-identical results; every sum runs in a fixed
// order, so a pair gives the same result in any batch.
//
// Numerics: float32 throughout, IEEE division and square roots (built
// without --use_fast_math); rsqrtf for the cross-power normalization.
//
// Plain C interface, loaded with ctypes.  The kernels allocate nothing; the
// caller passes the scratch, the output buffers and the stream.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "fft_stages.cuh"
#include "peak_refine.cuh"

namespace {

using fft::buffer_side;
using fft::conj;
using fft::cross_power;
using fft::csub;
using fft::kSmallMaxW;
using fft::small_route;

constexpr int kThreads = fft::kThreads;  // a block of the large design's passes
constexpr int kSmallThreads = 512;       // a block of the small design
constexpr int kSmallWarps = kSmallThreads / 32;
constexpr int kSlotsPerLane = (kSmallMaxW / 2 + 31) / 32;

__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// The two real rows of a packed row Z = a + i b, from its spectrum P:
// A(l) = (P(l) + conj P(-l)) / 2 and B(l) = (P(l) - conj P(-l)) / 2i.
__device__ __forceinline__ void hermitian_split(float2 p, float2 q, float2& a, float2& b) {
  const float2 c = conj(q);
  const float2 d = csub(p, c);
  a = make_float2(0.5f * (p.x + c.x), 0.5f * (p.y + c.y));
  b = make_float2(0.5f * d.y, -0.5f * d.x);
}

// Row (V(l), V(n - l)) of two real rows' half spectra u1, u2 at slot l:
// V = H1 + i H2, H the Hermitian extension, scaled.
__device__ __forceinline__ void hermitian_pack(float2 u1, float2 u2, float scale, float2& v, float2& w) {
  v = make_float2(scale * (u1.x - u2.y), scale * (u1.y + u2.x));
  w = make_float2(scale * (u1.x + u2.y), scale * (u2.x - u1.y));
}

// ---------------------------------------------------------------------------
// small n: one block a pair
// ---------------------------------------------------------------------------

// N > 0: the kernel for patch size N alone, every size and index division
// known to the compiler (sizes the engines route here, run_small);
// N = 0: any n up to kSmallMaxW, from `plan`.
template <typename T, int N>
__global__ void __launch_bounds__(kSmallThreads)
    small_kernel(const T* __restrict__ curr_g, const T* __restrict__ prev_g, fft::Plan plan,
                 int search_radius, int centroid_radius, const float2* __restrict__ tab,
                 float* __restrict__ shift_out, float* __restrict__ maxval_out) {
  extern __shared__ float2 buf[];
  __shared__ short pm[kSmallMaxW];   // perm of the plan
  __shared__ float exact[kSmallWarps][8];  // each warp's partial self-conjugate bins
  const int n = N > 0 ? N : plan.n, odd = n & 1, w = n + odd, s_half = w / 2, h = n / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  const T* __restrict__ curr = curr_g + off;
  const T* __restrict__ prev = prev_g + off;

  fft::fill_perm(pm, plan);
  // 1. load, and the self-conjugate bins [patch][F(0,0), F(h,0), F(0,h), F(h,h)];
  // kLoad elements a thread a round, their loads issued together
  constexpr int kLoad = 4;
  float part[8] = {};
  for (int e0 = threadIdx.x; e0 < w * n; e0 += kLoad * kSmallThreads) {
    float a[kLoad], b[kLoad];
#pragma unroll
    for (int i = 0; i < kLoad; ++i) {
      const int e = e0 + i * kSmallThreads;
      const int r = e / n, c = e - r * n, y = r & ~1;
      const T* __restrict__ src = (r & 1) ? prev : curr;
      a[i] = e < w * n ? to_f32(src[y * n + c]) : 0.0f;
      b[i] = e < w * n && y + 1 < n ? to_f32(src[(y + 1) * n + c]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kLoad; ++i) {
      const int e = e0 + i * kSmallThreads;
      if (e >= w * n) continue;
      const int r = e / n, c = e - r * n;
      buf[r * w + c] = make_float2(a[i], b[i]);
      const float sx = (c & 1) ? -1.0f : 1.0f;
      const float v[4] = {a[i] + b[i], a[i] - b[i], sx * (a[i] + b[i]), sx * (a[i] - b[i])};
      const float to_curr = (r & 1) ? 0.0f : 1.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        part[j] += to_curr * v[j];
        part[4 + j] += (1.0f - to_curr) * v[j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    for (int o = 16; o > 0; o >>= 1) part[i] += __shfl_xor_sync(0xffffffffu, part[i], o);
    if (lane == 0) exact[warp][i] = part[i];
  }
  __syncthreads();

  // 2. row FFTs
  fft::forward<N>(buf, w, w, 1, plan, tab);

  // 3. split each row pair into [T1 | T2] of its two real rows
  for (int p = warp; p < s_half; p += kSmallWarps) {
    float2* r0 = buf + 2 * p * w;
    float2* r1 = r0 + w;
    const bool lone = odd && p == s_half - 1;
    float2 out[kSlotsPerLane][4];
#pragma unroll
    for (int i = 0; i < kSlotsPerLane; ++i) {
      const int l = lane + 32 * i;
      if (l >= s_half) continue;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float2* r = s ? r1 : r0;
        const float2 a = r[pm[l]];
        if (l == 0) {
          // A(0) = Re P(0), B(0) = Im P(0); even n packs A(n/2), B(n/2) beside them
          const float2 b = odd ? make_float2(0.0f, 0.0f) : r[pm[h]];
          out[i][2 * s] = make_float2(a.x, b.x);
          out[i][2 * s + 1] = make_float2(a.y, b.y);
        } else if (lone) {
          out[i][2 * s] = a;
        } else {
          hermitian_split(a, r[pm[n - l]], out[i][2 * s], out[i][2 * s + 1]);
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kSlotsPerLane; ++i) {
      const int l = lane + 32 * i;
      if (l >= s_half) continue;
      r0[l] = out[i][0];           // T1, real row 2p
      r0[s_half + l] = out[i][2];  // T2, real row 2p
      if (!lone) {
        r1[l] = out[i][1];           // T1, real row 2p + 1
        r1[s_half + l] = out[i][3];  // T2, real row 2p + 1
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // 4. column FFTs: w columns of n rows
  fft::forward<N>(buf, w, 1, w, plan, tab);

  // 5. cross-power into the curr half
  float e1[4] = {}, e2[4] = {};
  for (int v = 0; v < kSmallWarps; ++v)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e1[i] += exact[v][i];
      e2[i] += exact[v][4 + i];
    }
  if (odd) {
    for (int t = threadIdx.x; t < n * s_half; t += kSmallThreads) {
      const int r = t / s_half, l = t - r * s_half;
      float2* f = buf + r * w + l;
      const bool dc = r == 0 && l == 0;  // pm[0] == 0: F(0, 0)
      *f = cross_power(dc ? make_float2(e1[0], 0.0f) : *f, dc ? make_float2(e2[0], 0.0f) : f[s_half]);
    }
  } else {
    for (int t = threadIdx.x; t < n * (h - 1); t += kSmallThreads) {
      const int r = t / (h - 1), l = 1 + t - r * (h - 1);
      float2* f = buf + r * w + l;
      *f = cross_power(*f, f[h]);
    }
    // the packed columns C = F(., 0) + i F(., n/2) of each patch, one task a
    // frequency pair (ky, -ky), ky = 0 .. n/2
    for (int ky = threadIdx.x; ky <= h; ky += kSmallThreads) {
      float2* c1 = buf + pm[ky] * w;
      float2* c2 = buf + pm[(n - ky) % n] * w;
      float2 f[2][2];  // [patch][column 0, column n/2]
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (ky == 0 || ky == h) {
          const int o = ky == 0 ? 0 : 1;
          const float* e = s ? e2 : e1;
          f[s][0] = make_float2(e[o], 0.0f);
          f[s][1] = make_float2(e[2 + o], 0.0f);
        } else {
          hermitian_split(c1[s * h], c2[s * h], f[s][0], f[s][1]);
        }
      }
      const float2 q0 = cross_power(f[0][0], f[1][0]);
      const float2 qh = cross_power(f[0][1], f[1][1]);
      *c1 = make_float2(q0.x - qh.y, q0.y + qh.x);                // R0 + i Rh at ky
      if (c2 != c1) *c2 = make_float2(q0.x + qh.y, qh.x - q0.y);  // at -ky
    }
  }
  __syncthreads();

  // 6. inverse FFTs of the curr half's columns
  fft::inverse<N>(buf, s_half, 1, w, plan, tab);

  // 7. pack row pairs, Hermitian-extended, into row 2p in perm order
  const float scale = 1.0f / static_cast<float>(n * n);
  for (int p = warp; p < s_half; p += kSmallWarps) {
    float2* r0 = buf + 2 * p * w;
    const float2* r1 = r0 + w;
    const bool lone = odd && p == s_half - 1;
    float2 v[kSlotsPerLane][2];
#pragma unroll
    for (int i = 0; i < kSlotsPerLane; ++i) {
      const int l = lane + 32 * i;
      if (l >= s_half) continue;
      const float2 u1 = r0[l];
      const float2 u2 = lone ? make_float2(0.0f, 0.0f) : r1[l];
      if (l == 0) {  // even n: U(0) + i U(n/2), both real; odd n: U(0), real
        v[i][0] = make_float2(scale * u1.x, scale * u2.x);
        v[i][1] = make_float2(scale * u1.y, scale * u2.y);
      } else {
        hermitian_pack(u1, u2, scale, v[i][0], v[i][1]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kSlotsPerLane; ++i) {
      const int l = lane + 32 * i;
      if (l >= s_half) continue;
      r0[pm[l]] = v[i][0];
      if (l > 0 || !odd) r0[pm[l == 0 ? h : n - l]] = v[i][1];
    }
    __syncwarp();
  }
  __syncthreads();

  // 8. inverse row FFTs of the packed rows
  fft::inverse<N>(buf, s_half, 2 * w, 1, plan, tab);

  // 9. the peak
  const float* sf = reinterpret_cast<const float*>(buf);
  peak::window_peak([sf, w](int y, int x) { return sf[2 * ((y & ~1) * w + x) + (y & 1)]; }, n,
                    search_radius, centroid_radius, blockIdx.x, shift_out, maxval_out);
}

// ---------------------------------------------------------------------------
// large n: four launches a chunk through the scratch
// ---------------------------------------------------------------------------

// scratch of a chunk: T [c, 2, n, nh] float2 (nh = n/2 + 1), then the peak's
// part values, indices, NaN flags (c * n each at most) and c counters
struct Layout {
  int n, nh, pr;  // pr: packed rows a patch, (n + 1) / 2
  size_t half;    // n * nh, one half-spectrum matrix
  __host__ __device__ float2* t(float2* base, int pair, int s) const {
    return base + (2 * static_cast<size_t>(pair) + s) * half;
  }
};

__host__ __device__ inline Layout layout(int n) {
  Layout l;
  l.n = n;
  l.nh = n / 2 + 1;
  l.pr = (n + 1) / 2;
  l.half = static_cast<size_t>(n) * l.nh;
  return l;
}

// packed rows a block in the row passes, columns of each patch a block in
// the column pass
__host__ __device__ inline int large_lines(int n) { return fft::pass_lines(8LL * n + 4, fft::kLines); }
__host__ __device__ inline int large_band(int n) { return fft::pass_lines(16LL * n + 4, fft::kBand); }

// 1. packed rows (2p, 2p + 1) of patch s, lines s * pr + p of pair
// blockIdx.y, `lines` a block: FFT, Hermitian split, half spectra into T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rows_forward(const T* __restrict__ curr_g, const T* __restrict__ prev_g, fft::Plan plan,
                 int lines, const float2* __restrict__ tab, float2* __restrict__ scratch) {
  extern __shared__ float2 buf[];
  const int n = plan.n;
  const Layout lay = layout(n);
  int* pm = reinterpret_cast<int*>(buf + lines * n);
  const int pair = blockIdx.y;
  const int first = blockIdx.x * lines;
  const int count = min(lines, 2 * lay.pr - first);
  fft::fill_perm(pm, plan);
  for (int e = threadIdx.x; e < count * n; e += kThreads) {
    const int li = e / n, c = e - li * n;
    const int line = first + li;
    const int s = line >= lay.pr, y = 2 * (line - s * lay.pr);
    const T* __restrict__ src = (s ? prev_g : curr_g) + static_cast<size_t>(pair) * n * n;
    const float a = to_f32(src[y * n + c]);
    const float b = y + 1 < n ? to_f32(src[(y + 1) * n + c]) : 0.0f;
    buf[li * n + c] = make_float2(a, b);
  }
  __syncthreads();
  fft::forward(buf, count, n, 1, plan, tab);
  for (int e = threadIdx.x; e < count * lay.nh; e += kThreads) {
    const int li = e / lay.nh, l = e - li * lay.nh;
    const int line = first + li;
    const int s = line >= lay.pr, y = 2 * (line - s * lay.pr);
    const float2* row = buf + li * n;
    float2* dst = lay.t(scratch, pair, s);
    const float2 a = row[pm[l]];
    if (y + 1 < n) {
      float2 t1, t2;
      hermitian_split(a, row[pm[(n - l) % n]], t1, t2);
      dst[y * lay.nh + l] = t1;
      dst[(y + 1) * lay.nh + l] = t2;
    } else {
      dst[y * lay.nh + l] = a;  // the lone last row of odd n
    }
  }
}

// 2. columns l0 .. l0 + band - 1 (band = blockDim's share, blockIdx.x) of
// both patches of pair blockIdx.y, all n rows in shared memory as
// [y][patch][column]: forward column FFTs, the cross-power into the curr
// half, inverse column FFTs of the curr half, back into T's curr half.
__global__ void __launch_bounds__(kThreads)
    cols_fused(fft::Plan plan, int band, const float2* __restrict__ tab, float2* __restrict__ scratch) {
  extern __shared__ float2 buf[];
  const int n = plan.n;
  const Layout lay = layout(n);
  const int pair = blockIdx.y;
  const int l0 = blockIdx.x * band;
  const int bw = min(band, lay.nh - l0);
  const int stride = 2 * band;
  for (int e = threadIdx.x; e < n * stride; e += kThreads) {
    const int y = e / stride, i = e - y * stride;
    const int s = i >= band, cl = i - s * band;
    buf[e] = cl < bw ? lay.t(scratch, pair, s)[y * lay.nh + l0 + cl] : make_float2(0.0f, 0.0f);
  }
  __syncthreads();
  fft::forward(buf, 2 * band, 1, stride, plan, tab);
  for (int e = threadIdx.x; e < n * band; e += kThreads) {
    const int y = e / band, cl = e - y * band;
    float2* f = buf + y * stride + cl;
    *f = cross_power(*f, f[band]);
  }
  __syncthreads();
  fft::inverse(buf, band, 1, stride, plan, tab);
  float2* u = lay.t(scratch, pair, 0);
  for (int e = threadIdx.x; e < n * band; e += kThreads) {
    const int y = e / band, cl = e - y * band;
    if (cl < bw) u[y * lay.nh + l0 + cl] = buf[y * stride + cl];
  }
}

// 3. packed surface rows (2p, 2p + 1) of pair blockIdx.y, `lines` a block:
// the Hermitian extension of U's rows 2p and 2p + 1 as one complex row,
// scaled by 1/n^2, in perm order; the inverse FFT; the surface rows into
// T's prev half.  Block (0, 0) zeroes the c counters of the peak.
__global__ void __launch_bounds__(kThreads)
    rows_inverse(fft::Plan plan, int lines, const float2* __restrict__ tab,
                 float2* __restrict__ scratch, unsigned* __restrict__ counters, int c) {
  extern __shared__ float2 buf[];
  const int n = plan.n;
  const Layout lay = layout(n);
  int* pm = reinterpret_cast<int*>(buf + lines * n);
  const int pair = blockIdx.y;
  const int first = blockIdx.x * lines;
  const int count = min(lines, lay.pr - first);
  if (blockIdx.x == 0 && blockIdx.y == 0)
    for (int i = threadIdx.x; i < c; i += kThreads) counters[i] = 0u;
  fft::fill_perm(pm, plan);
  __syncthreads();
  const float2* u = lay.t(scratch, pair, 0);
  const float scale = 1.0f / static_cast<float>(n * n);
  for (int e = threadIdx.x; e < count * lay.nh; e += kThreads) {
    const int li = e / lay.nh, l = e - li * lay.nh;
    const int y = 2 * (first + li);
    const float2 u1 = u[y * lay.nh + l];
    const float2 u2 = y + 1 < n ? u[(y + 1) * lay.nh + l] : make_float2(0.0f, 0.0f);
    float2* row = buf + li * n;
    if (l == 0 || 2 * l == n) {  // real bins: the Hermitian part
      row[pm[l]] = make_float2(scale * u1.x, scale * u2.x);
    } else {
      float2 v, w;
      hermitian_pack(u1, u2, scale, v, w);
      row[pm[l]] = v;
      row[pm[n - l]] = w;
    }
  }
  __syncthreads();
  fft::inverse(buf, count, n, 1, plan, tab);
  float* surf = reinterpret_cast<float*>(lay.t(scratch, pair, 1));
  for (int e = threadIdx.x; e < count * n; e += kThreads) {
    const int li = e / n, x = e - li * n;
    const int y = 2 * (first + li);
    const float2 v = buf[li * n + x];
    surf[y * n + x] = v.x;
    if (y + 1 < n) surf[(y + 1) * n + x] = v.y;
  }
}

long long small_smem(int n) {
  const long long w = buffer_side(n);
  return 8 * w * w;
}

long long large_smem(int n) {
  const long long rows = static_cast<long long>(large_lines(n)) * n * 8 + 4LL * n;
  const long long cols = 16LL * large_band(n) * n;
  return rows > cols ? rows : cols;
}

template <typename T, int N>
int launch_small(const T* curr, const T* prev, int p, const fft::Plan& plan, int search_radius,
                 int centroid_radius, const float2* tab, float* shift, float* maxval,
                 cudaStream_t stream) {
  const long long smem = small_smem(plan.n);
  const cudaError_t err = fft::allow_smem(reinterpret_cast<const void*>(small_kernel<T, N>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  small_kernel<T, N><<<p, kSmallThreads, smem, stream>>>(curr, prev, plan, search_radius,
                                                         centroid_radius, tab, shift, maxval);
  return static_cast<int>(cudaGetLastError());
}

// the patch sizes with a kernel of their own: 60 (the 480/60 windows of
// short and long range), 150 (frame 600 / patch 150, scale_factor 0.8)
template <typename T>
int run_small(const T* curr, const T* prev, int p, const fft::Plan& plan, int search_radius,
              int centroid_radius, const float2* tab, float* shift, float* maxval,
              cudaStream_t stream) {
  switch (plan.n) {
    case 60:
      return launch_small<T, 60>(curr, prev, p, plan, search_radius, centroid_radius, tab, shift,
                                 maxval, stream);
    case 150:
      return launch_small<T, 150>(curr, prev, p, plan, search_radius, centroid_radius, tab, shift,
                                  maxval, stream);
    default:
      return launch_small<T, 0>(curr, prev, p, plan, search_radius, centroid_radius, tab, shift,
                                maxval, stream);
  }
}

template <typename T>
int run_large(const T* curr, const T* prev, int p, const fft::Plan& plan, int chunk,
              int search_radius, int centroid_radius, int k, int band_rows, const float2* tab,
              float2* scratch, float* shift, float* maxval, cudaStream_t stream) {
  const int n = plan.n;
  const Layout lay = layout(n);
  const int lines = large_lines(n), band = large_band(n);
  const long long row_smem = static_cast<long long>(lines) * n * 8 + 4LL * n;
  const long long col_smem = 16LL * band * n;
  cudaError_t err = fft::allow_smem(reinterpret_cast<const void*>(rows_forward<T>), row_smem);
  if (err == cudaSuccess) err = fft::allow_smem(reinterpret_cast<const void*>(cols_fused), col_smem);
  if (err == cudaSuccess) err = fft::allow_smem(reinterpret_cast<const void*>(rows_inverse), row_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = n % 4 == 0;  // then n * nh is even: every surface 16-byte aligned
  for (int p0 = 0; p0 < p; p0 += chunk) {
    const int c = p - p0 < chunk ? p - p0 : chunk;
    const size_t off = static_cast<size_t>(p0) * n * n;
    float* part_val = reinterpret_cast<float*>(scratch + 2 * static_cast<size_t>(c) * lay.half);
    int* part_idx = reinterpret_cast<int*>(part_val + static_cast<size_t>(c) * n);
    int* part_nan = part_idx + static_cast<size_t>(c) * n;
    unsigned* counters = reinterpret_cast<unsigned*>(part_nan + static_cast<size_t>(c) * n);
    rows_forward<T><<<dim3((2 * lay.pr + lines - 1) / lines, c), kThreads, row_smem, stream>>>(
        curr + off, prev + off, plan, lines, tab, scratch);
    cols_fused<<<dim3((lay.nh + band - 1) / band, c), kThreads, col_smem, stream>>>(plan, band, tab,
                                                                                   scratch);
    rows_inverse<<<dim3((lay.pr + lines - 1) / lines, c), kThreads, row_smem, stream>>>(
        plan, lines, tab, scratch, counters, c);
    const float* surf = reinterpret_cast<const float*>(lay.t(scratch, 0, 1));
    const size_t stride = 4 * lay.half;  // floats from one pair's surface to the next
    err = peak::launch_split(surf, stride, c, n, search_radius, centroid_radius, k, band_rows, vec,
                             part_val, part_idx, part_nan, counters, shift + 2 * p0, maxval + p0,
                             nullptr, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename T>
int run(const T* curr, const T* prev, int p, int n, int chunk, int search_radius,
        int centroid_radius, int k, int band_rows, const float2* tab, float2* scratch,
        float* shift, float* maxval, cudaStream_t stream) {
  const fft::Plan plan = fft::make_plan(n);
  if (plan.stages < 0 || p < 0 ||
      (!small_route(n) && (chunk < 1 || !peak::valid_split(n, search_radius, k, band_rows))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p == 0) return 0;
  if (small_route(n))
    return run_small(curr, prev, p, plan, search_radius, centroid_radius, tab, shift, maxval, stream);
  return run_large(curr, prev, p, plan, chunk, search_radius, centroid_radius, k, band_rows, tab,
                   scratch, shift, maxval, stream);
}

}  // namespace

extern "C" {

// Which design takes patch size n: 0 one block a pair, 1 the staged passes,
// -1 none (n < 1, or a prime factor above fft::kMaxGenericRadix).
int pcff_route(int n) {
  if (fft::make_plan(n).stages < 0) return -1;
  return small_route(n) ? 0 : 1;
}

// The radices of n's FFT plan, in stage order, into radices[0 ..
// fft::kMaxStages); returns the number of stages (-1 as pcff_route).
int pcff_plan(int n, int* radices) {
  const fft::Plan plan = fft::make_plan(n);
  for (int s = 0; s < plan.stages; ++s) radices[s] = plan.radix[s];
  return plan.stages;
}

// Dynamic shared memory of the largest block for patch size n, in bytes:
// the small design's W x W complex buffer, or the large design's row or
// column pass.
long long pcff_smem_bytes(int n) { return small_route(n) ? small_smem(n) : large_smem(n); }

// Scratch bytes one patch pair needs for patch size n: none for the small
// design; for the large one its two half spectra and its share of the
// peak's parts and counter.
long long pcff_scratch_bytes(int n) {
  if (small_route(n)) return 0;
  const long long nh = n / 2 + 1;
  return 16LL * n * nh + 12LL * n + 4;
}

// Launch on `stream` over p pairs of [n, n] patches; the large design goes
// `chunk` pairs at a time (scratch: chunk * pcff_scratch_bytes(n) bytes,
// 16-byte aligned; chunk <= 65535) and splits each surface's peak over k
// blocks of band_rows window rows (peak::valid_split; the small design
// ignores both).  is_u8 != 0: uint8 patches, else float32.  Returns the
// first CUDA error code of an attribute call or a launch (0 on success).
int pcff_phase_correlate_fullfused(const void* curr, const void* prev, int is_u8, int p, int n,
                                   int chunk, int search_radius, int centroid_radius, int k,
                                   int band_rows, const void* tab, void* scratch, void* shift,
                                   void* maxval, void* stream) {
  const auto* w = static_cast<const float2*>(tab);
  auto* s = static_cast<float2*>(scratch);
  auto* sh = static_cast<float*>(shift);
  auto* mv = static_cast<float*>(maxval);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_u8)
    return run(static_cast<const uint8_t*>(curr), static_cast<const uint8_t*>(prev), p, n, chunk,
               search_radius, centroid_radius, k, band_rows, w, s, sh, mv, st);
  return run(static_cast<const float*>(curr), static_cast<const float*>(prev), p, n, chunk,
             search_radius, centroid_radius, k, band_rows, w, s, sh, mv, st);
}

}  // extern "C"
