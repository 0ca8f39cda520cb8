// Whole-frame batched phase correlation for Hopper (sm_90a): kernel A.
//
// Replaces the TPU kernel mrs_optic_flow_tpu/ops/pallas_kernels.py::
// phase_correlate_frames_pallas (kernel body _fullfused_frames_kernel with
// _pc_bands_body_half and the peak stage _masked_peak_centroid).  It computes
// the same thing: for every patch of a q x q grid cut straight out of
// [B, H, W] frame pairs (H = W = q * n, n a multiple of 8 up to 168), the 2-D
// DFT of both real patches, the normalized cross-power
// F1 * conj(F2) * rsqrt(|.|^2 + FLT_EPSILON), its inverse (real part, scaled
// by 1/n^2), the fftshift and the +-search_radius mask in index space, the
// argmax with ties broken on the minimum fftshifted flat index, and the
// positive-only weighted centroid over a (2 * centroid_radius + 1)^2 window
// with an FLT_EPSILON-seeded denominator.  NaN anywhere inside the search
// window gives NaN maxval and NaN shifts.  Output field order is i + q * j
// (i = column patch).
//
// What bounds it on this card.  A real 2-D FFT phase correlation of one
// n = 120 window needs about 1.58 MFLOP (5 n^2 log2(n^2) for the forward
// complex transform of both patches, half that for the inverse, 12 a bin for
// the cross-power) against 28.8 KB of uint8 input: about 55 FLOP a byte, above
// the card's FP32 ridge (67 TFLOP/s over 3.35 TB/s = 20), so the bound is
// arithmetic: 65,536 windows (B = 4096) in 1.55 ms.  The direct DFT that this
// kernel used before counted 31.6 MFLOP a window, 20 times more.
//
// The design.  One block per window, one n x n complex buffer in shared memory
// (n^2 * 8 bytes: 115,200 B at n = 120, so two blocks share an SM), and every
// 1-D transform of length n = 8 m as a four-step FFT in place: a radix-8
// butterfly in registers over elements j1 + m j2 (multiplies by +-1, +-i and
// (+-1 +- i)/sqrt(2) only), the twiddle W_n^(j1 k2), then an m-point direct
// DFT over j1 (m <= 21, unrolled: m a template parameter), its conjugate
// symmetry pairing j with m - j and k with m - k (a quarter of the direct
// sum's multiplies).  Each step reads and writes one set of positions per
// thread, so the transform needs no second buffer; its output sits in the
// permuted order k -> (k >> 3) + m (k & 7), and the inverse takes that order
// back to the natural one.  About 2 MFLOP a 120 px window are executed (the
// m-point DFTs are direct), 1.3 times the count above; the nine passes over
// shared memory, each latency-bound with 16 warps an SM, hold the kernel at
// about a sixth of the bound at B = 4096 (PERF.md).  The stages:
//   1. load, 4 pixels of two rows a thread: row 2p of the buffer holds curr
//      rows (2p, 2p + 1) as the real and imaginary parts of one complex
//      row, row 2p + 1 the same of prev;
//      the four self-conjugate bins of each patch, F(0, 0), F(n/2, 0),
//      F(0, n/2) and F(n/2, n/2), are summed directly on the way;
//   2. n forward row FFTs;
//   3. split each row pair into the half spectra of its two real rows by
//      Hermitian symmetry, T(l) = (P(l) + conj P(-l)) / 2 and
//      (P(l) - conj P(-l)) / 2i; row r then holds [T1_r | T2_r], n/2 complex
//      each, slot 0 packing the real DC and Nyquist bins;
//   4. n forward column FFTs (the packed column 0 of each patch splits the
//      same way in stage 5);
//   5. cross-power into the curr half, column 0 packing the (real-output)
//      columns l = 0 and l = n/2 as Q = R(., 0) + i R(., n/2), the four
//      self-conjugate bins taken from the sums of stage 1;
//   6. n/2 inverse column FFTs;
//   7. pack rows (2p, 2p + 1) into one complex row, Hermitian-extended
//      (this is where the {1, 2, ..., 2, 1} fold weights come in) and scaled
//      by 1/n^2;
//   8. n/2 inverse row FFTs: row 2p holds surface rows 2p and 2p + 1 as real
//      and imaginary parts;
//   9. the peak, as _masked_peak_centroid: one warp a buffer row (two
//      surface rows), then warp 0 for the centroid.
// A zero patch stays exactly zero through every stage (its rows are packed
// with rows of the same patch only), so a zero pair, and a one-sided zero
// pair, give a surface of exact zeros: every entry a tie, as the twin gives.
// The direct sums of stage 1 are exact for integer pixels.  The twin's DFT
// gets those four real bins exactly too, and where one is exactly zero for
// the integer patch, the FFT's rounding would turn it into a unit after the
// normalization: a (+-1)^(x+y) / n^2 ripple on the surface, 0.011 px of
// centroid at n = 24.
//
// Tensor cores do not pay here: bf16x3 DFT-as-GEMM costs 6.3 ms at B = 4096
// on their peak, four times this bound.
//
// Twiddles come from the float64-built table W(k) = exp(-2 pi i k / n)
// (row 1 of the JAX package's _dft_matrices(n), cast to float32), read from
// device memory through L1: W_n^(j1 k2) at j1 * k2 < n and W_m^(j1 k1) at
// 8 * (j1 k1 mod m).  No sincos on the device.
//
// Numerics: float32 throughout, built without --use_fast_math; rsqrtf for the
// cross-power normalization.
//
// Plain C interface, loaded with ctypes.  The kernel allocates nothing; the
// caller passes the output buffers and the stream.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <utility>

namespace {

// 256 threads a block: 512 (one block an SM at n = 120, for its registers)
// and a persistent grid of two blocks an SM walking the windows were both
// slower at B = 4096 (PERF.md, Findings).  -DPCF_THREADS=T builds a tuning
// variant with T threads (scripts/tune_frames_kernel_torch.py); without it
// the build is the shipped kernel.
#ifndef PCF_THREADS
#define PCF_THREADS 256
#endif
constexpr int kThreads = PCF_THREADS;
static_assert(kThreads % 32 == 0 && kThreads >= 32 && kThreads <= 1024,
              "PCF_THREADS: whole warps, 32 to 1024 threads");
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 21;  // n = 8 m <= 168
constexpr float kFltEpsilon = 1.1920928955078125e-07f;  // FLT_EPSILON
constexpr float kSqrtHalf = 0.70710678118654752440f;

__device__ __forceinline__ float2 operator+(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 operator-(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * conj(b)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}
__device__ __forceinline__ float2 conj(float2 a) { return make_float2(a.x, -a.y); }

// a * W4, W4 = -i (forward) or +i (inverse)
template <bool kInv>
__device__ __forceinline__ float2 mul_w4(float2 a) {
  return kInv ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}
// a * W8 and a * W8^3, W8 = (1 -+ i) / sqrt(2)
template <bool kInv>
__device__ __forceinline__ float2 mul_w8(float2 a) {
  return kInv ? make_float2((a.x - a.y) * kSqrtHalf, (a.x + a.y) * kSqrtHalf)
              : make_float2((a.x + a.y) * kSqrtHalf, (a.y - a.x) * kSqrtHalf);
}
template <bool kInv>
__device__ __forceinline__ float2 mul_w8_3(float2 a) {
  return kInv ? make_float2(-(a.x + a.y) * kSqrtHalf, (a.x - a.y) * kSqrtHalf)
              : make_float2((a.y - a.x) * kSqrtHalf, -(a.x + a.y) * kSqrtHalf);
}

template <bool kInv>
__device__ __forceinline__ void dft4(float2& x0, float2& x1, float2& x2, float2& x3) {
  const float2 t0 = x0 + x2, t1 = x0 - x2, t2 = x1 + x3, t3 = mul_w4<kInv>(x1 - x3);
  x0 = t0 + t2;
  x2 = t0 - t2;
  x1 = t1 + t3;
  x3 = t1 - t3;
}

// 8-point DFT in registers, natural order in and out
template <bool kInv>
__device__ __forceinline__ void dft8(float2 (&v)[8]) {
  dft4<kInv>(v[0], v[2], v[4], v[6]);
  dft4<kInv>(v[1], v[3], v[5], v[7]);
  const float2 o[4] = {v[1], mul_w8<kInv>(v[3]), mul_w4<kInv>(v[5]), mul_w8_3<kInv>(v[7])};
  const float2 e[4] = {v[0], v[2], v[4], v[6]};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = e[k] + o[k];
    v[k + 4] = e[k] - o[k];
  }
}

// Position of frequency k in a transformed line of length 8 m.
template <int M>
__device__ __forceinline__ int perm(int k) {
  return (k >> 3) + M * (k & 7);
}

// Lines of length n = 8 M in buf: line L starts at L * line_stride, element
// j at j * es.  Task t of (line, inner index): with es == 1 the inner index
// runs fastest across threads (neighbouring elements), else the line does
// (neighbouring columns).
__device__ __forceinline__ void split_task(int t, int lines, int inner, int es, int& line, int& idx) {
  if (es == 1) {
    line = t / inner;
    idx = t - line * inner;
  } else {
    idx = t / lines;
    line = t - idx * lines;
  }
}

// Radix-8 step of the forward FFT (kInv = false: butterfly, then twiddle) or
// of the inverse (kInv = true: conjugate twiddle, then butterfly), one task a
// (line, j1) over elements j1 + M * j2, j2 = 0..7.
template <int M, bool kInv>
__device__ void radix8_step(float2* __restrict__ buf, int lines, int line_stride, int es,
                            const float2* __restrict__ tab) {
  for (int t = threadIdx.x; t < lines * M; t += kThreads) {
    int line, j1;
    split_task(t, lines, M, es, line, j1);
    float2* p = buf + line * line_stride + j1 * es;
    float2 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = p[j * M * es];
    if (kInv) {
#pragma unroll
      for (int k2 = 1; k2 < 8; ++k2) v[k2] = cmulc(v[k2], __ldg(tab + j1 * k2));
    }
    dft8<kInv>(v);
    if (!kInv) {
#pragma unroll
      for (int k2 = 1; k2 < 8; ++k2) v[k2] = cmul(v[k2], __ldg(tab + j1 * k2));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j * M * es] = v[j];
  }
}

// M-point direct DFT step, one task a (line, k2) over the M contiguous
// positions i + M * k2: forward X(k) = sum_j b(j) W_M^(j k), inverse with
// conj(W_M).  Conjugate symmetry pairs j with M - j (u = b(j) + b(M - j),
// v = b(j) - b(M - j)) and k with M - k:
//   X(k), X(M - k) = b(0) + sum_j (u.x c - / + v.y s, u.y c + / - v.x s)
// (+ (-1)^k b(M/2) for even M), W_M^(j k) = c + i s, so four FMAs a (j, k)
// pair give two outputs: a quarter of the direct sum's multiplies.
template <int M, bool kInv>
__device__ void dftm_step(float2* __restrict__ buf, int lines, int line_stride, int es,
                          const float2* __restrict__ tab) {
  constexpr int J = (M - 1) / 2;  // pairs (j, M - j), j = 1..J
  constexpr bool kEven = M % 2 == 0;
  float2 w[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float2 t = __ldg(tab + 8 * i);
    w[i] = kInv ? conj(t) : t;
  }
  for (int t = threadIdx.x; t < lines * 8; t += kThreads) {
    int line, k2;
    split_task(t, lines, 8, es, line, k2);
    float2* p = buf + line * line_stride + k2 * M * es;
    float2 b[M];
#pragma unroll
    for (int j = 0; j < M; ++j) b[j] = p[j * es];
    // b(j) <- u(j), b(M - j) <- v(j)
#pragma unroll
    for (int j = 1; j <= J; ++j) {
      const float2 x = b[j], y = b[M - j];
      b[j] = x + y;
      b[M - j] = x - y;
    }
    const float2 mid = kEven ? b[M / 2] : make_float2(0.0f, 0.0f);
    float2 x0 = b[0] + mid;
#pragma unroll
    for (int j = 1; j <= J; ++j) x0 = x0 + b[j];
    p[0] = x0;
#pragma unroll
    for (int k = 1; k <= J; ++k) {
      const float sign = (k & 1) ? -1.0f : 1.0f;  // (-1)^k, the j = M/2 twiddle
      float a = b[0].x + (kEven ? sign * mid.x : 0.0f), c = b[0].y + (kEven ? sign * mid.y : 0.0f);
      float bs = 0.0f, d = 0.0f;
#pragma unroll
      for (int j = 1; j <= J; ++j) {
        const float2 tw = w[(j * k) % M];
        a = fmaf(b[j].x, tw.x, a);
        c = fmaf(b[j].y, tw.x, c);
        bs = fmaf(b[M - j].y, tw.y, bs);
        d = fmaf(b[M - j].x, tw.y, d);
      }
      p[k * es] = make_float2(a - bs, c + d);
      p[(M - k) * es] = make_float2(a + bs, c - d);
    }
    if (kEven) {  // k = M/2: W_M^(j M/2) = (-1)^j
      float2 x = b[0];
#pragma unroll
      for (int j = 1; j <= J; ++j) x = (j & 1) ? x - b[j] : x + b[j];
      p[(M / 2) * es] = ((M / 2) & 1) ? x - mid : x + mid;
    }
  }
}

// Forward FFT of `lines` lines: natural order in, permuted order out.
template <int M>
__device__ void fft_forward(float2* buf, int lines, int line_stride, int es, const float2* tab) {
  radix8_step<M, false>(buf, lines, line_stride, es, tab);
  __syncthreads();
  dftm_step<M, false>(buf, lines, line_stride, es, tab);
  __syncthreads();
}

// Inverse FFT (unscaled): permuted order in, natural order out.
template <int M>
__device__ void fft_inverse(float2* buf, int lines, int line_stride, int es, const float2* tab) {
  dftm_step<M, true>(buf, lines, line_stride, es, tab);
  __syncthreads();
  radix8_step<M, true>(buf, lines, line_stride, es, tab);
  __syncthreads();
}

// Stage 3: row pair p holds the transformed complex rows of curr (row 2p)
// and prev (row 2p + 1), each packing two real rows.  Rewrite it as the half
// spectra [T1_2p | T2_2p] and [T1_2p+1 | T2_2p+1].  One warp a row pair:
// every lane reads its bins, then the warp writes.
template <int M>
__device__ void split_rows(float2* __restrict__ buf) {
  constexpr int n = 8 * M, h = n / 2, kPer = (h + 31) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < h; p += kWarps) {
    float2* r0 = buf + 2 * p * n;
    float2* r1 = r0 + n;
    float2 out[kPer][4];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int l = lane + 32 * i;
      if (l >= h) continue;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float2* r = s ? r1 : r0;
        if (l == 0) {
          const float2 a = r[perm<M>(0)], b = r[perm<M>(h)];  // P(0), P(n/2)
          out[i][2 * s] = make_float2(a.x, b.x);
          out[i][2 * s + 1] = make_float2(a.y, b.y);
        } else {
          const float2 a = r[perm<M>(l)], b = conj(r[perm<M>(n - l)]);
          const float2 d = a - b;
          out[i][2 * s] = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y + b.y));
          out[i][2 * s + 1] = make_float2(0.5f * d.y, -0.5f * d.x);
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int l = lane + 32 * i;
      if (l >= h) continue;
      r0[l] = out[i][0];      // T1, row 2p
      r1[l] = out[i][1];      // T1, row 2p + 1
      r0[h + l] = out[i][2];  // T2, row 2p
      r1[h + l] = out[i][3];  // T2, row 2p + 1
    }
    __syncwarp();
  }
}

__device__ __forceinline__ float2 cross_power(float2 f1, float2 f2) {
  const float2 r = cmulc(f1, f2);
  const float s = rsqrtf(r.x * r.x + r.y * r.y + kFltEpsilon);
  return make_float2(r.x * s, r.y * s);
}

// Stage 5: R = F1 conj(F2) normalized, into the curr half of each row.
// `exact` holds each warp's partial sums of the four self-conjugate bins of
// each patch (stage 1); their sum replaces the FFT's value of those bins.
template <int M>
__device__ void cross_power_stage(float2* __restrict__ buf, const float* __restrict__ exact) {
  constexpr int n = 8 * M, h = n / 2;
  // columns 1 .. n/2 - 1: every storage row
  for (int t = threadIdx.x; t < n * (h - 1); t += kThreads) {
    const int r = t / (h - 1);
    const int s = 1 + t - r * (h - 1);
    float2* f = buf + r * n + s;
    *f = cross_power(*f, f[h]);
  }
  // the packed columns: C = F(., 0) + i F(., n/2) per patch; one task a
  // frequency pair (ky, -ky), ky = 0 .. n/2
  for (int ky = threadIdx.x; ky <= h; ky += kThreads) {
    float2* c1 = buf + perm<M>(ky) * n;
    float2* c2 = buf + perm<M>((n - ky) % n) * n;
    float2 f[2][2];  // [patch][column 0, column n/2]
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (ky == 0 || ky == h) {
        const int o = ky == 0 ? 0 : 1;
        float e0 = 0.0f, eh = 0.0f;
        for (int w = 0; w < kWarps; ++w) {
          e0 += exact[8 * w + 4 * s + o];
          eh += exact[8 * w + 4 * s + 2 + o];
        }
        f[s][0] = make_float2(e0, 0.0f);
        f[s][1] = make_float2(eh, 0.0f);
      } else {
        const float2 a = c1[s * h], b = conj(c2[s * h]);
        const float2 d = a - b;
        f[s][0] = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y + b.y));
        f[s][1] = make_float2(0.5f * d.y, -0.5f * d.x);
      }
    }
    const float2 r0 = cross_power(f[0][0], f[1][0]);
    const float2 rh = cross_power(f[0][1], f[1][1]);
    *c1 = make_float2(r0.x - rh.y, r0.y + rh.x);                      // R0 + i Rh at ky
    if (c2 != c1) *c2 = make_float2(r0.x + rh.y, rh.x - r0.y);        // conj R0 + i conj Rh at -ky
  }
}

// Stage 7: surface rows (2p, 2p + 1), half spectra U in the curr half of
// rows 2p and 2p + 1, into row 2p as V = scale * (H_2p + i H_2p+1), H the
// Hermitian extension, in the permuted order the inverse FFT takes.  One
// warp a row pair: every lane reads, then the warp writes.
template <int M>
__device__ void pack_rows(float2* __restrict__ buf, float scale) {
  constexpr int n = 8 * M, h = n / 2, kPer = (h + 31) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < h; p += kWarps) {
    float2* r0 = buf + 2 * p * n;
    const float2* r1 = r0 + n;
    float2 v[kPer][2];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int l = lane + 32 * i;
      if (l >= h) continue;
      const float2 u1 = r0[l], u2 = r1[l];
      if (l == 0) {  // U(0) + i U(n/2), both real
        v[i][0] = make_float2(scale * u1.x, scale * u2.x);  // V(0)
        v[i][1] = make_float2(scale * u1.y, scale * u2.y);  // V(n/2)
      } else {
        v[i][0] = make_float2(scale * (u1.x - u2.y), scale * (u1.y + u2.x));  // V(l)
        v[i][1] = make_float2(scale * (u1.x + u2.y), scale * (u2.x - u1.y));  // V(n - l)
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int l = lane + 32 * i;
      if (l >= h) continue;
      r0[perm<M>(l)] = v[i][0];
      r0[perm<M>(l == 0 ? h : n - l)] = v[i][1];
    }
    __syncwarp();
  }
}

// (value, shifted flat index) candidate: larger value wins, ties go to the
// smaller index.  NaN values never enter; they are counted in a flag.
__device__ __forceinline__ bool better(float v, int s, float bv, int bs) {
  return v > bv || (v == bv && s < bs);
}

// Stage 9, the peak of _masked_peak_centroid on the surface of stage 8:
// buffer row p holds surface rows 2p (real parts) and 2p + 1 (imaginary
// parts).  One warp a buffer row, lanes along x; the fftshift and the mask
// are index arithmetic; the argmax takes (value, shifted flat index) with
// ties to the smaller index, masked entries as 0 and NaN (inside the mask
// only) as a flag; then warp 0 takes the positive-only centroid over the
// (2 centroid_radius + 1)^2 window in shifted coordinates.  `red` holds
// three words a warp.
template <int M>
__device__ void peak_stage(const float2* __restrict__ buf, int search_radius, int centroid_radius,
                           float* __restrict__ red, float* __restrict__ shift_out,
                           float* __restrict__ maxval_out) {
  constexpr int n = 8 * M, h = n / 2;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* warp_best = red;
  int* warp_s = reinterpret_cast<int*>(red + kWarps);
  int* warp_nan = reinterpret_cast<int*>(red + 2 * kWarps);
  float best = -INFINITY;
  int best_s = n * n;
  int has_nan = 0;
  for (int p = warp; p < h; p += kWarps) {
#pragma unroll
    for (int x0 = 0; x0 < n; x0 += 32) {
      const int x = x0 + lane;
      if (x < n) {
        const float2 v2 = buf[2 * p * n + x];
        const int sx = x < h ? x + h : x - h;
        const bool keep_x = abs(sx - h) <= search_radius;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int y = 2 * p + r;
          const int sy = y < h ? y + h : y - h;
          const float v = keep_x && abs(sy - h) <= search_radius ? (r ? v2.y : v2.x) : 0.0f;
          if (v != v) {
            has_nan = 1;
          } else if (better(v, sy * n + sx, best, best_s)) {
            best = v;
            best_s = sy * n + sx;
          }
        }
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
  if (lane == 0) {
    warp_best[warp] = best;
    warp_s[warp] = best_s;
    warp_nan[warp] = has_nan;
  }
  __syncthreads();
  if (warp != 0) return;
  best = warp_best[0];
  best_s = warp_s[0];
  has_nan = warp_nan[0];
  for (int w = 1; w < kWarps; ++w) {
    if (better(warp_best[w], warp_s[w], best, best_s)) {
      best = warp_best[w];
      best_s = warp_s[w];
    }
    has_nan |= warp_nan[w];
  }
  const int yc = best_s / n;
  const int xc = best_s - yc * n;
  const int side = 2 * centroid_radius + 1;
  const float* sf = reinterpret_cast<const float*>(buf);
  float sw = 0.0f, swx = 0.0f, swy = 0.0f;
  for (int i = lane; i < side * side; i += 32) {
    const int sy = yc - centroid_radius + i / side;
    const int sx = xc - centroid_radius + i % side;
    if (sy < 0 || sy >= n || sx < 0 || sx >= n || abs(sy - h) > search_radius ||
        abs(sx - h) > search_radius)
      continue;
    const int y = sy < h ? sy + h : sy - h;
    const int x = sx < h ? sx + h : sx - h;
    const float v = sf[2 * ((y & ~1) * n + x) + (y & 1)];
    if (v > 0.0f) {
      sw += v;
      swx += v * static_cast<float>(sx);
      swy += v * static_cast<float>(sy);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    sw += __shfl_xor_sync(0xffffffffu, sw, off);
    swx += __shfl_xor_sync(0xffffffffu, swx, off);
    swy += __shfl_xor_sync(0xffffffffu, swy, off);
  }
  if (lane != 0) return;
  const float denom = sw + kFltEpsilon;
  float cx = swx / denom - static_cast<float>(h);
  float cy = swy / denom - static_cast<float>(h);
  if (has_nan) {
    best = cx = cy = __int_as_float(0x7fc00000);  // quiet NaN
  }
  shift_out[0] = cx;
  shift_out[1] = cy;
  maxval_out[0] = best;
}

template <int M>
__global__ void __launch_bounds__(kThreads)
    phase_correlate_frames_kernel(const void* __restrict__ curr_v, const void* __restrict__ prev_v,
                                  int is_u8, int width, int q, int search_radius, int centroid_radius,
                                  const float2* __restrict__ tab, float* __restrict__ shift_out,
                                  float* __restrict__ maxval_out) {
  constexpr int n = 8 * M, h = n / 2;
  extern __shared__ float2 buf[];
  // per-warp partials: the exact bins of stage 1, then the peak of stage 9
  __shared__ float red[8 * kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int row = blockIdx.x;  // b * q * q + (i + q * j)
  const int qq = q * q;
  const int b = row / qq;
  const int k = row - b * qq;
  const int pi = k % q;
  const int pj = k / q;
  const size_t offset = static_cast<size_t>(b) * q * n * width + static_cast<size_t>(pj) * n * width +
                        static_cast<size_t>(pi) * n;

  // 1. load: row 2p <- curr rows (2p, 2p + 1), row 2p + 1 <- prev rows;
  // and the four self-conjugate bins of each patch as plain sums,
  // [patch][F(0, 0), F(n/2, 0), F(0, n/2), F(n/2, n/2)]: exact for
  // integer pixels, so a bin that is exactly zero stays zero (the FFT's
  // rounding would make it a unit after the normalization)
  float part[8] = {};
  constexpr int n4 = n / 4;  // 4 pixels a task: one 4-byte (uint8) or 16-byte (float32) load a row
#pragma unroll 4
  for (int e = threadIdx.x; e < n * n4; e += kThreads) {
    const int r = e / n4;
    const int c = 4 * (e - r * n4);
    const size_t src = offset + static_cast<size_t>(r & ~1) * width + c;
    float lo[4], hi[4];
    if (is_u8) {
      const uint8_t* f = static_cast<const uint8_t*>((r & 1) ? prev_v : curr_v);
      const uchar4 a = *reinterpret_cast<const uchar4*>(f + src);
      const uchar4 b = *reinterpret_cast<const uchar4*>(f + src + width);
      lo[0] = a.x, lo[1] = a.y, lo[2] = a.z, lo[3] = a.w;
      hi[0] = b.x, hi[1] = b.y, hi[2] = b.z, hi[3] = b.w;
    } else {
      const float* f = static_cast<const float*>((r & 1) ? prev_v : curr_v);
      const float4 a = *reinterpret_cast<const float4*>(f + src);
      const float4 b = *reinterpret_cast<const float4*>(f + src + width);
      lo[0] = a.x, lo[1] = a.y, lo[2] = a.z, lo[3] = a.w;
      hi[0] = b.x, hi[1] = b.y, hi[2] = b.z, hi[3] = b.w;
    }
    float4* dst = reinterpret_cast<float4*>(buf + r * n + c);
    dst[0] = make_float4(lo[0], hi[0], lo[1], hi[1]);
    dst[1] = make_float4(lo[2], hi[2], lo[3], hi[3]);
    // c is even: the column signs (-1)^x are +, -, +, -
    float v[4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = lo[i] + hi[i], d = lo[i] - hi[i], sx = (i & 1) ? -1.0f : 1.0f;
      v[0] += a;
      v[1] += d;
      v[2] += sx * a;
      v[3] += sx * d;
    }
    const float to_curr = (r & 1) ? 0.0f : 1.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      part[i] += to_curr * v[i];
      part[4 + i] += (1.0f - to_curr) * v[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    for (int off = 16; off > 0; off >>= 1) part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
    if (lane == 0) red[8 * warp + i] = part[i];
  }
  __syncthreads();
  fft_forward<M>(buf, n, n, 1, tab);  // 2. rows
  split_rows<M>(buf);                 // 3.
  __syncthreads();
  fft_forward<M>(buf, n, 1, n, tab);  // 4. columns
  cross_power_stage<M>(buf, red);     // 5.
  __syncthreads();
  fft_inverse<M>(buf, h, 1, n, tab);  // 6. columns of the curr half
  pack_rows<M>(buf, 1.0f / static_cast<float>(n * n));  // 7.
  __syncthreads();
  fft_inverse<M>(buf, h, 2 * n, 1, tab);  // 8. rows 2p

  peak_stage<M>(buf, search_radius, centroid_radius, red, shift_out + 2 * row, maxval_out + row);  // 9.
}

using LaunchFn = int (*)(const void*, const void*, int, int, int, int, int, int, const void*, void*,
                         void*, cudaStream_t, size_t);

template <int M>
int launch(const void* curr, const void* prev, int is_u8, int width, int q, int windows,
           int search_radius, int centroid_radius, const void* tab, void* shift, void* maxval,
           cudaStream_t stream, size_t smem) {
  auto* kernel = phase_correlate_frames_kernel<M>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block a window
  kernel<<<windows, kThreads, smem, stream>>>(curr, prev, is_u8, width, q, search_radius, centroid_radius,
                                              static_cast<const float2*>(tab), static_cast<float*>(shift),
                                              static_cast<float*>(maxval));
  return static_cast<int>(cudaGetLastError());
}

template <int... I>
LaunchFn pick(int m, std::integer_sequence<int, I...>) {
  static const LaunchFn fns[] = {launch<I + 1>...};
  return fns[m - 1];
}

// Blocks of the kernel for n = 8 M that one SM holds at once.
template <int M>
int blocks_per_sm() {
  auto* kernel = phase_correlate_frames_kernel<M>;
  const int smem = 64 * M * M * static_cast<int>(sizeof(float2));
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem) != cudaSuccess)
    return -1;
  return blocks;
}

template <int... I>
int pick_blocks_per_sm(int m, std::integer_sequence<int, I...>) {
  static int (*const fns[])() = {blocks_per_sm<I + 1>...};
  return fns[m - 1]();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for patch size n, in bytes: one
// n x n complex float32 buffer.
long long pcf_smem_bytes(int n) {
  return static_cast<long long>(n) * n * static_cast<long long>(sizeof(float2));
}

// Blocks for patch size n that one SM holds at once; -1 for an n the
// kernel does not take or on a CUDA error.
int pcf_blocks_per_sm(int n) {
  if (n % 8 != 0 || n < 8 || n > 8 * kMaxM) return -1;
  return pick_blocks_per_sm(n / 8, std::make_integer_sequence<int, kMaxM>{});
}

// Launch on `stream`.  is_u8 != 0: uint8 frames, else float32, 16-byte
// aligned.  n must be a multiple of 8 up to 8 * kMaxM.  Returns the CUDA
// error code of the attribute calls or of the launch (0 on success).
int pcf_phase_correlate_frames(const void* curr, const void* prev, int is_u8, int batch, int height,
                               int width, int n, int q, int search_radius, int centroid_radius,
                               const void* tab, void* shift, void* maxval, void* stream) {
  if (n % 8 != 0 || n < 8 || n > 8 * kMaxM || height != q * n || width != q * n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int windows = batch * q * q;
  if (windows == 0) return 0;
  return pick(n / 8, std::make_integer_sequence<int, kMaxM>{})(
      curr, prev, is_u8, width, q, windows, search_radius, centroid_radius, tab, shift, maxval,
      static_cast<cudaStream_t>(stream), static_cast<size_t>(pcf_smem_bytes(n)));
}

}  // extern "C"
