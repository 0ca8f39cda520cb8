// Mixed-radix FFT stages for lines of any length n in shared memory, the
// device code of kernels D (phase_correlate_fullfused.cu) and E
// (phase_correlate_fused.cu): their one-block designs for small patches and
// the row and column passes of their staged designs for large ones, with
// what those share around the stages (the route rule, the passes' sizes,
// the perm table, the cross-power).
//
// The plan.  n is factored into radices 8 (while they divide it), then 4, 2,
// 3 and 5 (kRadices in make_plan), then its remaining prime factors in ascending order,
// each a generic radix.  make_plan builds it, the same on the host and on the
// device; ops/cuda_kernels.py::fft_plan is its Python twin.
//
// The transform is in place, decimation in frequency: stage s (radix r,
// span L = n / (r_0 ... r_(s-1)), m = L / r) takes each group of r elements
// j + m q (q = 0 .. r - 1) of each block of L, runs the r-point DFT over q
// and multiplies output k by W_L^(j k).  Each group reads and writes one set
// of positions, so no stage needs a second buffer.  Frequency
// k = k_0 + r_0 (k_1 + r_1 (k_2 + ...)) ends at position sum_s k_s m_s
// (perm); the inverse runs the stages backwards (conjugate twiddle, then
// the inverse r-point DFT) from that order back to the natural one,
// unscaled.  Radices 2, 4 and 8 multiply by +-1, +-i and (+-1 +- i)/sqrt(2)
// only; 3 and 5 are unrolled with their cos/sin constants; any other prime p
// is a direct p-point sum over the group (generic_step), computed for whole
// groups into registers, then written after a barrier, in rounds of at most
// kGenOut outputs a thread (so p <= kThreads * kGenOut).
//
// Twiddles come from the float64-built table tab[k] = exp(-2 pi i k / n),
// row 1 of the JAX package's _dft_matrices(n) cast to float32
// (ops/cuda_kernels.py::_twiddles): W_L^(j k) = tab[j k n / L] with
// j k < L, and W_p^(q k) = tab[(q k mod p) n / p].  No sincos on the device.

#pragma once

#include <cuda_runtime.h>

namespace fft {

// Every stage strides over the block's threads, blockDim.x, a multiple of 32
// and at least kThreads.
constexpr int kThreads = 256;
constexpr int kMaxStages = 20;
constexpr int kGenOut = 4;  // outputs a thread holds in a generic round
constexpr int kMaxGenericRadix = kThreads * kGenOut;
constexpr float kSqrtHalf = 0.70710678118654752440f;
constexpr float kC3 = -0.5f, kS3 = 0.86602540378443864676f;  // cos, sin 2 pi / 3
constexpr float kC51 = 0.30901699437494742410f, kS51 = 0.95105651629515357212f;   // 2 pi / 5
constexpr float kC52 = -0.80901699437494742410f, kS52 = 0.58778525229247312917f;  // 4 pi / 5

struct Plan {
  int n;
  int stages;
  int radix[kMaxStages];
  int span[kMaxStages];  // L of each stage
};

// The plan of n, or stages = -1 when n < 1, a prime factor exceeds
// kMaxGenericRadix or the stages exceed kMaxStages.
__host__ __device__ constexpr Plan make_plan(int n) {
  Plan plan{};
  plan.n = n;
  if (n < 1) {
    plan.stages = -1;
    return plan;
  }
  // the unrolled radices, taken in this order before the generic primes
  constexpr int kRadices[5] = {8, 4, 2, 3, 5};
  int rest = n, span = n, s = 0;
  for (int r : kRadices) {
    while (rest % r == 0 && rest > 1) {
      if (s == kMaxStages) {
        plan.stages = -1;
        return plan;
      }
      plan.radix[s] = r;
      plan.span[s++] = span;
      span /= r;
      rest /= r;
    }
  }
  for (int p = 7; rest > 1; p += 2) {
    while (rest % p == 0) {
      if (s == kMaxStages || p > kMaxGenericRadix) {
        plan.stages = -1;
        return plan;
      }
      plan.radix[s] = p;
      plan.span[s++] = span;
      span /= p;
      rest /= p;
    }
  }
  plan.stages = s;
  return plan;
}

// Position of frequency k after the forward transform.
__device__ __forceinline__ int perm(const Plan& plan, int k) {
  int pos = 0;
  for (int s = 0; s < plan.stages; ++s) {
    const int r = plan.radix[s];
    const int q = k / r;
    pos += (k - q * r) * (plan.span[s] / r);
    k = q;
  }
  return pos;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * conj(b)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}
__device__ __forceinline__ float2 conj(float2 a) { return make_float2(a.x, -a.y); }
// a * (-i) forward, a * (+i) inverse
template <bool kInv>
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return kInv ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}
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
  const float2 t0 = cadd(x0, x2), t1 = csub(x0, x2), t2 = cadd(x1, x3), t3 = mul_mi<kInv>(csub(x1, x3));
  x0 = cadd(t0, t2);
  x2 = csub(t0, t2);
  x1 = cadd(t1, t3);
  x3 = csub(t1, t3);
}

// R-point DFT in registers, natural order in and out; forward with
// W_R = exp(-2 pi i / R), inverse with its conjugate
template <int R, bool kInv>
__device__ __forceinline__ void butterfly(float2 (&v)[R]) {
  if constexpr (R == 2) {
    const float2 a = v[0];
    v[0] = cadd(a, v[1]);
    v[1] = csub(a, v[1]);
  } else if constexpr (R == 4) {
    dft4<kInv>(v[0], v[1], v[2], v[3]);
  } else if constexpr (R == 8) {
    dft4<kInv>(v[0], v[2], v[4], v[6]);
    dft4<kInv>(v[1], v[3], v[5], v[7]);
    const float2 o[4] = {v[1], mul_w8<kInv>(v[3]), mul_mi<kInv>(v[5]), mul_w8_3<kInv>(v[7])};
    const float2 e[4] = {v[0], v[2], v[4], v[6]};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = cadd(e[k], o[k]);
      v[k + 4] = csub(e[k], o[k]);
    }
  } else if constexpr (R == 3) {
    // y1, y2 = x0 + c (x1 + x2) -/+ i s (x1 - x2) (signs swapped inverse)
    const float2 t = cadd(v[1], v[2]);
    const float2 d = mul_mi<kInv>(csub(v[1], v[2]));
    const float2 a = make_float2(v[0].x + kC3 * t.x, v[0].y + kC3 * t.y);
    v[0] = cadd(v[0], t);
    v[1] = make_float2(a.x + kS3 * d.x, a.y + kS3 * d.y);
    v[2] = make_float2(a.x - kS3 * d.x, a.y - kS3 * d.y);
  } else if constexpr (R == 5) {
    const float2 t1 = cadd(v[1], v[4]), t2 = cadd(v[2], v[3]);
    const float2 d1 = mul_mi<kInv>(csub(v[1], v[4])), d2 = mul_mi<kInv>(csub(v[2], v[3]));
    const float2 x0 = v[0];
    const float2 a1 = make_float2(x0.x + kC51 * t1.x + kC52 * t2.x, x0.y + kC51 * t1.y + kC52 * t2.y);
    const float2 a2 = make_float2(x0.x + kC52 * t1.x + kC51 * t2.x, x0.y + kC52 * t1.y + kC51 * t2.y);
    const float2 b1 = make_float2(kS51 * d1.x + kS52 * d2.x, kS51 * d1.y + kS52 * d2.y);
    const float2 b2 = make_float2(kS52 * d1.x - kS51 * d2.x, kS52 * d1.y - kS51 * d2.y);
    v[0] = cadd(x0, cadd(t1, t2));
    v[1] = cadd(a1, b1);
    v[4] = csub(a1, b1);
    v[2] = cadd(a2, b2);
    v[3] = csub(a2, b2);
  }
}

// Task t of (line, group): with es == 1 the group index runs fastest across
// threads (neighbouring elements), else the line does (neighbouring columns).
__device__ __forceinline__ void split_task(int t, int lines, int inner, int es, int& line, int& idx) {
  if (es == 1) {
    line = t / inner;
    idx = t - line * inner;
  } else {
    idx = t / lines;
    line = t - idx * lines;
  }
}

// One radix-R stage over `lines` lines of length n (line i at i * ls,
// element j at j * es), span L: forward butterfly then twiddle, inverse
// conjugate twiddle then butterfly.
template <int R, bool kInv>
__device__ __forceinline__ void radix_step(float2* __restrict__ buf, int lines, int ls, int es, int n, int L,
                           const float2* __restrict__ tab) {
  const int m = L / R, inner = n / R, nl = n / L;
  for (int t = threadIdx.x; t < lines * inner; t += blockDim.x) {
    int line, g;
    split_task(t, lines, inner, es, line, g);
    const int blk = g / m, j = g - blk * m;
    float2* p = buf + line * ls + (blk * L + j) * es;
    float2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = p[q * m * es];
    if (kInv && j) {
#pragma unroll
      for (int k = 1; k < R; ++k) v[k] = cmulc(v[k], __ldg(tab + j * k * nl));
    }
    butterfly<R, kInv>(v);
    if (!kInv && j) {
#pragma unroll
      for (int k = 1; k < R; ++k) v[k] = cmul(v[k], __ldg(tab + j * k * nl));
    }
#pragma unroll
    for (int q = 0; q < R; ++q) p[q * m * es] = v[q];
  }
}

// One generic radix-p stage: every output of a round of whole groups is a
// direct p-point sum into registers, written after a barrier.  Every thread
// of the block must call it.
template <bool kInv>
__device__ void generic_step(float2* __restrict__ buf, int lines, int ls, int es, int n, int L, int p,
                             const float2* __restrict__ tab) {
  const int m = L / p, inner = n / p, nl = n / L;
  const int groups = lines * inner;
  const int per_round = blockDim.x * kGenOut / p;
  for (int g0 = 0; g0 < groups; g0 += per_round) {
    const int outputs = (groups - g0 < per_round ? groups - g0 : per_round) * p;
    float2 out[kGenOut];
    int pos[kGenOut];
#pragma unroll
    for (int i = 0; i < kGenOut; ++i) {
      const int o = threadIdx.x + i * blockDim.x;
      pos[i] = -1;
      if (o >= outputs) continue;
      const int gi = o / p, k = o - gi * p;
      int line, g;
      split_task(g0 + gi, lines, inner, es, line, g);
      const int blk = g / m, j = g - blk * m;
      const float2* src = buf + line * ls + (blk * L + j) * es;
      float2 acc = make_float2(0.0f, 0.0f);
      int w = 0;  // (q k) mod p
      for (int q = 0; q < p; ++q) {
        float2 x = src[q * m * es];
        if (kInv) x = cmulc(x, __ldg(tab + j * q * nl));
        const float2 t = __ldg(tab + w * inner);
        const float2 y = kInv ? cmulc(x, t) : cmul(x, t);
        acc.x += y.x;
        acc.y += y.y;
        w += k;
        if (w >= p) w -= p;
      }
      if (!kInv) acc = cmul(acc, __ldg(tab + j * k * nl));
      out[i] = acc;
      pos[i] = line * ls + (blk * L + j + m * k) * es;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kGenOut; ++i)
      if (pos[i] >= 0) buf[pos[i]] = out[i];
    __syncthreads();
  }
}

template <bool kInv>
__device__ __forceinline__ void stage(float2* buf, int lines, int ls, int es, int n, int L, int r, const float2* tab) {
  switch (r) {
    case 8: radix_step<8, kInv>(buf, lines, ls, es, n, L, tab); break;
    case 4: radix_step<4, kInv>(buf, lines, ls, es, n, L, tab); break;
    case 2: radix_step<2, kInv>(buf, lines, ls, es, n, L, tab); break;
    case 3: radix_step<3, kInv>(buf, lines, ls, es, n, L, tab); break;
    case 5: radix_step<5, kInv>(buf, lines, ls, es, n, L, tab); break;
    default: generic_step<kInv>(buf, lines, ls, es, n, L, r, tab);
  }
  __syncthreads();
}

// Forward FFT of `lines` lines: natural order in, perm order out.  Every
// thread of the block must call it; it ends with a barrier.  N > 0: the plan
// of length N, known to the compiler (stages unrolled, every index division
// by a constant); N = 0: `plan`, read at run time.
template <int N = 0>
__device__ __forceinline__ void forward(float2* buf, int lines, int ls, int es, const Plan& plan,
                                        const float2* tab) {
  if constexpr (N > 0) {
    constexpr Plan kPlan = make_plan(N);
#pragma unroll
    for (int s = 0; s < kPlan.stages; ++s)
      stage<false>(buf, lines, ls, es, N, kPlan.span[s], kPlan.radix[s], tab);
  } else {
    for (int s = 0; s < plan.stages; ++s)
      stage<false>(buf, lines, ls, es, plan.n, plan.span[s], plan.radix[s], tab);
  }
}

// Inverse FFT (unscaled): perm order in, natural order out.
template <int N = 0>
__device__ __forceinline__ void inverse(float2* buf, int lines, int ls, int es, const Plan& plan,
                                        const float2* tab) {
  if constexpr (N > 0) {
    constexpr Plan kPlan = make_plan(N);
#pragma unroll
    for (int s = kPlan.stages - 1; s >= 0; --s)
      stage<true>(buf, lines, ls, es, N, kPlan.span[s], kPlan.radix[s], tab);
  } else {
    for (int s = plan.stages - 1; s >= 0; --s)
      stage<true>(buf, lines, ls, es, plan.n, plan.span[s], plan.radix[s], tab);
  }
}

// ---------------------------------------------------------------------------
// around the stages: what kernels D and E share
// ---------------------------------------------------------------------------

constexpr long long kSmemOptin = 232448;  // shared memory a block of an H100 may opt into
constexpr int kStaticReserve = 1248;      // static shared memory a one-block kernel may use
constexpr int kSmallMaxW = 170;           // 8 W^2 + kStaticReserve <= kSmemOptin
constexpr int kLines = 4;                 // lines a block in a staged row pass, at most
constexpr int kBand = 4;                  // columns a block in a staged column pass, at most
constexpr int kLargeSmemCap = 96 * 1024;  // a staged pass's shared memory target
constexpr float kFltEpsilon = 1.1920928955078125e-07f;  // FLT_EPSILON

__host__ __device__ inline int buffer_side(int n) { return n + (n & 1); }

// The route rule of kernels D and E: one block a pair while a W x W complex
// buffer (W = buffer_side(n)) and the static reserve fit a block.
__host__ __device__ inline bool small_route(int n) {
  const long long w = buffer_side(n);
  return 8 * w * w + kStaticReserve <= kSmemOptin;
}

// Lines of line_bytes each that a staged pass puts in one block: as many as
// kLargeSmemCap holds, at least 1, at most `most`.
__host__ __device__ inline int pass_lines(long long line_bytes, int most) {
  const long long fit = kLargeSmemCap / line_bytes;
  return fit < 1 ? 1 : fit < most ? static_cast<int>(fit) : most;
}

// pm[k] = perm(plan, k) for k < plan.n, over the block's threads.
template <typename I>
__device__ inline void fill_perm(I* pm, const Plan& plan) {
  for (int k = threadIdx.x; k < plan.n; k += blockDim.x) pm[k] = static_cast<I>(perm(plan, k));
}

// The normalized cross-power F1 * conj(F2) * rsqrt(|F1 * conj(F2)|^2 + FLT_EPSILON)
__device__ __forceinline__ float2 cross_power(float2 f1, float2 f2) {
  const float2 r = cmulc(f1, f2);
  const float s = rsqrtf(r.x * r.x + r.y * r.y + kFltEpsilon);
  return make_float2(r.x * s, r.y * s);
}

// Opt `kernel` into `bytes` of dynamic shared memory, with the carveout
// that gives shared memory all it can.
inline cudaError_t allow_smem(const void* kernel, long long bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
}

}  // namespace fft
