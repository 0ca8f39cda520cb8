// getRT in one launch, for Hopper (sm_90a): window shifts -> undistorted
// points -> RANSAC homography -> refit -> Malis-Vargas decomposition -> the
// IMU-nearest solution -> twist, and on request the node's body frame of
// it.  Kernel G of the port.
//
// Replaces no TPU kernel.  The JAX package computes getRT in XLA
// (mrs_optic_flow_tpu/geometry/motion.py::get_rt and geometry/batched.py::
// get_rt_batch); the port's torch version of it (geometry/motion.py::
// get_rt_ref, geometry/batched.py::get_rt_batch_ref, its plain version here)
// writes the reference's data-dependent algorithm as masked fixed-shape
// tensor code, about 1,000 launches of tiny kernels a call, whatever the
// batch.  This kernel does the same work in one launch, so that a node frame
// and a pipeline call stop paying for those launches.  Its epilogue is the
// method-4 node's summary head (geometry/motion.py::rt_body_frame, the JAX
// node's runtime/node.py:408-411): the detilted body-frame velocity and the
// roll, pitch and yaw of the body-frame rate, about 100 launches of scalar
// tensor code in the plain version.
//
// What bounds it on this card: its work is small.  The Gumbel draws
// [I, P, B] float32 are the only large input (67.1 MB at I = 256, P = 16,
// B = 4096: 0.020 ms at 3.35 TB/s, the bound); the operations, about 31 a
// (hypothesis, point) and 160 a hypothesis plus the refit a pair, take
// 0.011 ms at 67 TFLOP/s (scripts/profile_geometry_torch.py::geometry_work,
// the bound of chip_smoke.py's row).  So the design aims at one launch and no
// intermediate in device memory, and at a batch at keeping every warp busy:
//  - the pair's P points and valid flags in shared memory; each thread
//    solves and scores hypotheses in registers and keeps its best (count,
//    lowest index) and that homography; the winner's inlier set is
//    computed again after the argmax (storing every hypothesis's set would
//    take [I, P] flags);
//  - one warp refits by Householder QR over the 2P x 9 system in shared
//    memory; four of its lanes run the inverse iteration and the
//    decomposition, each then one of the four solutions, and lane 0 the
//    selection, the outputs and the epilogue.
// The serial refit and the hypotheses' long dependent chains (IEEE
// divisions, no contraction) make a pair's time latency, so the layout
// gives each pair as many threads as the call leaves room for.  Two layouts
// share those steps:
//  - the block layout, a block of warps a pair: 256 threads up to one pair
//    an SM (the node's B = 1, the fleet's 128), then the power of two of
//    warps, 8 to 2, that fills kFillWarps warps an SM (the ServingLoop's
//    512: 4); a block argmax, then warp 0 refits; on the batched path each
//    thread copies its next hypothesis's draws into shared memory
//    asynchronously (cp.async) while it scores the current one;
//  - the warp layout, where that leaves one warp a pair (the bench's 4,096):
//    GRT_PAIRS pairs a block, adjacent in B.  The block stages each chunk
//    of 32 hypotheses' draws into a shared tile together, the next chunk in
//    flight, so that at each (hypothesis, window) it reads one run of
//    adjacent floats of the plain version's [I, P, B] layout where a thread
//    a pair pulled a 32-byte sector for 4 bytes; each warp scores its pair's
//    hypotheses, a lane each, takes its argmax with shuffles alone and
//    refits at once: no warp waits on another pair's serial refit.
//
// Numerics.  Everything is float32 in the plain version's operation order,
// and this file is built with -fmad=false (no contraction; IEEE division and
// square root, no fast math), so the hypotheses, the best index, n_inliers
// and the inlier set are the batched plain version's bit for bit.  Where the
// plain version sums through a torch reduction or a cuBLAS product, or
// divides by a Python number, G repeats the order torch takes on the card
// (scripts/probe_torch_orders_torch.py measures it on an H100 with CUDA
// 12.8): a norm or sum as torch's reduction kernel adds it (tsum, the
// refit's norms), the refit's v^T A in the halves, chain or even and odd
// rows cuBLAS takes at that batch and row count, the substitutions of
// solve_triangular, a 3 x 3 product as a chain of fused multiply-adds, a
// division by 3 or 6 as a product with the float32 reciprocal.  The twist
// depends on the last bits of the refit: the decomposition takes square
// roots of minors of H^T H - I that vanish for a translation along an axis,
// so one ulp of h moves such a pair's twist by up to about 0.01 m/s, and the
// bench holds the card's twists to the plain version on the CPU within
// 0.0075 m/s: a more exact float64 refit fails that (PERF.md).  Where an
// order is not known (cuBLAS at batch 128, one pair at 72 or 128 rows),
// the twist differs by that much.  The layout changes which thread does a
// step, never its arithmetic: both give the same bits.  The epilogue's
// transcendentals are the libdevice functions ATen's float32 kernels call
// (acosf, sinf, cosf, asinf, atan2f).
//
// Plain C interface, loaded with ctypes.  The kernel allocates nothing and
// does not synchronise; the caller passes every output and the stream.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace grt {

// The block layout's threads a block at most (kMaxThreads), the warps an SM
// that a pair's warps fill beyond one pair an SM (kFillWarps: the power of
// two of warps a pair, 8 to 1; one warp is the warp layout), and the warp
// layout's pairs a block (GRT_PAIRS, a warp each) and the blocks an SM its
// registers must leave room for (GRT_PAIR_BLOCKS, __launch_bounds__).  A
// tuning build sets GRT_WARP_LAYOUT 1: every batched call takes the warp
// layout.
#ifndef GRT_PAIRS
#define GRT_PAIRS 8
#endif
#ifndef GRT_PAIR_BLOCKS
#define GRT_PAIR_BLOCKS 4
#endif
#ifndef GRT_WARP_LAYOUT
#define GRT_WARP_LAYOUT 0
#endif
// GRT_SPAN(k): the boundary of phase k of one pair's getRT, empty here;
// scripts/probe_get_rt_spans_torch.py defines it to record the SM clock.
#ifndef GRT_SPAN
#define GRT_SPAN(k)
#endif
constexpr int kMaxThreads = 256, kFillWarps = 16;
// pi, pi + 1 and pi / 4 as float32, the values torch compares a float32
// tensor with
constexpr float kPi = 3.14159265358979f, kPiPlus1 = 4.14159265358979f, kPiQuarter = 0.785398163397448f;

struct Args {
  const float* shifts;    // [B, P, 2]
  const float* heights;   // [B]
  const float* dts;       // [B]
  const float* ulx;       // [B], or null for ulx_scalar
  float ulx_scalar;
  const float* cam;       // [3, 3]
  const float* dist;      // [5], or null: a distortion-free camera
  const float* c2b;       // [4]
  const float* rate;      // [B, 4]
  const long long* hyp;   // [I, 4] point indices (per pair, B = 1), or null
  const float* gumbel;    // [I, P, B] draws (batched), or null
  long long g_si, g_sp;   // element strides of the draws' first two dimensions
  int b, p, q, patch, iters, thr_pts;
  float thr2;             // the reprojection threshold squared
  unsigned char* ok;      // [B]
  float* rot;             // [B, 4]
  float* tran;            // [B, 3]
  void* n_inl;            // [B] int64 (n_inl64) or int32
  int n_inl64;
  float* ang_diff;        // [B]
  unsigned char* rejected;  // [B]
  int* best_out;          // [B] or null: the best hypothesis
  unsigned char* inl_out;   // [B, P] or null: its inlier set
  float* h_out;           // [B, 9] or null: the refit homography
  const float* detilt;    // [4], or null: no epilogue
  float* summary;         // [B, 9] the epilogue's summary head (with detilt)
};

// ---------------------------------------------------------------- float32 --

__device__ __forceinline__ void undistort(float px, float py, float fx, float fy, float cx,
                                          float cy, const float* dist, float& x, float& y) {
  // geometry/undistort.py::undistort_xy, five fixed-point iterations
  const float xd = (px - cx) / fx;
  const float yd = (py - cy) / fy;
  x = xd;
  y = yd;
  if (dist == nullptr) return;
  const float k1 = dist[0], k2 = dist[1], p1 = dist[2], p2 = dist[3], k3 = dist[4];
  for (int it = 0; it < 5; ++it) {
    const float r2 = x * x + y * y;
    const float icdist = 1.0f / (1.0f + r2 * (k1 + r2 * (k2 + r2 * k3)));
    const float dx = 2.0f * p1 * x * y + p2 * (r2 + 2.0f * x * x);
    const float dy = p1 * (r2 + 2.0f * y * y) + 2.0f * p2 * x * y;
    x = (xd - dx) * icdist;
    y = (yd - dy) * icdist;
  }
}

__device__ __forceinline__ float det3pts(float pa, float pb, float qa, float qb, float ra, float rb) {
  // | pa qa ra ; pb qb rb ; 1 1 1 |
  return pa * (qb - rb) + qa * (rb - pb) + ra * (pb - qb);
}

// The canonical-basis side matrix of four points (homography.py::_solve_h4)
__device__ __forceinline__ void side(const float a[4], const float b[4], float m[9]) {
  const float d1 = det3pts(a[3], b[3], a[1], b[1], a[2], b[2]);
  const float d2 = det3pts(a[0], b[0], a[3], b[3], a[2], b[2]);
  const float d3 = det3pts(a[0], b[0], a[1], b[1], a[3], b[3]);
  m[0] = d1 * a[0]; m[1] = d2 * a[1]; m[2] = d3 * a[2];
  m[3] = d1 * b[0]; m[4] = d2 * b[1]; m[5] = d3 * b[2];
  m[6] = d1;        m[7] = d2;        m[8] = d3;
}

// The exact homography of four point pairs, H = H_dst adj(H_src): the
// batched plain version's (batched.py::_h4_b, normalized by the largest
// absolute entry) or the per-pair one's (homography.py::_solve_h4, by h22).
__device__ void solve_h4(const float xs[4], const float ys[4], const float us[4],
                         const float vs[4], bool per_pair, float h[9]) {
  float hs[9], hd[9], adj[9];
  side(xs, ys, hs);
  side(us, vs, hd);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int r1 = j == 0 ? 1 : 0, r2 = j == 2 ? 1 : 2;  // rows != j
      const int c1 = i == 0 ? 1 : 0, c2 = i == 2 ? 1 : 2;  // columns != i
      const float minor = hs[r1 * 3 + c1] * hs[r2 * 3 + c2] - hs[r1 * 3 + c2] * hs[r2 * 3 + c1];
      adj[i * 3 + j] = (i + j) % 2 == 0 ? minor : -minor;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float a0 = hd[i * 3] * adj[j];
      if (per_pair) {
        h[i * 3 + j] = fmaf(hd[i * 3 + 2], adj[6 + j], fmaf(hd[i * 3 + 1], adj[3 + j], a0));
      } else {
        h[i * 3 + j] = a0 + hd[i * 3 + 1] * adj[3 + j] + hd[i * 3 + 2] * adj[6 + j];
      }
    }
  }
  float scale;
  if (per_pair) {  // homography.py::_norm_h
    scale = fabsf(h[8]) > 1e-12f ? h[8] : 1.0f;
  } else {  // the largest absolute entry; a NaN entry makes it NaN, and then 1
    float m = fabsf(h[0]);
    for (int k = 1; k < 9; ++k) {
      const float a = fabsf(h[k]);
      if (a > m || a != a) m = a;
    }
    scale = m > 0.0f ? m : 1.0f;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = h[k] / scale;
}

// The forward reprojection test of one point (batched.py::_project_err2_b,
// homography.py::_project): squared error below the threshold.
__device__ __forceinline__ bool inlier(const float h[9], float x, float y, float u, float v,
                                       float thr2) {
  float d = h[6] * x + h[7] * y + h[8];
  d = fabsf(d) > 1e-12f ? d : 1e-12f;
  const float pu = (h[0] * x + h[1] * y + h[2]) / d;
  const float pv = (h[3] * x + h[4] * y + h[5]) / d;
  const float eu = pu - u, ev = pv - v;
  return eu * eu + ev * ev < thr2;
}

// Hypothesis i's four point indices.  Batched: the top 4 of its draws `col`
// (element stride `stride`) over the valid points by four rounds of argmax
// and mask (batched.py::gumbel_top4: strict >, so ties go to the lowest
// index; a NaN draw counts as the largest, as torch.argmax takes it; once
// every candidate is -inf the round takes index 0).  Per pair: the given
// row.
template <int kP>
__device__ __forceinline__ void picks_of(const Args& a, int i, const float* col, long long stride,
                                         const unsigned char* valid, int n_valid, int k[4]) {
  const int P = kP ? kP : a.p;
  if (a.hyp != nullptr) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long v = a.hyp[4LL * i + r];
      k[r] = (v >= 0 && v < P) ? static_cast<int>(v) : 0;
    }
    return;
  }
  if (n_valid >= 4) {
    // one pass: the four largest valid draws, kept sorted, a later equal
    // draw placed after an earlier one (an invalid window's draw taken as
    // -inf, never placed).  With four finite valid draws or more that is
    // the four rounds' result; a NaN or infinite draw takes the rounds
    // below.  Selects, not branches: the lanes of a warp score different
    // hypotheses.
    float t0 = -INFINITY, t1 = -INFINITY, t2 = -INFINITY, t3 = -INFINITY;
    int i0 = 0, i1 = 0, i2 = 0, i3 = 0;
    bool finite = true;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bool ok = valid[p];
      const float v = ok ? col[stride * p] : -INFINITY;
      finite = finite && (!ok || fabsf(v) < INFINITY);
      const bool c0 = v > t0, c1 = v > t1, c2 = v > t2, c3 = v > t3;  // c0 => c1 => c2 => c3
      t3 = c2 ? t2 : (c3 ? v : t3);
      i3 = c2 ? i2 : (c3 ? p : i3);
      t2 = c1 ? t1 : (c2 ? v : t2);
      i2 = c1 ? i1 : (c2 ? p : i2);
      t1 = c0 ? t0 : (c1 ? v : t1);
      i1 = c0 ? i0 : (c1 ? p : i1);
      t0 = c0 ? v : t0;
      i0 = c0 ? p : i0;
    }
    if (finite) {
      k[0] = i0; k[1] = i1; k[2] = i2; k[3] = i3;
      return;
    }
  }
  for (int r = 0; r < 4; ++r) {
    int bi = 0;
    float bv = -INFINITY;
    for (int p = 0; p < P; ++p) {
      bool taken = false;
      for (int s = 0; s < r; ++s) taken |= k[s] == p;
      const float v = (valid[p] && !taken) ? col[stride * p] : -INFINITY;
      if (p == 0 || v > bv || (v != v && bv == bv)) {
        bv = v;
        bi = p;
      }
    }
    k[r] = bi;
  }
}

template <int kP>
__device__ __forceinline__ void hypothesis(const Args& a, int i, const float* col, long long stride,
                           const unsigned char* valid, int n_valid, const float* ax,
                           const float* ay, const float* bx, const float* by, float h[9]) {
  int k[4];
  picks_of<kP>(a, i, col, stride, valid, n_valid, k);
  float xs[4], ys[4], us[4], vs[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    xs[r] = ax[k[r]]; ys[r] = ay[k[r]]; us[r] = bx[k[r]]; vs[r] = by[k[r]];
  }
  solve_h4(xs, ys, us, vs, a.hyp != nullptr, h);
}

// ------------------------------------------------- refit and decomposition --
// float32, each step in the order torch takes it on the card (measured
// against torch on an H100 by scripts/probe_torch_orders_torch.py): an
// elementwise step as written; a sum or norm over the last dimension as
// torch's reduction kernel adds (tsum); a 3 x 3 product a term
// fma(x2, y2, fma(x1, y1, x0 y0)), as cuBLAS forms it.

// torch divides a tensor by a Python number on the card as a product with
// the number's float32 reciprocal
constexpr float kThird = 1.0f / 3.0f, kSixth = 1.0f / 6.0f;

// torch's CUDA reduction of n <= 32 values over the last dimension
// (ATen/native/cuda/Reduce.cuh): bw = the largest power of two <= n lanes,
// lane t adding values t and t + bw, then a tree with decreasing offsets
__device__ float tsum(const float* v, int n) {
  float lanes[32];
  int bw = 1;
  while (bw * 2 <= n) bw *= 2;
  for (int t = 0; t < bw; ++t) lanes[t] = t + bw < n ? v[t] + v[t + bw] : v[t];
  for (int off = bw / 2; off > 0; off /= 2)
    for (int t = 0; t < off; ++t) lanes[t] = lanes[t] + lanes[t + off];
  return lanes[0];
}

// torch.linalg.norm over the last dimension: the squares, then tsum
__device__ float tnorm(const float* v, int n) {
  float sq[32];
  for (int k = 0; k < n; ++k) sq[k] = v[k] * v[k];
  return sqrtf(tsum(sq, n));
}

__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float signd(float x) { return x >= 0.0f ? 1.0f : -1.0f; }
__device__ __forceinline__ float nanmin2(float x, float y) {
  return (x != x || y != y) ? NAN : (x < y ? x : y);
}

// homography.py::_det3x3
__device__ float det3(const float m[9]) {
  return m[0] * (m[4] * m[8] - m[5] * m[7]) - m[1] * (m[3] * m[8] - m[5] * m[6]) +
         m[2] * (m[3] * m[7] - m[4] * m[6]);
}

__device__ void matmul3(const float x[9], const float y[9], float out[9]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[i * 3 + j] = fmaf(x[i * 3 + 2], y[6 + j], fmaf(x[i * 3 + 1], y[3 + j], x[i * 3] * y[j]));
}

__device__ float norm3(const float v[3]) { return tnorm(v, 3); }

// -minor of a 3 x 3 (homography.py::_opposite_of_minor)
__device__ float opp_minor(const float m[9], int row, int col) {
  const int x1 = col == 0 ? 1 : 0, x2 = col == 2 ? 1 : 2;
  const int y1 = row == 0 ? 1 : 0, y2 = row == 2 ? 1 : 2;
  return m[y1 * 3 + x2] * m[y2 * 3 + x1] - m[y1 * 3 + x1] * m[y2 * 3 + x2];
}

// The middle singular value from the closed-form eigenvalues of H^T H
// (homography.py::_sv_middle_3x3)
__device__ float sv_middle(const float h[9]) {
  float ht[9], a[9], b[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) ht[i * 3 + j] = h[j * 3 + i];
  matmul3(ht, h, a);
  const float diag[3] = {a[0], a[4], a[8]};
  const float q = tsum(diag, 3) * kThird;
  float sq[9];
  for (int k = 0; k < 9; ++k) {
    b[k] = a[k] - ((k % 4 == 0) ? q : 0.0f);
    sq[k] = b[k] * b[k];
  }
  const float p = sqrtf(clamp_min(tsum(sq, 9) * kSixth, 0.0f));
  const float psafe = p > 1e-30f ? p : 1.0f;
  float bn[9];
  for (int k = 0; k < 9; ++k) bn[k] = b[k] / psafe;
  const float rr = clamp(det3(bn) / 2.0f, -1.0f, 1.0f);
  const float phi = acosf(rr) * kThird;
  const float e1 = q + 2.0f * p * cosf(phi);
  const float e3 = q + 2.0f * p * cosf(phi + 2.0943951023931953f);  // 2 pi / 3
  const float e2 = p > 1e-30f ? 3.0f * q - e1 - e3 : q;
  return sqrtf(clamp_min(e2, 0.0f));
}

// x / max(|x|, 1e-12), a NaN norm kept (torch.clamp)
__device__ void unit3(const float x[3], float out[3]) {
  const float n = clamp_min(norm3(x), 1e-12f);
  for (int k = 0; k < 3; ++k) out[k] = x[k] / n;
}

struct Decomposition {
  float rots[4][9], trans[4][3], norms[4][3];
  int n;
};

// Analytical Malis-Vargas decomposition (homography.py::decompose_homography):
// solutions ordered [Ra+, Ra-, Rb+, Rb-]; a (near-)pure rotation gives one.
__device__ void decompose(const float h[9], Decomposition& d) {
  const float gamma = sv_middle(h);
  float hn[9];
  for (int k = 0; k < 9; ++k) hn[k] = h[k] / gamma;
  const float sg = signd(det3(hn));
  for (int k = 0; k < 9; ++k) hn[k] = hn[k] * sg;
  float hnt[9], s[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) hnt[i * 3 + j] = hn[j * 3 + i];
  matmul3(hnt, hn, s);
  float smax = 0.0f;
  for (int k = 0; k < 9; ++k) {
    s[k] -= (k % 4 == 0) ? 1.0f : 0.0f;
    const float v = fabsf(s[k]);
    if (v > smax || v != v) smax = v;
  }
  const bool rotation_only = smax < 1e-3f;

  const float m00 = opp_minor(s, 0, 0), m11 = opp_minor(s, 1, 1), m22 = opp_minor(s, 2, 2);
  const float rt00 = sqrtf(clamp_min(m00, 0.0f)), rt11 = sqrtf(clamp_min(m11, 0.0f));
  const float rt22 = sqrtf(clamp_min(m22, 0.0f));
  const float e12 = signd(opp_minor(s, 1, 2)), e02 = signd(opp_minor(s, 0, 2));
  const float e01 = signd(opp_minor(s, 0, 1));
  const float s00 = s[0], s11 = s[4], s22 = s[8], s01 = s[1], s02 = s[2], s12 = s[5];
  // argmax(|s00|, |s11|, |s22|), the first of equals (NaN first)
  int idx = 0;
  float best = fabsf(s00);
  const float cand[2] = {fabsf(s11), fabsf(s22)};
  for (int k = 0; k < 2; ++k)
    if (cand[k] > best || (cand[k] != cand[k] && best == best)) {
      best = cand[k];
      idx = k + 1;
    }
  float npa[3], npb[3];
  if (idx == 0) {
    npa[0] = s00; npa[1] = s01 + rt22; npa[2] = s02 + e12 * rt11;
    npb[0] = s00; npb[1] = s01 - rt22; npb[2] = s02 - e12 * rt11;
  } else if (idx == 1) {
    npa[0] = s01 + rt22; npa[1] = s11; npa[2] = s12 - e02 * rt00;
    npb[0] = s01 - rt22; npb[1] = s11; npb[2] = s12 + e02 * rt00;
  } else {
    npa[0] = s02 + e01 * rt11; npa[1] = s12 + rt00; npa[2] = s22;
    npb[0] = s02 - e01 * rt11; npb[1] = s12 - rt00; npb[2] = s22;
  }
  const float trace = s00 + s11 + s22;
  const float v = 2.0f * sqrtf(clamp_min(1.0f + trace - m00 - m11 - m22, 0.0f));
  const float s_ii = idx == 0 ? s00 : (idx == 1 ? s11 : s22);
  const float es = signd(s_ii);
  const float r = sqrtf(clamp_min(2.0f + trace + v, 0.0f));
  const float nt = sqrtf(clamp_min(2.0f + trace - v, 0.0f));
  float na[3], nb[3];
  unit3(npa, na);
  unit3(npb, nb);
  const float half_nt = 0.5f * nt, esr = es * r;
  float ta_s[3], tb_s[3];
  for (int k = 0; k < 3; ++k) {
    ta_s[k] = half_nt * (esr * nb[k] - nt * na[k]);
    tb_s[k] = half_nt * (esr * na[k] - nt * nb[k]);
  }
  const float inv_v = 2.0f / (fabsf(v) > 1e-30f ? v : 1e-30f);
  float ra[9], rb[9], ma[9], mb[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      ma[i * 3 + j] = eye - inv_v * (ta_s[i] * na[j]);
      mb[i * 3 + j] = eye - inv_v * (tb_s[i] * nb[j]);
    }
  matmul3(hn, ma, ra);
  matmul3(hn, mb, rb);
  float ta[3], tb[3];
  for (int i = 0; i < 3; ++i) {  // cuBLAS's order for a [3, 3] @ [3, 1] product
    ta[i] = fmaf(ra[i * 3 + 1], ta_s[1], ra[i * 3] * ta_s[0]) + ra[i * 3 + 2] * ta_s[2];
    tb[i] = fmaf(rb[i * 3 + 1], tb_s[1], rb[i * 3] * tb_s[0]) + rb[i * 3 + 2] * tb_s[2];
  }
  for (int k = 0; k < 9; ++k) {
    d.rots[0][k] = rotation_only ? hn[k] : ra[k];
    d.rots[1][k] = rotation_only ? hn[k] : ra[k];
    d.rots[2][k] = rotation_only ? hn[k] : rb[k];
    d.rots[3][k] = rotation_only ? hn[k] : rb[k];
  }
  for (int k = 0; k < 3; ++k) {
    d.trans[0][k] = rotation_only ? 0.0f : ta[k];
    d.trans[1][k] = rotation_only ? 0.0f : -ta[k];
    d.trans[2][k] = rotation_only ? 0.0f : tb[k];
    d.trans[3][k] = rotation_only ? 0.0f : -tb[k];
    d.norms[0][k] = rotation_only ? 0.0f : na[k];
    d.norms[1][k] = rotation_only ? 0.0f : -na[k];
    d.norms[2][k] = rotation_only ? 0.0f : nb[k];
    d.norms[3][k] = rotation_only ? 0.0f : -nb[k];
  }
  d.n = rotation_only ? 1 : 4;
}

__device__ void quat_normalize(float q[4]) {
  const float n = tnorm(q, 4);
  for (int k = 0; k < 4; ++k) q[k] = q[k] / n;
}

// Shepperd's method, branch-free (rotations.py::quat_from_matrix)
__device__ void quat_from_matrix(const float m[9], float out[4]) {
  const float m00 = m[0], m01 = m[1], m02 = m[2], m10 = m[3], m11 = m[4], m12 = m[5];
  const float m20 = m[6], m21 = m[7], m22 = m[8];
  const float tr = m00 + m11 + m22;
  const float piv[4] = {tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11};
  int best = 0;
  for (int k = 1; k < 4; ++k)
    if (piv[k] > piv[best] || (piv[k] != piv[k] && piv[best] == piv[best])) best = k;
  float parts[4];
  if (best == 0) {
    parts[0] = m21 - m12; parts[1] = m02 - m20; parts[2] = m10 - m01;
  } else if (best == 1) {
    parts[1] = m01 + m10; parts[2] = m02 + m20; parts[3] = m21 - m12;
  } else if (best == 2) {
    parts[0] = m01 + m10; parts[2] = m12 + m21; parts[3] = m02 - m20;
  } else {
    parts[0] = m02 + m20; parts[1] = m12 + m21; parts[3] = m10 - m01;
  }
  // the pivot's own component is 4 root^2 (root = sqrt(1 + pivot) / 2)
  const int own = best == 0 ? 3 : best - 1;
  const float root = sqrtf(clamp_min(1.0f + piv[best], 0.0f)) / 2.0f;
  const float scale = clamp_min(4.0f * root, 1e-12f);
  parts[own] = 4.0f * root * root;
  for (int k = 0; k < 4; ++k) out[k] = parts[k] / scale;
  quat_normalize(out);
}

// tf2 getAxis()/getAngle() (rotations.py::quat_axis_angle): the axis rule's
// threshold 10 FLT_EPSILON, as the plain version takes it in float32
__device__ void quat_axis_angle(const float q_in[4], float axis[3], float& angle) {
  float q[4] = {q_in[0], q_in[1], q_in[2], q_in[3]};
  quat_normalize(q);
  const float w = clamp(q[3], -1.0f, 1.0f);
  angle = 2.0f * acosf(w);
  const float s2 = 1.0f - w * w;
  const bool safe = s2 >= 1.1920929e-06f;
  const float s = sqrtf(safe ? s2 : 1.0f);
  axis[0] = safe ? q[0] / s : 1.0f;
  axis[1] = safe ? q[1] / s : 0.0f;
  axis[2] = safe ? q[2] / s : 0.0f;
}

// torch.linalg.cross's kernel, whose a b - c d the compiler fuses
__device__ void cross3(const float a[3], const float b[3], float out[3]) {
  out[0] = fmaf(a[1], b[2], -(a[2] * b[1]));
  out[1] = fmaf(a[2], b[0], -(a[0] * b[2]));
  out[2] = fmaf(a[0], b[1], -(a[1] * b[0]));
}

__device__ void quat_rotate(const float q[4], const float v[3], float out[3]) {
  float t[3], c[3];
  cross3(q, v, t);
  for (int k = 0; k < 3; ++k) t[k] = 2.0f * t[k];
  cross3(q, t, c);
  for (int k = 0; k < 3; ++k) out[k] = v[k] + q[3] * t[k] + c[k];
}

__device__ void quat_from_axis_angle(const float axis[3], float angle, float out[4]) {
  const float n = norm3(axis);
  const float half = angle * 0.5f;
  const float sh = sinf(half);
  for (int k = 0; k < 3; ++k) out[k] = axis[k] / n * sh;
  out[3] = cosf(half);
}

__device__ float quat_angle(const float a[4], const float b[4]) {
  float ab[4], aa[4], bb[4];
  for (int k = 0; k < 4; ++k) {
    ab[k] = a[k] * b[k];
    aa[k] = a[k] * a[k];
    bb[k] = b[k] * b[k];
  }
  return acosf(clamp(tsum(ab, 4) / sqrtf(tsum(aa, 4) * tsum(bb, 4)), -1.0f, 1.0f));
}

// The method-4 node's summary head of one pair's getRT (geometry/motion.py::
// rt_body_frame, each step as torch takes it): [ok, tran_b (3), roll, pitch,
// yaw, n_inliers, ang_diff_rejected].  tran_b = detilt * (c2b * tran)
// (src/optic_flow.cpp:1694); the rate's axis into the body frame, rotation
// only (:1747), then tf2's getRPY of its matrix (rotations.py::
// rpy_from_matrix: roll and yaw 0 at the gimbal, |sin pitch| >= 1 - 1e-9,
// which is 1 in float32).
__device__ void body_frame(const float c2b[4], const float detilt[4], const float tran[3],
                           const float rot[4], bool ok, int n_inl, bool rejected, float* out) {
  float t_c[3], t_b[3];
  quat_rotate(c2b, tran, t_c);
  quat_rotate(detilt, t_c, t_b);
  float axis[3], angle, axis_b[3], q[4];
  quat_axis_angle(rot, axis, angle);
  quat_rotate(c2b, axis, axis_b);
  quat_from_axis_angle(axis_b, angle, q);
  quat_normalize(q);  // matrix_from_quat
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float m00 = 1.0f - 2.0f * (y * y + z * z);
  const float m10 = 2.0f * (x * y + z * w);
  const float m20 = 2.0f * (x * z - y * w);
  const float m21 = 2.0f * (y * z + x * w);
  const float m22 = 1.0f - 2.0f * (x * x + y * y);
  const float sp = clamp(-m20, -1.0f, 1.0f);
  const bool gimbal = fabsf(sp) >= 1.0f;
  out[0] = ok ? 1.0f : 0.0f;
  for (int k = 0; k < 3; ++k) out[1 + k] = t_b[k];
  out[4] = gimbal ? 0.0f : atan2f(m21, m22);
  out[5] = asinf(sp);
  out[6] = gimbal ? 0.0f : atan2f(m10, m00);
  out[7] = static_cast<float>(n_inl);
  out[8] = rejected ? 1.0f : 0.0f;
}

// --------------------------------------------------------------- the kernel --


// The orders in which cuBLAS sums v^T A for torch.einsum("...m,...mk->...k")
// over M = 2P rows, by the pipeline's batch (one pair: b = 1), as measured
// on an H100 with CUDA 12.8 (scripts/probe_torch_orders_torch.py): two
// halves each accumulated by fused multiply-adds, then added; one chain;
// or the even and the odd rows, then added.  Batch 128 and one pair at
// M = 72 or 128 matched none of these; they take the halves.
enum { kHalves = 0, kChain = 1, kEvenOdd = 2 };

__device__ int product_scheme(int b, int M) {
  if (b >= 4096 && M > 32) return M <= 72 ? kChain : kEvenOdd;
  return kHalves;
}

__device__ __forceinline__ float product(const float* v, const float* A, int k, int M, int scheme) {
  float acc0 = 0.0f, acc1 = 0.0f;
  if (scheme == kChain) {
#pragma unroll 8
    for (int m = 0; m < M; ++m) acc0 = fmaf(v[m], A[9 * m + k], acc0);
    return acc0;
  }
  if (scheme == kEvenOdd) {
#pragma unroll 8
    for (int m = 0; m < M; m += 2) acc0 = fmaf(v[m], A[9 * m + k], acc0);
#pragma unroll 8
    for (int m = 1; m < M; m += 2) acc1 = fmaf(v[m], A[9 * m + k], acc1);
    return acc0 + acc1;
  }
  const int half = (M + 1) / 2;
#pragma unroll 8
  for (int m = 0; m < half; ++m) acc0 = fmaf(v[m], A[9 * m + k], acc0);
#pragma unroll 8
  for (int m = half; m < M; ++m) acc1 = fmaf(v[m], A[9 * m + k], acc1);
  return acc0 + acc1;
}

// One pair's shared memory
struct Shared {
  float* a;    // [2P, 9] the refit system, row-major
  float* v;    // [2P] the Householder vector of the refit's current column
  float* g;    // [2, threads, P + 1] two rows of draws a thread (batched block layout)
  float* ax;   // [P] each, zero at an invalid window
  float* ay;
  float* bx;
  float* by;
  unsigned char* valid;  // [P]
  unsigned char* inl;    // [P] the winner's inlier set
  float* h_seed;         // [9] the winner's homography
  float* w;              // [9] the refit's v^T A
};

// Dynamic shared memory of a block-layout block of `threads` at p windows;
// the batched path stages each thread's columns of draws, two rows a
// thread, the one it scores and the next one in flight (an odd row pitch,
// P + 1, keeps the threads' rows on different banks).  Such a block keeps
// h_seed and w in static shared memory.
__host__ __device__ inline long long smem_bytes(int p, int threads, bool batched) {
  return 4LL * 20 * p + (batched ? 4LL * 2 * threads * (p + 1) : 0) + 4LL * 4 * p +
         ((2LL * p + 7) / 8) * 8;
}

// A warp block's shared memory a pair (a warp): a block's without draws,
// and h_seed and w; a multiple of 8 bytes.
__host__ __device__ inline long long pair_smem_bytes(int p) { return smem_bytes(p, 0, false) + 4LL * 18; }

// A warp block's two tiles of the draws of 32 hypotheses for its `pairs`
// pairs, [32][P][pairs] each, a hypothesis's row padded by one float (the
// lanes, a hypothesis each, read one pair's column on different banks)
__host__ __device__ inline long long tile_bytes(int p, int pairs) { return 4LL * 2 * 32 * (p * pairs + 1); }

// Threads a block of the block layout: one a hypothesis up to `most`, whole
// warps, fewer where the batched path's staged draws would pass the shared
// memory a block may opt in to (smem_limit); 0 if even one warp does not
// fit.
__host__ __device__ inline int block_threads(int p, int iters, bool batched, long long smem_limit,
                                             int most) {
  int t = iters < most ? iters : most;
  t = ((t + 31) / 32) * 32;
  while (t > 0 && smem_bytes(p, t, batched) > smem_limit) t -= 32;
  return t;
}

// Warps a pair of a call over b pairs on `sms` SMs beyond one pair an SM:
// the power of two, 1 to 8, nearest below `fill` warps an SM.
__host__ __device__ inline int pair_warps(int b, int sms, int fill) {
  int w = 8;
  while (w > 1 && static_cast<long long>(w) * b > static_cast<long long>(fill) * sms) w /= 2;
  return w;
}

// Pairs a warp block of a call over b pairs on `sms` SMs: `most`, halved
// while that leaves fewer blocks than SMs, fewer where the block's shared
// memory would pass smem_limit; 0 if even one pair does not fit.
__host__ __device__ inline int block_pairs(int b, int sms, int p, long long smem_limit, int most) {
  int n = most;
  while (n > 1 && static_cast<long long>(n) * sms > b) n /= 2;
  while (n > 0 && n * pair_smem_bytes(p) + tile_bytes(p, n) > smem_limit) --n;
  return n;
}

// Lays out one pair's shared memory from `base` for `threads` draw rows.
__device__ Shared carve(float* base, int P, int threads, bool batched) {
  Shared sh;
  sh.a = base;
  sh.v = sh.a + 18 * P;
  sh.g = sh.v + 2 * P;
  sh.ax = sh.g + (batched ? 2 * threads * (P + 1) : 0);
  sh.ay = sh.ax + P;
  sh.bx = sh.ay + P;
  sh.by = sh.bx + P;
  sh.valid = reinterpret_cast<unsigned char*>(sh.by + P);
  sh.inl = sh.valid + P;
  sh.h_seed = sh.w = nullptr;
  return sh;
}

// 1. points (motion.py::rt_points) by threads t = 0..nt-1; returns how many
// of this thread's windows are valid
__device__ int points(const Args& a, int pair, const Shared& sh, int t, int nt) {
  const int P = a.p;
  const float fx = a.cam[0], fy = a.cam[4];
  const float ccx = a.cam[2] - (a.ulx != nullptr ? a.ulx[pair] : a.ulx_scalar);
  const float ccy = a.cam[5];
  int my_valid = 0;
  for (int p = t; p < P; p += nt) {
    float sx = a.shifts[(static_cast<long long>(pair) * P + p) * 2];
    float sy = a.shifts[(static_cast<long long>(pair) * P + p) * 2 + 1];
    const bool v = isfinite(sx) && isfinite(sy);
    sx = v ? sx : 0.0f;
    sy = v ? sy : 0.0f;
    const float cxg = static_cast<float>(p % a.q) * static_cast<float>(a.patch) +
                      static_cast<float>(a.patch / 2);
    const float cyg = static_cast<float>(p / a.q) * static_cast<float>(a.patch) +
                      static_cast<float>(a.patch / 2);
    float x0, y0, x1, y1;
    undistort(cxg, cyg, fx, fy, ccx, ccy, a.dist, x0, y0);
    undistort(cxg + sx, cyg + sy, fx, fy, ccx, ccy, a.dist, x1, y1);
    sh.ax[p] = v ? x0 : 0.0f;
    sh.ay[p] = v ? y0 : 0.0f;
    sh.bx[p] = v ? x1 : 0.0f;
    sh.by[p] = v ? y1 : 0.0f;
    sh.valid[p] = v;
    my_valid += v;
  }
  return my_valid;
}

// Hypothesis i (its draws `col`, element stride `stride`) scored over the
// points; kept as the thread's best if it has more inliers than that.
// kMasked: every window tested (an invalid one's zeros too), then masked,
// with no branch, which the warp layout and the per-pair path take; else
// only the valid windows, which the batched block layout takes (each
// measured the faster on its path on an H100; the count is the same).
template <int kP, bool kMasked>
__device__ __forceinline__ void score_one(const Args& a, int i, const float* col, long long stride,
                                          const Shared& sh, int n_valid, int& my_cnt, int& my_i,
                                          float my_h[9]) {
  const int P = kP ? kP : a.p;
  float h[9];
  hypothesis<kP>(a, i, col, stride, sh.valid, n_valid, sh.ax, sh.ay, sh.bx, sh.by, h);
  int cnt = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (kMasked)
      cnt += (sh.valid[p] != 0) & inlier(h, sh.ax[p], sh.ay[p], sh.bx[p], sh.by[p], a.thr2);
    else
      cnt += sh.valid[p] && inlier(h, sh.ax[p], sh.ay[p], sh.bx[p], sh.by[p], a.thr2);
  }
  if (cnt > my_cnt) {
    my_cnt = cnt;
    my_i = i;
#pragma unroll
    for (int c = 0; c < 9; ++c) my_h[c] = h[c];
  }
}

// Thread t's row of draws in buffer k (of 2) of a block of nt threads
__device__ __forceinline__ float* draw_row(const Shared& sh, int P, int t, int nt, int k) {
  return sh.g + static_cast<long long>(k * nt + t) * (P + 1);
}

// Hypothesis i's column of draws (batched; none past the last hypothesis)
// into `row` by asynchronous copies, P in flight, as one commit group
__device__ __forceinline__ void stage_draws(const Args& a, int pair, int i, float* row) {
  if (i < a.iters) {
    const float* g = a.gumbel + a.g_si * i + pair;
    for (int p = 0; p < a.p; ++p) __pipeline_memcpy_async(row + p, g + a.g_sp * p, sizeof(float));
  }
  __pipeline_commit();
}

// 2-3. hypotheses t, t + nt, ..., each scored over the points; the thread
// keeps its best (most inliers, lowest index) and that hypothesis's
// homography.  Batched, the caller has staged hypothesis t's draws into
// buffer 0 (stage_draws); each hypothesis's draws land while the one before
// is scored.
template <int kP>
__device__ void score(const Args& a, int pair, const Shared& sh, int n_valid, int t, int nt,
                      int& my_cnt, int& my_i, float my_h[9]) {
  const int P = kP ? kP : a.p;
  const bool batched = a.hyp == nullptr;
  my_cnt = -1;
  my_i = 0x7fffffff;
  int k = 0;
  for (int i = t; i < a.iters; i += nt, k ^= 1) {
    const float* my_g = draw_row(sh, P, t, nt, k);
    if (batched) {
      stage_draws(a, pair, i + nt, draw_row(sh, P, t, nt, k ^ 1));
      __pipeline_wait_prior(1);  // all but the group just committed: this row's
    }
    if (batched)
      score_one<kP, false>(a, i, my_g, 1, sh, n_valid, my_cnt, my_i, my_h);
    else
      score_one<kP, true>(a, i, my_g, 1, sh, n_valid, my_cnt, my_i, my_h);
  }
  if (batched) __pipeline_wait_prior(0);
}

// The argmax of a warp's (count, index): the most inliers, the lowest index
// of equals; every lane gets it
__device__ __forceinline__ void warp_argmax(int& cnt, int& idx) {
  for (int o = 16; o > 0; o >>= 1) {
    const int c = __shfl_xor_sync(0xffffffffu, cnt, o);
    const int i = __shfl_xor_sync(0xffffffffu, idx, o);
    if (c > cnt || (c == cnt && i < idx)) {
      cnt = c;
      idx = i;
    }
  }
}

// 5-6. the rest of one pair's getRT by one whole warp, after the argmax and
// the winner's inlier set: the refit, the decomposition, the selection, the
// outputs and the epilogue
template <int kP>
__device__ void refit_and_solve(const Args& a, int pair, const Shared& sh, int n_valid,
                                int best_cnt, int best_i, int lane) {
  const int P = kP ? kP : a.p;
  const bool batched = a.hyp == nullptr;
  // 5. the refit (homography.py::_solve_h_qr_null): Householder QR of the
  // weighted DLT rows (_dlt_rows), rows of the first point set then the
  // second, a lane a row
  const int M = 2 * P;
  float* A = sh.a;
  for (int m = lane; m < M; m += 32) {
    const int p = m < P ? m : m - P;
    const float w = sh.inl[p] ? 1.0f : 0.0f;
    const float x = sh.ax[p], y = sh.ay[p], u = sh.bx[p], v = sh.by[p];
    float* row = A + 9 * m;
    if (m < P) {
      row[0] = x; row[1] = y; row[2] = 1.0f; row[3] = 0.0f; row[4] = 0.0f; row[5] = 0.0f;
      row[6] = -x * u; row[7] = -y * u; row[8] = -u;
    } else {
      row[0] = 0.0f; row[1] = 0.0f; row[2] = 0.0f; row[3] = x; row[4] = y; row[5] = 1.0f;
      row[6] = -x * v; row[7] = -y * v; row[8] = -v;
    }
    for (int k = 0; k < 9; ++k) row[k] = row[k] * w;
  }
  __syncwarp();
  // torch's reduction of M values over lanes (torch.linalg.norm's order):
  // from 128 values on, each lane loads 4 neighbours at a time into its 4
  // accumulators; below, lane t takes values t, t + bw, ...
  const bool vec4 = M >= 128;
  int bw = 1;
  while (bw * 2 <= (vec4 ? M / 4 : M) && bw < 32) bw *= 2;
  const int scheme = product_scheme(a.b, M);
  for (int j = 0; j < 9; ++j) {
    float vs = 0.0f;  // the column's norm below row j - 1: 4 accumulators, then a tree
    if (lane < bw) {
      float vl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (vec4) {
        for (int idx = lane; idx * 4 + 3 < M; idx += bw) {
          for (int i = 0; i < 4; ++i) {
            const int m = idx * 4 + i;
            const float x = m >= j ? A[9 * m + j] : 0.0f;
            vl[i] = fmaf(x, x, vl[i]);
          }
        }
        const int m = M - M % 4 + lane;  // the tail
        if (m < M) {
          const float x = m >= j ? A[9 * m + j] : 0.0f;
          vl[0] = fmaf(x, x, vl[0]);
        }
      } else {
        int idx = lane;
        while (idx + 3 * bw < M) {
          for (int i = 0; i < 4; ++i) {
            const int m = idx + i * bw;
            const float x = m >= j ? A[9 * m + j] : 0.0f;
            vl[i] = fmaf(x, x, vl[i]);
          }
          idx += 4 * bw;
        }
        for (int i = 0; i < 4 && idx < M; ++i, idx += bw) {
          const float x = idx >= j ? A[9 * idx + j] : 0.0f;
          vl[i] = fmaf(x, x, vl[i]);
        }
      }
      vs = ((vl[0] + vl[1]) + vl[2]) + vl[3];
    }
    for (int off = bw / 2; off > 0; off /= 2) vs = vs + __shfl_down_sync(0xffffffffu, vs, off);
    const float normx = sqrtf(__shfl_sync(0xffffffffu, vs, 0));
    const float rjj = A[9 * j + j];
    const float sign = rjj >= 0.0f ? 1.0f : -1.0f;
    const float u1 = rjj + sign * normx;
    const bool safe = normx > 1e-30f;
    const float u1s = fabsf(u1) > 1e-30f ? u1 : 1.0f;
    const float tau = safe ? sign * u1 / (normx > 1e-30f ? normx : 1.0f) : 0.0f;
    // v: x / u1 below row j, 1 at it, 0 above (and 0 where the column is zero)
    for (int m = lane; m < M; m += 32)
      sh.v[m] = !safe ? 0.0f : (m == j ? 1.0f : (m > j ? A[9 * m + j] : 0.0f) / u1s);
    __syncwarp();
    // w = v^T A, a lane a column, in cuBLAS's order for torch.einsum
    if (lane < 9) sh.w[lane] = product(sh.v, A, lane, M, scheme);
    __syncwarp();
    for (int m = lane; m < M; m += 32) {
      if (m < j) continue;
      const float tv = tau * sh.v[m];
      for (int k = j; k < 9; ++k) A[9 * m + k] = A[9 * m + k] - tv * sh.w[k];
    }
    __syncwarp();
  }
  GRT_SPAN(4);
  // lanes 0-3 each run the rest on the same numbers, lane s taking solution
  // s of the decomposition; lane 0 writes the results
  if (lane >= 4) return;
  constexpr unsigned kLanes = 0xfu;

  // R with the diagonal guard, three rounds of inverse iteration from the
  // winner (solve_triangular's substitutions), h22 normalisation, the
  // identity where n_inliers < 4
  float R[81];
  for (int i = 0; i < 9; ++i)
    for (int k = i; k < 9; ++k) R[i * 9 + k] = A[9 * i + k];
  for (int i = 0; i < 9; ++i) {
    const float d = R[i * 9 + i];
    R[i * 9 + i] = fabsf(d) > 1e-12f ? d : 1e-12f;
  }
  float x[9], z[9];
  for (int k = 0; k < 9; ++k) x[k] = sh.h_seed[k];
  float nx;
  if (batched) {
    // the batched seed is a strided view ([9, B] transposed): torch's
    // reduction then sums each output in one thread, 4 accumulators in turn
    float vl[4];
    for (int i = 0; i < 4; ++i) vl[i] = fmaf(x[4 + i], x[4 + i], x[i] * x[i]);
    vl[0] = fmaf(x[8], x[8], vl[0]);
    nx = sqrtf(((vl[0] + vl[1]) + vl[2]) + vl[3]);
  } else {
    nx = tnorm(x, 9);
  }
  nx = clamp_min(nx, 1e-30f);
  for (int k = 0; k < 9; ++k) x[k] = x[k] / nx;
  for (int round = 0; round < 3; ++round) {
    // cuBLAS's substitutions for torch.linalg.solve_triangular: fused
    // updates, forward from the first column, backward from the last
    for (int i = 0; i < 9; ++i) {  // R^T z = x
      float acc = x[i];
      for (int k = 0; k < i; ++k) acc = fmaf(-R[k * 9 + i], z[k], acc);
      z[i] = acc / R[i * 9 + i];
    }
    for (int i = 8; i >= 0; --i) {  // R x = z
      float acc = z[i];
      for (int k = 8; k > i; --k) acc = fmaf(-R[i * 9 + k], x[k], acc);
      x[i] = acc / R[i * 9 + i];
    }
    nx = clamp_min(tnorm(x, 9), 1e-30f);
    for (int k = 0; k < 9; ++k) x[k] = x[k] / nx;
  }
  const float h22 = fabsf(x[8]) > 1e-12f ? x[8] : 1.0f;
  float h[9];
  const bool h_ok = best_cnt >= 4;
  for (int k = 0; k < 9; ++k) h[k] = h_ok ? x[k] / h22 : ((k % 4 == 0) ? 1.0f : 0.0f);

  GRT_SPAN(5);
  // 6. decomposition and solution selection (motion.py::rt_solution)
  const float dt = a.dts[pair], height = a.heights[pair];
  bool ok = isfinite(1.0f / dt) && n_valid >= a.thr_pts && h_ok && best_cnt >= a.thr_pts;
  Decomposition dec;
  decompose(h, dec);
  GRT_SPAN(6);
  const float c2b[4] = {a.c2b[0], a.c2b[1], a.c2b[2], a.c2b[3]};
  const float* rq = a.rate + 4LL * pair;
  const float rate[4] = {rq[0], rq[1], rq[2], rq[3]};
  const float rate_inv[4] = {-rate[0], -rate[1], -rate[2], rate[3]};
  float axis[3], angle, diff;
  {
    float q[4], axis_b[3], qr[4];
    quat_from_matrix(dec.rots[lane], q);
    quat_axis_angle(q, axis, angle);
    quat_rotate(c2b, axis, axis_b);  // deviation 1: rotation only
    quat_from_axis_angle(axis_b, angle / dt, qr);
    const float d = nanmin2(quat_angle(qr, rate), quat_angle(qr, rate_inv));
    diff = lane < dec.n ? d : kPiPlus1;
  }
  float diffs[4];
  for (int k = 0; k < 4; ++k) diffs[k] = __shfl_sync(kLanes, diff, k, 4);
  int best = 0;
  for (int k = 1; k < 4; ++k)
    if (diffs[k] < diffs[best] || (diffs[k] != diffs[k] && diffs[best] == diffs[best])) best = k;
  const float best_axis[3] = {__shfl_sync(kLanes, axis[0], best, 4),
                              __shfl_sync(kLanes, axis[1], best, 4),
                              __shfl_sync(kLanes, axis[2], best, 4)};
  const float best_angle = __shfl_sync(kLanes, angle, best, 4);
  if (lane != 0) return;
  GRT_SPAN(7);
  const float best_diff = diffs[best];
  const bool found = best_diff < kPi;  // bestIndex stays -1 otherwise (strict <)
  ok = ok && found;
  const bool multi = dec.n > 1;
  const bool rejected = found && multi && best_diff > kPiQuarter;
  ok = ok && (!multi || best_diff <= kPiQuarter);  // the pi/4 gate
  // inverseSolution <=> n_z >= 0; t flips on the multi-solution path only
  const float inv_unit = (multi && dec.norms[best][2] >= 0.0f) ? -1.0f : 1.0f;
  const float scale = height / dt;
  float tran[3], rot[4];
  for (int i = 0; i < 3; ++i) {
    float terms[3];
    for (int k = 0; k < 3; ++k) terms[k] = dec.rots[best][i * 3 + k] * (inv_unit * dec.trans[best][k]);
    tran[i] = tsum(terms, 3) * scale;
  }
  quat_from_axis_angle(best_axis, best_angle / dt, rot);
  bool finite = true;
  for (int k = 0; k < 3; ++k) finite = finite && isfinite(tran[k]);
  for (int k = 0; k < 4; ++k) finite = finite && isfinite(rot[k]);
  ok = ok && finite;
  for (int k = 0; k < 3; ++k) tran[k] = ok ? tran[k] : NAN;
  for (int k = 0; k < 4; ++k) rot[k] = ok ? rot[k] : NAN;

  GRT_SPAN(8);
  a.ok[pair] = ok;
  for (int k = 0; k < 4; ++k) a.rot[4LL * pair + k] = rot[k];
  for (int k = 0; k < 3; ++k) a.tran[3LL * pair + k] = tran[k];
  if (a.n_inl64)
    static_cast<long long*>(a.n_inl)[pair] = best_cnt;
  else
    static_cast<int*>(a.n_inl)[pair] = best_cnt;
  a.ang_diff[pair] = best_diff;
  a.rejected[pair] = rejected;
  if (a.best_out != nullptr) a.best_out[pair] = best_i;
  if (a.inl_out != nullptr)
    for (int p = 0; p < P; ++p) a.inl_out[static_cast<long long>(pair) * P + p] = sh.inl[p];
  if (a.h_out != nullptr)
    for (int k = 0; k < 9; ++k) a.h_out[9LL * pair + k] = h[k];
  GRT_SPAN(9);
  if (a.summary != nullptr) {
    const float detilt[4] = {a.detilt[0], a.detilt[1], a.detilt[2], a.detilt[3]};
    body_frame(c2b, detilt, tran, rot, ok, best_cnt, rejected, a.summary + 9LL * pair);
  }
  GRT_SPAN(10);
}

// The block layout: one block a pair.  kP: the window count, compiled in
// (16, the main path's 4 x 4 grid), or 0 for any.
template <int kP>
__global__ void __launch_bounds__(kMaxThreads, 1) get_rt_kernel(Args a) {
  extern __shared__ float smem_raw[];
  const int P = kP ? kP : a.p, pair = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  Shared sh = carve(smem_raw, P, nt, a.hyp == nullptr);
  __shared__ float h_seed[9], w_sh[9];
  __shared__ int red_cnt[kMaxThreads / 32], red_idx[kMaxThreads / 32];
  __shared__ int n_valid;
  sh.h_seed = h_seed;
  sh.w = w_sh;

  GRT_SPAN(0);
  if (a.hyp == nullptr) stage_draws(a, pair, tid, draw_row(sh, P, tid, nt, 0));  // lands during the points
  if (tid == 0) n_valid = 0;
  __syncthreads();
  const int my_valid = points(a, pair, sh, tid, nt);
  if (my_valid) atomicAdd(&n_valid, my_valid);
  __syncthreads();

  GRT_SPAN(1);
  int my_cnt, my_i;
  float my_h[9];
  score<kP>(a, pair, sh, n_valid, tid, nt, my_cnt, my_i, my_h);
  GRT_SPAN(2);
  // 4. argmax over the block: the most inliers, the lowest index of equals
  int best_cnt = my_cnt, best_i = my_i;
  warp_argmax(best_cnt, best_i);
  const int warp = tid / 32, lane = tid % 32, warps = (nt + 31) / 32;
  if (lane == 0) {
    red_cnt[warp] = best_cnt;
    red_idx[warp] = best_i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < warps; ++w)
      if (red_cnt[w] > best_cnt || (red_cnt[w] == best_cnt && red_idx[w] < best_i)) {
        best_cnt = red_cnt[w];
        best_i = red_idx[w];
      }
    red_cnt[0] = best_cnt;
    red_idx[0] = best_i;
  }
  __syncthreads();
  best_cnt = red_cnt[0];
  best_i = red_idx[0];
  if (my_i == best_i)  // the winner's owner: the homography it scored
    for (int k = 0; k < 9; ++k) h_seed[k] = my_h[k];
  __syncthreads();
  // the winner's inlier set again, with the scoring's arithmetic
  for (int p = tid; p < P; p += nt)
    sh.inl[p] = sh.valid[p] && inlier(h_seed, sh.ax[p], sh.ay[p], sh.bx[p], sh.by[p], a.thr2);
  __syncthreads();
  GRT_SPAN(3);
  if (warp != 0) return;
  refit_and_solve<kP>(a, pair, sh, n_valid, best_cnt, best_i, lane);
}

// Chunk c's draws (hypotheses 32 c .. 32 c + 31) of a warp block's `wb`
// pairs from pair0 into `tile` ([32][P][W], rows padded by one float) by
// asynchronous copies from the whole block, as one commit group: each
// (hypothesis, window) a run of wb adjacent floats of the [I, P, B] draws.
__device__ __forceinline__ void stage_tile(const Args& a, int pair0, int wb, int W, int c, float* tile) {
  const int P = a.p, run = P * wb, n = 32 * run;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int il = e / run, r = e - il * run, p = r / wb, w = r - p * wb;
    const int i = 32 * c + il;
    if (i < a.iters) {
      const float* g = a.gumbel + a.g_si * i + a.g_sp * p + pair0 + w;
      __pipeline_memcpy_async(tile + il * (P * W + 1) + p * W + w, g, sizeof(float));
    }
  }
  __pipeline_commit();
}

// The warp layout (batched): a warp a pair, blockDim.x / 32 pairs a block,
// adjacent in B.  The block stages each chunk of 32 hypotheses' draws into
// shared memory together, the next chunk in flight while the warps score
// the current one, lane l hypothesis 32 c + l of its warp's pair; after the
// last chunk each warp takes its argmax with shuffles and refits on its
// own: no barrier spans the block after the hypotheses.
template <int kPairs, int kMinBlocks, int kP>
__global__ void __launch_bounds__(32 * kPairs, kMinBlocks) get_rt_warp_kernel(Args a) {
  extern __shared__ float smem_raw[];
  const int P = kP ? kP : a.p, warp = threadIdx.x / 32, lane = threadIdx.x % 32, W = blockDim.x / 32;
  const int pair0 = blockIdx.x * W, pair = pair0 + warp;
  const int wb = a.b - pair0 < W ? a.b - pair0 : W;  // pairs of this block
  const bool active = warp < wb;
  const int tile_floats = 32 * (P * W + 1);
  float* tiles = smem_raw;
  Shared sh = carve(tiles + 2 * tile_floats + warp * (pair_smem_bytes(P) / 4), P, 0, false);
  sh.h_seed = reinterpret_cast<float*>(sh.valid + ((2 * P + 7) / 8) * 8);  // after the flags
  sh.w = sh.h_seed + 9;

  const int chunks = (a.iters + 31) / 32;
  GRT_SPAN(0);
  stage_tile(a, pair0, wb, W, 0, tiles);  // lands during the points
  int n_valid = 0;
  if (active) {
    n_valid = __reduce_add_sync(0xffffffffu, points(a, pair, sh, lane, 32));
    __syncwarp();
  }
  GRT_SPAN(1);
  int my_cnt = -1, my_i = 0x7fffffff;
  float my_h[9];
  for (int c = 0; c < chunks; ++c) {
    // the next chunk into the other tile (past the last one: an empty group)
    stage_tile(a, pair0, wb, W, c + 1, tiles + ((c + 1) & 1) * tile_floats);
    __pipeline_wait_prior(1);  // this thread's copies of chunk c
    __syncthreads();           // and every thread's
    const int i = 32 * c + lane;
    if (active && i < a.iters)
      score_one<kP, true>(a, i, tiles + (c & 1) * tile_floats + lane * (P * W + 1) + warp, W, sh, n_valid,
                          my_cnt, my_i, my_h);
    __syncthreads();  // chunk c read before chunk c + 2 lands in its tile
  }
  GRT_SPAN(2);
  __pipeline_wait_prior(0);
  if (!active) return;
  int best_cnt = my_cnt, best_i = my_i;
  warp_argmax(best_cnt, best_i);
  if (my_i == best_i)
    for (int k = 0; k < 9; ++k) sh.h_seed[k] = my_h[k];
  __syncwarp();
  for (int p = lane; p < P; p += 32)
    sh.inl[p] = sh.valid[p] && inlier(sh.h_seed, sh.ax[p], sh.ay[p], sh.bx[p], sh.by[p], a.thr2);
  __syncwarp();
  GRT_SPAN(3);
  refit_and_solve<kP>(a, pair, sh, n_valid, best_cnt, best_i, lane);
}

// The most dynamic shared memory this library has allowed each kernel so
// far, [kP == 16][warp layout].  Not a static inside launch: GCC makes a
// template's local static one symbol across every loaded build of this file
// (STB_GNU_UNIQUE), and a tuning variant would then skip its own kernel's
// opt-in.
static long long smem_set[2][2] = {{48 * 1024, 48 * 1024}, {48 * 1024, 48 * 1024}};

// Launches kernel G's layout with kP windows compiled in (0: any).
template <int kP>
int launch(const Args& a, bool warp, int threads, long long smem, cudaStream_t s) {
  auto warp_kernel = get_rt_warp_kernel<GRT_PAIRS, GRT_PAIR_BLOCKS, kP>;
  long long& set = smem_set[kP == 16][warp];
  if (smem > set) {
    const int bytes = static_cast<int>(smem);
    const cudaError_t err =
        warp ? cudaFuncSetAttribute(warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaFuncSetAttribute(get_rt_kernel<kP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    set = smem;
  }
  if (warp)
    warp_kernel<<<(a.b + threads / 32 - 1) / (threads / 32), threads, smem, s>>>(a);
  else
    get_rt_kernel<kP><<<a.b, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace grt

extern "C" {

// Dynamic shared memory of a block-layout block of `threads` at p windows,
// of one pair of a warp block, and of a warp block's two tiles of draws for
// `pairs` pairs, in bytes.
long long grt_smem_bytes(int p, int threads, int batched) {
  return grt::smem_bytes(p, threads, batched != 0);
}

long long grt_pair_smem_bytes(int p) { return grt::pair_smem_bytes(p); }

long long grt_tile_bytes(int p, int pairs) { return grt::tile_bytes(p, pairs); }

// The launch of a call over b pairs on the current device: threads a block
// (0 where p does not fit the device's shared memory), its dynamic shared
// memory, and whether it is the warp layout (`warp`): kMaxThreads threads a
// pair up to one pair an SM, then pair_warps' warps a pair, one warp the
// warp layout (batched only; every batched call with GRT_WARP_LAYOUT).
static int launch_shape(int b, int p, int iters, bool batched, bool* warp, long long* smem) {
  int dev = 0, optin = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  const long long limit = optin - 1024;
  const int warps = GRT_WARP_LAYOUT && batched ? 1
                    : b > sms                   ? grt::pair_warps(b, sms, grt::kFillWarps)
                                                : grt::kMaxThreads / 32;
  *warp = batched && warps == 1;
  if (*warp) {
    const int pairs = grt::block_pairs(b, sms, p, limit, GRT_PAIRS);
    *smem = pairs * grt::pair_smem_bytes(p) + grt::tile_bytes(p, pairs);
    return 32 * pairs;
  }
  const int threads = grt::block_threads(p, iters, batched, limit, 32 * warps);
  *smem = grt::smem_bytes(p, threads, batched);
  return threads;
}

int grt_block_threads(int b, int p, int iters, int batched) {
  bool warp = false;
  long long smem = 0;
  return launch_shape(b, p, iters, batched != 0, &warp, &smem);
}

long long grt_block_smem(int b, int p, int iters, int batched) {
  bool warp = false;
  long long smem = 0;
  launch_shape(b, p, iters, batched != 0, &warp, &smem);
  return smem;
}

// getRT of b pairs of p = q x q window shifts on `stream`.  Per pair (hyp
// non-null, b = 1): the hypotheses are hyp's `iters` rows of 4 point
// indices, normalized by h22.  Batched (gumbel non-null): each hypothesis is
// the top 4 of its column of draws [iters, p, b] (element strides g_si,
// g_sp, 1), normalized by its largest entry.  ulx: one crop offset a pair,
// or null for ulx_scalar; dist null for a distortion-free camera.  n_inl is
// int64 where n_inl64 != 0, else int32; best, inl and h may be null.  With
// detilt [4] non-null, summary [b, 9] receives each pair's body-frame
// summary head.  Returns the CUDA error code of the launch (0 on success).
int grt_get_rt(const void* shifts, const void* heights, const void* dts, const void* ulx,
               float ulx_scalar, const void* cam, const void* dist, const void* c2b,
               const void* rate, const void* hyp, const void* gumbel, long long g_si,
               long long g_sp, int b, int p, int q, int patch, int iters, int thr_pts, float thr2,
               void* ok, void* rot, void* tran, void* n_inl, int n_inl64, void* ang_diff,
               void* rejected, const void* detilt, void* summary, void* best, void* inl, void* h,
               void* stream) {
  if (b < 1 || 2 * p < 9 || p != q * q || iters < 1 || (hyp == nullptr) == (gumbel == nullptr) ||
      (hyp != nullptr && b != 1) || (detilt == nullptr) != (summary == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  grt::Args a;
  a.shifts = static_cast<const float*>(shifts);
  a.heights = static_cast<const float*>(heights);
  a.dts = static_cast<const float*>(dts);
  a.ulx = static_cast<const float*>(ulx);
  a.ulx_scalar = ulx_scalar;
  a.cam = static_cast<const float*>(cam);
  a.dist = static_cast<const float*>(dist);
  a.c2b = static_cast<const float*>(c2b);
  a.rate = static_cast<const float*>(rate);
  a.hyp = static_cast<const long long*>(hyp);
  a.gumbel = static_cast<const float*>(gumbel);
  a.g_si = g_si;
  a.g_sp = g_sp;
  a.b = b;
  a.p = p;
  a.q = q;
  a.patch = patch;
  a.iters = iters;
  a.thr_pts = thr_pts;
  a.thr2 = thr2;
  a.ok = static_cast<unsigned char*>(ok);
  a.rot = static_cast<float*>(rot);
  a.tran = static_cast<float*>(tran);
  a.n_inl = n_inl;
  a.n_inl64 = n_inl64;
  a.ang_diff = static_cast<float*>(ang_diff);
  a.rejected = static_cast<unsigned char*>(rejected);
  a.best_out = static_cast<int*>(best);
  a.inl_out = static_cast<unsigned char*>(inl);
  a.h_out = static_cast<float*>(h);
  a.detilt = static_cast<const float*>(detilt);
  a.summary = static_cast<float*>(summary);
  bool warp = false;
  long long smem = 0;
  const int threads = launch_shape(b, p, iters, hyp == nullptr, &warp, &smem);
  if (threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  // the main path's 16 windows compiled in, any other count at run time
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p == 16 ? grt::launch<16>(a, warp, threads, smem, s) : grt::launch<0>(a, warp, threads, smem, s);
}

}  // extern "C"
