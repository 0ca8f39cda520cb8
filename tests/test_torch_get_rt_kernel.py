"""Kernel G (``csrc/get_rt.cu``, ``ops/cuda_kernels.py::get_rt``) on the CPU.

G computes getRT in one launch on the card; here, on CPU tensors, its
wrappers run the plain version, the torch geometry.  These tests hold:

(a) ``get_rt`` and ``get_rt_batch`` (and ``cuda_kernels.get_rt``) on CPU
    tensors equal to their plain versions ``get_rt_ref`` /
    ``get_rt_batch_ref`` bit for bit, with no launch counted, at 16, 36 and
    64 windows, with and without the lens distortion;
(b) a NumPy model of G's order of decisions (the batched path's top 4 by
    four rounds of strict ``>``, its float32 hypotheses and scores in the
    plain version's operation order, the argmax with the lowest index on
    ties, the winner's inlier set computed again after the argmax) equal to
    the plain torch functions bit for bit, on seeded inputs with exact ties
    in the draws and in the counts;
(c) the plain versions within the present tolerances of the JAX
    ``get_rt`` / ``get_rt_batch`` (float32: ``tran`` 1e-3 m/s, ``rot``
    ``torch_parity.rot_tol``; float64: 1e-9);
(d) ``SOURCES`` names ``get_rt.cu``, built with ``-fmad=false``; the source's
    constants, shared-memory formulas and both layouts' block shapes are the
    wrapper's; the wrapper's checks raise on a wrong dtype, shape, window
    count, draws or epilogue input (``detilt``) before
    they look at the device, and on CPU tensors (no fallback).  The
    epilogue's plain version is held in ``tests/test_torch_body_frame.py``.
"""

import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_rot_close, to_numpy

from mrs_optic_flow_tpu.geometry import batched as jb
from mrs_optic_flow_tpu_torch.geometry import batched as tb
from mrs_optic_flow_tpu_torch.geometry import homography as th
from mrs_optic_flow_tpu_torch.geometry import motion as tm
from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck

SOURCE = ck.CSRC / "get_rt.cu"
FRAME = 480
CAM = np.array([[420.0, 0, 376.0], [0, 420.0, 240.0], [0, 0, 1]], np.float32)
DIST = np.array([-0.12, 0.03, 1e-3, -5e-4, 0.0], np.float32)
IDENTITY = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
DT = 0.05
THR = 0.01


def _windows(rng, b, p, n_outliers=2, n_nan=1):
    """``b`` pairs of ``p`` window shifts of a level camera translating,
    yawing and changing height over flat ground, with outliers and NaN
    windows (pair 0 has none valid)."""
    q = int(round(np.sqrt(p)))
    patch = FRAME // q
    c = np.arange(q) * patch + patch // 2
    gx, gy = np.meshgrid(c + 136.0, c)
    x, y = (gx.reshape(-1) - 376.0) / 420.0, (gy.reshape(-1) - 240.0) / 420.0
    out = np.empty((b, p, 2))
    for i in range(b):
        t = np.r_[rng.uniform(-0.02, 0.02, 2), rng.uniform(-0.004, 0.004)]
        yaw = rng.uniform(-0.02, 0.02)
        hm = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        hm = hm + np.outer(t, [0, 0, 1.0])
        w = hm @ np.stack([x, y, np.ones(p)])
        out[i, :, 0] = (w[0] / w[2] - x) * 420.0
        out[i, :, 1] = (w[1] / w[2] - y) * 420.0
        bad = rng.choice(p, n_outliers + n_nan, replace=False)
        out[i, bad[:n_outliers]] += rng.uniform(5, 10, (n_outliers, 2)) * rng.choice([-1, 1], (n_outliers, 2))
        out[i, bad[n_outliers:]] = np.nan
    out += rng.normal(0, 0.02, out.shape)
    out[0] = np.nan
    return out.astype(np.float32), patch


def _inputs(seed, b, p, dist):
    rng = np.random.default_rng(seed)
    shifts, patch = _windows(rng, b, p)
    heights = rng.uniform(1.0, 2.5, b).astype(np.float32)
    rates = np.tile(IDENTITY, (b, 1))
    t = torch.from_numpy
    return (t(shifts), t(heights), t(np.full(b, DT, np.float32)), 136.0, t(CAM),
            t(DIST) if dist else None, t(IDENTITY), t(rates)), patch


def _draws(seed, iters, p, b):
    g = tb.draw_gumbel(iters, p, b, "cpu", torch.Generator().manual_seed(seed))
    g[: iters // 4, 3] = g[: iters // 4, 5]  # exact ties between two windows' draws
    return g


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(torch.nan_to_num(x, nan=7.0), torch.nan_to_num(y, nan=7.0))


# --------------------------------------------------------------------- (a) --


@pytest.mark.parametrize("p", [16, 36, 64])
@pytest.mark.parametrize("dist", [False, True])
def test_cpu_tensors_take_the_plain_version(p, dist):
    """On CPU tensors the routed functions and the kernel's wrapper equal
    the plain versions bit for bit, and count no launch."""
    b, iters = 6, 48
    args, patch = _inputs(p + dist, b, p, dist)
    kw = dict(frame_size=FRAME, patch=patch, shifted_pts_thr=8)
    g = _draws(p, iters, p, b)
    before = ck.get_rt.LAUNCHES
    ref = tb.get_rt_batch_ref(*args, gumbel=g, ransac_iterations=iters, **kw)
    _assert_same(tb.get_rt_batch(*args, gumbel=g, ransac_iterations=iters, **kw), ref)
    _assert_same(ck.get_rt(*args, gumbel=g, **kw), ref)
    top4 = tb.gumbel_top4(g, torch.isfinite(args[0]).all(-1).T)
    for i in range(1, b):
        one = (args[0][i], args[1][i], args[2][i], 136.0, args[4], args[5], args[6], args[7][i])
        ref1 = tm.get_rt_ref(*one, hyp_idx=top4[:, :, i], **kw)
        _assert_same(tm.get_rt(*one, hyp_idx=top4[:, :, i], **kw), ref1)
        wrapped = ck.get_rt(one[0][None], one[1].reshape(1), one[2].reshape(1), 136.0, one[4], one[5],
                            one[6], one[7][None], hyp_idx=top4[:, :, i], **kw)
        _assert_same((x[0] for x in wrapped[:6]), ref1)
    assert ck.get_rt.LAUNCHES == before


def test_cpu_draws_are_the_plain_versions():
    """Without injected draws the routed functions draw from the generator
    exactly as the plain versions do."""
    args, patch = _inputs(3, 4, 16, False)
    kw = dict(frame_size=FRAME, patch=patch, ransac_iterations=32)
    _assert_same(tb.get_rt_batch(*args, generator=torch.Generator().manual_seed(5), **kw),
                 tb.get_rt_batch_ref(*args, generator=torch.Generator().manual_seed(5), **kw))
    one = (args[0][2], args[1][2], args[2][2], 136.0, args[4], args[5], args[6], args[7][2])
    _assert_same(tm.get_rt(*one, generator=torch.Generator().manual_seed(5), **kw),
                 tm.get_rt_ref(*one, generator=torch.Generator().manual_seed(5), **kw))


# --------------------------------------------------------------------- (b) --

F32 = np.float32


def _rounds(col, valid):
    """G's slow path: four rounds over the windows in index order, a
    candidate replacing the best only if strictly larger (or a NaN over a
    number); masked and taken windows read -inf; each round starts from
    window 0's value."""
    picks = []
    for _ in range(4):
        bi, bv = 0, None
        for k in range(len(col)):
            v = col[k] if valid[k] and k not in picks else F32(-np.inf)
            if k == 0 or v > bv or (np.isnan(v) and not np.isnan(bv)):
                bi, bv = k, v
        picks.append(bi)
    return picks


def _one_pass(col, valid):
    """G's fast path: the four largest valid draws in one pass, kept sorted,
    a draw entering above another only if strictly larger; None where a
    valid draw is NaN or infinite (G then takes the rounds)."""
    t, idx = [F32(-np.inf)] * 4, [0] * 4
    for k in range(len(col)):
        if not valid[k]:
            continue
        v = col[k]
        if not np.isfinite(v):
            return None
        for slot in range(4):
            if v > t[slot]:
                t.insert(slot, v)
                idx.insert(slot, k)
                t, idx = t[:4], idx[:4]
                break
    return idx


def model_top4(g, valid):
    """G's picks per (hypothesis, pair): the one pass where the pair has 4
    valid windows or more and the column's valid draws are finite, else the
    rounds."""
    iters, p, b = g.shape
    out = np.empty((iters, 4, b), np.int64)
    for j in range(b):
        for i in range(iters):
            fast = _one_pass(g[i, :, j], valid[:, j]) if valid[:, j].sum() >= 4 else None
            out[i, :, j] = fast if fast is not None else _rounds(g[i, :, j], valid[:, j])
    return out


def _det(pa, pb, qa, qb, ra, rb):
    return pa * (qb - rb) + qa * (rb - pb) + ra * (pb - qb)


def _side(a, b):
    d1 = _det(a[3], b[3], a[1], b[1], a[2], b[2])
    d2 = _det(a[0], b[0], a[3], b[3], a[2], b[2])
    d3 = _det(a[0], b[0], a[1], b[1], a[3], b[3])
    return [[d1 * a[0], d2 * a[1], d3 * a[2]], [d1 * b[0], d2 * b[1], d3 * b[2]], [d1, d2, d3]]


def model_h4_batched(xs, ys, us, vs):
    """G's batched hypothesis in float32, operation by operation: the
    canonical-basis solve, rows summed left to right, divided by the
    largest absolute entry (NaN or 0 -> 1)."""
    hs, hd = _side(xs, ys), _side(us, vs)
    adj = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            r1, r2 = [r for r in range(3) if r != j]
            c1, c2 = [c for c in range(3) if c != i]
            minor = hs[r1][c1] * hs[r2][c2] - hs[r1][c2] * hs[r2][c1]
            adj[i][j] = minor if (i + j) % 2 == 0 else -minor
    h = [hd[i][0] * adj[0][j] + hd[i][1] * adj[1][j] + hd[i][2] * adj[2][j] for i in range(3) for j in range(3)]
    m = np.abs(h[0])
    for k in range(1, 9):
        a = np.abs(h[k])
        m = np.where((a > m) | np.isnan(a), a, m)
    scale = np.where(m > 0, m, F32(1.0)).astype(F32)
    return [x / scale for x in h]


def model_inliers(h, x, y, u, v, valid):
    """G's reprojection test of every point for hypotheses ``h`` (nine
    arrays broadcasting against the points)."""
    d = h[6] * x + h[7] * y + h[8]
    d = np.where(np.abs(d) > F32(1e-12), d, F32(1e-12)).astype(F32)
    pu = (h[0] * x + h[1] * y + h[2]) / d
    pv = (h[3] * x + h[4] * y + h[5]) / d
    eu, ev = pu - u, pv - v
    return (eu * eu + ev * ev < F32(THR * THR)) & valid


def model_argmax(counts):
    """G's argmax over the hypotheses: each thread's strict ``>`` over its
    hypotheses, then the block's (count, lowest index) order."""
    best, best_c = 0, -1
    for i, c in enumerate(counts):
        if c > best_c:
            best, best_c = i, c
    return best


def test_one_pass_equals_the_rounds():
    """G's one-pass top 4 gives the four rounds' picks, order included, on
    finite draws with ties in every position; the rounds take NaN and
    infinite draws and fewer than 4 valid windows."""
    rng = np.random.default_rng(0)
    for _ in range(400):
        p = int(rng.integers(5, 40))
        col = rng.integers(-3, 4, p).astype(F32)  # many exact ties
        valid = rng.random(p) < 0.8
        if valid.sum() >= 4:
            assert _one_pass(col, valid) == _rounds(col, valid)
    col = np.array([1, np.nan, 3, 2, 0, 5], F32)
    assert _one_pass(col, np.ones(6, bool)) is None and _rounds(col, np.ones(6, bool)) == [1, 5, 2, 3]
    col = np.array([1, -np.inf, 3, 2, 0], F32)
    assert _one_pass(col, np.ones(5, bool)) is None and _rounds(col, np.ones(5, bool)) == [2, 3, 0, 4]
    # fewer than 4 valid windows: the rounds end on index 0, as torch.argmax does
    assert _rounds(np.array([1, 2, 3, 4, 5], F32), np.array([0, 1, 0, 1, 0], bool)) == [3, 1, 0, 0]


@pytest.mark.parametrize("p,iters", [(16, 64), (36, 48), (64, 40)])
def test_model_of_the_batched_decisions(p, iters):
    """G's batched decisions, modelled in NumPy float32, against
    ``ransac_best_b`` bit for bit: picks, hypotheses, counts, the best index
    with ties in the counts, its inlier count, set and homography."""
    b = 6
    args, patch = _inputs(10 + p, b, p, p == 36)
    g = _draws(p, iters, p, b)
    g[5, 7, 2] = np.nan  # a NaN draw counts as the largest (the rounds)
    g[6, 2, 3] = np.inf
    ax, ay, bx, by, valid, _ = tm.rt_points(args[0], args[2], 136.0, args[4], args[5], frame_size=FRAME,
                                           patch=patch, shifted_pts_thr=8)
    dec = tb.ransac_best_b(ax, ay, bx, by, valid, g, THR)
    pts = [t.numpy() for t in dec.points]
    vnp = valid.numpy()
    top = model_top4(g.numpy(), vnp)
    np.testing.assert_array_equal(top, tb.gumbel_top4(g, valid).numpy())
    ties = 0
    for j in range(b):
        sel = [[c[top[:, k, j], j] for k in range(4)] for c in pts]
        h = model_h4_batched(*sel)
        inl = model_inliers([x[:, None] for x in h], *(c[None, :, j] for c in pts), vnp[None, :, j])
        counts = inl.sum(1)
        best = model_argmax(counts)
        ties += int((counts == counts[best]).sum() > 1)
        assert best == int(dec.best[j]) and counts[best] == int(dec.n_inliers[j])
        # the winner again, after the argmax, as G computes it
        again = model_h4_batched(*[[c[top[best, k, j], j] for k in range(4)] for c in pts])
        np.testing.assert_array_equal(np.array(again, F32), dec.h_seed[:, j].numpy())
        np.testing.assert_array_equal(model_inliers(again, *(c[:, j] for c in pts), vnp[:, j]),
                                      dec.inliers[:, j].numpy())
    assert ties >= b - 2  # consensus pairs: many hypotheses see every inlier


def test_model_of_the_per_pair_decisions():
    """Per pair G scores the given hypotheses (here the plain solver's own
    matrices), takes the argmax with the lowest index of equals and the
    winner's inlier set again: ``ransac_best``'s best, count and set."""
    args, patch = _inputs(4, 5, 16, True)
    gen = torch.Generator().manual_seed(1)
    for j in range(1, 5):
        ax, ay, bx, by, valid, _ = tm.rt_points(args[0][j:j + 1], args[2][j:j + 1], 136.0, args[4], args[5],
                                               frame_size=FRAME, patch=patch, shifted_pts_thr=8)
        src = torch.stack([ax[:, 0], ay[:, 0]], -1)
        dst = torch.stack([bx[:, 0], by[:, 0]], -1)
        hyp = th.draw_hypotheses(valid[:, 0], 96, gen)
        hyp[10] = hyp[3]  # an exact tie in the counts
        src0, dst0, best, inliers, n, seed = th.ransac_best(src, dst, valid[:, 0], hyp, THR)
        hs = th._solve_h4(src0[hyp], dst0[hyp]).reshape(-1, 9).numpy()
        s, d, v = src0.numpy(), dst0.numpy(), valid[:, 0].numpy()
        inl = model_inliers([hs[:, k, None] for k in range(9)], s[None, :, 0], s[None, :, 1], d[None, :, 0],
                            d[None, :, 1], v[None])
        counts = inl.sum(1)
        k = model_argmax(counts)
        assert k == int(best) and counts[k] == int(n)
        np.testing.assert_array_equal(
            model_inliers(list(hs[k]), s[:, 0], s[:, 1], d[:, 0], d[:, 1], v), inliers.numpy())
        np.testing.assert_array_equal(hs[k].reshape(3, 3), seed.numpy())


# --------------------------------------------------------------------- (c) --

JFRAME, JPATCH, JB, JITERS = 256, 64, 8, 64


def _jax_case(seed, dtype):
    rng = np.random.default_rng(seed)
    args, _ = _inputs(seed, JB, 16, True)
    shifts = _windows(rng, JB, 16)[0] * np.float32(0.5)
    cam = np.array([[420.0, 0, 136.0], [0, 420.0, 128.0], [0, 0, 1]])
    return (shifts.astype(dtype), args[1].numpy().astype(dtype), np.full(JB, DT, dtype), 16.0,
            cam.astype(dtype), DIST.astype(dtype), IDENTITY.astype(dtype), np.tile(IDENTITY, (JB, 1)).astype(dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_batched_version_against_jax(dtype):
    """``get_rt_batch_ref`` on the JAX function's own draws: ok, n_inliers
    and the pi/4 flag equal; tran within 1e-3 m/s and rot within
    ``rot_tol`` in float32, both within 1e-9 in float64."""
    shifts, heights, dts, ul, cam, dist, c2b, rates = _jax_case(0, dtype)
    kw = dict(frame_size=JFRAME, patch=JPATCH, shifted_pts_thr=8, ransac_iterations=JITERS)
    with jax.enable_x64(dtype == np.float64):  # the JAX function draws in its own precision
        keys = jax.random.split(jax.random.PRNGKey(0), JB)
        g = np.array(jax.random.gumbel(keys[0], (JITERS, 16, JB)))
        jres = to_numpy(tuple(jb.get_rt_batch(*(jnp.asarray(a) for a in (shifts, heights, dts, ul, cam, dist, c2b,
                                                                            rates)), keys, **kw)))
    t = torch.from_numpy
    tres = to_numpy(tuple(tb.get_rt_batch_ref(t(shifts), t(heights), t(dts), ul, t(cam), t(dist), t(c2b), t(rates),
                                              gumbel=t(g), **kw)))
    np.testing.assert_array_equal(tres[0], jres[0])
    np.testing.assert_array_equal(tres[3], jres[3])
    np.testing.assert_array_equal(tres[5], jres[5])
    assert tres[0].sum() >= JB - 2
    if dtype == np.float64:
        np.testing.assert_allclose(tres[2], jres[2], atol=1e-9, rtol=0)
        np.testing.assert_allclose(tres[1], jres[1], atol=1e-9, rtol=0)
    else:
        np.testing.assert_allclose(tres[2], jres[2], atol=1e-3, rtol=0)
        assert_rot_close(tres[1], jres[1], dts)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_per_pair_version_against_jax(dtype):
    """``get_rt_ref`` on the JAX function's hypotheses (its Gumbel top 4 as
    ``hyp_idx``) against the JAX ``get_rt``, pair by pair."""
    shifts, heights, dts, ul, cam, dist, c2b, rates = _jax_case(1, dtype)
    t = torch.from_numpy
    kw = dict(frame_size=JFRAME, patch=JPATCH, shifted_pts_thr=8)
    with jax.enable_x64(dtype == np.float64):
        keys = jax.random.split(jax.random.PRNGKey(1), JB)
        g = np.array(jax.random.gumbel(keys[0], (JITERS, 16, JB)))
        top4 = tb.gumbel_top4(t(g), torch.isfinite(t(shifts)).all(-1).T)
        jall = to_numpy(tuple(jb.get_rt_batch(*(jnp.asarray(a) for a in (shifts, heights, dts, ul, cam, dist, c2b,
                                                                            rates)), keys,
                                              ransac_iterations=JITERS, **kw)))
    for i in range(1, JB):
        one = to_numpy(tuple(tm.get_rt_ref(t(shifts[i]), t(heights[i:i + 1])[0], t(dts[i:i + 1])[0], ul, t(cam),
                                           t(dist), t(c2b), t(rates[i]), hyp_idx=top4[:, :, i], **kw)))
        assert bool(one[0]) == bool(jall[0][i]) and int(one[3]) == int(jall[3][i])
        atol = 1e-9 if dtype == np.float64 else 1e-3
        np.testing.assert_allclose(one[2], jall[2][i], atol=atol, rtol=0)
        if dtype == np.float64:
            np.testing.assert_allclose(one[1], jall[1][i], atol=1e-9, rtol=0)
        else:
            assert_rot_close(one[1][None], jall[1][i][None], dts[i:i + 1])


# --------------------------------------------------------------------- (d) --


def test_source_is_listed_and_built_without_contraction():
    assert ck.SOURCES["get_rt"] == "get_rt.cu" and SOURCE.exists()
    assert "-fmad=false" in ck.SOURCE_FLAGS["get_rt"]
    text = SOURCE.read_text()
    assert re.search(r"constexpr int kMaxThreads = (\d+),", text).group(1) == str(ck.GRT_MAX_THREADS)
    pairs = tuple(int(re.search(rf"#define {m} (\d+)", text).group(1)) for m in ("GRT_PAIRS", "GRT_PAIR_BLOCKS"))
    assert pairs == ck.GRT_PAIR_SHAPE
    assert int(re.search(r"constexpr int kMaxThreads = \d+, kFillWarps = (\d+);", text).group(1)) == \
        ck.GRT_FILL_WARPS
    assert "#define GRT_WARP_LAYOUT 0" in text  # the shipped build: the warp layout beyond 2,112 pairs
    assert "4LL * 20 * p + (batched ? 4LL * 2 * threads * (p + 1) : 0) + 4LL * 4 * p +" in text
    assert "((2LL * p + 7) / 8) * 8" in text
    assert "return smem_bytes(p, 0, false) + 4LL * 18;" in text
    assert "return 4LL * 2 * 32 * (p * pairs + 1);" in text
    assert "while (n > 1 && static_cast<long long>(n) * sms > b) n /= 2;" in text
    assert "while (w > 1 && static_cast<long long>(w) * b > static_cast<long long>(fill) * sms) w /= 2;" in text
    assert "Replaces no TPU kernel" in text


def test_build_passes_the_source_flags(monkeypatch, tmp_path):
    """``start_build`` hands ``-fmad=false`` to kernel G's ``nvcc`` alone."""
    argvs = []

    class FakePopen:
        def __init__(self, argv, **kw):
            argvs.append(argv)
            self.returncode = 0

    monkeypatch.setattr(ck, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(ck, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(ck.subprocess, "Popen", FakePopen)
    ck.start_build(["get_rt", "sad_search"])
    flags = {a[-1].rsplit("/", 1)[-1]: a for a in argvs}
    assert "-fmad=false" in flags["get_rt.cu"] and "-fmad=false" not in flags["sad_search.cu"]


@pytest.mark.parametrize("p,threads,batched", [(16, 256, True), (64, 256, True), (16, 256, False), (9, 32, True)])
def test_shared_memory_and_threads(p, threads, batched):
    """Both layouts' shared memory and launch shapes on an H100's 132 SMs:
    a block of 256 threads a pair up to 132 pairs, then the warps a pair
    that fill 16 warps an SM, one warp the warp layout (pairs a block
    halved while the blocks would leave an SM idle)."""
    limit = ck.H100_SMEM_OPTIN_BYTES - ck.STATIC_SMEM_BYTES
    smem = ck.grt_smem_bytes(p, threads, batched)
    # two rows of draws a thread: the one scored and the next in flight
    assert smem == 80 * p + (8 * threads * (p + 1) if batched else 0) + 16 * p + (2 * p + 7) // 8 * 8
    t = ck.grt_block_threads(p, 512, batched, limit)
    assert t == ck.GRT_MAX_THREADS and ck.grt_smem_bytes(p, t, batched) <= limit
    assert ck.grt_block_threads(p, 40, batched, limit) == 64  # whole warps
    assert ck.grt_block_threads(256, 256, True, limit) == 96  # the staged draws cap the block
    assert ck.grt_block_threads(2000, 256, True, limit) == 0
    # the warp layout: a pair's region is a block's without draws and the
    # winner's homography and v^T A; the block's two tiles of 32
    # hypotheses' draws; 8 pairs a block at the bench batch
    pair = ck.grt_pair_smem_bytes(p)
    assert pair == ck.grt_smem_bytes(p, 0, False) + 72 and pair % 8 == 0
    assert ck.grt_tile_bytes(p, 8) == 2 * 32 * (8 * p + 1) * 4
    assert ck.GRT_PAIR_SHAPE == (8, 4) and ck.GRT_FILL_WARPS == 16
    assert ck.grt_block_pairs(4096, 132, p, limit) == 8
    assert ck.grt_block_pairs(1024, 132, p, limit) == 4
    assert ck.grt_block_pairs(512, 132, p, limit) == 2  # 256 blocks, none of 132 SMs idle
    assert ck.grt_block_pairs(133, 132, p, limit) == 1
    assert ck.grt_block_pairs(4096, 132, 256, limit) == 2  # shared memory caps the block
    assert ck.grt_block_pairs(4096, 132, 2000, limit) == 0
    # warps a pair: 8 up to one pair an SM, then as many as fill 16 an SM
    assert [ck.grt_pair_warps(b, 132) for b in (133, 264, 265, 512, 1056, 1057, 2112, 2113, 4096)] == \
        [8, 8, 4, 4, 2, 1, 1, 1, 1]
    launches = {b: ck.grt_launch(b, p, 256, batched, 132, limit) for b in (1, 128, 512, 1024, 4096)}
    assert [launches[b][:2] for b in (1, 128, 512, 1024)] == [(t, ck.grt_smem_bytes(p, t, batched))
                                                             for t in (256, 256, 128, 64)]
    assert launches[4096][2] == batched  # the warp layout takes the batched path only
    if batched:
        assert launches[4096][:2] == (256, 8 * pair + ck.grt_tile_bytes(p, 8))


def _good(b=1, p=16, hyp=True):
    args, patch = _inputs(0, max(b, 2), p, True)
    args = (args[0][:b], args[1][:b], args[2][:b]) + args[3:7] + (args[7][:b],)
    kw = dict(frame_size=FRAME, patch=patch)
    if hyp:
        kw["hyp_idx"] = torch.zeros((32, 4), dtype=torch.int64)
    else:
        kw["gumbel"] = torch.zeros((32, p, b))
    return list(args), kw


@pytest.mark.parametrize("bad", ["float64 shifts", "shifts shape", "heights shape", "camera", "dist",
                                 "ul per sample", "both draws", "no draws", "hyp with two pairs",
                                 "hyp shape", "gumbel shape", "gumbel dtype", "gumbel stride", "windows",
                                 "too few windows", "no hypotheses", "c2b shape", "c2b dtype", "detilt shape",
                                 "detilt dtype"])
def test_wrapper_checks_raise(bad):
    """Each argument the kernel does not take raises before any launch, and
    before the device is looked at."""
    args, kw = _good(hyp=bad not in ("gumbel shape", "gumbel dtype", "gumbel stride"))
    if bad == "float64 shifts":
        args[0] = args[0].double()
    elif bad == "shifts shape":
        args[0] = args[0][0]
    elif bad == "heights shape":
        args[1] = args[1].reshape(())
    elif bad == "camera":
        args[4] = args[4][:2]
    elif bad == "dist":
        args[5] = args[5][:4]
    elif bad == "ul per sample":
        args[3] = torch.zeros(3)
    elif bad == "both draws":
        kw["gumbel"] = torch.zeros((32, 16, 1))
    elif bad == "no draws":
        del kw["hyp_idx"]
    elif bad == "hyp with two pairs":
        args, kw = _good(b=2)
    elif bad == "hyp shape":
        kw["hyp_idx"] = torch.zeros((32, 3), dtype=torch.int64)
    elif bad == "gumbel shape":
        kw["gumbel"] = torch.zeros((32, 15, 1))
    elif bad == "gumbel dtype":
        kw["gumbel"] = kw["gumbel"].double()
    elif bad == "gumbel stride":
        kw["gumbel"] = torch.zeros((32, 16, 2))[..., ::2]
    elif bad == "windows":
        kw["patch"] = 96
    elif bad == "too few windows":
        args, kw = _good(p=4)
    elif bad == "no hypotheses":
        kw["hyp_idx"] = torch.zeros((0, 4), dtype=torch.int64)
    elif bad == "c2b shape":
        args[6] = args[6][:3]
    elif bad == "c2b dtype":
        args[6] = args[6].double()
    elif bad == "detilt shape":
        kw["detilt"] = torch.zeros(3)
    elif bad == "detilt dtype":
        kw["detilt"] = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError) as err:
        ck.launch_get_rt(*args, **kw)
    assert "CUDA" not in str(err.value)


def test_wrapper_refuses_cpu_tensors():
    """Well-formed CPU tensors do not reach a plain version through the
    launcher: it raises, naming the device; so does a well-formed epilogue
    input."""
    for hyp in (True, False):
        args, kw = _good(b=1 if hyp else 2, hyp=hyp)
        with pytest.raises(ValueError, match="CUDA"):
            ck.launch_get_rt(*args, **kw)
        with pytest.raises(ValueError, match="CUDA"):
            ck.launch_get_rt(*args, detilt=torch.zeros(4), **kw)


def test_sources_hold_every_kernel():
    """``cuda_kernels.SOURCES`` names a file in ``csrc/`` for every kernel,
    G's included, and each wrapper counts its launches."""
    for name, src in ck.SOURCES.items():
        assert (ck.CSRC / src).exists()
        assert isinstance(getattr(ck, name).LAUNCHES, int)
    assert pathlib.Path(ck.CSRC / ck.SOURCES["get_rt"]).name == "get_rt.cu"


def test_tune_script_on_the_cpu(capsys):
    """``scripts/tune_get_rt_kernel_torch.py`` on the CPU: one line a build
    (each ``PAIRSxBLOCKS`` of the warp layout, then each fill, then each
    rewrite), each case's launch from the mirror (the warp shapes' every
    batched case in the warp layout, its pairs halved at 512; a rewrite
    the shipped launch), nothing built; every rewrite's texts are in the
    source once."""
    from scripts import tune_get_rt_kernel_torch as tg

    assert tg.main(["--shapes", "8x2,4x4", "--fills", "8", "--rewrites", ",".join(tg.REWRITES),
                    "--cases", "4096x256x16,512x256x16,1x512x16", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["build"] for r in rows] == [tg.defines((8, 2)), tg.defines((4, 4)), {"fill": 8}] + \
        [{"rewrite": n} for n in tg.REWRITES]
    assert tg.defines((8, 2)) == {"GRT_PAIRS": 8, "GRT_PAIR_BLOCKS": 2, "GRT_WARP_LAYOUT": 1}
    assert not any(r["built"] for r in rows)
    pair, tile = ck.grt_pair_smem_bytes(16), ck.grt_tile_bytes
    assert rows[0]["cases"]["4096x256x16"] == {"threads": 256, "smem": 8 * pair + tile(16, 8), "warp_layout": True}
    assert rows[0]["cases"]["512x256x16"] == {"threads": 64, "smem": 2 * pair + tile(16, 2), "warp_layout": True}
    assert rows[1]["cases"]["4096x256x16"]["threads"] == 128
    assert rows[0]["cases"]["1x512x16"] == {"threads": 256, "smem": ck.grt_smem_bytes(16, 256, False),
                                            "warp_layout": False}
    assert rows[2]["cases"]["512x256x16"] == {"threads": 64, "smem": ck.grt_smem_bytes(16, 64, True),
                                              "warp_layout": False}
    assert all(r["cases"] == rows[-1]["cases"] for r in rows[3:])
    assert rows[-1]["cases"]["512x256x16"]["threads"] == 128
    src = SOURCE.read_text()
    for build in [("fill", 8)] + [("rewrite", n) for n in tg.REWRITES]:
        assert tg.rewritten(src, build) != src
    with pytest.raises(ValueError, match="once"):
        tg.rewritten(src.replace(tg.FILL, ""), ("fill", 8))
    with pytest.raises(SystemExit):
        tg.main(["--rewrites", "nonesuch", "--device", "cpu"])


def test_span_probe_finds_its_anchors():
    """``scripts/probe_get_rt_spans_torch.py``'s anchors are the source's
    ``GRT_SPAN(k)`` marks, empty in the shipped build: phases 0-3 in both
    layouts' kernels, 4-10 in the shared refit; the probe's copy defines
    them before the unchanged source and raises where one is missing."""
    from scripts import probe_get_rt_spans_torch as ps

    src = SOURCE.read_text()
    assert "#ifndef GRT_SPAN\n#define GRT_SPAN(k)\n#endif" in src
    counts = [src.count(f"GRT_SPAN({k});") for k in range(len(ps.PHASES) + 1)]
    assert counts == [2, 2, 2, 2] + [1] * (len(ps.PHASES) - 3)
    out = ps.instrumented(src)
    assert out.startswith(ps.SPAN) and src in out and "clock64()" in ps.SPAN
    with pytest.raises(ValueError, match="GRT_SPAN"):
        ps.instrumented(src.replace("GRT_SPAN(5);", ""))


def test_order_probe_on_the_cpu(capsys):
    """``scripts/probe_torch_orders_torch.py`` on the CPU at small shapes: a
    line an operation, its candidates' shares in [0, 1], the best first;
    torch's CPU einsum adds left to right without fusing, which no
    candidate but its own order matches everywhere."""
    from scripts import probe_torch_orders_torch as po

    assert po.main(["--batches", "1,4", "--rows", "18", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    ops = {r["op"] for r in rows}
    assert ops == {"einsum", "solve_triangular", "bmm_33_31", "bmm_33_33", "bmm_33t_33", "norm", "sum",
                   "norm_one_output", "norm_strided"}
    for r in rows:
        shares = [v for _, v in r["best"]]
        assert all(0.0 <= v <= 1.0 for v in shares) and shares == sorted(shares, reverse=True)
    # the reduction model on one output equals the model of many
    x = np.random.default_rng(0).standard_normal((5, 9))
    assert np.array_equal(po.torch_reduce(x, False), np.stack([po.torch_reduce(x[i:i + 1], False)[0]
                                                               for i in range(5)]))
