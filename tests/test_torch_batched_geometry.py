"""Parity of the port's batched geometry with the JAX package on the CPU:
``get_rt_batch`` fed the JAX function's own Gumbel draws
(``jax.random.gumbel(keys[0], (I, P, B))``), and ``get_2dt_batch`` against
``jax.vmap(get_2dt)``.

Tolerances: ``ok``, ``n_inliers`` and ``ang_diff_rejected`` equal.  In
float64 (JAX with x64, the port on float64 tensors) ``tran`` and ``rot``
agree to 1e-9 (``test_float64_chains_agree``).  In
float32 ``tran`` is held to 1e-3 m/s, the twist parity of
``tests/test_torch_node.py``: the float32 refit differs from the JAX one by
about 2e-7 in ``h`` (another summation order), and the decomposition takes
square roots of near-zero minors of ``H^T H - I``, which, times ``height /
dt``, moves ``tran`` by up to 9e-4 m/s on these inputs; the float64 run
shows that this gap is rounding.  ``rot`` is held sample by sample to
``torch_parity.rot_tol``: 1e-4 plus two ulps of the frame quaternion's
``w`` through tf2's ``2 acos(w)`` and axis normalization at that sample's
own angle.  The same bounds hold the batched function against the port's
per-pair ``get_rt`` on the same hypotheses (both run the same decomposition
and selection, ``motion.rt_solution``; only the RANSAC stage differs), and
``get_2dt_batch`` (no decomposition) is held to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import ATOL, assert_rot_close, to_numpy

from mrs_optic_flow_tpu.geometry import batched as jb
from mrs_optic_flow_tpu.geometry import motion as jm
from mrs_optic_flow_tpu_torch.geometry import batched as tb
from mrs_optic_flow_tpu_torch.geometry import motion as tm

FRAME, PATCH, B, ITERS = 256, 64, 8, 64
CAM = np.array([[420.0, 0, 136.0], [0, 420.0, 128.0], [0, 0, 1]], np.float32)
DIST = np.array([-0.28, 0.07, 1e-3, -5e-4, 0.0], np.float32)
IDENTITY = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
DT = 0.05
TRAN_TOL = 1e-3  # m/s, float32
F64_TOL = 1e-9  # tran and rot, float64


def _unit(q):
    q = np.asarray(q, np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _shifts(rng, b=B, n_outliers=0, n_invalid=0):
    """Per-sample flows of a translating, slightly rotating and zooming
    camera at the grid centres, with outliers and NaN windows."""
    centers = jm.grid_centers(FRAME, PATCH).astype(np.float64)
    p = centers.shape[0]
    rel = centers - FRAME / 2
    out = np.empty((b, p, 2), np.float32)
    for i in range(b):
        t = rng.uniform(-6, 6, 2)
        th = rng.uniform(-0.01, 0.01)
        s = 1.0 + rng.uniform(-0.01, 0.01)
        rot = s * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        flow = t + rel @ rot.T - rel + rng.normal(0, 0.02, (p, 2))
        bad = rng.choice(p, n_outliers + n_invalid, replace=False)
        flow[bad[:n_outliers]] += rng.uniform(8, 20, (n_outliers, 2)) * rng.choice([-1, 1], (n_outliers, 2))
        flow[bad[n_outliers:]] = np.nan
        out[i] = flow
    return out


def _case(name):
    """(shifts, heights, dts, ul_corner_x, dist or None, c2b, rates)."""
    rng = np.random.default_rng(CASES.index(name))
    heights = rng.uniform(1.5, 2.5, B).astype(np.float32)
    dts = np.full(B, DT, np.float32)
    ul, dist, c2b = np.float32(16.0), None, IDENTITY
    rates = np.tile(IDENTITY, (B, 1))
    shifts = _shifts(rng)
    if name == "outliers":
        shifts = _shifts(rng, n_outliers=4)
    elif name == "few_valid":
        shifts = np.concatenate([_shifts(rng, 4, n_invalid=9), _shifts(rng, 4, n_invalid=4)])
    elif name == "dt_zero":
        dts[[1, 5]] = 0.0
    elif name == "ul_per_sample":
        ul = rng.uniform(0.0, 64.0, B).astype(np.float32)
    elif name == "distortion":
        dist = DIST
    elif name == "c2b_and_rates":
        c2b = _unit([0.02, -0.03, 0.7, 0.7])
        rates = _unit(np.c_[rng.normal(0, 0.01, (B, 3)), np.ones(B)])
    return shifts, heights, dts, ul, dist, c2b, rates


CASES = ["consensus", "outliers", "few_valid", "dt_zero", "ul_per_sample", "distortion", "c2b_and_rates"]


def _jax_draws(seed, iters=ITERS, p=16, b=B):
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    return keys, np.asarray(jax.random.gumbel(keys[0], (iters, p, b)))


def _run_both(name, seed=0, dtype=np.float32):
    shifts, heights, dts, ul, dist, c2b, rates = (
        None if a is None else np.asarray(a, dtype) for a in _case(name))
    keys, g = _jax_draws(seed)
    kw = dict(frame_size=FRAME, patch=PATCH, shifted_pts_thr=8, ransac_iterations=ITERS)
    jres = jb.get_rt_batch(
        jnp.asarray(shifts), jnp.asarray(heights), jnp.asarray(dts), jnp.asarray(ul),
        jnp.asarray(CAM, dtype), None if dist is None else jnp.asarray(dist), jnp.asarray(c2b),
        jnp.asarray(rates), keys, **kw)
    t = torch.from_numpy
    tres = tb.get_rt_batch(
        t(shifts), t(heights), t(dts), float(ul) if np.ndim(ul) == 0 else t(ul), t(CAM.astype(dtype)),
        None if dist is None else t(dist), t(c2b), t(rates), gumbel=t(g), **kw)
    return to_numpy(tuple(jres)), to_numpy(tuple(tres))


@pytest.mark.parametrize("name", CASES)
def test_get_rt_batch_with_jax_draws(name):
    (jok, jrot, jtran, jn, _, jrej), (tok, trot, ttran, tn, _, trej) = _run_both(name)
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(trej, jrej)
    np.testing.assert_allclose(ttran, jtran, atol=TRAN_TOL, rtol=0)
    assert_rot_close(trot, jrot, _case(name)[2])
    assert np.isnan(ttran[~tok]).all() and np.isnan(trot[~tok]).all()
    expect_ok = {"consensus": B, "outliers": B, "few_valid": 4, "dt_zero": B - 2}
    if name in expect_ok:
        assert tok.sum() == expect_ok[name], tok


@pytest.mark.parametrize("name", CASES)
def test_float64_chains_agree(name):
    """Both chains in float64 on the same draws: the float32 gaps above
    (``TRAN_TOL``, ``rot_tol``) are rounding, not a difference of method."""
    with jax.enable_x64(True):
        (jok, jrot, jtran, jn, _, jrej), (tok, trot, ttran, tn, _, trej) = _run_both(name, dtype=np.float64)
    assert ttran.dtype == jtran.dtype == np.float64
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(trej, jrej)
    np.testing.assert_allclose(ttran, jtran, atol=F64_TOL, rtol=0)
    np.testing.assert_allclose(trot, jrot, atol=F64_TOL, rtol=0)


def test_per_sample_ul_corner_is_not_sample_zeros():
    """A ``[B]`` crop offset changes each sample's principal point: the
    result differs from the one with every sample at sample 0's offset."""
    shifts, heights, dts, ul, _, c2b, rates = _case("ul_per_sample")
    _, g = _jax_draws(0)
    t = torch.from_numpy
    kw = dict(frame_size=FRAME, patch=PATCH, ransac_iterations=ITERS, gumbel=t(g))
    args = (t(shifts), t(heights), t(dts))
    per = tb.get_rt_batch(*args, t(ul), t(CAM), None, t(c2b), t(rates), **kw)
    zero = tb.get_rt_batch(*args, float(ul[0]), t(CAM), None, t(c2b), t(rates), **kw)
    np.testing.assert_allclose(to_numpy(per.tran)[0], to_numpy(zero.tran)[0], atol=1e-6)
    assert np.abs(to_numpy(per.tran)[1:] - to_numpy(zero.tran)[1:]).max() > 1e-4


@pytest.mark.parametrize("name", ["consensus", "outliers", "few_valid", "dt_zero", "distortion", "c2b_and_rates"])
def test_get_rt_batch_equals_per_pair_get_rt(name):
    """The batched chain against the port's per-pair ``get_rt`` on the same
    hypotheses (the Gumbel tensor's top 4 as ``hyp_idx``)."""
    _batched_against_per_pair(name, np.float32)


@pytest.mark.parametrize("name", ["consensus", "outliers", "distortion", "c2b_and_rates"])
def test_float64_batched_equals_per_pair(name):
    """The same in float64: only the RANSAC stages differ (the hypotheses'
    normalization and the batched refit), and they agree to 1e-9."""
    _batched_against_per_pair(name, np.float64)


def _batched_against_per_pair(name, dtype):
    shifts, heights, dts, ul, dist, c2b, rates = (
        None if a is None else np.asarray(a, dtype) for a in _case(name))
    _, g = _jax_draws(1)
    t = torch.from_numpy
    kw = dict(frame_size=FRAME, patch=PATCH, ransac_iterations=ITERS)
    cam = t(CAM.astype(dtype))
    res = tb.get_rt_batch(t(shifts), t(heights), t(dts), float(ul), cam,
                          None if dist is None else t(dist), t(c2b), t(rates), gumbel=t(g), **kw)
    top4 = tb.gumbel_top4(t(g), torch.isfinite(t(shifts)).all(-1).T)
    for i in range(B):
        one = tm.get_rt(t(shifts[i]), torch.tensor(heights[i]), torch.tensor(dts[i]), float(ul), cam,
                        None if dist is None else t(dist), t(c2b), t(rates[i]),
                        hyp_idx=top4[:, :, i], **kw)
        assert one.tran.dtype == res.tran.dtype == torch.from_numpy(shifts).dtype
        assert bool(one.ok) == bool(res.ok[i])
        assert int(one.n_inliers) == int(res.n_inliers[i])
        if dtype == np.float64:
            np.testing.assert_allclose(to_numpy(res.tran[i]), to_numpy(one.tran), atol=F64_TOL, rtol=0)
            np.testing.assert_allclose(to_numpy(res.rot[i]), to_numpy(one.rot), atol=F64_TOL, rtol=0)
        else:
            np.testing.assert_allclose(to_numpy(res.tran[i]), to_numpy(one.tran), atol=TRAN_TOL, rtol=0)
            assert_rot_close(to_numpy(res.rot[i]), to_numpy(one.rot), dts[i])


def test_gumbel_top4_order_and_ties():
    """Four rounds of argmax and mask: descending draws, ties to the lowest
    index, invalid points never drawn while 4 valid ones exist."""
    g = torch.tensor([[[0.5], [2.0], [2.0], [1.0], [3.0], [2.0]]])  # [1, 6, 1]
    valid = torch.tensor([[True], [True], [True], [True], [False], [True]])
    assert tb.gumbel_top4(g, valid)[0, :, 0].tolist() == [1, 2, 5, 3]
    gen = torch.Generator().manual_seed(0)
    draws = tb.draw_gumbel(512, 16, 4, "cpu", gen)
    valid = torch.rand(16, 4, generator=gen) > 0.3
    idx = tb.gumbel_top4(draws, valid)
    for i in range(4):
        rows = idx[:, :, i]
        assert bool(valid[rows, i].all())
        assert all(len(set(r.tolist())) == 4 for r in rows)


def test_gumbel_shape_is_checked():
    shifts, heights, dts, ul, _, c2b, rates = _case("consensus")
    t = torch.from_numpy
    with pytest.raises(ValueError, match="gumbel"):
        tb.get_rt_batch(t(shifts), t(heights), t(dts), float(ul), t(CAM), None, t(c2b), t(rates),
                        frame_size=FRAME, patch=PATCH, ransac_iterations=ITERS,
                        gumbel=torch.zeros(ITERS, 16, B + 1))


@pytest.mark.parametrize("ratio", [2, 4])
def test_get_2dt_batch_matches_jax_vmap(ratio):
    rng = np.random.default_rng(ratio)
    b, p = 6, 9
    shifts = (rng.normal(3, 2, (b, p, 2)) + rng.choice([0, 40], (b, p, 1))).astype(np.float32)
    shifts[0, :3] = np.nan
    shifts[1] = np.nan  # no valid window
    shifts[2, 1:] = np.nan  # one valid window: not enough at ratio 2
    heights = rng.uniform(0.5, 3, b).astype(np.float32)
    dts = np.full(b, 0.05, np.float32)
    dts[3] = 0.0
    rr = rng.normal(0, 0.2, b).astype(np.float32)
    pr = rng.normal(0, 0.2, b).astype(np.float32)
    cam_yaw = 0.3
    j = jax.vmap(lambda s, h, d, r, q: jm.get_2dt(
        s, h, d, jnp.float32(0.0), jnp.asarray(CAM), r, q, jnp.float32(cam_yaw), long_range_ratio=ratio,
    ))(*(jnp.asarray(a) for a in (shifts, heights, dts, rr, pr)))
    t = torch.from_numpy
    r = tm.get_2dt_batch(t(shifts), t(heights), t(dts), t(CAM), t(rr), t(pr), cam_yaw,
                         long_range_ratio=ratio)
    np.testing.assert_array_equal(to_numpy(r.ok), np.asarray(j.ok))
    assert not to_numpy(r.ok)[[1, 3]].any()
    np.testing.assert_allclose(to_numpy(r.tran), np.asarray(j.tran), atol=ATOL, rtol=0)
    np.testing.assert_allclose(to_numpy(r.tran_diff), np.asarray(j.tran_diff), atol=ATOL, rtol=0)
