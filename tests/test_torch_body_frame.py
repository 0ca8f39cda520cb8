"""The method-4 node's body frame on the CPU: ``geometry/motion.py::
rt_body_frame``, the plain version of kernel G's epilogue.

(a) ``rt_body_frame`` against the JAX node's lines
    (``mrs_optic_flow_tpu/runtime/node.py:408-417``, under ``jax.jit`` as
    the node runs them) on seeded NumPy getRT results, float32, within
    1e-6: rates of 0.5-1 rad/s about random axes with velocities within 1
    m/s, through a 90 deg camera mount and a tilt of (0.1, -0.08) rad;
    near-identity rates below ``quat_axis_angle``'s ``safe`` threshold
    (tf2's axis (1, 0, 0)); pitch rates at +-pi/2, the gimbal of
    ``rpy_from_matrix``; results that are not ok (NaN).  Slower rates
    differ by more (``test_slow_rates_follow_acos_conditioning``).
(b) the wrapper's CPU route with ``detilt``: ``get_rt_ref``'s (or
    ``get_rt_batch_ref``'s) result, then ``rt_body_frame``'s head, a new
    ``[B, 9]`` float32 tensor; ``get_rt_body_frame`` likewise.
(c) the node's CPU summary bit for bit the chain before the body frame
    became G's epilogue (``get_rt``, then the body frame as torch steps),
    frame by frame, in every method-4 mode of
    ``tests/test_torch_frame_graph.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_frame_graph import MODES, _events, _mode

from mrs_optic_flow_tpu.geometry import rotations as jr
from mrs_optic_flow_tpu_torch.geometry import batched as tb
from mrs_optic_flow_tpu_torch.geometry import motion as tm
from mrs_optic_flow_tpu_torch.geometry.rotations import (
    matrix_from_quat,
    quat_axis_angle,
    quat_from_axis_angle,
    quat_rotate,
    rpy_from_matrix,
)
from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck
from mrs_optic_flow_tpu_torch.runtime import node as node_module
from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode

F32 = np.float32
TOL = 1e-6
#: a 90 deg camera mount (camera z to body -z, x to -y) and a tilt of
#: roll 0.1, pitch -0.08 rad (``np_quat_from_rpy``)
C2B = np.array([0.70710677, -0.70710677, 0.0, 0.0], F32)
DETILT = np.array([0.04993919, -0.03993936, 0.00199863, 0.9979514], F32)
IDENTITY = np.array([0.0, 0.0, 0.0, 1.0], F32)


@jax.jit
def jax_head(ok, rot, tran, n_inliers, rejected, c2b, detilt):
    """The JAX node's body frame and summary head (``runtime/node.py:408-417``)."""
    tran_b = jr.quat_rotate(detilt, jr.quat_rotate(c2b, tran))
    axis, angle = jr.quat_axis_angle(rot)
    rot_b = jr.quat_from_axis_angle(jr.quat_rotate(c2b, axis), angle)
    ang = jnp.stack(jr.rpy_from_matrix(jr.matrix_from_quat(rot_b)))
    return jnp.concatenate([ok.astype(jnp.float32)[None], tran_b, ang,
                            n_inliers.astype(jnp.float32)[None], rejected.astype(jnp.float32)[None]])


def port_head(ok, rot, tran, n_inliers, rejected, c2b, detilt):
    t = torch.from_numpy
    res = tm.GetRTResult(torch.tensor(ok), t(rot), t(tran), torch.tensor(n_inliers, dtype=torch.int64),
                         torch.tensor(0.0), torch.tensor(rejected))
    return tm.rt_body_frame(res, t(c2b), t(detilt)).numpy()


def both(*args):
    return np.asarray(jax_head(*(jnp.asarray(a) for a in args))), port_head(*args)


def rate_quat(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    return np.append(axis * np.sin(angle / 2), np.cos(angle / 2)).astype(F32)


def is_gimbal(head):
    return head[4] == 0 and head[6] == 0 and abs(head[5]) == F32(np.pi / 2)


# --------------------------------------------------------------------- (a) --


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rates_and_velocities_against_jax(seed):
    """Rates of 0.5-1 rad/s about random axes and velocities within 1 m/s,
    through the mount and the tilt (and each alone): the JAX node's head
    within 1e-6, ``ok``, ``n_inliers`` and the flag exactly."""
    rng = np.random.default_rng(seed)
    for i in range(60):
        rot = rate_quat(rng.normal(size=3), rng.uniform(0.5, 1.0))
        tran = rng.uniform(-1.0, 1.0, 3).astype(F32)
        c2b, detilt = [(C2B, DETILT), (C2B, IDENTITY), (IDENTITY, DETILT)][i % 3]
        j, p = both(True, rot, tran, int(rng.integers(8, 17)), bool(i % 2), c2b, detilt)
        np.testing.assert_allclose(p, j, rtol=0, atol=TOL)
        np.testing.assert_array_equal(p[[0, 7, 8]], j[[0, 7, 8]])
    assert np.abs(p[1:4] - quat_rotate(torch.from_numpy(C2B), torch.from_numpy(tran)).numpy()).max() > 1e-3


@pytest.mark.parametrize("half_axis", [2.0 ** -11, 2.0 ** -12, 3e-4])
def test_near_identity_rates_take_tf2_axis(half_axis):
    """A rate whose quaternion has ``1 - w^2`` below 10 float32 epsilons:
    both take tf2's axis (1, 0, 0) whatever the quaternion's own axis, and
    agree within 1e-6 (at 2^-11 exactly: its norm is exact in any
    order)."""
    heads = []
    for axis in ([1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.6, 0.0, 0.8]):
        rot = np.append(half_axis * np.array(axis), 1.0).astype(F32)
        j, p = both(True, rot, np.array([0.3, -0.2, 0.05], F32), 15, False, C2B, DETILT)
        np.testing.assert_allclose(p, j, rtol=0, atol=TOL)
        heads.append(p)
    qn = heads[0]
    assert all(np.array_equal(h, qn) for h in heads)  # the axis is (1, 0, 0) every time
    axis, _ = quat_axis_angle(torch.from_numpy(np.append(half_axis * np.array([0.0, 1.0, 0.0]), 1.0).astype(F32)))
    assert axis.tolist() == [1.0, 0.0, 0.0]


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_gimbal_pitch_rates(sign):
    """Pitch rates within a few ulps of +-pi/2 rad/s: float32 rounding takes
    some to ``rpy_from_matrix``'s gimbal branch (roll and yaw 0, pitch
    +-pi/2) and some just below it, where roll and yaw are ill-conditioned.
    Where both packages take the branch, they agree within 1e-6; both take
    it at several rates."""
    hits = 0
    for k in range(-20, 21):
        angle = F32(np.pi / 2) + F32(k) * F32(2.0 ** -22)
        rot = np.array([0.0, sign * np.sin(angle / 2), 0.0, np.cos(angle / 2)], F32)
        j, p = both(True, rot, np.array([0.3, -0.2, 0.05], F32), 15, False, IDENTITY, IDENTITY)
        if is_gimbal(j) and is_gimbal(p):
            hits += 1
            np.testing.assert_allclose(p, j, rtol=0, atol=TOL)
            assert p[5] == F32(sign * np.pi / 2)
    assert hits >= 4


def test_not_ok_results_are_nan():
    """A result that is not ok (NaN rate and velocity): NaN velocity and
    angles, the flags and count as given, in both."""
    nan = np.full(4, np.nan, F32)
    j, p = both(False, nan, nan[:3], 3, False, C2B, DETILT)
    np.testing.assert_array_equal(p, j)
    assert p[0] == 0 and p[7] == 3 and np.isnan(p[1:7]).all()


def test_slow_rates_follow_acos_conditioning():
    """Rates of 0.01-0.5 rad/s: tf2's angle ``2 acos(w)`` turns one ulp of
    the normalised w (the packages sum its norm in other orders) into up to
    ``2 ulp(1) / sin(angle / 2)`` rad/s; the two heads stay within that."""
    rng = np.random.default_rng(7)
    for _ in range(200):
        angle = rng.uniform(0.01, 0.5)
        rot = rate_quat(rng.normal(size=3), angle)
        j, p = both(True, rot, rng.uniform(-1.0, 1.0, 3).astype(F32), 15, False, C2B, DETILT)
        bound = 2 * 2 * np.finfo(F32).eps / np.sin(angle / 2) + TOL
        assert np.abs(p[4:7] - j[4:7]).max() <= bound
        np.testing.assert_allclose(p[1:4], j[1:4], rtol=0, atol=TOL)


def test_batched_heads_equal_one_at_a_time():
    """``rt_body_frame`` on ``[B]`` results equals it on each pair alone."""
    rng = np.random.default_rng(3)
    b = 6
    rot = np.stack([rate_quat(rng.normal(size=3), rng.uniform(0.1, 1.0)) for _ in range(b)])
    tran = rng.uniform(-1, 1, (b, 3)).astype(F32)
    t = torch.from_numpy
    res = tm.GetRTResult(torch.tensor([True] * b), t(rot), t(tran), torch.arange(b), torch.zeros(b),
                         torch.tensor([False, True] * 3))
    heads = tm.rt_body_frame(res, t(C2B), t(DETILT))
    assert heads.shape == (b, 9) and heads.dtype == torch.float32
    for i in range(b):
        one = tm.GetRTResult(*(x[i] for x in res))
        assert torch.equal(tm.rt_body_frame(one, t(C2B), t(DETILT)), heads[i])


# --------------------------------------------------------------------- (b) --

FRAME = 480
CAM = np.array([[420.0, 0, 376.0], [0, 420.0, 240.0], [0, 0, 1]], np.float32)


def _pairs(seed, b):
    """``b`` pairs of 16 window shifts of a camera translating over flat
    ground, with one NaN window each."""
    rng = np.random.default_rng(seed)
    c = np.arange(4) * 120 + 60
    gx, gy = np.meshgrid(c + 136.0, c)
    x, y = (gx.reshape(-1) - 376.0) / 420.0, (gy.reshape(-1) - 240.0) / 420.0
    out = np.empty((b, 16, 2))
    for i in range(b):
        t = np.r_[rng.uniform(-0.02, 0.02, 2), rng.uniform(-0.004, 0.004)]
        w = (np.eye(3) + np.outer(t, [0, 0, 1.0])) @ np.stack([x, y, np.ones(16)])
        out[i, :, 0] = (w[0] / w[2] - x) * 420.0
        out[i, :, 1] = (w[1] / w[2] - y) * 420.0
        out[i, rng.integers(16)] = np.nan
    out += rng.normal(0, 0.02, out.shape)
    t = torch.from_numpy
    return (t(out.astype(F32)), t(rng.uniform(1.0, 2.5, b).astype(F32)), t(np.full(b, 0.05, F32)), 136.0,
            t(CAM), None, t(C2B), t(np.tile(IDENTITY, (b, 1))))


def test_wrapper_cpu_route_with_the_epilogue():
    """``cuda_kernels.get_rt`` with ``detilt`` on CPU tensors: the plain
    getRT's fields, then ``rt_body_frame``'s head as ``summary``, per pair
    and batched, each head a new ``[B, 9]`` float32 tensor; no launch."""
    args = _pairs(4, 5)
    kw = dict(frame_size=FRAME, patch=120, shifted_pts_thr=8)
    detilt = torch.from_numpy(DETILT)
    before = ck.get_rt.LAUNCHES
    g = tb.draw_gumbel(48, 16, 5, "cpu", torch.Generator().manual_seed(1))
    ref = tb.get_rt_batch_ref(*args, gumbel=g, ransac_iterations=48, **kw)
    out = ck.get_rt(*args, gumbel=g, detilt=detilt, **kw)
    for x, y in zip(out[:6], ref):
        assert torch.equal(torch.nan_to_num(x, nan=7.0), torch.nan_to_num(y, nan=7.0))
    assert torch.equal(out.summary, tm.rt_body_frame(ref, args[6], detilt))
    assert out.summary[:, 0].sum() >= 4
    top4 = tb.gumbel_top4(g, torch.isfinite(args[0]).all(-1).T)
    for i in range(5):
        one = (args[0][i], args[1][i], args[2][i], 136.0, args[4], None, args[6], args[7][i])
        ref1 = tm.get_rt_ref(*one, hyp_idx=top4[:, :, i], **kw)
        got = ck.get_rt(one[0][None], one[1].reshape(1), one[2].reshape(1), 136.0, args[4], None, args[6],
                        one[7][None], hyp_idx=top4[:, :, i], detilt=detilt, **kw)
        assert got.summary.shape == (1, 9) and got.summary.dtype == torch.float32
        head = tm.rt_body_frame(ref1, args[6], detilt)
        assert torch.equal(torch.nan_to_num(got.summary[0], nan=7.0), torch.nan_to_num(head, nan=7.0))
        body = tm.get_rt_body_frame(*one, detilt, hyp_idx=top4[:, :, i], **kw)
        assert torch.equal(torch.nan_to_num(body, nan=7.0), torch.nan_to_num(head, nan=7.0))
    assert ck.get_rt.LAUNCHES == before
    assert ck.get_rt(*args, gumbel=g, **kw).summary is None


def test_get_rt_body_frame_draws_as_get_rt():
    """Without given hypotheses ``get_rt_body_frame`` draws from the
    generator exactly as ``get_rt`` does."""
    args = _pairs(5, 2)
    one = (args[0][1], args[1][1], args[2][1], 136.0, args[4], None, args[6], args[7][1])
    kw = dict(frame_size=FRAME, patch=120, ransac_iterations=64)
    gen_a, gen_b = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    head = tm.get_rt_body_frame(*one, torch.from_numpy(DETILT), generator=gen_a, **kw)
    res = tm.get_rt(*one, generator=gen_b, **kw)
    assert torch.equal(head, tm.rt_body_frame(res, args[6], torch.from_numpy(DETILT)))
    assert torch.equal(gen_a.get_state(), gen_b.get_state())


# --------------------------------------------------------------------- (c) --


def _legacy_frame_step(node, gray, params, cx_eff):
    """The method-4 chain before its body frame became kernel G's
    epilogue: ``get_rt``, then the body frame as torch steps."""
    c = node.config
    height, dt = params[node_module.P_HEIGHT], params[node_module.P_DT]
    cam = params[node_module.P_CAM].reshape(3, 3)
    dist, c2b = params[node_module.P_DIST], params[node_module.P_C2B]
    rate_quat, detilt = params[node_module.P_RATE_QUAT], params[node_module.P_DETILT]
    flow_state, flow = node.engine.step(node.flow_state, gray)
    res = tm.get_rt(flow.shifts, height, dt, float(cx_eff - c.frame_size // 2), cam, dist, c2b, rate_quat,
                    frame_size=c.frame_size, patch=c.sample_point_size, generator=node._gen,
                    shifted_pts_thr=c.shifted_pts_thr)
    tran_b = quat_rotate(detilt, quat_rotate(c2b, res.tran))
    axis, angle = quat_axis_angle(res.rot)
    rot_b = quat_from_axis_angle(quat_rotate(c2b, axis), angle)
    ang = torch.stack(rpy_from_matrix(matrix_from_quat(rot_b)))
    sr_state, sr_parts = node._sr_step(gray)
    parts = [res.ok.to(torch.float32)[None], tran_b, ang, res.n_inliers.to(torch.float32)[None],
             res.ang_diff_rejected.to(torch.float32)[None], *sr_parts]
    if c.raw_output:
        parts.append(flow.shifts_raw.reshape(-1))
    return flow_state, sr_state, torch.cat(parts), flow


#: the modes of tests/test_torch_frame_graph.py whose frames run _frame_step
METHOD4_MODES = [m for m, (o, _) in MODES.items()
                 if o["mrs_optic_flow"].get("method", 4) == 4
                 and o["mrs_optic_flow"].get("long_range_mode", "always_off") != "always_on"]


@pytest.mark.parametrize("mode", METHOD4_MODES)
def test_node_summary_is_the_legacy_chains(mode):
    """Every method-4 frame's summary, frame by frame, bit for bit the
    legacy chain's on the same state and generator, and the generator left
    where the legacy chain leaves it."""
    config, stream = _mode(mode)
    node = OpticFlowNode(config, device="cpu", publish=lambda t, m: None, log=lambda s: None)
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    step = node._frame_step
    frames = []

    def checked(gray, params, cx_eff):
        state = node._gen.get_state()
        legacy = _legacy_frame_step(node, gray, params, cx_eff)
        after = node._gen.get_state()
        node._gen.set_state(state)
        out = step(gray, params, cx_eff)
        assert torch.equal(node._gen.get_state(), after)
        assert out[2].shape == legacy[2].shape
        assert torch.equal(torch.nan_to_num(out[2], nan=7.0), torch.nan_to_num(legacy[2], nan=7.0))
        frames.append(bool(out[2][0]))
        return out

    node._frame_step = checked
    for handler, msg in _events(**stream):
        getattr(node, handler)(msg)
    assert len(frames) >= 10 and sum(frames) >= len(frames) // 2
