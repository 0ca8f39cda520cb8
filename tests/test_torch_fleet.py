"""Parity of the port's ``FleetServer`` with the JAX package's on the CPU,
tick by tick, the JAX fleet's key sequence replayed as the port's ``draws``
hook (``torch_parity.jax_key_draws``): masked streams, ``reset``, BGR
frames, long range with tilt correction and the rate feed-forward, the
scale/rotation leg fused and unfused, checkpoints both ways, and each
checkpoint validation error.

Tolerances: ``ok`` and ``dts`` equal; shifts within 1e-3 px; ``tran``
within 1e-3 m/s and ``rot`` sample by sample within
``torch_parity.rot_tol`` (``tests/test_torch_batched_geometry.py``; the
streams turn by up to 0.8 degrees a tick, so ``rot`` is far from the
identity); long-range twists within 1e-4
m/s; scale and rotation decodes within 1e-3.  A checkpoint resumed in the
other package repeats the uninterrupted run's next tick to these bounds.
"""

import numpy as np
import pytest
from oracle import smooth_random_image
from torch_parity import assert_rot_close, jax_key_draws, rotated

from mrs_optic_flow_tpu.models import ScaleRotationConfig as JSRConfig
from mrs_optic_flow_tpu.models import ScaleRotationEstimator as JSR
from mrs_optic_flow_tpu.parallel import BatchPipeline as JaxPipeline
from mrs_optic_flow_tpu.runtime import FleetServer as JaxFleet
from mrs_optic_flow_tpu_torch.models import ScaleRotationConfig, ScaleRotationEstimator
from mrs_optic_flow_tpu_torch.parallel import BatchPipeline
from mrs_optic_flow_tpu_torch.runtime import FleetServer

K = np.array([[40.0, 0, 32.0], [0, 40.0, 32.0], [0, 0, 1.0]], np.float32)
KW = dict(frame_size=64, sample_point_size=16, camera_matrix=K,
          dist_coeffs=np.zeros(5, np.float32), ransac_iterations=32)
N, DT = 3, 0.1
SHIFT_TOL = 1e-3  # px
TRAN_TOL = 1e-3  # m/s
#: stream i's turn a tick [deg]
TURN = [0.0, 0.8, -0.6]
LR_TOL = 1e-4  # m/s
DECODE_TOL = 1e-3


def _base(seed=0, size=64):
    return (smooth_random_image(np.random.default_rng(seed), size, cutoff=0.4) * 127 + 128).astype(np.uint8)


def _frames(base, t, n=N, bgr=False):
    """Stream i's frame at tick t: the texture turned by ``t TURN[i % 3]``
    degrees and rolled (t (i % 2), t (1 + i % 3)) px."""
    f = np.stack([np.roll(rotated(base, t * TURN[i % len(TURN)]), (t * (i % 2), t * (1 + i % 3)), (0, 1))
                  for i in range(n)])
    return np.repeat(f[..., None], 3, axis=-1) if bgr else f


def _sr(res=64):
    cfg = dict(resolution=res, magnitude=15.0)
    return JSR(JSRConfig(**cfg)), ScaleRotationEstimator(ScaleRotationConfig(**cfg), device="cpu")


def _assert_tick(t, j, lr=False, sr=False):
    t, j = t.materialize(), j.materialize()
    np.testing.assert_array_equal(t.ok, j.ok)
    np.testing.assert_array_equal(t.dts, j.dts)
    np.testing.assert_allclose(t.shifts, j.shifts, atol=SHIFT_TOL, rtol=0, equal_nan=True)
    np.testing.assert_allclose(t.tran, j.tran, atol=LR_TOL if lr else TRAN_TOL, rtol=0, equal_nan=True)
    assert_rot_close(t.rot, j.rot, j.dts)
    if sr:
        np.testing.assert_allclose(t.scale, j.scale, atol=DECODE_TOL, rtol=0, equal_nan=True)
        np.testing.assert_allclose(t.rotation, j.rotation, atol=DECODE_TOL, rtol=0, equal_nan=True)
    else:
        assert t.scale is None and j.scale is None


def _pair(long_range=False, sr=None, fused=False, kw=KW, n=N, **fleet_kw):
    jsr, tsr = sr if sr else (None, None)
    jpipe = JaxPipeline(**kw, scale_rotation=jsr if fused else None)
    tpipe = BatchPipeline(**kw, scale_rotation=tsr if fused else None, device="cpu")
    jf = JaxFleet(jpipe, n, long_range=long_range, scale_rotation=jsr, **fleet_kw)
    tf = FleetServer(tpipe, n, long_range=long_range, scale_rotation=tsr, draws=jax_key_draws(0),
                     **fleet_kw)
    return jf, tf


@pytest.mark.parametrize("bgr", [False, True], ids=["gray", "bgr"])
def test_fleet_ticks_match_jax(bgr):
    """First frames gated, a masked stream whose next dt spans two ticks, a
    reset stream regated, a non-identity mount and IMU rates."""
    base = _base(1)
    c2b = np.array([0.0, 0.0, 0.38268343, 0.92387953])  # 45 deg yaw mount
    jf, tf = _pair(c2b_quat=c2b)
    rates = np.tile([0.0, 0.0, 0.0, 1.0], (N, 1)).astype(np.float32)
    rates[:, 2] = [0.002, -0.001, 0.0]
    rates /= np.linalg.norm(rates, axis=1, keepdims=True)
    heights = np.array([2.0, 1.5, 2.5])
    plan = [dict(), dict(mask=np.array([True, False, True])), dict(reset=1), dict(reset=0), dict()]
    for t, step in enumerate(plan):
        if "reset" in step:
            jf.reset(step["reset"])
            tf.reset(step["reset"])
        args = (_frames(base, t, bgr=bgr), np.full(N, t * DT), heights)
        kw = dict(rate_quats=rates, mask=step.get("mask"))
        tick_t, tick_j = tf.tick(*args, **kw), jf.tick(*args, **kw)
        _assert_tick(tick_t, tick_j)
        ok = tick_t.materialize().ok
        if t == 0 or t == 3:
            assert not ok.any() if t == 0 else not ok[0]
    assert tf.cam_yaw == pytest.approx(jf.cam_yaw)


@pytest.mark.parametrize("tilt", [False, True])
def test_fleet_long_range_matches_jax(tilt):
    """Long range: tilt-corrected heights and per-stream roll/pitch rates."""
    kw = dict(KW, frame_size=96, sample_point_size=24, crop_cx=48.0)
    base = _base(2, 96)
    jf, tf = _pair(long_range=True, kw=kw)
    heights = np.full(N, 3.0)
    rr = np.array([0.2, 0.0, -0.1], np.float32)
    pr = np.array([0.0, 0.3, 0.1], np.float32)
    extra = dict(rolls=np.full(N, 0.3), pitches=np.array([0.1, -0.2, 0.0])) if tilt else {}

    def frames(t):
        return np.stack([np.roll(base, (0, 8 * t * (i + 1)), (0, 1)) for i in range(N)])

    for t in range(3):
        args = (frames(t), np.full(N, t * DT), heights)
        kw_t = dict(roll_rates=rr, pitch_rates=pr, **extra)
        _assert_tick(tf.tick(*args, **kw_t), jf.tick(*args, **kw_t), lr=True)


def test_fleet_rate_feed_forward_matches_jax():
    """Identical frames measure zero flow, so each stream's velocity is
    get2DT's correction for its own rates."""
    base = _base(3)
    jf, tf = _pair(long_range=True)
    frames = np.stack([base] * N)
    rr = np.array([0.2, 0.0, -0.1], np.float32)
    pr = np.array([0.0, 0.3, 0.1], np.float32)
    for t in range(2):
        args = (frames, np.full(N, t * 0.05), np.full(N, 2.0))
        tt, jt = tf.tick(*args, roll_rates=rr, pitch_rates=pr), jf.tick(*args, roll_rates=rr, pitch_rates=pr)
        _assert_tick(tt, jt, lr=True)
    assert tt.materialize().ok.all() and np.std(tt.materialize().tran[:, :2]) > 1e-3


def _rotated(base, degs):
    return np.stack([rotated(base, d) for d in degs])


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_fleet_scale_rotation_matches_jax(fused):
    base = _base(4)
    sr = _sr()
    jf, tf = _pair(sr=sr, fused=fused)
    assert tf._sr_fused == jf._sr_fused == fused
    heights = np.full(N, 2.0)
    seq = [np.stack([base] * N), _rotated(base, [12.0, -8.0, 4.0]), _rotated(base, [24.0, -16.0, 8.0])]
    for t, frames in enumerate(seq):
        _assert_tick(tf.tick(frames, np.full(N, t * DT), heights),
                     jf.tick(frames, np.full(N, t * DT), heights), sr=True)


def test_fleet_fused_equals_unfused():
    base = _base(5)
    sr = _sr()[1]
    fused = FleetServer(BatchPipeline(**KW, scale_rotation=sr, device="cpu"), N, draws=jax_key_draws(0))
    plain = FleetServer(BatchPipeline(**KW, device="cpu"), N, scale_rotation=sr, draws=jax_key_draws(0))
    assert fused._sr_fused and not plain._sr_fused
    for t, frames in enumerate([np.stack([base] * N), _rotated(base, [10.0, -6.0, 3.0])]):
        a = fused.tick(frames, np.full(N, t * DT), np.full(N, 2.0)).materialize()
        b = plain.tick(frames, np.full(N, t * DT), np.full(N, 2.0)).materialize()
        for f in ("ok", "tran", "rot", "scale", "rotation"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _run_ticks(fleet, base, ticks):
    return [fleet.tick(_frames(base, t), np.full(N, t * DT), np.full(N, 2.0)) for t in ticks]


def test_checkpoint_port_to_jax(tmp_path):
    """The port's checkpoint resumes in the JAX fleet: with the port's draw
    key handed over, the JAX fleet's next tick is the port's."""
    base = _base(6)
    tpipe = BatchPipeline(**KW, device="cpu")
    draws = jax_key_draws(0)
    a = FleetServer(tpipe, N, draws=draws)
    _run_ticks(a, base, [0, 1])
    path = str(tmp_path / "port_fleet")
    a.save_state(path)
    with np.load(path + ".npz") as z:
        assert set(z.files) == {"prev", "prev_lp", "prev_stamps", "seen", "long_range", "torch_rng"}
    j = JaxFleet(JaxPipeline(**KW), N)
    j.load_state(path)
    j._key = draws.state[0]
    _assert_tick(_run_ticks(a, base, [2])[0], _run_ticks(j, base, [2])[0])


def test_checkpoint_jax_to_port(tmp_path):
    """A JAX checkpoint (with its threefry ``key``) resumes in the port; the
    key is not read, so the draws replay from it here through the hook."""
    base = _base(7)
    j = JaxFleet(JaxPipeline(**KW), N)
    _run_ticks(j, base, [0, 1])
    path = str(tmp_path / "jax_fleet.npz")
    j.save_state(path)
    with np.load(path) as z:
        key = np.array(z["key"])
    t = FleetServer(BatchPipeline(**KW, device="cpu"), N, draws=jax_key_draws(key=key))
    t.load_state(path)
    assert t._gen.initial_seed() == 0  # the threefry key left the generator alone
    _assert_tick(_run_ticks(t, base, [2])[0], _run_ticks(j, base, [2])[0])


def test_checkpoint_port_round_trip_restores_the_generator(tmp_path):
    base = _base(8)
    pipe = BatchPipeline(**KW, device="cpu")
    a = FleetServer(pipe, N, seed=5)
    _run_ticks(a, base, [0, 1])
    a.save_state(str(tmp_path / "rt"))
    cont = _run_ticks(a, base, [2])[0].materialize()
    b = FleetServer(pipe, N, seed=99)
    b.load_state(str(tmp_path / "rt"))
    resumed = _run_ticks(b, base, [2])[0].materialize()
    for f in ("ok", "tran", "rot", "shifts"):
        np.testing.assert_array_equal(getattr(resumed, f), getattr(cont, f))
    assert resumed.ok.all()


def _checkpoint(tmp_path, sr=False, n=N):
    base = _base(9)
    jsr, _ = _sr() if sr else (None, None)
    j = JaxFleet(JaxPipeline(**KW), n, scale_rotation=jsr)
    j.tick(np.stack([base] * n), np.zeros(n), np.full(n, 2.0))
    path = str(tmp_path / "ck.npz")
    j.save_state(path)
    return path


def _bad_prev(tmp_path):
    path = _checkpoint(tmp_path)
    z = dict(np.load(path))
    z["prev"] = z["prev"][:2]
    np.savez(path, **z)
    return path


#: checkpoint maker, the reading fleet's arguments, the error's message
ERRORS = {
    "range mode": (_checkpoint, dict(long_range=True), "range mode"),
    "stream count": (_checkpoint, dict(n=N + 1), "streams"),
    "frame batch": (_bad_prev, {}, "frame batch"),
    "no estimator": (lambda p: _checkpoint(p, sr=True), {}, "scale_rotation"),
    "log-polar geometry": (lambda p: _checkpoint(p, sr=True), dict(lp=32), "log-polar"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_checkpoint_validation_errors_match_jax(case, tmp_path):
    make, kw, match = ERRORS[case]
    path = make(tmp_path)
    n, lp = kw.get("n", N), kw.get("lp")
    jsr = tsr = None
    if lp:
        cfg = dict(resolution=64, lp_resolution=lp, magnitude=15.0)
        jsr, tsr = JSR(JSRConfig(**cfg)), ScaleRotationEstimator(ScaleRotationConfig(**cfg), device="cpu")
    lr = kw.get("long_range", False)
    errors = []
    for fleet in (JaxFleet(JaxPipeline(**KW), n, long_range=lr, scale_rotation=jsr),
                  FleetServer(BatchPipeline(**KW, device="cpu"), n, long_range=lr, scale_rotation=tsr)):
        with pytest.raises(ValueError, match=match) as err:
            fleet.load_state(path)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_fleet_rejects_wrong_stream_count_and_resolution():
    tf = FleetServer(BatchPipeline(**KW, device="cpu"), N)
    with pytest.raises(ValueError, match="streams"):
        tf.tick(np.zeros((N + 1, 64, 64), np.uint8), np.zeros(N + 1), np.ones(N + 1))
    bad = ScaleRotationEstimator(ScaleRotationConfig(resolution=48), device="cpu")
    with pytest.raises(ValueError, match="resolution"):
        FleetServer(BatchPipeline(**KW, device="cpu"), N, scale_rotation=bad)
    first = tf.tick(_frames(_base(0), 0), np.zeros(N), np.ones(N)).materialize()
    assert not first.ok.any() and np.isnan(first.tran).all()
    np.testing.assert_array_equal(first.rot, np.tile([0, 0, 0, 1], (N, 1)))
    assert first.shifts.shape == (N, 16, 2)
