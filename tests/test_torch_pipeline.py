"""Parity of the port's ``BatchPipeline`` with the JAX package's on the CPU,
every step entry point (``step``, ``step_pre``, ``step_pre_carried``,
``step_long_range``, ``step_long_range_pre``), with the JAX function's own
RANSAC draws injected (``jax.random.gumbel(keys[0], (I, P, B))``).

Tolerances: ``ok`` equal; shifts within 1e-3 px (the engine tests'
``SHIFT_TOL``); ``tran`` within 1e-3 m/s and ``rot`` sample by sample
within ``torch_parity.rot_tol`` (``tests/test_torch_batched_geometry.py``
gives the float32 reasons and the float64 run behind them); the pairs turn
by up to 1.5 degrees, so ``rot`` is far from the identity; the
long-range twists (no decomposition) within 1e-4 m/s; scale and rotation
decodes within 1e-3 (``tests/test_torch_scale_rotation.py``), the uint8
log-polar carries within 1 gray level (a float32 resample a rounding step
away);
``fleet_mean_speed`` within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import smooth_random_image
from torch_parity import assert_rot_close, rotated, to_numpy

from mrs_optic_flow_tpu.models import ScaleRotationConfig as JSRConfig
from mrs_optic_flow_tpu.models import ScaleRotationEstimator as JSR
from mrs_optic_flow_tpu.parallel import BatchPipeline as JaxPipeline
from mrs_optic_flow_tpu_torch.models import ScaleRotationConfig, ScaleRotationEstimator
from mrs_optic_flow_tpu_torch.parallel import BatchPipeline

K = np.array([[40.0, 0, 32.0], [0, 40.0, 32.0], [0, 0, 1.0]], np.float32)
KW = dict(frame_size=64, sample_point_size=16, camera_matrix=K,
          dist_coeffs=np.zeros(5, np.float32), ransac_iterations=32)
B, DT = 4, 0.05
SHIFT_TOL = 1e-3  # px
TRAN_TOL = 1e-3  # m/s
#: pair i's turn between its frames [deg]
TURN = [0.0, 1.0, -1.5, 0.6]
LR_TOL = 1e-4  # m/s
DECODE_TOL = 1e-3


def _pairs(seed, size=64, dtype=np.uint8, bgr=False):
    """B frame pairs, pair i turned by ``TURN[i]`` and shifted by its own
    (dy, dx)."""
    rng = np.random.default_rng(seed)
    prev = (np.stack([smooth_random_image(rng, size, cutoff=0.4) for _ in range(B)]) * 127 + 128)
    prev = prev.astype(np.uint8).astype(dtype)
    curr = np.stack([np.roll(rotated(prev[i], TURN[i]), ((i % 3) - 1, 2 - i), axis=(0, 1))
                     for i in range(B)])
    if bgr:
        prev, curr = (np.repeat(x[..., None], 3, axis=-1) for x in (prev, curr))
    return prev, curr


def _ctx(seed):
    rng = np.random.default_rng(100 + seed)
    heights = rng.uniform(1.5, 2.5, B).astype(np.float32)
    dts = np.full(B, DT, np.float32)
    rates = np.tile(np.array([0, 0, 0, 1], np.float32), (B, 1))
    rates[:, :3] = rng.normal(0, 0.005, (B, 3))
    rates /= np.linalg.norm(rates, axis=1, keepdims=True)
    c2b = np.array([0.01, -0.02, 0.0, 1.0], np.float32)
    return heights, dts, rates, c2b / np.linalg.norm(c2b)


def _draws(seed, p=16):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return keys, torch.from_numpy(np.array(jax.random.gumbel(keys[0], (32, p, B))))


def _sr_pair():
    cfg = dict(resolution=64, magnitude=15.0)
    return JSR(JSRConfig(**cfg)), ScaleRotationEstimator(ScaleRotationConfig(**cfg), device="cpu")


def _assert_outputs(j, t, sr=False):
    np.testing.assert_array_equal(to_numpy(t.ok), np.asarray(j.ok))
    np.testing.assert_allclose(to_numpy(t.shifts), np.asarray(j.shifts), atol=SHIFT_TOL, rtol=0,
                               equal_nan=True)
    np.testing.assert_allclose(to_numpy(t.tran), np.asarray(j.tran), atol=TRAN_TOL, rtol=0,
                               equal_nan=True)
    assert_rot_close(to_numpy(t.rot), np.asarray(j.rot), DT)
    np.testing.assert_allclose(float(t.fleet_mean_speed), float(j.fleet_mean_speed), rtol=1e-5)
    for name in ("scale", "rotation"):
        a, b = to_numpy(getattr(t, name)), np.asarray(getattr(j, name))
        if sr:
            np.testing.assert_allclose(a, b, atol=DECODE_TOL, rtol=0)
        else:
            assert np.isnan(a).all() and np.isnan(b).all()


@pytest.mark.parametrize("entry,dtype,bgr,sr", [
    ("step", np.uint8, False, False),
    ("step", np.float32, False, False),
    ("step", np.uint8, True, False),
    ("step_pre", np.uint8, False, False),
    ("step_pre", np.float32, False, False),
    ("step", np.uint8, False, True),
    ("step_pre", np.uint8, False, True),
])
def test_step_matches_jax(entry, dtype, bgr, sr):
    seed = 3 if sr else int(np.dtype(dtype).itemsize) + 2 * bgr
    prev, curr = _pairs(seed, dtype=dtype, bgr=bgr)
    heights, dts, rates, c2b = _ctx(seed)
    jsr, tsr = _sr_pair() if sr else (None, None)
    jp = JaxPipeline(**KW, scale_rotation=jsr)
    tp = BatchPipeline(**KW, scale_rotation=tsr, device="cpu")
    keys, g = _draws(seed)
    ctx = (heights, dts, rates, c2b)
    j = getattr(jp, entry)(jnp.asarray(prev), jnp.asarray(curr), *(jnp.asarray(a) for a in ctx), keys)
    t = getattr(tp, entry)(torch.from_numpy(prev), torch.from_numpy(curr), *ctx, gumbel=g)
    _assert_outputs(j, t, sr=sr)
    assert to_numpy(t.ok).sum() >= B - 1


def test_step_pre_carried_matches_jax():
    """The scale/rotation leg on carried log-polar images, and the carry it
    returns."""
    prev, curr = _pairs(5)
    heights, dts, rates, c2b = _ctx(5)
    jsr, tsr = _sr_pair()
    jp = JaxPipeline(**KW, scale_rotation=jsr)
    tp = BatchPipeline(**KW, scale_rotation=tsr, device="cpu")
    jlp = jp.logpolar_carry(jnp.asarray(prev))
    tlp = tp.logpolar_carry(torch.from_numpy(prev))
    np.testing.assert_allclose(to_numpy(tlp), np.asarray(jlp), atol=1, rtol=0)
    keys, g = _draws(5)
    ctx = (heights, dts, rates, c2b)
    j, jlp_c = jp.step_pre_carried(jnp.asarray(prev), jnp.asarray(curr), jlp,
                                   *(jnp.asarray(a) for a in ctx), keys)
    t, tlp_c = tp.step_pre_carried(torch.from_numpy(prev), torch.from_numpy(curr), tlp, *ctx, gumbel=g)
    _assert_outputs(j, t, sr=True)
    np.testing.assert_allclose(to_numpy(tlp_c), np.asarray(jlp_c), atol=1, rtol=0)


@pytest.mark.parametrize("entry,cam_yaw", [("step_long_range", np.pi / 2),
                                           ("step_long_range_pre", 0.3)])
def test_long_range_matches_jax(entry, cam_yaw):
    """4x-downsampled flow and get2DT pair by pair, tilt-corrected heights
    and per-pair roll/pitch rates."""
    kw = dict(KW, frame_size=96, sample_point_size=24, crop_cx=48.0)
    prev, curr = _pairs(7, size=96)
    rng = np.random.default_rng(7)
    heights = (3.0 / (np.cos(0.1) * np.cos(-0.2)) * np.ones(B)).astype(np.float32)
    dts = np.full(B, 0.1, np.float32)
    rr, pr = (rng.normal(0, 0.2, B).astype(np.float32) for _ in range(2))
    j = getattr(JaxPipeline(**kw), entry)(
        jnp.asarray(prev), jnp.asarray(curr), *(jnp.asarray(a) for a in (heights, dts, rr, pr)),
        jnp.float32(cam_yaw))
    t = getattr(BatchPipeline(**kw, device="cpu"), entry)(
        torch.from_numpy(prev), torch.from_numpy(curr), heights, dts, rr, pr, cam_yaw)
    np.testing.assert_array_equal(to_numpy(t.ok), np.asarray(j.ok))
    assert to_numpy(t.ok).all()
    np.testing.assert_allclose(to_numpy(t.shifts), np.asarray(j.shifts), atol=SHIFT_TOL, rtol=0)
    np.testing.assert_allclose(to_numpy(t.tran), np.asarray(j.tran), atol=LR_TOL, rtol=0)
    np.testing.assert_allclose(to_numpy(t.tran_diff), np.asarray(j.tran_diff), atol=LR_TOL, rtol=0)
    np.testing.assert_allclose(float(t.fleet_mean_speed), float(j.fleet_mean_speed), rtol=1e-5)


def test_fleet_mean_speed_ignores_a_dead_pair():
    """A NaN frame pair's NaN raw shifts drop out of the fleet statistic
    (nanmean), as in the JAX pipeline."""
    prev, curr = _pairs(9, dtype=np.float32)
    prev[1, 5, 5] = np.nan
    heights, dts, rates, c2b = _ctx(9)
    keys, g = _draws(9)
    ctx = (heights, dts, rates, c2b)
    j = JaxPipeline(**KW).step(jnp.asarray(prev), jnp.asarray(curr), *(jnp.asarray(a) for a in ctx), keys)
    t = BatchPipeline(**KW, device="cpu").step(torch.from_numpy(prev), torch.from_numpy(curr), *ctx,
                                                gumbel=g)
    assert np.isfinite(float(t.fleet_mean_speed))
    _assert_outputs(j, t)


@pytest.mark.parametrize("frame,patch", [(64, 24), (65, 16), (96, 32)])
def test_engine_normalized_geometry(frame, patch):
    """The pipeline's patch grid is the engine's: an odd frame becomes even
    and a patch that does not divide it becomes the whole frame."""
    kw = dict(KW, frame_size=frame, sample_point_size=patch, crop_cx=frame / 2)
    j, t = JaxPipeline(**kw), BatchPipeline(**kw, device="cpu")
    assert (t.frame_size, t.sample_point_size, t.ul_x) == (j.frame_size, j.sample_point_size, j.ul_x)
    assert t.engine.num_windows == j.engine.num_windows


def test_scale_rotation_resolution_is_checked():
    bad = ScaleRotationEstimator(ScaleRotationConfig(resolution=48), device="cpu")
    with pytest.raises(ValueError, match="resolution"):
        BatchPipeline(**KW, scale_rotation=bad, device="cpu")
    with pytest.raises(ValueError, match="scale_rotation"):
        BatchPipeline(**KW, device="cpu").logpolar_carry(torch.zeros(1, 64, 64))
