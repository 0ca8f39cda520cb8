"""The port's log-polar resample and scale/rotation estimator against the JAX
package on the CPU (kernel B runs as its plain twin here).

Tolerances:

- log-polar float output: 5e-3 gray levels.  The JAX package resamples with
  bf16 hi/lo weight and image splits on the matrix unit (plan path) or with
  float32 coordinates (per-frame path); the two JAX paths differ from each
  other by up to 3e-3, the port (float64 tap table, float32 sums) from
  either by as much;
- after uint8 rounding a pixel whose float value lies within that much of
  x.5 may round the other way: at most 1 LSB, on at most 0.5% of the pixels;
- decoded scale 1e-3 and rotation 1e-3 rad: the correlated log-polar
  images differ in those few pixels by 1 LSB;
- against ``cv2.warpPolar`` the JAX package's own bounds
  (``tests/test_logpolar.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import smooth_random_image
from torch_parity import to_numpy

from mrs_optic_flow_tpu.models import ScaleRotationConfig as JaxConfig
from mrs_optic_flow_tpu.models import ScaleRotationEstimator as JaxEstimator
from mrs_optic_flow_tpu.ops import logpolar as jlp
from mrs_optic_flow_tpu_torch.models import ScaleRotationConfig, ScaleRotationEstimator
from mrs_optic_flow_tpu_torch.ops import logpolar as tlp

LP_TOL = 5e-3
LSB_SHARE = 0.005
DECODE_TOL = 1e-3


def _texture(n, seed=0):
    return smooth_random_image(np.random.default_rng(seed), n).astype(np.float32)


def _warp(img, deg, zoom):
    cv2 = pytest.importorskip("cv2")
    n = img.shape[0]
    m = cv2.getRotationMatrix2D((n / 2, n / 2), deg, zoom)
    return cv2.warpAffine(img, m, (n, n))


@pytest.mark.parametrize("interp", ["lanczos4", "bilinear"])
@pytest.mark.parametrize("n,res", [(64, None), (128, None), (128, 32), (64, 32)])
def test_logpolar_matches_both_jax_paths(n, res, interp):
    m = 20.0 if n == 128 else 12.0
    img = _texture(n, seed=n)
    img_u8 = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    plan, weights = jlp.build_lp_plan(n, m, resolution=res or n, interp=interp)
    weights = tuple(jnp.asarray(w) for w in weights)
    for x in (img, img_u8):
        ours = to_numpy(tlp.logpolar(torch.from_numpy(x), m, resolution=res, interp=interp))
        per_frame = np.asarray(jlp.logpolar(jnp.asarray(x), m, resolution=res, interp=interp))
        planned = np.asarray(jlp.logpolar(jnp.asarray(x), m, resolution=res, interp=interp,
                                          plan=plan, weights=weights))
        assert ours.shape == per_frame.shape == (res or n, res or n) and ours.dtype == np.float32
        np.testing.assert_allclose(ours, per_frame, atol=LP_TOL, rtol=0)
        np.testing.assert_allclose(ours, planned, atol=LP_TOL, rtol=0)
        rounded = [np.clip(np.rint(v), 0, 255) for v in (ours, planned)]
        diff = np.abs(rounded[0] - rounded[1])
        assert diff.max() <= 1 and (diff > 0).mean() <= LSB_SHARE


@pytest.mark.parametrize("interp,mean_tol,max_tol", [("bilinear", 0.01, 0.01), ("lanczos4", 1.0, 5.0)])
def test_logpolar_matches_opencv(interp, mean_tol, max_tol):
    cv2 = pytest.importorskip("cv2")
    n, m = 128, 20.0
    img = _texture(n, seed=1)
    ours = to_numpy(tlp.logpolar(torch.from_numpy(img), m, interp=interp))
    flag = cv2.INTER_LINEAR if interp == "bilinear" else cv2.INTER_LANCZOS4
    ref = cv2.warpPolar(img, (n, n), (n / 2, n / 2), float(np.exp(n / m)), flag + cv2.WARP_POLAR_LOG)
    sl = np.s_[:, 4:int(m * np.log(n / 2 - 6))]  # inside the disc, off the centre
    err = np.abs(ours[sl] - ref[sl])
    assert err.mean() < mean_tol and err.max() < max_tol


def test_tap_table_trim_matches_jax():
    for n, res, m in [(480, 480, 49.9), (128, 128, 20.0), (128, 32, 5.0)]:
        for interp, offsets in [("lanczos4", jlp._LANCZOS4_OFFSETS), ("bilinear", np.arange(2))]:
            assert tlp.static_trim(n, res, m, offsets) == jlp._static_trim(n, res, m, offsets)
    idx, w = tlp.tap_table(64, 64, 12.0, "lanczos4")
    assert idx.shape == w.shape == (64, 64, 64) and w.dtype == np.float32
    assert idx.min() >= 0 and idx.max() < 64 * 64


@pytest.mark.parametrize("quantize_8bit", [True, False])
def test_step_stream_matches_jax(quantize_8bit):
    n = 64
    f0 = _texture(n, seed=3)
    frames = [f0, _warp(f0, 6.0, 1.0), _warp(f0, 6.0, 1.05), _warp(f0, 2.0, 1.05)]
    kw = dict(resolution=n, magnitude=12.0, quantize_8bit=quantize_8bit)
    jest = JaxEstimator(JaxConfig(**kw))
    test = ScaleRotationEstimator(ScaleRotationConfig(**kw), device="cpu")
    jst, tst = jest.init_state(), test.init_state()
    assert tst.first and tst.prev_logpolar.dtype == (torch.uint8 if quantize_8bit else torch.float32)
    for i, f in enumerate(frames):
        jst, jres = jest.step(jst, jnp.asarray(f))
        tst, tres = test.step(tst, torch.from_numpy(f))
        if i == 0:  # the first frame: no estimate
            assert float(tres.scale) == 1.0 and float(tres.rotation) == 0.0
        assert abs(float(tres.scale) - float(jres.scale)) <= DECODE_TOL
        assert abs(float(tres.rotation) - float(jres.rotation)) <= DECODE_TOL
        ours, theirs = to_numpy(tst.prev_logpolar), np.asarray(jst.prev_logpolar)
        assert ours.dtype == theirs.dtype and tst.first is False
        diff = np.abs(ours.astype(np.float64) - theirs)
        if quantize_8bit:
            assert diff.max() <= 1 and (diff > 0).mean() <= LSB_SHARE
        else:
            assert diff.max() <= LP_TOL


def test_batch_modes_match_jax():
    n = 64
    f0 = _texture(n, seed=4)
    prev = np.stack([f0, f0, _warp(f0, 4.0, 1.0)])
    curr = np.stack([_warp(f0, 4.0, 1.0), _warp(f0, 0.0, 1.06), _warp(f0, 8.0, 1.03)])
    kw = dict(resolution=n, magnitude=12.0)
    jest = JaxEstimator(JaxConfig(**kw))
    test = ScaleRotationEstimator(ScaleRotationConfig(**kw), device="cpu")
    jres = jest.step_batch(jnp.asarray(prev), jnp.asarray(curr))
    tres = test.step_batch(torch.from_numpy(prev), torch.from_numpy(curr))
    np.testing.assert_allclose(to_numpy(tres.scale), np.asarray(jres.scale), atol=DECODE_TOL)
    np.testing.assert_allclose(to_numpy(tres.rotation), np.asarray(jres.rotation), atol=DECODE_TOL)

    jlp_prev = jest.logpolar_batch(jnp.asarray(prev))
    tlp_prev = test.logpolar_batch(torch.from_numpy(prev))
    assert tlp_prev.dtype == torch.uint8 and tuple(tlp_prev.shape) == (3, n, n)
    jlp_c, jcar = jest.step_batch_carried(jlp_prev, jnp.asarray(curr))
    tlp_c, tcar = test.step_batch_carried(tlp_prev, torch.from_numpy(curr))
    np.testing.assert_allclose(to_numpy(tcar.rotation), np.asarray(jcar.rotation), atol=DECODE_TOL)
    np.testing.assert_allclose(to_numpy(tcar.scale), to_numpy(tres.scale), atol=1e-6)
    diff = np.abs(to_numpy(tlp_c).astype(np.int16) - np.asarray(jlp_c))
    assert diff.max() <= 1 and (diff > 0).mean() <= LSB_SHARE


def test_lp_resolution_rescales_the_decode():
    kw = dict(resolution=128, magnitude=20.0, lp_resolution=64)
    jest = JaxEstimator(JaxConfig(**kw))
    test = ScaleRotationEstimator(ScaleRotationConfig(**kw), device="cpu")
    assert (test.m_eff, test.ky) == (jest.m_eff, jest.ky) == (10.0, 64 / 360.0)
    f0 = _texture(128, seed=5)
    prev, curr = np.stack([f0]), np.stack([_warp(f0, 14.0, 1.0)])
    jres = jest.step_batch(jnp.asarray(prev), jnp.asarray(curr))
    tres = test.step_batch(torch.from_numpy(prev), torch.from_numpy(curr))
    assert abs(float(tres.rotation[0]) - float(jres.rotation[0])) <= DECODE_TOL
    assert abs(float(tres.rotation[0]) - np.deg2rad(14.0)) < np.deg2rad(3.0)


def test_decode_gate_matches_jax():
    """The first-frame gate, a peak out of range (|pt.x| > n/2, both of the
    reference's checks test pt.x) and a NaN peak all give (1, 0)."""
    kw = dict(resolution=64, magnitude=12.0)
    jest = JaxEstimator(JaxConfig(**kw))
    test = ScaleRotationEstimator(ScaleRotationConfig(**kw), device="cpu")
    shift = np.array([[3.5, -2.25], [-40.0, 1.0], [1.0, 40.0], [np.nan, np.nan], [32.0, 0.0]],
                     np.float32)
    gate = np.array([False, False, False, False, True])
    j_scale, j_rot = jest._decode(jnp.asarray(shift), jnp.asarray(gate))
    t = test._decode(torch.from_numpy(shift), torch.from_numpy(gate))
    np.testing.assert_allclose(to_numpy(t.scale), np.asarray(j_scale), rtol=1e-6)
    np.testing.assert_allclose(to_numpy(t.rotation), np.asarray(j_rot), rtol=1e-6)
    assert to_numpy(t.scale)[[1, 3, 4]].tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("interp", ["lanczos4", "bilinear"])
def test_decode_accuracy(interp):
    """The bounds ``tests/test_logpolar.py`` sets for the JAX estimator:
    rotation within 1 deg and scale within 0.03 (Lanczos-4), 1.5 deg and
    0.05 (bilinear)."""
    n = 128
    f0 = _texture(n, seed=6)
    test = ScaleRotationEstimator(
        ScaleRotationConfig(resolution=n, magnitude=20.0, interp=interp), device="cpu")
    res = test.step_batch(torch.from_numpy(np.stack([f0, f0])),
                          torch.from_numpy(np.stack([_warp(f0, 10.0, 1.0), _warp(f0, 0.0, 1.08)])))
    rot_tol, scale_tol = (1.0, 0.03) if interp == "lanczos4" else (1.5, 0.05)
    assert abs(float(res.rotation[0]) - np.deg2rad(10.0)) < np.deg2rad(rot_tol)
    assert abs(float(res.scale[1]) - 1 / 1.08) < scale_tol  # a zoom-in decodes below 1


def test_config_fields_match_jax_and_validation():
    import dataclasses

    assert [f.name for f in dataclasses.fields(ScaleRotationConfig)] == \
        [f.name for f in dataclasses.fields(JaxConfig)]
    assert ScaleRotationConfig() == ScaleRotationConfig(**dataclasses.asdict(JaxConfig()))
    with pytest.raises(ValueError, match="backend"):
        ScaleRotationEstimator(ScaleRotationConfig(backend="nope"), device="cpu")
    with pytest.raises(ValueError, match="interp"):
        ScaleRotationEstimator(ScaleRotationConfig(interp="cubic"), device="cpu")
