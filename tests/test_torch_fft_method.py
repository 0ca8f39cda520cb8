"""Parity of the port's FftMethod engine with the JAX engine on the CPU
(frame 256, patch 64): the single-frame stream with its first-frame copy and
uint8 carry, and the batched mode, on every route: kernel A
(``use_pallas=True, backend="dft"``), the raw surface and kernel B
(``backend="fft"``), and the plain path (``use_pallas=False``).  The JAX
engine runs its Pallas kernels in interpret mode; the port runs the kernels'
plain twins."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import fourier_shift, smooth_random_image
from torch_parity import to_numpy

from mrs_optic_flow_tpu.models import FftMethod as JaxFftMethod
from mrs_optic_flow_tpu.models import FftMethodConfig as JaxConfig
from mrs_optic_flow_tpu_torch.models import FftMethod, FftMethodConfig, make_engine

SHIFT_TOL = 1e-3  # px
MAX_SPEED = 20.0  # px per frame


def _stream(seed=0):
    """Four float gray frames: a start, two sub-pixel moves, and a 25 px jump
    that the speed gate of ``MAX_SPEED`` rejects."""
    base = smooth_random_image(np.random.default_rng(seed), 256, cutoff=0.3).astype(np.float64)
    moves = [(0.0, 0.0), (3.3, -2.7), (7.1, -4.2), (32.1, -1.2)]
    return [fourier_shift(base, dx, dy).astype(np.float32) for dx, dy in moves]


def _assert_gated_equal(ts, js):
    np.testing.assert_array_equal(np.isnan(ts), np.isnan(js))
    np.testing.assert_allclose(ts, js, atol=SHIFT_TOL, rtol=0, equal_nan=True)


@pytest.mark.parametrize("quantize_8bit", [True, False])
def test_step_stream_matches_jax(quantize_8bit):
    kw = dict(frame_size=256, sample_point_size=64, quantize_8bit=quantize_8bit,
              max_pixel_speed=MAX_SPEED)
    jeng, teng = JaxFftMethod(JaxConfig(**kw)), FftMethod(FftMethodConfig(**kw), device="cpu")
    jst, tst = jeng.init_state(), teng.init_state()
    gated = 0
    for i, frame in enumerate(_stream()):
        jst, jres = jeng.step(jst, jnp.asarray(frame))
        tst, tres = teng.step(tst, torch.from_numpy(frame))
        js, ts = to_numpy(jres.shifts), to_numpy(tres.shifts)
        _assert_gated_equal(ts, js)
        np.testing.assert_allclose(to_numpy(tres.shifts_raw), to_numpy(jres.shifts_raw),
                                   atol=SHIFT_TOL, rtol=0)
        np.testing.assert_allclose(to_numpy(tres.response), to_numpy(jres.response), rtol=1e-4)
        # the carry: uint8 (rounded) or float32, equal to JAX's
        assert tst.prev.dtype == (torch.uint8 if quantize_8bit else torch.float32)
        np.testing.assert_array_equal(to_numpy(tst.prev), to_numpy(jst.prev))
        assert tst.first is False
        if i == 0:  # first-frame copy: a zero-shift measurement
            assert np.abs(ts).max() <= SHIFT_TOL
        gated += int(np.isnan(ts).any())
    assert gated == 1 and np.isnan(ts).all()  # the jump, every window


def test_step_batch_matches_jax():
    frames = _stream(seed=1)
    prev = np.stack(frames[:3])
    curr = np.stack(frames[1:])
    kw = dict(frame_size=256, sample_point_size=64, max_pixel_speed=MAX_SPEED)
    jres = JaxFftMethod(JaxConfig(**kw)).step_batch(jnp.asarray(prev), jnp.asarray(curr))
    tres = FftMethod(FftMethodConfig(**kw), device="cpu").step_batch(
        torch.from_numpy(prev), torch.from_numpy(curr))
    ts = to_numpy(tres.shifts)
    assert ts.shape == (3, 16, 2)
    _assert_gated_equal(ts, to_numpy(jres.shifts))
    np.testing.assert_allclose(to_numpy(tres.response), to_numpy(jres.response), rtol=1e-4)


@pytest.mark.parametrize("backend,use_pallas", [("fft", True), ("fft", False), ("dft", False)])
def test_other_routes_match_jax(backend, use_pallas):
    frames = _stream(seed=2)
    kw = dict(frame_size=256, sample_point_size=64, max_pixel_speed=MAX_SPEED, backend=backend,
              use_pallas=use_pallas)
    jeng, teng = JaxFftMethod(JaxConfig(**kw)), FftMethod(FftMethodConfig(**kw), device="cpu")
    jst, tst = jeng.init_state(), teng.init_state()
    for frame in frames:
        jst, jres = jeng.step(jst, jnp.asarray(frame))
        tst, tres = teng.step(tst, torch.from_numpy(frame))
        _assert_gated_equal(to_numpy(tres.shifts), to_numpy(jres.shifts))
        np.testing.assert_allclose(to_numpy(tres.response), to_numpy(jres.response), rtol=1e-4)
    prev, curr = np.stack(frames[:3]), np.stack(frames[1:])
    jres = jeng.step_batch(jnp.asarray(prev), jnp.asarray(curr))
    tres = teng.step_batch(torch.from_numpy(prev), torch.from_numpy(curr))
    assert tuple(tres.shifts.shape) == (3, 16, 2)
    _assert_gated_equal(to_numpy(tres.shifts), to_numpy(jres.shifts))


def test_set_im_prev_and_init_state():
    eng = FftMethod(FftMethodConfig(frame_size=128, sample_point_size=64), device="cpu")
    st = eng.init_state()
    assert st.first is True and st.prev.dtype == torch.uint8 and st.prev.shape == (128, 128)
    assert not st.prev.any()
    st = eng.set_im_prev(st, torch.full((128, 128), 7.6))
    assert st.first is False and st.prev.dtype == torch.uint8 and int(st.prev[0, 0]) == 8


@pytest.mark.parametrize(
    "frame_size,patch", [(481, 120), (480, 100), (480, 60), (256, 64)]
)
def test_config_normalization_matches_jax(frame_size, patch):
    ours = FftMethodConfig(frame_size=frame_size, sample_point_size=patch).normalized()
    theirs = JaxConfig(frame_size=frame_size, sample_point_size=patch).normalized()
    assert (ours.frame_size, ours.sample_point_size) == (theirs.frame_size, theirs.sample_point_size)
    assert FftMethod(ours, device="cpu").sq_num == JaxFftMethod(theirs).sq_num


def test_tpu_knobs_accepted_and_ignored():
    names = {f.name for f in dataclasses.fields(JaxConfig)}
    assert names == {f.name for f in dataclasses.fields(FftMethodConfig)}
    frame = torch.from_numpy(_stream()[1])
    plain = FftMethod(FftMethodConfig(frame_size=256, sample_point_size=64), device="cpu")
    knobs = FftMethod(FftMethodConfig(frame_size=256, sample_point_size=64, mxu_passes=1,
                                      half_spectrum=False, bands_per_step=2,
                                      pairs_per_step=2, band_stack=2), device="cpu")
    a = plain.step(plain.init_state(), frame)[1].shifts
    b = knobs.step(knobs.init_state(), frame)[1].shifts
    assert torch.equal(a, b)


def test_unported_routes_raise():
    """Every route of the JAX engine is ported, long range included
    (tests/test_torch_long_range.py); what the JAX engine refuses, the port
    refuses."""
    with pytest.raises(ValueError, match="backend"):
        FftMethod(FftMethodConfig(backend="nope"), device="cpu")
    eng = FftMethod(FftMethodConfig(frame_size=128, sample_point_size=64), device="cpu")
    _, res = eng.step_long_range(eng.init_state(), torch.zeros((128, 128)))
    assert tuple(res.shifts.shape) == (eng.num_windows_lr, 2) == (1, 2)
    with pytest.raises(ValueError, match="grid"):  # a frame that is no grid of 64 px patches
        eng.step(eng.init_state(), torch.zeros((100, 100)))
    assert isinstance(make_engine(4, frame_size=128, sample_point_size=64, device="cpu"), FftMethod)
    with pytest.raises(ValueError, match="invalid method"):
        make_engine(7, device="cpu")
