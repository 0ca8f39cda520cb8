"""The port's ``OpticFlowCalc`` (the reference's stateful interface,
``include/OpticFlowCalc.h:9-16``) against the JAX package's wrapper on the
CPU, as ``tests/test_fft_method.py::test_optic_flow_calc_compat`` drives
it: ``process_image`` with ``raw_output`` (a numpy array and a tensor
filled in place, an output of the wrong shape left as it is),
``process_image_long_range``, ``set_im_prev`` and ``last_result``.

Engines: ``FftMethod`` at frame 256 / patch 64 (kernel A's route: the JAX
engine runs its Pallas kernel in interpret mode, the port A's plain twin),
at frame 120 / patch 60 (kernel D's route and twin), and ``BlockMethod``
(kernel C's route and twin).  Tolerance: the NaN pattern equal, shifts
within 1e-3 px (``tests/test_torch_fft_method.py``'s ``SHIFT_TOL``);
the block engine's integer search bit for bit, as
``tests/test_torch_block_matching.py`` holds it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import fourier_shift, smooth_random_image
from torch_parity import to_numpy

from mrs_optic_flow_tpu.models import BlockMethod as JaxBlockMethod
from mrs_optic_flow_tpu.models import BlockMethodConfig as JaxBlockConfig
from mrs_optic_flow_tpu.models import FftMethod as JaxFftMethod
from mrs_optic_flow_tpu.models import FftMethodConfig as JaxFftConfig
from mrs_optic_flow_tpu.models import OpticFlowCalc as JaxCalc
from mrs_optic_flow_tpu_torch.models import (
    BlockMethod,
    BlockMethodConfig,
    FftMethod,
    FftMethodConfig,
    OpticFlowCalc,
)

SHIFT_TOL = 1e-3  # px

ENGINES = {
    "fft_kernel_a": (JaxFftMethod, JaxFftConfig, FftMethod, FftMethodConfig,
                     dict(frame_size=256, sample_point_size=64, max_pixel_speed=20.0)),
    "fft_kernel_d": (JaxFftMethod, JaxFftConfig, FftMethod, FftMethodConfig,
                     dict(frame_size=120, sample_point_size=60, max_pixel_speed=20.0)),
    "block_kernel_c": (JaxBlockMethod, JaxBlockConfig, BlockMethod, BlockMethodConfig,
                       dict(frame_size=96, sample_point_size=24, scan_radius=8)),
}


def _frames(size, seed, integer):
    """Four gray frames: a start, two moves and a jump past the FFT
    engines' speed gate; whole-pixel rolls for the block engine, sub-pixel
    shifts otherwise."""
    base = smooth_random_image(np.random.default_rng(seed), size, cutoff=0.3).astype(np.float64)
    moves = [(0.0, 0.0), (3.3, -2.7), (5.1, -4.2), (-17.1, -1.2)]
    if integer:
        return [np.roll(base, (int(dy), int(dx)), axis=(0, 1)).astype(np.float32) for dx, dy in moves]
    return [fourier_shift(base, dx, dy).astype(np.float32) for dx, dy in moves]


def _pair(name):
    jcls, jcfg, tcls, tcfg, kw = ENGINES[name]
    return JaxCalc(jcls(jcfg(**kw))), OpticFlowCalc(tcls(tcfg(**kw), device="cpu")), kw


def _assert_shifts(ours, theirs, name):
    ours, theirs = to_numpy(ours), np.asarray(theirs)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(theirs))
    if name.startswith("block"):
        np.testing.assert_array_equal(ours, theirs)
    else:
        np.testing.assert_allclose(ours, theirs, atol=SHIFT_TOL, rtol=0, equal_nan=True)


@pytest.mark.parametrize("name", ENGINES)
def test_process_image_matches_jax(name):
    jcalc, tcalc, kw = _pair(name)
    for frame in _frames(kw["frame_size"], 0, integer=name.startswith("block")):
        # sized as the ungated shifts: one row a window, or a block cell
        jraw = np.zeros_like(np.asarray(jcalc.engine.step(jcalc.state, jnp.asarray(frame))[1].shifts_raw))
        traw = np.full_like(jraw, -7.0)
        js = jcalc.process_image(jnp.asarray(frame), gui=True, debug=True, yaw_angle=0.3,
                                 raw_output=jraw)
        # the GUI, debug and geometry arguments are ignored; numpy frames go to the device
        ts = tcalc.process_image(frame, True, True, (1, 2), 0.3, (3, 4), traw, 420.0, 420.0)
        _assert_shifts(ts, js, name)
        _assert_shifts(tcalc.last_result.shifts_raw, jcalc.last_result.shifts_raw, name)
        _assert_shifts(traw, jraw, name)  # filled in place, as the JAX wrapper fills it
        assert not (traw == -7.0).all()


@pytest.mark.parametrize("name", ENGINES)
def test_raw_output_tensor_and_wrong_shape(name):
    _, tcalc, kw = _pair(name)
    frames = _frames(kw["frame_size"], 1, integer=name.startswith("block"))
    tcalc.process_image(torch.from_numpy(frames[0]))
    p = tcalc.last_result.shifts_raw.shape[0]
    out = torch.full((p, 2), -7.0)
    tcalc.process_image(torch.from_numpy(frames[1]), raw_output=out)
    np.testing.assert_array_equal(to_numpy(out), to_numpy(tcalc.last_result.shifts_raw))
    wrong = np.full((p + 1, 3), -7.0, np.float32)
    tcalc.process_image(frames[2], raw_output=wrong)
    assert (wrong == -7.0).all()


@pytest.mark.parametrize("name", ENGINES)
def test_set_im_prev_matches_jax(name):
    """``set_im_prev`` makes a frame the previous one: the next call
    measures against it, as in the JAX wrapper (and not a first frame)."""
    jcalc, tcalc, kw = _pair(name)
    f0, f1, f2, _ = _frames(kw["frame_size"], 2, integer=name.startswith("block"))
    jcalc.set_im_prev(jnp.asarray(f0))
    tcalc.set_im_prev(f0)
    assert tcalc.state.first is False
    _assert_shifts(tcalc.process_image(f2), jcalc.process_image(jnp.asarray(f2)), name)
    jcalc.set_im_prev(jnp.asarray(f1))
    tcalc.set_im_prev(torch.from_numpy(f1))
    _assert_shifts(tcalc.process_image(f2), jcalc.process_image(jnp.asarray(f2)), name)


def test_set_im_prev_case():
    """``test_optic_flow_calc_compat``'s case on the port: 480 px frames, a
    (5, 2) px move, read through ``raw_output``."""
    calc = OpticFlowCalc(FftMethod(FftMethodConfig(frame_size=480, sample_point_size=120),
                                   device="cpu"))
    f0 = smooth_random_image(np.random.default_rng(0), 480)
    f1 = np.roll(f0, (2, 5), axis=(0, 1))
    calc.set_im_prev(f0)
    raw = np.zeros((16, 2), np.float32)
    s = to_numpy(calc.process_image(f1, raw_output=raw))
    assert np.all(np.abs(s - np.array([5, 2])) < 0.3)
    assert np.abs(raw - np.array([5, 2])).max() < 0.3


@pytest.mark.parametrize("name", ["fft_kernel_a", "fft_kernel_d"])
def test_process_image_long_range_matches_jax(name):
    jcalc, tcalc, kw = _pair(name)
    for frame in _frames(kw["frame_size"], 3, integer=False):
        js = jcalc.process_image_long_range(jnp.asarray(frame), False, False)
        ts = tcalc.process_image_long_range(frame, False, False)
        _assert_shifts(ts, js, name)
        _assert_shifts(tcalc.last_result.shifts_raw, jcalc.last_result.shifts_raw, name)
    # the carry is the full-resolution frame: the modes switch between frames
    _assert_shifts(tcalc.process_image(frame), jcalc.process_image(jnp.asarray(frame)), name)


def test_long_range_needs_an_engine_with_it():
    _, tcalc, kw = _pair("block_kernel_c")
    with pytest.raises(AttributeError):
        tcalc.process_image_long_range(np.zeros((kw["frame_size"],) * 2, np.float32))
