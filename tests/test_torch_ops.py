"""Parity of the port's device ops with the JAX package on the CPU:
preprocessing, the phase-correlation math, and kernel A's plain twin against
the JAX Pallas kernel (interpret mode) and the NumPy oracle.

Tolerances: float32 results of the same math summed in another order
(1e-4 gray levels, 1e-5 on surfaces of unit peak); shifts 1e-3 px, a
hundredth of the 0.1 px flow budget of BASELINE.md.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import make_accuracy_pairs, phase_correlate_oracle
from torch_parity import run_both, to_numpy

from mrs_optic_flow_tpu.ops import pallas_kernels
from mrs_optic_flow_tpu.ops import phase_correlate as jpc
from mrs_optic_flow_tpu.ops import preprocess as jpre
from mrs_optic_flow_tpu_torch.ops import cuda_kernels
from mrs_optic_flow_tpu_torch.ops import phase_correlate as tpc
from mrs_optic_flow_tpu_torch.ops import preprocess as tpre

SHIFT_TOL = 1e-3


@pytest.fixture(scope="module")
def bgr():
    return np.random.default_rng(0).integers(0, 256, size=(480, 752, 3), dtype=np.uint8)


@pytest.mark.parametrize("swap_rb", [True, False])
def test_grayscale_parity(bgr, swap_rb):
    j, t = run_both(
        lambda x: jpre.to_grayscale(x, swap_rb=swap_rb),
        lambda x: tpre.to_grayscale(x, swap_rb=swap_rb), bgr,
    )
    assert t.dtype == np.float32 and t.shape == (480, 752)
    np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)


def test_crop_and_quantize_exact(bgr):
    gray = np.random.default_rng(7).uniform(-20, 280, size=(480, 752)).astype(np.float32)

    def chain(pre):
        return lambda x: pre.quantize_u8(pre.center_crop(x, 480, 376.0))

    j, t = run_both(chain(jpre), chain(tpre), gray)
    assert t.dtype == np.uint8 and t.shape == (480, 480)
    np.testing.assert_array_equal(t, j)
    j, t = run_both(lambda x: jpre.center_crop(x, 480, 376.0),
                    lambda x: tpre.center_crop(x, 480, 376.0), bgr[..., 0])
    np.testing.assert_array_equal(t, j)
    assert tpre.crop_origin(752, 480, 480, 376.0) == jpre.crop_origin(752, 480, 480, 376.0)


def test_quantize_rounds_half_to_even_and_saturates():
    x = np.array([-3.0, 0.5, 1.5, 2.5, 254.5, 255.4, 300.0], np.float32)
    j, t = run_both(jpre.quantize_u8, tpre.quantize_u8, x)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, [0, 0, 2, 2, 254, 255, 255])


def test_center_crop_outside_the_image_raises():
    with pytest.raises(ValueError, match="leaves"):
        tpre.center_crop(torch.zeros((480, 752)), 480, 700.0)


@pytest.mark.parametrize("inv_scale", [2.0, 4.0])
def test_resize_by_parity(inv_scale):
    img = np.random.default_rng(1).uniform(0, 255, size=(2, 480, 480)).astype(np.float32)
    j, t = run_both(lambda x: jpre.resize_by(x, inv_scale), lambda x: tpre.resize_by(x, inv_scale), img)
    assert t.shape == j.shape == (2, round(480 / inv_scale), round(480 / inv_scale))
    np.testing.assert_allclose(t, j, atol=1e-3, rtol=0)


def test_patchify_parity_and_roundtrip():
    frame = np.arange(2 * 96 * 96, dtype=np.float32).reshape(2, 96, 96)
    j, t = run_both(lambda x: jpre.patchify(x, 24), lambda x: tpre.patchify(x, 24), frame)
    np.testing.assert_array_equal(t, j)
    back = tpre.unpatchify(torch.from_numpy(t), 4, 4).numpy()
    np.testing.assert_array_equal(back, frame)


def _patch_pairs(n_pairs=3, n=64, seed=2):
    prev, curr, _, _ = make_accuracy_pairs(np.random.default_rng(seed), n_pairs, size=n, patch=n)
    return curr.astype(np.float32), prev.astype(np.float32)


@pytest.mark.parametrize("backend", ["dft", "fft"])
def test_correlation_surface_parity(backend):
    curr, prev = _patch_pairs()
    j, t = run_both(
        lambda c, p: jpc.correlation_surface(c, p, backend=backend),
        lambda c, p: tpc.correlation_surface(c, p, backend=backend), curr, prev,
    )
    assert t.shape == curr.shape
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)


@pytest.mark.parametrize("backend", ["dft", "fft"])
def test_phase_correlate_field_parity(backend):
    curr, prev = _patch_pairs()
    (js, jm), (ts, tm) = run_both(
        lambda c, p: jpc.phase_correlate_field(c, p, backend=backend),
        lambda c, p: tpc.phase_correlate_field(c, p, backend=backend), curr, prev,
    )
    np.testing.assert_allclose(ts, js, atol=SHIFT_TOL, rtol=0)
    np.testing.assert_allclose(tm, jm, rtol=1e-4)


def test_peak_refine_parity_on_ties_and_nan():
    surf = np.zeros((3, 16, 16), np.float32)
    surf[0, 3, 5] = surf[0, 9, 2] = 1.0  # tie: the lower flat index wins
    surf[1, 8, 8] = 2.0
    surf[1, 8, 9] = 1.0
    surf[2, 4, 4] = np.nan
    (js, jm), (ts, tm) = run_both(jpc.peak_refine, tpc.peak_refine, surf)
    np.testing.assert_allclose(ts, js, atol=1e-6, equal_nan=True)
    np.testing.assert_array_equal(tm, jm)
    assert np.isnan(ts[2]).all() and np.isnan(tm[2])


def _frames_both(curr, prev, patch):
    jax_out = pallas_kernels.phase_correlate_frames_pallas(
        jnp.asarray(curr), jnp.asarray(prev), patch=patch
    )
    torch_out = cuda_kernels.phase_correlate_frames(
        torch.from_numpy(curr), torch.from_numpy(prev), patch=patch
    )
    return to_numpy(tuple(jax_out)), to_numpy(torch_out)


def test_twin_matches_jax_frames_kernel():
    prev, curr, _, oracle = make_accuracy_pairs(np.random.default_rng(0), 4, size=256, patch=64)
    (js, jm), (ts, tm) = _frames_both(curr, prev, 64)
    assert ts.shape == (4, 16, 2) and tm.shape == (4, 16)
    np.testing.assert_allclose(ts, js, atol=SHIFT_TOL, rtol=0)
    np.testing.assert_allclose(tm, jm, rtol=1e-4)
    np.testing.assert_allclose(ts, oracle, atol=SHIFT_TOL, rtol=0)


def test_twin_matches_oracle_per_patch():
    prev, curr, _, _ = make_accuracy_pairs(np.random.default_rng(3), 2, size=128, patch=64)
    ts, tm = to_numpy(cuda_kernels.phase_correlate_frames_ref(
        torch.from_numpy(curr), torch.from_numpy(prev), patch=64
    ))
    for b in range(2):
        for k in range(4):
            i, j = k % 2, k // 2
            sl = (b, slice(j * 64, (j + 1) * 64), slice(i * 64, (i + 1) * 64))
            osh, omax = phase_correlate_oracle(curr[sl], prev[sl])
            np.testing.assert_allclose(ts[b, k], osh, atol=SHIFT_TOL)
            np.testing.assert_allclose(tm[b, k], omax, rtol=1e-4)


def test_default_size_matches_jax():
    prev, curr, _, oracle = make_accuracy_pairs(np.random.default_rng(4), 1)
    (js, jm), (ts, tm) = _frames_both(curr, prev, 120)
    assert ts.shape == (1, 16, 2)
    np.testing.assert_allclose(ts, js, atol=SHIFT_TOL, rtol=0)
    np.testing.assert_allclose(tm, jm, rtol=1e-4)
    np.testing.assert_allclose(ts, oracle, atol=SHIFT_TOL, rtol=0)


def test_zero_frames_match_jax_exactly():
    zero = np.zeros((2, 128, 128), np.uint8)
    (js, jm), (ts, tm) = _frames_both(zero, zero, 64)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tm, jm)
    assert np.all(ts == -32.0) and np.all(tm == 0.0)


def test_identical_frames_give_zero_shift():
    prev, _, _, _ = make_accuracy_pairs(np.random.default_rng(5), 2, size=128, patch=64)
    (js, _), (ts, _) = _frames_both(prev, prev, 64)
    assert np.abs(ts).max() <= SHIFT_TOL and np.abs(js).max() <= SHIFT_TOL


def test_nan_frames_match_jax():
    prev, curr, _, _ = make_accuracy_pairs(np.random.default_rng(6), 1, size=128, patch=64)
    curr = curr.astype(np.float32)
    curr[0, 70, 3] = np.nan  # patch i=0, j=1: field 2
    (js, jm), (ts, tm) = _frames_both(curr, prev.astype(np.float32), 64)
    np.testing.assert_array_equal(np.isnan(ts), np.isnan(js))
    np.testing.assert_array_equal(np.isnan(tm), np.isnan(jm))
    assert np.isnan(ts[0, 2]).all() and np.isfinite(np.delete(ts[0], 2, axis=0)).all()
    np.testing.assert_allclose(ts, js, atol=SHIFT_TOL, rtol=0, equal_nan=True)


def test_wrapper_dispatch_and_checks():
    # a tensor neither on the CPU nor on a CUDA device is refused, never
    # moved to the CPU twin
    meta = torch.empty((1, 128, 128), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.phase_correlate_frames(meta, meta, patch=64)
    with pytest.raises(ValueError, match="square grid"):
        cuda_kernels.phase_correlate_frames(
            torch.zeros((1, 128, 96)), torch.zeros((1, 128, 96)), patch=64
        )
