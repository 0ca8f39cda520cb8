"""Kernel B's plain twin (``cuda_kernels.peak_refine_raw_ref``) against the
JAX Pallas kernel ``peak_refine_raw_pallas`` (interpret mode on the CPU), and
the routes that reach it: ``phase_correlate_field(use_pallas=True)`` and the
wrapper's dispatch.

Tolerances: the peak index and maxval are exact (the same element of the
same surface); shifts 1e-4 px, the bound ``chip_smoke.py`` holds kernel B
to: float32 centroid sums taken in another order, over coordinates up to
N/2 = 60, whose float32 spacing is 3.8e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import make_accuracy_pairs
from torch_parity import run_both, to_numpy

from mrs_optic_flow_tpu.ops import pallas_kernels
from mrs_optic_flow_tpu.ops import phase_correlate as jpc
from mrs_optic_flow_tpu_torch.ops import cuda_kernels
from mrs_optic_flow_tpu_torch.ops import phase_correlate as tpc

SHIFT_TOL = 1e-4


def _surfaces(n: int, seed: int = 0) -> np.ndarray:
    """Raw (unshifted) surfaces ``[6, n, n]``: random values with one strong
    peak, a forced tie, NaN inside and outside a radius-(n//4) window, a
    peak on the surface edge, and zeros.  Raw index (y, x) sits at shifted
    ((y + n/2) % n, (x + n/2) % n)."""
    rng = np.random.default_rng(seed)
    h = n // 2
    s = rng.uniform(-0.1, 0.1, size=(6, n, n)).astype(np.float32)
    s[0, 3, n - 2] = 1.0
    s[1, 2, 1] = s[1, n - 1, 3] = 1.0  # tie: the smaller shifted index wins
    s[2, 1, 1] = 1.0
    s[2, 0, 2] = np.nan  # inside any window
    s[3, 1, 1] = 1.0
    s[3, h, h] = np.nan  # shifted (0, 0): outside a window of radius < n/2
    s[4, h, h + 2] = 1.0  # shifted (0, 2): the centroid window is clamped
    s[4, h, h + 3] = s[4, h + 1, h + 2] = 0.5
    s[5] = 0.0
    return s


@pytest.mark.parametrize("n", [16, 32, 120])
@pytest.mark.parametrize("radius", ["quarter", "full"])
def test_twin_matches_jax_peak_kernel(n, radius):
    surf = _surfaces(n)
    r = n // 4 if radius == "quarter" else n // 2
    (js, jm), (ts, tm) = run_both(
        lambda x: pallas_kernels.peak_refine_raw_pallas(x, search_radius=r, centroid_radius=3),
        lambda x: cuda_kernels.peak_refine_raw(x, search_radius=r, centroid_radius=3),
        surf,
    )
    assert ts.shape == (6, 2) and tm.shape == (6,)
    np.testing.assert_array_equal(np.isnan(ts), np.isnan(js))
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(ts, js, atol=SHIFT_TOL, rtol=0, equal_nan=True)
    assert np.isnan(tm[2]) and np.isnan(ts[2]).all()  # NaN in the window
    assert np.isnan(tm[3]) == (radius == "full")  # shifted (0, 0) is only in the full window


def test_tie_and_edge_peak_indices():
    surf = torch.from_numpy(_surfaces(32))
    _, maxval, index = cuda_kernels.peak_refine_raw(surf, search_radius=16, with_index=True)
    # surface 1: raw (2, 1) -> shifted (18, 17); raw (31, 3) -> shifted (15, 19)
    assert int(index[1]) == 15 * 32 + 19
    assert int(index[4]) == 0 * 32 + 2 and float(maxval[4]) == 1.0
    assert float(maxval[5]) == 0.0 and int(index[5]) == 0  # zeros: the first index
    # the clamped window of a clean edge peak: shifted (0, 2) = 1, (0, 3) =
    # 0.5 and (1, 2) = 0.5
    edge = torch.zeros((1, 32, 32))
    edge[0, 16, 18] = 1.0
    edge[0, 16, 19] = edge[0, 17, 18] = 0.5
    shift, _ = cuda_kernels.peak_refine_raw(edge, search_radius=16)
    np.testing.assert_allclose(shift[0].numpy(), [2.25 - 16, 0.25 - 16], atol=1e-5)


def test_twin_leading_dims_and_empty_batch():
    surf = torch.from_numpy(_surfaces(16)).reshape(2, 3, 16, 16)
    shift, maxval = cuda_kernels.peak_refine_raw(surf, search_radius=8)
    assert shift.shape == (2, 3, 2) and maxval.shape == (2, 3)
    flat = cuda_kernels.peak_refine_raw(surf.reshape(6, 16, 16), search_radius=8)
    np.testing.assert_array_equal(to_numpy(maxval).ravel(), to_numpy(flat[1]))
    empty = cuda_kernels.peak_refine_raw(torch.zeros((0, 16, 16)))
    assert empty[0].shape == (0, 2)


@pytest.mark.parametrize("backend", ["dft", "fft"])
def test_phase_correlate_field_kernel_route_matches_jax(backend):
    prev, curr, _, _ = make_accuracy_pairs(np.random.default_rng(8), 3, size=64, patch=64)
    curr, prev = curr.astype(np.float32), prev.astype(np.float32)
    (js, jm), (ts, tm) = run_both(
        lambda c, p: jpc.phase_correlate_field(c, p, backend=backend, use_pallas=True),
        lambda c, p: tpc.phase_correlate_field(c, p, backend=backend, use_pallas=True),
        curr, prev,
    )
    np.testing.assert_allclose(ts, js, atol=1e-3, rtol=0)
    np.testing.assert_allclose(tm, jm, rtol=1e-4)
    plain = to_numpy(tpc.phase_correlate_field(torch.from_numpy(curr), torch.from_numpy(prev),
                                               backend=backend))
    np.testing.assert_array_equal(ts, plain[0])


def test_raw_surface_is_the_unshifted_surface():
    prev, curr, _, _ = make_accuracy_pairs(np.random.default_rng(9), 2, size=32, patch=32)
    c, p = torch.from_numpy(curr), torch.from_numpy(prev)
    raw = tpc.correlation_surface_raw(c, p, backend="dft")
    surf = tpc.correlation_surface(c, p, search_radius=16, backend="dft")
    np.testing.assert_array_equal(to_numpy(torch.fft.fftshift(raw, dim=(-2, -1))), to_numpy(surf))
    j = np.asarray(jpc.correlation_surface(jnp.asarray(curr), jnp.asarray(prev), search_radius=16,
                                           backend="dft"))
    np.testing.assert_allclose(to_numpy(surf), j, atol=1e-5, rtol=0)


def test_wrappers_refuse_other_devices():
    meta = torch.empty((1, 16, 16), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.peak_refine_raw(meta)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.sad_search(meta, meta, block_size=16, scan_radius=0)
