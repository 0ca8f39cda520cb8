"""``estimate_tran_rot_vvel`` of the port against
:mod:`mrs_optic_flow_tpu.filters.tran_rot_vvel` on the CPU: the cases of
``tests/test_filters.py`` (translation, rotation, scale, no valid estimate,
bounds) on the port, and seeded random grids with NaN cells through both.

Tolerance: the NaN pattern equal; values within 1e-6 relative, or 1e-6
times the largest input component absolute (float32 sums of the same terms,
which the two libraries may associate differently: the random grids differ
by at most 2.4e-7 px and 4.5e-8 in a rate)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_numpy

from mrs_optic_flow_tpu.filters.tran_rot_vvel import estimate_tran_rot_vvel as jax_trv
from mrs_optic_flow_tpu_torch.filters import TranRotVvel, estimate_tran_rot_vvel

TOL = 1e-6


def _port(vec, *scalars):
    return to_numpy(tuple(estimate_tran_rot_vvel(torch.from_numpy(np.array(vec, np.float32)),
                                                 *scalars)))


def _jax(vec, *scalars):
    out = jax_trv(jnp.asarray(vec, jnp.float32), *(jnp.float32(s) for s in scalars))
    return tuple(np.asarray(x) for x in out)


def _pack_column_major(r):
    """``r``: cell -> (vx, vy) in the flipped-y working frame; the ``[9, 2]``
    input (screen coordinates, column-major, ``src/utilityFunctions.cpp:358-369``)."""
    order = [1, 4, 7, 2, 5, 8, 3, 6, 9]
    return np.array([[r[k][0], -r[k][1]] for k in order], np.float32)


def test_result_fields():
    out = estimate_tran_rot_vvel(torch.zeros(9, 2), 40.0, 400.0, 400.0, 2.0, 100.0, 0.1, 5.0, 5.0)
    assert isinstance(out, TranRotVvel) and out.tran.shape == (2,)
    assert out.rot.shape == () and out.vvel.shape == ()


def test_pure_translation():
    vec = np.tile(np.array([4.0, -2.0], np.float32), (9, 1))
    tran, rot, vvel = _port(vec, 40.0, 400.0, 400.0, 2.0, 100.0, 0.1, 5.0, 5.0)
    np.testing.assert_allclose(tran, [4.0, -2.0], atol=1e-5)
    np.testing.assert_allclose(rot, 0.0, atol=1e-6)
    np.testing.assert_allclose(vvel, 0.0, atol=1e-6)


def test_no_valid_estimates_is_nan():
    vec = np.full((9, 2), np.nan, np.float32)
    vec[4] = (1.0, 1.0)  # r5, the centre: every r_est/s_est term touches an outer cell
    tran, rot, vvel = _port(vec, 40.0, 400.0, 400.0, 2.0, 100.0, 0.1, 5.0, 5.0)
    assert np.isnan(rot) and np.isnan(vvel)
    assert np.all(np.isfinite(tran))


def test_pure_rotation():
    c = 0.5
    r = {1: (c, c), 9: (-c, -c), 3: (c, -c), 7: (-c, c), 4: (0, c), 6: (0, -c), 2: (c, 0),
         8: (-c, 0), 5: (0, 0)}
    tran, rot, vvel = _port(_pack_column_major(r), 1.0, 400.0, 400.0, 2.0, 100.0, 1.0, 5.0, 5.0)
    np.testing.assert_allclose(tran, [0.0, 0.0], atol=1e-5)
    np.testing.assert_allclose(rot, c, atol=1e-5)
    np.testing.assert_allclose(vvel, 0.0, atol=1e-6)


def test_pure_scale():
    c, rng_ = 0.25, 2.0
    r = {1: (-c, c), 9: (c, -c), 3: (c, c), 7: (-c, -c), 4: (-c, 0), 6: (c, 0), 2: (0, c),
         8: (0, -c), 5: (0, 0)}
    tran, rot, vvel = _port(_pack_column_major(r), 1.0, 400.0, 400.0, rng_, 100.0, 1.0, 5.0, 5.0)
    np.testing.assert_allclose(rot, 0.0, atol=1e-6)
    np.testing.assert_allclose(vvel, c * rng_, atol=1e-5)


def test_bounds_to_nan():
    vec = np.zeros((9, 2), np.float32)
    vec[4] = [100.0, 0.0]
    args = (1.0, 400.0, 400.0, 2.0, 1e-6, 0.01, 0.1, 0.1)
    tran, rot, vvel = _port(vec, *args)
    assert np.isnan(rot) or abs(float(rot)) <= 0.1
    jt, jr, jv = _jax(vec, *args)
    np.testing.assert_array_equal(np.isnan([rot, vvel]), np.isnan([jr, jv]))


def _assert_close(ours, theirs, vec):
    scale = max(1.0, float(np.nanmax(np.abs(vec), initial=0.0)))
    for a, b in zip(ours, theirs):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL * scale, equal_nan=True)


@pytest.mark.parametrize("n_nan", [0, 1, 3, 6, 8])
@pytest.mark.parametrize("seed", range(4))
def test_random_grids_match_jax(seed, n_nan):
    """Seeded grids: a translation, a turn and a zoom with noise, some cells
    NaN; allsac radii that keep all, some and none of the hypotheses."""
    rng = np.random.default_rng(seed * 16 + n_nan)
    a = 40.0
    ij = np.array([(i, j) for j in (-1, 0, 1) for i in (-1, 0, 1)], np.float32)  # column-major
    t = rng.normal(0, 3, 2)
    w, s = rng.normal(0, 0.05), rng.normal(0, 0.05)
    flow = t + a * (w * np.stack([-ij[:, 1], ij[:, 0]], 1) + s * ij) + rng.normal(0, 0.2, (9, 2))
    vec = flow.astype(np.float32)
    vec[rng.permutation(9)[:n_nan]] = np.nan
    for radius_sq in (1e-4, 0.05, 100.0):
        for bounds in ((5.0, 5.0), (0.02, 0.02)):
            args = (a, 420.0, 415.0, 1.7, radius_sq, 0.05, *bounds)
            _assert_close(_port(vec, *args), _jax(vec, *args), vec)
