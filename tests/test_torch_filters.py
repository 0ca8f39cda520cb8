"""The consensus means of the block-matching node path against
:mod:`mrs_optic_flow_tpu.filters.allsac` on the CPU.  ``ransac_mean`` is fed
the JAX function's own draws (``jax.random.choice`` with the same keys), so
both compute the same hypotheses.  Tolerance 1e-6: float32 means of the same
points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import run_both, to_numpy

from mrs_optic_flow_tpu.filters import allsac as jas
from mrs_optic_flow_tpu_torch.filters import allsac as tas

TOL = 1e-6


def _points(seed, n=9, n_valid=9, outliers=2):
    rng = np.random.default_rng(seed)
    pts = (np.array([0.8, -0.5]) + 0.05 * rng.standard_normal((n, 2))).astype(np.float32)
    pts[:outliers] += np.array([3.0, -2.0], np.float32)
    valid = np.zeros(n, bool)
    valid[rng.permutation(n)[:n_valid]] = True
    return pts, valid


@pytest.mark.parametrize("n_valid", [0, 1, 2, 5, 9])
def test_point_mean_matches_jax(n_valid):
    pts, valid = _points(0, n_valid=n_valid)
    j, t = run_both(jas.point_mean, tas.point_mean, pts, valid)
    np.testing.assert_allclose(t, j, atol=TOL, equal_nan=True)
    assert np.isnan(t).all() == (n_valid == 0)


@pytest.mark.parametrize("n_valid,thr_sq", [(9, 1.0), (9, 0.01), (2, 1.0), (1, 1.0), (6, 100.0)])
def test_allsac_mean_matches_jax(n_valid, thr_sq):
    pts, valid = _points(1, n_valid=n_valid)
    (jm, jc), (tm, tc) = run_both(lambda p, v: jas.allsac_mean(p, v, jnp.float32(thr_sq)),
                                  lambda p, v: tas.allsac_mean(p, v, thr_sq), pts, valid)
    np.testing.assert_allclose(tm, jm, atol=TOL, equal_nan=True)
    assert int(tc) == int(jc)


def test_allsac_ties_take_the_first_pair():
    # two equal clusters: every pair inside either scores 2; the first pair
    # in (i, j) scan order is (0, 0)
    pts = np.array([[0, 0], [0, 0.1], [5, 5], [5, 5.1]], np.float32)
    valid = np.ones(4, bool)
    (jm, jc), (tm, tc) = run_both(lambda p, v: jas.allsac_mean(p, v, jnp.float32(1.0)),
                                  lambda p, v: tas.allsac_mean(p, v, 1.0), pts, valid)
    np.testing.assert_allclose(tm, jm, atol=TOL)
    np.testing.assert_allclose(tm, [0.0, 0.05], atol=TOL)
    assert int(tc) == int(jc) == 2


def _jax_draws(key, valid, num_of_chosen, num_of_iterations):
    """The indices ``jas.ransac_mean`` draws from ``key``."""
    n = valid.shape[0]
    p = valid.astype(np.float32)
    p = jnp.asarray(p / max(p.sum(), 1.0))
    keys = jax.random.split(key, num_of_iterations)
    return np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, n, shape=(num_of_chosen,), replace=True, p=p))(keys))


@pytest.mark.parametrize("n_valid,seed", [(9, 0), (6, 1), (2, 2), (0, 3)])
def test_ransac_mean_with_jax_draws(n_valid, seed):
    pts, valid = _points(seed, n_valid=n_valid)
    key = jax.random.PRNGKey(seed)
    draws = _jax_draws(key, valid, 2, 50)
    j = np.asarray(jas.ransac_mean(jnp.asarray(pts), jnp.asarray(valid), jnp.float32(0.25), key,
                                   num_of_chosen=2, num_of_iterations=50))
    t = to_numpy(tas.ransac_mean(torch.from_numpy(pts), torch.from_numpy(valid), 0.25,
                                 num_of_chosen=2, num_of_iterations=50,
                                 draws=torch.from_numpy(draws.copy()).long()))
    np.testing.assert_allclose(t, j, atol=TOL, equal_nan=True)


def test_ransac_draws_from_a_generator_pick_valid_points():
    valid = torch.tensor([False, True, False, True, True, False])
    gen = torch.Generator().manual_seed(0)
    idx = tas.draw_indices(valid, 2, 500, gen)
    assert idx.shape == (500, 2)
    assert set(idx.unique().tolist()) == {1, 3, 4}
    pts, valid_np = _points(4)
    gen.manual_seed(1)
    mean = tas.ransac_mean(torch.from_numpy(pts), torch.from_numpy(valid_np), 0.25, generator=gen)
    np.testing.assert_allclose(mean.numpy(), [0.8, -0.5], atol=0.05)  # the inlier cluster


# ---------------------------------------------------------------------------
# the scalar allsac, the bounds and rotate_2d (tests/test_filters.py's cases
# on the port, and parity with the JAX functions on seeded inputs)
# ---------------------------------------------------------------------------


def test_allsac_1d_case():
    vals = np.array([1.0, 1.05, 0.98, 5.0, 1.01], np.float32)
    mean, chosen = tas.allsac_mean_1d(torch.from_numpy(vals), torch.ones(5, dtype=torch.bool), 0.2)
    assert int(chosen) == 4
    assert abs(float(mean) - np.mean([1.0, 1.05, 0.98, 1.01])) < 1e-6


def test_allsac_1d_all_invalid_is_nan():
    mean, chosen = tas.allsac_mean_1d(torch.full((5,), float("nan")),
                                      torch.zeros(5, dtype=torch.bool), 0.2)
    assert np.isnan(float(mean)) and int(chosen) == 0


@pytest.mark.parametrize("n_valid,thr", [(9, 0.2), (9, 0.01), (2, 0.2), (1, 0.2), (0, 0.2), (6, 50.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_allsac_1d_matches_jax(n_valid, thr, seed):
    pts, valid = _points(10 + seed, n_valid=n_valid)
    vals = np.where(valid, pts[:, 0], np.nan).astype(np.float32)
    (jm, jc), (tm, tc) = run_both(lambda v, m: jas.allsac_mean_1d(v, m, jnp.float32(thr)),
                                  lambda v, m: tas.allsac_mean_1d(v, m, thr), vals, valid)
    np.testing.assert_allclose(tm, jm, rtol=TOL, atol=TOL, equal_nan=True)
    assert int(tc) == int(jc)


def test_bounds_and_rotate_case():
    pts = torch.tensor([[3.0, 4.0], [0.1, 0.1]])
    assert tas.bound_abs_mask(pts, 5.1).tolist() == [True, True]
    assert tas.bound_abs_mask(pts, 4.9).tolist() == [False, True]
    r = tas.rotate_2d(torch.tensor([1.0, 0.0]), np.float32(np.pi / 2)).numpy()
    np.testing.assert_allclose(r, [0.0, 1.0], atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bounds_match_jax(seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 2, (12, 2)).astype(np.float32)
    vals = rng.normal(0, 2, 12).astype(np.float32)
    vals[3] = pts[2, 0] = np.nan
    for bound in (0.5, 2.0, 4.0):
        j, t = run_both(lambda p: jas.bound_abs_mask(p, bound), lambda p: tas.bound_abs_mask(p, bound), pts)
        np.testing.assert_array_equal(t, j)
        j, t = run_both(lambda v: jas.bound_abs_mask(v, bound), lambda v: tas.bound_abs_mask(v, bound), vals)
        np.testing.assert_array_equal(t, j)
        j, t = run_both(lambda p, e: jas.bound_radius_mask(p, e, bound),
                        lambda p, e: tas.bound_radius_mask(p, e, bound), pts, np.float32([0.5, -1.0]))
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("seed", [0, 1])
def test_rotate_2d_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 3, (7, 2)).astype(np.float32)
    for alpha in (0.0, 0.3, -2.1, np.pi):
        j, t = run_both(lambda p: jas.rotate_2d(p, jnp.float32(alpha)),
                        lambda p: tas.rotate_2d(p, np.float32(alpha)), pts)
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL * np.abs(pts).max())
