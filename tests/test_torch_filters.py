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
