"""Parity of the port's geometry with the JAX package on the CPU: rotations,
undistortion, RANSAC homography fed the JAX draws, Malis-Vargas
decomposition and getRT.

Tolerances: float32 math in another operation order, 1e-5 on unit-scale
rotation values, 1e-4 relative on homographies and velocities.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import run_both, to_numpy

from mrs_optic_flow_tpu.geometry import homography as jh
from mrs_optic_flow_tpu.geometry import motion as jm
from mrs_optic_flow_tpu.geometry import rotations as jr
from mrs_optic_flow_tpu.geometry import undistort as ju
from mrs_optic_flow_tpu_torch.geometry import homography as th
from mrs_optic_flow_tpu_torch.geometry import motion as tm
from mrs_optic_flow_tpu_torch.geometry import rotations as tr
from mrs_optic_flow_tpu_torch.geometry import undistort as tu


def _quats(rng, n=16):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rotations(rng, n=16):
    return np.asarray(jr.matrix_from_quat(jnp.asarray(_quats(rng, n))))


ROTATION_CASES = {
    "quat_multiply": (lambda m: (lambda a, b: m.quat_multiply(a, b)), lambda r: (_quats(r), _quats(r))),
    "quat_rotate": (lambda m: (lambda q, v: m.quat_rotate(q, v)),
                    lambda r: (_quats(r), r.standard_normal((16, 3)).astype(np.float32))),
    "quat_inverse": (lambda m: m.quat_inverse, lambda r: (_quats(r),)),
    "quat_from_axis_angle": (lambda m: m.quat_from_axis_angle,
                             lambda r: (r.standard_normal((16, 3)).astype(np.float32),
                                        r.uniform(-3, 3, 16).astype(np.float32))),
    "quat_axis_angle": (lambda m: m.quat_axis_angle, lambda r: (_quats(r),)),
    "quat_angle": (lambda m: m.quat_angle, lambda r: (_quats(r), _quats(r))),
    "quat_from_rpy": (lambda m: m.quat_from_rpy,
                      lambda r: tuple(r.uniform(-1.5, 1.5, 16).astype(np.float32) for _ in range(3))),
    "matrix_from_quat": (lambda m: m.matrix_from_quat, lambda r: (_quats(r),)),
    "quat_from_matrix": (lambda m: m.quat_from_matrix, lambda r: (_rotations(r),)),
    "rpy_from_matrix": (lambda m: m.rpy_from_matrix, lambda r: (_rotations(r),)),
}


@pytest.mark.parametrize("name", sorted(ROTATION_CASES))
def test_rotations_parity(name):
    fn, make_inputs = ROTATION_CASES[name]
    inputs = make_inputs(np.random.default_rng(0))
    j, t = run_both(fn(jr), fn(tr), *inputs)
    if not isinstance(t, tuple):
        j, t = (j,), (t,)
    for a, b in zip(t, j, strict=True):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


CAM = np.array([[420.0, 0, 136.0], [0, 420.0, 240.0], [0, 0, 1]], np.float32)
DIST = np.array([-0.28, 0.07, 1e-3, -5e-4, 0.0], np.float32)


def test_undistort_parity():
    pts = np.random.default_rng(1).uniform(0, 480, (64, 2)).astype(np.float32)
    j, t = run_both(ju.undistort_points, tu.undistort_points, pts, CAM, DIST)
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)
    j, t = run_both(lambda p, c: ju.undistort_points(p, c, None),
                    lambda p, c: tu.undistort_points(p, c, None), pts, CAM)
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    j, t = run_both(ju.distort_points, tu.distort_points, t, DIST)
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)


def _jax_hypotheses(key, valid, iterations):
    """The JAX package's draws, rebuilt exactly as homography.py:231-240."""
    n = valid.shape[0]
    p = jnp.asarray(valid, jnp.float32)
    p_norm = p / jnp.maximum(jnp.sum(p), 1.0)
    keys = jax.random.split(key, iterations)
    idx = jax.vmap(lambda k: jax.random.choice(k, n, shape=(4,), replace=False, p=p_norm))(keys)
    return torch.from_numpy(np.asarray(idx).astype(np.int64))


def _point_set(seed, n_outliers, n_invalid):
    """16 normalized grid points through a mild homography, with outliers and
    invalid (masked) points."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(np.linspace(-0.3, 0.3, 4), np.linspace(-0.3, 0.3, 4)), -1)
    src = g.reshape(-1, 2).astype(np.float32)
    h = np.array([[1.01, 0.01, 0.02], [-0.008, 0.995, -0.015], [0.01, -0.02, 1.0]])
    dst_h = np.c_[src, np.ones(16)] @ h.T
    dst = (dst_h[:, :2] / dst_h[:, 2:]).astype(np.float32)
    dst += rng.normal(0, 5e-4, dst.shape).astype(np.float32)
    bad = rng.choice(16, n_outliers + n_invalid, replace=False)
    dst[bad[:n_outliers]] += rng.uniform(0.05, 0.1, (n_outliers, 2)).astype(np.float32)
    valid = np.ones(16, bool)
    valid[bad[n_outliers:]] = False
    return src, dst, valid


@pytest.mark.parametrize("seed,n_outliers,n_invalid", [(0, 0, 0), (1, 3, 2), (2, 5, 0)])
def test_find_homography_ransac_with_jax_draws(seed, n_outliers, n_invalid):
    src, dst, valid = _point_set(seed, n_outliers, n_invalid)
    key = jax.random.PRNGKey(seed)
    jres = jh.find_homography_ransac(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), key,
                                     iterations=64)
    tres = th.find_homography_ransac(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid),
        hyp_idx=_jax_hypotheses(key, valid, 64), iterations=64,
    )
    np.testing.assert_array_equal(to_numpy(tres.inliers), to_numpy(jres.inliers))
    assert int(tres.n_inliers) == int(jres.n_inliers) == 16 - n_outliers - n_invalid
    assert bool(tres.ok) and bool(jres.ok)
    np.testing.assert_allclose(to_numpy(tres.h), to_numpy(jres.h), rtol=1e-4, atol=1e-5)


def test_drawn_hypotheses_are_distinct_valid_points():
    valid = torch.zeros(16, dtype=torch.bool)
    valid[[1, 4, 5, 9, 11, 15]] = True
    gen = torch.Generator().manual_seed(0)
    idx = th.draw_hypotheses(valid, 256, gen)
    assert idx.shape == (256, 4)
    assert bool(valid[idx].all())
    assert all(len(set(row.tolist())) == 4 for row in idx)
    # every valid point is drawn about equally often
    counts = torch.bincount(idx.reshape(-1), minlength=16)[valid]
    assert counts.min() > 0.7 * counts.float().mean()


def _homographies():
    rng = np.random.default_rng(3)
    out = [np.eye(3, dtype=np.float32)]  # the pure-rotation (1-solution) case
    for _ in range(4):
        r = np.asarray(jr.matrix_from_quat(jnp.asarray(
            np.r_[rng.normal(0, 0.05, 3), 1.0].astype(np.float32))))
        t = rng.normal(0, 0.05, 3)
        n = np.array([0.0, 0.0, 1.0]) + rng.normal(0, 0.05, 3)
        out.append((r + np.outer(t, n / np.linalg.norm(n))).astype(np.float32))
    return out


@pytest.mark.parametrize("k", range(5))
def test_decompose_homography_parity(k):
    h = _homographies()[k]
    j, t = run_both(jh.decompose_homography, th.decompose_homography, h)
    assert int(t[3]) == int(j[3]) == (1 if k == 0 else 4)
    for a, b in zip(t[:3], j[:3]):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def test_get_inliers_parity():
    rng = np.random.default_rng(4)
    shifts = np.r_[rng.normal(5, 2, (10, 2)), rng.normal(-30, 2, (6, 2))].astype(np.float32)
    valid = np.ones(16, bool)
    valid[[0, 12]] = False
    j, t = run_both(lambda s, v: jm.get_inliers(s, v, 15.0),
                    lambda s, v: tm.get_inliers(s, v, 15.0), shifts, valid)
    np.testing.assert_array_equal(t, j)


def _rt_args(seed, n_nan):
    rng = np.random.default_rng(seed)
    shifts = np.tile(np.array([[-8.4, 5.25]], np.float32), (16, 1))
    shifts += rng.normal(0, 0.05, shifts.shape).astype(np.float32)
    shifts[rng.choice(16, n_nan, replace=False)] = np.nan
    rate = np.array([0.01, -0.02, 0.005, 1.0], np.float32)
    rate /= np.linalg.norm(rate)
    return (
        shifts, np.float32(2.0), np.float32(0.05), np.float32(16.0), CAM, DIST,
        np.array([0.0, 0.0, 0.0, 1.0], np.float32), rate,
    ), np.isfinite(shifts).all(-1)


@pytest.mark.parametrize("seed,n_nan", [(0, 0), (1, 4), (2, 9)])
def test_get_rt_with_jax_draws(seed, n_nan):
    args, valid = _rt_args(seed, n_nan)
    key = jax.random.PRNGKey(seed)
    kw = dict(frame_size=256, patch=64, shifted_pts_thr=8)
    jres = jm.get_rt(*(jnp.asarray(a) for a in args), key, **kw)
    targs = [torch.from_numpy(np.array(a)) for a in args]
    targs[3] = float(args[3])
    tres = tm.get_rt(*targs, hyp_idx=_jax_hypotheses(key, valid, 512), **kw)
    assert bool(tres.ok) == bool(jres.ok) == (n_nan <= 8)
    assert int(tres.n_inliers) == int(jres.n_inliers)
    assert bool(tres.ang_diff_rejected) == bool(jres.ang_diff_rejected)
    np.testing.assert_allclose(to_numpy(tres.tran), to_numpy(jres.tran), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(to_numpy(tres.rot), to_numpy(jres.rot), atol=1e-4, rtol=1e-4)
