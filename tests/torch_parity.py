"""Helpers shared by the parity tests of the PyTorch port (not a test module).

The same numpy inputs, made from a seed, go through a JAX function and its
port; both results come back as numpy arrays for comparison.  Torch runs on
one thread: the suite runs under several xdist workers on one host.
"""

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)


def to_numpy(x):
    """A result (array, tensor, or a tuple of them) as numpy arrays."""
    if isinstance(x, tuple):
        return tuple(to_numpy(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def run_both(jax_fn, torch_fn, *np_inputs):
    """``(jax_fn(*inputs), torch_fn(*inputs))`` as numpy, the inputs handed
    to each framework as its own arrays."""
    j = jax_fn(*(jnp.asarray(a) for a in np_inputs))
    t = torch_fn(*(torch.from_numpy(np.array(a)) for a in np_inputs))
    return to_numpy(j), to_numpy(t)


def jax_key_draws(seed=0, key=None):
    """The RANSAC draws of the JAX package's ``ServingLoop`` and
    ``FleetServer`` replayed as a ``draws`` hook of the port's: each call
    splits the key as a dispatch or tick does (``key, sub = split(key);
    keys = split(sub, b)``) and returns ``jax.random.gumbel(keys[0], (i,
    p, b))``, the tensor the JAX ``get_rt_batch`` draws from.  ``key``
    resumes from a saved key (a JAX fleet checkpoint's ``key``);
    ``draws.state[0]`` is the key the next call splits."""
    import jax

    state = [jax.random.PRNGKey(seed) if key is None else jnp.asarray(key)]

    def draws(i, p, b):
        state[0], sub = jax.random.split(state[0])
        keys = jax.random.split(sub, b)
        return torch.from_numpy(np.array(jax.random.gumbel(keys[0], (i, p, b))))

    draws.state = state  # the key the next call splits
    return draws


#: the absolute tolerance on ``tran`` and ``rot`` of a float64 chain, and the
#: floor of :func:`rot_tol`
ATOL = 1e-4
#: one unit in the last place of a float32 just below 1
F32_ULP = 2.0**-24


def rot_tol(rot_ref, dts):
    """Per-sample tolerance of a float32 rate quaternion ``rot`` ``[..., 4]``
    against ``rot_ref``: ``ATOL`` plus the float32 resolution of tf2's axis
    and angle at the sample's own rotation.

    ``rot`` is ``(axis sin(a / 2dt), cos(a / 2dt))`` with the frame's angle
    ``a = 2 acos(w)`` and ``axis = xyz / sqrt(1 - w^2)`` of the frame's
    quaternion.  One ulp of ``w`` moves ``acos(w)`` and ``sqrt(1 - w^2)`` by
    ``ulp / sin(a/2)`` absolute and relative, which moves a component of
    ``rot`` by about ``ulp / (sin(a/2) dt)``; the bound allows two ulps.
    ``sin(a/2)`` is floored at ``sqrt(2 ulp)``, the smallest angle a float32
    ``w`` resolves, so a (near) pure translation gets ``sqrt(2 ulp) / dt``.
    ``a`` comes from ``rot_ref``: ``a / 2 = dt acos(|w_rot|)``.  The float64
    chains agree to 1e-9 (``tests/test_torch_batched_geometry.py::
    test_float64_chains_agree``), so what this bound admits is rounding."""
    rot_ref = np.asarray(rot_ref, np.float64)
    dts = np.broadcast_to(np.asarray(dts, np.float64), rot_ref.shape[:-1])
    w = np.clip(np.abs(np.nan_to_num(rot_ref[..., 3], nan=1.0)), 0.0, 1.0)
    half = np.maximum(np.sin(dts * np.arccos(w)), np.sqrt(2 * F32_ULP))
    res = np.divide(2 * F32_ULP, half * dts, out=np.zeros_like(half), where=dts > 0)
    return ATOL + res


def assert_rot_close(rot, rot_ref, dts):
    """``rot`` within :func:`rot_tol` of ``rot_ref`` sample by sample, NaN
    where and only where ``rot_ref`` is NaN."""
    rot, rot_ref = np.asarray(rot, np.float64), np.asarray(rot_ref, np.float64)
    np.testing.assert_array_equal(np.isnan(rot), np.isnan(rot_ref))
    tol = rot_tol(rot_ref, dts)
    err = np.nan_to_num(np.abs(rot - rot_ref), nan=0.0).max(axis=-1)
    assert (err <= tol).all(), f"rot differs by {err} against a tolerance of {tol}"


def rotated(img, deg):
    """``img`` ``[H, W]`` turned by ``deg`` degrees about its centre (cubic
    spline, periodic at the edges), back in its dtype: rounded and clipped
    for an integer type."""
    import scipy.ndimage as ndi

    out = ndi.rotate(img.astype(np.float32), deg, reshape=False, mode="wrap")
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    return out.astype(img.dtype)
