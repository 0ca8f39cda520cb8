"""Consensus means and bounding filters (``src/utilityFunctions.cpp``).

Port of :mod:`mrs_optic_flow_tpu.filters.allsac`: ``rotate_2d``,
``point_mean``, ``allsac_mean`` and its scalar variant ``allsac_mean_1d``,
``ransac_mean``, ``bound_abs_mask`` and ``bound_radius_mask``.  "Allsac" is the reference's
deterministic RANSAC: it scores every pair of points
(``src/utilityFunctions.cpp:58-95``).  All functions take a validity mask
instead of removing NaN points (``removeNanPoints``, ``:245-263``), so the
shapes stay fixed and nothing is read back to the host.

``ransac_mean`` takes its random draws as an input (``draws``), or makes
them with a ``torch.Generator``: the JAX function's ``jax.random.choice``
bits cannot be reproduced in PyTorch, so the tests hand both the same draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rotate_2d(pts: torch.Tensor, alpha) -> torch.Tensor:
    """Rotate ``[..., 2]`` points by ``alpha`` [rad] (``src/utilityFunctions.cpp:4-22``)."""
    alpha = torch.as_tensor(alpha, dtype=pts.dtype, device=pts.device)
    c, s = torch.cos(alpha), torch.sin(alpha)
    x, y = pts[..., 0], pts[..., 1]
    return torch.stack([x * c - y * s, x * s + y * c], dim=-1)


def point_mean(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """NaN-aware mean ``[2]`` (``pointMean``, ``src/utilityFunctions.cpp:26-44``):
    the mean over valid points, or (NaN, NaN) if there is none."""
    w = valid.to(pts.dtype)
    n = w.sum()
    m = (pts * w[..., None]).sum(dim=0) / torch.clamp(n, min=1.0)
    return torch.where(n > 0, m, torch.full_like(m, float("nan")))


def _row(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[i]`` for a 0-dim index tensor, on its device: indexing with a
    0-dim tensor reads the index back to the host first."""
    return t.index_select(0, i.reshape(1))[0]


def allsac_mean(
    pts: torch.Tensor, valid: torch.Tensor, threshold_radius_sq: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-pairs consensus mean (``allsacMean``, ``src/utilityFunctions.cpp:58-95``).

    For every pair (i, j), j >= i, take the two-point mean and count the
    valid points closer than ``threshold_radius_sq`` (squared distance); the
    pair with the most wins, ties to the earliest pair in (i, j) scan order
    (the reference's strict ``>``), and the result is the mean of its
    consensus set.  With <= 2 valid points the plain mean is returned
    (``:60-62``).  Returns ``(mean [2], chosen_count)``."""
    n = pts.shape[0]
    pts_f = torch.where(valid[:, None], pts, torch.zeros((), dtype=pts.dtype, device=pts.device))
    mid = 0.5 * (pts_f[:, None, :] + pts_f[None, :, :])  # [n, n, 2]
    upper = torch.ones((n, n), dtype=torch.bool, device=pts.device).triu()
    pair_ok = valid[:, None] & valid[None, :] & upper
    d2 = ((mid[:, :, None, :] - pts_f[None, None, :, :]) ** 2).sum(dim=-1)
    members = (d2 < threshold_radius_sq) & valid[None, None, :]  # [n, n, k]
    counts = torch.where(pair_ok, members.sum(dim=-1), -1).reshape(-1)
    best = torch.argmax(counts)  # the first maximum in scan order
    consensus = point_mean(pts_f, _row(members.reshape(n * n, n), best))
    n_valid = valid.sum()
    few = n_valid <= 2
    mean = torch.where(few, point_mean(pts_f, valid), consensus)
    return mean, torch.where(few, n_valid, _row(counts, best))


def allsac_mean_1d(
    vals: torch.Tensor, valid: torch.Tensor, threshold_radius: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scalar variant of :func:`allsac_mean` (``src/utilityFunctions.cpp:105-142``):
    every pair's midpoint counts the valid values within ``threshold_radius``
    (absolute distance), the first best pair in scan order wins.  With <= 2
    valid values the plain mean, and with none NaN (the reference's
    ``calcMean`` of an empty vector is 0/0).  Returns ``(mean [], chosen_count)``."""
    n = vals.shape[0]
    v = torch.where(valid, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
    mid = 0.5 * (v[:, None] + v[None, :])
    upper = torch.ones((n, n), dtype=torch.bool, device=vals.device).triu()
    pair_ok = valid[:, None] & valid[None, :] & upper
    members = ((mid[:, :, None] - v[None, None, :]).abs() < threshold_radius) & valid[None, None, :]
    counts = torch.where(pair_ok, members.sum(dim=-1), -1).reshape(-1)
    best = torch.argmax(counts)  # the first maximum in scan order
    w = _row(members.reshape(n * n, n), best).to(v.dtype)
    consensus = (v * w).sum() / torch.clamp(w.sum(), min=1.0)
    n_valid = valid.sum()
    fallback = torch.where(n_valid > 0, (v * valid).sum() / torch.clamp(n_valid, min=1),
                           torch.full_like(consensus, float("nan")))
    few = n_valid <= 2
    return torch.where(few, fallback, consensus), torch.where(few, n_valid, _row(counts, best))


def draw_indices(
    valid: torch.Tensor, num_of_chosen: int, num_of_iterations: int,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """``[num_of_iterations, num_of_chosen]`` point indices drawn with
    replacement, each valid point equally likely (the reference's
    ``rand() % size`` over the NaN-free points, ``:194``)."""
    cdf = torch.cumsum(valid.to(torch.float32), dim=0)
    u = torch.rand((num_of_iterations, num_of_chosen), generator=generator,
                   device=valid.device) * cdf[-1]
    idx = torch.searchsorted(cdf, u, right=True)
    return torch.clamp(idx, max=valid.shape[0] - 1)


def ransac_mean(
    pts: torch.Tensor,
    valid: torch.Tensor,
    threshold_radius_sq: float,
    *,
    num_of_chosen: int = 2,
    num_of_iterations: int = 50,
    generator: Optional[torch.Generator] = None,
    draws: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Randomized consensus mean (``ransacMean``,
    ``src/utilityFunctions.cpp:182-216``): each hypothesis is the mean of
    ``num_of_chosen`` points drawn with replacement; the one with the most
    valid points within the threshold wins (first on ties) and the result is
    the mean of its consensus set.  With ``<= num_of_chosen`` valid points
    the plain mean.  ``draws`` ``[num_of_iterations, num_of_chosen]`` gives
    the hypotheses' indices; without it they come from ``generator``."""
    if draws is None:
        draws = draw_indices(valid, num_of_chosen, num_of_iterations, generator)
    pts_f = torch.where(valid[:, None], pts, torch.zeros((), dtype=pts.dtype, device=pts.device))
    centers = pts_f[draws].mean(dim=1)  # [iters, 2]
    d2 = ((pts_f[None, :, :] - centers[:, None, :]) ** 2).sum(dim=-1)
    members = (d2 < threshold_radius_sq) & valid[None, :]
    best = torch.argmax(members.sum(dim=-1))
    consensus = point_mean(pts_f, _row(members, best))
    return torch.where(valid.sum() <= num_of_chosen, point_mean(pts_f, valid), consensus)


def bound_abs_mask(pts: torch.Tensor, bound) -> torch.Tensor:
    """``|p| < bound`` (``getOnlyInAbsBound``, ``src/utilityFunctions.cpp:218-231``):
    the absolute value of ``[n]`` scalars, or the norm of ``[..., 2]`` points."""
    if pts.ndim == 1:
        return pts.abs() < bound
    return (pts * pts).sum(dim=-1) < bound * bound


def bound_radius_mask(pts: torch.Tensor, expected, radius) -> torch.Tensor:
    """Distance from ``expected`` below ``radius``
    (``getOnlyInRadiusFromExpected``, ``src/utilityFunctions.cpp:265-281``)."""
    expected = torch.as_tensor(expected, dtype=pts.dtype, device=pts.device)
    return ((pts - expected) ** 2).sum(dim=-1) < radius * radius
