"""Consensus means of the block-matching node path (``src/utilityFunctions.cpp``).

Port of ``point_mean``, ``allsac_mean`` and ``ransac_mean`` from
:mod:`mrs_optic_flow_tpu.filters.allsac`.  "Allsac" is the reference's
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


def point_mean(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """NaN-aware mean ``[2]`` (``pointMean``, ``src/utilityFunctions.cpp:26-44``):
    the mean over valid points, or (NaN, NaN) if there is none."""
    w = valid.to(pts.dtype)
    n = w.sum()
    m = (pts * w[..., None]).sum(dim=0) / torch.clamp(n, min=1.0)
    return torch.where(n > 0, m, torch.full_like(m, float("nan")))


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
    consensus = point_mean(pts_f, members.reshape(n * n, n)[best])
    n_valid = valid.sum()
    few = n_valid <= 2
    mean = torch.where(few, point_mean(pts_f, valid), consensus)
    return mean, torch.where(few, n_valid, counts[best])


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
    consensus = point_mean(pts_f, members[best])
    return torch.where(valid.sum() <= num_of_chosen, point_mean(pts_f, valid), consensus)
