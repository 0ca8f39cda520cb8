"""Batched getRT: the whole chain over a batch of frame pairs in one set of
launches (port of :mod:`mrs_optic_flow_tpu.geometry.batched`).

Only the RANSAC stage is this module's own; the points before it and the
decomposition and solution selection after it are the ones the per-pair
:func:`~.motion.get_rt` runs (:func:`~.motion.rt_points`,
:func:`~.motion.rt_solution`), so both have the same semantics and gates.
The stage follows the JAX package's batched function:

- The RANSAC draws of the whole batch are ONE Gumbel tensor ``[iterations,
  P, B]``; each hypothesis takes the top 4 of its column by four rounds of
  argmax and mask, so ties go to the lowest index and the four indices keep
  that order.  The tensor is injectable (``gumbel=``); without it it is
  drawn from ``generator`` on the device.
- The 4-point hypotheses are the exact projective solve normalized by their
  largest entry (not h22 as the per-pair solver does): that keeps genuine
  projection denominators clear of the 1e-12 clamp at long focal lengths,
  and it is what the consensus scores of the JAX function see.
- The one-hot sums of the JAX function (``sel``, ``oh_best``) are exact
  selections; here they are gathers, so no ``[I, 4, P, B]`` temporary
  exists.

The hypotheses keep the batch last, as the JAX function does (on the card
that makes every elementwise pass and every reduction over points read
consecutive samples); the refit runs batch-first.  Nothing here reads a
value back to the host, so a caller can keep several batches in flight.
Batched get2DT is :func:`~.motion.get_2dt_batch`.

Reference citations as in ``motion.py``: getRT ``src/optic_flow.cpp:515-774``,
RANSAC ``:558``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Union

import torch

from mrs_optic_flow_tpu_torch.geometry.homography import _dlt_rows, _solve_h_qr_null
from mrs_optic_flow_tpu_torch.geometry.motion import GetRTResult, rt_points, rt_solution

# ---------------------------------------------------------------------------
# the batched RANSAC stage
# ---------------------------------------------------------------------------


def _h4_b(xs: List[torch.Tensor], ys, us, vs) -> torch.Tensor:
    """Exact homography from 4 point pairs: four ``[I, B]`` components per
    coordinate -> h ``[I, 9, B]`` (row-major, up to scale), by the
    division-free projective canonical-basis method ``H = H_dst adj(H_src)``
    (``homography._solve_h4``), normalized by its largest absolute entry."""

    def _side(a, b):
        a1, a2, a3, a4 = a
        b1, b2, b3, b4 = b

        def det(pa, pb, qa, qb, ra, rb):
            # | pa qa ra ; pb qb rb ; 1 1 1 |
            return pa * (qb - rb) + qa * (rb - pb) + ra * (pb - qb)

        d1 = det(a4, b4, a2, b2, a3, b3)
        d2 = det(a1, b1, a4, b4, a3, b3)
        d3 = det(a1, b1, a2, b2, a4, b4)
        return [[d1 * a1, d2 * a2, d3 * a3], [d1 * b1, d2 * b2, d3 * b3], [d1, d2, d3]]

    hs = _side(xs, ys)
    hd = _side(us, vs)
    adj = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            r1, r2 = (r for r in range(3) if r != j)  # adj[i][j] = cof[j][i]
            c1, c2 = (c for c in range(3) if c != i)
            minor = hs[r1][c1] * hs[r2][c2] - hs[r1][c2] * hs[r2][c1]
            adj[i][j] = minor if (i + j) % 2 == 0 else -minor
    rows = [
        hd[i][0] * adj[0][j] + hd[i][1] * adj[1][j] + hd[i][2] * adj[2][j]
        for i in range(3)
        for j in range(3)
    ]
    h = torch.stack(rows, dim=1)  # [I, 9, B]
    scale = torch.amax(h.abs(), dim=1, keepdim=True)
    return h / torch.where(scale > 0.0, scale, 1.0)


def _project_err2_b(h, ax, ay, bx, by):
    """Forward reprojection squared error: h ``[I, 9, B]`` against point
    components ``[P, B]`` -> err2 ``[I, P, B]``."""

    def hc(i):
        return h[:, i, None, :]  # [I, 1, B]

    d = hc(6) * ax + hc(7) * ay + hc(8)
    d = torch.where(d.abs() > 1e-12, d, 1e-12)
    u = (hc(0) * ax + hc(1) * ay + hc(2)) / d
    v = (hc(3) * ax + hc(4) * ay + hc(5)) / d
    return (u - bx) ** 2 + (v - by) ** 2


def draw_gumbel(iterations: int, p: int, b: int, device, generator=None) -> torch.Tensor:
    """Standard Gumbel draws ``[iterations, p, b]`` float32 from ``generator``
    on ``device`` (the distribution of ``jax.random.gumbel``)."""
    u = torch.rand((iterations, p, b), generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


def gumbel_top4(gumbel: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The hypotheses' point indices ``[I, 4, B]``: per (iteration, sample)
    the 4 largest draws among the valid points, by four rounds of argmax and
    mask (ties to the lowest index, in that order) -- uniform sampling of 4
    distinct valid points, as ``jax.random.choice(p=valid)``."""
    g = torch.where(valid[None], gumbel, -math.inf)
    picks = []
    for _ in range(4):
        top = torch.argmax(g, dim=1)  # [I, B]
        picks.append(top)
        g.scatter_(1, top[:, None, :], -math.inf)
    return torch.stack(picks, dim=1)


def _ransac_h_b(ax, ay, bx, by, valid, gumbel, threshold: float):
    """RANSAC homography over the batch.  ``ax/ay`` ``[P, 1]`` (shared grid)
    or ``[P, B]``; ``bx/by/valid`` ``[P, B]``; ``gumbel`` ``[I, P, B]``.
    Returns (h ``[B, 3, 3]``, n_inliers ``[B]`` int32, ok ``[B]``)."""
    p, b = bx.shape
    zero = torch.zeros((), dtype=bx.dtype, device=bx.device)
    bxv = torch.where(valid, bx, zero)
    byv = torch.where(valid, by, zero)
    axv = torch.where(valid, ax.expand(p, b), zero)
    ayv = torch.where(valid, ay.expand(p, b), zero)

    top4 = gumbel_top4(gumbel, valid)

    def sel(comp):  # [P, B] -> four [I, B]
        return [comp.gather(0, top4[:, k]) for k in range(4)]

    hs = _h4_b(sel(axv), sel(ayv), sel(bxv), sel(byv))  # [I, 9, B]
    err2 = _project_err2_b(hs, axv, ayv, bxv, byv)
    inls = (err2 < threshold * threshold) & valid[None]  # [I, P, B]
    counts = inls.sum(dim=1)  # [I, B]
    best = torch.argmax(counts, dim=0)  # [B]
    inliers = inls.gather(0, best[None, None, :].expand(1, p, b))[0]  # [P, B]
    n_inl = counts.gather(0, best[None])[0].to(torch.int32)
    h_seed = hs.gather(0, best[None, None, :].expand(1, 9, b))[0]  # [9, B]

    src = torch.stack([axv.T, ayv.T], dim=-1)  # [B, P, 2]
    dst = torch.stack([bxv.T, byv.T], dim=-1)
    a_full = _dlt_rows(src, dst, inliers.T.to(bx.dtype))  # [B, 2P, 9]
    h = _solve_h_qr_null(a_full, h_seed.T.reshape(b, 3, 3))
    ok = n_inl >= 4
    eye = torch.eye(3, dtype=h.dtype, device=h.device)
    return torch.where(ok[:, None, None], h, eye), n_inl, ok


# ---------------------------------------------------------------------------
# the full chain
# ---------------------------------------------------------------------------


def get_rt_batch(
    shifts: torch.Tensor,  # [B, P, 2]
    heights: torch.Tensor,  # [B]
    dts: torch.Tensor,  # [B]
    ul_corner_x: Union[float, torch.Tensor],  # scalar or [B]
    camera_matrix: torch.Tensor,  # [3, 3]
    dist_coeffs: Optional[torch.Tensor],  # [5], or None for a distortion-free camera
    c2b_quat: torch.Tensor,  # [4]
    ang_rate_quats: torch.Tensor,  # [B, 4]
    *,
    frame_size: int,
    patch: int,
    shifted_pts_thr: int = 8,
    ransac_threshold: float = 0.01,
    ransac_iterations: int = 512,
    gumbel: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> GetRTResult:
    """Batched ``getRT``: ``[B, P, 2]`` pixel shifts -> a :class:`GetRTResult`
    of ``[B]``-leading fields, with the semantics of the per-pair
    :func:`~.motion.get_rt`: ``ok`` needs a finite ``1/dt``, at least
    ``shifted_pts_thr`` valid windows and RANSAC inliers, a solution, the
    pi/4 gate on multi-solution results and finite outputs; ``tran`` and
    ``rot`` are NaN where not ok.

    ``ul_corner_x`` may be one crop offset or one per sample (``[B]``,
    honoured per sample).  ``dist_coeffs=None`` skips the undistortion
    iterations.  ``gumbel`` ``[ransac_iterations, P, B]`` gives the RANSAC
    draws as they are (the JAX function draws them as
    ``jax.random.gumbel(keys[0], (I, P, B))``); without it they come from
    ``generator`` (a ``torch.Generator`` on the shifts' device, or that
    device's default generator).  No value is read back to the host.
    """
    b, p = shifts.shape[:2]
    ax, ay, bx, by, valid, ok = rt_points(
        shifts, dts, ul_corner_x, camera_matrix, dist_coeffs,
        frame_size=frame_size, patch=patch, shifted_pts_thr=shifted_pts_thr,
    )
    if gumbel is None:
        gumbel = draw_gumbel(ransac_iterations, p, b, shifts.device, generator)
    elif tuple(gumbel.shape) != (ransac_iterations, p, b):
        raise ValueError(f"gumbel has shape {tuple(gumbel.shape)}, expected "
                         f"{(ransac_iterations, p, b)}")
    h, n_inl, h_ok = _ransac_h_b(ax, ay, bx, by, valid, gumbel, ransac_threshold)
    return rt_solution(h, h_ok, n_inl, ok, heights, dts, c2b_quat, ang_rate_quats,
                       shifted_pts_thr=shifted_pts_thr)
