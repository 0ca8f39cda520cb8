"""Motion decomposition: pixel shifts -> camera-frame (rotation rate,
velocity).  Port of :mod:`mrs_optic_flow_tpu.geometry.motion`
(``OpticFlow::getRT``, ``src/optic_flow.cpp:515-774``, ``get2DT``,
``:388-510``, and ``getInliers``, ``:335-358``), with the reference's
data-dependent control flow replaced by masked fixed-shape math, so a whole
frame stays on the device.

Each chain has one implementation, batch-first: :func:`get_2dt_batch`, and
getRT's points (:func:`rt_points`) and its decomposition and solution
selection (:func:`rt_solution`).  The per-pair :func:`get_rt` and
:func:`get_2dt` are their one-sample case; only the RANSAC stage differs
between :func:`get_rt` (:func:`~.homography.find_homography_ransac`) and the
batched :func:`~.batched.get_rt_batch`.  Nothing here reads a value back to
the host or builds a constant from it.

The documented deviations of the JAX module carry over: the rotation axis is
rotated into the body frame without the camera->base translation
(deviation 1), the dead "no motion" branch is absent (2), ``get2DT`` uses
the raw pixel shifts (3), its rate feed-forward axis map is rebuilt
(ARCHITECTURE.md deviation 21), and the post-RANSAC inlier count is gated at
``shifted_pts_thr`` (24).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch

from mrs_optic_flow_tpu_torch.geometry.homography import decompose_homography, find_homography_ransac
from mrs_optic_flow_tpu_torch.geometry.rotations import (
    quat_angle,
    quat_axis_angle,
    quat_from_axis_angle,
    quat_from_matrix,
    quat_inverse,
    quat_rotate,
)
from mrs_optic_flow_tpu_torch.geometry.undistort import undistort_xy

#: ratio-2 long-range mutual-agreement gate in px, ``LONGRANGE_INLIER_THRESHOLD``
#: (``src/optic_flow.cpp:34``, used at ``:456`` with a strict ``<``)
LONGRANGE_INLIER_THRESHOLD = 15.0


def grid_centers_xy(frame_size: int, patch: int, device, dtype) -> tuple:
    """Patch-grid centre pixels as ``(x [P], y [P])`` on ``device``, field
    order ``i + q*j`` (``src/optic_flow.cpp:538-540``), made there so that no
    host copy is needed."""
    q = frame_size // patch
    c = torch.arange(q, dtype=dtype, device=device) * patch + patch // 2
    return c[None, :].expand(q, q).reshape(-1), c[:, None].expand(q, q).reshape(-1)


def get_inliers(shifts: torch.Tensor, valid: torch.Tensor, threshold: float) -> torch.Tensor:
    """Largest mutual-agreement inlier set (``src/optic_flow.cpp:335-358``):
    shifts ``[..., P, 2]`` and ``valid`` ``[..., P]`` -> the bool mask
    ``[..., P]`` of the point whose ``threshold`` neighbourhood is largest."""
    d2 = torch.sum((shifts[..., :, None, :] - shifts[..., None, :, :]) ** 2, dim=-1)
    near = (d2 < threshold * threshold) & valid[..., None, :] & valid[..., :, None]
    counts = torch.where(valid, near.sum(dim=-1), -1)
    centre = torch.argmax(counts, dim=-1, keepdim=True)[..., None]  # [..., 1, 1]
    return near.gather(-2, centre.expand(centre.shape[:-1] + near.shape[-1:]))[..., 0, :]


class GetRTResult(NamedTuple):
    ok: torch.Tensor  # 0-dim bool ([B] batched)
    rot: torch.Tensor  # [4] quaternion (x,y,z,w): axis + angle/dt
    tran: torch.Tensor  # [3] camera-frame velocity [m/s]
    n_inliers: torch.Tensor  # 0-dim int
    ang_diff: torch.Tensor  # 0-dim: best IMU-consistency angle [rad]
    #: a solution was found, the homography had several, and the best angle
    #: exceeds pi/4 (the reference's warning, src/optic_flow.cpp:682-684)
    ang_diff_rejected: torch.Tensor


def rt_points(
    shifts: torch.Tensor,  # [B, P, 2]
    dts: torch.Tensor,  # [B]
    ul_corner_x: Union[float, torch.Tensor],  # scalar or [B]
    camera_matrix: torch.Tensor,
    dist_coeffs: Optional[torch.Tensor],
    *,
    frame_size: int,
    patch: int,
    shifted_pts_thr: int,
):
    """getRT up to RANSAC, batch last: the grid centres and their shifted
    positions, undistorted with ``cx -= ulCorner.x`` (``:524``), as
    components ``(ax, ay, bx, by)``, the valid windows ``[P, B]`` and the
    ``[B]`` gate on a finite ``1/dt`` and ``shifted_pts_thr`` valid windows.
    ``ax``/``ay`` are ``[P, 1]`` for one crop offset and ``[P, B]`` for one a
    sample (never sliced to sample 0); ``bx``/``by`` are ``[P, B]``."""
    sx = shifts[..., 0].T  # [P, B]
    sy = shifts[..., 1].T
    valid = torch.isfinite(sx) & torch.isfinite(sy)
    sx = torch.where(valid, sx, 0.0)
    sy = torch.where(valid, sy, 0.0)
    cx_grid, cy_grid = grid_centers_xy(frame_size, patch, shifts.device, shifts.dtype)
    cxs, cys = cx_grid[:, None], cy_grid[:, None]  # [P, 1]
    fx, fy = camera_matrix[0, 0], camera_matrix[1, 1]
    ccx = camera_matrix[0, 2] - ul_corner_x  # [] or [B]
    ccy = camera_matrix[1, 2]
    ok = torch.isfinite(1.0 / dts) & (valid.sum(dim=0) >= shifted_pts_thr)
    ax, ay = undistort_xy(cxs, cys, fx, fy, ccx, ccy, dist_coeffs)
    bx, by = undistort_xy(cxs + sx, cys + sy, fx, fy, ccx, ccy, dist_coeffs)
    return ax, ay, bx, by, valid, ok


def rt_solution(
    h: torch.Tensor,  # [B, 3, 3]
    h_ok: torch.Tensor,  # [B]
    n_inliers: torch.Tensor,  # [B]
    ok: torch.Tensor,  # [B], from rt_points
    heights: torch.Tensor,  # [B]
    dts: torch.Tensor,  # [B]
    c2b_quat: torch.Tensor,  # [4]
    ang_rate_quats: torch.Tensor,  # [B, 4]
    *,
    shifted_pts_thr: int,
) -> GetRTResult:
    """getRT after RANSAC, batch first: Malis-Vargas decomposition -> the
    solution whose rotation rate is closest to the IMU rate (both quaternion
    covers, ``src/optic_flow.cpp:630-671``) -> pi/4 gate on the
    multi-solution path -> ``v = R (+-t) * height / dt``; NaN where not
    ok."""
    b = h.shape[0]
    ok = ok & h_ok & (n_inliers >= shifted_pts_thr)  # deviation 24
    dec = decompose_homography(h)

    axes, angles = quat_axis_angle(quat_from_matrix(dec.rotations))  # [B, 4, 3], [B, 4]
    axes_b = quat_rotate(c2b_quat, axes)  # deviation 1: rotation only
    q_rate_b = quat_from_axis_angle(axes_b, angles / dts[:, None])
    rate = ang_rate_quats[:, None, :]
    ang_diffs = torch.minimum(quat_angle(q_rate_b, rate), quat_angle(q_rate_b, quat_inverse(rate)))
    usable = torch.arange(4, device=h.device)[None, :] < dec.n_solutions[:, None]
    ang_diffs = torch.where(usable, ang_diffs, math.pi + 1.0)
    best = torch.argmin(ang_diffs, dim=1)  # [B]
    best_diff = ang_diffs.gather(1, best[:, None])[:, 0]
    found = best_diff < math.pi  # bestIndex stays -1 otherwise (strict <, :665)
    ok &= found

    multi = dec.n_solutions > 1
    ang_diff_rejected = found & multi & (best_diff > math.pi / 4)
    ok &= ~multi | (best_diff <= math.pi / 4)  # pi/4 gate (:682-684)

    def pick(x):  # [B, 4, ...] -> [B, ...] at the best solution
        idx = best.reshape((b, 1) + (1,) * (x.ndim - 2)).expand((b, 1) + x.shape[2:])
        return x.gather(1, idx)[:, 0]

    # inverseSolution <=> n_z >= 0 (:657-660); t flips on the multi path only
    inverse_sol = pick(dec.normals)[:, 2] >= 0.0
    inv_unit = torch.where(multi & inverse_sol, -1.0, 1.0).to(h.dtype)
    t_best = inv_unit[:, None] * pick(dec.translations)
    tran = torch.sum(pick(dec.rotations) * t_best[:, None, :], dim=-1) * (heights / dts)[:, None]
    rot = quat_from_axis_angle(pick(axes), pick(angles) / dts)

    ok &= torch.isfinite(tran).all(dim=-1) & torch.isfinite(rot).all(dim=-1)
    return GetRTResult(
        ok=ok,
        rot=torch.where(ok[:, None], rot, math.nan),
        tran=torch.where(ok[:, None], tran, math.nan),
        n_inliers=n_inliers,
        ang_diff=best_diff,
        ang_diff_rejected=ang_diff_rejected,
    )


def _one(x, like: torch.Tensor) -> torch.Tensor:
    """A per-pair scalar as a ``[1]`` tensor on ``like``'s device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device).reshape(1)


def get_rt(
    shifts: torch.Tensor,
    height: torch.Tensor,
    dt: torch.Tensor,
    ul_corner_x: float,
    camera_matrix: torch.Tensor,
    dist_coeffs: torch.Tensor,
    c2b_quat: torch.Tensor,
    ang_rate_quat: torch.Tensor,
    *,
    frame_size: int,
    patch: int,
    generator: Optional[torch.Generator] = None,
    hyp_idx: Optional[torch.Tensor] = None,
    shifted_pts_thr: int = 8,
    ransac_threshold: float = 0.01,
    ransac_iterations: int = 512,
) -> GetRTResult:
    """``getRT`` of one pair: grid centres + NaN mask -> local camera matrix
    with ``cx -= ulCorner.x`` -> undistort -> RANSAC homography ->
    Malis-Vargas decomposition -> the solution whose rotation rate is
    closest to the IMU rate (both quaternion covers) -> pi/4 gate on the
    multi-solution path -> ``v = R (+-t) * height / dt``.
    ``generator``/``hyp_idx`` feed the RANSAC draws (see
    :func:`find_homography_ransac`).  The one-pair case of
    :func:`rt_points` and :func:`rt_solution`."""
    dt1 = _one(dt, shifts)
    ax, ay, bx, by, valid, ok = rt_points(
        shifts[None], dt1, ul_corner_x, camera_matrix, dist_coeffs,
        frame_size=frame_size, patch=patch, shifted_pts_thr=shifted_pts_thr,
    )
    hres = find_homography_ransac(
        torch.stack([ax[:, 0], ay[:, 0]], dim=-1), torch.stack([bx[:, 0], by[:, 0]], dim=-1),
        valid[:, 0], generator=generator, hyp_idx=hyp_idx,
        threshold=ransac_threshold, iterations=ransac_iterations,
    )
    res = rt_solution(
        hres.h[None], hres.ok.reshape(1), hres.n_inliers.reshape(1), ok, _one(height, shifts), dt1,
        c2b_quat, ang_rate_quat[None], shifted_pts_thr=shifted_pts_thr,
    )
    return GetRTResult(*(x[0] for x in res))


class Get2DTResult(NamedTuple):
    ok: torch.Tensor  # 0-dim bool ([B] batched)
    tran: torch.Tensor  # [3] camera-frame velocity [m/s] (z = 0)
    tran_diff: torch.Tensor  # [3] the rate correction's second addition


def get_2dt_batch(
    shifts: torch.Tensor,  # [B, P, 2]
    heights: torch.Tensor,  # [B]
    dts: torch.Tensor,  # [B]
    camera_matrix: torch.Tensor,
    roll_rates: torch.Tensor,  # [B]
    pitch_rates: torch.Tensor,  # [B]
    cam_yaw: Union[float, torch.Tensor],
    *,
    long_range_ratio: int = 4,
) -> Get2DTResult:
    """``get2DT``, long-range mode, over a batch: the long-range grid's raw
    pixel shifts ``[B, P, 2]`` -> one camera-frame velocity a pair, fields
    ``[B]``-leading (the JAX pipeline vmaps its per-pair function).

    Ratio 2: at least 3 valid shifts, the mutual-agreement inliers within
    ``LONGRANGE_INLIER_THRESHOLD`` (:func:`get_inliers`), at least 3 of
    them, averaged (``:414-421``, ``:452-467``).  Any other ratio: the first
    valid shift (``:423-427``, ``:470``).  Then the roll/pitch-rate
    feed-forward ``corr = (fx tan(w_y dt), -fy tan(w_x dt)) / ratio`` with
    the body rates turned into camera rates through the mount yaw
    ``pi/2 - cam_yaw`` (deviation 21; ``cam_yaw`` one number or 0-dim
    tensor for the batch), and ``v = -(shift + corr) * height / f * ratio /
    dt`` (``:491-495``).  ``heights`` must be tilt-corrected by the caller
    (``:1780-1781``).  ``tran_diff`` is the velocity of the reference's
    second addition of ``corr`` (``:486-505``), published as
    ``velocity_out_longrange_diff``.  Both are NaN where ``ok`` is false.

    The JAX function's ``ul_corner_x`` argument, unused there, is left out.
    """
    dtype = shifts.dtype
    b = shifts.shape[0]
    fx, fy = camera_matrix[0, 0], camera_matrix[1, 1]
    mult = float(long_range_ratio)
    valid = torch.all(torch.isfinite(shifts), dim=-1)  # [B, P]
    shifts_f = torch.where(valid[..., None], shifts, 0.0)
    if long_range_ratio == 2:
        ok = torch.isfinite(1.0 / dts) & (valid.sum(dim=-1) >= 3)
        inl = get_inliers(shifts_f, valid, LONGRANGE_INLIER_THRESHOLD)
        ok &= inl.sum(dim=-1) >= 3
        w = inl.to(dtype)
        avg = (shifts_f * w[..., None]).sum(dim=1) / torch.clamp(w.sum(dim=-1), min=1.0)[:, None]
    else:
        ok = torch.isfinite(1.0 / dts) & valid.any(dim=-1)
        first = torch.argmax(valid.to(torch.int32), dim=1)
        avg = shifts_f.gather(1, first[:, None, None].expand(b, 1, 2))[:, 0]

    psi = math.pi / 2 - cam_yaw  # mount yaw (identity mount -> 0)
    trig = (torch.cos, torch.sin) if torch.is_tensor(psi) else (math.cos, math.sin)
    c, s = (f(psi) for f in trig)
    w_cx = c * roll_rates + s * pitch_rates
    w_cy = -s * roll_rates + c * pitch_rates
    corr = torch.stack([torch.tan(w_cy * dts) * fx / mult, -torch.tan(w_cx * dts) * fy / mult], dim=-1)
    scale = torch.stack([heights / fx * mult, heights / fy * mult], dim=-1)
    zero = torch.zeros_like(heights)[:, None]
    tran = -torch.cat([(avg + corr) * scale, zero], dim=-1) / dts[:, None]
    tran_corr = -torch.cat([(avg + 2.0 * corr) * scale, zero], dim=-1) / dts[:, None]
    tran_diff = tran_corr - tran
    return Get2DTResult(
        ok=ok,
        tran=torch.where(ok[:, None], tran, math.nan),
        tran_diff=torch.where(ok[:, None], tran_diff, math.nan),
    )


def get_2dt(
    shifts: torch.Tensor,
    height: torch.Tensor,
    dt: torch.Tensor,
    camera_matrix: torch.Tensor,
    imu_roll_rate: torch.Tensor,
    imu_pitch_rate: torch.Tensor,
    cam_yaw: torch.Tensor,
    *,
    long_range_ratio: int = 4,
) -> Get2DTResult:
    """``get2DT`` of one pair: shifts ``[P, 2]`` -> 0-dim ``ok`` and ``[3]``
    velocities, the one-pair case of :func:`get_2dt_batch`."""
    res = get_2dt_batch(
        shifts[None], _one(height, shifts), _one(dt, shifts), camera_matrix,
        _one(imu_roll_rate, shifts), _one(imu_pitch_rate, shifts), cam_yaw,
        long_range_ratio=long_range_ratio,
    )
    return Get2DTResult(*(x[0] for x in res))
