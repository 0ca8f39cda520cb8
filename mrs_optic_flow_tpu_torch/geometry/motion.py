"""Motion decomposition: pixel shifts -> camera-frame (rotation rate,
velocity).  Port of :mod:`mrs_optic_flow_tpu.geometry.motion`
(``OpticFlow::getRT``, ``src/optic_flow.cpp:515-774``, ``get2DT``,
``:388-510``, and ``getInliers``, ``:335-358``), with the reference's
data-dependent control flow replaced by masked fixed-shape math, so a whole
frame stays on the device.

The documented deviations of the JAX module carry over: the rotation axis is
rotated into the body frame without the camera->base translation
(deviation 1), the dead "no motion" branch is absent (2), ``get2DT`` uses
the raw pixel shifts (3), its rate feed-forward axis map is rebuilt
(ARCHITECTURE.md deviation 21), and the post-RANSAC inlier count is gated at
``shifted_pts_thr`` (24).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mrs_optic_flow_tpu_torch.geometry.homography import (
    _take,
    decompose_homography,
    find_homography_ransac,
)
from mrs_optic_flow_tpu_torch.geometry.rotations import (
    quat_angle,
    quat_axis_angle,
    quat_from_axis_angle,
    quat_from_matrix,
    quat_inverse,
    quat_rotate,
)
from mrs_optic_flow_tpu_torch.geometry.undistort import undistort_points
from mrs_optic_flow_tpu_torch.utils.precision import full_float32

#: ratio-2 long-range mutual-agreement gate in px, ``LONGRANGE_INLIER_THRESHOLD``
#: (``src/optic_flow.cpp:34``, used at ``:456`` with a strict ``<``)
LONGRANGE_INLIER_THRESHOLD = 15.0


def grid_centers(frame_size: int, patch: int) -> np.ndarray:
    """Patch-grid centre pixels ``[P, 2]`` in field order ``i + q*j``
    (``src/optic_flow.cpp:538-540``)."""
    q = frame_size // patch
    i = np.arange(q)
    xs, ys = np.meshgrid(i * patch + patch // 2, i * patch + patch // 2)
    return np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1).astype(np.float32)


def get_inliers(shifts: torch.Tensor, valid: torch.Tensor, threshold: float) -> torch.Tensor:
    """Largest mutual-agreement inlier set (``src/optic_flow.cpp:335-358``):
    the bool mask of the point whose ``threshold`` neighbourhood is largest."""
    d2 = torch.sum((shifts[:, None, :] - shifts[None, :, :]) ** 2, dim=-1)
    near = (d2 < threshold * threshold) & valid[None, :] & valid[:, None]
    counts = torch.where(valid, near.sum(dim=1), -1)
    return _take(near, torch.argmax(counts))


class GetRTResult(NamedTuple):
    ok: torch.Tensor  # 0-dim bool
    rot: torch.Tensor  # [4] quaternion (x,y,z,w): axis + angle/dt
    tran: torch.Tensor  # [3] camera-frame velocity [m/s]
    n_inliers: torch.Tensor  # 0-dim int
    ang_diff: torch.Tensor  # 0-dim: best IMU-consistency angle [rad]
    #: a solution was found, the homography had several, and the best angle
    #: exceeds pi/4 (the reference's warning, src/optic_flow.cpp:682-684)
    ang_diff_rejected: torch.Tensor


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
    """``getRT``: grid centres + NaN mask -> local camera matrix with
    ``cx -= ulCorner.x`` -> undistort -> RANSAC homography -> Malis-Vargas
    decomposition -> the solution whose rotation rate is closest to the IMU
    rate (both quaternion covers) -> pi/4 gate on the multi-solution path ->
    ``v = R (+-t) * height / dt``.  ``generator``/``hyp_idx`` feed the RANSAC
    draws (see :func:`find_homography_ransac`)."""
    dev, dtype = shifts.device, shifts.dtype
    centers = torch.from_numpy(grid_centers(frame_size, patch)).to(dev)
    valid = torch.all(torch.isfinite(shifts), dim=-1)
    shifted = centers + torch.where(valid[:, None], shifts, torch.zeros((), dtype=dtype, device=dev))

    cam_local = camera_matrix.clone()
    cam_local[0, 2] -= ul_corner_x

    ok = torch.isfinite(1.0 / dt)
    ok &= valid.sum() >= shifted_pts_thr

    und_a = undistort_points(centers, cam_local, dist_coeffs)
    und_b = undistort_points(shifted, cam_local, dist_coeffs)
    hres = find_homography_ransac(
        und_a, und_b, valid, generator=generator, hyp_idx=hyp_idx,
        threshold=ransac_threshold, iterations=ransac_iterations,
    )
    ok &= hres.ok
    ok &= hres.n_inliers >= shifted_pts_thr  # deviation 24

    dec = decompose_homography(hres.h)

    # IMU-nearest solution selection (src/optic_flow.cpp:630-671)
    axes, angles = quat_axis_angle(quat_from_matrix(dec.rotations))  # [4, 3], [4]
    axes_b = quat_rotate(c2b_quat[None, :], axes)  # deviation 1: rotation only
    q_rate_b = quat_from_axis_angle(axes_b, angles / dt)
    d_plus = quat_angle(q_rate_b, ang_rate_quat[None, :])
    d_minus = quat_angle(q_rate_b, quat_inverse(ang_rate_quat)[None, :])
    ang_diffs = torch.minimum(d_plus, d_minus)
    usable = torch.arange(4, device=dev) < dec.n_solutions
    ang_diffs = torch.where(usable, ang_diffs, torch.full_like(ang_diffs, math.pi + 1.0))
    best = torch.argmin(ang_diffs)
    best_diff = _take(ang_diffs, best)
    found = best_diff < math.pi  # bestIndex stays -1 otherwise (strict <, :665)
    ok &= found

    multi = dec.n_solutions > 1
    ang_diff_rejected = found & multi & (best_diff > math.pi / 4)
    ok &= ~multi | (best_diff <= math.pi / 4)  # pi/4 gate (:682-684)

    # inverseSolution <=> n_z >= 0 (:657-660); t flips on the multi path only
    inverse_sol = _take(dec.normals, best)[2] >= 0.0
    inv_unit = torch.where(multi & inverse_sol, -1.0, 1.0).to(dtype)
    with full_float32():
        tran = (_take(dec.rotations, best) @ (inv_unit * _take(dec.translations, best))) * height / dt
    rot = quat_from_axis_angle(_take(axes, best), _take(angles, best) / dt)

    ok &= torch.all(torch.isfinite(tran)) & torch.all(torch.isfinite(rot))
    return GetRTResult(
        ok=ok,
        rot=torch.where(ok, rot, torch.full_like(rot, float("nan"))),
        tran=torch.where(ok, tran, torch.full_like(tran, float("nan"))),
        n_inliers=hres.n_inliers,
        ang_diff=best_diff,
        ang_diff_rejected=ang_diff_rejected,
    )


class Get2DTResult(NamedTuple):
    ok: torch.Tensor  # 0-dim bool
    tran: torch.Tensor  # [3] camera-frame velocity [m/s] (z = 0)
    tran_diff: torch.Tensor  # [3] the rate correction's second addition


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
    """``get2DT``, long-range mode: the long-range grid's raw pixel shifts
    ``[P, 2]`` -> one camera-frame velocity.

    Ratio 2: at least 3 valid shifts, the mutual-agreement inliers within
    ``LONGRANGE_INLIER_THRESHOLD`` (:func:`get_inliers`), at least 3 of
    them, averaged (``:414-421``, ``:452-467``).  Any other ratio: the first
    valid shift (``:423-427``, ``:470``).  Then the roll/pitch-rate
    feed-forward ``corr = (fx tan(w_y dt), -fy tan(w_x dt)) / ratio`` with
    the body rates turned into camera rates through the mount yaw
    ``pi/2 - cam_yaw`` (deviation 21), and ``v = -(shift + corr) * height /
    f * ratio / dt`` (``:491-495``).  ``tran_diff`` is the velocity of the
    reference's second addition of ``corr`` (``:486-505``), published as
    ``velocity_out_longrange_diff``.  Both are NaN where ``ok`` is false.

    The JAX function's ``ul_corner_x`` argument, unused there, is left out.
    """
    dtype, dev = shifts.dtype, shifts.device
    fx, fy = camera_matrix[0, 0], camera_matrix[1, 1]
    mult = float(long_range_ratio)
    valid = torch.all(torch.isfinite(shifts), dim=-1)
    shifts_f = torch.where(valid[:, None], shifts, torch.zeros((), dtype=dtype, device=dev))
    if long_range_ratio == 2:
        ok = torch.isfinite(1.0 / dt) & (valid.sum() >= 3)
        inl = get_inliers(shifts_f, valid, LONGRANGE_INLIER_THRESHOLD)
        ok &= inl.sum() >= 3
        w = inl.to(dtype)
        avg = (shifts_f * w[:, None]).sum(dim=0) / torch.clamp(w.sum(), min=1.0)
    else:
        ok = torch.isfinite(1.0 / dt) & valid.any()
        avg = _take(shifts_f, torch.argmax(valid.to(torch.int32)))

    psi = math.pi / 2 - cam_yaw  # mount yaw (identity mount -> 0)
    w_cx = torch.cos(psi) * imu_roll_rate + torch.sin(psi) * imu_pitch_rate
    w_cy = -torch.sin(psi) * imu_roll_rate + torch.cos(psi) * imu_pitch_rate
    corr = torch.stack([torch.tan(w_cy * dt) * fx / mult, -torch.tan(w_cx * dt) * fy / mult])
    scale = torch.stack([height / fx * mult, height / fy * mult])
    zero = torch.zeros((1,), dtype=dtype, device=dev)

    tran = -torch.cat([(avg + corr) * scale, zero]) / dt
    tran_corr = -torch.cat([(avg + 2.0 * corr) * scale, zero]) / dt
    tran_diff = tran_corr - tran
    nan = torch.full((3,), float("nan"), dtype=dtype, device=dev)
    return Get2DTResult(
        ok=ok,
        tran=torch.where(ok, tran, nan),
        tran_diff=torch.where(ok, tran_diff, nan),
    )
