"""Quaternion / rotation-matrix utilities with tf2 conventions (port of
:mod:`mrs_optic_flow_tpu.geometry.rotations`).

Quaternions are ``(x, y, z, w)``; :func:`quat_angle` is tf2's
``Quaternion::angle`` (no double-cover folding); :func:`rpy_from_matrix` is
``tf2::Matrix3x3::getRPY`` solution 1.  All functions broadcast over leading
batch dimensions and run on the device of their inputs.
"""

from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    """tf2 inverse of a unit quaternion: conjugate."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az, aw = torch.unbind(a, dim=-1)
    bx, by, bz, bw = torch.unbind(b, dim=-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion q (tf2 ``quatRotate``)."""
    qv = q[..., :3]
    w = q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """tf2 ``Quaternion(axis, angle)`` — axis is normalized internally."""
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    half = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)[..., None] * 0.5
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def quat_axis_angle(q: torch.Tensor) -> tuple:
    """tf2 ``getAxis()``/``getAngle()``: angle ``2*acos(w)`` in [0, 2*pi),
    unit axis; (1, 0, 0) for near-identity rotations.  Builds no constant
    from the host, so it never waits for the device."""
    q = quat_normalize(q)
    w = torch.clamp(q[..., 3], -1.0, 1.0)
    angle = 2.0 * torch.arccos(w)
    s2 = 1.0 - w * w
    safe = s2 >= 10.0 * torch.finfo(q.dtype).eps
    s = torch.sqrt(torch.where(safe, s2, 1.0))
    axis = torch.stack([
        torch.where(safe, q[..., 0] / s, 1.0),
        torch.where(safe, q[..., 1] / s, 0.0),
        torch.where(safe, q[..., 2] / s, 0.0),
    ], dim=-1)
    return axis, angle


def quat_angle(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """tf2 ``Quaternion::angle``: acos of the normalized dot product."""
    d = torch.sum(a * b, dim=-1) / torch.sqrt(torch.sum(a * a, dim=-1) * torch.sum(b * b, dim=-1))
    return torch.arccos(torch.clamp(d, -1.0, 1.0))


def quat_from_rpy(roll, pitch, yaw) -> torch.Tensor:
    """tf2 ``setRPY`` (fixed-axis XYZ)."""
    hr, hp, hy = (torch.as_tensor(a) * 0.5 for a in (roll, pitch, yaw))
    sr, cr = torch.sin(hr), torch.cos(hr)
    sp, cp = torch.sin(hp), torch.cos(hp)
    sy, cy = torch.sin(hy), torch.cos(hy)
    return torch.stack(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ],
        dim=-1,
    )


def matrix_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix of a unit quaternion (tf2 ``Matrix3x3(q)``)."""
    x, y, z, w = torch.unbind(quat_normalize(q), dim=-1)
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1)
    row1 = torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1)
    row2 = torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def quat_from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Quaternion of a rotation matrix — branch-free Shepperd's method
    (``tf2::Transform::getRotation``, ``src/optic_flow.cpp:639-640``)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    def candidate(pivot, parts):
        root = torch.sqrt(torch.clamp(1.0 + pivot, min=0.0)) / 2.0
        scale = torch.clamp(4.0 * root, min=1e-12)[..., None]
        return torch.stack([p if p is not None else 4.0 * root * root for p in parts], -1) / scale

    tr = m00 + m11 + m22
    q0 = candidate(tr, [m21 - m12, m02 - m20, m10 - m01, None])
    q1 = candidate(m00 - m11 - m22, [None, m01 + m10, m02 + m20, m21 - m12])
    q2 = candidate(m11 - m00 - m22, [m01 + m10, None, m12 + m21, m02 - m20])
    q3 = candidate(m22 - m00 - m11, [m02 + m20, m12 + m21, None, m10 - m01])

    pivots = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cand = torch.stack([q0, q1, q2, q3], dim=-2)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return quat_normalize(torch.gather(cand, -2, idx)[..., 0, :])


def rpy_from_matrix(m: torch.Tensor) -> tuple:
    """tf2 ``Matrix3x3::getRPY`` solution 1; roll and yaw are 0 at the exact
    gimbal singularity (ARCHITECTURE.md deviation 16)."""
    sp = torch.clamp(-m[..., 2, 0], -1.0, 1.0)
    pitch = torch.arcsin(sp)
    gimbal = sp.abs() >= 1.0 - 1e-9
    zero = torch.zeros_like(pitch)
    roll = torch.where(gimbal, zero, torch.atan2(m[..., 2, 1], m[..., 2, 2]))
    yaw = torch.where(gimbal, zero, torch.atan2(m[..., 1, 0], m[..., 0, 0]))
    return roll, pitch, yaw


def rpy_from_quat(q: torch.Tensor) -> tuple:
    return rpy_from_matrix(matrix_from_quat(q))

