"""NumPy quaternion helpers for the node's host-side callback math.

The port's own copy of :mod:`mrs_optic_flow_tpu.utils.quat_np` (the port
imports nothing of the JAX package); a test holds the two bit-identical.
The sensor callbacks run on the transport thread at sensor rate (IMU often
100-1000 Hz), so 4-element quaternion conversions stay on the host instead
of becoming device launches.  Same tf2 conventions as
:mod:`mrs_optic_flow_tpu_torch.geometry.rotations` ((x, y, z, w),
fixed-axis RPY).
"""

from __future__ import annotations

import numpy as np


def np_quat_from_rpy(roll: float, pitch: float, yaw: float) -> np.ndarray:
    hr, hp, hy = roll * 0.5, pitch * 0.5, yaw * 0.5
    sr, cr = np.sin(hr), np.cos(hr)
    sp, cp = np.sin(hp), np.cos(hp)
    sy, cy = np.sin(hy), np.cos(hy)
    return np.array(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ]
    )


def np_quat_inverse(q: np.ndarray) -> np.ndarray:
    return np.asarray(q) * np.array([-1.0, -1.0, -1.0, 1.0])


def np_quat_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ]
    )


def np_rpy_from_quat(q: np.ndarray) -> tuple:
    """tf2 ``Matrix3x3::getRPY`` solution 1, numpy scalar version."""
    x, y, z, w = np.asarray(q, float) / np.linalg.norm(q)
    m20 = 2 * (x * z - y * w)
    m21 = 2 * (y * z + x * w)
    m22 = 1 - 2 * (x * x + y * y)
    m10 = 2 * (x * y + z * w)
    m00 = 1 - 2 * (y * y + z * z)
    sp = np.clip(-m20, -1.0, 1.0)
    pitch = float(np.arcsin(sp))
    if abs(sp) >= 1.0 - 1e-9:
        return 0.0, pitch, 0.0
    roll = float(np.arctan2(m21, m22))
    yaw = float(np.arctan2(m10, m00))
    return roll, pitch, yaw
