"""Pinhole undistortion — ``cv::undistortPoints`` (port of
:mod:`mrs_optic_flow_tpu.geometry.undistort`).

The 5-coefficient radial-tangential model ``(k1, k2, p1, p2, k3)``
(``src/optic_flow.cpp:1499-1519``) is inverted by OpenCV's fixed-point
iteration with its default of 5 iterations.
"""

from __future__ import annotations

from typing import Optional

import torch


def distort_points(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Apply the radial-tangential model to normalized coords ``[..., 2]``."""
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_xy(px, py, fx, fy, cx, cy, dist: Optional[torch.Tensor], *, iterations: int = 5):
    """:func:`undistort_points` on pixel components ``px``/``py`` and camera
    entries that broadcast with them (a principal point per sample, say)
    -> normalized ``(x, y)``."""
    xd = (px - cx) / fx
    yd = (py - cy) / fy
    if dist is None:
        return xd, yd
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    x, y = xd, yd
    for _ in range(iterations):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) * icdist
        y = (yd - dy) * icdist
    return x, y


def undistort_points(
    pts: torch.Tensor,
    camera_matrix: torch.Tensor,
    dist: Optional[torch.Tensor],
    *,
    iterations: int = 5,
) -> torch.Tensor:
    """Pixel points ``[..., 2]`` -> undistorted normalized coords ``[..., 2]``
    (``cv::undistortPoints(pts, out, K, dist)``, ``src/optic_flow.cpp:549``).
    ``dist=None`` is a distortion-free camera: only the ``K^-1`` step."""
    k = camera_matrix
    x, y = undistort_xy(pts[..., 0], pts[..., 1], k[..., 0, 0], k[..., 1, 1], k[..., 0, 2],
                        k[..., 1, 2], dist, iterations=iterations)
    return torch.stack([x, y], dim=-1)
