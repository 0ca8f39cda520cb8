"""Transport-agnostic message types: the port's copy of
:mod:`mrs_optic_flow_tpu.runtime.msgs` (whose package imports JAX), with
the same class and field names, for the messages the node exchanges.

Field-for-field mirrors of the ROS messages the reference exchanges
(``src/optic_flow.cpp:1036-1058``): sensor_msgs/CameraInfo+Imu,
nav_msgs/Odometry, mrs_msgs/Float64Stamped (height), and the published
geometry_msgs/TwistWithCovarianceStamped.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class CameraInfo:
    """K (3x3 row-major) and D (k1, k2, p1, p2, k3) as in sensor_msgs;
    decoded like ``callbackCameraInfo`` (``src/optic_flow.cpp:1496-1520``)."""

    k: Sequence[float]  # 9 values row-major
    d: Sequence[float]  # >= 5 values
    binning_x: int = 0

    def matrix(self) -> np.ndarray:
        return np.asarray(self.k, np.float64).reshape(3, 3)

    def dist(self) -> np.ndarray:
        return np.asarray(self.d, np.float64)[:5]


@dataclasses.dataclass
class Imu:
    """angular_velocity [3] + orientation quaternion (x, y, z, w)."""

    stamp: float
    angular_velocity: Tuple[float, float, float]
    orientation: Tuple[float, float, float, float]


@dataclasses.dataclass
class Odometry:
    stamp: float
    orientation: Tuple[float, float, float, float]
    linear_velocity: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    angular_velocity: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class Float64Stamped:
    stamp: float
    value: float


@dataclasses.dataclass
class ImageMsg:
    stamp: float
    data: np.ndarray  # [H, W, 3] uint8 BGR or [H, W] grayscale


@dataclasses.dataclass
class TrackerStatus:
    """mrs ControlManagerDiagnostics subset (``src/optic_flow.cpp:1253-1266``)."""

    active_tracker: str


@dataclasses.dataclass
class TwistWithCovarianceStamped:
    """The node's velocity output (``src/optic_flow.cpp:1748-1776``)."""

    frame_id: str
    stamp: float
    linear: Tuple[float, float, float]
    angular: Tuple[float, float, float]
    covariance: np.ndarray  # [36]

    @staticmethod
    def make(frame_id: str, stamp: float, linear, angular, cov_xy: float,
             cov_z: Optional[float] = None, cov_ang: Optional[float] = None
             ) -> "TwistWithCovarianceStamped":
        cov = np.zeros(36)
        cov[0] = cov[7] = cov_xy
        cov[14] = cov_z if cov_z is not None else cov_xy * 2
        a = cov_ang if cov_ang is not None else float(np.arctan(0.25))
        cov[21] = cov[28] = cov[35] = a
        return TwistWithCovarianceStamped(
            frame_id=frame_id, stamp=stamp,
            linear=tuple(float(x) for x in linear),
            angular=tuple(float(x) for x in angular),
            covariance=cov,
        )
