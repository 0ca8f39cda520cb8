"""Frame-stream harness: rosbag-replay-style driving of the node.

The port's own copy of :mod:`mrs_optic_flow_tpu.runtime.stream` (numpy and
``scipy.ndimage``; the port imports nothing of the JAX package).  The
reference is fed by live ROS topics; its only test story is flying the UAV.
This harness replays timestamped event streams (images, IMU, odometry,
height, tracker status) into :class:`OpticFlowNode` in stamp order — the
structural equivalent of `rosbag play` — and provides a synthetic
camera-over-textured-floor scene with known ground-truth velocity for
end-to-end verification.  Its renders are bit-identical to the JAX
package's for the same arguments.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Tuple

import numpy as np
from scipy import ndimage

from mrs_optic_flow_tpu_torch.runtime.msgs import (
    CameraInfo,
    Float64Stamped,
    ImageMsg,
    Imu,
    Odometry,
)
from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode


@dataclasses.dataclass(order=True)
class _Event:
    stamp: float
    seq: int
    kind: str = dataclasses.field(compare=False)
    msg: object = dataclasses.field(compare=False)


class FrameStream:
    """Event-ordered replay into the node's callbacks."""

    KIND_DISPATCH = {
        "image": "on_image",
        "imu": "on_imu",
        "odometry": "on_odometry",
        "height": "on_height",
        "camera_info": "on_camera_info",
        "tracker": "on_tracker_status",
    }

    def __init__(self, node: OpticFlowNode):
        self.node = node
        self._events: List[_Event] = []
        self._seq = 0

    def add(self, kind: str, stamp: float, msg) -> "FrameStream":
        if kind not in self.KIND_DISPATCH:
            raise ValueError(f"unknown event kind {kind!r}")
        heapq.heappush(self._events, _Event(stamp, self._seq, kind, msg))
        self._seq += 1
        return self

    def run(self) -> List[object]:
        """Dispatch all events in stamp order; returns on_image results."""
        outputs = []
        while self._events:
            ev = heapq.heappop(self._events)
            result = getattr(self.node, self.KIND_DISPATCH[ev.kind])(ev.msg)
            if ev.kind == "image":
                outputs.append(result)
        return outputs


class SyntheticScene:
    """Nadir camera over a textured plane with known metric velocity.

    Frames are rendered by projecting each pixel ray to the ground plane and
    sampling a band-limited texture — the ground truth the reference never
    had.  Pixel flow obeys ``d_px = -f * v * dt / h`` (the relation getRT
    inverts, ``src/optic_flow.cpp:701-722``).
    """

    def __init__(
        self,
        *,
        width: int = 752,
        height_px: int = 480,
        fx: float = 420.0,
        fy: float = 420.0,
        cx: Optional[float] = None,
        cy: Optional[float] = None,
        uav_height: float = 2.0,
        texture_size: int = 2048,
        texture_cutoff: float = 0.25,
        texture_scale: float = 200.0,  # texture pixels per metre
        dist_coeffs=(0.0, 0.0, 0.0, 0.0, 0.0),  # (k1, k2, p1, p2, k3)
        seed: int = 0,
    ):
        self.width = width
        self.height_px = height_px
        self.fx, self.fy = fx, fy
        self.cx = cx if cx is not None else width / 2.0
        self.cy = cy if cy is not None else height_px / 2.0
        self.uav_height = uav_height
        self.texture_scale = texture_scale
        self.dist_coeffs = np.asarray(dist_coeffs, np.float64)

        rng = np.random.default_rng(seed)
        t = rng.standard_normal((texture_size, texture_size))
        f = np.fft.fft2(t)
        fr = np.abs(np.fft.fftfreq(texture_size))
        f *= np.exp(-((fr[:, None] ** 2 + fr[None, :] ** 2) / (2 * texture_cutoff**2)))
        t = np.fft.ifft2(f).real
        t -= t.min()
        self.texture = (t / t.max() * 255.0).astype(np.float32)
        self._ts = texture_size
        self._grid = None  # (key, rays) of the last intrinsics rendered

    def camera_info(self) -> CameraInfo:
        return CameraInfo(
            k=[self.fx, 0, self.cx, 0, self.fy, self.cy, 0, 0, 1],
            d=list(self.dist_coeffs),
        )

    def _undistort_np(self, xd: np.ndarray, yd: np.ndarray, iterations: int = 20):
        """Invert the radial-tangential model (the observed pixels are
        distorted; each pixel's ray comes from the undistorted coords)."""
        k1, k2, p1, p2, k3 = self.dist_coeffs
        x, y = xd.copy(), yd.copy()
        for _ in range(iterations):
            r2 = x * x + y * y
            icdist = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
            dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
            dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
            x = (xd - dx) * icdist
            y = (yd - dy) * icdist
        return x, y

    def _pixel_rays(self):
        """Every pixel's undistorted normalized coordinates ``(xn, yn)``: the
        same for every frame of the same intrinsics, so computed once for
        them (the distortion model's inversion takes most of a distorted
        render).  The cache is keyed on every public attribute the rays
        depend on, so a scene whose size, intrinsics or distortion is set
        anew renders with its new rays, as the JAX scene does."""
        key = (self.width, self.height_px, self.fx, self.fy, self.cx, self.cy,
               tuple(np.asarray(self.dist_coeffs, np.float64).ravel().tolist()))
        if self._grid is None or self._grid[0] != key:
            uu, vv = np.meshgrid(np.arange(self.width), np.arange(self.height_px))
            xd = (uu - self.cx) / self.fx
            yd = (vv - self.cy) / self.fy
            if np.any(np.asarray(self.dist_coeffs) != 0.0):
                xd, yd = self._undistort_np(xd, yd)
            self._grid = (key, (xd, yd))
        return self._grid[1]

    def render(self, cam_xy: Tuple[float, float]) -> np.ndarray:
        """Grayscale frame for a camera at ground position ``cam_xy`` [m]."""
        xn, yn = self._pixel_rays()
        gx = cam_xy[0] + self.uav_height * xn
        gy = cam_xy[1] + self.uav_height * yn
        tx = (gx * self.texture_scale) % self._ts
        ty = (gy * self.texture_scale) % self._ts
        img = ndimage.map_coordinates(self.texture, [ty, tx], order=1, mode="wrap")
        return img.astype(np.float32)

    def render_pose(
        self,
        cam_xy: Tuple[float, float],
        rpy=(0.0, 0.0, 0.0),
        height: Optional[float] = None,
    ) -> np.ndarray:
        """Frame for a camera at ``cam_xy`` with orientation ``rpy``
        (fixed-axis roll/pitch/yaw of the body; camera looks along +z down).
        ``rpy`` may also be a 3x3 world<-camera rotation MATRIX — the
        mounted-camera case, where the camera orientation is the body
        attitude composed with a static mount rotation
        (:class:`~mrs_optic_flow_tpu_torch.runtime.flightsim.FlightSimulator`'s
        ``mount_rpy``; the reference's camera->base TF,
        ``src/optic_flow.cpp:1203-1208``).

        Rays are cast through the (un)distortion model, rotated by the body
        attitude, and intersected with the ground plane — tilted flight with
        exact geometry, for end-to-end tests of the detilt / decomposition
        chain (``src/optic_flow.cpp:1694-1746``).  ``height`` overrides the
        scene's fixed ``uav_height`` (climbing / descending trajectories —
        the flight-sim harness).
        """
        from scipy.spatial.transform import Rotation

        xn, yn = self._pixel_rays()
        rays = np.stack([xn, yn, np.ones_like(xn)], axis=-1)  # camera frame
        rpy_arr = np.asarray(rpy, np.float64)
        if rpy_arr.shape == (3, 3):
            r_wc = rpy_arr
        else:
            r_wc = Rotation.from_euler("xyz", rpy).as_matrix()
        d = rays @ r_wc.T  # world frame
        h = self.uav_height if height is None else float(height)
        t = h / d[..., 2]  # ground plane at +height below
        gx = cam_xy[0] + t * d[..., 0]
        gy = cam_xy[1] + t * d[..., 1]
        tx = (gx * self.texture_scale) % self._ts
        ty = (gy * self.texture_scale) % self._ts
        img = ndimage.map_coordinates(self.texture, [ty, tx], order=1, mode="wrap")
        return img.astype(np.float32)

    def trajectory_events(
        self,
        stream: FrameStream,
        *,
        velocity: Tuple[float, float],
        n_frames: int = 10,
        dt: float = 0.05,
        t0: float = 100.0,
    ) -> FrameStream:
        """Queue a constant-velocity run: camera info + transforms-ready
        sensors + frames.  Level flight: identity IMU orientation, zero
        angular rate."""
        stream.add("camera_info", t0 - 1.0, self.camera_info())
        for i in range(n_frames):
            t = t0 + i * dt
            stream.add("imu", t - 1e-4, Imu(
                stamp=t, angular_velocity=(0.0, 0.0, 0.0),
                orientation=(0.0, 0.0, 0.0, 1.0)))
            stream.add("odometry", t - 1e-4, Odometry(
                stamp=t, orientation=(0.0, 0.0, 0.0, 1.0),
                linear_velocity=(velocity[0], velocity[1], 0.0)))
            stream.add("height", t - 1e-4, Float64Stamped(stamp=t, value=self.uav_height))
            pos = (velocity[0] * i * dt, velocity[1] * i * dt)
            stream.add("image", t, ImageMsg(stamp=t, data=self.render(pos)))
        return stream
