"""Closed-loop synthetic flight harness.

The port's own copy of :mod:`mrs_optic_flow_tpu.runtime.flightsim` (numpy
and scipy; the port imports nothing of the JAX package): the same profiles,
renders, event streams, recordings (``.ofrec``, ROS1 bag, rosbag2) and
report.

The reference's ultimate validation is real UAV flights consuming the full
policy surface — the four ``long_range_mode`` policies and the
landoff-tracker handoff (``src/optic_flow.cpp:1575-1585``, tracker gate
``:1355-1366``) switching mid-stream as height changes.  This module is the
synthetic stand-in: a full trajectory (takeoff -> cruise -> yawing descent)
over a textured ground plane, rendered with exact projective geometry
(:class:`SyntheticScene.render_pose`) and accompanied by CONSISTENT
IMU / odometry / height / tracker streams, driven end-to-end through
:class:`OpticFlowNode` with trajectory-level metrics out.

The harness is a product surface, not just a test fixture: deployments can
re-run it after config changes as a regression gate (``FlightReport``
carries velocity RMSE, covariance consistency, and per-phase publish
coverage), and the rendered stream can be exported as an ``.ofrec``
recording (:meth:`FlightSimulator.record_ofrec`) so the offline-replay
path is exercised by the same artifact.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mrs_optic_flow_tpu_torch.runtime.msgs import (
    Float64Stamped,
    ImageMsg,
    Imu,
    Odometry,
    TrackerStatus,
)
from mrs_optic_flow_tpu_torch.runtime.stream import FrameStream, SyntheticScene
from mrs_optic_flow_tpu_torch.utils.quat_np import np_quat_from_rpy


@dataclasses.dataclass
class FlightSample:
    """Ground truth at one frame instant."""

    t: float
    pos: np.ndarray  # [3] world position (x, y, height) [m]
    vel: np.ndarray  # [3] world velocity over the PRECEDING interval [m/s]
    yaw: float  # [rad]
    yaw_rate: float  # [rad/s] over the preceding interval
    tracker: str  # active MRS tracker name
    phase: str  # "takeoff" | "cruise" | "descent" | "climb" | "brake"
    #: bank attitude (acceleration-consistent roll/pitch; zero on the
    #: level-flight profile) and its rates — rendered into the frames AND
    #: fed to the IMU stream, so the detilt chain
    #: (``src/optic_flow.cpp:1692-1746``) is exercised for real
    roll: float = 0.0
    pitch: float = 0.0
    roll_rate: float = 0.0
    pitch_rate: float = 0.0

    @property
    def vel_body(self) -> np.ndarray:
        """World velocity expressed in the yaw-rotated UNTILTED body frame —
        the frame the node's published twist lives in (detilt removes
        roll/pitch, keeps yaw: ``src/optic_flow.cpp:1694-1702``)."""
        c, s = np.cos(self.yaw), np.sin(self.yaw)
        r_wb = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        return r_wb.T @ self.vel


def takeoff_cruise_descent_profile(
    *,
    dt: float = 0.05,
    t0: float = 100.0,
    takeoff_frames: int = 36,
    cruise_frames: int = 16,
    descent_frames: int = 36,
    h0: float = 0.8,
    h_cruise: float = 2.0,
    h_final: float = 1.0,
    v_takeoff_xy: Tuple[float, float] = (0.3, 0.0),
    v_cruise_xy: Tuple[float, float] = (0.6, 0.2),
    descent_yaw_rate: float = 0.35,
) -> List[FlightSample]:
    """The canonical three-phase flight:

    - **takeoff**: LandoffTracker active, climbing ``h0`` -> ``h_cruise``
      with a small horizontal drift — the regime where the reference's
      takeoff/height policies select the 4x-downsampled long-range path;
    - **cruise**: constant height, constant horizontal velocity;
    - **yawing descent**: hovering in xy while descending to ``h_final``
      under a constant yaw rate — rotation + zoom flow that exercises the
      full homography decomposition (and the scale/rotation estimator).

    Heights follow COSINE-EASED ramps (slow near the endpoints): the
    frame-to-frame image zoom is ``vz * dt / h``, so a constant-rate climb
    at low altitude produces scale changes no frame-to-frame correlator —
    the reference's included (``cv::phaseCorrelate``) — survives; a real
    UAV's 20-60 fps streams never see more than a few percent per frame,
    and easing keeps this profile inside that envelope exactly where ``h``
    is smallest.
    """

    def eased(a: float, b: float, k: int, i: int) -> float:
        # cosine ease from a to b over k intervals, evaluated at frame i
        return a + (b - a) * 0.5 * (1.0 - np.cos(np.pi * min(i, k) / k))

    pos_list: List[np.ndarray] = []
    meta: List[Tuple[str, str, float]] = []  # (phase, tracker, yaw)
    xy = np.zeros(2)
    yaw = 0.0
    for i in range(takeoff_frames + 1):
        pos_list.append(np.array([*xy, eased(h0, h_cruise, takeoff_frames, i)]))
        meta.append(("takeoff", "LandoffTracker", yaw))
        xy = xy + np.asarray(v_takeoff_xy) * dt
    for _ in range(cruise_frames):
        pos_list.append(np.array([*xy, h_cruise]))
        meta.append(("cruise", "MpcTracker", yaw))
        xy = xy + np.asarray(v_cruise_xy) * dt
    for i in range(descent_frames):
        yaw += descent_yaw_rate * dt
        pos_list.append(
            np.array([*xy, eased(h_cruise, h_final, descent_frames, i + 1)])
        )
        meta.append(("descent", "MpcTracker", yaw))

    samples: List[FlightSample] = []
    for i, (pos, (phase, tracker, yw)) in enumerate(zip(pos_list, meta)):
        vel = (pos - pos_list[i - 1]) / dt if i else np.zeros(3)
        yr = (yw - meta[i - 1][2]) / dt if i else 0.0
        samples.append(FlightSample(
            t=t0 + i * dt, pos=pos, vel=vel, yaw=yw, yaw_rate=yr,
            tracker=tracker, phase=phase,
        ))
    return samples


def _attitude_from_accel(a_xy: np.ndarray, yaw: float, g: float = 9.81):
    """Acceleration-consistent bank attitude (roll, pitch) [rad].

    A multirotor accelerates by tilting its thrust axis: with gravity +z
    (the scene's z-down world), hover thrust is along -z and an
    acceleration ``a`` needs thrust along ``(a_x, a_y, -g)``, i.e. body
    z-axis along ``(-a_x, -a_y, g)``.  Solving
    ``Rz(yaw)·Ry(pitch)·Rx(roll) @ z = that direction`` gives, with
    ``u = Rz(yaw)^T @ (-a_x, -a_y, g)`` normalized:
    ``roll = -asin(u_y)``, ``pitch = atan2(u_x, u_z)``."""
    c, s = np.cos(yaw), np.sin(yaw)
    ax_b = c * a_xy[0] + s * a_xy[1]
    ay_b = -s * a_xy[0] + c * a_xy[1]
    u = np.array([-ax_b, -ay_b, g])
    u = u / np.linalg.norm(u)
    roll = -np.arcsin(np.clip(u[1], -1.0, 1.0))
    pitch = np.arctan2(u[0], u[2])
    return float(roll), float(pitch)


def banked_flight_profile(
    *,
    dt: float = 0.05,
    t0: float = 100.0,
    climb_frames: int = 16,
    cruise_frames: int = 10,
    brake_frames: int = 14,
    descent_frames: int = 20,
    h0: float = 1.5,
    h_cruise: float = 2.0,
    h_final: float = 1.4,
    v_cruise_xy: Tuple[float, float] = (0.9, 0.3),
    descent_yaw_rate: float = 0.35,
    g: float = 9.81,
) -> List[FlightSample]:
    """An acceleration-rich flight whose attitude BANKS with every commanded
    acceleration — the trajectory-level exercise of the detilt chain
    (``src/optic_flow.cpp:1692-1746``) that the level
    :func:`takeoff_cruise_descent_profile` never produces (its phases fly
    constant velocities, so roll = pitch = 0 on every frame):

    - **climb**: accelerate 0 -> ``v_cruise_xy`` (cosine-eased velocity, so
      the acceleration — and the bank — ramps smoothly to ~``pi/2 *
      |v_cruise| / (climb_frames*dt) / g`` rad, ~0.19 rad at the defaults)
      WHILE climbing ``h0 -> h_cruise``.  The simultaneous vz is what makes
      detilt measurable: without it the un-detilted xy error is only
      second-order (``v*(1-cos(tilt))``), with it first-order
      (``vz*sin(tilt)``);
    - **cruise**: constant velocity, level attitude;
    - **brake**: decelerate to hover — bank of the opposite sign;
    - **descent**: yawing descent as in the level profile.

    Attitude follows :func:`_attitude_from_accel` on the centered
    acceleration; the same roll/pitch (and their rates) render the frames
    and feed the IMU stream, so the estimator sees exactly what a banking
    UAV's camera and IMU would agree on.
    """

    def ease01(i: int, k: int) -> float:
        return 0.5 * (1.0 - np.cos(np.pi * min(max(i, 0), k) / k))

    n = climb_frames + cruise_frames + brake_frames + descent_frames + 1
    v = np.zeros((n, 3))
    h = np.full(n, h0)
    yaw = np.zeros(n)
    meta: List[Tuple[str, str]] = [("climb", "MpcTracker")]
    vc = np.asarray(v_cruise_xy)
    i = 1
    for k in range(1, climb_frames + 1):
        # velocity during the interval ending at this frame
        v[i, :2] = vc * ease01(k, climb_frames)
        h[i] = h0 + (h_cruise - h0) * ease01(k, climb_frames)
        v[i, 2] = (h[i] - h[i - 1]) / dt
        meta.append(("climb", "MpcTracker"))
        i += 1
    for _ in range(cruise_frames):
        v[i, :2] = vc
        h[i] = h_cruise
        meta.append(("cruise", "MpcTracker"))
        i += 1
    for k in range(1, brake_frames + 1):
        v[i, :2] = vc * (1.0 - ease01(k, brake_frames))
        h[i] = h_cruise
        meta.append(("brake", "MpcTracker"))
        i += 1
    for k in range(1, descent_frames + 1):
        h[i] = h_cruise + (h_final - h_cruise) * ease01(k, descent_frames)
        v[i, 2] = (h[i] - h[i - 1]) / dt
        yaw[i] = yaw[i - 1] + descent_yaw_rate * dt
        meta.append(("descent", "MpcTracker"))
        i += 1

    pos = np.zeros((n, 3))
    pos[0, 2] = h[0]
    for j in range(1, n):
        pos[j, :2] = pos[j - 1, :2] + v[j, :2] * dt
        pos[j, 2] = h[j]

    # centered acceleration -> attitude, then attitude rates
    rp = np.zeros((n, 2))
    for j in range(n):
        a = (v[min(j + 1, n - 1), :2] - v[max(j - 1, 0), :2]) / (
            dt * (min(j + 1, n - 1) - max(j - 1, 0) or 1)
        )
        rp[j] = _attitude_from_accel(a, yaw[j], g)

    samples: List[FlightSample] = []
    for j in range(n):
        yr = (yaw[j] - yaw[j - 1]) / dt if j else 0.0
        rr = (rp[j, 0] - rp[j - 1, 0]) / dt if j else 0.0
        pr = (rp[j, 1] - rp[j - 1, 1]) / dt if j else 0.0
        samples.append(FlightSample(
            t=t0 + j * dt, pos=pos[j].copy(), vel=v[j].copy(), yaw=yaw[j],
            yaw_rate=yr, tracker=meta[j][1], phase=meta[j][0],
            roll=rp[j, 0], pitch=rp[j, 1], roll_rate=rr, pitch_rate=pr,
        ))
    return samples


def banked_yawing_descent_profile(
    *,
    dt: float = 0.05,
    t0: float = 100.0,
    n_frames: int = 36,
    h0: float = 2.0,
    h_final: float = 1.28,
    yaw_rate: float = 0.35,
    sway_amp: float = 0.3,
    sway_period: float = 1.0,
    g: float = 9.81,
) -> List[FlightSample]:
    """A yawing descent that BANKS while the scale/rotation estimator is
    doing its job: horizontal velocity follows a sinusoid (amplitude
    ``sway_amp`` m/s, period ``sway_period`` s), so the commanded
    acceleration — and the acceleration-consistent attitude — oscillates up
    to ``atan(sway_amp * 2*pi / sway_period / g)`` rad (~0.19 at the
    defaults) DURING the zoom+rotation flow the log-polar decode consumes.

    This is the stress regime the log-polar similarity assumption
    (``src/scaleRotationEstimator.cpp:34-148``: the decode models the
    frame-to-frame flow as a centred scale+rotation) does not cover: tilt
    adds a projective component the reference never quantified.  The
    harness exists to measure that envelope (``scale_rot_max_tilt`` gates
    the decode on it)."""

    def eased(a: float, b: float, k: int, i: int) -> float:
        return a + (b - a) * 0.5 * (1.0 - np.cos(np.pi * min(i, k) / k))

    n = n_frames + 1
    v = np.zeros((n, 3))
    h = np.zeros(n)
    yaw = np.zeros(n)
    h[0] = h0
    for j in range(1, n):
        # velocity over the interval ending at frame j
        v[j, 0] = sway_amp * np.sin(2.0 * np.pi * (j * dt) / sway_period)
        h[j] = eased(h0, h_final, n_frames, j)
        v[j, 2] = (h[j] - h[j - 1]) / dt
        yaw[j] = yaw[j - 1] + yaw_rate * dt
    pos = np.zeros((n, 3))
    pos[0, 2] = h[0]
    for j in range(1, n):
        pos[j, :2] = pos[j - 1, :2] + v[j, :2] * dt
        pos[j, 2] = h[j]

    rp = np.zeros((n, 2))
    for j in range(n):
        a = (v[min(j + 1, n - 1), :2] - v[max(j - 1, 0), :2]) / (
            dt * (min(j + 1, n - 1) - max(j - 1, 0) or 1)
        )
        rp[j] = _attitude_from_accel(a, yaw[j], g)

    samples: List[FlightSample] = []
    for j in range(n):
        yr = yaw_rate if j else 0.0
        rr = (rp[j, 0] - rp[j - 1, 0]) / dt if j else 0.0
        pr = (rp[j, 1] - rp[j - 1, 1]) / dt if j else 0.0
        samples.append(FlightSample(
            t=t0 + j * dt, pos=pos[j].copy(), vel=v[j].copy(), yaw=yaw[j],
            yaw_rate=yr, tracker="MpcTracker", phase="descent",
            roll=rp[j, 0], pitch=rp[j, 1], roll_rate=rr, pitch_rate=pr,
        ))
    return samples


class FlightSimulator:
    """Render a :func:`takeoff_cruise_descent_profile`-style trajectory and
    feed it — frames plus consistent sensor streams — into an
    :class:`OpticFlowNode` (via :class:`FrameStream`) or an ``.ofrec``
    recording."""

    def __init__(
        self,
        samples: Sequence[FlightSample],
        *,
        scene: Optional[SyntheticScene] = None,
        seed: int = 7,
        texture_cutoff: float = 0.3,
        mount_rpy: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    ):
        """``mount_rpy``: static camera->body mount rotation (fixed-axis
        RPY).  The rendered camera orientation is the body attitude composed
        with the mount, and :meth:`c2b_quat` is what the node's
        ``set_transforms`` must be fed — the reference's camera->base TF
        (``timerTf``, ``src/optic_flow.cpp:1176-1208``; its real camera is
        mounted with ``cam_yaw = yaw + pi/2``)."""
        self.samples = list(samples)
        self.scene = scene or SyntheticScene(
            seed=seed, texture_cutoff=texture_cutoff
        )
        self.mount_rpy = tuple(float(a) for a in mount_rpy)

    @property
    def c2b_quat(self) -> Tuple[float, float, float, float]:
        """Camera->body rotation quaternion ``[x, y, z, w]`` of the mount —
        feed to ``OpticFlowNode.set_transforms``."""
        return tuple(np_quat_from_rpy(*self.mount_rpy))

    def render(self, s: FlightSample) -> np.ndarray:
        if any(self.mount_rpy):
            from scipy.spatial.transform import Rotation

            r_wb = Rotation.from_euler("xyz", (s.roll, s.pitch, s.yaw))
            r_bc = Rotation.from_euler("xyz", self.mount_rpy)
            rpy = (r_wb * r_bc).as_matrix()  # world <- camera
        else:
            rpy = (s.roll, s.pitch, s.yaw)
        return self.scene.render_pose(
            (float(s.pos[0]), float(s.pos[1])), rpy, height=float(s.pos[2]),
        )

    def frames(self) -> List[np.ndarray]:
        return [self.render(s) for s in self.samples]

    def events_into(
        self, stream: FrameStream, frames: Optional[Sequence[np.ndarray]] = None
    ) -> FrameStream:
        """Queue the whole flight: camera info, then per frame the tracker
        status, IMU (yaw attitude + yaw rate), odometry (orientation +
        world-frame speed), height, and the rendered image — each sensor
        stamped just before its frame, the arrival order a live graph
        produces."""
        if frames is None:
            frames = self.frames()
        stream.add("camera_info", self.samples[0].t - 1.0,
                   self.scene.camera_info())
        for s, img in zip(self.samples, frames):
            q = tuple(np_quat_from_rpy(s.roll, s.pitch, s.yaw))
            rates = (s.roll_rate, s.pitch_rate, s.yaw_rate)
            stream.add("tracker", s.t - 2e-4, TrackerStatus(
                active_tracker=s.tracker))
            stream.add("imu", s.t - 1e-4, Imu(
                stamp=s.t, angular_velocity=rates, orientation=q))
            stream.add("odometry", s.t - 1e-4, Odometry(
                stamp=s.t, orientation=q,
                linear_velocity=tuple(s.vel),
                angular_velocity=rates))
            stream.add("height", s.t - 1e-4, Float64Stamped(
                stamp=s.t, value=float(s.pos[2])))
            stream.add("image", s.t, ImageMsg(stamp=s.t, data=img))
        return stream

    def record_ofrec(self, path: str, frames: Optional[Sequence[np.ndarray]] = None):
        """Write the rendered flight as a timestamped ``.ofrec`` raw-frame
        recording (the native Recorder format) — the offline-replay artifact
        (``runtime.viz`` / ``native.Replay``)."""
        from mrs_optic_flow_tpu_torch import native

        if frames is None:
            frames = self.frames()
        with native.Recorder(
            path, width=self.scene.width, height=self.scene.height_px
        ) as rec:
            for s, img in zip(self.samples, frames):
                rec.write(s.t, np.clip(np.rint(img), 0, 255).astype(np.uint8))

    def record_bag(self, path: str, frames: Optional[Sequence[np.ndarray]] = None):
        """Write the flight as a ROS1 bag (``runtime.rosbag.BagWriter``) —
        camera info, IMU, odometry, height, and the rendered frames on the
        reference's topic types — so ``replay_bag`` drives the node from
        the SAME artifact a real flight recording would."""
        from mrs_optic_flow_tpu_torch.runtime import rosbag as rb

        if frames is None:
            frames = self.frames()
        info = self.scene.camera_info()
        with rb.BagWriter(path) as bag:
            bag.write(
                "/camera_info", "sensor_msgs/CameraInfo",
                self.samples[0].t - 1.0,
                rb.encode_camera_info_msg(
                    info, self.samples[0].t - 1.0,
                    shape=(self.scene.height_px, self.scene.width),
                ),
            )
            for s, img in zip(self.samples, frames):
                q = tuple(np_quat_from_rpy(s.roll, s.pitch, s.yaw))
                bag.write("/imu", "sensor_msgs/Imu", s.t - 1e-4,
                          rb.encode_imu_msg(Imu(
                              stamp=s.t,
                              angular_velocity=(s.roll_rate, s.pitch_rate,
                                                s.yaw_rate),
                              orientation=q)))
                bag.write("/odometry", "nav_msgs/Odometry", s.t - 1e-4,
                          rb.encode_odometry_msg(Odometry(
                              stamp=s.t, orientation=q,
                              linear_velocity=tuple(s.vel),
                              angular_velocity=(s.roll_rate, s.pitch_rate,
                                                s.yaw_rate))))
                bag.write("/height", "mrs_msgs/Float64Stamped", s.t - 1e-4,
                          rb.encode_float64_stamped_msg(Float64Stamped(
                              stamp=s.t, value=float(s.pos[2]))))
                bag.write("/image_raw", "sensor_msgs/Image", s.t,
                          rb.encode_image_msg(ImageMsg(stamp=s.t, data=img)))

    def record_bag2(self, path: str, frames: Optional[Sequence[np.ndarray]] = None):
        """Write the flight as a ROS2 rosbag2 directory
        (``runtime.rosbag2.Bag2Writer``: sqlite3 storage + metadata.yaml,
        CDR serialization) — the ROS2 twin of :meth:`record_bag`, replayed
        by ``replay_bag2`` / stock ``ros2 bag play``."""
        from mrs_optic_flow_tpu_torch.runtime import rosbag2 as rb2

        if frames is None:
            frames = self.frames()
        info = self.scene.camera_info()
        with rb2.Bag2Writer(path) as bag:
            bag.write(
                "/camera_info", "sensor_msgs/msg/CameraInfo",
                self.samples[0].t - 1.0,
                rb2.encode_camera_info_msg(
                    info, self.samples[0].t - 1.0,
                    shape=(self.scene.height_px, self.scene.width),
                ),
            )
            for s, img in zip(self.samples, frames):
                q = tuple(np_quat_from_rpy(s.roll, s.pitch, s.yaw))
                bag.write("/imu", "sensor_msgs/msg/Imu", s.t - 1e-4,
                          rb2.encode_imu_msg(Imu(
                              stamp=s.t,
                              angular_velocity=(s.roll_rate, s.pitch_rate,
                                                s.yaw_rate),
                              orientation=q)))
                bag.write("/odometry", "nav_msgs/msg/Odometry", s.t - 1e-4,
                          rb2.encode_odometry_msg(Odometry(
                              stamp=s.t, orientation=q,
                              linear_velocity=tuple(s.vel),
                              angular_velocity=(s.roll_rate, s.pitch_rate,
                                                s.yaw_rate))))
                bag.write("/height", "mrs_msgs/msg/Float64Stamped", s.t - 1e-4,
                          rb2.encode_float64_stamped_msg(Float64Stamped(
                              stamp=s.t, value=float(s.pos[2]))))
                bag.write("/image_raw", "sensor_msgs/msg/Image", s.t,
                          rb2.encode_image_msg(ImageMsg(stamp=s.t, data=img)))


@dataclasses.dataclass
class FlightReport:
    """Trajectory-level conformance metrics of one closed-loop flight."""

    n_frames: int
    n_published: int  # frames that produced a velocity estimate
    rmse_xy: float  # [m/s] vs ground-truth body-frame velocity
    max_err_xy: float  # [m/s]
    within_3sigma: float  # fraction of estimates within 3*sqrt(cov_xy)
    nan_published: int  # published twists carrying NaN xy (must be 0)
    mode_switches: List[int]  # frame indices where SR<->LR mode flipped
    dropped_at_switches: int  # invalid frames adjacent to a mode switch
    per_phase_coverage: dict  # phase -> published / frames
    #: mean normalized estimation error squared, ``mean(|err|^2 / cov_xy)``
    #: — the TWO-SIDED covariance-calibration statistic.  A perfectly
    #: calibrated 2-dof estimate scores 2.0; the reference's 5-px error
    #: model (``src/optic_flow.cpp:1757-1763``) deliberately over-covers
    #: the <1 px estimator, so healthy flights score ~0.05-0.5.  Tests
    #: bound it BELOW (over-confidence: sigma too small -> nees >> 2) and
    #: ABOVE zero-ish (absurd under-confidence: sigma 10x too large ->
    #: nees < 0.005) — unlike ``within_3sigma`` alone, which only ever
    #: catches catastrophic over-confidence.
    nees_xy: float = float("nan")
    #: phase -> velocity RMSE [m/s] — isolates phase-local effects (e.g.
    #: the banked climb's detilt error) that the whole-flight RMSE dilutes
    per_phase_rmse: dict = dataclasses.field(default_factory=dict)


def evaluate_flight(
    samples: Sequence[FlightSample],
    published: Sequence[Tuple[str, object]],
    *,
    warmup_frames: int = 2,
    stamp_tol: float = 1e-3,
) -> FlightReport:
    """Score a flight: match each published twist (``velocity_out`` or
    ``velocity_out_longrange``) to its ground-truth sample by NEAREST stamp
    within ``stamp_tol`` seconds (exact matching silently scored jittered
    or resampled replays as unpublished) and compute trajectory metrics.
    ``published`` is the node's collected ``(topic, msg)`` stream."""
    pub = sorted(
        ((float(msg.stamp), topic, msg) for topic, msg in published
         if topic in ("velocity_out", "velocity_out_longrange")),
        key=lambda r: r[0],
    )
    pub_stamps = np.asarray([r[0] for r in pub])
    matched: set = set()  # each published twist scores at most once

    def _match(t: float):
        if not len(pub_stamps):
            return None
        # ALL candidates within the tolerance window, not just the two
        # nearest neighbors: consumption (below) can hide a still-valid
        # unconsumed publication one slot further out when publications
        # are spaced under 2*stamp_tol
        lo = int(np.searchsorted(pub_stamps, t - stamp_tol))
        hi = int(np.searchsorted(pub_stamps, t + stamp_tol, side="right"))
        best = None
        for k in range(lo, hi):
            # consume matches: without the `matched` screen one publication
            # could pair with two adjacent ground-truth samples whenever
            # sample spacing is under 2*stamp_tol, double-counting it in
            # coverage and RMSE (silent at the shipped dt=0.05 vs tol=1e-3,
            # a live hazard for denser replays)
            if k not in matched and abs(pub_stamps[k] - t) <= stamp_tol:
                if best is None or abs(pub_stamps[k] - t) < abs(
                    pub_stamps[best] - t
                ):
                    best = k
        if best is None:
            return None
        matched.add(best)
        return (pub[best][1], pub[best][2])

    errs, sigmas, phases_pub = [], [], {}
    phase_errs: dict = {}
    n_pub = nan_pub = 0
    topics_seq = []
    phase_counts = {}
    for i, s in enumerate(samples):
        if i < warmup_frames:
            continue
        phase_counts[s.phase] = phase_counts.get(s.phase, 0) + 1
        hit = _match(s.t)
        topics_seq.append(hit[0] if hit else None)
        if hit is None:
            continue
        topic, tw = hit
        n_pub += 1
        phases_pub[s.phase] = phases_pub.get(s.phase, 0) + 1
        v = np.asarray(tw.linear[:2], float)
        if not np.all(np.isfinite(v)):
            nan_pub += 1
            continue
        err = float(np.linalg.norm(v - s.vel_body[:2]))
        errs.append(err)
        phase_errs.setdefault(s.phase, []).append(err)
        sigmas.append(float(np.sqrt(max(np.asarray(tw.covariance)[0], 1e-12))))

    # mode switches: consecutive published frames on different topic families
    seen = [t for t in topics_seq if t is not None]
    switches = [
        i for i in range(1, len(seen)) if seen[i] != seen[i - 1]
    ]
    # frames dropped adjacent to a topic-family flip (index into topics_seq)
    flips = [
        i for i in range(1, len(topics_seq))
        if topics_seq[i] is not None
        and any(t is not None and t != topics_seq[i]
                for t in topics_seq[max(0, i - 2):i])
    ]
    dropped = sum(
        1 for i in flips
        for j in (i - 1, i + 1)
        if 0 <= j < len(topics_seq) and topics_seq[j] is None
    )

    errs_a = np.asarray(errs) if errs else np.asarray([np.inf])
    sig_a = np.asarray(sigmas) if sigmas else np.asarray([1.0])
    return FlightReport(
        n_frames=len(samples) - warmup_frames,
        n_published=n_pub,
        rmse_xy=float(np.sqrt(np.mean(errs_a**2))),
        max_err_xy=float(errs_a.max()),
        within_3sigma=float(np.mean(errs_a <= 3.0 * sig_a)),
        nan_published=nan_pub,
        mode_switches=switches,
        dropped_at_switches=dropped,
        per_phase_coverage={
            k: phases_pub.get(k, 0) / v for k, v in phase_counts.items()
        },
        nees_xy=float(np.mean((errs_a / sig_a) ** 2)),
        per_phase_rmse={
            k: float(np.sqrt(np.mean(np.square(v))))
            for k, v in phase_errs.items()
        },
    )
