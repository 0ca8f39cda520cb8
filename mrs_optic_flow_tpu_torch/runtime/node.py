"""OpticFlowNode — the node in PyTorch.

Port of :class:`mrs_optic_flow_tpu.runtime.node.OpticFlowNode`, the
transport-agnostic rebuild of the ROS nodelet ``mrs_optic_flow/OpticFlow``
(``src/optic_flow.cpp:808-1871``): the sensor callbacks and readiness gates,
the per-frame chain raw camera frame -> body-frame twist, diagnostics,
warm-up, checkpoints and health.  Published messages go through a pluggable
``publish(topic, msg)`` callable.

Each frame runs one eager function on the node's device.  With method 4
(:meth:`_frame_step`): preprocess -> ``FftMethod.step`` (kernel A on a CUDA
device, or kernel D for a patch kernel A does not take) -> ``get_rt`` ->
detilt and body rotation (on a CUDA device kernel G, the body frame its
epilogue); in long-range mode (:meth:`_frame_step_lr`, chosen
per frame by ``long_range_mode``): preprocess -> ``FftMethod.step_long_range``
on the downsampled frames -> ``get_2dt`` -> body rotation.  With the
block-matching methods 3 and 5 (:meth:`_frame_step_simple`): preprocess ->
the SAD engine (kernel C) -> per-cell velocities -> consensus by
``filter_method`` -> body rotation.  With ``scale_rotation`` the log-polar
estimator (kernel B) runs in the same function on the same full-resolution
gray frame.  The frame and one packed parameter vector go up, and one
``summary`` tensor comes back: one readback per frame, as in the JAX node.
The whole of it, uploads and readback included, is one function on static
buffers (:meth:`_chain_body`); on a CUDA device
:class:`~mrs_optic_flow_tpu_torch.runtime.frame_graph.FrameGraphs` captures
it once per chain and input geometry and replays it a frame, so that a
frame is one graph launch and one host synchronisation.

Options of the JAX node: ``tpu.host_preprocess`` runs the native fused
grayscale and crop on the host and uploads the ``frame_size``² window
(:meth:`_maybe_host_preprocess`); ``store_video`` records the flow overlay
to ``video_path`` (``.ofrec`` through the native Recorder, else an AVI at
``video_fps``) and ``gui`` shows it with OpenCV, which disables itself with
one log line where OpenCV or a display is missing (:meth:`_record_overlay`).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from mrs_optic_flow_tpu_torch import native
from mrs_optic_flow_tpu_torch.config import NodeConfig
from mrs_optic_flow_tpu_torch.convert import node_state_from_numpy
from mrs_optic_flow_tpu_torch.filters.allsac import allsac_mean, point_mean, ransac_mean
from mrs_optic_flow_tpu_torch.filters.stats import SpeedBox, analyze_speeds
from mrs_optic_flow_tpu_torch.geometry.motion import get_2dt, get_rt_body_frame
from mrs_optic_flow_tpu_torch.geometry.rotations import quat_rotate
from mrs_optic_flow_tpu_torch.models import (
    FftMethod,
    ScaleRotationConfig,
    ScaleRotationEstimator,
    make_engine,
)
from mrs_optic_flow_tpu_torch.models.base import FlowState
from mrs_optic_flow_tpu_torch.models.scale_rotation import ScaleRotState
from mrs_optic_flow_tpu_torch.ops.preprocess import center_crop, resize_by, to_grayscale
from mrs_optic_flow_tpu_torch.runtime.frame_graph import FrameGraphs
from mrs_optic_flow_tpu_torch.runtime.msgs import (
    CameraInfo,
    Float64Stamped,
    ImageMsg,
    Imu,
    Odometry,
    TrackerStatus,
    TwistWithCovarianceStamped,
)
from mrs_optic_flow_tpu_torch.runtime.profiler import Profiler, ThrottledLog
from mrs_optic_flow_tpu_torch.runtime.viz import VideoWriter, flow_overlay
from mrs_optic_flow_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from mrs_optic_flow_tpu_torch.utils.quat_np import (
    np_quat_from_rpy,
    np_quat_inverse,
    np_quat_multiply,
    np_rpy_from_quat,
)

#: the ``torch.profiler`` ranges around the stages of a frame's chain
#: (``scripts/profile_torch_node.py --split``); a range shows only in a
#: trace of the eager chain, not inside a graph replay
STAGES = ("node.gray", "node.engine", "node.get_rt+body_frame", "node.get_2dt", "node.consensus",
          "node.body_frame", "node.scale_rotation")
stage = torch.profiler.record_function

# The per-frame parameter vector: :func:`pack_params` packs it on the host,
# the device chains read each field through its index or slice here.
P_HEIGHT, P_DT = 0, 1
P_CAM = slice(2, 11)  # K, row-major
P_DIST = slice(11, 16)
P_C2B = slice(16, 20)
P_RATE_QUAT = slice(20, 24)
P_DETILT = slice(24, 28)
P_HEIGHT_LR, P_ROLL_RATE, P_PITCH_RATE, P_CAM_YAW = 28, 29, 30, 31


def pack_params(height, dt, cam, dist, c2b, rate_quat, detilt, height_lr, roll_rate,
                pitch_rate, cam_yaw) -> np.ndarray:
    """The float32 vector of the ``P_*`` fields, in their order."""
    return np.concatenate([
        [height, dt], np.ravel(cam), np.ravel(dist)[:5], c2b, rate_quat, detilt,
        [height_lr, roll_rate, pitch_rate, cam_yaw],
    ]).astype(np.float32)


class OpticFlowNode:
    def __init__(
        self,
        config: Optional[NodeConfig] = None,
        *,
        device=DEFAULT_DEVICE,
        publish: Optional[Callable[[str, object], None]] = None,
        log: Callable[[str], None] = print,
        uav_frame: str = "fcu",
        uav_untilted_frame: str = "fcu_untilted",
        enable_profiler: bool = True,
        transform_provider: Optional[Callable[[], object]] = None,
    ):
        """``device``: where the frame chain runs; the card (``"cuda"``,
        which launches the hand-written kernels) unless the caller passes
        ``"cpu"``, and without a CUDA device the default raises.
        ``transform_provider``: optional zero-argument callable returning
        the camera->base quaternion ``[x, y, z, w]``, a
        ``(c2b_quat, cam_yaw)`` tuple, or ``None``; polled at most once per
        second from the image path until it succeeds (the reference's 1 Hz
        ``timerTf``, ``src/optic_flow.cpp:1165-1243``)."""
        self.config = config or NodeConfig()
        c = self.config
        self.device = resolve_device(device)
        self.publish = publish or (lambda topic, msg: None)
        self.log = log
        self.log_throttled = ThrottledLog(1.0, log)
        self.uav_frame = uav_frame
        self.uav_untilted_frame = uav_untilted_frame
        self.profiler = Profiler("OpticFlow", enable_profiler)

        engine_kwargs = dict(frame_size=c.frame_size, sample_point_size=c.sample_point_size)
        if c.method == 4:
            self.engine = make_engine(
                4, device=self.device, **engine_kwargs,
                max_pixel_speed=c.max_pixel_speed, use_pallas=c.use_pallas,
                backend=c.backend, quantize_8bit=c.quantize_8bit,
                long_range_ratio=c.long_range_ratio,
            )
        else:
            # the SAD engines follow use_pallas only when the YAML set it
            if c.use_pallas_explicit:
                engine_kwargs["use_pallas"] = c.use_pallas
            self.engine = make_engine(
                c.method, device=self.device, **engine_kwargs,
                scan_radius=c.scan_radius, step_size=c.step_size,
            )
        self.flow_state = self.engine.init_state()

        self.scale_rotation_estimator: Optional[ScaleRotationEstimator] = None
        self.scale_rot_state = None
        if c.scale_rotation:
            # the estimator shares the flow engine's use_pallas, backend and
            # quantize_8bit, as in the JAX node
            self.scale_rotation_estimator = ScaleRotationEstimator(
                ScaleRotationConfig(
                    resolution=c.frame_size, magnitude=c.scale_rot_magnitude,
                    interp=c.scale_rot_interp,
                    lp_resolution=c.scale_rot_lp_resolution or None,
                    backend=c.backend, use_pallas=c.use_pallas,
                    quantize_8bit=c.quantize_8bit,
                ),
                device=self.device,
            )
            self.scale_rot_state = self.scale_rotation_estimator.init_state()

        # sensor fusion state (src/optic_flow.cpp:160-330)
        self.got_camera_info = False
        self.got_image = False
        self.got_height = False
        self.got_imu = False
        self.got_odometry = False
        self.got_tfs = False
        self.got_active_tracker = False

        self.camera_matrix: Optional[np.ndarray] = None
        self.dist_coeffs: Optional[np.ndarray] = None
        self.uav_height = 0.0
        self.angular_rate = np.zeros(3)
        self.angular_rate_quat = np.asarray([0.0, 0.0, 0.0, 1.0])
        self.imu_roll = self.imu_pitch = self.imu_yaw = 0.0
        self.imu_roll_rate = self.imu_pitch_rate = 0.0
        self.odom_rpy = np.zeros(3)
        self.odometry_speed = np.zeros(2)
        self.odometry_orientation = np.asarray([0.0, 0.0, 0.0, 1.0])
        self.active_tracker = ""
        self.angle_diff = np.zeros(3)
        self._tilt_prev = np.asarray([0.0, 0.0, 0.0, 1.0])

        self.c2b_quat = np.asarray([0.0, 0.0, 0.0, 1.0])
        self.cam_yaw = 0.0
        self.transform_provider = transform_provider
        self._tf_poll_next = -np.inf

        self.first_image = True
        self._begin: Optional[float] = None
        self.dt = 0.0
        self._mutex = threading.Lock()  # mutex_process_ (src/optic_flow.cpp:1683)
        #: RANSAC draws: one generator on the node's device, seeded 0 like
        #: the JAX node's PRNGKey(0)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        #: the frame chains as static-buffer steps, one CUDA graph a key on
        #: the card; the carries every graph reads and overwrites in place
        self._graphs = FrameGraphs(self.device, generators=(self._gen,))
        self._carry = self.flow_state.prev
        self._sr_carry = (self.scale_rot_state.prev_logpolar
                          if self.scale_rot_state is not None else None)
        self._frames_processed = 0
        self._consecutive_failures = 0
        #: rolling (flow, odometry) speed samples over analyze_duration
        self._speed_history: list = []
        #: tpu.host_preprocess's native binding, resolved at the first frame
        #: (None: not yet, False: unavailable, else the module)
        self._host_pre = None
        #: store_video's sink (None: not yet opened or unavailable)
        self._recorder = None
        self._recorder_opened = False
        self._gui_failed = False
        #: set by :meth:`warmup`: its zero frames are not recorded or shown
        self._warming = False

    # ------------------------------------------------------------------ #
    # callbacks                                                           #
    # ------------------------------------------------------------------ #

    def on_camera_info(self, msg: CameraInfo):
        """``callbackCameraInfo`` (``src/optic_flow.cpp:1496-1531``)."""
        if self.got_camera_info:
            return
        if msg.binning_x != 0:
            self.log_throttled("binning", "[OpticFlow]: TODO: deal with binning")
        if len(msg.k) < 6 or len(msg.d) < 5:
            self.log_throttled("calib", "[OpticFlow]: camera info has wrong calibration")
            return
        self.camera_matrix = msg.matrix()
        self.dist_coeffs = msg.dist()
        self.got_camera_info = True

    def on_height(self, msg: Float64Stamped):
        """``callbackHeight`` (``src/optic_flow.cpp:1270-1293``)."""
        if abs(msg.value) < 0.001:
            return
        self.uav_height = float(msg.value)
        self.got_height = True

    def on_imu(self, msg: Imu):
        """``callbackImu`` (``src/optic_flow.cpp:1299-1341``)."""
        if self.config.ang_rate_source == "imu":
            self.angular_rate = np.asarray(msg.angular_velocity, float)
            # setRPY on angular rates (:1313)
            self.angular_rate_quat = np_quat_from_rpy(*self.angular_rate)
            self.got_imu = True
        self.imu_roll, self.imu_pitch, self.imu_yaw = np_rpy_from_quat(
            np.asarray(msg.orientation, float)
        )
        self.imu_roll_rate = float(msg.angular_velocity[0])
        self.imu_pitch_rate = float(msg.angular_velocity[1])

    def on_odometry(self, msg: Odometry):
        """``callbackOdometry`` (``src/optic_flow.cpp:1347-1375``)."""
        if self.config.ang_rate_source == "odometry":
            self.angular_rate = np.asarray(msg.angular_velocity, float)
            self.angular_rate_quat = np_quat_from_rpy(*self.angular_rate)
        self.odometry_speed = np.asarray(msg.linear_velocity[:2], float)
        self.odometry_orientation = np.asarray(msg.orientation, float)
        self.odom_rpy = np.asarray(np_rpy_from_quat(np.asarray(msg.orientation, float)))
        self.got_odometry = True

    def on_tracker_status(self, msg: TrackerStatus):
        """``callbackControlManagerDiag`` (``src/optic_flow.cpp:1253-1266``)."""
        self.active_tracker = msg.active_tracker
        self.got_active_tracker = True

    def set_transforms(self, c2b_quat, cam_yaw: Optional[float] = None):
        """Camera->base rotation quaternion; ``cam_yaw`` defaults to (yaw of
        the inverse) + pi/2 (``src/optic_flow.cpp:1206-1208``)."""
        self.c2b_quat = np.asarray(c2b_quat, float)
        if cam_yaw is None:
            _, _, yaw = np_rpy_from_quat(np_quat_inverse(self.c2b_quat))
            cam_yaw = float(yaw) + np.pi / 2
        self.cam_yaw = float(cam_yaw)
        self.got_tfs = True

    def poll_transforms(self, now: float) -> bool:
        """Run the ``transform_provider`` at most once per second until it
        yields a transform; a raising provider is a failed lookup.  Returns
        ``got_tfs``."""
        if self.got_tfs or self.transform_provider is None:
            return self.got_tfs
        if now < self._tf_poll_next:
            return False
        self._tf_poll_next = now + 1.0
        try:
            result = self.transform_provider()
        except Exception as e:  # noqa: BLE001 — the TransformException path
            self.log(f"[OpticFlow]: TF: {type(e).__name__}: {e}")
            return False
        if result is None:
            return False
        if isinstance(result, tuple) and len(result) == 2:
            c2b, cam_yaw = result
            self.set_transforms(c2b, float(cam_yaw))
        else:
            self.set_transforms(result)
        self.log("[OpticFlow]: got TFs, stopping transform polling")
        return True

    def poll_camera_init(self, now: float) -> Optional[str]:
        """timerCamInit analogue (``src/optic_flow.cpp:1102-1158``): camera
        info must follow the first image within 15 s.  Returns
        "waiting_image" / "waiting_info" / "timeout" / None (ready)."""
        if not self.got_image:
            self._caminfo_deadline = now + 15.0
            self.log_throttled("caminit", "[OpticFlow]: waiting for camera")
            return "waiting_image"
        if self.got_camera_info:
            return None
        if not hasattr(self, "_caminfo_deadline"):
            self._caminfo_deadline = now + 15.0
        if now < self._caminfo_deadline:
            self.log_throttled("caminit", "[OpticFlow]: waiting for camera info")
            return "waiting_info"
        self.log_throttled(
            "caminit",
            "[OpticFlow]: missing camera calibration parameters "
            "(nothing on camera_info / wrong matrices)",
        )
        return "timeout"

    def is_uav_landoff(self) -> bool:
        """``isUavLandoff`` (``src/optic_flow.cpp:364-384``)."""
        if not self.got_active_tracker:
            self.log_throttled("tracker", "[OpticFlow]: tracker status not available")
            return False
        return self.active_tracker == "LandoffTracker"

    def _resolve_long_range(self) -> bool:
        """The four ``long_range_mode`` policies (``src/optic_flow.cpp:1575-1585``)."""
        mode = self.config.long_range_mode
        if mode == "always_on":
            return True
        if mode == "takeoff_based":
            return self.is_uav_landoff()
        if mode == "height_based":
            return self.uav_height < self.config.takeoff_height
        return False  # always_off

    # ------------------------------------------------------------------ #
    # image path                                                          #
    # ------------------------------------------------------------------ #

    def on_image(self, msg: ImageMsg) -> Optional[TwistWithCovarianceStamped]:
        """``callbackImage`` (``src/optic_flow.cpp:1381-1489``) +
        ``processImage`` (``:1541-1871``).  Returns the published twist, or
        None when the frame is gated or fails."""
        if self.first_image or self._begin is None:
            self._begin = msg.stamp
        self.dt = msg.stamp - self._begin
        self._begin = msg.stamp

        if not self.got_odometry:
            self.log_throttled("odom", "[OpticFlow]: waiting for odometry")
            return None
        if self.config.ang_rate_source == "imu" and not self.got_imu:
            self.log_throttled("imu", "[OpticFlow]: waiting for imu")
            return None
        if not self.got_tfs and not self.poll_transforms(msg.stamp):
            self.log_throttled("tf", "[OpticFlow]: waiting for camera transforms")
            return None
        if not (np.isfinite(self.imu_roll) and np.isfinite(self.imu_pitch)):
            self.log_throttled("imunan", "[OpticFlow]: IMU data contains NaNs")
            return None
        if self.dt < 0.0 and not self.first_image:
            self.log_throttled("negdt", f"[OpticFlow]: time delta negative: {self.dt}")
            return None
        if abs(self.dt) < 0.001 and not self.first_image:
            self.log_throttled("smalldt", f"[OpticFlow]: time delta too small: {self.dt}")
            return None
        self.got_image = True
        if not self.first_image and self.dt < 1.0 / self.config.max_processing_rate:
            return None  # rate cap (src/optic_flow.cpp:1440)

        if self.config.ang_rate_source == "odometry_diff":
            # orientation delta since the previous frame, as a rate (:1453-1464,
            # ARCHITECTURE.md deviation 12)
            tilt_curr = self.odometry_orientation
            diff = np_quat_multiply(np_quat_inverse(self._tilt_prev), tilt_curr)
            self.angle_diff = np.asarray(np_rpy_from_quat(diff))
            self.angular_rate_quat = np_quat_from_rpy(*(self.angle_diff / max(self.dt, 1e-6)))
            self._tilt_prev = tilt_curr

        # per-frame fault containment: a malformed frame must not take the
        # stream down (the reference wraps publishing in try/catch,
        # src/optic_flow.cpp:1770-1776; widened to the whole frame)
        t0 = time.perf_counter()
        try:
            return self._process_image(msg)
        except Exception as e:  # noqa: BLE001
            self.log_throttled(
                "frame_fail",
                f"[OpticFlow]: frame at t={msg.stamp} failed: {type(e).__name__}: {e}",
            )
            self._note_result(False)
            return None
        finally:
            # raw-image-to-publish wall latency, a diagnostics topic
            try:
                self.publish("processing_latency_out", time.perf_counter() - t0)
            except Exception:  # noqa: BLE001 — a raising transport must not mask the result
                pass

    def _gray(self, img: torch.Tensor, channels: int, cx_eff: int) -> torch.Tensor:
        """Preprocess: grayscale, optional resize and the centre crop, or
        the frame as it is when it already is the cropped gray window."""
        c = self.config
        h, w = img.shape[0], img.shape[1]
        with stage("node.gray"):
            if channels == 1 and (h, w) == (c.frame_size, c.frame_size):
                return img.to(torch.float32)
            g = to_grayscale(img) if channels == 3 else img.to(torch.float32)
            if abs(c.scale_factor - 1.0) > 0.01:
                g = resize_by(g, c.scale_factor)
            return center_crop(g, c.frame_size, cx_eff)

    def _maybe_host_preprocess(self, img: np.ndarray, channels: int, cx_eff: int):
        """``tpu.host_preprocess``: the native fused uint8 grayscale and crop
        (``native.gray_crop``, or ``native.crop`` of a gray frame) on the
        host, so the upload is the ``frame_size``² gray window instead of
        the whole frame (4.7x fewer bytes at 752x480x3 -> 480²; the
        reference preprocesses on the host too, ``src/optic_flow.cpp:
        1602-1622``).  The crop corner is the device path's
        (``ops/preprocess.py::center_crop``) and the gray weights OpenCV's
        fixed-point ones, at most 1 uint8 LSB from the device's float mix.
        Inputs the native path cannot honour (not uint8, ``scale_factor !=
        1``, a crop that touches the image edge) and an unavailable native
        library fall back to device preprocessing with a throttled log."""
        c = self.config
        if self._host_pre is None:  # resolve the native binding once
            try:
                native.load()
                self._host_pre = native
            except Exception as e:  # noqa: BLE001 — build and load can fail many ways
                self._host_pre = False
                self.log(f"[OpticFlow]: host_preprocess unavailable "
                         f"({type(e).__name__}: {e}); preprocessing on device")
        if self._host_pre is False:
            return img, channels
        fs = c.frame_size
        h, w = int(img.shape[0]), int(img.shape[1])
        if channels == 1 and (h, w) == (fs, fs):
            return img, channels  # already the cropped gray window
        xi, yi = cx_eff - fs // 2, h // 2 - fs // 2
        eligible = (
            channels in (1, 3) and img.dtype == np.uint8 and abs(c.scale_factor - 1.0) <= 0.01
            and 0 <= xi and xi + fs <= w and 0 <= yi and yi + fs <= h
        )
        if not eligible:
            self.log_throttled(
                "hostpre",
                "[OpticFlow]: host_preprocess cannot honor this input "
                "(format/scale_factor/edge crop); preprocessing on device",
            )
            return img, channels
        if channels == 3:
            return self._host_pre.gray_crop(img, cx_eff, h // 2, fs), 1
        return self._host_pre.crop(img, cx_eff, h // 2, fs), 1

    def _record_overlay(self, stamp: float, gray: torch.Tensor, flow, scale: float = 1.0):
        """``gui`` and ``store_video``, one overlay render for both
        (``runtime/viz.py::flow_overlay`` of the gray window and the gated
        shifts, ``scale`` converting them to full-resolution pixels).

        ``store_video`` (``src/FftMethod.cpp:1695-1704``, ``:1895-1897``):
        a ``.ofrec`` ``video_path`` records a timestamped native-Recorder
        stream, any other path an AVI at ``video_fps`` (``viz.VideoWriter``,
        grayscale like the reference's ``isColor=false``).  ``gui``
        (``src/FftMethod.cpp:1886-1892``): ``cv2.imshow`` of the overlay,
        disabled with one log line at the first failure (no OpenCV or no
        display)."""
        c = self.config
        overlay = None

        def render():
            return flow_overlay(gray.cpu().numpy(), flow.shifts.cpu().numpy(),
                                c.sample_point_size, scale=scale)

        if c.gui and not self._gui_failed:
            overlay = render()
            try:
                import cv2  # noqa: PLC0415

                cv2.imshow("optic_flow", overlay)
                cv2.waitKey(1)
            except Exception as e:  # noqa: BLE001 — no OpenCV or no display
                self.log(f"[OpticFlow]: gui disabled: {e}")
                self._gui_failed = True
        if not c.store_video:
            return
        if not self._recorder_opened:
            self._recorder_opened = True
            try:
                if c.video_path.endswith(".ofrec"):
                    self._recorder = native.Recorder(c.video_path, width=c.frame_size,
                                                     height=c.frame_size)
                else:
                    self._recorder = VideoWriter(c.video_path, width=c.frame_size,
                                                 height=c.frame_size, fps=c.video_fps)
            except Exception as e:  # noqa: BLE001 — no toolchain or an unwritable path
                self.log(f"[OpticFlow]: could not open video recorder: {e}")
                self._recorder = None
        if self._recorder is not None:
            overlay = render() if overlay is None else overlay
            if isinstance(self._recorder, VideoWriter):
                self._recorder.write(overlay)  # AVI frames carry no stamp
            else:
                self._recorder.write(stamp, overlay)

    def close(self):
        """Release the video sink (an AVI's index is written here; the file
        is valid after every frame regardless) and the frame graphs."""
        if self._recorder is not None:
            self._recorder.close()
        self._recorder = None
        self._graphs.close()

    def _sr_step(self, gray: torch.Tensor):
        """Step the scale/rotation estimator on the frame's gray window:
        ``(new state, summary slots [scale, rot])``, or ``(None, [])``
        without an estimator."""
        sr = self.scale_rotation_estimator
        if sr is None:
            return None, []
        with stage("node.scale_rotation"):
            state, res = sr.step(self.scale_rot_state, gray)
            return state, [res.scale.reshape(1), res.rotation.reshape(1)]

    def _frame_step(self, gray: torch.Tensor, params: torch.Tensor, cx_eff: int):
        """The method-4 device chain on the gray window: engine step ->
        getRT -> detilt and body-frame rotation (``get_rt_body_frame``: one
        launch of kernel G on the card).  ``params`` is
        :func:`pack_params`'s vector.
        Returns the new flow and scale/rotation states, the ``summary``
        vector ``[ok, tran_b (3), ang (3), n_inliers, ang_diff_rejected]``,
        then ``[scale, rot]`` with scale/rotation, then the raw shifts with
        ``raw_output``, and the engine's ``FlowResult``."""
        c = self.config
        height, dt = params[P_HEIGHT], params[P_DT]
        cam = params[P_CAM].reshape(3, 3)
        dist, c2b = params[P_DIST], params[P_C2B]
        rate_quat, detilt = params[P_RATE_QUAT], params[P_DETILT]

        with stage("node.engine"):
            flow_state, flow = self.engine.step(self.flow_state, gray)
        with stage("node.get_rt+body_frame"):
            # getRT, then detilt * (C2B * tran) (src/optic_flow.cpp:1694)
            # and the rotation axis into the body frame, rotation only
            # (:1747): on the card one launch of kernel G, the body frame its
            # epilogue
            head = get_rt_body_frame(
                flow.shifts, height, dt, float(cx_eff - c.frame_size // 2), cam, dist, c2b,
                rate_quat, detilt, frame_size=c.frame_size, patch=c.sample_point_size,
                generator=self._gen, shifted_pts_thr=c.shifted_pts_thr,
            )
        sr_state, sr_parts = self._sr_step(gray)
        parts = [head, *sr_parts]
        if c.raw_output:
            parts.append(flow.shifts_raw.reshape(-1))
        return flow_state, sr_state, torch.cat(parts), flow

    def _frame_step_lr(self, gray: torch.Tensor, params: torch.Tensor):
        """The long-range device chain (the JAX node's ``_frame_program_lr``,
        ``src/optic_flow.cpp:1779-1867``): ``step_long_range`` on frames
        downsampled by ``long_range_ratio`` -> ``get2DT`` with the
        tilt-corrected height ``height_lr`` (``:1781``) -> body-frame rotation
        of the velocity and of its rate-correction delta.  Same ``params`` as
        :meth:`_frame_step`; no random draws.  Returns the new states and the
        summary ``[ok, tran_b (3), diff_b (3)]``, then ``[scale, rot]`` with
        scale/rotation (on the full-resolution gray, like the reference's
        ``imCurr_`` feed), then the long-range shifts with ``raw_output``, and
        the engine's ``FlowResult``."""
        c = self.config
        dt, cam, c2b = params[P_DT], params[P_CAM].reshape(3, 3), params[P_C2B]
        height_lr, roll_rate = params[P_HEIGHT_LR], params[P_ROLL_RATE]
        pitch_rate, cam_yaw = params[P_PITCH_RATE], params[P_CAM_YAW]
        with stage("node.engine"):
            flow_state, flow = self.engine.step_long_range(self.flow_state, gray)
        with stage("node.get_2dt"):
            res = get_2dt(flow.shifts, height_lr, dt, cam, roll_rate, pitch_rate, cam_yaw,
                          long_range_ratio=self.engine.config.long_range_ratio)
        with stage("node.body_frame"):
            body = [quat_rotate(c2b, res.tran), quat_rotate(c2b, res.tran_diff)]
        sr_state, sr_parts = self._sr_step(gray)
        parts = [res.ok.to(torch.float32)[None], *body, *sr_parts]
        if c.raw_output:
            parts.append(flow.shifts_raw.reshape(-1))
        return flow_state, sr_state, torch.cat(parts), flow

    def _frame_step_simple(self, gray: torch.Tensor, params: torch.Tensor):
        """The methods-3/5 device chain (the JAX node's
        ``_frame_program_simple``): SAD engine step -> per-cell metric
        velocities ``v = -d * h / f / dt`` -> consensus by ``filter_method``
        (allsac, ransac or average, ``src/utilityFunctions.cpp:58-216``) ->
        body-frame rotation.  Same ``params`` as :meth:`_frame_step`.
        Returns the new states, the summary ``[ok, tran_b (3)]``, then
        ``[scale, rot]`` with scale/rotation, then the per-cell shifts with
        ``raw_output``, and the engine's ``FlowResult``."""
        c = self.config
        height, dt = params[P_HEIGHT], params[P_DT]
        cam = params[P_CAM].reshape(3, 3)
        c2b = params[P_C2B]

        with stage("node.engine"):
            flow_state, flow = self.engine.step(self.flow_state, gray)
        with stage("node.consensus"):
            cells = flow.shifts_raw.reshape(-1, 2)
            vels = -cells * torch.stack([height / cam[0, 0], height / cam[1, 1]]) / dt
            valid = torch.isfinite(vels).all(dim=-1)
            vels = torch.where(valid[:, None], vels, torch.zeros((), device=vels.device))
            thr_sq = c.ransac_threshold_rad ** 2
            if c.filter_method == "allsac":
                vec, _ = allsac_mean(vels, valid, thr_sq)
            elif c.filter_method == "ransac":
                vec = ransac_mean(
                    vels, valid, thr_sq, num_of_chosen=c.ransac_num_of_chosen,
                    num_of_iterations=c.ransac_num_of_iter, generator=self._gen,
                )
            else:  # "average"
                vec = point_mean(vels, valid)
            ok = valid.any() & torch.isfinite(vec).all()
        with stage("node.body_frame"):
            tran_b = quat_rotate(c2b, torch.cat([vec, torch.zeros(1, dtype=vec.dtype, device=vec.device)]))
        sr_state, sr_parts = self._sr_step(gray)
        parts = [ok.to(torch.float32)[None], tran_b, *sr_parts]
        if c.raw_output:
            parts.append(cells.reshape(-1))
        return flow_state, sr_state, torch.cat(parts), flow

    def _carries_in(self) -> None:
        """Point the node's carries at the static buffers every graph reads,
        copying in a carry assigned since (``load_state``, ``warmup``'s
        restore, a state set from outside)."""
        fs, srs = self.flow_state, self.scale_rot_state
        if fs.prev is not self._carry:
            self._carry.copy_(fs.prev)
            self.flow_state = FlowState(prev=self._carry, first=fs.first)
        if srs is not None and srs.prev_logpolar is not self._sr_carry:
            self._sr_carry.copy_(srs.prev_logpolar)
            self.scale_rot_state = ScaleRotState(prev_logpolar=self._sr_carry, first=srs.first)

    def _chain_body(self, slot, channels: int, cx_eff: int, simple: bool, long_range: bool):
        """One frame's device work on ``slot``'s static buffers, from the
        uploads to the readback: what a graph captures.  The new carries
        overwrite the static ones.  Returns ``(host summary, gray, flow)``."""
        frame, params = slot.upload()
        gray = self._gray(frame, channels, cx_eff)
        if simple:
            states = self._frame_step_simple(gray, params)
        elif long_range:
            states = self._frame_step_lr(gray, params)
        else:
            states = self._frame_step(gray, params, cx_eff)
        flow_state, sr_state, summary, flow = states
        self._carry.copy_(flow_state.prev)
        if sr_state is not None:
            self._sr_carry.copy_(sr_state.prev_logpolar)
        return slot.read_back(summary), gray, flow

    def _run_chain(self, img: np.ndarray, channels: int, params: np.ndarray, cx_eff: int,
                   simple: bool, long_range: bool):
        """The frame through its chain: eagerly on a stream's first frame
        (the carry is set there, ``models/fft_method.py``'s first-frame
        copy), through the key's graph after that.  Returns ``(host
        summary, gray, flow)``, the first filled once
        :meth:`FrameGraphs.wait` returns."""
        c = self.config
        sr = self.scale_rotation_estimator is not None
        chain = "simple" if simple else "long_range" if long_range else "short_range"
        key = (chain, img.shape, img.dtype.str, channels, cx_eff, c.raw_output, sr)
        slot = self._graphs.slot(key, img, len(params))
        slot.load(img, params)
        self._carries_in()
        first = self.flow_state.first or (sr and self.scale_rot_state.first)
        out = self._graphs.run(
            slot, lambda: self._chain_body(slot, channels, cx_eff, simple, long_range),
            capture=not first,
        )
        self.flow_state = FlowState(prev=self._carry, first=False)
        if sr:
            self.scale_rot_state = ScaleRotState(prev_logpolar=self._sr_carry, first=False)
        return out

    def _process_image(
        self, msg: ImageMsg, long_range: Optional[bool] = None
    ) -> Optional[TwistWithCovarianceStamped]:
        """One frame through the node's chain.  ``long_range`` (default: the
        ``long_range_mode`` policy) picks the method-4 mode."""
        if self.first_image:
            self.first_image = False
            return None  # wait for two images (src/optic_flow.cpp:1544-1547)
        if not self.got_camera_info:
            self.log_throttled("caminfo", "[OpticFlow]: waiting for camera info!")
            return None
        if not self.got_height:
            self.log_throttled("height", "[OpticFlow]: waiting for uav height!")
            return None

        c = self.config
        height = self.uav_height
        img = np.asarray(msg.data)
        channels = img.shape[2] if img.ndim == 3 else 1
        cx = float(self.camera_matrix[0, 2])
        if abs(c.scale_factor - 1.0) > 0.01:
            cx_eff = int(cx / c.scale_factor)
            # intrinsics of the downscaled image (ARCHITECTURE.md deviation 22)
            cam_eff = np.array(self.camera_matrix, float)
            cam_eff[:2, :] /= c.scale_factor
        else:
            cx_eff = int(cx)
            cam_eff = self.camera_matrix
        if c.host_preprocess:
            img, channels = self._maybe_host_preprocess(img, channels, cx_eff)

        # detilt (src/optic_flow.cpp:1702); tilt_correction and its deadband
        # are live here (ARCHITECTURE.md deviation list)
        tilt = float(np.hypot(self.imu_roll, self.imu_pitch))
        detilted = c.tilt_correction and tilt >= c.minimum_tilt_correction
        if detilted:
            detilt = np_quat_from_rpy(self.imu_roll, self.imu_pitch, 0.0)
        else:
            detilt = np.asarray([0.0, 0.0, 0.0, 1.0])
        frame_id = self.uav_untilted_frame if detilted else self.uav_frame

        # get2DT takes the height corrected by the static tilt (:1781)
        height_lr = height / (np.cos(self.imu_pitch) * np.cos(self.imu_roll))
        params = pack_params(height, self.dt, cam_eff, self.dist_coeffs, self.c2b_quat,
                             self.angular_rate_quat, detilt, height_lr, self.imu_roll_rate,
                             self.imu_pitch_rate, self.cam_yaw)
        simple = not isinstance(self.engine, FftMethod)
        if long_range is None:
            long_range = self._resolve_long_range()
        long_range = long_range and not simple
        routine = ("frame_program_simple" if simple
                   else "frame_program_lr" if long_range else "frame_program")
        with self._mutex:
            with self.profiler.routine(routine):
                host_summary, gray, flow = self._run_chain(img, channels, params, cx_eff,
                                                           simple, long_range)
            # ONE readback: [ok, tran_b (3)(, ang (3), n_inliers,
            # ang_diff_rejected | , diff_b (3))(, scale, rot)(, raw shifts)];
            # the next frame overwrites the host vector and a replay's
            # outputs, so they are read under the lock
            self._graphs.wait()
            summary = host_summary.numpy().copy()
            if (c.store_video or c.gui) and not self._warming:
                # long-range shifts are measured on the downsampled frames:
                # scaled to full-resolution pixels for the overlay
                self._record_overlay(msg.stamp, gray, flow,
                                     scale=float(c.long_range_ratio) if long_range else 1.0)
        k = 4 if simple else 7 if long_range else 9
        sr = self.scale_rotation_estimator is not None
        # the raw shifts first, then scale/rotation, as the JAX node publishes
        if c.raw_output:
            self.publish("points_raw_out", summary[k + 2 * sr:].reshape(-1, 2))
        if sr:
            # published regardless of the flow gate: the estimators are
            # independent (src/optic_flow.cpp:1629-1650)
            self._publish_scale_rotation(msg.stamp, float(summary[k]), float(summary[k + 1]), height)
        if not bool(summary[0] > 0.5):
            if not (simple or long_range) and bool(summary[8] > 0.5):
                # src/optic_flow.cpp:682-684 (throttled, 1 Hz)
                self.log_throttled(
                    "angdiff", "[OpticFlow]: Angle difference greater than pi/4, skipping."
                )
            self._note_result(False)
            return None
        tran_b = summary[1:4]
        fx = float(cam_eff[0, 0])
        if long_range:
            return self._publish_long_range(msg.stamp, tran_b, summary[4:7], height, fx)
        if simple:
            # methods 3/5: a planar velocity in the body frame, no vertical
            # or angular estimate
            if not np.all(np.isfinite(tran_b[:2])):
                self._note_result(False)
                return None
            twist = TwistWithCovarianceStamped.make(
                frame_id=self.uav_frame,
                stamp=msg.stamp,
                linear=(float(tran_b[0]), float(tran_b[1]), float("nan")),
                angular=(float("nan"),) * 3,
                cov_xy=(50.0 * height / fx) ** 2,
            )
            self.publish("velocity_out", twist)
            self._note_result(True)
            self._frames_processed += 1
            return twist

        ang = [float(a) for a in summary[4:7]]
        n_inliers = int(summary[7])
        if not np.all(np.isfinite(tran_b)):
            self.log("[OpticFlow]: NaNs in output, returning.")
            self._note_result(False)
            return None
        if np.linalg.norm(tran_b) > 7.0:
            self.log(f"[OpticFlow]: LARGE SPEED: {tran_b}")

        twist = TwistWithCovarianceStamped.make(
            frame_id=frame_id,
            stamp=msg.stamp,
            linear=tuple(float(x) for x in tran_b),
            angular=tuple(ang),
            cov_xy=(50.0 * height / fx) ** 2,  # 5 px expected error (:1757-1763)
        )
        self.publish("velocity_out", twist)
        self._publish_diagnostics(msg.stamp, tran_b[:2], height, fx, n_inliers)
        self._note_result(True)
        self._frames_processed += 1
        return twist

    def _publish_long_range(self, stamp, tran_b, diff_b, height: float, fx: float):
        """The long-range outputs (``src/optic_flow.cpp:1779-1867``):
        ``velocity_out_longrange`` and ``velocity_out_longrange_diff`` in the
        body frame ``uav_frame``, planar, with z and the angular rate NaN and
        their covariances 666 (``:1839-1846``).  Returns the first."""
        if not np.all(np.isfinite(tran_b[:2])):
            self.log("[OpticFlow]: NaNs in output, returning.")
            self._note_result(False)
            return None
        twists = []
        for topic, vec_b in (("velocity_out_longrange", tran_b),
                             ("velocity_out_longrange_diff", diff_b)):
            twist = TwistWithCovarianceStamped.make(
                frame_id=self.uav_frame,
                stamp=stamp,
                linear=(float(vec_b[0]), float(vec_b[1]), float("nan")),
                angular=(float("nan"),) * 3,
                cov_xy=(50.0 * height / fx) ** 2,
                cov_z=666.0,
                cov_ang=666.0,
            )
            self.publish(topic, twist)
            twists.append(twist)
        self._note_result(True)
        self._frames_processed += 1
        return twists[0]

    def _publish_scale_rotation(self, stamp, scale: float, rotation: float, height: float):
        """``scale_rotation_out``: the frame's scale and rotation, the yaw
        rate, and the vertical speed from the scale change (``velocity``
        mode; ``altitude`` mode is the reference's disabled stub and emits
        0).  The reference's wiring is commented out
        (``src/optic_flow.cpp:1629-1650``); the JAX node's is live.

        Tilt gate (deviation 23): the log-polar decode assumes a centred
        zoom and rotation, so beyond ``scale_rot_max_tilt`` or
        ``scale_rot_max_tilt_rate`` the decode is published as NaN; the
        message still goes out every frame."""
        c = self.config
        tilt = float(np.hypot(self.imu_roll, self.imu_pitch))
        tilt_rate = float(np.hypot(self.imu_roll_rate, self.imu_pitch_rate))
        if tilt > c.scale_rot_max_tilt or tilt_rate > c.scale_rot_max_tilt_rate:
            scale, rotation = float("nan"), float("nan")
        rot_rate = rotation / self.dt if self.dt > 0 else float("nan")
        if c.scale_rot_output == "velocity":
            vz = (scale - 1.0) / self.dt * height if self.dt > 0 else float("nan")
        else:
            vz = 0.0
        self.publish(
            "scale_rotation_out",
            {"stamp": stamp, "scale": scale, "vz": vz, "yaw_rate": rot_rate,
             "frame_id": self.uav_frame},
        )

    def _publish_diagnostics(self, stamp, v_xy, height, fx, n_inliers):
        """Diagnostics the reference advertises but never publishes
        (``src/optic_flow.cpp:1036-1045``): ``allsac_chosen_out`` (RANSAC
        inlier count), ``max_velocity_out`` (``max_pixel_speed * height /
        (fx * dt)``) and ``velocity_stddev_out`` (flow vs odometry over the
        ``analyze_duration`` window, ``analyzeSpeeds``)."""
        self.publish("allsac_chosen_out", int(n_inliers))
        if self.dt > 0:
            self.publish(
                "max_velocity_out",
                float(self.config.max_pixel_speed * height / (fx * self.dt)),
            )
        self._speed_history.append(
            SpeedBox(time=stamp, speed=np.asarray(v_xy), odometry_speed=self.odometry_speed.copy())
        )
        cutoff = stamp - self.config.analyze_duration
        self._speed_history = [s for s in self._speed_history if s.time > cutoff - 5.0]
        sd = analyze_speeds(cutoff, self._speed_history)
        if sd.num >= 2:
            self.publish("velocity_stddev_out", (sd.std_dev_x, sd.std_dev_y, 0.0))

    def warmup(self, image_shape=None) -> float:
        """Run one synthetic frame per input geometry through the whole
        chain, in both modes of method 4, as a steady frame (on a CUDA
        device this builds the kernel libraries and captures each chain's
        graph), without touching the live stream: the flow and
        scale/rotation carries (their values, in the static buffers the
        graphs read), diagnostics history, health counters and the random
        generator are restored.  Requires camera info.  Returns the wall
        time spent."""
        if not self.got_camera_info:
            raise RuntimeError("warmup needs camera info (on_camera_info first)")
        t0 = time.perf_counter()
        c = self.config
        shapes = (
            [image_shape] if image_shape is not None
            # the raw-BGR path and the pre-cropped grayscale path
            else [(480, 752, 3), (c.frame_size, c.frame_size)]
        )
        saved = (
            self.flow_state, self.scale_rot_state, self.first_image, self._begin, self.dt,
            self.got_height, self.got_odometry, self.got_imu, self.got_tfs,
            self.uav_height, list(self._speed_history), self._frames_processed,
            self._consecutive_failures, self._gen.get_state(),
        )
        carries = [self.flow_state.prev.clone()]
        if self.scale_rot_state is not None:
            carries.append(self.scale_rot_state.prev_logpolar.clone())
        pub = self.publish
        self.publish = lambda *a: None
        # the zero frames reach neither the recording nor the GUI
        self._warming = True
        try:
            self.got_height = self.got_odometry = self.got_imu = self.got_tfs = True
            self.first_image = False
            self._begin = 0.0
            self.dt = 0.05
            self.uav_height = max(self.uav_height, 1.0)
            # steady frames: each key's graph is captured here, not in the stream
            self.flow_state = self.flow_state._replace(first=False)
            if self.scale_rot_state is not None:
                self.scale_rot_state = self.scale_rot_state._replace(first=False)
            modes = (False, True) if isinstance(self.engine, FftMethod) else (False,)
            for long_range in modes:
                for shape in shapes:
                    self._process_image(ImageMsg(stamp=0.05, data=np.zeros(shape, np.uint8)),
                                        long_range=long_range)
        finally:
            self.publish = pub
            self._warming = False
            (
                self.flow_state, self.scale_rot_state, self.first_image, self._begin, self.dt,
                self.got_height, self.got_odometry, self.got_imu, self.got_tfs,
                self.uav_height, self._speed_history, self._frames_processed,
                self._consecutive_failures, gen_state,
            ) = saved
            # the warm-up frames wrote the static carries: their values back
            self.flow_state.prev.copy_(carries[0])
            if self.scale_rot_state is not None:
                self.scale_rot_state.prev_logpolar.copy_(carries[1])
            # in place: the graphs hold this generator's state, not a copy
            self._gen.set_state(gen_state)
        return time.perf_counter() - t0

    # ------------------------------------------------------------------ #
    # state checkpoint / resume + health                                  #
    # ------------------------------------------------------------------ #

    def save_state(self, path: str):
        """Checkpoint the streaming state in the JAX node's ``.npz`` format
        (``runtime/node.py:1036-1075`` of the JAX package), which that node
        can load too, the scale/rotation carry included."""
        if not path.endswith(".npz"):
            path += ".npz"
        np.savez(
            path,
            prev=self.flow_state.prev.cpu().numpy(),
            first=np.asarray(self.flow_state.first),
            begin=np.asarray(self._begin if self._begin is not None else np.nan),
            first_image=np.asarray(self.first_image),
            uav_height=np.asarray(self.uav_height),
            angular_rate_quat=self.angular_rate_quat,
            c2b_quat=self.c2b_quat,
            cam_yaw=np.asarray(self.cam_yaw),
            camera_matrix=self.camera_matrix if self.camera_matrix is not None else np.zeros(0),
            dist_coeffs=self.dist_coeffs if self.dist_coeffs is not None else np.zeros(0),
            got_height=np.asarray(self.got_height),
            got_tfs=np.asarray(self.got_tfs),
            sr_lp=(
                self.scale_rot_state.prev_logpolar.cpu().numpy()
                if self.scale_rot_state is not None else np.zeros(0)
            ),
            sr_first=np.asarray(
                self.scale_rot_state.first if self.scale_rot_state is not None else True
            ),
        )

    def load_state(self, path: str):
        """Resume from a checkpoint written by either node.  A flow or
        log-polar carry of another geometry raises ``ValueError``; one of the
        other dtype is converted."""
        if not path.endswith(".npz"):
            path += ".npz"
        proto = self.engine.init_state().prev
        sr = self.scale_rotation_estimator
        sr_proto = sr.init_state().prev_logpolar if sr is not None else None
        with np.load(path) as z:
            st = node_state_from_numpy(
                z, self.device, carry_shape=tuple(proto.shape), carry_dtype=proto.dtype,
                sr_shape=tuple(sr_proto.shape) if sr is not None else None,
                sr_dtype=sr_proto.dtype if sr is not None else None,
            )
        self.flow_state = st.flow_state
        self._begin = st.begin
        self.first_image = st.first_image
        self.uav_height = st.uav_height
        self.angular_rate_quat = st.angular_rate_quat
        self.c2b_quat = st.c2b_quat
        self.cam_yaw = st.cam_yaw
        if st.camera_matrix is not None:
            self.camera_matrix = st.camera_matrix
            self.dist_coeffs = st.dist_coeffs
            self.got_camera_info = True
        if st.got_height is not None:
            self.got_height = st.got_height
            self.got_tfs = st.got_tfs
        if st.sr_lp is not None:
            self.scale_rot_state = ScaleRotState(prev_logpolar=st.sr_lp, first=st.sr_first)

    @property
    def health(self) -> dict:
        """Failure-detection summary: the reference's silent per-frame skips
        exposed as data."""
        return {
            "frames_processed": self._frames_processed,
            "consecutive_failures": self._consecutive_failures,
            "ready": self.got_camera_info and self.got_height and self.got_odometry
            and self.got_tfs and (self.got_imu or self.config.ang_rate_source != "imu"),
        }

    def _note_result(self, ok: bool):
        self._consecutive_failures = 0 if ok else self._consecutive_failures + 1
        if not ok and self._consecutive_failures in (10, 100, 1000):
            self.log_throttled(
                "health",
                f"[OpticFlow]: {self._consecutive_failures} consecutive frames "
                "without a valid motion estimate",
            )
