"""ROS1 transport adapter: run :class:`OpticFlowNode` as the reference ran.

The port's own copy of :mod:`mrs_optic_flow_tpu.runtime.ros_bridge` (the
port imports nothing of the JAX package): the same converters, publisher
table and bridge, with the port's node on ``device`` (the card unless the
caller passes ``"cpu"``).

The reference is a ROS nodelet (``plugins.xml:2``) whose entire transport
surface is six subscribers, eight publishers, and a 1 Hz tf2 lookup timer
(``src/optic_flow.cpp:1036-1080``, ``timerTf`` ``:1165-1243``).  The node
layer here is deliberately transport-agnostic (callbacks in, a pluggable
``publish(topic, msg)`` out); this module is the thin ROS1 shim that closes
the drop-in gap: a reference user with a running ROS graph points
:class:`RosBridge` at the same topics (the names match the reference's
pre-remap names exactly) and gets the same message types out.

Design rules:

- **No import-time ROS dependency.**  ``rospy`` and the message packages
  resolve lazily inside ``RosBridge.__init__``; everything else in this
  module is pure, duck-typed conversion code, unit-testable (and tested —
  ``tests/test_torch_ros_bridge.py``) with fake modules.
- **Converters are module-level functions** over ROS-message-shaped objects
  (``decode_image``, ``from_camera_info``, ...) so deployments with their
  own middleware loop can reuse them without instantiating the bridge.
- The tf2 lookup mirrors ``timerTf``: cam→base quaternion from
  ``lookupTransform(uav_frame, camera_frame)`` and ``cam_yaw`` = yaw of
  ``lookupTransform(camera_frame, uav_frame)`` + π/2
  (``src/optic_flow.cpp:1176``, ``:1203-1208``), wired through the node's
  ``transform_provider`` hook which already reproduces the 1 Hz
  poll-until-success / stop-on-success policy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np

from mrs_optic_flow_tpu_torch.runtime.msgs import (
    CameraInfo,
    Float64Stamped,
    ImageMsg,
    Imu,
    Odometry,
    TrackerStatus,
    TwistWithCovarianceStamped,
)
from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode
from mrs_optic_flow_tpu_torch.utils.device import DEFAULT_DEVICE
from mrs_optic_flow_tpu_torch.utils.quat_np import np_rpy_from_quat

# ------------------------------------------------------------------ #
# ROS message -> dataclass converters (pure, duck-typed)              #
# ------------------------------------------------------------------ #

#: encoding -> (channels, layout); layout "bgr"/"rgb" orders the color
#: channels, "gray" is single-channel.  The reference funnels everything
#: through ``cv_bridge::toCvCopy(msg, "bgr8")`` (src/optic_flow.cpp:1465);
#: the node's grayscale mix expects BGR, so rgb inputs are reordered here.
_ENCODINGS: Dict[str, tuple] = {
    "bgr8": (3, "bgr"),
    "rgb8": (3, "rgb"),
    "bgra8": (4, "bgr"),
    "rgba8": (4, "rgb"),
    "mono8": (1, "gray"),
    "8uc1": (1, "gray"),
    "8uc3": (3, "bgr"),
}


def _stamp(msg) -> float:
    """``header.stamp`` as seconds — accepts rospy.Time, a ROS2
    ``builtin_interfaces/Time`` (``sec``/``nanosec``), or a plain float."""
    st = msg.header.stamp
    if hasattr(st, "to_sec"):
        return float(st.to_sec())
    if hasattr(st, "nanosec"):  # ROS2 builtin_interfaces/msg/Time
        return float(st.sec) + float(st.nanosec) * 1e-9
    return float(st)


def decode_image(msg) -> ImageMsg:
    """sensor_msgs/Image -> :class:`ImageMsg` without cv_bridge.

    Handles the 8-bit encodings (bgr8/rgb8/bgra8/rgba8/mono8/8UC1/8UC3) and
    respects ``step`` (row stride) padding.  The cv_bridge the reference
    uses does the same normalization to BGR8 (``src/optic_flow.cpp:1465``).
    """
    enc = str(msg.encoding).lower()
    if enc not in _ENCODINGS:
        raise ValueError(
            f"unsupported image encoding {msg.encoding!r}; expected one of "
            f"{sorted(_ENCODINGS)} (the reference's cv_bridge path is bgr8)"
        )
    ch, layout = _ENCODINGS[enc]
    h, w, step = int(msg.height), int(msg.width), int(msg.step)
    if step < w * ch:
        raise ValueError(f"image step {step} < width*channels {w * ch}")
    buf = np.frombuffer(bytes(msg.data), np.uint8)
    if buf.size < h * step:
        raise ValueError(f"image data {buf.size} B < height*step {h * step} B")
    rows = buf[: h * step].reshape(h, step)
    if ch == 1:
        img = rows[:, :w]
    else:
        img = rows[:, : w * ch].reshape(h, w, ch)[:, :, :3]  # drop alpha
        if layout == "rgb":
            img = img[:, :, ::-1]
    return ImageMsg(stamp=_stamp(msg), data=np.ascontiguousarray(img))


def from_camera_info(msg) -> CameraInfo:
    """sensor_msgs/CameraInfo -> :class:`CameraInfo` (K/D/binning as decoded
    by ``callbackCameraInfo``, src/optic_flow.cpp:1496-1520; D may be empty
    for pre-calibrated streams — the reference falls back to zeros).  ROS2
    renamed the matrix fields lowercase (``k``/``d``); both spellings are
    accepted so the ROS1 and ROS2 bridges share this converter."""
    raw_d = msg.D if hasattr(msg, "D") else msg.d
    raw_k = msg.K if hasattr(msg, "K") else msg.k
    d = list(raw_d) if len(raw_d) else [0.0] * 5
    if len(d) < 5:
        d = d + [0.0] * (5 - len(d))
    return CameraInfo(k=list(raw_k), d=d, binning_x=int(msg.binning_x))


def from_imu(msg) -> Imu:
    av, q = msg.angular_velocity, msg.orientation
    return Imu(
        stamp=_stamp(msg),
        angular_velocity=(float(av.x), float(av.y), float(av.z)),
        orientation=(float(q.x), float(q.y), float(q.z), float(q.w)),
    )


def from_odometry(msg) -> Odometry:
    q = msg.pose.pose.orientation
    lin = msg.twist.twist.linear
    ang = msg.twist.twist.angular
    return Odometry(
        stamp=_stamp(msg),
        orientation=(float(q.x), float(q.y), float(q.z), float(q.w)),
        linear_velocity=(float(lin.x), float(lin.y), float(lin.z)),
        angular_velocity=(float(ang.x), float(ang.y), float(ang.z)),
    )


def from_float64_stamped(msg) -> Float64Stamped:
    """mrs_msgs/Float64Stamped (the height topic's type,
    ``src/optic_flow.cpp:1274-1301``)."""
    return Float64Stamped(stamp=_stamp(msg), value=float(msg.value))


def from_tracker_diag(msg) -> TrackerStatus:
    """mrs_msgs/ControlManagerDiagnostics subset
    (``callbackControlManagerDiag``, src/optic_flow.cpp:1253-1266)."""
    return TrackerStatus(active_tracker=str(msg.active_tracker))


# ------------------------------------------------------------------ #
# tf2 transform provider                                              #
# ------------------------------------------------------------------ #


def tf_transform_provider(
    buffer, rospy, uav_frame: str, camera_frame: str, timeout_s: float = 2.0
) -> Callable[[], Optional[tuple]]:
    """Build a ``transform_provider`` for :class:`OpticFlowNode` from a
    tf2_ros Buffer — the pull-style ``timerTf`` (``src/optic_flow.cpp:
    1165-1243``): cam→base rotation from ``lookupTransform(uav, camera)``
    and ``cam_yaw`` from the yaw of ``lookupTransform(camera, uav)`` + π/2
    (``:1203-1208``).  tf2 exceptions propagate; the node's polling treats
    them as "not available yet" and retries at 1 Hz."""

    def provider():
        t_c2b = buffer.lookup_transform(
            uav_frame, camera_frame, rospy.Time(0), rospy.Duration(timeout_s)
        )
        q = t_c2b.transform.rotation
        c2b = np.array([q.x, q.y, q.z, q.w], np.float64)
        t_b2c = buffer.lookup_transform(
            camera_frame, uav_frame, rospy.Time(0), rospy.Duration(timeout_s)
        )
        qb = t_b2c.transform.rotation
        _, _, yaw = np_rpy_from_quat(np.array([qb.x, qb.y, qb.z, qb.w]))
        return c2b, float(yaw) + np.pi / 2
    return provider


# ------------------------------------------------------------------ #
# the bridge                                                          #
# ------------------------------------------------------------------ #


@dataclasses.dataclass
class _PubSpec:
    """One advertised topic: its ROS type key and dataclass->ROS builder."""

    type_key: str
    build: Callable[[Any, Any, Any], Any]  # (types, rospy, payload) -> msg


def set_builtin_stamp(stamp_field, t: float) -> None:
    """Fill a ROS2 ``builtin_interfaces/Time`` in place from float seconds,
    normalized so ``0 <= nanosec < 1e9`` (a bare ``round()`` can emit
    nanosec == 1e9 for stamps just under a whole second)."""
    ns = int(round(t * 1e9))
    stamp_field.sec = ns // 1_000_000_000
    stamp_field.nanosec = ns % 1_000_000_000


def _build_twist(types, rospy, tw: TwistWithCovarianceStamped):
    m = types["TwistWithCovarianceStamped"]()
    m.header.frame_id = tw.frame_id
    if rospy is None:  # ROS2: builtin_interfaces/Time, set in place
        set_builtin_stamp(m.header.stamp, tw.stamp)
    else:
        m.header.stamp = rospy.Time.from_sec(tw.stamp)
    lin, ang = m.twist.twist.linear, m.twist.twist.angular
    lin.x, lin.y, lin.z = tw.linear
    ang.x, ang.y, ang.z = tw.angular
    m.twist.covariance = list(np.asarray(tw.covariance, np.float64))
    return m


def _build_vector3(types, rospy, v):
    m = types["Vector3"]()
    m.x, m.y, m.z = (float(x) for x in np.asarray(v).reshape(3))
    return m


def _build_float32(types, rospy, v):
    m = types["Float32"]()
    m.data = float(v)
    return m


def _build_int32(types, rospy, v):
    m = types["Int32"]()
    m.data = int(v)
    return m


def _build_float64_array(types, rospy, v):
    m = types["Float64MultiArray"]()
    m.data = [float(x) for x in np.asarray(v, np.float64).ravel()]
    return m


def _build_scale_rotation(types, rospy, d):
    """``scale_rotation_out`` payload (the node's dict: stamp / scale / vz /
    yaw_rate / frame_id) as a TwistWithCovarianceStamped — vertical velocity
    on linear.z, yaw rate on angular.z (the two quantities the reference's
    commented wiring derives, ``src/optic_flow.cpp:1636-1649``), NaN on the
    axes the estimator does not observe, and the raw frame-to-frame scale
    factor preserved in ``covariance[14]`` (the z-z slot) so no information
    is dropped at the transport boundary."""
    nan = float("nan")
    cov = [0.0] * 36
    cov[14] = float(d["scale"])
    tw = TwistWithCovarianceStamped(
        frame_id=str(d.get("frame_id", "")),
        stamp=float(d["stamp"]),
        linear=(nan, nan, float(d["vz"])),
        angular=(nan, nan, float(d["yaw_rate"])),
        covariance=tuple(cov),
    )
    return _build_twist(types, rospy, tw)


#: node output topic -> ROS message mapping.  Names and types match the
#: reference's advertisements (src/optic_flow.cpp:1036-1046) with two
#: deliberate deviations (ARCHITECTURE.md): ``points_raw_out`` carries the
#: raw sub-pixel shifts as Float64MultiArray (the reference advertises
#: UInt32MultiArray but never publishes, and its shifts are fractional),
#: and ``processing_latency_out`` is an extra diagnostics topic.
_PUBLISHERS: Dict[str, _PubSpec] = {
    "velocity_out": _PubSpec("TwistWithCovarianceStamped", _build_twist),
    "velocity_out_longrange": _PubSpec("TwistWithCovarianceStamped", _build_twist),
    "velocity_out_longrange_diff": _PubSpec(
        "TwistWithCovarianceStamped", _build_twist
    ),
    "velocity_stddev_out": _PubSpec("Vector3", _build_vector3),
    "max_velocity_out": _PubSpec("Float32", _build_float32),
    "allsac_chosen_out": _PubSpec("Int32", _build_int32),
    "points_raw_out": _PubSpec("Float64MultiArray", _build_float64_array),
    "processing_latency_out": _PubSpec("Float32", _build_float32),
    "scale_rotation_out": _PubSpec(
        "TwistWithCovarianceStamped", _build_scale_rotation
    ),
}

#: every topic OpticFlowNode can emit — the advertisement surface both
#: bridges must cover (asserted by tests/test_torch_ros_bridge.py; the reference's
#: advertisement block is src/optic_flow.cpp:1036-1046).  Keep in sync with
#: the node's ``self.publish(...)`` call sites.
NODE_OUTPUT_TOPICS = (
    "velocity_out",
    "velocity_out_longrange",
    "velocity_out_longrange_diff",
    "velocity_stddev_out",
    "max_velocity_out",
    "allsac_chosen_out",
    "points_raw_out",
    "processing_latency_out",
    "scale_rotation_out",
)


def _import_default_types() -> Dict[str, Any]:
    from geometry_msgs.msg import (  # noqa: PLC0415
        TwistWithCovarianceStamped as RosTwist,
        Vector3,
    )
    from std_msgs.msg import (  # noqa: PLC0415
        Float32,
        Float64MultiArray,
        Int32,
    )
    from nav_msgs.msg import Odometry as RosOdometry  # noqa: PLC0415
    from sensor_msgs.msg import (  # noqa: PLC0415
        CameraInfo as RosCameraInfo,
        Image as RosImage,
        Imu as RosImu,
    )

    types: Dict[str, Any] = {
        "TwistWithCovarianceStamped": RosTwist,
        "Vector3": Vector3,
        "Float32": Float32,
        "Int32": Int32,
        "Float64MultiArray": Float64MultiArray,
        "Image": RosImage,
        "CameraInfo": RosCameraInfo,
        "Imu": RosImu,
        "Odometry": RosOdometry,
    }
    # mrs_msgs mirrors the reference's height/tracker types; optional so the
    # bridge still runs against plain-ROS graphs that remap those topics to
    # compatible custom types via the `msg_types` override.
    try:
        from mrs_msgs.msg import (  # noqa: PLC0415
            ControlManagerDiagnostics,
            Float64Stamped as MrsFloat64Stamped,
        )

        types["Float64Stamped"] = MrsFloat64Stamped
        types["ControlManagerDiagnostics"] = ControlManagerDiagnostics
    except ImportError:
        pass
    return types


def input_subscriptions(bridge) -> list:
    """The input topics of ``bridge`` (either bridge) as ``(topic, type key,
    sensor data, callback)``: the reference's six (``src/optic_flow.cpp:
    1049-1063``), the IMU only when ``ang_rate_source == "imu"`` (``:1060``).
    ``sensor data``: the topic takes ROS2's best-effort sensor QoS.  A type
    missing from ``bridge.types`` (no mrs_msgs) raises ``KeyError``."""
    node = bridge.node
    subs = [
        ("active_tracker_in", "ControlManagerDiagnostics", False,
         lambda m: node.on_tracker_status(from_tracker_diag(m))),
        ("camera_info_in", "CameraInfo", True, lambda m: node.on_camera_info(from_camera_info(m))),
        ("camera_in", "Image", True, lambda m: node.on_image(decode_image(m))),
        ("uav_height_in", "Float64Stamped", False, lambda m: node.on_height(from_float64_stamped(m))),
        ("odometry_in", "Odometry", False, lambda m: node.on_odometry(from_odometry(m))),
    ]
    if node.config.ang_rate_source == "imu":  # the reference's conditional (:1060)
        subs.append(("imu_in", "Imu", True, lambda m: node.on_imu(from_imu(m))))
    for topic, key, _, _ in subs:
        if key not in bridge.types:
            raise KeyError(
                f"message type {key!r} for topic {topic!r} is not "
                f"available; install mrs_msgs or pass msg_types={{...}}"
            )
    return subs


class RosBridge:
    """Run an :class:`OpticFlowNode` on a live ROS1 graph.

    Subscribes the reference's six input topics (same pre-remap names under
    the node's private namespace — the reference uses its private nodelet
    handle — ``src/optic_flow.cpp:1049-1063``; remap with ROS's standard
    machinery, e.g. ``launch/optic_flow_tpu.launch``),
    converts to the transport-agnostic dataclasses, and republishes the
    node's outputs as the reference's message types.  The IMU topic is only
    subscribed when ``ang_rate_source == "imu"`` and ``points_raw_out`` is
    only advertised when ``raw_output`` is set — both exactly as the
    reference (``:1060-1063``, ``:1043-1046``).

    Parameters mirror the launch-file surface: ``camera_frame`` /
    ``uav_frame`` for the tf2 lookups (``loadParam("camera_frame", ...)``,
    src/optic_flow.cpp:827-830).  ``rospy_module`` / ``msg_types`` /
    ``tf_buffer`` exist for dependency injection (tests, custom stacks);
    by default the real ``rospy``, message packages, and a
    ``tf2_ros.Buffer`` + ``TransformListener`` are used.  ``device`` is
    where the node this bridge builds runs: the card (``"cuda"``) unless
    the caller passes ``"cpu"``; without a CUDA device the default raises
    (``utils/device.resolve_device``).  A ``node`` passed in keeps its own.
    """

    def __init__(
        self,
        config=None,
        *,
        camera_frame: str = "camera",
        uav_frame: str = "fcu",
        uav_untilted_frame: str = "fcu_untilted",
        node: Optional[OpticFlowNode] = None,
        rospy_module=None,
        msg_types: Optional[Dict[str, Any]] = None,
        tf_buffer=None,
        queue_size: int = 1,
        device=DEFAULT_DEVICE,
    ):
        if rospy_module is None:
            try:
                import rospy as rospy_module  # noqa: PLC0415
            except ImportError as e:  # pragma: no cover - exercised via fakes
                raise ImportError(
                    "RosBridge needs rospy (a ROS1 environment); the rest of "
                    "mrs_optic_flow_tpu_torch is transport-agnostic — use "
                    "OpticFlowNode directly or inject rospy_module="
                ) from e
        self.rospy = rospy_module
        self.types = dict(_import_default_types() if msg_types is None else msg_types)

        if tf_buffer is None:
            import tf2_ros  # noqa: PLC0415

            tf_buffer = tf2_ros.Buffer()
            # keep a reference: the listener fills the buffer asynchronously
            self._tf_listener = tf2_ros.TransformListener(tf_buffer)
        self.tf_buffer = tf_buffer

        provider = tf_transform_provider(
            tf_buffer, self.rospy, uav_frame, camera_frame
        )
        if node is None:
            node = OpticFlowNode(
                config,
                device=device,
                publish=self._publish,
                log=self.rospy.loginfo,
                uav_frame=uav_frame,
                uav_untilted_frame=uav_untilted_frame,
                transform_provider=provider,
            )
        else:
            node.publish = self._publish
            if node.transform_provider is None:
                node.transform_provider = provider
        self.node = node

        c = self.node.config
        self._pubs: Dict[str, Any] = {}
        for topic, spec in _PUBLISHERS.items():
            if topic == "points_raw_out" and not c.raw_output:
                continue  # advertised only when raw output is enabled (:1043)
            if spec.type_key not in self.types:
                continue
            # "~" = the node's private namespace: the reference advertises
            # and subscribes on its private nodelet handle, so its topics
            # live under ~ and the stock launch remaps target ~names
            # (launch/optic_flow.launch:45-58)
            self._pubs[topic] = self.rospy.Publisher(
                "~" + topic, self.types[spec.type_key], queue_size=queue_size
            )

        self._subs = [
            self.rospy.Subscriber(
                "~" + topic, self.types[key], cb, queue_size=queue_size,
                tcp_nodelay=True,
            )
            for topic, key, _, cb in input_subscriptions(self)
        ]

    # ------------------------------------------------------------------ #

    def _publish(self, topic: str, msg) -> None:
        pub = self._pubs.get(topic)
        if pub is None:
            # warn ONCE per unbridgeable topic instead of dropping silently —
            # an unknown topic here means the node grew an output the bridge
            # table doesn't cover (invisible data loss at integration time).
            # Topics deliberately not advertised (points_raw_out without
            # raw_output, a type missing from msg_types) stay quiet.
            if topic not in _PUBLISHERS and topic not in getattr(
                self, "_warned_topics", ()
            ):
                self._warned_topics = getattr(self, "_warned_topics", set())
                self._warned_topics.add(topic)
                self.rospy.logwarn(
                    f"[OpticFlow]: output topic {topic!r} has no ROS publisher "
                    "mapping; dropping (extend ros_bridge._PUBLISHERS)"
                )
            return
        spec = _PUBLISHERS[topic]
        pub.publish(spec.build(self.types, self.rospy, msg))

    def warmup(self, image_shape=None, camera_info_timeout_s: float = 15.0) -> None:
        """Build the kernels and run the chain once before streaming
        (node.warmup).

        ``node.warmup`` needs intrinsics; if no camera info has arrived yet
        this blocks on the ``camera_info_in`` topic first — the reference's
        ``timerCamInit`` wait with its 15 s timeout
        (``src/optic_flow.cpp:1102-1158``).
        """
        if not self.node.got_camera_info:
            msg = self.rospy.wait_for_message(
                "~camera_info_in",
                self.types["CameraInfo"],
                timeout=camera_info_timeout_s,
            )
            self.node.on_camera_info(from_camera_info(msg))
        self.node.warmup(image_shape)

    def spin(self) -> None:
        """Block servicing callbacks (``rospy.spin``)."""
        self.rospy.spin()
