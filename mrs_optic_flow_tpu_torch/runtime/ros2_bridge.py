"""ROS2 transport adapter: the ``rclpy`` twin of :mod:`.ros_bridge`.

The port's own copy of :mod:`mrs_optic_flow_tpu.runtime.ros2_bridge` (the
port imports nothing of the JAX package), with the port's node on
``device``, as :class:`.ros_bridge.RosBridge`.

The reference deploys on ROS1 (``package.xml``: noetic/melodic), but the
MRS-style UAV stacks its users run are migrating to ROS2.  This bridge
closes that deployment path: the same six input topics, the same output
message types, and the same tf2 camera→body lookup semantics
(``timerTf``, ``src/optic_flow.cpp:1165-1243``) — now over ``rclpy``.

Everything transport-agnostic is shared with the ROS1 bridge: the
duck-typed converters (:func:`.ros_bridge.decode_image`,
``from_camera_info`` — which accepts ROS2's lowercase ``k``/``d`` field
spelling — ``from_imu``, ...), the publisher topic table semantics, and
:class:`~mrs_optic_flow_tpu_torch.runtime.node.OpticFlowNode` itself.  What
differs is only the rclpy surface:

- topics are private-namespace ``~/name`` (ROS2 spells the private
  namespace with a slash);
- ``header.stamp`` is ``builtin_interfaces/Time`` (``sec``/``nanosec``);
- subscriptions/publishers hang off an ``rclpy`` node object
  (``create_subscription`` / ``create_publisher``), camera/IMU topics use
  the sensor-data QoS profile (best-effort — camera drivers publish
  best-effort and a reliable subscription would receive nothing);
- the tf2 listener needs the node (``TransformListener(buffer, node)``).

``rclpy`` and the message packages resolve lazily in ``__init__``;
``rclpy_module`` / ``node_handle`` / ``msg_types`` / ``tf_buffer`` /
``time_cls`` / ``duration_cls`` exist for dependency injection
(``tests/test_torch_ros2_bridge.py`` runs the full surface with fakes).
"""

from __future__ import annotations

import time as _time
from typing import Any, Callable, Dict, Optional

import numpy as np

from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode
from mrs_optic_flow_tpu_torch.runtime.ros_bridge import (
    _PUBLISHERS,
    _import_default_types,
    input_subscriptions,
)
from mrs_optic_flow_tpu_torch.utils.device import DEFAULT_DEVICE
from mrs_optic_flow_tpu_torch.utils.quat_np import np_rpy_from_quat


# ------------------------------------------------------------------ #
# tf2 transform provider (rclpy flavor)                                #
# ------------------------------------------------------------------ #


def tf2_transform_provider(
    buffer, time_cls, duration_cls, uav_frame: str, camera_frame: str,
    timeout_s: float = 2.0,
) -> Callable[[], Optional[tuple]]:
    """``transform_provider`` for :class:`OpticFlowNode` from a tf2_ros
    Buffer under rclpy — the pull-style ``timerTf``
    (``src/optic_flow.cpp:1165-1243``): cam→base rotation from
    ``lookup_transform(uav, camera)`` and ``cam_yaw`` from the yaw of
    ``lookup_transform(camera, uav)`` + π/2 (``:1203-1208``).  tf2
    exceptions propagate; the node's 1 Hz polling treats them as "not
    available yet"."""

    def provider():
        t_c2b = buffer.lookup_transform(
            uav_frame, camera_frame, time_cls(),
            timeout=duration_cls(seconds=timeout_s),
        )
        q = t_c2b.transform.rotation
        c2b = np.array([q.x, q.y, q.z, q.w], np.float64)
        t_b2c = buffer.lookup_transform(
            camera_frame, uav_frame, time_cls(),
            timeout=duration_cls(seconds=timeout_s),
        )
        qb = t_b2c.transform.rotation
        _, _, yaw = np_rpy_from_quat(np.array([qb.x, qb.y, qb.z, qb.w]))
        return c2b, float(yaw) + np.pi / 2
    return provider


# The publisher topic table and dataclass->message builders are SHARED
# with the ROS1 bridge (``ros_bridge._PUBLISHERS``): the builders take a
# ``rospy`` parameter that, when None, fills ROS2 builtin_interfaces
# stamps in place (``ros_bridge.set_builtin_stamp``) instead of
# constructing rospy.Time — one table, no drift between the bridges.


class Ros2Bridge:
    """Run an :class:`OpticFlowNode` on a live ROS2 graph.

    Parameters mirror :class:`.ros_bridge.RosBridge` (``camera_frame`` /
    ``uav_frame`` / ``uav_untilted_frame``); injection points are rclpy-
    shaped: ``rclpy_module`` (the ``rclpy`` package), ``node_handle`` (an
    existing rclpy node — one is created when absent; ``rclpy.init()``
    must have been called by then), ``msg_types``, ``tf_buffer``,
    ``time_cls``/``duration_cls`` (``rclpy.time.Time`` /
    ``rclpy.duration.Duration``), and ``sensor_qos`` (defaults to
    ``rclpy.qos.qos_profile_sensor_data`` for the camera/IMU topics).
    ``device``: where the node this bridge builds runs, as
    :class:`.ros_bridge.RosBridge`'s.
    """

    def __init__(
        self,
        config=None,
        *,
        camera_frame: str = "camera",
        uav_frame: str = "fcu",
        uav_untilted_frame: str = "fcu_untilted",
        node: Optional[OpticFlowNode] = None,
        rclpy_module=None,
        node_handle=None,
        msg_types: Optional[Dict[str, Any]] = None,
        tf_buffer=None,
        time_cls=None,
        duration_cls=None,
        sensor_qos=None,
        queue_size: int = 1,
        device=DEFAULT_DEVICE,
    ):
        if rclpy_module is None:
            try:
                import rclpy as rclpy_module  # noqa: PLC0415
            except ImportError as e:  # pragma: no cover - exercised via fakes
                raise ImportError(
                    "Ros2Bridge needs rclpy (a ROS2 environment); the rest "
                    "of mrs_optic_flow_tpu_torch is transport-agnostic — use "
                    "OpticFlowNode directly or inject rclpy_module="
                ) from e
        self.rclpy = rclpy_module
        if node_handle is None:
            node_handle = rclpy_module.create_node("optic_flow")
        self.handle = node_handle
        self.types = dict(_import_default_types() if msg_types is None else msg_types)

        if time_cls is None or duration_cls is None:
            from rclpy.duration import Duration  # noqa: PLC0415
            from rclpy.time import Time  # noqa: PLC0415

            time_cls = time_cls or Time
            duration_cls = duration_cls or Duration
        if sensor_qos is None:
            try:
                from rclpy.qos import qos_profile_sensor_data  # noqa: PLC0415

                sensor_qos = qos_profile_sensor_data
            except ImportError:  # pragma: no cover - injected in tests
                sensor_qos = queue_size

        if tf_buffer is None:
            import tf2_ros  # noqa: PLC0415

            tf_buffer = tf2_ros.Buffer()
            # keep a reference: the listener fills the buffer asynchronously.
            # spin_thread=True is LOAD-BEARING here: the transform provider
            # runs inside an image callback on the node's executor, and
            # lookup_transform's timeout sleep-polls — without the
            # listener's own executor thread, queued /tf(_static) messages
            # could never be processed during that wait, so the lookup
            # would always time out (rospy's listener always has its own
            # thread, which is why the ROS1 twin needs no flag).
            self._tf_listener = tf2_ros.TransformListener(
                tf_buffer, node_handle, spin_thread=True
            )
        self.tf_buffer = tf_buffer

        provider = tf2_transform_provider(
            tf_buffer, time_cls, duration_cls, uav_frame, camera_frame
        )
        log = self.handle.get_logger().info
        if node is None:
            node = OpticFlowNode(
                config,
                device=device,
                publish=self._publish,
                log=log,
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
                continue  # advertised only when raw output is on (:1043)
            if spec.type_key not in self.types:
                continue
            # "~/name": ROS2's private-namespace spelling of the
            # reference's private nodelet-handle topics
            self._pubs[topic] = self.handle.create_publisher(
                self.types[spec.type_key], "~/" + topic, queue_size
            )

        # camera and IMU on the sensor-data profile, the rest keep-last
        self._subs = [
            self.handle.create_subscription(
                self.types[key], "~/" + topic, cb,
                sensor_qos if sensor else queue_size,
            )
            for topic, key, sensor, cb in input_subscriptions(self)
        ]

    # ------------------------------------------------------------------ #

    def _publish(self, topic: str, msg) -> None:
        pub = self._pubs.get(topic)
        if pub is None:
            # warn once per unbridgeable topic (see ros_bridge._publish)
            if topic not in _PUBLISHERS and topic not in getattr(
                self, "_warned_topics", ()
            ):
                self._warned_topics = getattr(self, "_warned_topics", set())
                self._warned_topics.add(topic)
                self.handle.get_logger().warn(
                    f"[OpticFlow]: output topic {topic!r} has no ROS publisher "
                    "mapping; dropping (extend ros_bridge._PUBLISHERS)"
                )
            return
        spec = _PUBLISHERS[topic]
        pub.publish(spec.build(self.types, None, msg))  # rospy=None -> ROS2

    def warmup(self, image_shape=None, camera_info_timeout_s: float = 15.0) -> None:
        """Build the kernels and run the chain once before streaming.

        ``node.warmup`` needs intrinsics; if none arrived yet this spins
        the rclpy executor on ``camera_info_in`` first — the reference's
        ``timerCamInit`` wait with its 15 s timeout
        (``src/optic_flow.cpp:1102-1158``)."""
        if not self.node.got_camera_info:
            deadline = _time.monotonic() + camera_info_timeout_s
            while (not self.node.got_camera_info
                   and _time.monotonic() < deadline):
                self.rclpy.spin_once(self.handle, timeout_sec=0.1)
            if not self.node.got_camera_info:
                raise TimeoutError(
                    f"no camera info on ~/camera_info_in within "
                    f"{camera_info_timeout_s} s (timerCamInit timeout)"
                )
        self.node.warmup(image_shape)

    def spin(self) -> None:
        """Block servicing callbacks (``rclpy.spin``)."""
        self.rclpy.spin(self.handle)
