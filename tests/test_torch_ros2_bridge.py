"""The port's ROS2 bridge (``runtime/ros2_bridge.py``) against the JAX
package's, with the fake ``rclpy``, node handle, message classes and tf2
buffer of ``tests/test_ros2_bridge.py`` (imported):

- every test of ``tests/test_ros2_bridge.py`` carried across to the port,
  under the same name, the node on the CPU (``device="cpu"``);
- both bridges create the same publishers and subscriptions (topic, type,
  QoS) under every combination of the conditional ``imu_in`` and
  ``points_raw_out``; the tf2 provider gives the JAX provider's values;
- a synthetic flight pushed through the fake ``rclpy`` publishes twists
  within 1e-3 m/s of the JAX bridge's, on ``torch_bag_parity.PARITY_SCENE``
  (every window an inlier), with equal ``sec``/``nanosec`` stamps;
- without a CUDA device the default device raises, and a missing ``rclpy``
  raises ``ImportError``.
"""

import sys

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (pins torch to one thread)
from test_ros2_bridge import (
    FAKE_TYPES2,
    SENSOR_QOS,
    FakeCameraInfo2,
    FakeFloat64Stamped2,
    FakeImage2,
    FakeImu2,
    FakeOdometry2,
    FakeTfBuffer2,
    FakeTrackerDiag2,
    _Duration2,
    _Stamp2,
    _Time2,
    make_fake_rclpy,
)
from torch_bag_parity import PARITY_OVERRIDES, PARITY_SCENE, TWIST_PARITY

from mrs_optic_flow_tpu.config import load_config as jax_load_config
from mrs_optic_flow_tpu.runtime import ros2_bridge as jax_bridge2
from mrs_optic_flow_tpu_torch.config import load_config
from mrs_optic_flow_tpu_torch.runtime.ros2_bridge import Ros2Bridge, tf2_transform_provider
from mrs_optic_flow_tpu_torch.runtime.ros_bridge import decode_image, from_camera_info
from mrs_optic_flow_tpu_torch.runtime.stream import SyntheticScene
from mrs_optic_flow_tpu_torch.utils.quat_np import np_quat_from_rpy

INJECTED = dict(msg_types=FAKE_TYPES2, time_cls=_Time2, duration_cls=_Duration2,
                sensor_qos=SENSOR_QOS)


def make_bridge(fail_tf=0, **overrides):
    rclpy = make_fake_rclpy()
    buf = FakeTfBuffer2(fail=fail_tf)
    bridge = Ros2Bridge(load_config(overrides=overrides or None), camera_frame="camera",
                        uav_frame="fcu", rclpy_module=rclpy, tf_buffer=buf, device="cpu",
                        **INJECTED)
    return bridge, rclpy, buf


def make_jax_bridge(fail_tf=0, **overrides):
    rclpy = make_fake_rclpy()
    buf = FakeTfBuffer2(fail=fail_tf)
    bridge = jax_bridge2.Ros2Bridge(jax_load_config(overrides=overrides or None),
                                    camera_frame="camera", uav_frame="fcu", rclpy_module=rclpy,
                                    tf_buffer=buf, **INJECTED)
    return bridge, rclpy, buf


# --------------------------------------------------------------------------- #
# topic surface + QoS                                                          #
# --------------------------------------------------------------------------- #

def test_topic_surface_matches_reference():
    """Same topic set as the ROS1 bridge / reference
    (src/optic_flow.cpp:1036-1063), under ROS2's ``~/`` private-namespace
    spelling; conditional imu subscription and raw advertisement hold."""
    bridge, rclpy, _ = make_bridge()
    handle = bridge.handle
    assert rclpy._created == [handle] and handle.name == "optic_flow"
    assert {s.topic for s in handle.subs} == {
        "~/active_tracker_in", "~/camera_info_in", "~/camera_in",
        "~/uav_height_in", "~/odometry_in", "~/imu_in",
    }
    assert {
        "~/velocity_out", "~/velocity_out_longrange",
        "~/velocity_out_longrange_diff", "~/velocity_stddev_out",
        "~/max_velocity_out", "~/allsac_chosen_out", "~/points_raw_out",
    } <= {p.topic for p in handle.pubs}

    bridge2, _, _ = make_bridge(ang_rate_source="odometry")
    assert "~/imu_in" not in {s.topic for s in bridge2.handle.subs}

    bridge3, _, _ = make_bridge(raw_output=False)
    assert "~/points_raw_out" not in {p.topic for p in bridge3.handle.pubs}


def _qos_key(qos):
    return "sensor" if qos is SENSOR_QOS else qos


@pytest.mark.parametrize("overrides", [
    {}, {"ang_rate_source": "odometry"}, {"raw_output": False},
    {"ang_rate_source": "odometry_diff", "raw_output": False},
])
def test_topic_surface_matches_jax(overrides):
    """The same (topic, type, QoS) publishers and subscriptions as the JAX
    bridge on the same config."""
    ours, _, _ = make_bridge(**overrides)
    theirs, _, _ = make_jax_bridge(**overrides)
    for attr in ("pubs", "subs"):
        a = sorted((p.topic, p.type.__name__, _qos_key(p.qos)) for p in getattr(ours.handle, attr))
        b = sorted((p.topic, p.type.__name__, _qos_key(p.qos))
                   for p in getattr(theirs.handle, attr))
        assert a == b, attr


def test_scale_rotation_out_bridged_and_warn_once():
    """``scale_rotation_out`` reaches ROS2 (vz on linear.z, yaw rate on
    angular.z, scale in covariance[14] — the shared ``_PUBLISHERS`` entry),
    and an unmapped topic warns exactly once instead of dropping silently."""
    bridge, _, _ = make_bridge()
    pub = {p.topic: p for p in bridge.handle.pubs}["~/scale_rotation_out"]
    bridge._publish("scale_rotation_out", {"stamp": 3.25, "scale": 0.98, "vz": -0.4,
                                           "yaw_rate": 0.1, "frame_id": "fcu"})
    assert len(pub.sent) == 1
    m = pub.sent[0]
    assert m.twist.twist.linear.z == pytest.approx(-0.4)
    assert m.twist.twist.angular.z == pytest.approx(0.1)
    assert m.twist.covariance[14] == pytest.approx(0.98)
    assert m.header.stamp.sec == 3 and m.header.stamp.nanosec == 250_000_000

    for _ in range(3):
        bridge._publish("mystery_new_topic_out", 1.0)
    assert len(bridge.handle.warned) == 1
    assert "mystery_new_topic_out" in bridge.handle.warned[0]


def test_sensor_topics_use_sensor_qos():
    """Camera + IMU subscribe with the sensor-data QoS profile (camera
    drivers publish best-effort; a reliable subscription gets nothing),
    state topics with the plain depth."""
    bridge, _, _ = make_bridge()
    qos_of = {s.topic: s.qos for s in bridge.handle.subs}
    assert qos_of["~/camera_in"] is SENSOR_QOS
    assert qos_of["~/camera_info_in"] is SENSOR_QOS
    assert qos_of["~/imu_in"] is SENSOR_QOS
    assert qos_of["~/odometry_in"] == 1
    assert qos_of["~/uav_height_in"] == 1


# --------------------------------------------------------------------------- #
# converters under ROS2 shapes                                                 #
# --------------------------------------------------------------------------- #

def test_ros2_stamp_and_camera_info_fields():
    """The shared converters accept ROS2's builtin_interfaces stamps and
    lowercase CameraInfo fields."""
    img = FakeImage2(np.zeros((4, 5), np.uint8), "mono8", stamp=4.25)
    assert decode_image(img).stamp == pytest.approx(4.25)

    ci = from_camera_info(FakeCameraInfo2(k=[420, 0, 376, 0, 420, 240, 0, 0, 1], d=[0.1, -0.2],
                                          binning_x=2))
    assert ci.matrix()[0, 0] == 420 and ci.binning_x == 2
    np.testing.assert_array_equal(ci.dist(), [0.1, -0.2, 0, 0, 0])


def test_tf2_provider_math():
    """cam_yaw = yaw(base2cam) + pi/2 (src/optic_flow.cpp:1203-1208),
    with rclpy Time()/Duration(seconds=) lookup arguments; the JAX
    provider's values on a tilted mount."""
    b2c = tuple(np_quat_from_rpy(0.0, 0.0, 0.7))
    buf = FakeTfBuffer2(c2b=(0, 0, 0, 1), b2c=b2c)
    c2b_quat, cam_yaw = tf2_transform_provider(buf, _Time2, _Duration2, "fcu", "camera")()
    np.testing.assert_allclose(c2b_quat, [0, 0, 0, 1])
    assert abs(cam_yaw - (0.7 + np.pi / 2)) < 1e-9
    assert isinstance(buf.last_args[2], _Time2)
    assert isinstance(buf.last_args[3], _Duration2)
    assert buf.last_args[3].seconds == pytest.approx(2.0)

    buf = FakeTfBuffer2(c2b=tuple(np_quat_from_rpy(0.2, -0.1, 0.4)), b2c=b2c)
    ours = tf2_transform_provider(buf, _Time2, _Duration2, "fcu", "camera")()
    theirs = jax_bridge2.tf2_transform_provider(buf, _Time2, _Duration2, "fcu", "camera")()
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert ours[1] == theirs[1]

    with pytest.raises(RuntimeError):
        tf2_transform_provider(FakeTfBuffer2(fail=1), _Time2, _Duration2, "fcu", "camera")()


def test_builtin_stamp_normalized():
    """Stamps just under a whole second must not round to nanosec == 1e9
    (builtin_interfaces/Time requires nanosec < 1e9)."""
    from mrs_optic_flow_tpu.runtime.ros_bridge import set_builtin_stamp as jax_set
    from mrs_optic_flow_tpu_torch.runtime.ros_bridge import set_builtin_stamp

    st = _Stamp2()
    set_builtin_stamp(st, 5.0 - 2e-10)
    assert (st.sec, st.nanosec) == (5, 0)
    set_builtin_stamp(st, 4.999999999)
    assert st.sec == 4 and st.nanosec == 999999999
    set_builtin_stamp(st, 10.25)
    assert (st.sec, st.nanosec) == (10, 250000000)
    theirs = _Stamp2()
    for t in np.random.default_rng(0).uniform(0.0, 2e9, 200).tolist() + [104.9999999996, 0.0]:
        set_builtin_stamp(st, t)
        jax_set(theirs, t)
        assert (st.sec, st.nanosec) == (theirs.sec, theirs.nanosec), t


def test_warmup_spins_for_camera_info():
    """warmup() before any camera_info spins the executor on the topic
    first — the reference's timerCamInit wait; a silent topic raises at
    the 15 s-analog timeout."""
    bridge, rclpy, _ = make_bridge(mrs_optic_flow={
        "frame_size": 128, "sample_point_size": 16, "scale_factor": 1})
    info_cb = next(s.cb for s in bridge.handle.subs if s.topic == "~/camera_info_in")
    spins = []

    def spin_once(node, timeout_sec=0.1):
        spins.append(timeout_sec)
        if len(spins) == 3:  # camera info "arrives" on the third spin
            info_cb(FakeCameraInfo2(k=[120.0, 0, 64.0, 0, 120.0, 64.0, 0, 0, 1], d=[0.0] * 5))

    rclpy.spin_once = spin_once
    assert not bridge.node.got_camera_info
    bridge.warmup((128, 128))
    assert bridge.node.got_camera_info and len(spins) == 3

    bridge2, rclpy2, _ = make_bridge()
    rclpy2.spin_once = lambda node, timeout_sec=0.1: None
    with pytest.raises(TimeoutError, match="camera info"):
        bridge2.warmup(camera_info_timeout_s=0.2)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the host has a CUDA device")
def test_default_device_needs_cuda():
    rclpy = make_fake_rclpy()
    with pytest.raises(RuntimeError, match="'cuda'"):
        Ros2Bridge(load_config(), rclpy_module=rclpy, tf_buffer=FakeTfBuffer2(), **INJECTED)
    assert rclpy._created[0].subs == []


def test_missing_rclpy_raises_import_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "rclpy", None)
    with pytest.raises(ImportError, match="Ros2Bridge needs rclpy"):
        Ros2Bridge(load_config(), tf_buffer=FakeTfBuffer2(), device="cpu", **INJECTED)


# --------------------------------------------------------------------------- #
# end-to-end through fake ROS2 messages                                        #
# --------------------------------------------------------------------------- #

def _cb(handle, topic):
    return next(s.cb for s in handle.subs if s.topic == "~/" + topic)


def _pub(handle, topic):
    return next(p for p in handle.pubs if p.topic == "~/" + topic)


V_TRUE, DT, H = (0.8, -0.5), 0.05, 2.0


def fly(handle, scene, n_frames):
    """The synthetic constant-velocity flight through the rclpy callbacks:
    a black frame 1 s early (its tf poll fails), then bgr8 frames."""
    _cb(handle, "camera_info_in")(FakeCameraInfo2(k=list(scene.camera_info().k),
                                                  d=list(scene.camera_info().d)))
    _cb(handle, "active_tracker_in")(FakeTrackerDiag2("MpcTracker"))
    _cb(handle, "odometry_in")(FakeOdometry2(9.0))
    _cb(handle, "imu_in")(FakeImu2(9.0))
    _cb(handle, "uav_height_in")(FakeFloat64Stamped2(9.0, H))
    _cb(handle, "camera_in")(FakeImage2(np.zeros((scene.height_px, scene.width, 3), np.uint8),
                                        "bgr8", stamp=9.0))
    for i in range(n_frames):
        t = 10.0 + i * DT
        _cb(handle, "odometry_in")(FakeOdometry2(t))
        _cb(handle, "imu_in")(FakeImu2(t))
        _cb(handle, "uav_height_in")(FakeFloat64Stamped2(t, H))
        frame = scene.render((V_TRUE[0] * i * DT, V_TRUE[1] * i * DT))
        bgr = np.repeat(frame.astype(np.uint8)[:, :, None], 3, axis=2)
        _cb(handle, "camera_in")(FakeImage2(bgr, "bgr8", stamp=t))


def test_e2e_ros2_flight():
    """Synthetic constant-velocity flight through the rclpy callbacks:
    tf resolution via the (initially failing) provider, bgr8 decode, and
    ROS2 twist messages carrying the true velocity with sec/nanosec
    stamps — the ROS2 deployment shape without rclpy installed."""
    bridge, rclpy, buf = make_bridge(fail_tf=1)
    node, handle = bridge.node, bridge.handle
    assert not node.got_tfs
    n_frames = 6
    fly(handle, SyntheticScene(uav_height=2.0, seed=1), n_frames)

    assert node.got_tfs and buf.calls >= 3
    sent = _pub(handle, "velocity_out").sent
    assert len(sent) >= 2
    v = np.array([[m.twist.twist.linear.x, m.twist.twist.linear.y] for m in sent[1:]])
    assert np.abs(v - np.array(V_TRUE)).max() < 0.15, v
    last = sent[-1]
    assert last.header.frame_id == "fcu_untilted"
    t_last = 10.0 + (n_frames - 1) * DT
    assert last.header.stamp.sec == int(t_last)
    assert last.header.stamp.nanosec == pytest.approx(round((t_last - int(t_last)) * 1e9), abs=1)
    cov = np.asarray(last.twist.covariance)
    assert cov.shape == (36,) and cov[0] == pytest.approx((50.0 * H / 420.0) ** 2)

    raw = _pub(handle, "points_raw_out").sent
    assert raw and len(raw[-1].data) == 32  # 16 windows x 2
    lat = _pub(handle, "processing_latency_out").sent
    assert lat and all(isinstance(m.data, float) for m in lat)


def test_e2e_flight_matches_jax_bridge():
    """The same fake ROS2 messages through the port bridge and the JAX
    bridge: the same topics published as often, equal ``sec``/``nanosec``
    stamps and frame ids, every window an inlier, twists within
    ``TWIST_PARITY``."""
    runs = []
    for make in (make_bridge, make_jax_bridge):
        bridge, _, _ = make(fail_tf=1, **PARITY_OVERRIDES)
        fly(bridge.handle, SyntheticScene(**PARITY_SCENE), n_frames=8)
        runs.append({p.topic: p.sent for p in bridge.handle.pubs})
    ours, theirs = runs
    assert {t: len(s) for t, s in ours.items()} == {t: len(s) for t, s in theirs.items()}
    assert [m.data for m in ours["~/allsac_chosen_out"]] == [16] * 7
    assert [m.data for m in theirs["~/allsac_chosen_out"]] == [16] * 7
    assert len(ours["~/velocity_out"]) == 7
    for a, b in zip(ours["~/velocity_out"], theirs["~/velocity_out"]):
        assert (a.header.stamp.sec, a.header.stamp.nanosec) == (b.header.stamp.sec,
                                                                b.header.stamp.nanosec)
        assert a.header.frame_id == b.header.frame_id
        for axis in ("x", "y", "z"):
            assert abs(getattr(a.twist.twist.linear, axis)
                       - getattr(b.twist.twist.linear, axis)) <= TWIST_PARITY, axis
