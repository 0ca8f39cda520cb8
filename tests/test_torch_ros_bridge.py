"""The port's ROS1 bridge (``runtime/ros_bridge.py``) against the JAX
package's, with the fake ``rospy``, message classes and tf2 buffer of
``tests/test_ros_bridge.py`` (imported):

- every test of ``tests/test_ros_bridge.py`` carried across to the port,
  under the same name, the node on the CPU (``device="cpu"``);
- the converters give the JAX converters' dataclass fields on the same fake
  messages, and the publisher builders the same message fields;
- both bridges advertise and subscribe the same topics with the same types,
  under every combination of the conditional ``imu_in`` subscription and
  ``points_raw_out`` advertisement;
- a synthetic flight pushed through the fake ``rospy`` publishes twists
  within 1e-3 m/s of the JAX bridge's (every window an inlier, so the two
  nodes' different RANSAC draws give the same refit, as
  ``test_torch_node.py``);
- without a CUDA device the bridge's default device raises, and a missing
  ``rospy`` raises ``ImportError``.
"""

import sys

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (pins torch to one thread)
from test_ros_bridge import (
    FAKE_TYPES,
    FakeCameraInfo,
    FakeFloat64Stamped,
    FakeImage,
    FakeImu,
    FakeOdometry,
    FakeTfBuffer,
    FakeTrackerDiag,
    _Time,
    make_fake_rospy,
)

from mrs_optic_flow_tpu.config import load_config as jax_load_config
from mrs_optic_flow_tpu.runtime import ros_bridge as jax_bridge
from mrs_optic_flow_tpu_torch.config import load_config
from mrs_optic_flow_tpu_torch.runtime import ros_bridge
from mrs_optic_flow_tpu_torch.runtime.ros_bridge import (
    RosBridge,
    decode_image,
    from_camera_info,
    from_imu,
    from_odometry,
    tf_transform_provider,
)
from mrs_optic_flow_tpu_torch.runtime.stream import SyntheticScene
from mrs_optic_flow_tpu_torch.utils.quat_np import np_quat_from_rpy
from torch_bag_parity import (
    PARITY_OVERRIDES,
    PARITY_SCENE,
    TWIST_PARITY,
    assert_same_message,
)

def make_bridge(fail_tf=0, **overrides):
    rospy = make_fake_rospy()
    buf = FakeTfBuffer(fail=fail_tf)
    bridge = RosBridge(
        load_config(overrides=overrides or None),
        camera_frame="camera",
        uav_frame="fcu",
        rospy_module=rospy,
        msg_types=FAKE_TYPES,
        tf_buffer=buf,
        device="cpu",
    )
    return bridge, rospy, buf


def make_jax_bridge(fail_tf=0, **overrides):
    rospy = make_fake_rospy()
    buf = FakeTfBuffer(fail=fail_tf)
    bridge = jax_bridge.RosBridge(
        jax_load_config(overrides=overrides or None),
        camera_frame="camera", uav_frame="fcu", rospy_module=rospy, msg_types=FAKE_TYPES,
        tf_buffer=buf,
    )
    return bridge, rospy, buf


# --------------------------------------------------------------------------- #
# topic surface                                                                #
# --------------------------------------------------------------------------- #

def test_topic_surface_matches_reference():
    """Subscribed/advertised names match src/optic_flow.cpp:1036-1063 —
    under the node's private namespace ("~", the reference's private nodelet
    handle) — including the conditional imu subscription and raw
    advertisement."""
    bridge, rospy, _ = make_bridge()
    assert {s.topic for s in rospy._subs} == {
        "~active_tracker_in", "~camera_info_in", "~camera_in",
        "~uav_height_in", "~odometry_in", "~imu_in",
    }
    assert {
        "~velocity_out", "~velocity_out_longrange",
        "~velocity_out_longrange_diff", "~velocity_stddev_out",
        "~max_velocity_out", "~allsac_chosen_out", "~points_raw_out",
    } <= {p.topic for p in rospy._pubs}

    # ang_rate_source != imu -> no imu subscription (:1060-1063)
    _, rospy2, _ = make_bridge(ang_rate_source="odometry")
    assert "~imu_in" not in {s.topic for s in rospy2._subs}

    # raw_output false -> points_raw_out not advertised (:1043-1046)
    _, rospy3, _ = make_bridge(raw_output=False)
    assert "~points_raw_out" not in {p.topic for p in rospy3._pubs}


@pytest.mark.parametrize("overrides", [
    {}, {"ang_rate_source": "odometry"}, {"raw_output": False},
    {"ang_rate_source": "odometry_diff", "raw_output": False},
])
def test_topic_surface_matches_jax(overrides):
    """The same advertised and subscribed (topic, type, queue) triples as the
    JAX bridge on the same config."""
    _, ours, _ = make_bridge(**overrides)
    _, theirs, _ = make_jax_bridge(**overrides)
    for attr in ("_pubs", "_subs"):
        a = sorted((p.topic, p.type.__name__) for p in getattr(ours, attr))
        b = sorted((p.topic, p.type.__name__) for p in getattr(theirs, attr))
        assert a == b, attr
    assert sorted((p.topic, p.queue_size) for p in ours._pubs) == sorted(
        (p.topic, p.queue_size) for p in theirs._pubs)


def test_launch_surface_covers_all_node_outputs():
    """Every topic the port node can emit has a publisher mapping in the
    shared bridge table (both bridges consume ``_PUBLISHERS``); the node's
    publish call sites are scraped from its source so a new output topic
    cannot be added without extending the table.  The table and topic list
    equal the JAX package's."""
    import inspect
    import re

    from mrs_optic_flow_tpu_torch.runtime import node as node_mod

    topics, table = ros_bridge.NODE_OUTPUT_TOPICS, ros_bridge._PUBLISHERS
    assert set(topics) <= set(table), set(topics) - set(table)
    src = inspect.getsource(node_mod)
    emitted = set(re.findall(r"self\.publish\(\s*\"([a-z0-9_]+)\"", src))
    emitted |= set(re.findall(r"\(\"([a-z0-9_]+_out[a-z0-9_]*)\", ", src))
    emitted = {t for t in emitted if t.endswith(("_out", "_diff", "_longrange")) or t in topics}
    assert emitted <= set(topics), emitted - set(topics)
    assert topics == jax_bridge.NODE_OUTPUT_TOPICS
    assert {k: v.type_key for k, v in table.items()} == {
        k: v.type_key for k, v in jax_bridge._PUBLISHERS.items()}


def test_scale_rotation_out_bridged():
    """The SR output crosses the bridge as a TwistWithCovarianceStamped:
    vz on linear.z, yaw rate on angular.z, raw scale in covariance[14]."""
    bridge, rospy, _ = make_bridge()
    pub = {p.topic: p for p in rospy._pubs}["~scale_rotation_out"]
    bridge._publish("scale_rotation_out", {"stamp": 12.5, "scale": 1.02, "vz": 0.8,
                                           "yaw_rate": -0.3, "frame_id": "fcu"})
    assert len(pub.sent) == 1
    m = pub.sent[0]
    assert m.header.frame_id == "fcu"
    assert m.twist.twist.linear.z == pytest.approx(0.8)
    assert m.twist.twist.angular.z == pytest.approx(-0.3)
    assert np.isnan(m.twist.twist.linear.x)
    assert m.twist.covariance[14] == pytest.approx(1.02)
    assert rospy._warnings == []


def test_unbridged_topic_warns_once():
    """An output with no publisher mapping logs ONE warning instead of
    vanishing silently."""
    bridge, rospy, _ = make_bridge()
    for _ in range(3):
        bridge._publish("mystery_new_topic_out", 1.0)
    assert len(rospy._warnings) == 1
    assert "mystery_new_topic_out" in rospy._warnings[0]
    # a known-but-unadvertised topic (raw_output off) stays quiet
    bridge2, rospy2, _ = make_bridge(raw_output=False)
    bridge2._publish("points_raw_out", np.zeros((2, 2)))
    assert rospy2._warnings == []


def test_publish_never_swallows_errors():
    """A payload a mapped builder cannot convert raises out of ``_publish``,
    and an error of the node raises out of the subscriber callback: the
    warn-once path covers unmapped topics only."""
    bridge, rospy, _ = make_bridge()
    with pytest.raises((TypeError, ValueError)):
        bridge._publish("max_velocity_out", "not a number")

    def boom(msg):
        raise RuntimeError("node fault")

    bridge.node.on_height = boom
    with pytest.raises(RuntimeError, match="node fault"):
        next(s.cb for s in rospy._subs if s.topic == "~uav_height_in")(FakeFloat64Stamped(1.0, 2.0))
    assert rospy._warnings == []


# --------------------------------------------------------------------------- #
# converters                                                                   #
# --------------------------------------------------------------------------- #

def test_decode_image_encodings():
    rng = np.random.default_rng(0)
    bgr = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)

    np.testing.assert_array_equal(decode_image(FakeImage(bgr, "bgr8")).data, bgr)
    # rgb8 is reordered to BGR (cv_bridge "bgr8" conversion semantics)
    np.testing.assert_array_equal(decode_image(FakeImage(bgr[:, :, ::-1], "rgb8")).data, bgr)
    # bgra8 drops alpha
    bgra = np.dstack([bgr, np.full((6, 5), 7, np.uint8)])
    np.testing.assert_array_equal(decode_image(FakeImage(bgra, "bgra8")).data, bgr)
    gray = bgr[:, :, 0]
    np.testing.assert_array_equal(decode_image(FakeImage(gray, "mono8")).data, gray)
    # row-stride padding is stripped
    np.testing.assert_array_equal(decode_image(FakeImage(bgr, "bgr8", step_pad=13)).data, bgr)
    with pytest.raises(ValueError, match="encoding"):
        decode_image(FakeImage(gray, "32FC1"))
    # stamp flows through
    m = FakeImage(gray, "mono8")
    m.header.stamp = _Time(4.25)
    assert decode_image(m).stamp == 4.25


def _fake_images():
    rng = np.random.default_rng(1)
    bgr = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (4, 7, 4), dtype=np.uint8)
    gray = rng.integers(0, 256, (3, 9), dtype=np.uint8)
    out = [FakeImage(bgr, "bgr8"), FakeImage(bgr, "rgb8", step_pad=3), FakeImage(rgba, "bgra8"),
           FakeImage(rgba, "RGBA8", step_pad=1), FakeImage(gray, "mono8", step_pad=5),
           FakeImage(gray, "8UC1"), FakeImage(bgr, "8UC3")]
    for i, m in enumerate(out):
        m.header.stamp = _Time(100.0 + 0.05 * i)
    return out


def _fake_sensors():
    return [
        (from_camera_info, FakeCameraInfo(k=[420, 0, 376, 0, 420, 240, 0, 0, 1], d=[0.1, -0.2],
                                          binning_x=2)),
        (from_camera_info, FakeCameraInfo(k=[1] * 9, d=[])),
        (from_imu, FakeImu(2.5, rates=(0.1, -0.2, 0.3), quat=(0.1, 0.2, 0.3, 0.9))),
        (from_odometry, FakeOdometry(3.0, quat=(0, 0, 0.1, 0.99), lin=(1.0, 2.0, 3.0))),
        (ros_bridge.from_float64_stamped, FakeFloat64Stamped(4.0, 2.75)),
        (ros_bridge.from_tracker_diag, FakeTrackerDiag("MpcTracker")),
    ]


def test_converters_match_jax():
    """Every converter on the same fake message gives the JAX converter's
    dataclass fields."""
    for m in _fake_images():
        assert_same_message(decode_image(m), jax_bridge.decode_image(m))
    for fn, m in _fake_sensors():
        assert_same_message(fn(m), getattr(jax_bridge, fn.__name__)(m))


def test_sensor_converters():
    ci = from_camera_info(FakeCameraInfo(k=[420, 0, 376, 0, 420, 240, 0, 0, 1], d=[0.1, -0.2],
                                         binning_x=2))
    assert ci.matrix()[0, 0] == 420 and ci.binning_x == 2
    np.testing.assert_array_equal(ci.dist(), [0.1, -0.2, 0, 0, 0])  # padded

    # empty D -> zeros (pre-calibrated streams)
    assert from_camera_info(FakeCameraInfo(k=[1] * 9, d=[])).dist().tolist() == [0.0] * 5

    imu = from_imu(FakeImu(2.5, rates=(0.1, -0.2, 0.3)))
    assert imu.stamp == 2.5 and imu.angular_velocity == (0.1, -0.2, 0.3)

    odo = from_odometry(FakeOdometry(3.0, lin=(1.0, 2.0, 3.0)))
    assert odo.stamp == 3.0 and odo.linear_velocity == (1.0, 2.0, 3.0)


def _payloads():
    from mrs_optic_flow_tpu_torch.runtime.msgs import TwistWithCovarianceStamped

    tw = TwistWithCovarianceStamped.make(frame_id="fcu_untilted", stamp=104.9999999996,
                                         linear=(0.8, -0.5, 0.01), angular=(0.0, 0.1, -0.2),
                                         cov_xy=0.0567)
    return {
        "velocity_out": tw, "velocity_out_longrange": tw, "velocity_out_longrange_diff": tw,
        "velocity_stddev_out": (0.01, 0.02, 0.0), "max_velocity_out": np.float32(3.25),
        "allsac_chosen_out": np.int64(16), "points_raw_out": np.arange(32.0).reshape(16, 2),
        "processing_latency_out": 0.0123,
        "scale_rotation_out": {"stamp": 12.5, "scale": 1.02, "vz": 0.8, "yaw_rate": -0.3,
                               "frame_id": "fcu"},
    }


def _msg_fields(m):
    """A fake ROS message as nested plain values (NaN as a string)."""
    if isinstance(m, (float, np.floating)):
        return "nan" if np.isnan(m) else float(m)
    if isinstance(m, (int, str, np.integer)):
        return m
    if isinstance(m, (list, tuple)):
        return [_msg_fields(v) for v in m]
    if isinstance(m, _Time):
        return ("time", m.to_sec())
    return {k: _msg_fields(v) for k, v in vars(m).items()}


@pytest.mark.parametrize("topic", list(_payloads()))
def test_builders_match_jax(topic):
    """Each publisher builder of the shared table gives the JAX builder's
    message, field by field, for ROS1 (``rospy``) and ROS2 stamps."""
    from test_ros2_bridge import FAKE_TYPES2

    payload = _payloads()[topic]
    for types, rospy in ((FAKE_TYPES, make_fake_rospy()), (FAKE_TYPES2, None)):
        ours = ros_bridge._PUBLISHERS[topic].build(types, rospy, payload)
        theirs = jax_bridge._PUBLISHERS[topic].build(types, rospy, payload)
        assert type(ours) is type(theirs)
        assert _msg_fields(ours) == _msg_fields(theirs)


def test_tf_provider_math():
    """cam_yaw = yaw(base2cam) + pi/2 (src/optic_flow.cpp:1203-1208)."""
    b2c = tuple(np_quat_from_rpy(0.0, 0.0, 0.7))
    buf = FakeTfBuffer(c2b=(0, 0, 0, 1), b2c=b2c)
    c2b_quat, cam_yaw = tf_transform_provider(buf, make_fake_rospy(), "fcu", "camera")()
    np.testing.assert_allclose(c2b_quat, [0, 0, 0, 1])
    assert abs(cam_yaw - (0.7 + np.pi / 2)) < 1e-9
    c2b = tuple(np_quat_from_rpy(0.2, -0.1, 0.4))
    buf = FakeTfBuffer(c2b=c2b, b2c=b2c)
    ours = tf_transform_provider(buf, make_fake_rospy(), "fcu", "camera")()
    theirs = jax_bridge.tf_transform_provider(buf, make_fake_rospy(), "fcu", "camera")()
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert ours[1] == theirs[1]

    # a failing lookup raises (the node's poll treats it as not-yet)
    with pytest.raises(RuntimeError):
        tf_transform_provider(FakeTfBuffer(fail=1), make_fake_rospy(), "fcu", "camera")()


def test_warmup_waits_for_camera_info():
    """warmup() before any camera_info blocks on the topic first — the
    reference's timerCamInit wait (src/optic_flow.cpp:1102-1158)."""
    # frame_size >= 8*sample_point_size so the long-range grid (frame/4,
    # patches 2*sps) warmed up by node.warmup is non-empty
    bridge, rospy, _ = make_bridge(mrs_optic_flow={
        "frame_size": 128, "sample_point_size": 16, "scale_factor": 1})
    waited = {}

    def wait_for_message(topic, typ, timeout=None):
        waited["args"] = (topic, typ, timeout)
        # intrinsics sized to the tiny 128 px test frame (cx centered)
        return FakeCameraInfo(k=[120.0, 0, 64.0, 0, 120.0, 64.0, 0, 0, 1], d=[0.0] * 5)

    rospy.wait_for_message = wait_for_message
    assert not bridge.node.got_camera_info
    bridge.warmup((128, 128))
    assert waited["args"] == ("~camera_info_in", FakeCameraInfo, 15.0)
    assert bridge.node.got_camera_info


@pytest.mark.skipif(torch.cuda.is_available(), reason="the host has a CUDA device")
def test_default_device_needs_cuda():
    """The bridge builds its node on the card unless told otherwise: without
    a CUDA device it raises naming the device, before subscribing."""
    rospy = make_fake_rospy()
    with pytest.raises(RuntimeError, match="'cuda'"):
        RosBridge(load_config(), rospy_module=rospy, msg_types=FAKE_TYPES,
                  tf_buffer=FakeTfBuffer())
    assert rospy._subs == []


def test_missing_rospy_raises_import_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "rospy", None)
    with pytest.raises(ImportError, match="RosBridge needs rospy"):
        RosBridge(load_config(), msg_types=FAKE_TYPES, tf_buffer=FakeTfBuffer(), device="cpu")


# --------------------------------------------------------------------------- #
# end-to-end through fake ROS messages                                         #
# --------------------------------------------------------------------------- #

def _cb(rospy, topic):
    return next(s.cb for s in rospy._subs if s.topic == "~" + topic)


def _pub(rospy, topic):
    return next(p for p in rospy._pubs if p.topic == "~" + topic)


V_TRUE, DT, H, N_FRAMES = (0.8, -0.5), 0.05, 2.0, 6
def fly(bridge, rospy, scene, n_frames=N_FRAMES):
    """The synthetic constant-velocity flight through the bridge's
    callbacks: a black frame 1 s early (its tf poll fails), then
    ``n_frames`` bgr8 frames with odometry, IMU and height."""
    _cb(rospy, "camera_info_in")(FakeCameraInfo(k=list(scene.camera_info().k),
                                                d=list(scene.camera_info().d)))
    _cb(rospy, "active_tracker_in")(FakeTrackerDiag("MpcTracker"))
    _cb(rospy, "odometry_in")(FakeOdometry(9.0))
    _cb(rospy, "imu_in")(FakeImu(9.0))
    _cb(rospy, "uav_height_in")(FakeFloat64Stamped(9.0, H))
    img0 = FakeImage(np.zeros((scene.height_px, scene.width, 3), np.uint8), "bgr8")
    img0.header.stamp = _Time(9.0)
    _cb(rospy, "camera_in")(img0)
    for i in range(n_frames):
        t = 10.0 + i * DT
        _cb(rospy, "odometry_in")(FakeOdometry(t))
        _cb(rospy, "imu_in")(FakeImu(t))
        _cb(rospy, "uav_height_in")(FakeFloat64Stamped(t, H))
        frame = scene.render((V_TRUE[0] * i * DT, V_TRUE[1] * i * DT))
        img = FakeImage(np.repeat(frame.astype(np.uint8)[:, :, None], 3, axis=2), "bgr8")
        img.header.stamp = _Time(t)
        _cb(rospy, "camera_in")(img)


def test_e2e_ros_flight():
    """Synthetic constant-velocity flight pushed through the ROS callbacks:
    the bridge resolves TFs from the (initially failing) fake tf2 buffer,
    converts bgr8 Images, and publishes ROS twist messages with the true
    velocity — the full reference deployment shape without ROS installed."""
    bridge, rospy, buf = make_bridge(fail_tf=1)
    node = bridge.node
    assert not node.got_tfs  # resolved lazily via the provider
    fly(bridge, rospy, SyntheticScene(uav_height=H, seed=1))

    assert node.got_tfs and buf.calls >= 3  # first poll failed, second won
    sent = _pub(rospy, "velocity_out").sent
    assert len(sent) >= 2
    v = np.array([[m.twist.twist.linear.x, m.twist.twist.linear.y] for m in sent[1:]])
    assert np.abs(v - np.array(V_TRUE)).max() < 0.15, v
    last = sent[-1]
    assert last.header.frame_id == "fcu_untilted"
    assert abs(last.header.stamp.to_sec() - (10.0 + (N_FRAMES - 1) * DT)) < 1e-9
    cov = np.asarray(last.twist.covariance)
    assert cov.shape == (36,) and cov[0] == pytest.approx((50.0 * H / 420.0) ** 2)

    # diagnostics topics carry converted payloads
    lat = _pub(rospy, "processing_latency_out").sent
    assert lat and all(isinstance(m.data, float) for m in lat)
    raw = _pub(rospy, "points_raw_out").sent
    assert raw and len(raw[-1].data) == 32  # 16 windows x 2
    chosen = _pub(rospy, "allsac_chosen_out").sent
    assert chosen and isinstance(chosen[-1].data, int)


def test_e2e_flight_matches_jax_bridge():
    """The same fake messages through the port bridge and the JAX bridge:
    the same topics published as often with the same stamps and frame ids,
    every window an inlier, twists within ``TWIST_PARITY``."""
    runs = []
    for make in (make_bridge, make_jax_bridge):
        bridge, rospy, _ = make(fail_tf=1, **PARITY_OVERRIDES)
        fly(bridge, rospy, SyntheticScene(**PARITY_SCENE), n_frames=8)
        runs.append({p.topic: p.sent for p in rospy._pubs})
    ours, theirs = runs
    assert {t: len(s) for t, s in ours.items()} == {t: len(s) for t, s in theirs.items()}
    assert [m.data for m in ours["~allsac_chosen_out"]] == [16] * 7
    assert [m.data for m in theirs["~allsac_chosen_out"]] == [16] * 7
    assert len(ours["~velocity_out"]) == 7
    for a, b in zip(ours["~velocity_out"], theirs["~velocity_out"]):
        assert a.header.stamp.to_sec() == b.header.stamp.to_sec()
        assert a.header.frame_id == b.header.frame_id
        for axis in ("x", "y", "z"):
            assert abs(getattr(a.twist.twist.linear, axis)
                       - getattr(b.twist.twist.linear, axis)) <= TWIST_PARITY, axis
