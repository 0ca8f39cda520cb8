"""The port's offline ROS1 rosbag path (``runtime/rosbag.py``) against the
JAX package's, on the bags of ``tests/test_rosbag.py`` (its rosbag 2.0
builder and ROS1 serializers, imported):

- every test of ``tests/test_rosbag.py`` carried across to the port, under
  the same name, the node on the CPU (``device="cpu"``), ``lz4`` blocked
  for its error path instead of skipped;
- the decoders give the JAX decoders' dataclass fields, the encoders the
  JAX encoders' bytes, and ``BagWriter`` the JAX writer's file, byte for
  byte, for the same writes;
- each package reads the other's bags (and the chunked, bz2 builder's) to
  equal ``(t, topic, type, raw)`` tuples;
- ``TfTree.lookup`` within 1e-12 of the JAX tree's, and ``resolve_topics``
  raises the JAX messages;
- a full recorded flight replays through the port node and the JAX node to
  twists within 1e-3 m/s (every window an inlier, so the two nodes'
  different RANSAC draws give the same refit, as ``test_torch_node.py``).
"""

import struct
import sys

import numpy as np
import pytest
import torch_parity  # noqa: F401  (pins torch to one thread)
from torch_bag_parity import ENCODED, assert_same_message, encode, messages, rand_q, write_flight
from test_rosbag import (
    DT,
    HEIGHT,
    MAGIC,
    V_TRUE,
    _flight_bag,
    _header,
    _record,
    _string,
    conn_record,
    msg_record,
    ser_camera_info,
    ser_height,
    ser_image,
    ser_imu,
    ser_odometry,
    ser_tf,
    write_bag,
)

from mrs_optic_flow_tpu.runtime import msgs as jax_msgs
from mrs_optic_flow_tpu.runtime import rosbag as jax_rb
from mrs_optic_flow_tpu_torch.config import load_config
from mrs_optic_flow_tpu_torch.runtime import OpticFlowNode, SyntheticScene
from mrs_optic_flow_tpu_torch.runtime import msgs as port_msgs
from mrs_optic_flow_tpu_torch.runtime import rosbag as rb
from mrs_optic_flow_tpu_torch.runtime.rosbag import (
    BagFormatError,
    BagReader,
    decode_camera_info_msg,
    decode_float64_stamped_msg,
    decode_image_msg,
    decode_imu_msg,
    decode_odometry_msg,
    replay_bag,
    resolve_topics,
)

TWIST_PARITY = 1e-3  # m/s, the port node against the JAX node (test_torch_node.py)


def _port_node(published=None, transforms=True):
    published = [] if published is None else published
    node = OpticFlowNode(load_config(), device="cpu",
                         publish=lambda t, m: published.append((t, m)), log=lambda s: None)
    if transforms:
        node.set_transforms((0.0, 0.0, 0.0, 1.0))
    return node


def _replay(path, **kw):
    published = []
    frames = replay_bag(_port_node(published), path, **kw)
    return frames, [m for t, m in published if t == "velocity_out"]


def _assert_velocity(twists, n_min=3):
    assert len(twists) >= n_min
    v = np.array([tw.linear[:2] for tw in twists[1:]])
    assert np.abs(v - np.array(V_TRUE)).max() < 0.15, v


# --------------------------------------------------------------------------- #
# decoders                                                                     #
# --------------------------------------------------------------------------- #

def test_decode_image_respects_stride():
    img = np.arange(6 * 8, dtype=np.uint8).reshape(6, 8)
    raw = ser_image(12.25, img, step_pad=3)
    msg = decode_image_msg(raw)
    assert msg.stamp == pytest.approx(12.25)
    np.testing.assert_array_equal(msg.data, img)
    assert_same_message(msg, jax_rb.decode_image_msg(raw))


def test_decode_camera_info():
    k = [420.0, 0, 376.0, 0, 421.0, 240.0, 0, 0, 1]
    raw = ser_camera_info(1.0, k, [0.1, -0.2], binning_x=2)
    ci = decode_camera_info_msg(raw)
    assert ci.k == k
    assert ci.d[:2] == [0.1, -0.2] and len(ci.d) == 5  # zero-padded to 5
    assert ci.binning_x == 2
    assert_same_message(ci, jax_rb.decode_camera_info_msg(raw))


def test_decode_imu_odometry_height():
    raw = ser_imu(2.5, quat=(0.1, 0.2, 0.3, 0.9), ang=(0.4, 0.5, 0.6))
    imu = decode_imu_msg(raw)
    assert imu.stamp == pytest.approx(2.5)
    assert imu.orientation == pytest.approx((0.1, 0.2, 0.3, 0.9))
    assert imu.angular_velocity == pytest.approx((0.4, 0.5, 0.6))
    assert_same_message(imu, jax_rb.decode_imu_msg(raw))

    raw = ser_odometry(3.5, quat=(0.0, 0.0, 0.1, 0.99), lin=(1.0, -2.0, 0.5))
    od = decode_odometry_msg(raw)
    assert od.stamp == pytest.approx(3.5)
    assert od.orientation == pytest.approx((0.0, 0.0, 0.1, 0.99))
    assert od.linear_velocity == pytest.approx((1.0, -2.0, 0.5))
    assert_same_message(od, jax_rb.decode_odometry_msg(raw))

    raw = ser_height(4.0, 2.75)
    hh = decode_float64_stamped_msg(raw)
    assert (hh.stamp, hh.value) == (pytest.approx(4.0), pytest.approx(2.75))
    assert_same_message(hh, jax_rb.decode_float64_stamped_msg(raw))


# --------------------------------------------------------------------------- #
# container / resolution                                                       #
# --------------------------------------------------------------------------- #

def test_bad_magic_raises(tmp_path):
    p = tmp_path / "not.bag"
    p.write_bytes(b"#ROSBAG V1.2\n junk")
    with pytest.raises(BagFormatError, match="not a rosbag 2.0"):
        BagReader(str(p))


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_reader_roundtrip(tmp_path, compression):
    img = np.full((4, 4), 7, np.uint8)
    records = [
        conn_record(0, "/uav1/bluefox_optflow/image_raw", "sensor_msgs/Image"),
        conn_record(1, "/uav1/odometry/height", "mrs_msgs/Float64Stamped"),
        msg_record(0, 10.0, ser_image(10.0, img)),
        msg_record(1, 10.1, ser_height(10.1, 2.0)),
    ]
    path = write_bag(tmp_path / f"{compression}.bag", records, compression)
    got = list(BagReader(path).messages())
    assert [(round(t, 3), topic, tn) for t, topic, tn, _ in got] == [
        (10.0, "/uav1/bluefox_optflow/image_raw", "sensor_msgs/Image"),
        (10.1, "/uav1/odometry/height", "mrs_msgs/Float64Stamped"),
    ]
    np.testing.assert_array_equal(decode_image_msg(got[0][3]).data, img)


def _raised(mod, fn, *args):
    with pytest.raises(mod.BagFormatError) as exc:
        fn(*args)
    return str(exc.value)


def test_resolve_topics_ambiguity(tmp_path):
    records = [
        conn_record(0, "/a/image_raw", "sensor_msgs/Image"),
        conn_record(1, "/b/image_raw", "sensor_msgs/Image"),
    ]
    path = write_bag(tmp_path / "two.bag", records)
    with pytest.raises(BagFormatError, match="several sensor_msgs/Image"):
        resolve_topics(BagReader(path))
    routing = resolve_topics(BagReader(path), {"image": "/b/image_raw"})
    assert set(routing) == {"/b/image_raw"}
    with pytest.raises(BagFormatError, match="unknown replay roles"):
        resolve_topics(BagReader(path), {"image": "/b/image_raw", "lidar": "/x"})
    # the same messages as the JAX package's
    for pins in (None, {"image": "/b/image_raw", "lidar": "/x"}, {"image": "/c/image_raw"}):
        assert (_raised(rb, resolve_topics, BagReader(path), pins)
                == _raised(jax_rb, jax_rb.resolve_topics, jax_rb.BagReader(path), pins))


# --------------------------------------------------------------------------- #
# end-to-end: recorded flight -> twists                                        #
# --------------------------------------------------------------------------- #

def test_replay_full_flight(tmp_path):
    """All five topics recorded: the node recovers the true velocity from
    the bag alone, like the live graph would feed it."""
    path = _flight_bag(tmp_path, full=True, compression="bz2")
    frames, twists = _replay(path)
    assert frames == 6
    _assert_velocity(twists)


def test_replay_full_flight_matches_jax_node(tmp_path):
    """The same bag through ``replay_bag`` of each package into its node:
    the same frames and stamps, twists within ``TWIST_PARITY``."""
    from mrs_optic_flow_tpu.config import load_config as jax_load_config
    from mrs_optic_flow_tpu.runtime import OpticFlowNode as JaxNode

    path = _flight_bag(tmp_path, full=True)
    published, jax_pub = [], []
    frames = replay_bag(_port_node(published), path)
    jax_node = JaxNode(jax_load_config(), publish=lambda t, m: jax_pub.append((t, m)),
                       log=lambda s: None, enable_profiler=False)
    jax_node.set_transforms((0.0, 0.0, 0.0, 1.0))
    assert frames == jax_rb.replay_bag(jax_node, path) == 6
    ours = [m for t, m in published if t == "velocity_out"]
    theirs = [m for t, m in jax_pub if t == "velocity_out"]
    assert [m.stamp for m in ours] == [m.stamp for m in theirs] and len(ours) >= 3
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.linear, b.linear, atol=TWIST_PARITY, rtol=0)
    _assert_velocity(ours)


def test_replay_image_only_bag(tmp_path):
    """A bare camera bag still replays: camera info is synthesized from the
    first frame's geometry and IMU/odometry/height get level-flight
    defaults (the .ofrec replay convention)."""
    path = _flight_bag(tmp_path, full=False)
    frames, twists = _replay(path, default_height=HEIGHT)
    assert frames == 6
    _assert_velocity(twists)


def test_replay_limit(tmp_path):
    path = _flight_bag(tmp_path, full=False, n_frames=5)
    frames, _ = _replay(path, limit=2)
    assert frames == 2


def test_cli_replay_bag(tmp_path, capsys):
    from mrs_optic_flow_tpu_torch.__main__ import main

    path = _flight_bag(tmp_path, full=True)
    rc = main(["--replay", path, "--height", str(HEIGHT), "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "twists from 6 replay frames" in out


def test_truncated_bag_raises(tmp_path):
    """Corrupt/truncated containers surface BagFormatError, never a raw
    struct/index crash."""
    img = np.zeros((4, 4), np.uint8)
    records = [
        conn_record(0, "/cam/image_raw", "sensor_msgs/Image"),
        msg_record(0, 10.0, ser_image(10.0, img)),
    ]
    path = write_bag(tmp_path / "whole.bag", records)
    whole = open(path, "rb").read()
    for cut in (len(whole) - 7, len(MAGIC) + 2, len(whole) // 2):
        p = tmp_path / f"cut{cut}.bag"
        p.write_bytes(whole[:cut])
        with pytest.raises(BagFormatError):
            list(BagReader(str(p)).messages())


def test_lz4_without_module_raises(tmp_path, monkeypatch):
    """An lz4-compressed bag on a host without the lz4 module (the card has
    none; blocked here) fails with the actionable message, not an
    ImportError traceback."""
    monkeypatch.setitem(sys.modules, "lz4", None)
    monkeypatch.setitem(sys.modules, "lz4.frame", None)
    records = [conn_record(0, "/cam/image_raw", "sensor_msgs/Image")]
    chunk = b"".join(records + [msg_record(0, 1.0, ser_image(1.0, np.zeros((2, 2), np.uint8)))])
    out = MAGIC + _record(
        {"op": b"\x05", "compression": b"lz4", "size": struct.pack("<I", len(chunk))},
        b"\x00" * 16,
    )
    p = tmp_path / "lz4.bag"
    p.write_bytes(out)
    with pytest.raises(BagFormatError, match="lz4"):
        list(BagReader(str(p)).messages())


def _png_payload(cv2, stamp, img):
    ok, enc = cv2.imencode(".png", img)
    assert ok
    return _header(stamp) + _string("png") + struct.pack("<I", len(enc)) + enc.tobytes()


def test_decode_compressed_image(tmp_path):
    """sensor_msgs/CompressedImage: png-encoded frames decode through cv2
    and replay like raw Image topics."""
    cv2 = pytest.importorskip("cv2")
    from mrs_optic_flow_tpu_torch.runtime.rosbag import decode_compressed_image_msg

    img = np.arange(32 * 48, dtype=np.uint8).reshape(32, 48)
    payload = _png_payload(cv2, 5.5, img)
    msg = decode_compressed_image_msg(payload)
    assert msg.stamp == pytest.approx(5.5)
    np.testing.assert_array_equal(msg.data, img)
    assert_same_message(msg, jax_rb.decode_compressed_image_msg(payload))

    # a compressed-camera bag end-to-end: same flight, png frames
    scene = SyntheticScene(uav_height=HEIGHT, seed=2)
    records = [conn_record(0, "/uav1/bluefox_optflow/image_raw/compressed",
                           "sensor_msgs/CompressedImage")]
    for i in range(4):
        t = 100.0 + i * DT
        pos = (V_TRUE[0] * i * DT, V_TRUE[1] * i * DT)
        frame = np.clip(np.round(scene.render(pos)), 0, 255).astype(np.uint8)
        records.append(msg_record(0, t, _png_payload(cv2, t, frame)))
    path = write_bag(tmp_path / "compressed.bag", records)
    frames, twists = _replay(path, default_height=HEIGHT)
    assert frames == 4
    _assert_velocity(twists, n_min=2)


def test_compressed_image_without_cv2_raises(monkeypatch):
    """Without OpenCV (the card has none; blocked here) a CompressedImage
    raises ``BagFormatError`` naming cv2, as in the JAX package."""
    payload = _header(5.5) + _string("png") + struct.pack("<I", 4) + b"\x89PNG"
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(BagFormatError, match="needs cv2"):
        rb.decode_compressed_image_msg(payload)


def test_cli_bag_topic_pins_role(tmp_path, capsys):
    """--bag-topic image=... resolves an ambiguous two-camera bag."""
    from mrs_optic_flow_tpu_torch.__main__ import main

    scene = SyntheticScene(uav_height=HEIGHT, seed=2)
    records = [
        conn_record(0, "/uav1/front/image_raw", "sensor_msgs/Image"),
        conn_record(1, "/uav1/down/image_raw", "sensor_msgs/Image"),
    ]
    for i in range(4):
        t = 100.0 + i * DT
        pos = (V_TRUE[0] * i * DT, V_TRUE[1] * i * DT)
        frame = np.clip(np.round(scene.render(pos)), 0, 255).astype(np.uint8)
        records.append(msg_record(1, t, ser_image(t, frame)))
        # the distractor camera publishes black frames
        records.append(msg_record(0, t, ser_image(t, np.zeros((8, 8), np.uint8))))
    path = write_bag(tmp_path / "two_cams.bag", records)

    with pytest.raises(BagFormatError, match="several sensor_msgs/Image"):
        main(["--replay", path, "--height", str(HEIGHT), "--device", "cpu"])

    rc = main(["--replay", path, "--height", str(HEIGHT), "--device", "cpu",
               "--bag-topic", "image=/uav1/down/image_raw"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "twists from 4 replay frames" in out


def test_topics_scan_skips_chunks(tmp_path):
    """Real rosbags repeat every connection record at top level after the
    chunks (the index section); topics_by_type must resolve from those
    without decompressing a chunk.  Proven with a bag whose chunk blob is
    corrupt: topic resolution succeeds, message iteration raises."""
    import os

    conns = [
        conn_record(0, "/cam/image_raw", "sensor_msgs/Image"),
        conn_record(1, "/odom", "nav_msgs/Odometry"),
    ]
    out = MAGIC
    out += _record({"op": b"\x05", "compression": b"bz2", "size": struct.pack("<I", 64)},
                   b"\x13\x37" * 8)  # not bz2
    out += b"".join(conns)  # the post-chunk connection section
    p = tmp_path / "fastpath.bag"
    p.write_bytes(out)

    reader = BagReader(str(p))
    by_type = reader.topics_by_type()
    assert by_type["sensor_msgs/Image"] == ["/cam/image_raw"]
    assert by_type["nav_msgs/Odometry"] == ["/odom"]
    with pytest.raises(Exception):  # noqa: B017 — bz2 garbage
        list(reader.messages())
    reader.close()
    assert os.path.exists(p)  # close released the mmap without unlinking


def test_raw_beats_compressed_auto(tmp_path):
    """image_transport records raw + compressed side by side; replay must
    pick ONE camera stream (raw wins on auto-resolve; an explicit
    compressed pin flips it) instead of double-dispatching every frame."""
    cv2 = pytest.importorskip("cv2")
    img = np.full((8, 8), 9, np.uint8)
    records = [
        conn_record(0, "/cam/image_raw", "sensor_msgs/Image"),
        conn_record(1, "/cam/image_raw/compressed", "sensor_msgs/CompressedImage"),
    ]
    for i in range(3):
        t = 100.0 + i * DT
        records.append(msg_record(0, t, ser_image(t, img)))
        records.append(msg_record(1, t, _png_payload(cv2, t, img)))
    path = write_bag(tmp_path / "both.bag", records)

    assert set(resolve_topics(BagReader(path))) == {"/cam/image_raw"}
    routing = resolve_topics(BagReader(path), {"compressed_image": "/cam/image_raw/compressed"})
    assert set(routing) == {"/cam/image_raw/compressed"}

    frames, _ = _replay(path, default_height=HEIGHT)
    assert frames == 3  # one dispatch per physical frame, not two


def test_pinned_topic_must_exist(tmp_path):
    records = [conn_record(0, "/cam/image_raw", "sensor_msgs/Image")]
    path = write_bag(tmp_path / "one.bag", records)
    with pytest.raises(BagFormatError, match="not in the bag"):
        resolve_topics(BagReader(path), {"image": "/cam/image_row"})  # typo


def test_replay_truncated_raises_bagformat(tmp_path):
    """A truncation surfacing mid-replay must raise the actionable
    BagFormatError, not a BufferError from the mmap close."""
    img = np.zeros((8, 8), np.uint8)
    records = [
        conn_record(0, "/cam/image_raw", "sensor_msgs/Image"),
        msg_record(0, 100.0, ser_image(100.0, img)),
        msg_record(0, 100.05, ser_image(100.05, img)),
    ]
    path = write_bag(tmp_path / "whole.bag", records)
    whole = open(path, "rb").read()
    cut = tmp_path / "cut.bag"
    cut.write_bytes(whole[: len(whole) - 9])
    with pytest.raises(BagFormatError):
        replay_bag(_port_node(), str(cut), default_height=HEIGHT)


def test_cli_bag_topic_malformed_errors(tmp_path, capsys):
    from mrs_optic_flow_tpu_torch.__main__ import main

    path = write_bag(tmp_path / "one.bag", [conn_record(0, "/cam/image_raw", "sensor_msgs/Image")])
    with pytest.raises(SystemExit) as exc:
        main(["--replay", path, "--bag-topic", "image", "--device", "cpu"])
    assert exc.value.code == 2
    assert "ROLE=TOPIC" in capsys.readouterr().err


def test_cli_bag_info(tmp_path, capsys):
    from mrs_optic_flow_tpu_torch.__main__ import main

    img = np.zeros((4, 4), np.uint8)
    records = [
        conn_record(0, "/uav1/bluefox_optflow/image_raw", "sensor_msgs/Image"),
        conn_record(1, "/uav1/odometry/height", "mrs_msgs/Float64Stamped"),
        conn_record(2, "/uav1/silent", "std_msgs/Empty"),  # no messages
        msg_record(0, 10.0, ser_image(10.0, img)),
        msg_record(0, 10.5, ser_image(10.5, img)),
        msg_record(1, 12.0, ser_height(12.0, 2.0)),
    ]
    path = write_bag(tmp_path / "info.bag", records, "bz2")
    rc = main(["--bag-info", path])
    assert rc == 0
    out = capsys.readouterr().out
    assert "3 messages, 2.00 s" in out
    assert "/uav1/bluefox_optflow/image_raw" in out and "sensor_msgs/Image" in out
    assert "/uav1/silent" in out and "      0" in out


# --------------------------------------------------------------------------- #
# tf from the bag (/tf_static) — the offline timerTf                           #
# --------------------------------------------------------------------------- #

def test_decode_tf_message():
    q1, q2 = (0.0, 0.0, 0.3826834, 0.9238795), (0.1, 0.2, 0.3, 0.9273618)
    raw = ser_tf([("uav1/fcu", "uav1/cam_link", q1), ("uav1/cam_link", "uav1/cam", q2)])
    got = rb.decode_tf_message(raw)
    assert got[0][0] == "uav1/fcu" and got[0][1] == "uav1/cam_link"
    assert got[0][2] == pytest.approx(q1)
    assert got[1][2] == pytest.approx(q2)
    assert got == jax_rb.decode_tf_message(raw)


def test_tf_tree_composes_chains():
    """lookup(target, source) composes rotations along the frame chain in
    either edge direction, like tf2's lookupTransform."""
    from mrs_optic_flow_tpu_torch.utils.quat_np import np_quat_inverse, np_quat_multiply

    rng = np.random.default_rng(11)
    q1, q2 = rand_q(rng), rand_q(rng)
    tree = rb.TfTree()
    tree.add("fcu", "link", q1)     # v_fcu  = R(q1) v_link
    tree.add("link", "cam", q2)     # v_link = R(q2) v_cam
    got = tree.lookup("fcu", "cam")  # v_fcu = R(q1 q2) v_cam
    want = np_quat_multiply(np.asarray(q1), np.asarray(q2))
    assert np.abs(got - want).max() < 1e-12 or np.abs(got + want).max() < 1e-12

    inv = tree.lookup("cam", "fcu")
    winv = np_quat_inverse(want)
    assert np.abs(inv - winv).max() < 1e-12 or np.abs(inv + winv).max() < 1e-12

    assert tree.lookup("fcu", "fcu") == pytest.approx([0, 0, 0, 1])
    assert tree.lookup("fcu", "nowhere") is None


def test_tf_tree_matches_jax():
    """A random tree of 12 frames (each added below a random earlier one,
    some edges given twice): every lookup within 1e-12 of the JAX tree's,
    None for the same pairs."""
    rng = np.random.default_rng(5)
    ours, theirs = rb.TfTree(), jax_rb.TfTree()
    frames = ["f0"]
    for i in range(1, 12):
        parent, q = frames[int(rng.integers(len(frames)))], rand_q(rng)
        for tree in (ours, theirs):
            tree.add(parent, f"f{i}", q)
        frames.append(f"f{i}")
    frames.append("island")
    for target in frames:
        for source in frames:
            a, b = ours.lookup(target, source), theirs.lookup(target, source)
            assert (a is None) == (b is None), (target, source)
            if a is not None:
                assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 1e-12, (target, source)


def test_replay_tf_from_bag(tmp_path):
    """camera->body resolves from /tf_static via a two-hop chain; without
    the frames the node stays gated on transforms (nothing publishes)."""
    scene = SyntheticScene(uav_height=HEIGHT, seed=2)
    ident = (0.0, 0.0, 0.0, 1.0)
    records = [
        conn_record(0, "/uav1/bluefox_optflow/image_raw", "sensor_msgs/Image"),
        conn_record(5, "/tf_static", "tf2_msgs/TFMessage"),
        msg_record(5, 99.0, ser_tf([("uav1/fcu", "uav1/cam_link", ident),
                                    ("uav1/cam_link", "uav1/cam", ident)])),
    ]
    for i in range(5):
        t = 100.0 + i * DT
        pos = (V_TRUE[0] * i * DT, V_TRUE[1] * i * DT)
        frame = np.clip(np.round(scene.render(pos)), 0, 255).astype(np.uint8)
        records.append(msg_record(0, t, ser_image(t, frame)))
    path = write_bag(tmp_path / "tf_flight.bag", records)

    published = []
    node = _port_node(published, transforms=False)  # the bag provides them
    frames = replay_bag(node, path, default_height=HEIGHT,
                        camera_frame="uav1/cam", uav_frame="uav1/fcu")
    assert node.got_tfs and frames == 5
    np.testing.assert_allclose(node.c2b_quat, ident, atol=1e-12)
    _assert_velocity([m for t, m in published if t == "velocity_out"])

    # frames that never resolve -> the node stays gated, publishes nothing
    published2 = []
    node2 = _port_node(published2, transforms=False)
    replay_bag(node2, path, default_height=HEIGHT,
               camera_frame="uav1/elsewhere", uav_frame="uav1/fcu")
    assert not node2.got_tfs and not published2


# --------------------------------------------------------------------------- #
# encoders and the writer against the JAX package's, byte for byte            #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ENCODED)
def test_encoder_bytes_equal_jax(name):
    ours = encode(rb, name, messages(port_msgs)[name])
    theirs = encode(jax_rb, name, messages(jax_msgs)[name])
    assert ours == theirs


def test_bag_writer_file_equal_jax(tmp_path):
    ours = write_flight(rb, port_msgs, tmp_path / "port.bag")
    theirs = write_flight(jax_rb, jax_msgs, tmp_path / "jax.bag")
    assert open(ours, "rb").read() == open(theirs, "rb").read()


def _chunked_bz2_bag(tmp_path):
    img = np.arange(16, dtype=np.uint8).reshape(4, 4)
    return write_bag(tmp_path / "chunked.bag", [
        conn_record(0, "/cam/image_raw", "sensor_msgs/Image"),
        conn_record(1, "/height", "mrs_msgs/Float64Stamped"),
        msg_record(0, 10.0, ser_image(10.0, img)),
        msg_record(1, 10.1, ser_height(10.1, 2.0)),
        msg_record(0, 10.2, ser_image(10.2, img)),
    ], "bz2")


@pytest.mark.parametrize("source", ["port writer", "jax writer", "chunked bz2"])
def test_each_package_reads_the_others_bag(tmp_path, source):
    if source == "chunked bz2":
        path = _chunked_bz2_bag(tmp_path)
    else:
        mod, msgs = (rb, port_msgs) if source == "port writer" else (jax_rb, jax_msgs)
        path = write_flight(mod, msgs, tmp_path / "flight.bag")
    with BagReader(path) as ours, jax_rb.BagReader(path) as theirs:
        got, want = list(ours.messages()), list(theirs.messages())
        assert ours.topics_by_type() == theirs.topics_by_type()
    assert got == want and len(got) >= 3
