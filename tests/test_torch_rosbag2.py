"""The port's offline rosbag2 path (``runtime/rosbag2.py``) against the JAX
package's, on the bags of ``tests/test_rosbag2.py`` (its independent CDR
serializer, sqlite3 storage writer and MCAP writer, imported):

- every test of ``tests/test_rosbag2.py`` carried across to the port, under
  the same name, the node on the CPU (``device="cpu"``); the zstd chunk both
  with a zstd module and with every zstd module blocked;
- the decoders give the JAX decoders' dataclass fields, the CDR encoders
  the JAX encoders' bytes; ``Bag2Writer`` writes the JAX writer's
  ``metadata.yaml`` text and the same decoded messages;
- each package reads the other's ``.db3`` and the hand-built MCAP files
  (chunked and bare) to equal ``(t, topic, type, raw)`` tuples;
- the split-bag order of ``metadata.yaml`` holds with ``yaml`` blocked (the
  card has no pyyaml), and the port's reader of ``relative_file_paths``
  agrees with ``yaml.safe_load`` on block, flow, quoted and commented lists,
  a flow list split over lines and a ``#`` inside a quoted name (repair F11).
"""

import os
import sqlite3
import sys

import numpy as np
import pytest
import torch_parity  # noqa: F401  (pins torch to one thread)
from test_rosbag2 import (
    DT,
    HEIGHT,
    V_TRUE,
    _flight_db3,
    mcap_channel,
    mcap_chunk,
    mcap_message,
    mcap_schema,
    ser_camera_info,
    ser_height,
    ser_image,
    ser_imu,
    ser_odometry,
    ser_tf,
    write_db3,
    write_mcap,
)
from torch_bag_parity import ENCODED, assert_same_message, encode, messages, write_flight

from mrs_optic_flow_tpu.runtime import msgs as jax_msgs
from mrs_optic_flow_tpu.runtime import rosbag2 as jax_rb2
from mrs_optic_flow_tpu_torch.config import load_config
from mrs_optic_flow_tpu_torch.runtime import msgs as port_msgs
from mrs_optic_flow_tpu_torch.runtime import rosbag2 as rb2
from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode
from mrs_optic_flow_tpu_torch.runtime.rosbag2 import (
    Bag2FormatError,
    Bag2Reader,
    decode_camera_info_msg,
    decode_float64_stamped_msg,
    decode_image_msg,
    decode_imu_msg,
    decode_odometry_msg,
    decode_tf_message,
    is_rosbag2,
    replay_bag2,
)
from mrs_optic_flow_tpu_torch.runtime.stream import SyntheticScene

# --------------------------------------------------------------------------- #
# decoders                                                                     #
# --------------------------------------------------------------------------- #


def test_decode_image_respects_stride():
    img = np.arange(12 * 7, dtype=np.uint8).reshape(12, 7)
    raw = ser_image(4.25, img, step_pad=3)
    msg = decode_image_msg(raw)
    assert msg.stamp == pytest.approx(4.25)
    np.testing.assert_array_equal(msg.data, img)
    assert_same_message(msg, jax_rb2.decode_image_msg(raw))


def test_decode_image_big_endian():
    img = np.arange(30, dtype=np.uint8).reshape(5, 6)
    raw = ser_image(1.5, img, endian=">")
    np.testing.assert_array_equal(decode_image_msg(raw).data, img)
    assert_same_message(decode_image_msg(raw), jax_rb2.decode_image_msg(raw))


def test_decode_camera_info():
    k = [420.0, 0, 240, 0, 421.0, 241, 0, 0, 1]
    raw = ser_camera_info(2.0, k, [0.1, 0.2, 0, 0, 0], binning_x=2)
    ci = decode_camera_info_msg(raw)
    assert list(ci.k) == k
    assert list(ci.d) == [0.1, 0.2, 0, 0, 0]
    assert ci.binning_x == 2
    assert_same_message(ci, jax_rb2.decode_camera_info_msg(raw))
    raw_be = ser_camera_info(2.0, k, [0.1], endian=">")
    assert_same_message(decode_camera_info_msg(raw_be), jax_rb2.decode_camera_info_msg(raw_be))


def test_decode_camera_info_empty_d():
    ci = decode_camera_info_msg(ser_camera_info(2.0, [1.0] * 9, []))
    assert list(ci.d) == [0.0] * 5


def test_decode_imu_odometry_height():
    raw = ser_imu(3.0, quat=(0, 0, 0.7071, 0.7071), ang=(0.1, -0.2, 0.3))
    imu = decode_imu_msg(raw)
    assert imu.stamp == pytest.approx(3.0)
    assert imu.angular_velocity == pytest.approx((0.1, -0.2, 0.3))
    assert imu.orientation[2] == pytest.approx(0.7071)
    assert_same_message(imu, jax_rb2.decode_imu_msg(raw))

    raw = ser_odometry(3.5, lin=(1.0, 2.0, 3.0), ang=(0.0, 0.0, 0.5))
    odo = decode_odometry_msg(raw)
    assert odo.stamp == pytest.approx(3.5)
    assert odo.linear_velocity == pytest.approx((1.0, 2.0, 3.0))
    assert odo.angular_velocity[2] == pytest.approx(0.5)
    assert_same_message(odo, jax_rb2.decode_odometry_msg(raw))

    raw = ser_height(4.0, 2.5)
    h = decode_float64_stamped_msg(raw)
    assert (h.stamp, h.value) == (pytest.approx(4.0), pytest.approx(2.5))
    assert_same_message(h, jax_rb2.decode_float64_stamped_msg(raw))


def test_decode_tf_message():
    raw = ser_tf([
        ("uav1/fcu", "uav1/cam", (0.0, 0.0, 0.0, 1.0)),
        ("world", "uav1/fcu", (0.0, 0.7071, 0.0, 0.7071)),
    ])
    tfs = decode_tf_message(raw)
    assert [(p, c) for p, c, _ in tfs] == [("uav1/fcu", "uav1/cam"), ("world", "uav1/fcu")]
    assert tfs[1][2][1] == pytest.approx(0.7071)
    assert tfs == jax_rb2.decode_tf_message(raw)


def test_xcdr2_encapsulation_rejected():
    payload = b"\x00\x07\x00\x00" + b"\x00" * 16  # XCDR2 DELIMITED_CDR LE
    with pytest.raises(Bag2FormatError, match="encapsulation"):
        decode_imu_msg(payload)


def test_truncated_cdr_raises():
    whole = ser_imu(3.0)
    # cut inside the orientation quaternion — decode_imu consumes only a
    # prefix of the message, so the cut must land inside the CONSUMED part
    with pytest.raises(Bag2FormatError, match="truncated"):
        decode_imu_msg(whole[:30])
    with pytest.raises(Bag2FormatError, match="truncated"):
        decode_image_msg(ser_image(1.0, np.zeros((4, 4), np.uint8))[:-8])


# --------------------------------------------------------------------------- #
# reader                                                                       #
# --------------------------------------------------------------------------- #

def test_reader_roundtrip(tmp_path):
    img = np.zeros((4, 4), np.uint8)
    path = write_db3(
        tmp_path / "flight.db3",
        [(1, "/cam/image_raw", "sensor_msgs/msg/Image"), (2, "/odom", "nav_msgs/msg/Odometry")],
        [(10.0, 1, ser_image(10.0, img)), (10.01, 2, ser_odometry(10.01)),
         (10.05, 1, ser_image(10.05, img))],
    )
    with Bag2Reader(path) as r:
        msgs = list(r.messages())
    assert [(round(t, 3), topic) for t, topic, _, _ in msgs] == [
        (10.0, "/cam/image_raw"), (10.01, "/odom"), (10.05, "/cam/image_raw")]
    assert msgs[0][2] == "sensor_msgs/msg/Image"
    assert r.topics_by_type() == {
        "sensor_msgs/msg/Image": ["/cam/image_raw"],
        "nav_msgs/msg/Odometry": ["/odom"],
    }


def _split_bag(tmp_path, metadata: str):
    """Two .db3 parts whose name order (a_, b_) contradicts their time order."""
    bag = tmp_path / "flight"
    bag.mkdir()
    img = np.zeros((4, 4), np.uint8)
    topics = [(1, "/cam/image_raw", "sensor_msgs/msg/Image")]
    write_db3(bag / "b_0.db3", topics, [(10.0, 1, ser_image(10.0, img))])
    write_db3(bag / "a_1.db3", topics, [(11.0, 1, ser_image(11.0, img))])
    (bag / "metadata.yaml").write_text(metadata)
    return bag


SPLIT_METADATA = ("rosbag2_bagfile_information:\n"
                  "  relative_file_paths:\n    - b_0.db3\n    - a_1.db3\n")


def test_directory_split_bags(tmp_path, monkeypatch):
    """A bag directory with split .db3 files replays them in
    metadata.yaml's relative_file_paths order — with ``yaml`` blocked, as
    on the card."""
    bag = _split_bag(tmp_path, SPLIT_METADATA)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with Bag2Reader(str(bag)) as r:
        times = [round(t, 3) for t, _, _, _ in r.messages()]
    assert times == [10.0, 11.0]


def test_split_bags_natural_sort_without_metadata(tmp_path):
    """rosbag2 names split files <bag>_<N>.db3; without metadata.yaml the
    fallback ordering must be numeric (lexicographic puts _10 before _2,
    replaying minutes out of order)."""
    bag = tmp_path / "long"
    bag.mkdir()
    img = np.zeros((4, 4), np.uint8)
    topics = [(1, "/cam", "sensor_msgs/msg/Image")]
    for i in (0, 1, 2, 10, 11):
        write_db3(bag / f"long_{i}.db3", topics, [(100.0 + i, 1, ser_image(100.0 + i, img))])
    with Bag2Reader(str(bag)) as r:
        times = [round(t, 3) for t, _, _, _ in r.messages()]
    assert times == [100.0, 101.0, 102.0, 110.0, 111.0]


def test_is_rosbag2(tmp_path):
    assert is_rosbag2("x/flight.db3")
    assert not is_rosbag2("x/flight.bag")
    bag = tmp_path / "dir_bag"
    bag.mkdir()
    assert not is_rosbag2(str(bag))
    (bag / "metadata.yaml").write_text("{}")
    assert is_rosbag2(str(bag))


def test_not_a_database_raises(tmp_path):
    p = tmp_path / "junk.db3"
    p.write_bytes(b"definitely not sqlite" * 10)
    with pytest.raises(Bag2FormatError, match="sqlite3"):
        Bag2Reader(str(p))


def test_missing_file_raises(tmp_path):
    with pytest.raises(Bag2FormatError, match="no such file"):
        Bag2Reader(str(tmp_path / "absent.db3"))


def test_non_cdr_serialization_rejected(tmp_path):
    p = tmp_path / "pb.db3"
    con = sqlite3.connect(str(p))
    con.execute("CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT, type TEXT, "
                "serialization_format TEXT, offered_qos_profiles TEXT)")
    con.execute("CREATE TABLE messages(id INTEGER PRIMARY KEY, topic_id INTEGER, "
                "timestamp INTEGER, data BLOB)")
    con.execute("INSERT INTO topics VALUES (1, '/x', 'std_msgs/msg/Empty', 'protobuf', '')")
    con.commit()
    con.close()
    with pytest.raises(Bag2FormatError, match="serialization"):
        Bag2Reader(str(p))


def test_empty_directory_raises(tmp_path):
    bag = tmp_path / "empty"
    bag.mkdir()
    (bag / "metadata.yaml").write_text("{}")
    with pytest.raises(Bag2FormatError, match="no .db3"):
        Bag2Reader(str(bag))


# --------------------------------------------------------------------------- #
# metadata.yaml without a YAML library                                         #
# --------------------------------------------------------------------------- #

METADATA_CASES = {
    "block, deeper": SPLIT_METADATA,
    "block, at the key's indentation": ("rosbag2_bagfile_information:\n  version: 5\n"
                                        "  relative_file_paths:\n  - b_0.db3\n  - a_1.db3\n"
                                        "  duration:\n    nanoseconds: 3\n"),
    "flow, quoted": ("rosbag2_bagfile_information:\n"
                     "  relative_file_paths: [\"b_0.db3\", 'a_1.db3']\n"),
    "comments and a missing file": ("# recorded by ros2 bag\nrosbag2_bagfile_information:\n"
                                    "  relative_file_paths:  # parts\n    - gone_2.db3\n"
                                    "    - b_0.db3  # first\n    - \"a_1.db3\"\n"
                                    "  files:\n    - path: a_1.db3\n"),
    "other top-level key": "other:\n  relative_file_paths:\n    - a_1.db3\n    - b_0.db3\n",
    "flow, split over lines": ("rosbag2_bagfile_information:\n"
                               "  relative_file_paths: [b_0.db3,  # first\n"
                               "    'a_1.db3']\n  version: 5\n"),
    "block, quoted hash": ("rosbag2_bagfile_information:\n  relative_file_paths:\n"
                           "    - 'gone #1.db3'\n    - \"b_0.db3\"  # first\n    - a_1.db3\n"),
    "block, apostrophe in a plain name": ("rosbag2_bagfile_information:\n  relative_file_paths:\n"
                                          "    - it's_2.db3  # gone\n    - b_0.db3\n"
                                          "    - a_1.db3\n"),
    "empty map": "{}",
    "no list": "rosbag2_bagfile_information:\n  version: 5\n",
}


@pytest.mark.parametrize("case", METADATA_CASES)
def test_relative_file_paths_match_yaml(case, tmp_path, monkeypatch):
    """The port's reader against ``yaml.safe_load`` on the same text, and
    the replay order against the JAX package's (which reads it with
    ``yaml``), with ``yaml`` blocked for the port."""
    import yaml

    text = METADATA_CASES[case]
    info = (yaml.safe_load(text) or {}).get("rosbag2_bagfile_information") or {}
    assert rb2._relative_file_paths(text) == info.get("relative_file_paths", [])
    bag = _split_bag(tmp_path, text)
    want = jax_rb2._storage_files(str(bag))
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert rb2._storage_files(str(bag)) == want


def test_bag2_writer_metadata_read_without_yaml(tmp_path, monkeypatch):
    """``Bag2Writer``'s own ``metadata.yaml`` gives its one storage file."""
    path = write_flight(rb2, port_msgs, tmp_path / "written", ros2=True)
    monkeypatch.setitem(sys.modules, "yaml", None)
    text = open(os.path.join(path, "metadata.yaml")).read()
    assert rb2._relative_file_paths(text) == ["written_0.db3"]


# --------------------------------------------------------------------------- #
# MCAP storage                                                                 #
# --------------------------------------------------------------------------- #

def _mcap_flight(tmp_path):
    img = np.zeros((4, 4), np.uint8)
    return write_mcap(tmp_path / "flight.mcap", [
        mcap_chunk([
            mcap_schema(1, "sensor_msgs/msg/Image"),
            mcap_channel(1, 1, "/cam/image_raw"),
            mcap_message(1, 10.0, ser_image(10.0, img)),
        ]),
        mcap_schema(2, "nav_msgs/msg/Odometry"),
        mcap_channel(2, 2, "/odom"),
        mcap_message(2, 10.01, ser_odometry(10.01)),
        mcap_message(1, 10.05, ser_image(10.05, img)),
    ])


def test_mcap_roundtrip_chunked_and_bare(tmp_path):
    """Schema/channel resolution and message streaming, for messages both
    inside an uncompressed chunk and at top level."""
    path = _mcap_flight(tmp_path)
    with Bag2Reader(path) as r:
        msgs = list(r.messages())
    assert [(round(t, 3), topic, tn) for t, topic, tn, _ in msgs] == [
        (10.0, "/cam/image_raw", "sensor_msgs/msg/Image"),
        (10.01, "/odom", "nav_msgs/msg/Odometry"),
        (10.05, "/cam/image_raw", "sensor_msgs/msg/Image"),
    ]
    assert r.topics_by_type()["sensor_msgs/msg/Image"] == ["/cam/image_raw"]
    assert decode_odometry_msg(msgs[1][3]).stamp == pytest.approx(10.01)


def test_mcap_summary_section_topic_discovery(tmp_path):
    """Real mcap writers put channels inside compressed chunks and repeat
    them in the summary section; topic discovery must resolve from the
    summary (footer summary_start) without decompressing any chunk."""
    img = np.zeros((4, 4), np.uint8)
    schema = mcap_schema(1, "sensor_msgs/msg/Image")
    channel = mcap_channel(1, 1, "/cam/image_raw")
    path = write_mcap(
        tmp_path / "s.mcap",
        [mcap_chunk([schema, channel, mcap_message(1, 10.0, ser_image(10.0, img))],
                    compression="snappy", comp_bytes=b"junk")],
        summary=[schema, channel],
    )
    with Bag2Reader(path) as r:
        assert r.topics_by_type() == {"sensor_msgs/msg/Image": ["/cam/image_raw"]}
        with pytest.raises(Bag2FormatError, match="compression"):
            list(r.messages())


def _zstd_inner(img):
    return [
        mcap_schema(1, "sensor_msgs/msg/Image"),
        mcap_channel(1, 1, "/cam"),
        mcap_message(1, 5.0, ser_image(5.0, img)),
    ]


def test_mcap_zstd_chunk(tmp_path, monkeypatch):
    """rosbag2's mcap writer compresses chunks with zstd by default; a zstd
    chunk round-trips when a zstd module exists (skipped without one), and
    raises the gating error with every zstd module blocked (the card has
    none: Python 3.12 has no ``compression.zstd``)."""
    img = np.arange(16, dtype=np.uint8).reshape(4, 4)
    inner = _zstd_inner(img)
    monkeypatch.setitem(sys.modules, "zstandard", None)
    monkeypatch.setitem(sys.modules, "compression", None)
    monkeypatch.setitem(sys.modules, "compression.zstd", None)
    path = write_mcap(tmp_path / "z.mcap", [
        mcap_chunk(inner, compression="zstd", comp_bytes=b"\x28\xb5\x2f\xfd junk")])
    with pytest.raises(Bag2FormatError, match="zstd"):
        Bag2Reader(path)


def test_mcap_zstd_chunk_with_zstandard(tmp_path):
    zstandard = pytest.importorskip("zstandard")
    img = np.arange(16, dtype=np.uint8).reshape(4, 4)
    inner = _zstd_inner(img)
    comp = zstandard.ZstdCompressor().compress(b"".join(inner))
    path = write_mcap(tmp_path / "z.mcap", [mcap_chunk(inner, compression="zstd", comp_bytes=comp)])
    with Bag2Reader(path) as r:
        msgs = list(r.messages())
    assert len(msgs) == 1 and msgs[0][1] == "/cam"
    np.testing.assert_array_equal(decode_image_msg(msgs[0][3]).data, img)


def test_mcap_unknown_compression_raises(tmp_path):
    path = write_mcap(tmp_path / "s.mcap", [
        mcap_chunk([mcap_schema(1, "x"), mcap_channel(1, 1, "/t")],
                   compression="snappy", comp_bytes=b"junk"),
    ])
    with pytest.raises(Bag2FormatError, match="compression"):
        Bag2Reader(path)


def test_mcap_bad_magic_and_truncation(tmp_path):
    p = tmp_path / "bad.mcap"
    p.write_bytes(b"not an mcap file at all")
    with pytest.raises(Bag2FormatError, match="magic"):
        Bag2Reader(str(p))

    good = write_mcap(tmp_path / "good.mcap", [
        mcap_schema(1, "sensor_msgs/msg/Image"),
        mcap_channel(1, 1, "/cam"),
        mcap_message(1, 1.0, ser_image(1.0, np.zeros((4, 4), np.uint8))),
    ])
    whole = open(good, "rb").read()
    trunc = tmp_path / "trunc.mcap"
    trunc.write_bytes(whole[: len(whole) // 2])
    with pytest.raises(Bag2FormatError, match="truncated"):
        Bag2Reader(str(trunc))


def test_mcap_non_cdr_channel_rejected(tmp_path):
    path = write_mcap(tmp_path / "pb.mcap", [
        mcap_schema(1, "foo/msg/Bar"),
        mcap_channel(1, 1, "/t", encoding="protobuf"),
    ])
    with pytest.raises(Bag2FormatError, match="serialization"):
        Bag2Reader(path)


def test_mcap_magic_sniff_beats_extension(tmp_path):
    """A .db3-named file with MCAP content reads as MCAP (content sniff)."""
    img = np.zeros((4, 4), np.uint8)
    mcap_bytes = open(write_mcap(tmp_path / "x.mcap", [
        mcap_schema(1, "sensor_msgs/msg/Image"),
        mcap_channel(1, 1, "/cam"),
        mcap_message(1, 2.0, ser_image(2.0, img)),
    ]), "rb").read()
    disguised = tmp_path / "disguised.db3"
    disguised.write_bytes(mcap_bytes)
    with Bag2Reader(str(disguised)) as r:
        assert len(list(r.messages())) == 1


def test_mcap_directory_mixed_with_db3(tmp_path, monkeypatch):
    """A split bag can mix storage flavors; replay follows metadata order
    (read here with ``yaml`` blocked)."""
    bag = tmp_path / "flight"
    bag.mkdir()
    img = np.zeros((4, 4), np.uint8)
    write_db3(bag / "part1.db3", [(1, "/cam", "sensor_msgs/msg/Image")],
              [(10.0, 1, ser_image(10.0, img))])
    write_mcap(bag / "part2.mcap", [
        mcap_schema(1, "sensor_msgs/msg/Image"),
        mcap_channel(1, 1, "/cam"),
        mcap_message(1, 11.0, ser_image(11.0, img)),
    ])
    (bag / "metadata.yaml").write_text(
        "rosbag2_bagfile_information:\n  relative_file_paths:\n    - part1.db3\n    - part2.mcap\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with Bag2Reader(str(bag)) as r:
        times = [round(t, 3) for t, _, _, _ in r.messages()]
    assert times == [10.0, 11.0]
    assert is_rosbag2(str(bag))
    assert is_rosbag2("whatever.mcap")


@pytest.mark.parametrize("layout", ["metadata", "db3 only", "mcap only", "empty", "other files",
                                    "flight.mcap", "flight.db3", "flight.bag", "flight.ofrec"])
def test_is_rosbag2_matches_jax(tmp_path, layout):
    """The CLI's dispatch test, on directories and file names."""
    if layout.startswith("flight."):
        path = str(tmp_path / layout)
    else:
        path = tmp_path / "bag"
        path.mkdir()
        names = {"metadata": ["metadata.yaml"], "db3 only": ["x_0.db3"], "mcap only": ["x.mcap"],
                 "empty": [], "other files": ["notes.txt", "x.bag"]}[layout]
        for n in names:
            (path / n).write_text("")
        path = str(path)
    assert is_rosbag2(path) == jax_rb2.is_rosbag2(path)


# --------------------------------------------------------------------------- #
# end-to-end replay                                                            #
# --------------------------------------------------------------------------- #

def _replay(path, **kw):
    published = []
    node = OpticFlowNode(load_config(), device="cpu",
                         publish=lambda t, m: published.append((t, m)), log=lambda s: None)
    if not (kw.get("camera_frame") and kw.get("uav_frame")):
        node.set_transforms((0.0, 0.0, 0.0, 1.0))
    frames = replay_bag2(node, path, **kw)
    return frames, [m for t, m in published if t == "velocity_out"]


def _assert_velocity(twists):
    assert len(twists) >= 3
    v = np.array([tw.linear[:2] for tw in twists[1:]])
    assert np.abs(v - np.array(V_TRUE)).max() < 0.15, v


def test_replay_full_flight(tmp_path):
    """All five ROS2 topics recorded: the node recovers the true velocity
    from the bag alone — the rosbag2 twin of the ROS1 flight test."""
    frames, twists = _replay(_flight_db3(tmp_path, full=True))
    assert frames == 6
    _assert_velocity(twists)


def test_replay_full_flight_mcap(tmp_path):
    """The same full flight through the MCAP storage flavor (messages in
    an uncompressed chunk, like rosbag2's mcap writer produces)."""
    scene = SyntheticScene(uav_height=HEIGHT, seed=2)
    records = [
        mcap_schema(1, "sensor_msgs/msg/Image"),
        mcap_channel(1, 1, "/uav1/camera/image_raw"),
        mcap_schema(2, "sensor_msgs/msg/CameraInfo"),
        mcap_channel(2, 2, "/uav1/camera/camera_info"),
        mcap_message(2, 99.0, ser_camera_info(
            99.0, [scene.fx, 0, scene.cx, 0, scene.fy, scene.cy, 0, 0, 1], [0.0] * 5)),
    ]
    frames_recs = []
    for i in range(6):
        t = 100.0 + i * DT
        pos = (V_TRUE[0] * i * DT, V_TRUE[1] * i * DT)
        frame = np.clip(np.round(scene.render(pos)), 0, 255).astype(np.uint8)
        frames_recs.append(mcap_message(1, t, ser_image(t, frame)))
    records.append(mcap_chunk(frames_recs))
    frames, twists = _replay(write_mcap(tmp_path / "flight.mcap", records), default_height=HEIGHT)
    assert frames == 6
    _assert_velocity(twists)


def test_replay_image_only_bag(tmp_path):
    frames, twists = _replay(_flight_db3(tmp_path, full=False), default_height=HEIGHT)
    assert frames == 6
    _assert_velocity(twists)


def test_replay_tf_from_bag(tmp_path):
    """camera->body resolves from /tf_static CDR messages through the
    shared TfTree chain composition (identity chain here: the recovered
    velocity must match the no-tf replay)."""
    scene = SyntheticScene(uav_height=HEIGHT, seed=2)
    topics = [(1, "/uav1/camera/image_raw", "sensor_msgs/msg/Image"),
              (2, "/tf_static", "tf2_msgs/msg/TFMessage")]
    messages_ = [(99.0, 2, ser_tf([("uav1/fcu", "uav1/link", (0.0, 0.0, 0.0, 1.0)),
                                   ("uav1/link", "uav1/cam", (0.0, 0.0, 0.0, 1.0))]))]
    for i in range(6):
        t = 100.0 + i * DT
        pos = (V_TRUE[0] * i * DT, V_TRUE[1] * i * DT)
        frame = np.clip(np.round(scene.render(pos)), 0, 255).astype(np.uint8)
        messages_.append((t, 1, ser_image(t, frame)))
    path = write_db3(tmp_path / "tf.db3", topics, messages_)
    frames, twists = _replay(path, default_height=HEIGHT, camera_frame="uav1/cam",
                             uav_frame="uav1/fcu")
    assert frames == 6
    _assert_velocity(twists)


def test_height_accepts_std_msgs_variant(tmp_path):
    """std_msgs/msg/Float64Stamped (vendored type, same wire layout) binds
    the height role too."""
    img = np.zeros((4, 4), np.uint8)
    path = write_db3(
        tmp_path / "h.db3",
        [(1, "/cam", "sensor_msgs/msg/Image"), (2, "/h", "std_msgs/msg/Float64Stamped")],
        [(10.0, 2, ser_height(10.0, 3.0)), (10.01, 1, ser_image(10.01, img))],
    )
    node = OpticFlowNode(load_config(), device="cpu", publish=lambda t, m: None,
                         log=lambda s: None)
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    replay_bag2(node, path)
    assert node.got_height
    assert node.uav_height == pytest.approx(3.0)


# --------------------------------------------------------------------------- #
# CLI                                                                          #
# --------------------------------------------------------------------------- #

def test_cli_replay_db3(tmp_path, capsys):
    from mrs_optic_flow_tpu_torch.__main__ import main

    rc = main(["--replay", _flight_db3(tmp_path, full=True), "--height", str(HEIGHT),
               "--device", "cpu"])
    assert rc == 0
    assert "twists from 6 replay frames" in capsys.readouterr().out


def test_cli_bag_info_rosbag2(tmp_path, capsys):
    from mrs_optic_flow_tpu_torch.__main__ import main

    rc = main(["--bag-info", _flight_db3(tmp_path, full=True)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "sensor_msgs/msg/Image" in out
    assert "/uav1/camera/image_raw" in out


# --------------------------------------------------------------------------- #
# Bag2Writer (sqlite3 storage + metadata.yaml + CDR encoders)                  #
# --------------------------------------------------------------------------- #

def test_bag2_encoders_roundtrip():
    from mrs_optic_flow_tpu_torch.runtime.msgs import (
        CameraInfo,
        Float64Stamped,
        ImageMsg,
        Imu,
        Odometry,
    )

    img = (np.arange(13 * 7, dtype=np.uint8).reshape(13, 7) * 3) % 251
    m = decode_image_msg(rb2.encode_image_msg(ImageMsg(stamp=4.25, data=img)))
    assert m.stamp == pytest.approx(4.25)
    np.testing.assert_array_equal(m.data, img)

    bgr = np.dstack([img, img + 1, img + 2]).astype(np.uint8)
    m = decode_image_msg(rb2.encode_image_msg(ImageMsg(stamp=1.0, data=bgr)))
    np.testing.assert_array_equal(m.data, bgr)

    k = [400.0, 0, 376, 0, 410.0, 240, 0, 0, 1]
    d = [0.1, -0.05, 0.001, 0.002, 0.01]
    info = decode_camera_info_msg(
        rb2.encode_camera_info_msg(CameraInfo(k=k, d=d, binning_x=2), 7.5, shape=(480, 752)))
    assert list(info.k) == k and list(info.d) == d
    assert info.binning_x == 2

    imu = decode_imu_msg(rb2.encode_imu_msg(Imu(
        stamp=3.5, angular_velocity=(0.1, -0.2, 0.3), orientation=(0.0, 0.1, 0.0, 0.995))))
    assert imu.stamp == pytest.approx(3.5)
    assert tuple(imu.angular_velocity) == pytest.approx((0.1, -0.2, 0.3))
    assert tuple(imu.orientation) == pytest.approx((0.0, 0.1, 0.0, 0.995))

    odo = decode_odometry_msg(rb2.encode_odometry_msg(Odometry(
        stamp=9.0, orientation=(0, 0, 0.383, 0.924),
        linear_velocity=(1.5, -0.5, 0.1), angular_velocity=(0, 0, 0.2))))
    assert odo.stamp == pytest.approx(9.0)
    assert tuple(odo.linear_velocity) == pytest.approx((1.5, -0.5, 0.1))

    h = decode_float64_stamped_msg(rb2.encode_float64_stamped_msg(
        Float64Stamped(stamp=2.0, value=3.75)))
    assert (h.stamp, h.value) == (pytest.approx(2.0), pytest.approx(3.75))


@pytest.mark.parametrize("name", ENCODED)
def test_encoder_bytes_equal_jax(name):
    ours = encode(rb2, name, messages(port_msgs)[name])
    theirs = encode(jax_rb2, name, messages(jax_msgs)[name])
    assert ours == theirs


def test_bag2_writer_reader_roundtrip(tmp_path):
    """Bag2Writer output is a directory Bag2Reader (and stock rosbag2
    layout expectations) open: metadata.yaml + one .db3 with the topics/
    messages/schema tables, messages in timestamp order."""
    from mrs_optic_flow_tpu_torch.runtime.rosbag2 import Bag2Writer

    path = str(tmp_path / "written_bag")
    with Bag2Writer(path) as w:
        w.write("/b", "std_msgs/msg/String", 2.0, b"\x00\x01\x00\x00bb")
        w.write("/a", "std_msgs/msg/String", 1.0, b"\x00\x01\x00\x00aa")
        w.write("/a", "std_msgs/msg/String", 3.0, b"\x00\x01\x00\x00cc")

    assert is_rosbag2(path)
    meta = (tmp_path / "written_bag" / "metadata.yaml").read_text()
    assert "storage_identifier: sqlite3" in meta
    assert "written_bag_0.db3" in meta
    assert "message_count: 3" in meta

    with Bag2Reader(path) as r:
        topics = dict(r.topic_types)
        msgs = list(r.messages())
    assert topics == {"/a": "std_msgs/msg/String", "/b": "std_msgs/msg/String"}
    # storage yields timestamp order regardless of write order
    assert [(m[0], m[1]) for m in msgs] == [(1.0, "/a"), (2.0, "/b"), (3.0, "/a")]
    assert msgs[0][3].endswith(b"aa") and msgs[2][3].endswith(b"cc")

    # metadata.yaml parses as YAML, and as the port reads it without one
    import yaml

    info = yaml.safe_load(meta)["rosbag2_bagfile_information"]
    assert info["relative_file_paths"] == ["written_bag_0.db3"]
    assert rb2._relative_file_paths(meta) == ["written_bag_0.db3"]
    assert info["message_count"] == 3
    assert {t["topic_metadata"]["name"]: t["message_count"]
            for t in info["topics_with_message_count"]} == {"/a": 2, "/b": 1}


def test_bag2_writer_matches_jax(tmp_path):
    """The same writes through each package's ``Bag2Writer``: identical
    ``metadata.yaml`` text, and each package reads both directories to the
    same message tuples."""
    ours = write_flight(rb2, port_msgs, tmp_path / "port" / "flight", ros2=True)
    theirs = write_flight(jax_rb2, jax_msgs, tmp_path / "jax" / "flight", ros2=True)
    meta = [open(os.path.join(p, "metadata.yaml")).read() for p in (ours, theirs)]
    assert meta[0] == meta[1]
    read = []
    for path in (ours, theirs):
        for mod in (rb2, jax_rb2):
            with mod.Bag2Reader(path) as r:
                read.append((list(r.messages()), dict(r.topic_types)))
    assert all(r == read[0] for r in read[1:]) and len(read[0][0]) == 13


@pytest.mark.parametrize("source", ["db3", "mcap", "port writer", "jax writer"])
def test_each_package_reads_the_others_bag(tmp_path, source):
    if source == "db3":
        path = _flight_db3(tmp_path, full=True)
    elif source == "mcap":
        path = _mcap_flight(tmp_path)
    else:
        mod, msgs = (rb2, port_msgs) if source == "port writer" else (jax_rb2, jax_msgs)
        path = write_flight(mod, msgs, tmp_path / "flight", ros2=True)
    with Bag2Reader(path) as ours, jax_rb2.Bag2Reader(path) as theirs:
        got, want = list(ours.messages()), list(theirs.messages())
        assert ours.topics_by_type() == theirs.topics_by_type()
    assert got == want and len(got) >= 3


def test_bag2_writer_replay(tmp_path):
    """A flight written by Bag2Writer with the module's CDR encoders
    replays through the standard replay_bag2 path and recovers velocity —
    writer-side counterpart of test_replay_full_flight."""
    from mrs_optic_flow_tpu_torch.runtime.msgs import Float64Stamped, ImageMsg, Imu, Odometry

    scene = SyntheticScene(uav_height=HEIGHT, seed=2)
    path = str(tmp_path / "wflight")
    with rb2.Bag2Writer(path) as w:
        w.write("/cam/camera_info", "sensor_msgs/msg/CameraInfo", 99.0,
                rb2.encode_camera_info_msg(scene.camera_info(), 99.0))
        for i in range(6):
            t = 100.0 + i * DT
            w.write("/imu", "sensor_msgs/msg/Imu", t - 1e-4, rb2.encode_imu_msg(Imu(
                stamp=t, angular_velocity=(0.0, 0.0, 0.0), orientation=(0.0, 0.0, 0.0, 1.0))))
            w.write("/odom", "nav_msgs/msg/Odometry", t - 1e-4, rb2.encode_odometry_msg(Odometry(
                stamp=t, orientation=(0.0, 0.0, 0.0, 1.0),
                linear_velocity=(V_TRUE[0], V_TRUE[1], 0.0))))
            w.write("/height", "mrs_msgs/msg/Float64Stamped", t - 1e-4,
                    rb2.encode_float64_stamped_msg(Float64Stamped(stamp=t, value=HEIGHT)))
            pos = (V_TRUE[0] * i * DT, V_TRUE[1] * i * DT)
            frame = np.clip(np.round(scene.render(pos)), 0, 255).astype(np.uint8)
            w.write("/image", "sensor_msgs/msg/Image", t,
                    rb2.encode_image_msg(ImageMsg(stamp=t, data=frame)))
    frames, twists = _replay(path)
    assert frames == 6
    _assert_velocity(twists)
