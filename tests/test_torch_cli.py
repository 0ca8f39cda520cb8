"""The port's CLI (``python -m mrs_optic_flow_tpu_torch``), mirroring
``tests/test_cli.py`` with ``--device cpu``: the synthetic run, the flight
gate, overrides, ``.ofrec`` record and replay, the fleet; the bags
(``--bag-info`` printing the JAX CLI's text, ``--replay`` of a ``.bag``, a
``.db3``, an ``.mcap`` and rosbag2 directories with the JAX CLI's frame and
twist counts, the bag's ``/tf`` with ``--camera-frame``/``--uav-frame``, a
malformed ``--bag-topic``) and the ROS modes without ``rospy``/``rclpy``;
and without ``--device`` on a host with no CUDA device the run fails naming
the device and never runs on the CPU (``--bag-info`` builds no node and
needs none)."""

import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (pins torch to one thread)

from mrs_optic_flow_tpu import __main__ as jax_cli
from mrs_optic_flow_tpu_torch import native
from mrs_optic_flow_tpu_torch.__main__ import _parse_overrides, filter_ros_remap_args, main

CPU = ["--device", "cpu"]
REPO = pathlib.Path(__file__).resolve().parent.parent


def test_cli_synthetic(capsys):
    rc = main(["--synthetic", "--frames", "5", "--velocity", "0.5,0.0", "--quiet", *CPU])
    assert rc == 0
    out = capsys.readouterr().out
    assert "fcu_untilted" in out and "health" in out
    v = [float(m) for m in re.findall(r"v = ([+-]\d+\.\d+)", out)]
    assert len(v) == 4 and all(abs(x - 0.5) < 0.15 for x in v[1:]), out


def test_cli_flight_gate(capsys):
    """``--flight``: banked against the default budgets, and level with an
    impossible budget (the gate flips while the flight itself is healthy),
    as ``tests/test_cli.py::test_cli_flight_gate``."""
    rc = main(["--flight", "banked", "--quiet", *CPU])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, rep
    assert rep["rmse_xy"] < 0.15 and rep["nan_published"] == 0
    assert set(rep["per_phase_coverage"]) == {"climb", "cruise", "brake", "descent"}
    assert 0.005 < rep["nees_xy"] < 2.5

    rc_level = main(["--flight", "level", "--quiet", "--flight-rmse-budget", "0.001", *CPU])
    rep_level = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc_level == 1
    assert rep_level["rmse_xy"] < 0.15, rep_level
    assert rep_level["nan_published"] == 0
    assert 0.005 < rep_level["nees_xy"] < 2.5
    assert all(v >= 0.9 for v in rep_level["per_phase_coverage"].values())
    assert set(rep_level["per_phase_coverage"]) == {"takeoff", "cruise", "descent"}


def test_cli_overrides_and_profile(capsys):
    rc = main(["--synthetic", "--frames", "4", "--quiet", "--profile",
               "--set", "mrs_optic_flow.shifted_pts_thr=4",
               "--set", "constraints.max_pixel_speed=60",
               "--set", "tpu.host_preprocess=true", *CPU])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[OpticFlow] profiler report" in out and "frame_program" in out


@pytest.mark.parametrize("pairs", [
    [], ["a=1"], ["a.b.c=true", "a.b.d=[1, 2]", "x=text", "y=1.5", "z=null", "w="],
    ["mrs_optic_flow.frame_size=256", "mrs_optic_flow.method=5", "tpu.backend=\"fft\""],
])
def test_parse_overrides_matches_jax(pairs):
    assert _parse_overrides(pairs) == jax_cli._parse_overrides(pairs)


@pytest.mark.parametrize("argv", [
    ["--synthetic"],
    ["--synthetic", "__name:=optic_flow", "__log:=/tmp/x.log", "image:=/cam/image"],
    ["--ros-args", "-r", "a:=b", "-p", "x:=1", "--", "--synthetic", "--quiet"],
    ["--flight", "level", "--ros-args", "--params-file", "p.yaml"],
])
def test_filter_ros_remap_args_matches_jax(argv):
    assert filter_ros_remap_args(argv) == jax_cli.filter_ros_remap_args(argv)


def test_cli_record_and_replay(tmp_path, capsys):
    if not native.available():
        pytest.skip("native runtime unavailable (no C++ toolchain)")
    rec = str(tmp_path / "run.ofrec")
    rc = main(["--synthetic", "--frames", "5", "--velocity", "0.6,0.2", "--record", rec,
               "--quiet", *CPU])
    assert rc == 0
    rc = main(["--replay", rec, "--quiet", *CPU])
    assert rc == 0
    out = capsys.readouterr().out
    assert "twists from 5 replay frames" in out
    with native.Replay(rec) as rep:
        assert rep.n_frames == 5 and rep.frame_shape == (480, 752)


def test_cli_fleet(capsys):
    rc = main(["--fleet", "2", "--frames", "4", "--velocity", "0.5,-0.2", *CPU])
    assert rc == 0
    out = capsys.readouterr().out
    assert "2/2 streams ok" in out
    m = re.findall(r"fleet mean v = ([+-]\d+\.\d+) ([+-]\d+\.\d+)", out)
    vx, vy = float(m[-1][0]), float(m[-1][1])
    assert abs(vx - 0.5) < 0.1 and abs(vy + 0.2) < 0.1, (vx, vy)


# --------------------------------------------------------------------------- #
# bags and ROS                                                                 #
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def bags(tmp_path_factory):
    """One 6-frame recorded flight in every format the CLI replays: the ROS1
    bag of ``tests/test_rosbag.py``, the rosbag2 ``.db3`` of
    ``tests/test_rosbag2.py`` alone, as an ``.mcap`` with the same messages
    (each topic's first messages in a chunk), in a directory with no
    ``metadata.yaml`` and as ``Bag2Writer``'s directory."""
    import shutil

    from test_rosbag import _flight_bag
    from test_rosbag2 import _flight_db3, mcap_channel, mcap_chunk, mcap_message, mcap_schema, write_mcap

    from mrs_optic_flow_tpu_torch.runtime.rosbag2 import Bag2Reader, Bag2Writer

    root = tmp_path_factory.mktemp("bags")
    (root / "ros1").mkdir()
    (root / "ros2").mkdir()
    out = {"bag": _flight_bag(root / "ros1", full=True),
           "db3": _flight_db3(root / "ros2", full=True)}
    with Bag2Reader(out["db3"]) as r:
        msgs, types = list(r.messages()), dict(r.topic_types)
    ids = {topic: i + 1 for i, topic in enumerate(types)}
    head = [rec for topic, i in ids.items()
            for rec in (mcap_schema(i, types[topic]), mcap_channel(i, i, topic))]
    records = [mcap_message(ids[topic], t, raw) for t, topic, _, raw in msgs]
    out["mcap"] = write_mcap(root / "flight.mcap", head + [mcap_chunk(records[:5])] + records[5:])
    (root / "db3_dir").mkdir()
    shutil.copy(out["db3"], root / "db3_dir" / "flight_0.db3")
    out["db3 dir"] = str(root / "db3_dir")
    with Bag2Writer(str(root / "written")) as w:
        for t, topic, type_name, raw in msgs:
            w.write(topic, type_name, t, raw)
    out["metadata dir"] = str(root / "written")
    return out


BAG_KINDS = ["bag", "db3", "mcap", "db3 dir", "metadata dir"]


@pytest.mark.parametrize("kind", BAG_KINDS)
def test_cli_bag_info_matches_jax(bags, kind, capsys):
    """``--bag-info`` prints the JAX CLI's text, without ``--device``."""
    assert main(["--bag-info", bags[kind]]) == 0
    ours = capsys.readouterr().out
    assert jax_cli.main(["--bag-info", bags[kind]]) == 0
    assert ours == capsys.readouterr().out
    assert re.search(r"image_raw\s+6\s", ours), ours


def _summary(out: str) -> str:
    return out.strip().splitlines()[-1].split("; health")[0]


@pytest.mark.parametrize("kind", BAG_KINDS)
def test_cli_replay_bag_matches_jax(bags, kind, capsys):
    """``--replay`` of every format reaches the bag replay (R3: an ``.mcap``
    and a directory of ``.db3`` files without ``metadata.yaml`` are
    rosbag2s): 6 frames, and the JAX CLI's count of twists."""
    assert main(["--replay", bags[kind], "--quiet", *CPU]) == 0
    ours = capsys.readouterr().out
    assert _summary(ours) == "5 twists from 6 replay frames", ours
    assert jax_cli.main(["--replay", bags[kind], "--quiet"]) == 0
    assert _summary(capsys.readouterr().out) == _summary(ours)


def test_cli_replay_empty_directory_is_not_a_bag(tmp_path):
    """R3: a directory with neither ``metadata.yaml`` nor storage files is
    not a rosbag2: it reaches the ``.ofrec`` reader and its error, as in the
    JAX CLI."""
    with pytest.raises(OSError) as ours:
        main(["--replay", str(tmp_path), *CPU])
    with pytest.raises(OSError) as theirs:
        jax_cli.main(["--replay", str(tmp_path)])
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("frames,published", [(("uav1/cam", "uav1/fcu"), True),
                                              (("uav1/elsewhere", "uav1/fcu"), False)])
def test_cli_replay_bag_tf(tmp_path, capsys, frames, published):
    """``--camera-frame``/``--uav-frame`` with a bag replay resolve
    camera->body from the bag's ``/tf_static``; frames the bag never joins
    leave the node gated: no twist, as in the JAX CLI."""
    from test_rosbag import DT, conn_record, msg_record, ser_image, ser_tf, write_bag

    from mrs_optic_flow_tpu_torch.runtime import SyntheticScene

    scene = SyntheticScene(uav_height=2.0, seed=2)
    ident = (0.0, 0.0, 0.0, 1.0)
    records = [conn_record(0, "/cam/image_raw", "sensor_msgs/Image"),
               conn_record(1, "/tf_static", "tf2_msgs/TFMessage"),
               msg_record(1, 99.0, ser_tf([("uav1/fcu", "uav1/cam", ident)]))]
    for i in range(4):
        t = 100.0 + i * DT
        frame = np.clip(np.round(scene.render((0.8 * i * DT, -0.5 * i * DT))), 0, 255)
        records.append(msg_record(0, t, ser_image(t, frame.astype(np.uint8))))
    path = write_bag(tmp_path / "tf.bag", records)
    argv = ["--replay", path, "--quiet", "--camera-frame", frames[0], "--uav-frame", frames[1]]
    assert main([*argv, *CPU]) == 0
    ours = _summary(capsys.readouterr().out)
    assert ours == ("3 twists from 4 replay frames" if published else "0 twists from 4 replay frames")
    assert jax_cli.main(argv) == 0
    assert _summary(capsys.readouterr().out) == ours


@pytest.mark.parametrize("pin", ["image", "=/cam/image_raw", "image="])
def test_cli_bag_topic_malformed_exits_2(bags, pin, capsys):
    """A ``--bag-topic`` that is not ROLE=TOPIC exits 2 naming the form, as
    the JAX CLI does."""
    for cli, extra in ((main, CPU), (jax_cli.main, [])):
        with pytest.raises(SystemExit) as exc:
            cli(["--replay", bags["bag"], "--bag-topic", pin, *extra])
        assert exc.value.code == 2
        assert "--bag-topic needs ROLE=TOPIC" in capsys.readouterr().err


@pytest.mark.parametrize("flag,module", [("--ros", "rospy"), ("--ros2", "rclpy")])
def test_cli_ros_without_ros_raises_import_error(flag, module, monkeypatch):
    """``--ros``/``--ros2`` on a host without ``rospy``/``rclpy`` (blocked
    here) raise ``ImportError`` before any node is built."""
    monkeypatch.setitem(sys.modules, module, None)
    with pytest.raises(ImportError, match=module):
        main([flag, *CPU])


@pytest.mark.parametrize("flag", ["--ros", "--ros2"])
def test_cli_ros_runs_the_bridge(flag, monkeypatch):
    """``--ros``/``--ros2`` with a fake ``rospy``/``rclpy`` and bridge: ROS is
    initialised, the bridge built with the CLI's frames and device, warmed
    up unless ``--no-warmup``, then spun, its node closed (repair F14) and
    ``rclpy`` shut down."""
    import types

    from mrs_optic_flow_tpu_torch.runtime import ros2_bridge, ros_bridge

    calls = []
    log = types.SimpleNamespace(info=lambda msg: None)

    class Bridge:
        handle = types.SimpleNamespace(get_logger=lambda: log)

        def __init__(self, cfg, **kw):
            calls.append(("bridge", kw))
            self.node = types.SimpleNamespace(close=lambda: calls.append(("close",)))

        def warmup(self):
            calls.append(("warmup",))

        def spin(self):
            calls.append(("spin",))

    if flag == "--ros":
        monkeypatch.setitem(sys.modules, "rospy", types.SimpleNamespace(
            init_node=lambda name: calls.append(("init", name)), loginfo=lambda msg: None))
        monkeypatch.setattr(ros_bridge, "RosBridge", Bridge)
        first, last = ("init", "optic_flow"), ("close",)
    else:
        monkeypatch.setitem(sys.modules, "rclpy", types.SimpleNamespace(
            init=lambda: calls.append(("init",)), shutdown=lambda: calls.append(("shutdown",))))
        monkeypatch.setattr(ros2_bridge, "Ros2Bridge", Bridge)
        first, last = ("init",), ("shutdown",)
    assert main([flag, "--camera-frame", "cam", *CPU]) == 0
    assert calls[0] == first and calls[-1] == last and ("warmup",) in calls
    assert calls[calls.index(("spin",)) + 1] == ("close",)
    kw = calls[1][1]
    assert (kw["camera_frame"], kw["uav_frame"], kw["uav_untilted_frame"]) == (
        "cam", "fcu", "fcu_untilted")
    assert str(kw["device"]) == "cpu"
    calls.clear()
    assert main([flag, "--no-warmup", *CPU]) == 0
    assert ("warmup",) not in calls and ("spin",) in calls


@pytest.mark.skipif(torch.cuda.is_available(), reason="the host has a CUDA device")
def test_cli_bag_info_needs_no_device(bags, capsys):
    assert main(["--bag-info", bags["bag"]]) == 0
    assert capsys.readouterr().out.startswith(f"{bags['bag']}: 25 messages, ")


@pytest.mark.skipif(torch.cuda.is_available(), reason="the host has a CUDA device")
def test_cli_without_device_needs_cuda(capsys):
    """The default device is the card: without one the run fails naming
    the device, before any frame is processed on the CPU."""
    with pytest.raises(SystemExit) as exc:
        main(["--synthetic", "--frames", "3"])
    assert exc.value.code == 2
    out = capsys.readouterr()
    assert "'cuda'" in out.err and "no CUDA device" in out.err
    assert "twists" not in out.out and "fcu" not in out.out


@pytest.mark.skipif(torch.cuda.is_available(), reason="the host has a CUDA device")
def test_cli_module_entry_point_without_cuda():
    proc = subprocess.run([sys.executable, "-m", "mrs_optic_flow_tpu_torch", "--flight", "level"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "'cuda'" in proc.stderr and proc.stdout == ""
