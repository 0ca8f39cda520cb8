"""The port's live ROS deployment surface: ``scripts/optic_flow_tpu_torch_node``
and ``launch/optic_flow_tpu_torch.launch`` / ``.launch.py`` against the JAX
package's executable and launch files, and the executable started as
roslaunch and ros2 launch start it, in a subprocess whose only ROS is the
stand-in packages of ``tests/torch_ros_standin/`` (``rospy``, ``rclpy``,
``tf2_ros`` and the message packages, fed a flight's bag):

- each launch file against the JAX one: the same remaps pair for pair,
  package, node name, namespace and arguments, plus ``device``; the node
  type is the port's executable;
- the executable's text (mode bit, shebang, imports) and its mode choice;
- the live runs on the CPU (``device:=cpu``) over 10 frames of the level
  flight at 752x480, recorded with ``record_bag`` / ``record_bag2``:
  ROS1 and ROS2, each exiting 0 with jax, yaml and cv2 blocked,
  publishing the twists of an in-process ``RosBridge`` / ``Ros2Bridge``
  (``tests/test_ros_bridge.py``'s and ``tests/test_ros2_bridge.py``'s
  fakes, ``device="cpu"``) on the same messages within 1e-6 m/s, stamp for
  stamp (the same node on the same CPU), and the JAX executable's through
  the same ROS1 stand-in within 1e-3 m/s (``torch_bag_parity.TWIST_PARITY``,
  the port node against the JAX node); ROS1 without ``mrs_msgs`` failing
  to start with the JAX bridge's ``KeyError``, as the bridge itself does;
- repair F14 (the ROS modes never closed the node, so a ``store_video``
  AVI had no index).

Run alone: ``python -m pytest tests/test_torch_launch_surface.py -q``
(about 40 s, most of it the JAX executable's compiles).
"""

from __future__ import annotations

import array
import ast
import os
import pathlib
import re
import runpy
import shlex
import stat
import subprocess
import sys
import xml.etree.ElementTree as ET

import chip_smoke
import numpy as np
import pytest
import torch_parity  # noqa: F401  (pins torch to one thread)
from test_torch_imports import FORBIDDEN_IMPORT
from torch_bag_parity import TWIST_PARITY

#: ``tests/torch_ros_standin/ros_standin.py``, loaded from its file (its
#: ``rospy`` and ``rclpy`` stay off this process's path)
ros_standin = chip_smoke.ros_standin()

REPO = pathlib.Path(__file__).resolve().parent.parent
NODE = REPO / "scripts" / "optic_flow_tpu_torch_node"
JAX_NODE = REPO / "scripts" / "optic_flow_tpu_node"
LAUNCH = {"ros1": ("optic_flow_tpu.launch", "optic_flow_tpu_torch.launch"),
          "ros2": ("optic_flow_tpu.launch.py", "optic_flow_tpu_torch.launch.py")}
N_FRAMES = 10  # of the level flight, its takeoff climb
CAMERA_FRAME, UAV_FRAME = "uav1/bluefox_optflow_optical", "uav1/fcu"
#: the runs' config: long range below 0.9 m, so the flight switches to short
#: range at its seventh frame and publishes on both velocity topics
CONFIG_LINES = {'long_range_mode: "always_off"': 'long_range_mode: "height_based"',
                "takeoff_height: 1.0 ": "takeoff_height: 0.9 "}
LIVE_TOL = 1e-6  # m/s, the executable against the in-process bridge
CHILD_TIMEOUT_S = 300


# --------------------------------------------------------------------------- #
# the launch files                                                            #
# --------------------------------------------------------------------------- #


def roslaunch_node(path: pathlib.Path, **args) -> dict:
    """The node of a ROS1 launch file as roslaunch starts it: ``argv`` is
    its ``args`` with every ``$(arg)``, ``$(find)`` and ``$(optenv)``
    substituted (``args`` over the defaults), split on whitespace as
    roslaunch splits it (newlines included), then the remaps as
    ``from:=to``, then ``__name:=`` and ``__log:=``."""
    root = ET.parse(path).getroot()
    values: dict = {}

    def subst(text: str) -> str:
        text = text.replace("$(find mrs_optic_flow_tpu)", str(REPO))
        text = re.sub(r"\$\(optenv (\w+)\)", lambda m: os.environ.get(m.group(1), ""), text)
        return re.sub(r"\$\(arg (\w+)\)", lambda m: values[m.group(1)], text)

    for arg in root.findall("arg"):
        name = arg.get("name")
        values[name] = args[name] if name in args else subst(arg.get("default"))
    (group,) = root.findall("group")
    (node,) = root.findall(".//node")
    remaps = [(r.get("from"), r.get("to")) for r in node.findall("remap")]
    argv = shlex.split(subst(node.get("args")))
    return {"pkg": node.get("pkg"), "type": node.get("type"), "name": node.get("name"),
            "namespace": subst(group.get("ns")), "declared": sorted(values),
            "flags": [a for a in argv if a.startswith("--")], "remaps": remaps,
            "argv": argv + [f"{a}:={b}" for a, b in remaps]
            + [f"__name:={node.get('name')}", "__log:=/dev/null"]}


def ros2_launch_node(path: pathlib.Path, **args) -> dict:
    """The ``Node`` of a ROS2 launch file, read from its text (``launch``
    and ``launch_ros`` are not imported): package, executable, name, the
    remaps, and ``argv`` as ``ros2 launch`` starts it, each
    ``LaunchConfiguration`` given from ``args`` or its declared default,
    then ``--ros-args`` with the node name, namespace and remaps."""
    tree = ast.parse(path.read_text())
    configs = {t.id: n.value.args[0].value for n in ast.walk(tree) if isinstance(n, ast.Assign)
               for t in n.targets if isinstance(n.value, ast.Call)
               and getattr(n.value.func, "id", "") == "LaunchConfiguration"}
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]
    declared = {c.args[0].value: {k.arg: k.value for k in c.keywords}.get("default_value")
                for c in calls if getattr(c.func, "id", "") == "DeclareLaunchArgument"}
    values: dict = {}

    def value(expr) -> str:
        if isinstance(expr, ast.Constant):
            return expr.value
        if isinstance(expr, ast.List):
            return "".join(value(e) for e in expr.elts)
        if isinstance(expr, ast.Name):
            name = configs[expr.id]
            if name not in values:
                values[name] = args[name] if name in args else value(declared[name])
            return values[name]
        if isinstance(expr, ast.Call) and expr.func.id == "EnvironmentVariable":
            default = {k.arg: k.value for k in expr.keywords}["default_value"]
            return os.environ.get(expr.args[0].value, value(default))
        raise ValueError(ast.dump(expr))

    (node,) = [c for c in calls if getattr(c.func, "id", "") == "Node"]
    kw = {k.arg: k.value for k in node.keywords}
    remaps = [tuple(value(e) for e in pair.elts) for pair in kw["remappings"].elts]
    argv = [value(e) for e in kw["arguments"].elts]
    name, namespace = value(kw["name"]), value(kw["namespace"])
    ros_args = ["--ros-args", "-r", f"__node:={name}", "-r", f"__ns:=/{namespace}"]
    for a, b in remaps:
        ros_args += ["-r", f"{a}:={b}"]
    return {"pkg": value(kw["package"]), "type": value(kw["executable"]), "name": name,
            "namespace": namespace, "declared": sorted(declared),
            "flags": [a for a in argv if a.startswith("--")], "remaps": remaps,
            "argv": argv + ros_args}


READERS = {"ros1": roslaunch_node, "ros2": ros2_launch_node}


@pytest.mark.parametrize("ros", ["ros1", "ros2"])
def test_launch_file_against_jax(ros):
    """The port's launch file is the JAX package's with the port's
    executable and a ``device`` argument passed as ``--device``: the same
    remaps pair for pair, package, node name and namespace, every flag of
    the JAX file's; the ROS2 file passes ``--ros2``."""
    jax_file, port_file = (REPO / "launch" / f for f in LAUNCH[ros])
    jax, port = READERS[ros](jax_file), READERS[ros](port_file)
    assert port["remaps"] == jax["remaps"] and len(port["remaps"]) == 10
    for key in ("pkg", "name", "namespace"):
        assert port[key] == jax[key], key
    assert jax["type"] == "optic_flow_tpu_node" and port["type"] == "optic_flow_tpu_torch_node"
    assert port["flags"] == jax["flags"] + ["--device"]
    assert port["declared"] == sorted(jax["declared"] + ["device"])
    assert ("--ros2" in port["flags"]) == (ros == "ros2")
    argv = port["argv"]
    assert argv[argv.index("--device") + 1] == "cuda"  # the card unless device:=cpu


@pytest.mark.parametrize("ros", ["ros1", "ros2"])
def test_launch_argv_reaches_the_cli(ros):
    """The argv each launch system builds from the port's file, newlines in
    the XML's ``args`` included, comes out of ``filter_ros_remap_args`` as
    the launch file's flags alone, each with its value."""
    from mrs_optic_flow_tpu_torch.__main__ import filter_ros_remap_args

    node = READERS[ros](REPO / "launch" / LAUNCH[ros][1], UAV_NAME="uav1", uav_name="uav1",
                        config="/x/c.yaml", device="cpu")
    args = filter_ros_remap_args(node["argv"])
    assert not any(":=" in a or a.startswith("__") or "\n" in a or a == "--ros-args" for a in args)
    assert [a for a in args if a.startswith("--")] == node["flags"]
    pairs = dict(zip(args, args[1:]))
    assert pairs["--camera-frame"] == CAMERA_FRAME and pairs["--uav-frame"] == UAV_FRAME
    assert pairs["--config"] == "/x/c.yaml" and pairs["--device"] == "cpu"


# --------------------------------------------------------------------------- #
# the executable                                                              #
# --------------------------------------------------------------------------- #


def test_executable_text():
    """Mode bit and shebang for roslaunch; the port's CLI and nothing of
    jax or the JAX package."""
    assert os.stat(NODE).st_mode & stat.S_IXUSR, "must be executable"
    text = NODE.read_text()
    assert text.startswith("#!/usr/bin/env python3\n")
    assert "from mrs_optic_flow_tpu_torch.__main__ import filter_ros_remap_args, main" in text
    assert not FORBIDDEN_IMPORT.search(text)


@pytest.mark.parametrize("argv,want", [
    ([], ["--ros"]),
    (["--config", "c.yaml", "__name:=optic_flow", "__log:=/tmp/l"], ["--config", "c.yaml", "--ros"]),
    (["--ros"], ["--ros"]),
    (["--ros2", "--ros-args", "-r", "__node:=optic_flow", "--"], ["--ros2"]),
    (["--ros2", "--device", "cpu", "--ros-args", "-r", "__ns:=/uav1"], ["--ros2", "--device", "cpu"]),
])
def test_executable_picks_the_mode(monkeypatch, argv, want):
    """The launch systems' arguments dropped; ``--ros`` appended only when
    neither ``--ros`` nor ``--ros2`` is there; ``main``'s status is the exit
    status."""
    import mrs_optic_flow_tpu_torch.__main__ as cli

    seen = []
    monkeypatch.setattr(cli, "main", lambda args: seen.append(args) or 7)
    monkeypatch.setattr(sys, "argv", [str(NODE), *argv])
    with pytest.raises(SystemExit) as exit_:
        runpy.run_path(str(NODE), run_name="__main__")
    assert exit_.value.code == 7 and seen == [want]


# --------------------------------------------------------------------------- #
# the bridges without mrs_msgs                                                #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("ros", ["ros1", "ros2"])
def test_bridge_without_mrs_msgs(ros):
    """With no mrs_msgs types (the height's and the tracker's) the port's
    bridge does not start: it raises the JAX bridge's ``KeyError`` word for
    word, naming the tracker topic and the ``msg_types`` override."""
    from mrs_optic_flow_tpu.config import load_config as jax_load_config
    from mrs_optic_flow_tpu.runtime import Ros2Bridge as JaxRos2Bridge
    from mrs_optic_flow_tpu.runtime import RosBridge as JaxRosBridge
    from mrs_optic_flow_tpu_torch.config import load_config
    from mrs_optic_flow_tpu_torch.runtime import Ros2Bridge, RosBridge

    if ros == "ros1":
        from test_ros_bridge import FAKE_TYPES, FakeTfBuffer, make_fake_rospy

        types, fakes = FAKE_TYPES, lambda: dict(rospy_module=make_fake_rospy(), tf_buffer=FakeTfBuffer())
        port, jax = (RosBridge, {"device": "cpu"}), (JaxRosBridge, {})
    else:
        from test_ros2_bridge import FAKE_TYPES2, FakeTfBuffer2, _Duration2, _Time2, make_fake_rclpy

        types = FAKE_TYPES2
        fakes = lambda: dict(rclpy_module=make_fake_rclpy(), tf_buffer=FakeTfBuffer2(), time_cls=_Time2,
                             duration_cls=_Duration2, sensor_qos="sensor")
        port, jax = (Ros2Bridge, {"device": "cpu"}), (JaxRos2Bridge, {})
    types = {k: v for k, v in types.items() if k not in ("Float64Stamped", "ControlManagerDiagnostics")}
    errors = []
    for (cls, kw), cfg in ((port, load_config()), (jax, jax_load_config())):
        with pytest.raises(KeyError) as err:
            cls(cfg, msg_types=types, **fakes(), **kw)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "'active_tracker_in'" in errors[0] and "install mrs_msgs or pass msg_types" in errors[0]


# --------------------------------------------------------------------------- #
# the live runs                                                               #
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def flight(tmp_path_factory):
    """The first ``N_FRAMES`` of the level flight at 752x480, recorded as a
    ROS1 bag and a rosbag2 in a directory of its own."""
    from mrs_optic_flow_tpu_torch.runtime.flightsim import (
        FlightSimulator,
        takeoff_cruise_descent_profile,
    )

    tmp = tmp_path_factory.mktemp("live")
    sim = FlightSimulator(takeoff_cruise_descent_profile()[:N_FRAMES])
    frames = sim.frames()
    sim.record_bag(str(tmp / "level.bag"), frames)
    sim.record_bag2(str(tmp / "level_bag2"), frames)
    return tmp


def write_config(path: pathlib.Path, video: pathlib.Path = None) -> str:
    text = (REPO / "configs" / "default.yaml").read_text()
    lines = dict(CONFIG_LINES)
    if video is not None:
        lines.update({"store_video: false": "store_video: true",
                      'video_path: "/dev/null"': f'video_path: "{video}"'})
    for old, new in lines.items():
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    path.write_text(text)
    return str(path)


#: label -> (launch flavour, mrs_msgs installed)
PORT_RUNS = {"ros1": ("ros1", True), "ros1 without mrs_msgs": ("ros1", False), "ros2": ("ros2", True)}


@pytest.fixture(scope="module")
def live(flight):
    """Every run, all started together, each with its own time limit: the
    port's executable as each launch file starts it (``device:=cpu``, its
    own config with ``store_video`` into an AVI), and the JAX executable
    through the ROS1 stand-in.  label -> (status, stderr, published rows,
    summary, the run's AVI)."""
    procs, runs = {}, {}
    base = {**os.environ, "OMP_NUM_THREADS": "1"}
    try:
        for label, (ros, mrs_msgs) in PORT_RUNS.items():
            tag = label.replace(" ", "_")
            video = flight / f"{tag}.avi"
            node = READERS[ros](REPO / "launch" / LAUNCH[ros][1], UAV_NAME="uav1", uav_name="uav1",
                                device="cpu", config=write_config(flight / f"{tag}.yaml", video))
            bag = flight / ("level.bag" if ros == "ros1" else "level_bag2")
            out = flight / f"{tag}.jsonl"
            env = ros_standin.environment(str(bag), str(out), mrs_msgs=mrs_msgs, base=base)
            procs[label] = subprocess.Popen([str(NODE), *node["argv"]], env=env, cwd=flight,
                                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            runs[label] = (out, video)
        # the JAX executable on the CPU: the config update after import, as
        # tests/conftest.py does
        jax_argv = roslaunch_node(REPO / "launch" / LAUNCH["ros1"][0], UAV_NAME="uav1",
                                  config=write_config(flight / "jax.yaml"))["argv"]
        code = ("import jax, runpy, sys; jax.config.update('jax_platforms', 'cpu'); "
                "sys.argv = sys.argv[1:]; runpy.run_path(sys.argv[0], run_name='__main__')")
        out = flight / "jax.jsonl"
        env = ros_standin.environment(str(flight / "level.bag"), str(out), block_jax=False,
                                      base={**base, "JAX_PLATFORMS": "cpu"})
        procs["jax"] = subprocess.Popen([sys.executable, "-c", code, str(JAX_NODE), *jax_argv], env=env,
                                        cwd=flight, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True)
        runs["jax"] = (out, None)
        done = {}
        for label, proc in procs.items():
            _, stderr = proc.communicate(timeout=CHILD_TIMEOUT_S)
            out, video = runs[label]
            rows, summary = ros_standin.read_output(str(out)) if out.exists() else (None, None)
            done[label] = (proc.returncode, stderr, rows, summary, video)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return done


def in_process_twists(flight, ros: str) -> dict:
    """The twists of an in-process bridge on the fakes of
    ``tests/test_ros_bridge.py`` (``test_ros2_bridge.py``) on the CPU, with
    the runs' config, fed the bag's messages as the stand-in feeds them:
    the camera info, the warm-up, then every message."""
    from mrs_optic_flow_tpu_torch.config import load_config
    from mrs_optic_flow_tpu_torch.runtime import Ros2Bridge, RosBridge

    cfg = load_config(write_config(flight / f"in_process_{ros}.yaml"))
    frames = dict(camera_frame=CAMERA_FRAME, uav_frame=UAV_FRAME, device="cpu")
    if ros == "ros1":
        from test_ros_bridge import FAKE_TYPES, FakeTfBuffer, make_fake_rospy

        fake = make_fake_rospy()
        bridge = RosBridge(cfg, rospy_module=fake, msg_types=FAKE_TYPES, tf_buffer=FakeTfBuffer(), **frames)
        subs, pubs, prefix = fake._subs, fake._pubs, "~"
        bag = flight / "level.bag"
    else:
        from test_ros2_bridge import FAKE_TYPES2, FakeTfBuffer2, _Duration2, _Time2, make_fake_rclpy

        bridge = Ros2Bridge(cfg, rclpy_module=make_fake_rclpy(), msg_types=FAKE_TYPES2,
                            tf_buffer=FakeTfBuffer2(), time_cls=_Time2, duration_cls=_Duration2,
                            sensor_qos="sensor", **frames)
        subs, pubs, prefix = bridge.handle.subs, bridge.handle.pubs, "~/"
        bag = flight / "level_bag2"
    callbacks = {s.topic[len(prefix):]: s.cb for s in subs}
    messages = ros_standin.ros_messages(str(bag))
    assert messages[0][0] == "camera_info_in"
    callbacks["camera_info_in"](messages[0][1])
    bridge.warmup()
    for topic, msg in messages:
        callbacks[topic](msg)
    rows = []
    for pub in pubs:
        topic = pub.topic[len(prefix):]
        if topic in ("velocity_out", "velocity_out_longrange"):
            for m in pub.sent:
                st = m.header.stamp
                rows.append({"topic": topic, "linear": [m.twist.twist.linear.x, m.twist.twist.linear.y],
                             "stamp": st.to_sec() if ros == "ros1" else st.sec + st.nanosec * 1e-9})
    return ros_standin.twists(rows)


def plain(value):
    """A stand-in message as plain values, either flavour alike: stamps in
    nanoseconds, field names lowercase, ``Header.seq`` left out."""
    if isinstance(value, ros_standin.Message):
        if value._type == "builtin_interfaces/Time":
            return value.sec * 10**9 + value.nanosec
        return {n.lower(): plain(getattr(value, n)) for n in value._fields if n != "seq"}
    if isinstance(value, ros_standin.RosTime):
        return value.to_nsec()
    if isinstance(value, (bytes, array.array)) and getattr(value, "typecode", "B") == "B":
        return bytes(value)
    if isinstance(value, (list, array.array, np.ndarray)):
        return [plain(v) for v in value]
    return value


@pytest.mark.parametrize("ros", ["ros1", "ros2"])
def test_standin_reads_both_bags_alike(flight, ros):
    """The stand-in's messages of one flavour are the same from either bag:
    the other format's converted field by field (what phase 16(l) feeds
    ``Ros2Bridge`` from the ROS1 bag) equal its own format's, and every
    message is of the flavour's class (ROS1 ``K``/``D`` and ``rospy``
    stamps, ROS2 ``k``/``d`` and ``builtin_interfaces`` stamps)."""
    ros2 = ros == "ros2"
    own, other = ("level_bag2", "level.bag") if ros2 else ("level.bag", "level_bag2")
    mine = ros_standin.ros_messages(str(flight / own))
    converted = ros_standin.ros_messages(str(flight / other), ros2=ros2)
    assert [t for t, _ in mine] == [t for t, _ in converted] and len(mine) == 1 + 4 * N_FRAMES
    classes = ros_standin.message_classes(ros2)
    for (_, a), (_, b) in zip(mine, converted):
        assert type(a) is type(b) is classes[a._type]
        assert plain(a) == plain(b)
    assert hasattr(mine[0][1], "k" if ros2 else "K")


@pytest.fixture(scope="module")
def in_process(flight):
    """flavour -> the in-process bridge's twists (``in_process_twists``)."""
    return {ros: in_process_twists(flight, ros) for ros in ("ros1", "ros2")}


@pytest.mark.parametrize("label", [label for label, (_, mrs_msgs) in PORT_RUNS.items() if mrs_msgs])
def test_live_node(live, in_process, label):
    """The executable as the launch file starts it, through the stand-in
    ROS: exit 0; jax, yaml and cv2 blocked and none of them or of the JAX
    package loaded; the node named by the launch system; the tf lookups
    between the launch file's frames; an image callback a frame; both
    velocity topics; the in-process bridge's twists within ``LIVE_TOL``,
    stamp for stamp."""
    ros, _ = PORT_RUNS[label]
    rc, stderr, rows, summary, _ = live[label]
    assert rc == 0, stderr[-3000:]
    assert summary["blocked"] == {"jax": True, "yaml": True, "cv2": True} and summary["loaded"] == []
    assert summary["node_name"] == ("optic_flow" if ros == "ros1" else "/uav1/optic_flow")
    assert sorted(map(tuple, summary["tf_lookups"])) == [(CAMERA_FRAME, UAV_FRAME), (UAV_FRAME, CAMERA_FRAME)]
    assert len(summary["image_callback_s"]) == N_FRAMES
    got = ros_standin.twists(rows)
    assert set(got) == {"velocity_out", "velocity_out_longrange"}
    assert sum(map(len, got.values())) == N_FRAMES - 1
    assert ros_standin.twist_diff(got, in_process[ros]) <= LIVE_TOL


def test_live_node_without_mrs_msgs(live):
    """On a graph without mrs_msgs (its import raises, so the bridges'
    ``ImportError`` branch runs) the executable fails to start, loudly, as
    the reference does: a non-zero exit with the bridge's ``KeyError``
    naming the tracker topic, no image taken and nothing published; jax,
    yaml and cv2 still blocked."""
    rc, stderr, rows, summary, _ = live["ros1 without mrs_msgs"]
    assert rc != 0
    assert "KeyError" in stderr and "'active_tracker_in'" in stderr and "install mrs_msgs" in stderr
    assert rows == [] and summary["image_callback_s"] == []
    assert summary["blocked"] == {"jax": True, "yaml": True, "cv2": True} and summary["loaded"] == []


def test_live_node_against_jax(live):
    """The slice against the JAX package: the JAX executable through the
    same ROS1 stand-in on the CPU publishes the port's twists within
    ``TWIST_PARITY``, stamp for stamp."""
    rc, stderr, rows, summary, _ = live["jax"]
    assert rc == 0, stderr[-3000:]
    assert "jax" in summary["loaded"]
    port = ros_standin.twists(live["ros1"][2])
    assert ros_standin.twist_diff(port, ros_standin.twists(rows)) <= TWIST_PARITY


@pytest.mark.parametrize("label", ["ros1", "ros2"])
def test_live_node_closes_video_sink(live, label):
    """Repair F14: the ROS modes close the node when the graph shuts down,
    so the ``store_video`` AVI gets its index, one overlay a processed
    frame."""
    rc, stderr, _, _, video = live[label]
    assert rc == 0, stderr[-3000:]
    w, h, frames = chip_smoke.read_avi(str(video))
    assert (w, h) == (480, 480) and len(frames) == N_FRAMES - 1
    assert np.ptp(frames) > 0


# --------------------------------------------------------------------------- #
# scripts/ci_torch.sh                                                         #
# --------------------------------------------------------------------------- #


def test_ci_torch_script_runs_the_port_lane():
    """The port's CI: the native build, the port's CPU lane, the CLI's level
    flight on the CPU, and ``chip_smoke.py`` only under ``--card``."""
    path = REPO / "scripts" / "ci_torch.sh"
    assert os.stat(path).st_mode & stat.S_IXUSR
    text = path.read_text()
    steps = ["make -C native", "python -m pytest tests/test_torch_*.py -q",
             "python -m mrs_optic_flow_tpu_torch --flight level --quiet --device cpu",
             "python3 chip_smoke.py"]
    assert all(step in text for step in steps)
    assert [text.index(step) for step in steps] == sorted(text.index(step) for step in steps)
    assert text.index('if [ "$card" = 1 ]; then\n  echo "== chip_smoke.py') < text.index("python3 chip_smoke.py")


@pytest.mark.parametrize("args,rc,says", [(["--card"], 1, "no CUDA device"), (["--cards"], 2, "usage")])
def test_ci_torch_script_refuses(args, rc, says):
    """``--card`` without a card fails before anything runs, never skipping
    the card's run in silence; an unknown argument is a usage error."""
    import torch

    if args == ["--card"] and torch.cuda.is_available():
        pytest.skip("the host has a CUDA device")
    proc = subprocess.run(["bash", str(REPO / "scripts" / "ci_torch.sh"), *args], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == rc and says in proc.stderr and "==" not in proc.stdout
