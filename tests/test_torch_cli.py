"""The port's CLI (``python -m mrs_optic_flow_tpu_torch``), mirroring
``tests/test_cli.py`` with ``--device cpu``: the synthetic run, the flight
gate, overrides, ``.ofrec`` record and replay, the fleet; the modes not
ported yet (ROS bridges and bags, ROADMAP queue 1 item 9) exit 2 naming the
item; and without ``--device`` on a host with no CUDA device the run fails
naming the device and never runs on the CPU."""

import json
import pathlib
import re
import subprocess
import sys

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


@pytest.mark.parametrize("argv,what", [
    (["--ros"], "--ros"),
    (["--ros2"], "--ros2"),
    (["--bag-info", "flight.bag"], "--bag-info"),
    (["--replay", "flight.bag"], "--replay of a ROS bag"),
    (["--replay", "flight.db3"], "--replay of a ROS bag"),
])
def test_cli_ros_and_bags_not_ported(argv, what, capsys, tmp_path):
    rc = main([*argv, *CPU])
    assert rc == 2
    err = capsys.readouterr().err
    assert what in err and "ROADMAP queue 1 item 9" in err


def test_cli_replay_of_rosbag2_directory_not_ported(tmp_path, capsys):
    assert main(["--replay", str(tmp_path), *CPU]) == 2
    assert "item 9" in capsys.readouterr().err


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
