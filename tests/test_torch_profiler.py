"""The port's ``Profiler`` event log and device trace against the JAX
package's profiler, on the CPU: the JSON lines (their keys and their count,
one a routine call), each line on disk before the next routine starts,
``close()``, and a ``torch.profiler`` trace whose exported Chrome trace
holds each routine as a named range, from a bare routine and from the
node's frame program."""

import json
import os

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (pins torch to one thread)

from mrs_optic_flow_tpu.runtime.profiler import Profiler as JaxProfiler
from mrs_optic_flow_tpu_torch.config import NodeConfig
from mrs_optic_flow_tpu_torch.runtime import profiler as port_profiler
from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode
from mrs_optic_flow_tpu_torch.runtime.profiler import Profiler
from mrs_optic_flow_tpu_torch.runtime.stream import FrameStream, SyntheticScene


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_event_log_lines_match_jax(tmp_path):
    ours, theirs = Profiler("x", event_log_path=str(tmp_path / "ours.jsonl")), \
        JaxProfiler("x", event_log_path=str(tmp_path / "theirs.jsonl"))
    for p in (ours, theirs):
        for name in ("a", "b", "a"):
            with p.routine(name):
                pass
        p.close()
    a, b = _lines(tmp_path / "ours.jsonl"), _lines(tmp_path / "theirs.jsonl")
    assert [sorted(e) for e in a] == [sorted(e) for e in b] == [["dur_s", "routine", "t"]] * 3
    assert [e["routine"] for e in a] == [e["routine"] for e in b] == ["a", "b", "a"]
    assert all(e["dur_s"] >= 0 and e["t"] > 0 for e in a)
    assert ours.stats()["a"]["count"] == 2


def test_event_log_flushes_each_line_and_appends(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    p = Profiler("x", event_log_path=path)
    for i in range(3):
        with p.routine("step"):
            pass
        assert len(_lines(path)) == i + 1  # on disk before close()
    p.close()
    p.close()  # twice is harmless
    with p.routine("after_close"):
        pass
    assert len(_lines(path)) == 3
    q = Profiler("x", event_log_path=path)  # appends, as the JAX log does
    with q.routine("step"):
        pass
    q.close()
    assert len(_lines(path)) == 4


def test_disabled_profiler_logs_nothing(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    p = Profiler("x", enabled=False, event_log_path=path, trace_dir=str(tmp_path))
    with p.routine("step"):
        pass
    p.close()
    assert _lines(path) == [] and p.stats() == {}


def _trace_names(path):
    with open(path) as f:
        return [e.get("name") for e in json.load(f)["traceEvents"]]


def test_device_trace_holds_the_routine_range(tmp_path):
    p = Profiler("x", trace_dir=str(tmp_path / "trace"))
    p.start_device_trace()
    for _ in range(2):
        with p.routine("correlate"):
            torch.fft.rfft2(torch.ones(32, 32))
    path = p.stop_device_trace()
    assert os.path.dirname(path) == str(tmp_path / "trace") and path.endswith(".json")
    names = _trace_names(path)
    assert names.count("correlate") == 2
    with pytest.raises(RuntimeError):
        p.stop_device_trace()


def test_device_trace_default_directory(tmp_path, monkeypatch):
    """Without ``trace_dir`` the trace goes to ``build/`` of the checkout
    (redirected here); routines then carry no range."""
    monkeypatch.setattr(port_profiler, "DEFAULT_TRACE_DIR", tmp_path / "default")
    p = Profiler("x")
    p.start_device_trace()
    with p.routine("correlate"):
        pass
    path = p.stop_device_trace()
    assert os.path.dirname(path) == str(tmp_path / "default")
    assert "correlate" not in _trace_names(path)


def test_node_frames_under_the_trace(tmp_path):
    """The method-4 node on the CPU with a tracing profiler: one log line
    and one trace range a frame program."""
    scene = SyntheticScene(width=320, height_px=288, uav_height=2.0, seed=3)
    node = OpticFlowNode(NodeConfig(frame_size=256, sample_point_size=64), device="cpu",
                         publish=lambda t, m: None, log=lambda s: None)
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    log = str(tmp_path / "node.jsonl")
    node.profiler = Profiler("OpticFlow", event_log_path=log, trace_dir=str(tmp_path / "trace"))
    events = []

    class _Collect:
        def add(self, kind, stamp, msg):
            events.append((stamp, len(events), kind, msg))
            return self

    scene.trajectory_events(_Collect(), velocity=(0.4, -0.2), n_frames=4, dt=0.05)
    node.profiler.start_device_trace()
    for _, _, kind, msg in sorted(events, key=lambda e: e[:2]):
        getattr(node, FrameStream.KIND_DISPATCH[kind])(msg)
    path = node.profiler.stop_device_trace()
    node.profiler.close()
    lines = _lines(log)
    frames = [e for e in lines if e["routine"] == "frame_program"]
    assert len(frames) == 3  # the first image only seeds the previous frame
    assert _trace_names(path).count("frame_program") == len(frames)
    assert np.all([e["dur_s"] > 0 for e in frames])
