"""Profiling and tracing — the ``mrs_lib::Profiler`` + ``Routine`` and
``ROS_*_THROTTLE`` idioms, port of :mod:`mrs_optic_flow_tpu.runtime.profiler`.

The reference wraps every callback and timer in a RAII Routine
(``src/optic_flow.cpp:1075``, ``:1107``, ``:1258``, ``:1435``, ...), toggled
by ``enable_profiler``.  Here: per-routine wall-time statistics and their
text report, an optional JSON-lines event log, and a device trace through
``torch.profiler`` in which each routine is a named range.

A routine times the host side of a stage with ``time.perf_counter``; device
work that the stage only enqueues is not waited for (the device trace shows
it).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

import torch

#: where :meth:`Profiler.stop_device_trace` writes without a ``trace_dir``
#: (``build/`` of the checkout, which git ignores)
DEFAULT_TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_trace"


class Profiler:
    def __init__(self, name: str = "OpticFlow", enabled: bool = True,
                 event_log_path: Optional[str] = None,
                 trace_dir: Optional[str] = None):
        """``event_log_path``: append one JSON line ``{"t", "routine",
        "dur_s"}`` a routine call, flushed at once.  ``trace_dir`` (the JAX
        profiler's ``jax_trace_dir``, renamed: the trace is PyTorch's): each
        routine runs inside ``torch.profiler.record_function`` with its name,
        and :meth:`stop_device_trace` writes its Chrome trace there."""
        self.name = name
        self.enabled = enabled
        self.trace_dir = trace_dir
        self._samples: Dict[str, list] = defaultdict(list)
        self._event_log = open(event_log_path, "a") if event_log_path else None
        self._trace: Optional[torch.profiler.profile] = None

    def start_device_trace(self):
        """Start a ``torch.profiler`` trace of the CPU and, where there is
        one, the CUDA device."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._trace = torch.profiler.profile(activities=acts)
        self._trace.__enter__()

    def stop_device_trace(self) -> str:
        """Stop the trace and export it as a Chrome trace into ``trace_dir``
        (``DEFAULT_TRACE_DIR`` without one); returns the file's path."""
        if self._trace is None:
            raise RuntimeError("stop_device_trace without start_device_trace")
        trace, self._trace = self._trace, None
        trace.__exit__(None, None, None)
        out = Path(self.trace_dir) if self.trace_dir is not None else DEFAULT_TRACE_DIR
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{self.name}.{os.getpid()}.{time.time_ns()}.pt.trace.json"
        trace.export_chrome_trace(str(path))
        return str(path)

    @contextlib.contextmanager
    def routine(self, routine_name: str):
        """``profiler_->createRoutine(name)`` as a context manager."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        rng = (torch.profiler.record_function(routine_name) if self.trace_dir is not None
               else contextlib.nullcontext())
        try:
            with rng:
                yield
        finally:
            dt = time.perf_counter() - t0
            self._samples[routine_name].append(dt)
            if self._event_log is not None:
                self._event_log.write(
                    json.dumps({"t": time.time(), "routine": routine_name, "dur_s": dt}) + "\n")
                # the tail must survive a crash: no line waits in the buffer
                self._event_log.flush()

    def stats(self) -> Dict[str, dict]:
        out = {}
        for k, v in self._samples.items():
            s = sorted(v)
            n = len(s)
            out[k] = {
                "count": n,
                "mean_s": sum(s) / n,
                "p50_s": s[n // 2],
                "p95_s": s[min(n - 1, int(n * 0.95))],
                "max_s": s[-1],
            }
        return out

    def report(self) -> str:
        lines = [f"[{self.name}] profiler report"]
        for k, st in sorted(self.stats().items()):
            lines.append(
                f"  {k:28s} n={st['count']:<6d} mean={st['mean_s']*1e3:8.3f}ms "
                f"p50={st['p50_s']*1e3:8.3f}ms p95={st['p95_s']*1e3:8.3f}ms "
                f"max={st['max_s']*1e3:8.3f}ms"
            )
        return "\n".join(lines)

    def close(self):
        """Close the event log."""
        if self._event_log is not None:
            self._event_log.close()
            self._event_log = None


class ThrottledLog:
    """``ROS_INFO_THROTTLE``-style rate-limited logging."""

    def __init__(self, period_s: float = 1.0, sink=print):
        self.period_s = period_s
        self.sink = sink
        self._last: Dict[str, float] = {}

    def __call__(self, key: str, message: str):
        now = time.monotonic()
        if now - self._last.get(key, -1e9) >= self.period_s:
            self._last[key] = now
            self.sink(message)
