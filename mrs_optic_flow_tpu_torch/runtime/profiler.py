"""Per-stage wall-time statistics and throttled logging — the port's copy
of :mod:`mrs_optic_flow_tpu.runtime.profiler` (the ``mrs_lib::Profiler`` +
``Routine`` and ``ROS_*_THROTTLE`` idioms): routine statistics and the text
report.  The JAX profiler's event log and device-trace hooks are not ported
(ROADMAP queue 1 item 8).

A routine times the host side of a stage with ``time.perf_counter``; device
work that the stage only enqueues is not waited for.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class Profiler:
    def __init__(self, name: str = "OpticFlow", enabled: bool = True):
        self.name = name
        self.enabled = enabled
        self._samples: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def routine(self, routine_name: str):
        """``profiler_->createRoutine(name)`` as a context manager."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[routine_name].append(time.perf_counter() - t0)

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
