"""The port's measurement harness (``mrs_optic_flow_tpu_torch/utils/
benchlib.py``) against the JAX package's (``mrs_optic_flow_tpu/utils/
benchlib.py``) on the same inputs: the slope and window arithmetic under one
scripted ``perf_counter`` sequence (equal dicts), the latency frames (equal
bytes), the device chain's escalation and budget rules with the slope
stubbed (equal records), and smoke runs of the node latency and the A/B pair
on a small CPU node.  The card-side timing (CUDA events, ``torch.profiler``)
runs in ``chip_smoke.py`` phase 18.
"""

import math
import signal
import time

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (pins torch to one thread)

from mrs_optic_flow_tpu.models import FftMethodConfig as JaxFftMethodConfig
from mrs_optic_flow_tpu.utils import benchlib as jax_bl
from mrs_optic_flow_tpu_torch.models import FftMethodConfig
from mrs_optic_flow_tpu_torch.utils import benchlib as bl


class _FakeClock:
    """Scripted ``perf_counter``: the measured calls advance it by scripted
    durations, so both packages see the same times."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


#: per-call duration [s] of a k-item chain at rep i
DURATIONS = {
    "quiet": lambda k, i: 0.065 + 0.0003 * k,
    "jitter": lambda k, i: 0.065 + 1e-5 * k + (0.005 if i % 2 else -0.005),
    "negative": lambda k, i: 0.100 - 0.0001 * k,
    "drift": lambda k, i: 0.010 + 0.0002 * k + 0.001 * i,
}


def _slope(module, monkeypatch, duration_fn, k_pair, reps, warmup):
    clock = _FakeClock()
    monkeypatch.setattr(module.time, "perf_counter", clock.perf_counter)

    def build(k):
        rep = {"i": 0}

        def run(i):
            clock.t += duration_fn(k, rep["i"])
            rep["i"] += 1

        return run

    return module.measure_scan_slope(build, k_pair, reps=reps, warmup=warmup)


@pytest.mark.parametrize("shape", sorted(DURATIONS))
@pytest.mark.parametrize("k_pair,reps,warmup", [((25, 100), 7, 2), ((4, 16), 4, 1)])
def test_scan_slope_equals_jax(monkeypatch, shape, k_pair, reps, warmup):
    ours = _slope(bl, monkeypatch, DURATIONS[shape], k_pair, reps, warmup)
    theirs = _slope(jax_bl, monkeypatch, DURATIONS[shape], k_pair, reps, warmup)
    assert ours == theirs


def test_scan_slope_verdicts(monkeypatch):
    """The JAX tests' three verdicts: a quiet slope is reliable, a jitter
    artifact and a negative slope are not."""
    quiet = _slope(bl, monkeypatch, DURATIONS["quiet"], (25, 100), 7, 2)
    assert quiet["reliable"] is True
    assert quiet["per_item_ms"] == pytest.approx(0.3, rel=1e-6)
    assert quiet["overhead_ms"] == pytest.approx(65.0, rel=1e-6)
    jitter = _slope(bl, monkeypatch, DURATIONS["jitter"], (25, 100), 7, 2)
    assert jitter["per_item_ms"] > 0 and jitter["reliable"] is False
    assert jitter["delta_ms"] < 3 * jitter["jitter_ms"]
    negative = _slope(bl, monkeypatch, DURATIONS["negative"], (25, 100), 7, 2)
    assert negative["per_item_ms"] < 0 and negative["reliable"] is False


def _chained_stats(module, monkeypatch, to_result, iters, pipeline, warmup):
    clock = _FakeClock()
    monkeypatch.setattr(module.time, "perf_counter", clock.perf_counter)
    calls = {"n": 0}
    first = []

    def chained(prev, curr):
        clock.t += 0.01 + 0.002 * (calls["n"] % 3) + 0.0005 * calls["n"]
        calls["n"] += 1
        return prev, to_result(float(calls["n"]))

    stats = module.measure_chained_stats(chained, None, None, items_per_call=64, iters=iters,
                                         pipeline=pipeline, warmup=warmup, progress=first.append)
    return stats, first


@pytest.mark.parametrize("iters,pipeline,warmup", [(16, 1, 3), (8, 2, 1), (9, 4, 0), (1, 1, 1)])
def test_chained_stats_equal_jax(monkeypatch, iters, pipeline, warmup):
    """The same windows, the upper-middle time as the headline, the rates in
    chronological order and the first window's progress call."""
    ours = _chained_stats(bl, monkeypatch, lambda v: torch.tensor([v]), iters, pipeline, warmup)
    theirs = _chained_stats(jax_bl, monkeypatch, lambda v: np.float32(v), iters, pipeline, warmup)
    assert ours == theirs


def test_chained_stats_headline_is_the_slower_middle_window():
    def step(prev, curr):
        s = (prev.to(torch.float32) * curr.to(torch.float32)).sum()
        return s, s

    st = bl.measure_chained_stats(bl.make_chained(step), torch.ones(8, 8), torch.ones(8, 8),
                                  items_per_call=8, iters=8, pipeline=2, warmup=1)
    assert st["n_windows"] == len(st["window_rates"]) == 4
    assert st["rate_min"] <= st["rate"] <= st["rate_max"]
    assert st["rate"] == sorted(st["window_rates"])[1]
    assert bl.measure_chained(bl.make_chained(step), torch.ones(8, 8), torch.ones(8, 8),
                              items_per_call=8, iters=2, warmup=1) > 0


@pytest.mark.parametrize("dtype,bump", [(torch.uint8, 7.0), (torch.float32, float("nan"))])
def test_make_chained_keeps_dtype_and_forces_dependence(dtype, bump):
    def step(prev, curr):
        return prev.to(torch.float32).sum(), torch.tensor(bump)

    chained = bl.make_chained(step)
    prev = torch.zeros((4, 4), dtype=dtype)
    nxt, result = chained(prev, torch.ones((4, 4), dtype=dtype))
    assert nxt.dtype == dtype
    nxt2, _ = chained(nxt, torch.ones((4, 4), dtype=dtype))
    # the bump is 1..3 (a NaN bump counts as 0): each call's input changes
    assert float(nxt2.sum()) > float(nxt.sum()) > 0
    assert float(result) == 0.0


@pytest.mark.parametrize("n_distinct,width,height,channels,seed", [
    (64, 752, 480, 3, 0), (5, 96, 64, 1, 3), (3, 130, 70, 3, 11),
])
def test_latency_frames_byte_equal_to_jax(n_distinct, width, height, channels, seed):
    kw = dict(width=width, height=height, channels=channels, seed=seed)
    ours = bl.make_latency_frames(n_distinct, **kw)
    theirs = jax_bl.make_latency_frames(n_distinct, **kw)
    assert len(ours) == len(theirs) == n_distinct
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.uint8 and a.flags.c_contiguous
        assert a.tobytes() == b.tobytes()


def _stub_slope(calls, reliable_from=None):
    """A ``measure_scan_slope`` that records its chain lengths and is
    reliable from the longer length ``reliable_from`` on (never with None)."""

    def fake_slope(build, k_pair, reps=7, warmup=2):
        calls.append(tuple(k_pair))
        reliable = reliable_from is not None and k_pair[1] >= reliable_from
        return {
            "per_item_ms": 0.3 if reliable_from else 0.05, "overhead_ms": 65.0,
            "k_pair": list(k_pair),
            "med_ms": {int(k): 65.0 + 0.3 * k for k in k_pair},
            "delta_ms": 0.3 * (k_pair[1] - k_pair[0]),
            "jitter_ms": 0.0 if reliable else 50.0,
            "reliable": reliable,
        }

    return fake_slope


#: (max_k, budget_s, the slope's first reliable length) -> chain lengths
ESCALATIONS = [
    (64, 10_000.0, 64, [(4, 16), (8, 32), (16, 64)]),  # escalates until reliable
    (64, 0.0, None, [(4, 16)]),  # no budget left: no escalation
    (None, None, None, [(4, 16)]),  # opt-in: neither budget nor max_k
    (32, 10_000.0, None, [(4, 16), (8, 32)]),  # stops at max_k, unreliable
    (None, 10_000.0, 1_000, [(4, 16), (8, 32), (16, 64)]),  # max_k defaults to 4 k
    (64, 0.5, None, [(4, 16)]),  # the doubled chains cost more than the budget
]


@pytest.mark.parametrize("max_k,budget_s,reliable_from,expected", ESCALATIONS)
def test_device_chain_escalation_equals_jax(monkeypatch, max_k, budget_s, reliable_from, expected):
    """The escalation and budget rules of ``tests/test_benchlib.py:159-210``
    with the slope stubbed, in both packages: the same chain lengths and the
    same record (the JAX ``per_frame_ms`` is the port's wall slope)."""
    kw = dict(reps=2, warmup=1, width=64, height=48, max_k=max_k, budget_s=budget_s)
    calls_ours, calls_theirs = [], []
    monkeypatch.setattr(bl, "measure_scan_slope", _stub_slope(calls_ours, reliable_from))
    monkeypatch.setattr(jax_bl, "measure_scan_slope", _stub_slope(calls_theirs, reliable_from))
    ours = bl.measure_device_chain_latency(
        16, config=FftMethodConfig(frame_size=48, sample_point_size=12), device="cpu", **kw)
    theirs = jax_bl.measure_device_chain_latency(
        16, config=JaxFftMethodConfig(frame_size=48, sample_point_size=12, mxu_passes=1), **kw)
    assert calls_ours == calls_theirs == expected
    for key in ("k", "dispatch_overhead_ms", "chain_medians_ms", "delta_ms", "jitter_ms", "escalations",
                "slope_ok"):
        assert ours[key] == theirs[key], key
    assert ours["wall_per_frame_ms"] == theirs["per_frame_ms"]
    # the CPU has no device profile, and the record says so
    assert ours["per_frame_ms"] is None and ours["launches_per_frame"] is None
    assert ours["measured"].startswith("wall only")


def test_device_chain_latency_tiny_geometry():
    """The chain itself (grayscale -> crop -> flow -> getRT -> detilt) at 48
    px frames and 12 px windows, both chain lengths, no escalation."""
    out = bl.measure_device_chain_latency(
        8, reps=2, warmup=1, config=FftMethodConfig(frame_size=48, sample_point_size=12),
        width=64, height=48, max_k=8, device="cpu")
    assert out["k"] == 8 and out["escalations"] == 0
    assert math.isfinite(out["wall_per_frame_ms"]) and isinstance(out["slope_ok"], bool)


def test_device_chain_rejects_k_below_two():
    with pytest.raises(ValueError, match="k must be >= 2"):
        bl.measure_device_chain_latency(1, device="cpu")


def test_device_chain_refuses_a_missing_card():
    """The measurement runs on the card unless told otherwise, and never
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bl.measure_device_chain_latency(4)


SMALL = {"mrs_optic_flow": {"frame_size": 96, "sample_point_size": 24}}


def test_node_latency_smoke():
    out = bl.measure_node_latency(4, warmup=2, n_distinct=2, overrides=SMALL, device="cpu")
    assert out["n"] == 4
    for key in ("p50_ms", "p90_ms", "p95_ms", "p99_ms", "mean_ms"):
        assert math.isfinite(out[key]) and out[key] > 0
    assert out["p50_ms"] <= out["p99_ms"]


def test_node_latency_ab_smoke():
    out = bl.measure_node_latency_ab(
        8, block=2, warmup=2, n_distinct=2, overrides_a=SMALL,
        overrides_b={"mrs_optic_flow": {"frame_size": 96, "sample_point_size": 32}}, device="cpu")
    assert out["n_rounds"] == 2 and len(out["round_deltas_ms"]) == 2 and out["block"] == 2
    assert math.isfinite(out["delta_p50_ms"]) and 0.0 <= out["sign_consistency"] <= 1.0
    assert out["a_p50_ms"] > 0 and out["b_p50_ms"] > 0


def test_latency_node_reads_the_overrides():
    node = bl._make_latency_node(SMALL, "cpu")
    assert (node.config.frame_size, node.config.sample_point_size) == (96, 24)
    assert node.device.type == "cpu" and node.got_height and node.got_odometry


@pytest.mark.parametrize("ops,nbytes,expected", [
    (67e9, 1.0, (1.0, "operations")),
    (1.0, 3.35e9, (1.0, "bytes")),
    (67e6, 3.35e6, (1e-3, "operations")),  # a tie goes to the operations
])
def test_bound_of(ops, nbytes, expected):
    ms, by = bl.bound_of(ops, nbytes)
    assert ms == pytest.approx(expected[0]) and by == expected[1]


def test_percentiles_and_idle_share():
    t = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert bl.percentiles(t) == {"p50_ms": 3.0, "p90_ms": pytest.approx(4.6)}
    assert bl.percentiles(t, (0, 100)) == {"p0_ms": 1.0, "p100_ms": 5.0}
    assert bl.idle_share(2.5, 10.0) == 0.75
    assert bl.idle_share(12.0, 10.0) == 0.0 and bl.idle_share(1.0, 0.0) == 0.0


def test_time_budget_raises_and_restores():
    before = signal.getsignal(signal.SIGALRM)
    with pytest.raises(TimeoutError, match="budget of 0.05 s"):
        with bl.time_budget(0.05) as left:
            assert 0 < left() <= 0.05
            time.sleep(1.0)
    assert signal.getsignal(signal.SIGALRM) is before
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
    with bl.time_budget(None) as left:
        assert left() == math.inf


def test_no_host_sync_is_a_plain_block_on_the_cpu():
    with bl.no_host_sync(torch.device("cpu")):
        assert float(torch.ones(3).sum().item()) == 3.0
