"""Measurement harness of the PyTorch port: timing on the card, bounds, and
the throughput and latency measurements of the tuning scripts.

Port of :mod:`mrs_optic_flow_tpu.utils.benchlib`, with its names and its
dicts' keys.  On a CUDA card the hazard a measurement must defeat is the
host racing ahead of the card: a launch returns before its kernel has run.
So every timed window ends with a host readback (``.item()`` of a checksum,
or a ``.cpu()`` of a result), and device time is read from CUDA events or
from ``torch.profiler``'s kernel durations, never from the host's clock
around an eager launch.

What the card-side scripts share lives here too: the bound of a kernel's
work (:func:`bound`), CUDA-event timing (:func:`time_cuda`,
:func:`timed_calls`), own device time by kernel name (:func:`own_by_kernel`,
:func:`own_ms`), a profiled call's device time, launches and idle share
(:func:`profile_calls`, :func:`device_split`), the device time of profiler
ranges (:func:`range_split`), percentiles, the
synchronisation guard :func:`no_host_sync`, and a raising time budget
(:func:`time_budget`).
"""

from __future__ import annotations

import contextlib
import math
import re
import signal
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

# --------------------------------------------------------------------------- #
# bounds                                                                       #
# --------------------------------------------------------------------------- #

#: published peaks of one H100 SXM at 700 W: float32 outside the tensor cores, HBM3
H100_FP32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12


def pc_flops(n: int) -> float:
    """Operations of one FFT phase correlation of a real ``n x n`` pair:
    5 N log2 N (N = n^2) for the forward complex transform of both patches
    packed as one, half that for the inverse, and 12 a bin of the half
    spectrum ``n (n/2 + 1)`` for the cross-power."""
    return 7.5 * n * n * math.log2(n * n) + 12 * n * (n // 2 + 1)


#: kernel -> (operations, bytes) of its function at a shape: each input
#: byte read once, each output byte written once (12 B of shift and maxval
#: a pair or window)
WORK = {
    # b frame pairs of q x q windows of n px, itemsize bytes a pixel
    "phase_correlate_frames": lambda b, n, q, itemsize: (
        b * q * q * pc_flops(n), 2 * b * (q * n) ** 2 * itemsize + 12 * b * q * q),
    # p surfaces of n x n float32: one comparison an element
    "peak_refine_raw": lambda p, n: (p * n * n, 4 * p * n * n + 12 * p),
    # g cells of s x s blocks, radius r: subtract, absolute value, add a
    # pixel and shift; float32 blocks and regions in, float32 maps out
    "sad_search": lambda g, s, r: (
        3 * g * (2 * r + 1) ** 2 * s * s,
        4 * g * (s * s + (s + 2 * r) ** 2 + (2 * r + 1) ** 2)),
    # p pairs of n x n patches
    "phase_correlate_fullfused": lambda p, n, itemsize: (
        p * pc_flops(n), 2 * p * n * n * itemsize + 12 * p),
    "phase_correlate_fused": lambda p, n, itemsize: (
        p * pc_flops(n), 2 * p * n * n * itemsize + 12 * p),
}


def bound_of(ops: float, nbytes: float) -> Tuple[float, str]:
    """(least milliseconds the card could take for ``ops`` float32
    operations and ``nbytes`` moved, "operations" or "bytes", whichever
    bounds it)."""
    t_ops, t_bytes = ops / H100_FP32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound(name: str, **shape) -> tuple:
    """(least milliseconds the card could take for kernel ``name``'s work at
    ``shape``, "operations" or "bytes", whichever bounds it)."""
    return bound_of(*WORK[name](**shape))


# --------------------------------------------------------------------------- #
# timing on the card                                                           #
# --------------------------------------------------------------------------- #


def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after one warm-up run; a host readback closes the window."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    float(out[0].float().sum().item())  # host readback of the last result
    return start.elapsed_time(stop) / reps


def timed_calls(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` with one call in flight: each call's
    CUDA events, closed by a host readback of its result before the next."""
    fn()[0].cpu()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        out[0].cpu()  # host readback
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def host_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs by the host clock,
    after one warm-up run: the CPU's time (on the card a launch returns
    before its kernel has run; use :func:`time_cuda` there)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _kernel_events(prof) -> list:
    """The kernels (not profiler ranges) a ``torch.profiler`` trace holds."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda and not e.is_user_annotation]


def own_by_kernel(fn, reps: int) -> dict:
    """Device time of one ``fn()`` call by kernel name, ``{name: (launches a
    call, ms a call)}``: for each kernel that ``torch.profiler`` records over
    ``reps`` calls (after a warm-up call), its launches a call and the median
    of its durations times them.  It leaves out the host's time to issue the
    launches and the gaps between them; the median keeps a launch that
    waited on the card's clock out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    durations: dict = {}
    for _ in range(3):  # a trace that came back without device events is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in _kernel_events(prof):
            durations.setdefault(e.name, []).append(e.self_device_time_total)
        if durations:
            break
    if not durations:
        raise RuntimeError("check failed: the profiler recorded no kernel")
    out = {}
    for name, d in durations.items():
        launches = max(1, round(len(d) / reps))
        out[name] = (launches, float(np.median(d)) * launches / 1e3)
    return out


def own_ms(fn, reps: int) -> float:
    """Device time of one ``fn()`` call: ``own_by_kernel``'s times, summed."""
    return sum(ms for _, ms in own_by_kernel(fn, reps).values())


def percentiles(times_ms, ps=(50, 90)) -> dict:
    """``{"p50_ms": ..., "p90_ms": ...}`` of ``times_ms`` (numpy's linear
    interpolation between ranks)."""
    return {f"p{p}_ms": float(np.percentile(times_ms, p)) for p in ps}


def idle_share(device_ms: float, wall_ms: float) -> float:
    """The share of ``wall_ms`` in which the card ran no kernel, from its
    summed kernel time ``device_ms`` (0 when the kernels overlap the whole
    window)."""
    return max(0.0, 1.0 - device_ms / wall_ms) if wall_ms > 0 else 0.0


#: the host calls that launch a kernel, in a ``torch.profiler`` trace
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def profile_calls(fn, n: int, top: int = 0) -> dict:
    """``fn()`` ``n`` times under ``torch.profiler`` (CUDA only), after the
    caller's warm-up.  Returns, a call: the profiled wall ms (host clock, to
    the last kernel's end), the card's busy time (``device_ms``: kernels,
    copies and memsets), the host's launch calls and the kernels the trace
    holds, device-to-host (``readbacks``) and host-to-device (``uploads``)
    copies, the device's ``idle_share`` against the profiled wall time (an
    upper bound: the profiler slows the host), and with ``top`` the kernels
    with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    on_card = _kernel_events(prof)
    kernels = [e for e in on_card if not e.name.startswith(("Memcpy", "Memset"))]
    device_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    out = {
        "wall_ms": wall_ms / n,
        "device_ms": device_ms / n,
        "launch_calls": sum(e.name in LAUNCH_CALLS for e in events) / n,
        "kernels": len(kernels) / n,
        "readbacks": sum(e.name.startswith("Memcpy DtoH") for e in on_card) / n,
        "uploads": sum(e.name.startswith("Memcpy HtoD") for e in on_card) / n,
        "idle_share": idle_share(device_ms, wall_ms),
    }
    if top:
        by_name: dict = {}
        for e in kernels:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.self_device_time_total, c + 1)
        out["top"] = [{"kernel": name[:90], "ms": t / 1e3 / n, "calls": c / n}
                      for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]]
    return out


#: kernel A's own kernel in a profile
A_KERNEL = re.compile(r"phase_correlate_frames_kernel")


def device_split(fn, wall_ms: float, reps: int = 2) -> dict:
    """Device time of one ``fn()`` call (a pipeline step) from one
    ``torch.profiler`` trace of ``reps`` calls: every kernel's duration
    summed, kernel A's own kernel, the geometry (every kernel launched inside
    the pipeline's ``GEOMETRY_RANGE``) and the rest (gating, casts, copies);
    launches a call; the device's idle share against ``wall_ms``, the call's
    wall time.  Kernel A's time is the median of its launches that the trace
    holds, once a call (the wrapper counts the calls' launches): in a
    process that has traced much before, a trace can hold one of two A
    launches, and A's work does not depend on the data."""
    from torch.profiler import ProfilerActivity, profile

    from mrs_optic_flow_tpu_torch.ops import cuda_kernels
    from mrs_optic_flow_tpu_torch.parallel.pipeline import GEOMETRY_RANGE

    cpu = torch.autograd.DeviceType.CPU
    a = cuda_kernels.phase_correlate_frames
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace that came back without kernel A is taken again
        a.LAUNCHES = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        kernels = _kernel_events(prof)
        a_traced = [e.self_device_time_total for e in kernels if A_KERNEL.search(e.name)]
        if a_traced:
            break
    ranges = [e for e in events if e.device_type == cpu and e.name == GEOMETRY_RANGE]
    if not (a_traced and a.LAUNCHES == reps and len(ranges) == reps):
        raise RuntimeError(
            f"check failed: the trace holds {len(a_traced)} of kernel A's {a.LAUNCHES} launches "
            f"and {len(ranges)} geometry ranges, for {reps} calls")
    others = [e for e in kernels if not A_KERNEL.search(e.name)]
    a_ms = float(np.median(a_traced)) / 1e3
    total = sum(e.self_device_time_total for e in others) / reps / 1e3 + a_ms
    geo = sum(e.device_time_total for e in ranges) / reps / 1e3
    if not 0 < geo < total:
        raise RuntimeError(f"check failed: geometry {geo} ms of {total} ms")
    return {"device_ms": total, "kernel_a_ms": a_ms, "geometry_ms": geo, "rest_ms": total - a_ms - geo,
            "launches": round(len(others) / reps) + 1, "kernel_a_in_trace": len(a_traced),
            "kernel_a_share": a_ms / total, "idle_share": idle_share(total, wall_ms)}


def _launched(e) -> int:
    """Kernels (not copies or fills) launched under a CPU event of a
    ``torch.profiler`` trace, its children's included."""
    own = sum(not k.name.startswith(("Memcpy", "Memset")) for k in e.kernels)
    return own + sum(_launched(c) for c in e.cpu_children)


def range_split(fn, n: int, names) -> dict:
    """``fn()`` ``n`` times under ``torch.profiler``, after the caller's
    warm-up: for each profiler range of ``names`` (``record_function``),
    the device ms, kernels and entries a call of the work launched inside
    it; the whole call's device ms and kernels; and ``rest``, what lies
    outside every named range (uploads, the readback, glue).  The ranges
    must not nest."""
    from torch.profiler import ProfilerActivity, profile

    cpu = torch.autograd.DeviceType.CPU
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    on_card = _kernel_events(prof)
    total = {"device_ms": sum(e.self_device_time_total for e in on_card) / 1e3 / n,
             "kernels": sum(not e.name.startswith(("Memcpy", "Memset")) for e in on_card) / n}
    out = {}
    for name in names:
        ranges = [e for e in events if e.device_type == cpu and e.name == name]
        if ranges:
            out[name] = {"device_ms": sum(e.device_time_total for e in ranges) / 1e3 / n,
                         "kernels": sum(_launched(e) for e in ranges) / n, "entries": len(ranges) / n}
    out["rest"] = {k: total[k] - sum(v[k] for v in out.values()) for k in total}
    out["total"] = total
    return out


def no_host_sync(dev):
    """A block in which any host synchronisation on the card raises
    (``torch.cuda.set_sync_debug_mode("error")``); on the CPU it does
    nothing."""

    @contextlib.contextmanager
    def block():
        if torch.device(dev).type != "cuda":
            yield
            return
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    return block()


@contextlib.contextmanager
def time_budget(seconds: Optional[float]):
    """A raising budget for a script: ``SIGALRM`` raises ``TimeoutError``
    after ``seconds`` (none for ``None`` or 0).  Yields a zero-argument
    callable, the seconds left (infinite without a budget); the alarm and
    the previous handler are restored on exit."""
    t0 = time.monotonic()
    if not seconds:
        yield lambda: math.inf
        return

    def on_alarm(signum, frame):
        raise TimeoutError(f"time budget of {seconds} s spent")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, float(seconds))
    try:
        yield lambda: seconds - (time.monotonic() - t0)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, old)


def card_name() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them (first card)."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# the JAX harness's measurements                                               #
# --------------------------------------------------------------------------- #


def _checksum(x) -> float:
    """Host readback of a result (a tensor, or the first tensor of a tuple):
    ``.item()`` of its sum, which waits for every launch before it on the
    stream."""
    while isinstance(x, (tuple, list)):
        x = x[0]
    return float(torch.as_tensor(x).float().sum().item())


def make_chained(step: Callable):
    """Wrap ``step(prev, curr) -> (result, bump_scalar)`` into
    ``chained(prev, curr) -> (next_prev, result)`` where ``next_prev``
    depends on the step's output, so each call's input is the previous
    call's result.  The bump stays small (wrap-add of 1..3) and keeps
    ``prev``'s dtype (uint8 wraps, float drifts negligibly)."""

    def chained(prev, curr):
        result, bump_scalar = step(prev, curr)
        bump = (torch.nan_to_num(torch.as_tensor(bump_scalar)) % 3.0 + 1.0).to(prev.dtype)
        return prev + bump, result

    return chained


def measure_scan_slope(build, k_pair=(25, 100), *, reps: int = 7, warmup: int = 2) -> dict:
    """Per-item time via TWO chain lengths.

    ``build(k)`` returns ``run(i)``, which issues ONE ``k``-item chain and
    reads a result back to the host (``.item()`` of a checksum: the only
    wait that covers every launch before it).  The per-item time is the
    slope ``(T[k_hi] - T[k_lo]) / (k_hi - k_lo)`` of the median wall times,
    which cancels the per-chain constants (set-up, the readback) exactly;
    dividing one chain's total by ``k`` would smear them into every item.

    The per-rep times give a jitter scale (the interquartile spread of the
    reps, worst of the two chain lengths); ``reliable`` is "the
    chain-median separation ``delta_ms`` clears 3x that jitter AND the
    slope is positive".  Eager chains on a card are wall time: the slope is
    the host's issue rate where the host, not the card, is the slower.
    """
    med, iqr = {}, {}
    for k in k_pair:
        run = build(k)
        for i in range(warmup):
            run(i)
        times = []
        for i in range(warmup, warmup + reps):
            t0 = time.perf_counter()
            run(i)
            times.append(time.perf_counter() - t0)
        times.sort()
        med[k] = times[len(times) // 2]
        iqr[k] = times[(3 * len(times)) // 4] - times[len(times) // 4]
    k_lo, k_hi = k_pair
    per = (med[k_hi] - med[k_lo]) / (k_hi - k_lo)
    delta = med[k_hi] - med[k_lo]
    jitter = max(iqr[k_lo], iqr[k_hi])
    return {
        "per_item_ms": per * 1e3,
        "overhead_ms": (med[k_lo] - per * k_lo) * 1e3,
        "k_pair": list(k_pair),
        # the chain medians the slope is drawn through: a slope whose
        # medians sit inside the jitter band shows it here
        "med_ms": {int(k): med[k] * 1e3 for k in k_pair},
        "delta_ms": delta * 1e3,
        "jitter_ms": jitter * 1e3,
        "reliable": bool(per > 0 and delta >= 3.0 * jitter),
    }


def make_latency_frames(
    n_distinct: int = 64,
    *,
    width: int = 752,
    height: int = 480,
    channels: int = 3,
    seed: int = 0,
):
    """``n_distinct`` distinct uint8 BGR camera frames (textured, shifted),
    host-side, for the latency measurements: the JAX package's frames byte
    for byte."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, size=(height, width), dtype=np.uint8)
    frames = []
    for i in range(n_distinct):
        g = np.roll(base, (3 * i) % height, axis=0)
        if channels == 3:
            g = np.stack([g, g, g], axis=-1)
        frames.append(np.ascontiguousarray(g))
    return frames


def measure_node_latency(
    n_frames: int = 1000,
    *,
    warmup: int = 64,
    n_distinct: int = 64,
    dt: float = 0.02,
    overrides=None,
    device="cuda",
) -> dict:
    """End-to-end per-frame latency of ``OpticFlowNode`` on ``device``: raw
    uint8 BGR 752x480 frame in, twist out, measured around ``on_image``
    (which ends with the node's one readback) for ``n_frames`` frames after
    ``warmup``.  Returns p50/p90/p95/p99/mean in milliseconds."""
    node = _make_latency_node(overrides, device)
    frames = make_latency_frames(n_distinct)
    times = []
    stamp = 100.0
    for i in range(warmup + n_frames):
        stamp += dt
        elapsed = _time_node_frame(node, stamp, frames[i % n_distinct])
        if i >= warmup:
            times.append(elapsed)
    arr = np.asarray(times) * 1e3
    arr.sort()
    pct = lambda p: float(arr[min(int(len(arr) * p), len(arr) - 1)])  # noqa: E731
    return {
        "n": len(arr),
        "p50_ms": pct(0.50),
        "p90_ms": pct(0.90),
        "p95_ms": pct(0.95),
        "p99_ms": pct(0.99),
        "mean_ms": float(arr.mean()),
    }


def _make_latency_node(overrides=None, device="cuda"):
    """A ready-to-measure ``OpticFlowNode`` on ``device`` (camera info and
    sensor snapshots seeded, null publish and log), from
    ``configs/default.yaml`` with ``overrides`` merged on top."""
    from mrs_optic_flow_tpu_torch.config import load_config
    from mrs_optic_flow_tpu_torch.runtime.msgs import CameraInfo, Float64Stamped, Imu, Odometry
    from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode

    cfg = load_config(overrides=overrides)
    node = OpticFlowNode(cfg, device=device, publish=lambda t, m: None, log=lambda s: None,
                         enable_profiler=False)
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    t0 = 100.0
    node.on_camera_info(CameraInfo(k=[420.0, 0, 376.0, 0, 420.0, 240.0, 0, 0, 1], d=[0.0] * 5))
    node.on_imu(Imu(stamp=t0, angular_velocity=(0.0, 0.0, 0.0), orientation=(0.0, 0.0, 0.0, 1.0)))
    node.on_odometry(Odometry(stamp=t0, orientation=(0.0, 0.0, 0.0, 1.0),
                              linear_velocity=(0.0, 0.0, 0.0)))
    node.on_height(Float64Stamped(stamp=t0, value=2.0))
    return node


def _time_node_frame(node, stamp: float, img) -> float:
    """Wall seconds of one ``on_image`` call."""
    from mrs_optic_flow_tpu_torch.runtime.msgs import ImageMsg

    t_start = time.perf_counter()
    node.on_image(ImageMsg(stamp=stamp, data=img))
    return time.perf_counter() - t_start


def measure_node_latency_ab(
    n_frames: int = 600,
    *,
    overrides_a=None,
    overrides_b=None,
    block: int = 10,
    warmup: int = 32,
    n_distinct: int = 64,
    dt: float = 0.02,
    device="cuda",
) -> dict:
    """Interleaved A/B of two node configurations within one run.

    Host-side latency drifts between and within runs (it moved up to 1.9x
    between runs of the same code on one H100), so the two configurations
    alternate every ``block`` frames against their own stamp streams; the
    per-round paired delta ``median(B round) - median(A round)`` cancels
    drift to first order, and ``sign_consistency`` (share of rounds
    agreeing with the median's sign) says whether the verdict holds inside
    the run.  Both nodes are warmed before timing.

    Returns ``delta_p50_ms`` (negative = B faster), the per-round deltas,
    the per-config p50s and ``sign_consistency``.
    """
    node_a = _make_latency_node(overrides_a, device)
    node_b = _make_latency_node(overrides_b, device)
    frames = make_latency_frames(n_distinct)
    stamps = {id(node_a): 100.0, id(node_b): 100.0}

    def run_block(node, n, i0, record=None):
        for i in range(n):
            stamps[id(node)] += dt
            el = _time_node_frame(node, stamps[id(node)], frames[(i0 + i) % n_distinct])
            if record is not None:
                record.append(el)

    run_block(node_a, warmup, 0)
    run_block(node_b, warmup, 0)
    rounds = max(n_frames // (2 * block), 1)
    deltas, all_a, all_b = [], [], []
    for r in range(rounds):
        ta, tb = [], []
        run_block(node_a, block, r * block, ta)
        run_block(node_b, block, r * block, tb)
        deltas.append((float(np.median(tb)) - float(np.median(ta))) * 1e3)
        all_a += ta
        all_b += tb
    med_delta = float(np.median(deltas))
    agree = [d for d in deltas if (d < 0) == (med_delta < 0) or d == 0]
    return {
        "delta_p50_ms": med_delta,
        "round_deltas_ms": [float(d) for d in deltas],
        "sign_consistency": len(agree) / len(deltas),
        "a_p50_ms": float(np.median(all_a)) * 1e3,
        "b_p50_ms": float(np.median(all_b)) * 1e3,
        "n_rounds": rounds,
        "block": block,
    }


def device_frame_chain(engine, *, width: int = 752, height: int = 480, scale_rotation=None,
                       generator=None):
    """The node's single-frame chain as a function of a raw frame on the
    engine's device: ``chain(state, sr_state, frame) -> (state, sr_state,
    checksum)``: grayscale -> crop -> ``FftMethod.step`` -> getRT -> detilt
    (identity mount and rates, 2 m, dt 0.02 s), and with ``scale_rotation``
    (a ``ScaleRotationEstimator``) its step on the same gray window.  The
    checksum is a 0-dim tensor on the device; nothing is read back."""
    from mrs_optic_flow_tpu_torch.geometry.motion import get_rt
    from mrs_optic_flow_tpu_torch.geometry.rotations import matrix_from_quat, quat_rotate, rpy_from_matrix
    from mrs_optic_flow_tpu_torch.ops.preprocess import center_crop, to_grayscale

    dev = engine.device
    frame_size, patch = engine.config.frame_size, engine.config.sample_point_size
    cx = width // 2
    ul_x = float(cx - frame_size // 2)
    cam = torch.tensor([[420.0, 0, float(cx)], [0, 420.0, height / 2.0], [0, 0, 1.0]],
                       dtype=torch.float32).to(dev)
    dist = torch.zeros((5,), dtype=torch.float32, device=dev)
    ident = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32).to(dev)
    alt_m = torch.full((), 2.0, dtype=torch.float32, device=dev)  # UAV height above ground
    dtv = torch.full((), 0.02, dtype=torch.float32, device=dev)

    def chain(state, sr_state, frame):
        gray = center_crop(to_grayscale(frame), frame_size, cx)
        state, flow = engine.step(state, gray)
        res = get_rt(flow.shifts, alt_m, dtv, ul_x, cam, dist, ident, ident,
                     frame_size=frame_size, patch=patch, generator=generator)
        tran_b = quat_rotate(ident, quat_rotate(ident, res.tran))
        ang = torch.stack(rpy_from_matrix(matrix_from_quat(res.rot)))
        acc = torch.nansum(tran_b) + torch.nansum(ang) + res.ok.to(torch.float32)
        if scale_rotation is not None:
            sr_state, sr = scale_rotation.step(sr_state, gray)
            acc = acc + torch.nan_to_num(sr.scale) + torch.nan_to_num(sr.rotation)
        return state, sr_state, acc

    return chain


#: frames of the device chain that :func:`measure_device_chain_latency` traces
PROFILED_FRAMES = 16


def measure_device_chain_latency(
    k: int = 100,
    *,
    reps: int = 7,
    warmup: int = 2,
    config=None,
    width: int = 752,
    height: int = 480,
    scale_rotation=None,
    max_k: int | None = None,
    budget_s=None,
    device="cuda",
) -> dict:
    """Per-frame cost of the full single-frame chain (grayscale -> crop ->
    ``FftMethod.step`` -> getRT -> detilt, :func:`device_frame_chain`), with
    ``scale_rotation``'s step on the same gray window when given.

    The port issues the chain eagerly, about 1,400 launches a frame, so the
    wall time of a chain is the host's issue rate as much as the card's
    work.  This returns both:

    - ``per_frame_ms``: device ms a frame, the kernels' durations summed
      from a ``torch.profiler`` trace of a chain of ``PROFILED_FRAMES``
      frames (at most ``k``), with ``launches_per_frame`` (kernels in that
      trace) and ``idle_share`` against the traced chain's wall time; None
      on the CPU;
    - ``wall_per_frame_ms``: the wall-time slope between a ``k/4``- and a
      ``k``-frame chain (:func:`measure_scan_slope`), each chain ending in
      one ``.item()`` of its checksum.

    ``measured`` says which were taken ("device and wall", or "wall only"
    on the CPU).  The slope keeps the JAX function's self-policing: when
    the chain medians do not clear the rep jitter (``slope_ok`` False) the
    chain length doubles, up to ``max_k``, while ``budget_s`` (seconds
    left: a zero-argument callable or a number) covers the doubled chains'
    estimated cost.  Escalation is opt-in: without ``budget_s`` or
    ``max_k`` it stays at ``k``; with a budget ``max_k`` defaults to
    ``4 k``.  The frames (``max_k`` distinct random BGR frames) are made
    on the device up front."""
    from mrs_optic_flow_tpu_torch.models import FftMethod, FftMethodConfig
    from mrs_optic_flow_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    engine = FftMethod(config or FftMethodConfig(), device=dev)
    if k < 2:
        raise ValueError(f"k must be >= 2 to fit a slope, got {k}")

    def _budget_now():
        if budget_s is None:
            return None
        return budget_s() if callable(budget_s) else float(budget_s)

    # an exhausted budget sizes the frames at k: escalation could never run
    if max_k is None:
        b_now = _budget_now()
        max_k = 4 * k if (b_now is not None and b_now > 0) else k
    max_k = max(int(max_k), k)

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    frames = torch.randint(0, 256, (max_k, height, width), generator=gen, device=dev,
                           dtype=torch.uint8)[..., None].expand(max_k, height, width, 3)
    draws = torch.Generator(device=dev)
    draws.manual_seed(0)
    chain = device_frame_chain(engine, width=width, height=height,
                               scale_rotation=scale_rotation, generator=draws)
    holder = {"state": engine.init_state(),
              "sr": None if scale_rotation is None else scale_rotation.init_state()}

    def run_chain(kk):
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(kk):
            holder["state"], holder["sr"], chk = chain(holder["state"], holder["sr"], frames[i])
            acc = acc + chk
        return acc

    def build(kk):
        def run(i):
            float(run_chain(kk).item())  # the readback: waits for the chain

        return run

    def _budget_left():
        b = _budget_now()
        return float("inf") if b is None else b

    k_cur, escalations = k, 0
    while True:
        slope = measure_scan_slope(build, (max(k_cur // 4, 1), k_cur), reps=reps, warmup=warmup)
        if slope["reliable"] or k_cur >= max_k:
            break
        # the doubled chains' cost from the medians just measured (x2 for
        # the doubling, x1.5 safety): escalate only if the budget covers it
        est_s = 3.0 * (reps + warmup) * sum(slope["med_ms"].values()) / 1e3
        if _budget_left() < est_s:
            break
        k_cur = min(2 * k_cur, max_k)
        escalations += 1
    out = {
        "k": k_cur,
        "per_frame_ms": None,
        "launches_per_frame": None,
        "idle_share": None,
        "wall_per_frame_ms": slope["per_item_ms"],
        "dispatch_overhead_ms": slope["overhead_ms"],
        "chain_medians_ms": slope["med_ms"],
        "delta_ms": slope["delta_ms"],
        "jitter_ms": slope["jitter_ms"],
        "escalations": escalations,
        # the wall slope's verdict: publish no ratio off slope_ok False
        "slope_ok": slope["reliable"],
        "measured": "wall only (no device profile on the CPU)",
    }
    if dev.type == "cuda":
        kp = min(k_cur, PROFILED_FRAMES)
        prof = profile_calls(lambda: run_chain(kp), 1)
        out.update(per_frame_ms=prof["device_ms"] / kp, launches_per_frame=prof["kernels"] / kp,
                   idle_share=prof["idle_share"], measured="device and wall")
    return out


def measure_chained_stats(
    chained,
    prev,
    curr,
    *,
    items_per_call: int,
    iters: int = 16,
    pipeline: int = 1,
    warmup: int = 3,
    progress: Callable[[float], None] | None = None,
) -> dict:
    """Steady-state items/sec of a :func:`make_chained` function, with the
    per-window spread.

    ``pipeline`` calls are kept in flight per timed window (a streaming
    consumer's shape); every window's results are read back to the host.
    The headline ``rate`` is the rate of the upper-middle window time (an
    even window count rounds to the slower of the middle pair), and
    ``window_rates`` (chronological, so drift within the run shows),
    ``rate_min`` and ``rate_max`` publish the spread.

    ``progress``, when given, is called once with the first timed window's
    rate as soon as it lands.
    """
    p, s = chained(prev, curr)
    _checksum(s)
    for _ in range(warmup):
        p, s = chained(p, curr)
        _checksum(s)
    times = []
    for _ in range(max(iters // pipeline, 1)):
        pending = []
        t0 = time.perf_counter()
        for _ in range(pipeline):
            p, s = chained(p, curr)
            pending.append(s)
        for s in pending:
            _checksum(s)
        times.append(time.perf_counter() - t0)
        if progress is not None and len(times) == 1:
            progress(items_per_call * pipeline / times[0])
    rate = items_per_call * pipeline / sorted(times)[len(times) // 2]
    rates = [items_per_call * pipeline / t for t in times]
    return {
        "rate": rate,
        "rate_min": min(rates),
        "rate_max": max(rates),
        "window_rates": rates,
        "n_windows": len(rates),
    }


def measure_chained(chained, prev, curr, **kw) -> float:
    """The ``rate`` of :func:`measure_chained_stats`."""
    return measure_chained_stats(chained, prev, curr, **kw)["rate"]
