#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each printing a line when it finishes:

1. device: the ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compiles the hand-written kernel from ``mrs_optic_flow_tpu_torch/
   csrc/`` into ``build/torch_kernels/``;
3. kernel A against its plain twin and the NumPy oracle (``tests/oracle.py``)
   on the shared accuracy pairs (480 px frames, 120 px patches, uint8), plus
   the edge cases: zero frames, identical frames, a NaN pixel, float32
   input, batches 1 and 3;
4. throughput of ``FftMethod.step_batch`` at the bench point (4,096 uint8
   480² pairs, 4x4 patches of 120 px) against the twin on the same batch
   (about 60 GB of intermediates), and both at the node's batch of 1;
5. the node: ``OpticFlowNode(NodeConfig(), device="cuda")`` on 20 BGR
   752x480 frames of a texture moving at a known velocity; every published
   twist after the first is held to 0.15 m/s of the truth, and every frame
   is shown to have gone through the kernel.

Before the last line it prints one JSON object describing each kernel of
the path; the last line is ``{"ok": true, "device": {...}}``.  Any failure
raises, so the script exits non-zero and prints no result.  Without a CUDA
device, or without the repository beside it, it fails.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
KERNEL_SOURCE = "mrs_optic_flow_tpu_torch/csrc/phase_correlate_frames.cu"
KERNEL_REPLACES = "mrs_optic_flow_tpu/ops/pallas_kernels.py:270"

SHIFT_TOL = 0.01  # px, kernel against twin and oracle (hard budget 0.1, BASELINE.md)
MAXVAL_RTOL = 1e-4  # float32 sums in another order than the twin's
V_TRUE = (0.8, -0.5)  # m/s
TWIST_TOL = 0.15  # m/s, the budget of tests/test_node.py
FX = FY = 420.0
HEIGHT = 2.0
DT = 0.05
N_FRAMES = 20
BENCH_BATCH = 4096


def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after one warm-up run; a host readback closes the window."""
    import torch

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


def check_kernel(dev, n_pairs: int = 64) -> float:
    """Phase 3.  Returns the largest shift difference between kernel and twin."""
    import torch

    from oracle import make_accuracy_pairs

    from mrs_optic_flow_tpu_torch.ops.cuda_kernels import (
        phase_correlate_frames as kernel,
        phase_correlate_frames_ref as twin,
    )

    prev_np, curr_np, _, oracle = make_accuracy_pairs(np.random.default_rng(0), n_pairs)
    prev, curr = torch.from_numpy(prev_np).to(dev), torch.from_numpy(curr_np).to(dev)
    ks, km = (x.cpu().numpy() for x in kernel(curr, prev, patch=120))
    ts, tm = (x.cpu().numpy() for x in twin(curr, prev, patch=120))
    err_twin = float(np.abs(ks - ts).max())
    err_oracle = float(np.abs(ks - oracle).max())
    err_maxval = float(np.abs(km - tm).max() / np.abs(tm).max())
    say(f"  {n_pairs} pairs: max|shift - twin| {err_twin:.3g} px, max|shift - oracle| "
        f"{err_oracle:.3g} px (twin vs oracle {float(np.abs(ts - oracle).max()):.3g} px), "
        f"max|maxval - twin| / max {err_maxval:.3g}")
    check(err_twin <= SHIFT_TOL, f"kernel vs twin {err_twin} px")
    check(err_oracle <= SHIFT_TOL, f"kernel vs oracle {err_oracle} px")
    check(err_maxval <= MAXVAL_RTOL, f"maxval vs twin {err_maxval}")

    zero = torch.zeros((2, 480, 480), dtype=torch.uint8, device=dev)
    zs, zm = (x.cpu().numpy() for x in kernel(zero, zero, patch=120))
    check(np.all(zs == -60.0) and np.all(zm == 0.0), f"zero frames give {zs[0, 0]}, {zm[0, 0]}")
    ids = kernel(curr[:4], curr[:4], patch=120)[0].cpu().numpy()
    check(np.abs(ids).max() <= 1e-3, f"identical frames give {np.abs(ids).max()} px")
    nan_c = curr[:1].float().clone()
    nan_c[0, 2 * 120 + 7, 1 * 120 + 9] = float("nan")  # patch i=1, j=2: field 9
    ns, nm = (x.cpu().numpy()[0] for x in kernel(nan_c, prev[:1].float(), patch=120))
    check(np.isnan(ns[9]).all() and np.isnan(nm[9]), f"NaN patch gives {ns[9]}, {nm[9]}")
    check(np.isfinite(np.delete(ns, 9, axis=0)).all(), "NaN leaked into other patches")
    fs = kernel(curr[:3].float(), prev[:3].float(), patch=120)[0].cpu().numpy()
    check(np.abs(fs - ts[:3]).max() <= SHIFT_TOL, "float32 input disagrees with the twin")
    for b in (1, 3):
        bs = kernel(curr[:b].contiguous(), prev[:b].contiguous(), patch=120)[0].cpu().numpy()
        check(np.array_equal(bs, ks[:b]), f"batch {b} differs from the same pairs in batch {n_pairs}")
    say("[3 kernel] matches twin and oracle; zero, identical, NaN, float32, B=1 and B=3 cases hold")
    return err_twin


def measure_throughput(dev) -> tuple:
    """Phase 4.  Returns (kernel ms, twin ms) at the node's batch of 1."""
    from oracle import make_accuracy_pairs

    import torch

    from mrs_optic_flow_tpu_torch.models import FftMethod, FftMethodConfig
    from mrs_optic_flow_tpu_torch.ops.cuda_kernels import (
        phase_correlate_frames as kernel,
        phase_correlate_frames_ref as twin,
    )

    prev_np, curr_np, _, _ = make_accuracy_pairs(np.random.default_rng(1), 64)
    reps = BENCH_BATCH // 64
    prev = torch.from_numpy(prev_np).to(dev).repeat(reps, 1, 1)
    curr = torch.from_numpy(curr_np).to(dev).repeat(reps, 1, 1)
    engine = FftMethod(FftMethodConfig(), device=dev)
    ms_batch = time_cuda(lambda: engine.step_batch(prev, curr), 5)
    torch.cuda.reset_peak_memory_stats()
    ms_twin_batch = time_cuda(lambda: twin(curr, prev, patch=120), 3)
    twin_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    say(f"  step_batch B={BENCH_BATCH}: {ms_batch:.3f} ms = "
        f"{BENCH_BATCH / ms_batch * 1e3:.1f} frame-pairs/s (kernel)")
    say(f"  twin B={BENCH_BATCH}: {ms_twin_batch:.3f} ms = "
        f"{BENCH_BATCH / ms_twin_batch * 1e3:.1f} frame-pairs/s, peak {twin_gb:.1f} GB allocated")
    ms_one = time_cuda(lambda: kernel(curr[:1], prev[:1], patch=120), 200)
    ms_twin_one = time_cuda(lambda: twin(curr[:1], prev[:1], patch=120), 50)
    say(f"  B=1: kernel {ms_one:.4f} ms, twin {ms_twin_one:.4f} ms")
    say("[4 throughput] done")
    return ms_one, ms_twin_one


def render_frames(n_frames: int, seed: int = 0) -> list:
    """BGR uint8 752x480 frames of a nadir camera over a band-limited periodic
    texture, one texture pixel per image pixel, moving at ``V_TRUE``: pixel
    flow per frame ``d = -f * v * dt / h`` (``runtime/stream.py:75-81``),
    rendered as an exact Fourier shift."""
    from oracle import fourier_shift, smooth_random_image

    tex = smooth_random_image(np.random.default_rng(seed), 1024, cutoff=0.25)
    d = (-FX * V_TRUE[0] * DT / HEIGHT, -FY * V_TRUE[1] * DT / HEIGHT)
    frames = []
    for i in range(n_frames):
        gray = fourier_shift(tex, d[0] * i, d[1] * i)[:480, :752]
        g8 = np.clip(np.rint(gray), 0, 255).astype(np.uint8)
        frames.append(np.repeat(g8[..., None], 3, axis=-1))
    return frames


def run_node(dev) -> int:
    """Phase 5.  Returns the kernel launches of the node's run."""
    from mrs_optic_flow_tpu_torch.config import NodeConfig
    from mrs_optic_flow_tpu_torch.ops.cuda_kernels import phase_correlate_frames as kernel
    from mrs_optic_flow_tpu_torch.runtime.msgs import (
        CameraInfo, Float64Stamped, ImageMsg, Imu, Odometry,
    )
    from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode

    published = []
    node = OpticFlowNode(
        NodeConfig(), device=dev, publish=lambda t, m: published.append((t, m)), log=say,
    )
    node.on_camera_info(CameraInfo(k=[FX, 0, 376.0, 0, FY, 240.0, 0, 0, 1], d=[0.0] * 5))
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    frames = render_frames(N_FRAMES)
    say(f"  warmup {node.warmup():.2f} s")

    kernel.LAUNCHES = 0
    for i, frame in enumerate(frames):
        t = 100.0 + i * DT
        node.on_imu(Imu(stamp=t, angular_velocity=(0.0, 0.0, 0.0),
                        orientation=(0.0, 0.0, 0.0, 1.0)))
        node.on_odometry(Odometry(stamp=t, orientation=(0.0, 0.0, 0.0, 1.0),
                                  linear_velocity=(V_TRUE[0], V_TRUE[1], 0.0)))
        node.on_height(Float64Stamped(stamp=t, value=HEIGHT))
        node.on_image(ImageMsg(stamp=t, data=frame))
    launches = kernel.LAUNCHES

    twists = [m for t, m in published if t == "velocity_out"]
    # raw frame to published twist; the first frame only primes the node
    lat_ms = np.array([m for t, m in published if t == "processing_latency_out"][1:]) * 1e3
    health = node.health
    # the first published twist is the first-frame copy (zero shift), as in
    # tests/test_node.py
    v = np.array([tw.linear[:2] for tw in twists[1:]])
    err = np.abs(v - np.array(V_TRUE)).max(axis=0)
    say(f"  {len(twists)} twists, mean v {v.mean(axis=0).round(4).tolist()} m/s, "
        f"max |v - truth| {err.round(4).tolist()} m/s; health {health}; launches {launches}")
    host = node.profiler.stats()["frame_program"]
    say(f"  per-frame latency p50 {np.percentile(lat_ms, 50):.3f} ms, "
        f"p90 {np.percentile(lat_ms, 90):.3f} ms over {len(lat_ms)} frames; "
        f"host time to issue the frame chain p50 {host['p50_s'] * 1e3:.3f} ms")
    check(len(twists) == N_FRAMES - 1, f"{len(twists)} twists for {N_FRAMES} frames")
    check(np.isfinite(v).all() and np.all(err <= TWIST_TOL), f"twist error {err} m/s")
    check(health["consecutive_failures"] == 0, health)
    check(health["frames_processed"] == len(twists), health)
    say("[5 node] twists within budget")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device")
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    from mrs_optic_flow_tpu_torch.ops import cuda_kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(smi)
    check(torch.get_float32_matmul_precision() == "highest", "float32 matmul precision")
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are enabled")
    say(f"[1 device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    log = cuda_kernels.build()
    cuda_kernels.load_library()
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")
    say(f"[2 build] {time.perf_counter() - t0:.1f} s")

    dev = torch.device("cuda")
    err_twin = check_kernel(dev)
    ms_one, ms_twin_one = measure_throughput(dev)
    launches = run_node(dev)
    check(launches >= N_FRAMES - 1, f"{launches} kernel launches for {N_FRAMES - 1} processed frames")

    say(json.dumps({"kernels": [{
        "name": "phase_correlate_frames",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": err_twin,
        "ms": ms_one,
        "plain_ms": ms_twin_one,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
