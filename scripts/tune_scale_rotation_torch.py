#!/usr/bin/env python3
"""Measure the scale/rotation estimator on one CUDA card.

    python3 scripts/tune_scale_rotation_torch.py [--configs lanczos4_480,bilinear_480,lanczos4_lp256]
        [--streams 1,2,4,8,16] [--k 32] [--budget-s 900] [--device cuda|cpu]

At the reference geometry (480² frames, ``optimM`` 49.9,
``src/scaleRotationEstimator.cpp:5,28``), on uint8 frames of a random
texture rolled 3 px a frame:

1. ``ScaleRotationEstimator.step`` a frame (the node's scale/rotation leg)
   under ``lanczos4`` (the reference's interpolator) and ``bilinear``, and
   at ``lp_resolution`` 256: the wall time a frame (the slope of
   ``benchlib.measure_scan_slope`` between a ``k/4``- and a ``k``-frame
   chain, each read back once), the device time and kernels a frame
   (``benchlib.profile_calls``) and kernel B's own time a frame
   (``benchlib.own_by_kernel``, its ``peak_split_kernel``);
2. ``step_batch_carried`` at each stream count of ``--streams`` (the fleet's
   carried log-polar images): device time a call and a stream, against
   ``step``'s device time a frame (``per_stream_vs_step``), the wall time a
   call by CUDA events, and kernel B's own time a call.

The port accepts ``lp_rows_per_chunk`` and ``lp_batch_chunk`` so that the
JAX estimator's arguments construct it, and reads neither (they schedule
the TPU's resample); every line says so, and nothing sweeps them.  Each
line carries the card's ``nvidia-smi`` name and power limit.  With
``--device cpu`` it runs on the CPU: wall times only, device numbers null.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

#: tag -> ScaleRotationConfig fields
CONFIGS = {
    "lanczos4_480": {"interp": "lanczos4"},
    "bilinear_480": {"interp": "bilinear"},
    "lanczos4_lp256": {"interp": "lanczos4", "lp_resolution": 256},
}
IGNORED = ("lp_rows_per_chunk and lp_batch_chunk are accepted and not read by the port "
           "(they schedule the TPU's resample); not swept")
#: kernel B's kernel in a profile
B_KERNEL = re.compile(r"peak_split_kernel")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--streams", default="1,2,4,8,16")
    ap.add_argument("--k", type=int, default=32, help="frames of the longer chain")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--size", type=int, default=480, help="frame side")
    ap.add_argument("--budget-s", type=float, default=900.0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def sr_frames(dev, k: int, n: int):
    """``[k, n, n]`` uint8: a random texture rolled 3 px a frame."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    base = torch.randint(0, 255, (n, n), generator=gen, device=dev, dtype=torch.uint8)
    return torch.stack([torch.roll(base, 3 * i, dims=0) for i in range(k)])


def kernel_b_ms(fn, reps: int) -> float:
    """Kernel B's own device time a ``fn()`` call."""
    from mrs_optic_flow_tpu_torch.utils import benchlib

    return sum(ms for name, (_, ms) in benchlib.own_by_kernel(fn, reps).items() if B_KERNEL.search(name))


def step_row(est, frames, reps: int, dev) -> dict:
    import torch

    from mrs_optic_flow_tpu_torch.utils import benchlib

    holder = {"state": est.init_state()}

    def steps(n):
        acc = torch.zeros((), device=dev)
        for f in frames[:n]:
            holder["state"], res = est.step(holder["state"], f)
            acc = acc + res.scale + res.rotation
        return acc

    k = len(frames)
    slope = benchlib.measure_scan_slope(lambda kk: lambda i: float(steps(kk).item()),
                                        (max(k // 4, 1), k), reps=reps, warmup=1)
    out = {"wall_ms_per_frame": slope["per_item_ms"], "slope_ok": slope["reliable"],
           "device_ms_per_frame": None, "kernels_per_frame": None, "kernel_b_own_ms": None}
    if dev.type == "cuda":
        prof = benchlib.profile_calls(lambda: steps(k), 1)
        out.update(device_ms_per_frame=prof["device_ms"] / k, kernels_per_frame=prof["kernels"] / k,
                   kernel_b_own_ms=kernel_b_ms(lambda: est.step(holder["state"], frames[0]), 20))
    return out


def batch_row(est, frames, b: int, reps: int, dev) -> dict:
    from mrs_optic_flow_tpu_torch.utils import benchlib

    curr = frames[:b].contiguous()
    holder = {"lp": est.logpolar_batch(frames[1:b + 1].contiguous())}

    def call():
        holder["lp"], res = est.step_batch_carried(holder["lp"], curr)
        return res.scale, res.rotation

    out = {"streams": b}
    if dev.type == "cuda":
        out["wall_ms"] = benchlib.timed_calls(call, reps)
        prof = benchlib.profile_calls(call, reps)
        out.update(device_ms=prof["device_ms"], device_ms_per_stream=prof["device_ms"] / b,
                   kernels=prof["kernels"], idle_share=prof["idle_share"],
                   kernel_b_own_ms=kernel_b_ms(call, reps))
    else:
        out.update(wall_ms=benchlib.host_ms(call, reps), device_ms=None,
                   device_ms_per_stream=None, kernels=None, idle_share=None, kernel_b_own_ms=None)
    return out


def run(args, emit) -> bool:
    from mrs_optic_flow_tpu_torch.models import ScaleRotationConfig, ScaleRotationEstimator
    from mrs_optic_flow_tpu_torch.utils import benchlib
    from mrs_optic_flow_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    streams = [int(s) for s in args.streams.split(",")]
    frames = sr_frames(dev, max(args.k, max(streams) + 1), args.size)
    base = {"card": benchlib.card_name() if dev.type == "cuda" else "cpu", "resolution": args.size,
            "magnitude": 49.9, "ignored": IGNORED}
    for tag in args.configs.split(","):
        est = ScaleRotationEstimator(ScaleRotationConfig(resolution=args.size, **CONFIGS[tag]), device=dev)
        row = {**base, "metric": f"scale_rotation_{tag}_ms_per_frame", "config": CONFIGS[tag],
               "lp_resolution": est.config.lp_res,
               "step": step_row(est, frames[:args.k], args.reps, dev)}
        per_frame = row["step"]["device_ms_per_frame"]
        row["batch_carried"] = []
        for b in streams:
            br = batch_row(est, frames, b, args.reps, dev)
            br["per_stream_vs_step"] = br["device_ms_per_stream"] / per_frame if per_frame else None
            row["batch_carried"].append(br)
        emit(row)
    return True


def main(argv=None) -> int:
    from mrs_optic_flow_tpu_torch.utils import benchlib

    args = parse_args(argv)

    def emit(row):
        print(json.dumps(row), flush=True)

    with benchlib.time_budget(args.budget_s):
        try:
            return 0 if run(args, emit) else 1
        except TimeoutError as e:
            emit({"metric": "scale_rotation", "timed_out": str(e)})
            return 3


if __name__ == "__main__":
    sys.exit(main())
