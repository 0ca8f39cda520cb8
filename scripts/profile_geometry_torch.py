#!/usr/bin/env python3
"""Profile the batched geometry on one CUDA card, with its bound.

    SWEEP=64,256,512 BATCH=4096 python3 scripts/profile_geometry_torch.py [--reps 5]
        [--budget-s 900] [--device cuda|cpu]

Runs ``geometry/batched.py::get_rt_batch`` (the serving pipeline's getRT:
undistort -> RANSAC homography -> Malis-Vargas decomposition -> the
IMU-nearest solution; on the card the Gumbel draw and kernel G) on
``BATCH`` pairs of 16 window shifts each (uniform in +-3 px, made on the
card) at each RANSAC iteration count of ``SWEEP``, and prints one JSON line
a count:

- ``wall_ms``: a call's time by CUDA events, one call in flight, each read
  back (``benchlib.timed_calls``);
- ``device_ms``, ``kernels``, ``launch_calls`` and ``idle_share`` a call
  from ``torch.profiler`` (``benchlib.profile_calls``);
- ``bound_ms`` and ``bound_by``: the least time of the work reckoned from
  the code (:func:`geometry_work`) over 67 TFLOP/s and 3.35 TB/s, and
  ``bound_materialized_ms``, the same with the ``[iterations, P, B]``
  residuals and ``[iterations, 9, B]`` hypotheses written and read once, as
  the plain version materialises them (kernel G keeps them on chip).

Each line carries the card's ``nvidia-smi`` name and power limit.  With
``--device cpu`` it times the calls by the host clock; device numbers null.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

WINDOWS = 16  # 4x4 windows of 120 px in a 480 px frame


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--budget-s", type=float, default=900.0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


#: operations a (hypothesis, point, pair) of the RANSAC stage, from
#: ``geometry/batched.py``: the reprojection (``_project_err2_b``: 8
#: multiply-adds and 2 divisions for u and v, the guard, 5 for the squared
#: error), the inlier test and count (3), and the four rounds of masked
#: argmax that draw the sample (``gumbel_top4``: 5)
OPS_PER_RESIDUAL = 31
#: operations a (hypothesis, pair): the exact 4-point homography
#: (``_h4_b``: two sides of 3 determinants and 6 products, the adjugate's 9
#: minors, the 9 three-term rows, the max-abs normalisation)
OPS_PER_HYPOTHESIS = 160
#: operations a pair outside the hypotheses: the refit's QR over the 2P x 9
#: system (about 2 m n^2 with m = 2P, n = 9) and the decomposition
OPS_PER_PAIR_REFIT = 2 * (2 * WINDOWS) * 81 + 2_000


def geometry_work(iterations: int, p: int, b: int) -> dict:
    """Operations and bytes of ``get_rt_batch`` on ``b`` pairs of ``p``
    window shifts at ``iterations`` RANSAC hypotheses.  ``bytes``: the
    inputs read once (the ``[I, P, B]`` float32 Gumbel draws, the ``[B, P,
    2]`` shifts, heights, dts and rate quaternions) and the outputs written
    once (tran, rot, ok, n_inliers and the rest, about 48 B a pair).
    ``bytes_materialized`` adds the ``[I, P, B]`` residuals and the ``[I, 9,
    B]`` hypotheses, each written and read once."""
    ops = (iterations * p * b * OPS_PER_RESIDUAL + iterations * b * OPS_PER_HYPOTHESIS
           + b * OPS_PER_PAIR_REFIT)
    nbytes = 4 * iterations * p * b + 8 * p * b + 4 * b * (1 + 1 + 4) + 48 * b
    materialized = nbytes + 2 * 4 * iterations * p * b + 2 * 4 * 9 * iterations * b
    return {"ops": ops, "bytes": nbytes, "bytes_materialized": materialized}


def run(args, emit, sweep=None, batch=None) -> bool:
    import torch

    from mrs_optic_flow_tpu_torch.geometry.batched import get_rt_batch
    from mrs_optic_flow_tpu_torch.utils import benchlib
    from mrs_optic_flow_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    batch = batch or int(os.environ.get("BATCH", "4096"))
    sweep = sweep or [int(v) for v in os.environ.get("SWEEP", "64,256,512").split(",")]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    shifts = (torch.rand((batch, WINDOWS, 2), generator=gen, device=dev) * 6.0 - 3.0)
    cam = torch.tensor([[420.0, 0, 376.0], [0, 420.0, 240.0], [0, 0, 1.0]]).to(dev)
    heights = torch.full((batch,), 2.0, device=dev)
    dts = torch.full((batch,), 0.02, device=dev)
    c2b = torch.tensor([0.0, 0.0, 0.0, 1.0]).to(dev)
    rates = c2b[None].expand(batch, 4).contiguous()
    base = {"metric": "get_rt_batch", "batch": batch, "windows": WINDOWS,
            "card": benchlib.card_name() if cuda else "cpu"}
    for iters in sweep:
        draws = torch.Generator(device=dev)
        draws.manual_seed(0)

        def call(iters=iters, draws=draws):
            rt = get_rt_batch(shifts, heights, dts, 376.0 - 240.0, cam, None, c2b, rates,
                              frame_size=480, patch=120, ransac_iterations=iters, generator=draws)
            return rt.tran, rt.ok

        work = geometry_work(iters, WINDOWS, batch)
        bound_ms, by = benchlib.bound_of(work["ops"], work["bytes"])
        row = {**base, "ransac_iterations": iters, **work, "bound_ms": bound_ms, "bound_by": by,
               "bound_materialized_ms": benchlib.bound_of(work["ops"], work["bytes_materialized"])[0]}
        ok_share = float(call()[1].float().mean())
        if cuda:
            row["wall_ms"] = benchlib.timed_calls(call, args.reps)
            prof = benchlib.profile_calls(call, args.reps)
            row.update(device_ms=prof["device_ms"], kernels=prof["kernels"],
                       launch_calls=prof["launch_calls"], idle_share=prof["idle_share"],
                       bound_share=bound_ms / prof["device_ms"])
        else:
            row.update(wall_ms=benchlib.host_ms(call, args.reps), device_ms=None, kernels=None,
                       launch_calls=None, idle_share=None, bound_share=None)
        row["ok_share"] = ok_share
        row["us_per_pair"] = row["wall_ms"] * 1e3 / batch
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
            emit({"metric": "get_rt_batch", "timed_out": str(e)})
            return 3


if __name__ == "__main__":
    sys.exit(main())
