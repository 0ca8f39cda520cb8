#!/usr/bin/env python3
"""Verify the node's scale/rotation path on one CUDA card.

    python3 scripts/verify_sr_fused_torch.py [--frames 8] [--k 32] [--device cuda|cpu]

1. Functional: an ``OpticFlowNode`` with ``scale_rotation: true`` (480 px
   crop of 752x480 BGR frames, log-polar 480, Lanczos-4) on frames of a
   texture turning at 0.4 rad/s about the image centre, then on hovering
   frames (no motion): every decode after the first within
   ``tests/test_logpolar.py:408-444``'s bounds, 1 deg of rotation a frame
   and 0.03 of scale.
2. Performance (the card only): the single-frame chain's device time and
   launches a frame, with and without the scale/rotation leg
   (``benchlib.measure_device_chain_latency``: device ms a frame from the
   profiler, the wall slope beside it); the same chain issued under
   ``benchlib.no_host_sync`` (any host synchronisation raises); and the
   node's copies a frame under ``torch.profiler``: exactly one
   device-to-host copy (its one readback) a frame is required, the uploads
   are counted.  The port issues the chain eagerly, about 1,480 launches a
   scale/rotation frame: it reports them and claims no single dispatch.

Prints one JSON line a part; exits 1 if a check fails.  With ``--device
cpu`` it runs part 1 and the chain's wall slope on the CPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

YAW_RATE = 0.4  # rad/s
ROT_TOL_DEG, SCALE_TOL = 1.0, 0.03  # tests/test_logpolar.py:408-444


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=8, help="frames a sequence")
    ap.add_argument("--k", type=int, default=32, help="frames of the longer chain")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def decodes(dev, frames, config) -> list:
    """The node's ``scale_rotation_out`` messages over ``frames`` (gray),
    BGR, level, at chip_smoke's height, dt and camera."""
    import chip_smoke as cs

    published = []
    node = cs.level_node(dev, config, published)
    node.log = lambda s: None
    cs.feed_node(node, [np.repeat(g[..., None], 3, axis=-1) for g in frames])
    return [m for t, m in published if t == "scale_rotation_out"]


def functional(dev, n: int) -> dict:
    import chip_smoke as cs

    from mrs_optic_flow_tpu_torch.config import NodeConfig

    step_deg = float(np.rad2deg(YAW_RATE * cs.DT))
    out = {"metric": "sr_node_decodes", "frames": n, "yaw_rate_truth": YAW_RATE,
           "rot_tol_deg": ROT_TOL_DEG, "scale_tol": SCALE_TOL}
    ok = True
    for name, deg in (("rotating", step_deg), ("hovering", 0.0)):
        frames = cs.render_affine(n, deg, 1.0, shape=(480, 752), center=(376.0, 240.0))
        msgs = decodes(dev, frames, NodeConfig(scale_rotation=True))
        sr = msgs[1:]  # the first decode is the first frame's (1, 0)
        rot_err = np.abs(np.rad2deg(np.array([m["yaw_rate"] for m in sr]) * cs.DT) - deg)
        scale_err = np.abs(np.array([m["scale"] for m in sr]) - 1.0)
        good = len(msgs) == n - 1 and bool(np.all(rot_err <= ROT_TOL_DEG) and np.all(scale_err <= SCALE_TOL))
        out[name] = {"decodes": len(msgs), "max_rot_err_deg": float(rot_err.max()),
                     "max_scale_err": float(scale_err.max()), "ok": good}
        ok &= good
    out["ok"] = ok
    return out


def performance(dev, args) -> dict:
    import torch

    import chip_smoke as cs

    from mrs_optic_flow_tpu_torch.config import NodeConfig
    from mrs_optic_flow_tpu_torch.models import (
        FftMethod,
        FftMethodConfig,
        ScaleRotationConfig,
        ScaleRotationEstimator,
    )
    from mrs_optic_flow_tpu_torch.runtime.msgs import ImageMsg
    from mrs_optic_flow_tpu_torch.utils import benchlib

    est = ScaleRotationEstimator(ScaleRotationConfig(), device=dev)
    out = {"metric": "sr_chain", "without_sr": benchlib.measure_device_chain_latency(
        args.k, reps=args.reps, device=dev)}
    out["with_sr"] = benchlib.measure_device_chain_latency(args.k, reps=args.reps, scale_rotation=est,
                                                           device=dev)
    if dev.type != "cuda":
        out["ok"] = True
        return out
    keys = ("per_frame_ms", "launches_per_frame")
    out["sr_leg"] = {k: out["with_sr"][k] - out["without_sr"][k] for k in keys}

    # the chain from a raw frame on the card to its checksum, warmed, then
    # issued with host synchronisation made an error
    engine = FftMethod(FftMethodConfig(), device=dev)
    chain = benchlib.device_frame_chain(engine, scale_rotation=est,
                                        generator=torch.Generator(device=dev))
    frames = torch.randint(0, 256, (4, 480, 752, 3), dtype=torch.uint8, device=dev)
    state, sr_state, acc = engine.init_state(), est.init_state(), []
    state, sr_state, _ = chain(state, sr_state, frames[0])
    with benchlib.no_host_sync(dev):
        for f in frames[1:]:
            state, sr_state, chk = chain(state, sr_state, f)
            acc.append(chk)
    out["chain_without_host_sync"] = bool(np.isfinite(float(torch.stack(acc).sum())))

    # the node's copies a frame: one readback, and its uploads
    node = cs.level_node(dev, NodeConfig(scale_rotation=True), [])
    node.log = lambda s: None
    gray = cs.render_affine(2, 1.0, 1.0, shape=(480, 752), center=(376.0, 240.0))
    bgr = [np.repeat(g[..., None], 3, axis=-1) for g in gray]
    cs.feed_node(node, bgr)  # the first frame primes, the second runs the chain
    stamp = iter(100.0 + cs.DT * (2 + np.arange(args.reps)))
    prof = benchlib.profile_calls(lambda: node.on_image(ImageMsg(stamp=next(stamp), data=bgr[1])),
                                  args.reps)
    out["node"] = {k: prof[k] for k in ("readbacks", "uploads", "kernels", "device_ms", "wall_ms")}
    out["ok"] = out["chain_without_host_sync"] and prof["readbacks"] == 1
    return out


def run(args, emit) -> bool:
    from mrs_optic_flow_tpu_torch.utils import benchlib
    from mrs_optic_flow_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    card = {"card": benchlib.card_name() if dev.type == "cuda" else "cpu"}
    ok = True
    for part in (functional(dev, args.frames), performance(dev, args)):
        emit({**card, **part})
        ok &= part["ok"]
    return ok


def main(argv=None) -> int:
    args = parse_args(argv)
    return 0 if run(args, lambda row: print(json.dumps(row), flush=True)) else 1


if __name__ == "__main__":
    sys.exit(main())
