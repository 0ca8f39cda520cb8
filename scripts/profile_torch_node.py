#!/usr/bin/env python3
"""Per-frame profile of the PyTorch port's node on one CUDA card, mode by mode.

    python3 scripts/profile_torch_node.py [--modes method4,lr_only_120,...] [--frames 20]

For each mode it builds an ``OpticFlowNode`` on the card, warms it up, feeds
10 frames, then times ``--frames`` more (host wall time of each
``on_image``, which ends with the node's one readback), feeds the 10 again
and profiles ``--frames`` frames under ``torch.profiler``.  It prints, per
mode, the unprofiled p50 / p90 in ms, then from the profile: wall and device
ms per frame, kernel launch calls and kernel events per frame, the device's
idle share (1 - device time / profiled wall time; the profiler slows the
host, so this is an upper bound) and the kernels with the most device time.
The frames are ``chip_smoke.py``'s renders (a texture moving at 0.8, -0.5
m/s; rotating and zooming for the scale/rotation modes).  Needs the CUDA
toolkit to build the kernels; imports no JAX.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

WARM = 10
#: mode -> (NodeConfig fields, scene, height per frame or None for 2 m)
MODES = {
    "method4": ({}, "translate", None),
    "method4_sr": ({"scale_rotation": True}, "affine", None),
    "method3": ({"method": 3}, "translate", None),
    "method5": ({"method": 5}, "translate", None),
    "lr_only_120": ({"long_range_mode": "always_on"}, "translate", 0.8),
    "lr_only_60": ({"long_range_mode": "always_on", "sample_point_size": 60}, "translate", 0.8),
    "sr_only_60": ({"sample_point_size": 60}, "translate", None),
    "switching_120_sr": ({"long_range_mode": "height_based", "takeoff_height": 1.0,
                          "scale_rotation": True}, "switching", None),
    "switching_60": ({"long_range_mode": "height_based", "takeoff_height": 1.0,
                      "sample_point_size": 60}, "switching", None),
}


def frames_for(scene: str, n: int, height):
    import chip_smoke as cs

    if scene == "affine":
        gray = cs.render_affine(n, cs.SR_STEP_DEG, cs.SR_STEP_ZOOM, shape=(480, 752),
                                center=(376.0, 240.0))
        return [np.repeat(g[..., None], 3, axis=-1) for g in gray], [cs.HEIGHT] * n
    if scene == "switching":
        # the measured frames cross takeoff_height both ways, as chip_smoke's phase 12
        heights = [cs.LR_HEIGHTS[0]] * (n - len(cs.LR_HEIGHTS)) + cs.LR_HEIGHTS
    else:
        heights = [cs.HEIGHT if height is None else height] * n
    return cs.render_frames(n, heights=heights), heights


def profile_mode(name: str, n_frames: int, dev) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from mrs_optic_flow_tpu_torch.config import NodeConfig
    from mrs_optic_flow_tpu_torch.runtime.msgs import (
        CameraInfo, Float64Stamped, ImageMsg, Imu, Odometry,
    )
    from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode

    fields, scene, height = MODES[name]
    frames, heights = frames_for(scene, WARM + n_frames, height)
    node = OpticFlowNode(NodeConfig(**fields), device=dev, publish=lambda t, m: None,
                         log=lambda s: None)
    node.on_camera_info(CameraInfo(k=[cs.FX, 0, 376.0, 0, cs.FY, 240.0, 0, 0, 1], d=[0.0] * 5))
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    node.warmup()

    def feed(i):
        t = 100.0 + i * cs.DT
        node.on_imu(Imu(stamp=t, angular_velocity=(0.0, 0.0, 0.0), orientation=(0.0, 0.0, 0.0, 1.0)))
        node.on_odometry(Odometry(stamp=t, orientation=(0.0, 0.0, 0.0, 1.0),
                                  linear_velocity=(cs.V_TRUE[0], cs.V_TRUE[1], 0.0)))
        node.on_height(Float64Stamped(stamp=t, value=heights[i]))
        node.on_image(ImageMsg(stamp=t, data=frames[i]))

    measured = range(WARM, WARM + n_frames)
    for i in range(WARM):
        feed(i)
    torch.cuda.synchronize()
    lat = []
    for i in measured:
        t0 = time.perf_counter()
        feed(i)
        lat.append((time.perf_counter() - t0) * 1e3)
    print(f"== {name} {fields}: unprofiled wall p50 {np.percentile(lat, 50):.3f} ms, "
          f"p90 {np.percentile(lat, 90):.3f} ms over {n_frames} frames", flush=True)

    for i in range(WARM):
        feed(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in measured:
            feed(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launch_calls = sum(e.count for e in events
                       if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    print(f"   profiled wall {wall / n_frames * 1e3:.3f} ms/frame, device "
          f"{dev_us / n_frames / 1e3:.3f} ms/frame, launch calls {launch_calls / n_frames:.0f}/frame, "
          f"kernel events {sum(e.count for e in kernels) / n_frames:.0f}/frame, "
          f"idle {1 - dev_us / 1e6 / wall:.3f}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"   {e.self_device_time_total / n_frames / 1e3:8.4f} ms/frame  "
              f"x{e.count / n_frames:6.1f}  {e.key[:90]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default=",".join(MODES), help=f"comma-separated, of {list(MODES)}")
    ap.add_argument("--frames", type=int, default=20)
    args = ap.parse_args()
    modes = args.modes.split(",")
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        ap.error(f"unknown modes {unknown}")

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_node.py needs a CUDA device")
    from mrs_optic_flow_tpu_torch.ops import cuda_kernels

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cuda_kernels.build()
    dev = torch.device("cuda")
    for name in modes:
        profile_mode(name, args.frames, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
