#!/usr/bin/env python3
"""Per-frame profile of the PyTorch port's node on one CUDA card, mode by mode.

    python3 scripts/profile_torch_node.py [--modes method4,lr_only_120,...] [--frames 20]

For each mode it builds an ``OpticFlowNode`` on the card, warms it up, feeds
10 frames, then times ``--frames`` more (host wall time of each
``on_image``, which ends with the node's one readback), feeds the 10 again
and profiles ``--frames`` frames under ``torch.profiler``.  It prints, per
mode, the unprofiled p50 / p90 in ms, then from the profile
(``mrs_optic_flow_tpu_torch/utils/benchlib.py::profile_calls``): wall and
device ms per frame (kernels and copies), kernel launch calls, kernels and
device-to-host copies per frame, the device's idle share (1 - device time /
profiled wall time; the profiler slows the host, so this is an upper bound)
and the kernels with the most device time; the hand kernels' launches a
frame (their wrappers' counts over the unprofiled frames); and a JSON line
of these.
The frames are ``chip_smoke.py``'s renders (a texture moving at 0.8, -0.5
m/s; rotating and zooming for the scale/rotation modes).  Needs the CUDA
toolkit to build the kernels; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
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
    # the options that change the device chain, each alone; a scale_factor
    # divides frame_size and sample_point_size as the YAML loader does
    "method3_ransac": ({"method": 3, "filter_method": "ransac"}, "translate", None),
    "method5_average": ({"method": 5, "filter_method": "average"}, "translate", None),
    "method5_ransac": ({"method": 5, "filter_method": "ransac"}, "translate", None),
    "scale_0.8": ({"scale_factor": 0.8, "frame_size": 600, "sample_point_size": 150},
                  "translate", None),
    "scale_1.5": ({"scale_factor": 1.5, "frame_size": 320, "sample_point_size": 80},
                  "translate", None),
    "raw_off": ({"raw_output": False}, "translate", None),
    "fft_sr": ({"backend": "fft", "scale_rotation": True}, "affine", None),
    "plain": ({"use_pallas": False, "use_pallas_explicit": True}, "translate", None),
    "float_frames": ({"quantize_8bit": False}, "translate", None),
    "sr_bilinear": ({"scale_rotation": True, "scale_rot_interp": "bilinear"}, "affine", None),
    "lr_ratio_2": ({"long_range_mode": "always_on", "long_range_ratio": 2}, "translate", 0.8),
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

    import chip_smoke as cs
    from mrs_optic_flow_tpu_torch.config import NodeConfig
    from mrs_optic_flow_tpu_torch.ops import cuda_kernels
    from mrs_optic_flow_tpu_torch.runtime.msgs import (
        CameraInfo, Float64Stamped, ImageMsg, Imu, Odometry,
    )
    from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode
    from mrs_optic_flow_tpu_torch.utils.benchlib import percentiles, profile_calls

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
    wrappers = [getattr(cuda_kernels, k) for k in cuda_kernels.SOURCES]
    for fn in wrappers:
        fn.LAUNCHES = 0
    lat = []
    for i in measured:
        t0 = time.perf_counter()
        feed(i)
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = {fn.__name__: fn.LAUNCHES / n_frames for fn in wrappers if fn.LAUNCHES}
    pct = percentiles(lat)
    print(f"== {name} {fields}: unprofiled wall p50 {pct['p50_ms']:.3f} ms, "
          f"p90 {pct['p90_ms']:.3f} ms over {n_frames} frames; kernel launches a frame {launches}",
          flush=True)

    for i in range(WARM):
        feed(i)
    frames_left = iter(measured)
    prof = profile_calls(lambda: feed(next(frames_left)), n_frames, top=8)
    print(f"   profiled wall {prof['wall_ms']:.3f} ms/frame, device "
          f"{prof['device_ms']:.3f} ms/frame, launch calls {prof['launch_calls']:.0f}/frame, "
          f"kernel events {prof['kernels']:.0f}/frame, readbacks {prof['readbacks']:.0f}/frame, "
          f"idle {prof['idle_share']:.3f}", flush=True)
    for k in prof["top"]:
        print(f"   {k['ms']:8.4f} ms/frame  x{k['calls']:6.1f}  {k['kernel']}", flush=True)
    row = {"mode": name, "p50_ms": pct["p50_ms"], "p90_ms": pct["p90_ms"],
           "device_ms": prof["device_ms"], "kernels": prof["kernels"],
           "idle_share": prof["idle_share"], "launches_per_frame": launches}
    print("   " + json.dumps(row), flush=True)


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

    from mrs_optic_flow_tpu_torch.utils.benchlib import card_name

    print(card_name(), flush=True)
    cuda_kernels.build()
    dev = torch.device("cuda")
    for name in modes:
        profile_mode(name, args.frames, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
