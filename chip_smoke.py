#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --baseline NAME=PATH [--baseline NAME=PATH ...]

``--baseline`` builds kernel NAME (``phase_correlate_frames``,
``peak_refine_raw``, ``sad_search``, ``phase_correlate_fullfused`` or
``phase_correlate_fused``) from another source, PATH, and times it in turns
with the kernel from ``csrc/`` in the phase that times that kernel (4, 6, 7,
10, 11 and 13); PATH may have the current C interface or, for B to E, the
one before their redesign.  The card gets no ``.git/``: write an earlier
source into ``build/`` first, e.g. ``git show
a7250c7:mrs_optic_flow_tpu_torch/csrc/sad_search.cu >
build/baseline/sad_search.cu``, with the headers it includes beside it
(kernel B's ``peak_refine_raw.cu``; kernel D's design before its FFT,
``32e2fe5:.../phase_correlate_fullfused.cu``; kernel E's before its FFT,
``9508452:.../phase_correlate_fused.cu``).

Phases, each printing a line when it finishes:

1. device: the ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compiles the hand-written kernels A to E from
   ``mrs_optic_flow_tpu_torch/csrc/`` into ``build/torch_kernels/``, one
   ``nvcc`` per source, all started together, and checks the engines' route
   constant (kernel A's largest patch), kernel A's blocks an SM (two at
   n = 120), kernel C's launch geometry (``sad_geometry``: shared memory,
   scratch, counters) against its library and the device's limits,
   kernels B's and C's fill targets against the SM count, and kernels D's
   and E's FFT plan, route, shared memory and scratch for n = 1 to 480
   against ``cuda_kernels`` (``fft_plan``, ``pcff_small``,
   ``pcff_smem_bytes``, ``pcfu_smem_bytes``, ``pcfu_scratch_bytes``);
3. kernel A against its plain twin and the NumPy oracle (``tests/oracle.py``)
   on the shared accuracy pairs (480 px frames, 120 px patches, uint8), plus
   the edge cases: zero frames, identical frames, a NaN pixel, float32
   input, batches 1 and 3; then at every patch it takes (multiples of 8 up
   to ``PCF_MAX_PATCH``, q x q windows, q >= 2), one-sided zero pairs (a
   surface of ties) and windows with a strong shift beyond the search
   radius and a weak one within it;
4. kernel A at B = 1 and at the bench point (4,096 uint8 480² pairs, 4x4
   patches of 120 px) beside the stock ``torch.fft`` route on the same
   inputs, its bound and the share of it (of its own device time too at
   the bench point), the twin, and the throughput of
   ``FftMethod.step_batch`` at the bench point;
5. the node: ``OpticFlowNode(NodeConfig(), device="cuda")`` on 20 BGR
   752x480 frames of a texture moving at a known velocity; every published
   twist after the first is held to 0.15 m/s of the truth, and every frame
   is shown to have gone through the kernel;
6. kernel B against its twin: log-polar surfaces at N = 480 (P = 1 and 4),
   FftMethod ``backend="fft"`` surfaces ``[64, 120, 120]``, and ties, NaN
   inside and outside the search window, an edge peak, an all-negative and
   a zero surface; then P = 1, 4 and 64 with ties and NaN in different row
   bands of the split, r >= n/2 and r < n/2, odd n; timed at [1, 480, 480],
   [4, 480, 480] and [64, 120, 120] through the wrapper and by its own
   device time, beside the twin and ``torch.max`` over the same surfaces;
7. kernel C against its twin: bit-identical maps on integer-valued inputs
   and identical repeated runs at (S, R) = (120, 21), (120, 0) and (8, 3),
   G = 1, 9 and 16; 1e-6 relative on float inputs; timed at the default
   geometry (9 cells, S = 120, R = 21) and at G = 1 beside the twin, the
   bound and ``torch.cdist(p=1)`` over the regions' unfold (also in phase
   13);
8. the node with ``scale_rotation: true`` at full width (frame 480,
   log-polar 480, Lanczos-4) on 20 frames rotated and zoomed about the
   image centre by known steps: every decode after the first within 1 deg
   and 0.03 of the truth, kernel and twin decodes within 1e-4, every frame
   through kernel B;
9. the node with methods 3 and 5 (480 / 120 / R 21 / step 24) on phase 5's
   texture: every twist after the first within 0.10 m/s of the truth, every
   frame through kernel C;
10. kernel D against its twin and the NumPy oracle at every n of
    ``D_SIZES`` (45 to 480: its one-block design up to 170, its staged
    design from 171; 97 a prime, 171 = 9 x 19); uint8 and float32
    bit-identical, P = 1 equal to the same pair in the batch; zero patches,
    a NaN pixel and one-sided zero pairs (exactly -(n//2)) at n = 45, 60,
    97, 170, 171 and 480, a shift beyond the search radius at n = 480;
    ``FftMethod`` at 480 px with patch 160 through kernel A, 240 and 100
    (one 480 px window) and 600 / 150 (``scale_factor`` 0.8) through kernel
    D, against the engine on the CPU; timed at each shape of ``D_TIMED``
    ([64, 60, 60] uint8 the node's) beside the twin, the ``torch.fft`` route
    (through its calls and by its own device time) and the bound, and in
    turns with the design before when ``--baseline`` names it;
11. kernel E against its twin and the oracle at n = 120, 45, 97, 170, 171,
    240 and 480 (its one-block design up to 170, its three staged launches
    from 171; 16 pairs of 480 px in two chunks, P = 1 within SHIFT_TOL of
    the same pair in the batch), uint8 and float32 bit-identical (repair
    F8); the staged design at odd counts of odd patches (171 px at P = 1,
    3 and 100 in chunks of 95 and 5, 175 px at P = 3); zero, NaN
    and one-sided zero pairs at n = 120, 171 and 480, a shift beyond the
    search radius at n = 480; then ``conformance.check`` of the five
    backends on ``[16, 120, 120]`` (all 10 pairs within 0.05 px); timed at
    each shape of ``E_TIMED`` through the wrapper and by its own device
    time, split by kernel name into E's own launches and the forward
    products, with its launches a call, beside the twin, the ``torch.fft``
    route (through its calls and by its own device time) and the bound, and
    in turns with the design before when ``--baseline`` names it;
12. long-range nodes: ``long_range_mode: height_based`` with
    ``takeoff_height`` 1.0 m on 20 frames whose heights cross 1.0 m both
    ways, the render's pixel shift following each frame's height; (a) at
    480 / 120 (kernel A in both modes) with ``scale_rotation: true`` (one
    kernel B launch and one decode a frame in both modes, each the
    estimator's own on the node's gray window), (b) with ``sample_point_size`` 60 (kernel D in both modes:
    64 windows, and 2x2 long-range windows of 60); long-range twists within
    0.25 m/s of the truth, short-range ones within 0.15 m/s, every frame
    through the named kernel;
13. kernel C at S = 160 and 240 (R = 21), the blocks of repair F3:
    bit-identical to its twin on integer inputs and on a repeated run;
    timed;
14. repair F6: TF32 matrix products switched on for the whole process; the
    scale/rotation decodes of 6 frames, the method-4 node's twists on 8,
    kernel D's twin and kernel E at n = 480 within TF32_TOL of the same run
    with TF32 off (each pinned contraction runs in full float32), how far
    an unpinned 480² DFT product moves printed; the setting restored;
15. serving at ``configs/default.yaml``'s geometry (480² crop, 4x4 x 120
    px, fx = fy = 420, 256 RANSAC hypotheses): (a) ``BatchPipeline.step_pre``
    on 4,096 uint8 480² pairs of phase 5's texture at 8 known velocities,
    issued with host synchronisation made an error
    (``torch.cuda.set_sync_debug_mode("error")``), at least 95% of the pairs
    ok and every ok twist within 0.15 m/s; on 64 of them ``get_rt_batch``
    against the per-pair ``get_rt`` on the same hypotheses (the Gumbel
    draws' top 4): ``ok`` and ``n_inliers`` equal, ``tran`` within
    ``TRAN_PARITY``; (b) frame-pairs/s of ``step_pre`` at B = 4096 with one
    call in flight and of ``ServingLoop(batch_size=512)`` over 4,096
    requests at depths 1 and 8 (one dispatch under the no-sync block), each
    with its device time split into kernel A, the geometry and the rest (or
    the copies), launches and the device's idle share; (c) ``FleetServer``
    with 128 streams of BGR 752x480 frames for 10 ticks (a masked stream
    whose next dt spans two ticks, a reset, a checkpoint round trip that
    repeats the uninterrupted tick, every valid twist within 0.15 m/s, tick
    p50/p90), a long-range fleet with tilt-corrected heights within 0.25
    m/s, and 16 streams with the scale/rotation estimator fused into the
    pipeline and beside it (decodes within 1 deg and 0.03, fused = unfused
    within 1e-4); (d) ``FleetFeeder`` over the fleet, frames pushed from a
    second thread past full rings of 2 (dropped and skipped counted), the
    next tick's twists within budget.  Every part counts kernel A's (and in
    the scale/rotation fleet kernel B's) launches: one a call or tick;
16. flights (``tests/test_flightsim.py`` on the port): the port's
    ``FlightSimulator`` renders each profile once at full width (752x480,
    fx 420) and ``OpticFlowNode`` flies it on ``configs/default.yaml``
    through the port's ``load_config`` (480 crop, 4x4 windows of 120 px),
    warmed up, at the test's budgets: (a) the level flight under
    ``height_based`` and ``takeoff_based`` (``takeoff_height`` 1.2; both
    topic families, 2 and 1 switches, RMSE, coverage, NEES); (b) the banked
    flight under each ``ang_rate_source``, the ``tilt_correction`` A/B with
    its deadband and a 90 deg camera mount; (c) a low banked flight in long
    range at mount yaw 0 and pi/2; (d) ``scale_rotation`` (log-polar 240) on
    the level descent (vz and yaw rate) and the banked tilt gate with its
    threshold sweep; (e) the level flight recorded to ``.ofrec`` and
    replayed (stamps and frames bit-exact), flown again as BGR uint8 frames
    with ``tpu.host_preprocess`` (``native.gray_crop`` on every frame after
    the first, twists equal to (a)'s within 1e-6 m/s) and with
    ``store_video`` to ``.ofrec`` and ``.avi`` (read back, the same overlays);
    (f) ``test_fleet_flight_closed_loop``'s three streams through one
    ``FleetServer`` with scale/rotation fused; (h) (a)'s renders written by
    ``record_bag`` and ``record_bag2`` and replayed through ``replay_bag``
    and ``replay_bag2`` under ``height_based`` (every frame replayed, 2
    switches, RMSE, coverage, no NaN twist, the two formats' twists within
    1e-6 m/s); (i) the banked flight through both formats
    (``test_flight_banked_bag_roundtrips``' budgets); (j) the banked scene
    variants (lens distortion, principal point 420, 230) at the nominal
    banked budgets; (l) ``RosBridge`` and ``Ros2Bridge`` on fakes of
    ``rospy`` and ``rclpy`` defined here, fed (h)'s ROS1 bag as ROS1 or
    ROS2 messages (``tests/torch_ros_standin/ros_standin.py::
    ros_messages``): twists equal to (h)'s replay within 1e-6 m/s, every
    message of its builder's type, each image callback timed;
    (g) and (k) ``python -m mrs_optic_flow_tpu_torch`` as eight
    subprocesses started together: ``--flight banked`` exits 0 with the
    report as its last line, ``--flight level --flight-rmse-budget 0.001``
    exits 1, ``--synthetic`` with ``tpu.host_preprocess=true`` and
    ``--replay`` of (e)'s file exit 0, ``--bag-info`` of both bags lists
    every topic with its count and ``--replay`` of both prints a twist line
    for each twist it counts.  Every flight sets the counts to 0 just
    before its frames: kernel A once a frame after the first, kernel B too
    with scale/rotation (none without), both once a fleet tick after the
    first; each prints its RMSE, the node's p50 and p90 latency and its
    render and node wall times, a bag flight also the bag's write and read
    seconds;
17. the rest of the public surface at ``configs/default.yaml``'s geometry
    (480² crop, 4x4 x 120 px, fx = fy = 420, 256 hypotheses): (a)
    ``OpticFlowCalc`` over ``FftMethod`` on phase 5's 20 frames (gray,
    cropped): ``process_image`` equal to ``FftMethod.step`` exactly,
    ``raw_output`` filled, kernel A once a call; ``process_image_long_range``
    likewise (A at 120 px); over ``FftMethod`` at patch 60 (kernel D) and
    ``BlockMethod`` (kernel C) within ``SHIFT_TOL`` of the engine's step;
    (b) ``sharded_flow_step`` at the bench point on ``make_mesh()`` (one
    card) and on ``make_mesh(4, device="cuda:0")``: shifts within 1e-5 px of
    ``step_batch``, NaN for NaN, kernel A once a shard, frame-pairs/s beside
    ``step_batch``'s (printed, not claimed); ``BatchPipeline`` over the 4
    shards: ``step_pre`` on 1,024 pairs of phase 15's texture under
    sync-as-error and ``step_long_range``, each against the unsharded
    pipeline with the same generator (``ok`` and, shard by shard,
    ``n_inliers`` equal, shifts within 1e-5 px, twists within 5e-3 m/s) and
    the truth; (c) over the 4 shards against unsharded: ``FleetServer`` of
    128 BGR 752x480 streams for 5 ticks (twists within 5e-3 m/s, A once a
    shard a tick), 16 streams with scale/rotation fused (A and B once a
    shard a tick, decodes within 1e-4), ``ServingLoop(batch_size=512,
    depth=2)`` over 1,024 requests; (d) ``estimate_tran_rot_vvel`` and the
    allsac helpers on the card equal to the CPU (1e-6 relative) on
    ``tests/test_filters.py``'s cases and on the 3x3 grid of window shifts
    of phase 5's first pair; (e) the method-4 node with a ``Profiler``
    logging events and tracing on 5 frames: kernel A's CUDA kernel and one
    ``frame_program`` range a frame program in the exported trace, one log
    line a routine call.  It prints one line;
18. the measurement and tuning layer (``mrs_optic_flow_tpu_torch/utils/
    benchlib.py`` and the ``scripts/*_torch.py`` built on it) at short
    settings, in a process of its own (a long process's profiler traces
    drop device events): (a) ``measure_node_latency`` on the default node
    (10 frames);
    (b) ``tune_frames_kernel_torch``: kernel A built with ``PCF_THREADS``
    128, 256 (the default, bit for bit equal to the shipped kernel) and 512
    (the builds started in phase 2), each within SHIFT_TOL of its twin and
    the oracle, timed at B = 1 and 4096; (c) ``tune_sad_kernel_torch``:
    ``BlockMethod.step`` with kernel C and with the plain search, and C
    built with the default tile (bit for bit the shipped kernel) and one
    other, both exact against the twin; (d) ``tune_scale_rotation_torch``
    at 4 streams; (e) ``profile_geometry_torch`` at 64 and 256 RANSAC
    iterations, B = 4096, with its bound; (f) ``accuracy_report_torch`` on 8
    pairs, A, D and E within SHIFT_TOL of the oracle; (g)
    ``verify_sr_fused_torch``: the scale/rotation decodes, the chain's
    device time with and without it, the chain issued with host
    synchronisation made an error and one readback a node frame; (h) the
    method-3 and method-5 nodes: one device-to-host copy a frame (repair
    F13).  Every JSON line the scripts print is checked for its keys and
    for finite numbers; it prints one line;
19. right after phase 16, in its recording directory: the node executable,
    ``scripts/optic_flow_tpu_torch_node``, as roslaunch (a) and ros2
    launch (b) start it (``__name:=``/``__log:=``; ``--ros2 ... --ros-args
    -r __node:= -r __ns:= --``), with no ``--device`` (the card), over
    (h)'s level-flight ROS1 bag (a) and rosbag2 (b), under the stand-in
    ROS of ``tests/torch_ros_standin/`` (jax, yaml and cv2 blocked), both
    children started together, each with its own time limit: each exits 0,
    publishes (l)'s twists of its flavour within 1e-6 m/s stamp for stamp,
    launches kernel A at least once a processed frame and holds
    ``check_bag_flight``'s budgets; the children find the kernel libraries
    built and leave them as they are.  A line each prints the twists, the
    largest difference, A's launches, the image callback's p50 and p90
    beside (l)'s in-process ones and the cold start (process start to the
    first image callback);
20. the node's frame graphs, right after phase 12: for every mode of
    ``scripts/profile_torch_node.py`` (method 4, with scale/rotation,
    methods 3 and 5, long range through kernels A and D, 480/60 through D,
    the two ``height_based`` modes that switch both ways, and each option
    that changes the device chain: methods 3 and 5 with ``ransac``, method
    5 with ``average``, ``scale_factor`` 0.8 (D at [16, 150, 150]) and 1.5
    (A at 16 windows of 80), ``raw_output: false``, ``backend: fft`` with
    scale/rotation (cuFFT and B only), ``use_pallas: false`` (no hand
    kernel), ``quantize_8bit: false`` (A on float32 frames),
    ``scale_rot_interp: bilinear`` and ``long_range_ratio: 2``), a node on
    its CUDA graphs and one on the eager chain they replace, both warmed
    up (warm-up captures every graph; no library, table or merge-counter
    buffer is made while capturing), fed the same ``GRAPH_FRAMES`` steady
    frames in turns: the engine's raw window shifts (from the flow each
    chain returns) and the published ones equal to 0 px, twists and
    decodes within ``GRAPH_TWIST_TOL``, the generators' states equal, the
    wrappers' launch counts equal and each kernel of ``GRAPH_KERNELS[mode]``
    launched at least once a frame and no other, one graph replay and one
    host synchronisation a frame (counted as the bench counts them); then
    a capture made to raise: its frame fails, the next one tries to capture
    again and fails too, and once the capture succeeds the node publishes.

Each node phase sets every kernel's launch count to 0 just before it drives
the node and reads the counts just after.  Before the last line it prints
a ``serving`` JSON object (phase 15's throughputs, tick times, the
geometry's device time at B = 4096 and kernel A's share, with the card's
``nvidia-smi`` name and power limit), a ``flights`` object (phase 16's
rows, the card, its wall time, phase 19's rows under ``live_nodes``), then
one JSON object describing each
kernel: its launches in its node phase and over phase 16's flights
(``flight_launches``) and over phase 17's paths (``slice_launches``, none
for E, which lies on none of them)
(kernel C: methods 3 and 5 together; kernel D: phase 12(b); kernel E: the
conformance check of phase 11), its largest difference from its twin, its
time through the wrapper (``ms``, CUDA events over back-to-back calls), its
own device time (``own_ms``, ``torch.profiler``'s kernel durations), the
twin's and the stock PyTorch route's (``library_ms``: the ``torch.fft``
chain for A, D and E; ``torch.cdist`` for C; null for B, which no PyTorch
call computes; ``library_own_ms`` its own device time) at the node's shape,
and its bound there (``bound_ms``: the
larger of its operations over 67 TFLOP/s and its bytes, each read or
written once, over 3.35 TB/s; ``bound_by`` names which).  The last line is
``{"ok": true, "device": {...}}``.  Any failure raises, so the script exits
non-zero and prints no result.  Without a CUDA device, or without the
repository beside it, it fails.
"""

from __future__ import annotations

import functools
import json
import math
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

from mrs_optic_flow_tpu_torch.ops.cuda_kernels import ptxas_lines
from mrs_optic_flow_tpu_torch.utils.benchlib import (  # noqa: F401  (WORK, pc_flops: the tests read them here)
    A_KERNEL,
    WORK,
    bound,
    card_name,
    device_split,
    no_host_sync,
    own_by_kernel,
    own_ms,
    pc_flops,
    time_cuda,
    timed_calls,
)

REPO = pathlib.Path(__file__).resolve().parent
#: the stand-in ROS packages phase 19's children run on
STANDIN = REPO / "tests" / "torch_ros_standin"
#: kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "phase_correlate_frames": ("mrs_optic_flow_tpu_torch/csrc/phase_correlate_frames.cu",
                               "mrs_optic_flow_tpu/ops/pallas_kernels.py:270"),
    "peak_refine_raw": ("mrs_optic_flow_tpu_torch/csrc/peak_refine_raw.cu",
                        "mrs_optic_flow_tpu/ops/pallas_kernels.py:142"),
    "sad_search": ("mrs_optic_flow_tpu_torch/csrc/sad_search.cu",
                   "mrs_optic_flow_tpu/ops/block_matching.py:66"),
    "phase_correlate_fullfused": ("mrs_optic_flow_tpu_torch/csrc/phase_correlate_fullfused.cu",
                                  "mrs_optic_flow_tpu/ops/pallas_kernels.py:849"),
    "phase_correlate_fused": ("mrs_optic_flow_tpu_torch/csrc/phase_correlate_fused.cu",
                              "mrs_optic_flow_tpu/ops/pallas_kernels.py:916"),
}

SHIFT_TOL = 0.01  # px, kernel against twin and oracle (hard budget 0.1, BASELINE.md)
MAXVAL_RTOL = 1e-4  # float32 sums in another order than the twin's
V_TRUE = (0.8, -0.5)  # m/s
TWIST_TOL = 0.15  # m/s, the budget of tests/test_node.py
FX = FY = 420.0
HEIGHT = 2.0
DT = 0.05
N_FRAMES = 20
BENCH_BATCH = 4096
SR_STEP_DEG, SR_STEP_ZOOM = 2.0, 1.02  # per frame, phase 8
SR_ROT_TOL, SR_SCALE_TOL = 1.0, 0.03  # deg and scale, tests/test_logpolar.py:408-444
SR_TWIN_TOL = 1e-4  # kernel and twin decodes
BM_TWIST_TOL = 0.10  # m/s: about 1 px of flow per frame at fx 420, h 2 m, dt 0.05 s
LR_TWIST_TOL = 0.25  # m/s, the long-range budget of tests/test_node.py
#: phase 12's heights: short range above 1.0 m, long range below, both ways
LR_HEIGHTS = [1.5] * 6 + [0.8] * 7 + [1.4] * 7
CONFORMANCE_TOL = 0.05  # px, ops/conformance.py
def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


#: ``--baseline NAME=PATH``: kernel name -> the library built from PATH
BASELINES: dict = {}


def build_baselines(specs: list) -> None:
    """Build each ``NAME=PATH`` source into ``build/torch_kernels/`` (all at
    once) and bind its C interface: the current one, or the one the kernel
    had before its redesign (kernel B's ``prr_peak_refine_raw``, kernel C's
    ``sad_sad_search``, kernel D's ``pcff_phase_correlate_fullfused``
    without the peak split, a library without ``pcff_route``; kernel E's
    ``pcfu_phase_correlate_fused`` of four spectra, a library without
    ``pcfu_stack``)."""
    import ctypes

    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck

    jobs = {}
    for spec in specs:
        name, _, path = spec.partition("=")
        check(name in KERNELS and path, f"--baseline {spec}: expected NAME=PATH, NAME one of {list(KERNELS)}")
        out = ck.BUILD_DIR / f"lib{name}_baseline.so"
        jobs[name] = (out, subprocess.Popen([ck._nvcc(), *ck.NVCC_FLAGS, "-o", str(out), path],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    _P, _I = ctypes.c_void_p, ctypes.c_int
    before = {
        "prr_peak_refine_raw": (_I, [_P, _I, _I, _I, _I, _P, _P, _P, _P]),
        "sad_sad_search": (_I, [_P, _P, _I, _I, _I, _I, _P, _P]),
    }
    before_new = {  # kernel -> (the function the redesign added, the old signatures)
        "phase_correlate_fullfused": ("pcff_route", {
            "pcff_phase_correlate_fullfused": (_I, [_P, _P] + [_I] * 6 + [_P] * 5)}),
        "phase_correlate_fused": ("pcfu_stack", {
            "pcfu_phase_correlate_fused": (_I, [_P] * 4 + [_I] * 5 + [_P] * 5)}),
    }
    for name, (out, proc) in jobs.items():
        log = proc.communicate()[0]
        check(proc.returncode == 0, f"baseline {name}: nvcc failed\n{log}")
        for line in ptxas_lines(log):
            say(f"  ptxas baseline {name}: {line}")
        lib = ctypes.CDLL(str(out))
        added, old = before_new.get(name, ("", {}))
        old = old if added and not hasattr(lib, added) else {}
        for fn, (restype, argtypes) in {**ck._SIGNATURES[name], **before, **old}.items():
            if hasattr(lib, fn):
                getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
        BASELINES[name] = lib


def in_turns(label: str, runners: dict, reps: int) -> dict:
    """Own times (``own_ms``) of ``runners`` {"baseline": fn, "kernel": fn}
    in turns on one card: baseline, kernel, kernel, baseline.  Returns each
    one's mean."""
    order = ["baseline", "kernel", "kernel", "baseline"]
    times = {name: [] for name in runners}
    for name in order:
        times[name].append(own_ms(runners[name], reps))
    say(f"  {label}, own time in turns {order}: " + "; ".join(
        f"{name} {' / '.join(f'{t:.4f}' for t in ts)} ms" for name, ts in times.items()))
    return {name: float(np.mean(ts)) for name, ts in times.items()}


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
    errs = [err_twin, check_kernel_cases(dev, curr[:1], prev[:1])]
    say("[3 kernel] matches twin and oracle at every patch; zero, one-sided zero (ties), identical, "
        "NaN, float32, masked, B=1 and B=3 cases hold")
    return max(errs)


def check_kernel_cases(dev, curr, prev) -> float:
    """Phase 3, continued: kernel A against its twin and the oracle at every
    patch it takes (multiples of 8 up to ``PCF_MAX_PATCH``, frames of q x q
    windows, q >= 2); one-sided zero pairs at n = 120 (a surface of exact
    zeros: every entry a tie, the minimum shifted index wins); and windows
    holding a strong shift beyond the search radius and a weak one within
    it.  Returns the largest shift difference from the twin."""
    import torch

    from oracle import make_accuracy_pairs

    from mrs_optic_flow_tpu_torch.ops.cuda_kernels import (
        PCF_MAX_PATCH,
        phase_correlate_frames as kernel,
        phase_correlate_frames_ref as twin,
    )

    def on(x):
        return torch.from_numpy(x).to(dev)

    errs = []
    for n in range(8, PCF_MAX_PATCH + 1, 8):
        q = max(2, 240 // n)
        prev_np, curr_np, _, oracle = make_accuracy_pairs(
            np.random.default_rng(n), 1, size=q * n, patch=n, max_shift=min(25.0, n / 6))
        errs.append(compare_pc(kernel, twin, on(curr_np), on(prev_np), f"A n={n} q={q}", oracle, patch=n))

    zero = torch.zeros_like(curr)
    for c, p, label in ((zero, prev, "curr zero"), (curr, zero, "prev zero")):
        ks, km = (x.cpu().numpy() for x in kernel(c, p, patch=120))
        ts, tm = (x.cpu().numpy() for x in twin(c, p, patch=120))
        check(np.all(ks == -60.0) and np.all(km == 0.0), f"{label}: ties give {ks[0, 0]}, {km[0, 0]}")
        check(np.array_equal(ks, ts) and np.array_equal(km, tm), f"{label}: kernel and twin differ")

    # 2x2 windows of 120 px, each the strong (58, 0) / weak (10, 3) pair
    tiles = [masked_pair(120, seed=20 + i, strong=(58.0, 0.0)) for i in range(4)]
    mc, mp = (on(np.block([[t[k][0] for t in tiles[:2]], [t[k][0] for t in tiles[2:]]])[None])
              for k in (0, 1))
    for radius, want in ((55, (10.0, 3.0)), (60, (58.0, 0.0))):
        errs.append(compare_pc(kernel, twin, mc, mp, f"A masked, radius {radius}", patch=120,
                               search_radius=radius))
        got = kernel(mc, mp, patch=120, search_radius=radius)[0].cpu().numpy()[0]
        say(f"  A two-shift windows, radius {radius}: {got.round(3).tolist()}")
        check(np.abs(got - np.array(want)).max() < 0.5, f"radius {radius}: peaks {got}")
    return max(errs)


def measure_throughput(dev) -> tuple:
    """Phase 4.  Kernel A at the node's batch of 1 and at the bench point
    (B = 4096) beside its twin, the stock ``torch.fft`` route on the same
    inputs (``phase_correlate_field(..., backend="fft")``: rfft2 twice, the
    cross-power, irfft2, then the plain shift, mask and peak; a chain of
    calls, not one) and the bound, and ``step_batch`` throughput.  Returns
    (kernel ms through the wrapper, own ms, twin ms, library ms, library own
    ms) at B = 1."""
    from oracle import make_accuracy_pairs

    import torch

    from mrs_optic_flow_tpu_torch.models import FftMethod, FftMethodConfig
    from mrs_optic_flow_tpu_torch.ops.cuda_kernels import (
        phase_correlate_frames as kernel,
        phase_correlate_frames_ref as twin,
    )
    from mrs_optic_flow_tpu_torch.ops.phase_correlate import (
        correlation_surface_raw,
        phase_correlate_field,
    )
    from mrs_optic_flow_tpu_torch.ops.preprocess import patchify

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

    def library(c, p):
        return phase_correlate_field(patchify(c, 120), patchify(p, 120), backend="fft")

    def fft_chain(c, p):
        return (correlation_surface_raw(patchify(c, 120), patchify(p, 120), backend="fft"),)

    out = {}
    for b, reps_k, reps_l in ((1, 200, 50), (BENCH_BATCH, 5, 3)):
        c, p = curr[:b].contiguous(), prev[:b].contiguous()
        ms = time_cuda(lambda: kernel(c, p, patch=120), reps_k)
        torch.cuda.reset_peak_memory_stats()
        lib_ms = time_cuda(lambda: library(c, p), reps_l)
        chain_ms = time_cuda(lambda: fft_chain(c, p), reps_l)
        lib_gb = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
        bound_ms, by = bound("phase_correlate_frames", b=b, n=120, q=4, itemsize=1)
        say(f"  kernel A B={b}: {ms:.4f} ms ({b * 16 / ms * 1e3:.0f} windows/s); torch.fft route "
            f"{lib_ms:.4f} ms (surfaces alone {chain_ms:.4f} ms, peak {lib_gb:.1f} GB allocated); "
            f"bound {bound_ms:.5f} ms ({by}), kernel at {bound_ms / ms:.2%} of it")
        if b == BENCH_BATCH:
            own = own_ms(lambda: kernel(c, p, patch=120), reps_k)
            say(f"  kernel A B={b}: own {own:.4f} ms, at {bound_ms / own:.2%} of the bound")
        out[b] = (ms, lib_ms)
    ms_twin_one = time_cuda(lambda: twin(curr[:1], prev[:1], patch=120), 50)
    ms_twin_16 = time_cuda(lambda: twin(curr[:16], prev[:16], patch=120), 20)
    c1, p1 = curr[:1].contiguous(), prev[:1].contiguous()
    own_one = own_ms(lambda: kernel(c1, p1, patch=120), 200)
    lib_own_one = own_ms(lambda: library(c1, p1), 50)
    say(f"  B=1: kernel {out[1][0]:.4f} ms through the wrapper, own {own_one:.4f} ms; twin "
        f"{ms_twin_one:.4f} ms (B=16: {ms_twin_16:.4f} ms); torch.fft route own {lib_own_one:.4f} ms")
    say("[4 throughput] done")
    return out[1][0], own_one, ms_twin_one, out[1][1], lib_own_one


PEAK_SHIFT_TOL = 1e-4  # px, kernel B against its twin
PEAK_MAXVAL_RTOL = 1e-6
SAD_RTOL = 1e-6  # kernel C against its twin on non-integer inputs


def compare_peak(raw, search_radius: int, label: str) -> float:
    """Kernel B against its twin on raw surfaces ``[..., N, N]``: the same
    peak index wherever the maxval is finite, the same NaN pattern, shifts
    within PEAK_SHIFT_TOL and maxval within PEAK_MAXVAL_RTOL.  Returns the
    largest shift difference."""
    from mrs_optic_flow_tpu_torch.ops.cuda_kernels import (
        peak_refine_raw as kernel,
        peak_refine_raw_ref as twin,
    )

    ks, km, ki = (x.cpu().numpy() for x in kernel(raw, search_radius=search_radius, with_index=True))
    ts, tm, ti = (x.cpu().numpy() for x in twin(raw, search_radius=search_radius, with_index=True))
    nan = np.isnan(tm)
    check(np.array_equal(np.isnan(km), nan), f"{label}: NaN maxval pattern differs")
    check(np.array_equal(np.isnan(ks), np.isnan(ts)), f"{label}: NaN shift pattern differs")
    check(np.array_equal(ki[~nan], ti[~nan]), f"{label}: peak index differs")
    fin = np.isfinite(ts)
    err = float(np.abs(ks[fin] - ts[fin]).max()) if fin.any() else 0.0
    check(err <= PEAK_SHIFT_TOL, f"{label}: shift differs by {err} px")
    rel = np.abs(km[~nan] - tm[~nan]) <= PEAK_MAXVAL_RTOL * np.abs(tm[~nan])
    check(rel.all(), f"{label}: maxval differs")
    return err


def render_affine(n_frames: int, step_deg: float, step_zoom: float, shape=(480, 480),
                  center=None, seed: int = 0) -> list:
    """uint8 gray frames of a band-limited texture rotated by ``step_deg``
    and zoomed by ``step_zoom`` per frame about ``center`` (x, y; default
    the frame centre), rendered with cubic splines.  Frame i shows the
    texture point ``c + R(-i a)(q - c) / z^i`` at pixel q, R the rotation
    of ``cv2.getRotationMatrix2D``, so the estimator decodes each step as a
    rotation of ``+a`` and a scale of ``1 / z``."""
    from scipy.ndimage import map_coordinates
    from oracle import smooth_random_image

    h, w = shape
    cx, cy = center if center is not None else (w / 2.0, h / 2.0)
    tex = smooth_random_image(np.random.default_rng(seed), 1024, cutoff=0.25).astype(np.float64)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    frames = []
    for i in range(n_frames):
        a = np.deg2rad(step_deg * i)
        z = step_zoom ** i
        u, v = (xs - cx) / z, (ys - cy) / z
        # R(-a) of cv2's rotation [[cos, sin], [-sin, cos]]
        px = np.cos(a) * u - np.sin(a) * v + 512.0
        py = np.sin(a) * u + np.cos(a) * v + 512.0
        g = map_coordinates(tex, [py, px], order=3, mode="wrap")
        frames.append(np.clip(np.rint(g), 0, 255).astype(np.uint8))
    return frames


def peak_runner(lib, raw, search_radius: int, centroid_radius: int = 3):
    """A closure launching kernel B from ``lib`` on ``raw [P, N, N]`` with
    its outputs and scratch allocated once: the current interface or the
    one-block-a-surface design before it (``prr_peak_refine_raw``)."""
    import torch

    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck

    p, n = raw.shape[0], raw.shape[-1]
    dev = raw.device
    shift = torch.empty((p, 2), dtype=torch.float32, device=dev)
    maxval = torch.empty((p,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if hasattr(lib, "prr_peak_refine_raw"):
        fn = lib.prr_peak_refine_raw
        args = (raw.data_ptr(), p, n, search_radius, centroid_radius, shift.data_ptr(),
                maxval.data_ptr(), None, stream)
    else:
        fn = lib.prr_peak_refine_split
        k, band_rows = ck.peak_split(p, n, search_radius)
        scratch = torch.empty((3 * p * k,), dtype=torch.int32, device=dev)
        counters = torch.zeros((p,), dtype=torch.int32, device=dev)
        args = (raw.data_ptr(), p, n, search_radius, centroid_radius, k, band_rows,
                int(n % 4 == 0), scratch.data_ptr(), counters.data_ptr(), shift.data_ptr(),
                maxval.data_ptr(), None, stream)

    def run():
        check(fn(*args) == 0, "kernel B launch failed")
        return shift
    return run


def peak_cases(dev) -> list:
    """Phase 6's surfaces for kernel B's split, as (raw, radius, label):
    ties and NaN in different row bands (bands of 2 rows at P = 1, N = 480,
    of 8 at P = 4, of 23 at P = 64), the masked zero and the largest
    negative value as peaks, NaN outside the window, odd n."""
    import torch

    rng = np.random.default_rng(6)

    def noise(p, n):
        return rng.uniform(-0.1, 0.1, (p, n, n)).astype(np.float32)

    one = noise(3, 480)
    one[0, 1, 7] = one[0, 2, 3] = 1.0  # a tie across two blocks
    one[1, 0, 5] = one[1, 479, 5] = 1.0  # first and last blocks
    one[2, 10, 10] = 1.0
    one[2, 300, 4] = np.nan  # NaN in one band only
    four = noise(4, 480)
    four[0, 3, 9] = four[0, 12, 9] = 0.9  # bands 0 and 1
    four[1, 100, 100] = 2.0
    four[1, 471, 2] = np.nan
    four[2] = -rng.uniform(0.5, 1.0, (480, 480))  # r >= n/2: the largest negative wins
    four[2, 200, 7] = -0.25
    four[3, 479, 479] = 1.5  # an edge peak (shifted (239, 239))
    many = noise(64, 120)
    for i in range(64):
        many[i, rng.integers(0, 120), rng.integers(0, 120)] = 1.0
    many[5] = -rng.uniform(0.5, 1.0, (120, 120))  # r < n/2: the masked zero at index 0 wins
    many[9, 60, 60] = np.nan  # shifted (0, 0): outside radius 55
    many[17, 30, 3] = np.nan  # inside, one band
    many[20, 2, 2] = many[20, 100, 2] = 3.0  # a tie across bands
    odd = noise(3, 121)
    odd[0, 2, 118] = 1.0
    odd[1, 1, 1] = odd[1, 120, 2] = 0.5
    odd[2, 60, 60] = np.nan
    odd[2, 0, 1] = 1.0

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return [
        (on(one[:1]), 240, "P=1 N=480 r=240, tie across two bands"),
        (on(one[1:2]), 240, "P=1 N=480 r=240, tie between the first and last bands"),
        (on(one[2:]), 240, "P=1 N=480 r=240, NaN in one band"),
        (on(four), 240, "P=4 N=480 r=240: tie, NaN, all negative, edge"),
        (on(four), 100, "P=4 N=480 r=100"),
        (on(many), 55, "P=64 N=120 r=55: masked zero, NaN outside and inside, tie"),
        (on(many), 60, "P=64 N=120 r=60"),
        (on(odd), 30, "P=3 N=121 r=30"),
        (on(odd), 60, "P=3 N=121 r=60"),
    ]


def check_peak_kernel(dev) -> dict:
    """Phase 6.  Returns kernel B's numbers at the scale/rotation shape (P =
    1, N = 480): max shift difference, wrapper ms, own ms, twin ms (and the
    baseline's own ms in turns when one is given)."""
    import torch

    from oracle import make_accuracy_pairs

    from mrs_optic_flow_tpu_torch.models.scale_rotation import (
        ScaleRotationConfig,
        ScaleRotationEstimator,
    )
    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck
    from mrs_optic_flow_tpu_torch.ops.cuda_kernels import (
        peak_refine_raw as kernel,
        peak_refine_raw_ref as twin,
    )
    from mrs_optic_flow_tpu_torch.ops.phase_correlate import correlation_surface_raw
    from mrs_optic_flow_tpu_torch.ops.preprocess import patchify

    errs = []
    # log-polar surfaces at N = 480, as the scale/rotation estimator makes them
    est = ScaleRotationEstimator(ScaleRotationConfig(), device=dev)
    frames = torch.from_numpy(np.stack(render_affine(5, 2.0, 1.02))).to(dev)
    lp = est.logpolar_batch(frames)
    lp_raw = correlation_surface_raw(lp[1:], lp[:-1], backend="dft").contiguous()
    errs.append(compare_peak(lp_raw[:1], 240, "log-polar P=1"))
    errs.append(compare_peak(lp_raw, 240, "log-polar P=4"))
    # FftMethod's fft route: [16 B, 120, 120] surfaces
    prev_np, curr_np, _, _ = make_accuracy_pairs(np.random.default_rng(2), 4)
    fft_raw = correlation_surface_raw(
        patchify(torch.from_numpy(curr_np).to(dev), 120),
        patchify(torch.from_numpy(prev_np).to(dev), 120), backend="fft",
    ).reshape(64, 120, 120).contiguous()
    errs.append(compare_peak(fft_raw, 55, "fft route [64, 120, 120]"))

    # edge cases at N = 120 (raw index (y, x) sits at shifted ((y+60)%120, (x+60)%120))
    edge = torch.zeros((6, 120, 120), dtype=torch.float32, device=dev)
    edge[0, 5, 7] = edge[0, 100, 3] = 1.0  # tie: the smaller shifted index wins
    edge[1, 10, 10] = 2.0
    edge[1, 3, 4] = float("nan")  # NaN inside the window
    edge[2, 10, 10] = 2.0
    edge[2, 60, 60] = float("nan")  # shifted (0, 0): outside radius 55, ignored
    edge[3] = -1.0  # all negative: a masked zero is the maximum
    edge[4, 60, 63] = 3.0  # shifted (0, 3): on the edge, centroid clamped
    edge[4, 60, 64] = edge[4, 61, 63] = 1.0
    # surface 5 stays zero
    errs.append(compare_peak(edge, 55, "edge cases, radius 55"))
    errs.append(compare_peak(edge, 60, "edge cases, radius 60"))
    km = kernel(edge, search_radius=55)[1]
    check(bool(torch.isnan(km[1])) and not bool(torch.isnan(km[2])), "NaN inside/outside the window")
    for raw, radius, label in peak_cases(dev):
        errs.append(compare_peak(raw, radius, label))
        k, band = ck.peak_split(raw.shape[0], raw.shape[-1], radius)
        say(f"  {label}: {k} blocks a surface of {band} rows, matches the twin")
    err = max(errs)

    out = {"err": err}
    for key, raw, radius, reps in (("1x480", lp_raw[:1].contiguous(), 240, 200),
                                   ("4x480", lp_raw, 240, 200), ("64x120", fft_raw, 55, 200)):
        ms = time_cuda(lambda: kernel(raw, search_radius=radius), reps)
        own = own_ms(lambda: kernel(raw, search_radius=radius), reps)
        plain_ms = time_cuda(lambda: twin(raw, search_radius=radius), 50)
        read_floor = own_ms(lambda: torch.max(raw), reps)
        k, band = ck.peak_split(raw.shape[0], raw.shape[-1], radius)
        line = (f"  [{key}] r={radius}, {k} blocks a surface: kernel {ms:.4f} ms through the wrapper, "
                f"own {own:.4f} ms; twin {plain_ms:.4f} ms; torch.max over the surfaces (the argmax "
                f"alone, a library reduction's read floor) own {read_floor:.4f} ms")
        say(line)
        out[key] = {"ms": ms, "own_ms": own, "plain_ms": plain_ms, "max_ms": read_floor}
        if "peak_refine_raw" in BASELINES:
            turns = in_turns(f"kernel B [{key}]", {
                "baseline": peak_runner(BASELINES["peak_refine_raw"], raw, radius),
                "kernel": peak_runner(ck.load_library("peak_refine_raw"), raw, radius)}, reps)
            out[key]["baseline_own_ms"] = turns["baseline"]
            out[key]["turns_own_ms"] = turns["kernel"]
    say(f"  max|shift - twin| {err:.3g} px")
    say("[6 kernel B] matches its twin on log-polar, fft-route, tie, NaN, edge, zero, banded and odd-n "
        "surfaces")
    return out


def old_sad_tile_rows(s: int, r: int, smem_limit: int) -> int:
    """Block rows a tile of kernel C's design before its register tiling
    (``sad_tile_rows`` as it stood at a7250c7): the fewest even tiles with
    which two 512-thread blocks share an SM."""
    row_bytes = (2 * s + 2 * r) * 4
    fit = max(1, (smem_limit // 2 - 1024 - (2 * r + 1) * 32 * 8) // row_bytes)
    tiles = -(-s // fit)
    return -(-s // tiles)


def sad_runner(lib, curr, prev, s: int, r: int):
    """A closure launching kernel C from ``lib`` on ``curr [G, S, S]`` and
    ``prev [G, S+2R, S+2R]`` with its output and scratch allocated once: the
    current interface or the one-block-a-row-shift design before it
    (``sad_sad_search``, tiles of ``old_sad_tile_rows``)."""
    import torch

    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck

    g, d, dev = curr.shape[0], 2 * r + 1, curr.device
    out = torch.empty((g, d, d), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if hasattr(lib, "sad_sad_search"):
        fn = lib.sad_sad_search
        rows = old_sad_tile_rows(s, r, torch.cuda.get_device_properties(dev).shared_memory_per_block_optin)
        args = (curr.data_ptr(), prev.data_ptr(), g, s, r, rows, out.data_ptr(), stream)
    else:
        fn = lib.sad_search_tiled
        geo = ck.sad_geometry(g, s, r)
        scratch = torch.empty((geo.scratch,), dtype=torch.float64, device=dev)
        counters = torch.zeros((geo.counters,), dtype=torch.int32, device=dev)
        args = (curr.data_ptr(), prev.data_ptr(), g, s, r, geo.xb, scratch.data_ptr(),
                counters.data_ptr(), out.data_ptr(), stream)

    def run():
        check(fn(*args) == 0, "kernel C launch failed")
        return out
    return run


def sad_blocks(dev, rng, g: int, s: int, r: int, integer: bool = True):
    import torch

    def draw(shape):
        x = rng.integers(0, 256, shape) if integer else rng.uniform(0, 255, shape)
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    return draw((g, s, s)), draw((g, s + 2 * r, s + 2 * r))


def check_sad_exact(dev, rng, g: int, s: int, r: int):
    """Kernel C bit-identical to its twin on integer-valued inputs, and on a
    repeated run.  Returns the inputs and the map."""
    import torch

    from mrs_optic_flow_tpu_torch.ops import block_matching
    from mrs_optic_flow_tpu_torch.ops.cuda_kernels import sad_search as kernel

    curr, prev = sad_blocks(dev, rng, g, s, r)
    k = kernel(curr, prev, block_size=s, scan_radius=r)
    t = block_matching.sad_search(curr, prev, block_size=s, scan_radius=r)
    check(tuple(k.shape) == (g, 2 * r + 1, 2 * r + 1), f"SAD map shape {tuple(k.shape)}")
    check(torch.equal(k, t), f"G={g} S={s} R={r}: max |kernel - twin| {float((k - t).abs().max())}")
    check(torch.equal(kernel(curr, prev, block_size=s, scan_radius=r), k),
          f"G={g} S={s} R={r}: a repeated run differs")
    return curr, prev, k


def time_sad(dev, curr, prev, s: int, r: int, label: str, library: bool = False) -> dict:
    """Kernel C through the wrapper (CUDA events) and its own time, the
    twin's, ``torch.cdist`` over the unfolded regions when ``library``, and
    the former design in turns when ``--baseline sad_search=PATH`` names it."""
    import torch

    from mrs_optic_flow_tpu_torch.ops import block_matching
    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck
    from mrs_optic_flow_tpu_torch.ops.cuda_kernels import sad_search as kernel

    g, d = curr.shape[0], 2 * r + 1
    out = {
        "ms": time_cuda(lambda: kernel(curr, prev, block_size=s, scan_radius=r), 50),
        "own_ms": own_ms(lambda: kernel(curr, prev, block_size=s, scan_radius=r), 50),
        "plain_ms": time_cuda(lambda: block_matching.sad_search(curr, prev, block_size=s, scan_radius=r), 10),
        "library_ms": None,
    }
    if library:
        # one PyTorch call computing the same map: L1 distances of each block to
        # its D*D windows, the [G, D*D, S*S] unfold built once, outside the timing
        windows = prev.unfold(1, s, 1).unfold(2, s, 1).reshape(g, d * d, s * s)
        flat = curr.reshape(g, 1, s * s)
        lib_map = torch.cdist(flat, windows, p=1).reshape(g, d, d)
        k = kernel(curr, prev, block_size=s, scan_radius=r)
        rel = float(((lib_map - k).abs() / k.abs().clamp_min(1e-30)).max())
        check(rel <= SAD_RTOL, f"torch.cdist map differs from the kernel's by {rel} relative")
        out["library_ms"] = time_cuda(lambda: torch.cdist(flat, windows, p=1), 20)
        out["library_own_ms"] = own_ms(lambda: torch.cdist(flat, windows, p=1), 20)
        say(f"  {label}: torch.cdist(p=1) over the {windows.numel() * 4 / 1e9:.2f} GB unfold: "
            f"{out['library_ms']:.4f} ms (own {out['library_own_ms']:.4f} ms), within {rel:.2g} "
            f"of the kernel")
        del windows
        torch.cuda.empty_cache()
    geo = ck.sad_geometry(g, s, r)
    bound_ms, by = bound("sad_search", g=g, s=s, r=r)
    say(f"  {label}: {geo.blocks} blocks of {geo.threads} threads ({geo.parts} parts, bands of "
        f"{geo.xb}); kernel {out['ms']:.4f} ms through the wrapper, own {out['own_ms']:.4f} ms; twin "
        f"{out['plain_ms']:.4f} ms; bound {bound_ms:.5f} ms ({by}), own time at "
        f"{bound_ms / out['own_ms']:.1%} of it")
    if "sad_search" in BASELINES:
        turns = in_turns(f"kernel C {label}", {
            "baseline": sad_runner(BASELINES["sad_search"], curr, prev, s, r),
            "kernel": sad_runner(ck.load_library("sad_search"), curr, prev, s, r)}, 50)
        out["baseline_own_ms"] = turns["baseline"]
        out["turns_own_ms"] = turns["kernel"]
    return out


def check_sad_kernel(dev) -> dict:
    """Phase 7.  Returns kernel C's numbers at the node's geometry (9
    cells, S = 120, R = 21): max abs difference on integer inputs (0) and
    ``time_sad``'s times."""
    import torch

    from mrs_optic_flow_tpu_torch.ops import block_matching
    from mrs_optic_flow_tpu_torch.ops.cuda_kernels import sad_search as kernel

    s, r, g = 120, 21, 9
    rng = np.random.default_rng(5)
    curr, prev, k = check_sad_exact(dev, rng, g, s, r)
    check(torch.equal(kernel(curr[:1].contiguous(), prev[:1].contiguous(), block_size=s, scan_radius=r),
                      k[:1]), "G=1 differs from the same cell in G=9")
    for ss, rr in ((120, 21), (120, 0), (8, 3)):
        for gg in (1, 9, 16):
            check_sad_exact(dev, rng, gg, ss, rr)
    say("  integer inputs bit-identical and repeated runs identical at (S, R) = (120, 21), "
        "(120, 0), (8, 3), G = 1, 9, 16")
    rel = 0.0
    for gg in (1, 9):
        cf, pf = sad_blocks(dev, rng, gg, s, r, integer=False)
        kf = kernel(cf, pf, block_size=s, scan_radius=r)
        tf = block_matching.sad_search(cf, pf, block_size=s, scan_radius=r)
        rel = max(rel, float(((kf - tf).abs() / tf.abs()).max()))
        check(torch.equal(kernel(cf, pf, block_size=s, scan_radius=r), kf), "float inputs: a repeated run differs")
    check(rel <= SAD_RTOL, f"float inputs: relative difference {rel}")
    say(f"  float inputs within {rel:.3g} relative of the twin")
    out = time_sad(dev, curr, prev, s, r, "[9, 43, 43] S=120", library=True)
    c1, p1 = curr[:1].contiguous(), prev[:1].contiguous()
    out["g1"] = time_sad(dev, c1, p1, s, r, "[1, 43, 43] S=120", library=True)
    say("[7 kernel C] matches its twin; G=1 and repeated runs identical")
    out["err"] = 0.0
    return out


def render_frames(n_frames: int, seed: int = 0, heights=None) -> list:
    """BGR uint8 752x480 frames of a nadir camera over a band-limited periodic
    texture, one texture pixel per image pixel, moving at ``V_TRUE``: pixel
    flow per frame ``d = -f * v * dt / h`` (``runtime/stream.py:75-81``) at
    ``HEIGHT`` or, from frame i - 1 to frame i, at ``heights[i]``, rendered
    as an exact Fourier shift."""
    from oracle import fourier_shift, smooth_random_image

    tex = smooth_random_image(np.random.default_rng(seed), 1024, cutoff=0.25)
    d = (-FX * V_TRUE[0] * DT / HEIGHT, -FY * V_TRUE[1] * DT / HEIGHT)
    pos = np.zeros(2)
    frames = []
    for i in range(n_frames):
        if heights is None:
            pos = (d[0] * i, d[1] * i)
        elif i:
            pos = pos - np.array([FX * V_TRUE[0], FY * V_TRUE[1]]) * DT / heights[i]
        gray = fourier_shift(tex, pos[0], pos[1])[:480, :752]
        g8 = np.clip(np.rint(gray), 0, 255).astype(np.uint8)
        frames.append(np.repeat(g8[..., None], 3, axis=-1))
    return frames


def kernel_wrappers() -> dict:
    """Kernel name -> its wrapper, whose ``LAUNCHES`` counts its launches."""
    from mrs_optic_flow_tpu_torch.ops import cuda_kernels

    return {name: getattr(cuda_kernels, name) for name in KERNELS}


def level_node(dev, config, published: list):
    """A node on ``dev`` publishing into ``published``, with the camera of
    ``render_frames`` and the identity mount."""
    from mrs_optic_flow_tpu_torch.runtime.msgs import CameraInfo
    from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode

    node = OpticFlowNode(config, device=dev, publish=lambda t, m: published.append((t, m)), log=say)
    node.on_camera_info(CameraInfo(k=[FX, 0, 376.0, 0, FY, 240.0, 0, 0, 1], d=[0.0] * 5))
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    return node


def feed_frame(node, i: int, frame, height: float = HEIGHT):
    """Frame i with its IMU, odometry at ``V_TRUE`` and ``height`` at
    ``100 + i DT``, level.  Returns ``on_image``'s twist."""
    from mrs_optic_flow_tpu_torch.runtime.msgs import Float64Stamped, ImageMsg, Imu, Odometry

    t = 100.0 + i * DT
    node.on_imu(Imu(stamp=t, angular_velocity=(0.0, 0.0, 0.0), orientation=(0.0, 0.0, 0.0, 1.0)))
    node.on_odometry(Odometry(stamp=t, orientation=(0.0, 0.0, 0.0, 1.0),
                              linear_velocity=(V_TRUE[0], V_TRUE[1], 0.0)))
    node.on_height(Float64Stamped(stamp=t, value=height))
    return node.on_image(ImageMsg(stamp=t, data=frame))


def feed_node(node, frames, heights=None) -> None:
    """:func:`feed_frame` of every frame, at ``HEIGHT`` or ``heights[i]``."""
    for i, frame in enumerate(frames):
        feed_frame(node, i, frame, HEIGHT if heights is None else heights[i])


def drive_node(dev, config, frames, label: str, heights=None):
    """Warm a node up, then drive it with ``frames`` (BGR 752x480 uint8) at
    ``DT``, level, at ``HEIGHT`` (or frame i at ``heights[i]``), with
    odometry at ``V_TRUE``.  Every
    kernel's launch count is set to 0 just before the frames and read just
    after.  Returns (node, published messages, launches per kernel,
    per-frame latency in ms of the processed frames)."""
    published = []
    node = level_node(dev, config, published)
    say(f"  {label}: warmup {node.warmup():.2f} s")

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.LAUNCHES = 0
    feed_node(node, frames, heights)
    launches = {name: fn.LAUNCHES for name, fn in wrappers.items()}

    # raw frame to published twist; the first frame only primes the node
    lat_ms = np.array([m for t, m in published if t == "processing_latency_out"][1:]) * 1e3
    say(f"  {label}: per-frame latency p50 {np.percentile(lat_ms, 50):.3f} ms, "
        f"p90 {np.percentile(lat_ms, 90):.3f} ms over {len(lat_ms)} frames; launches {launches}")
    return node, published, launches, lat_ms


def check_twists(node, published, tol: float, label: str) -> None:
    """Every published twist after the first (the first-frame copy, a zero
    shift) within ``tol`` of ``V_TRUE`` in x and y; no failed frame."""
    twists = [m for t, m in published if t == "velocity_out"]
    v = np.array([tw.linear[:2] for tw in twists[1:]])
    err = np.abs(v - np.array(V_TRUE)).max(axis=0)
    health = node.health
    say(f"  {label}: {len(twists)} twists, mean v {v.mean(axis=0).round(4).tolist()} m/s, "
        f"max |v - truth| {err.round(4).tolist()} m/s; health {health}")
    check(len(twists) == N_FRAMES - 1, f"{label}: {len(twists)} twists for {N_FRAMES} frames")
    check(np.isfinite(v).all() and np.all(err <= tol), f"{label}: twist error {err} m/s")
    check(health["consecutive_failures"] == 0, health)
    check(health["frames_processed"] == len(twists), health)


def run_node(dev) -> int:
    """Phase 5.  Returns the kernel launches of the node's run."""
    from mrs_optic_flow_tpu_torch.config import NodeConfig

    node, published, launches, _ = drive_node(dev, NodeConfig(), render_frames(N_FRAMES), "method 4")
    host = node.profiler.stats()["frame_program"]
    say(f"  host time to issue the frame chain p50 {host['p50_s'] * 1e3:.3f} ms")
    check_twists(node, published, TWIST_TOL, "method 4")
    say("[5 node] twists within budget")
    return launches["phase_correlate_frames"]


def run_scale_rotation_node(dev) -> int:
    """Phase 8.  Returns kernel B's launches in the node's run."""
    import torch

    from mrs_optic_flow_tpu_torch.config import NodeConfig
    from mrs_optic_flow_tpu_torch.models.scale_rotation import (
        ScaleRotationConfig,
        ScaleRotationEstimator,
    )

    gray = render_affine(N_FRAMES, SR_STEP_DEG, SR_STEP_ZOOM, shape=(480, 752), center=(376.0, 240.0))
    frames = [np.repeat(g[..., None], 3, axis=-1) for g in gray]
    node, published, launches, _ = drive_node(
        dev, NodeConfig(scale_rotation=True), frames, "scale/rotation")
    check(node.scale_rotation_estimator.config.lp_res == 480, "log-polar size")
    sr = [m for t, m in published if t == "scale_rotation_out"]
    check(len(sr) == N_FRAMES - 1, f"{len(sr)} scale/rotation messages for {N_FRAMES} frames")
    check(sr[0]["scale"] == 1.0 and sr[0]["yaw_rate"] == 0.0, f"first decode {sr[0]}")
    rot_deg = np.array([np.rad2deg(m["yaw_rate"] * DT) for m in sr[1:]])
    scale = np.array([m["scale"] for m in sr[1:]])
    rot_err = np.abs(rot_deg - SR_STEP_DEG)
    scale_err = np.abs(scale - 1.0 / SR_STEP_ZOOM)
    say(f"  decodes: rotation {rot_deg.mean():.4f} deg (truth {SR_STEP_DEG}), max err "
        f"{rot_err.max():.4f} deg; scale {scale.mean():.5f} (truth {1 / SR_STEP_ZOOM:.5f}), "
        f"max err {scale_err.max():.5f}")
    check(np.all(rot_err <= SR_ROT_TOL), f"rotation errors {rot_err} deg")
    check(np.all(scale_err <= SR_SCALE_TOL), f"scale errors {scale_err}")
    check(launches["peak_refine_raw"] >= N_FRAMES - 1,
          f"{launches['peak_refine_raw']} kernel B launches for {N_FRAMES - 1} processed frames")

    # the same crops through the estimator on the kernel route and the twin's
    crops = torch.from_numpy(np.stack(gray)[:, :, 136:616]).to(dev)
    decodes = []
    for use_pallas in (True, False):
        est = ScaleRotationEstimator(ScaleRotationConfig(use_pallas=use_pallas), device=dev)
        state, out = est.init_state(), []
        for crop in crops:
            state, res = est.step(state, crop)
            out.append([float(res.scale), float(res.rotation)])
        decodes.append(np.array(out))
    twin_err = float(np.abs(decodes[0] - decodes[1]).max())
    say(f"  kernel vs twin decodes: max difference {twin_err:.3g}")
    check(twin_err <= SR_TWIN_TOL, f"kernel and twin decodes differ by {twin_err}")
    say("[8 scale/rotation node] decodes within budget")
    return launches["peak_refine_raw"]


def run_block_matching_nodes(dev) -> int:
    """Phase 9.  Returns kernel C's launches in the two nodes' runs."""
    from mrs_optic_flow_tpu_torch.config import NodeConfig

    frames = render_frames(N_FRAMES)
    total = 0
    for method in (3, 5):
        label = f"method {method}"
        node, published, launches, _ = drive_node(dev, NodeConfig(method=method), frames, label)
        check_twists(node, published, BM_TWIST_TOL, label)
        check(launches["sad_search"] >= N_FRAMES - 1,
              f"{label}: {launches['sad_search']} kernel C launches for {N_FRAMES - 1} frames")
        total += launches["sad_search"]
    say("[9 block-matching nodes] twists within budget")
    return total


def patch_pairs(n: int, pairs: int, seed: int):
    """uint8 ``[P, n, n]`` patch pairs cut from ``pairs`` frame pairs of side
    ``q * n`` (q = 480 // n, at least 1) with sub-pixel shifts up to
    ``n / 6`` px (25 px at most), and the oracle's shift of each patch."""
    from oracle import make_accuracy_pairs

    q = max(480 // n, 1)
    prev, curr, _, oracle = make_accuracy_pairs(
        np.random.default_rng(seed), pairs, size=q * n, patch=n, max_shift=min(25.0, n / 6))

    def cut(frames):
        b = frames.shape[0]
        return np.ascontiguousarray(
            frames.reshape(b, q, n, q, n).transpose(0, 1, 3, 2, 4).reshape(b * q * q, n, n))

    return cut(curr), cut(prev), oracle.reshape(-1, 2)


def compare_pc(kernel, twin, curr, prev, label: str, oracle=None, **kw) -> float:
    """A phase-correlation kernel against its twin (and the oracle when
    given) on one batch: the same NaN pattern, shifts within SHIFT_TOL,
    maxval within MAXVAL_RTOL of the largest.  Returns the largest shift
    difference from the twin."""
    ks, km = (x.cpu().numpy() for x in kernel(curr, prev, **kw))
    ts, tm = (x.cpu().numpy() for x in twin(curr, prev, **kw))
    check(np.array_equal(np.isnan(ks), np.isnan(ts)), f"{label}: NaN shift pattern differs")
    check(np.array_equal(np.isnan(km), np.isnan(tm)), f"{label}: NaN maxval pattern differs")
    fin = np.isfinite(ts)
    err = float(np.abs(ks[fin] - ts[fin]).max()) if fin.any() else 0.0
    check(err <= SHIFT_TOL, f"{label}: kernel vs twin {err} px")
    finm = np.isfinite(tm)
    if finm.any():
        rel = float(np.abs(km[finm] - tm[finm]).max() / max(np.abs(tm[finm]).max(), 1e-30))
        check(rel <= MAXVAL_RTOL, f"{label}: maxval vs twin {rel}")
    if oracle is not None:
        err_o = float(np.abs(ks - oracle).max())
        check(err_o <= SHIFT_TOL, f"{label}: kernel vs oracle {err_o} px")
        say(f"  {label}: max|shift - twin| {err:.3g} px, max|shift - oracle| {err_o:.3g} px")
    return err


def masked_pair(n: int, seed: int, strong=(70.0, 0.0)):
    """One float32 ``[1, n, n]`` pair whose content moves by a ``strong``
    shift, beyond the search radius 55, plus a weaker copy moved by (10, 3)
    px: masked, the peak is the weak one; unmasked, the strong one."""
    from oracle import fourier_shift, smooth_random_image

    base = smooth_random_image(np.random.default_rng(seed), n, cutoff=0.3).astype(np.float64)
    curr = 0.7 * fourier_shift(base, *strong) + 0.3 * fourier_shift(base, 10.0, 3.0)
    return curr[None].astype(np.float32), base[None].astype(np.float32)


#: phase 10's kernel-D batches: (n, frame pairs of q x q patches, q = 480 // n):
#: both designs, odd n, a prime (97, the generic radix alone), the
#: ``scale_factor: 0.8`` patch (150), the last one-block n (170) and the first
#: staged one (171 = 9 * 19, a generic radix 19)
D_SIZES = ((60, 1), (45, 1), (90, 1), (97, 1), (100, 1), (150, 2), (160, 1), (170, 1), (171, 1),
           (240, 1), (480, 16))
#: kernel D's timed shapes: label -> (n, pairs, dtype); the first is the
#: node's shape of phase 12(b)
D_TIMED = {"64x60 u8": (60, 64, "uint8"), "1x480 u8": (480, 1, "uint8"),
           "4x60 f32": (60, 4, "float32"), "16x150 u8": (150, 16, "uint8"),
           "4x240 u8": (240, 4, "uint8"),
           # the run-time plan (no kernel compiled for the size): odd, and a prime
           "64x45 u8": (45, 64, "uint8"), "16x97 u8": (97, 16, "uint8")}
#: the shapes at which ``--baseline phase_correlate_fullfused=PATH`` runs in turns
D_TURNS = ("64x60 u8", "1x480 u8", "64x45 u8", "16x97 u8")


def fullfused_runner(lib, curr, prev, search_radius: int = 55, centroid_radius: int = 3):
    """A closure launching kernel D from ``lib`` (this design's or an
    earlier one's: both have ``pcff_scratch_bytes`` and
    ``pcff_phase_correlate_fullfused``, this one with the peak split after
    the radii) on ``[P, N, N]`` pairs, its outputs and scratch allocated
    once."""
    import torch

    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck

    p, n, dev = curr.shape[0], curr.shape[-1], curr.device
    pair_bytes = lib.pcff_scratch_bytes(n)
    chunk = ck._chunk(p, pair_bytes)
    scratch = torch.empty((chunk * pair_bytes,), dtype=torch.uint8, device=dev)
    tab = ck._twiddles(n, dev)
    shift = torch.empty((p, 2), dtype=torch.float32, device=dev)
    maxval = torch.empty((p,), dtype=torch.float32, device=dev)
    split = ck.peak_split(chunk, n, search_radius) if hasattr(lib, "pcff_route") else ()
    args = (curr.data_ptr(), prev.data_ptr(), int(curr.dtype == torch.uint8), p, n, chunk,
            search_radius, centroid_radius, *split, tab.data_ptr(), scratch.data_ptr(),
            shift.data_ptr(), maxval.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)

    def run():
        check(lib.pcff_phase_correlate_fullfused(*args) == 0, "kernel D launch failed")
        return shift
    return run


def time_fullfused(dev, c, p, label: str) -> dict:
    """Kernel D on one batch: through the wrapper and by its own device
    time, the twin, the ``torch.fft`` route through its wrapper
    (``library_ms``) and by its own device time (``library_own_ms``), the
    bound, and the design before this one in turns when ``--baseline``
    names it."""
    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck
    from mrs_optic_flow_tpu_torch.ops.cuda_kernels import (
        phase_correlate_fullfused as kernel,
        phase_correlate_fullfused_ref as twin,
    )
    from mrs_optic_flow_tpu_torch.ops.phase_correlate import phase_correlate_field

    n, pairs = c.shape[-1], c.shape[0]

    def library():
        return phase_correlate_field(c, p, backend="fft")

    out = {
        "ms": time_cuda(lambda: kernel(c, p), 100),
        "own_ms": own_ms(lambda: kernel(c, p), 100),
        "plain_ms": time_cuda(lambda: twin(c, p), 20),
        "library_ms": time_cuda(library, 50),
        "library_own_ms": own_ms(library, 50),
    }
    bound_ms, by = bound("phase_correlate_fullfused", p=pairs, n=n, itemsize=c.element_size())
    out.update(bound_ms=bound_ms, bound_by=by)
    route = "one block a pair" if ck.pcff_small(n) else "staged"
    say(f"  D [{label}] ({route}): kernel {out['ms']:.4f} ms through the wrapper, own "
        f"{out['own_ms']:.4f} ms; twin {out['plain_ms']:.4f} ms; torch.fft route {out['library_ms']:.4f} "
        f"ms (own {out['library_own_ms']:.4f} ms); bound {bound_ms:.6f} ms ({by})")
    if "phase_correlate_fullfused" in BASELINES and label in D_TURNS:
        runs = {"baseline": fullfused_runner(BASELINES["phase_correlate_fullfused"], c, p),
                "kernel": fullfused_runner(ck.load_library("phase_correlate_fullfused"), c, p)}
        err = float((runs["baseline"]() - runs["kernel"]()).abs().max())
        check(err <= SHIFT_TOL, f"D [{label}]: the baseline differs by {err} px")
        turns = in_turns(f"kernel D [{label}] (max|shift difference| {err:.2e} px)", runs, 100)
        out["baseline_own_ms"] = turns["baseline"]
        out["turns_own_ms"] = turns["kernel"]
    return out


def check_fullfused_kernel(dev) -> dict:
    """Phase 10.  Returns {"err": max shift difference from the twin,
    label: ``time_fullfused``'s numbers for each of D_TIMED}."""
    import torch

    from mrs_optic_flow_tpu_torch.models import FftMethod, FftMethodConfig
    from mrs_optic_flow_tpu_torch.ops import cuda_kernels
    from mrs_optic_flow_tpu_torch.ops.cuda_kernels import (
        phase_correlate_fullfused as kernel,
        phase_correlate_fullfused_ref as twin,
    )

    def on(x):
        return torch.from_numpy(x).to(dev)

    errs = []
    batches = {}
    for n, pairs in D_SIZES:
        c8, p8, oracle = patch_pairs(n, pairs, seed=10 + n)
        c, p = on(c8), on(p8)
        batches[n] = (c, p)
        route = "one block a pair" if cuda_kernels.pcff_small(n) else "staged"
        errs.append(compare_pc(kernel, twin, c, p, f"n={n} P={c.shape[0]} ({route})", oracle))
        ks8 = kernel(c, p)
        ksf = kernel(c.float(), p.float())
        check(all(torch.equal(a, b) for a, b in zip(ks8, ksf)), f"n={n}: uint8 and float32 differ")
        if c.shape[0] > 1:
            one = kernel(c[1:2].contiguous(), p[1:2].contiguous())
            check(all(torch.equal(a, b[1:2]) for a, b in zip(one, ks8)),
                  f"n={n}: P=1 differs from the same pair in P={c.shape[0]}")
    say("  every n: uint8 and float32 bit-identical; P=1 equal to the same pair in the batch")
    # the staged design over several chunks: every chunk's peak takes the
    # first chunk's split, and a pair's result stays the same
    c, p = batches[480]
    pair_bytes = cuda_kernels.pcff_scratch_bytes(480)
    chunk = cuda_kernels._chunk(2 * c.shape[0], pair_bytes)
    check(chunk < 2 * c.shape[0], f"n=480: one chunk of {chunk} pairs")
    twice = kernel(torch.cat([c, c]), torch.cat([p, p]))
    once = kernel(c, p)
    check(all(torch.equal(a, torch.cat([b, b])) for a, b in zip(twice, once)),
          f"n=480: {2 * c.shape[0]} pairs in chunks of {chunk} differ from {c.shape[0]} at once")
    say(f"  n=480: {2 * c.shape[0]} pairs in chunks of {chunk} (peak split "
        f"{cuda_kernels.peak_split(chunk, 480, 55)}) equal the same pairs at once")

    for n in (45, 60, 97, 170, 171, 480):
        zero = torch.zeros((2, n, n), dtype=torch.uint8, device=dev)
        zs, zm = (x.cpu().numpy() for x in kernel(zero, zero))
        check(np.all(zs == -(n // 2)) and np.all(zm == 0.0), f"n={n}: zero patches give {zs[0]}, {zm[0]}")
        c, p = batches[n]
        c = c[:4].float().clone()
        p = p[:4].float().clone()
        c[1, n // 3, n // 2] = float("nan")  # a NaN pixel in pair 1
        c[2] = 0.0  # pair 2: curr zero, a surface of ties
        p[3] = 0.0  # pair 3: prev zero
        ns, nm = (x.cpu().numpy() for x in kernel(c, p))
        check(np.isnan(ns[1]).all() and np.isnan(nm[1]), f"n={n}: NaN pair gives {ns[1]}, {nm[1]}")
        check(np.isfinite(ns[0]).all() and np.all(ns[2:] == -(n // 2)) and np.all(nm[2:] == 0.0),
              f"n={n}: {ns[0]}, one-sided zero pairs give {ns[2:]}, {nm[2:]}")
        errs.append(compare_pc(kernel, twin, c, p, f"n={n} NaN/one-sided zero"))
    say("  zero, NaN and one-sided zero pairs at n = 45, 60, 97, 170, 171 and 480 as the twin: "
        "exactly -(n//2) with maxval 0")
    mc, mp = (on(x) for x in masked_pair(480, seed=7))
    errs.append(compare_pc(kernel, twin, mc, mp, "n=480 masked, radius 55"))
    errs.append(compare_pc(kernel, twin, mc, mp, "n=480 unmasked, radius 240", search_radius=240))
    masked = kernel(mc, mp)[0].cpu().numpy()[0]
    unmasked = kernel(mc, mp, search_radius=240)[0].cpu().numpy()[0]
    say(f"  n=480 two-shift pair: radius 55 -> {masked.round(3).tolist()}, "
        f"radius 240 -> {unmasked.round(3).tolist()}")
    check(np.abs(masked - [10.0, 3.0]).max() < 0.5, f"masked peak {masked}")
    check(np.abs(unmasked - [70.0, 0.0]).max() < 0.5, f"unmasked peak {unmasked}")
    err = max(errs)

    # FftMethod with large patches, each through the kernel the route rule
    # names (repair F2; 600/150 is the loader's frame and patch at
    # scale_factor 0.8)
    from oracle import fourier_shift, smooth_random_image

    for size, patch, route in ((480, 160, "phase_correlate_frames"), (480, 240, "phase_correlate_fullfused"),
                               (480, 100, "phase_correlate_fullfused"),
                               (600, 150, "phase_correlate_fullfused")):
        base = smooth_random_image(np.random.default_rng(3), size, cutoff=0.3).astype(np.float64)
        frames = np.stack([fourier_shift(base, 2.5 * i, -1.5 * i) for i in range(3)]).astype(np.float32)
        wrapper = getattr(cuda_kernels, route)
        cfg = FftMethodConfig(frame_size=size, sample_point_size=patch)
        outs = []
        for d in (dev, torch.device("cpu")):
            eng = FftMethod(cfg, device=d)
            state = eng.init_state()
            before = wrapper.LAUNCHES
            for f in frames:
                state, res = eng.step(state, torch.from_numpy(f).to(d))
            if d == dev:
                check(wrapper.LAUNCHES - before == len(frames), f"{size}/{patch}: not through {route}")
            outs.append(res.shifts_raw.cpu().numpy())
        e = float(np.abs(outs[0] - outs[1]).max())
        say(f"  FftMethod {size}/{patch} ({eng.num_windows} windows of {eng.config.sample_point_size}) "
            f"through {route}: max|card - CPU| {e:.3g} px, shift {outs[0][0].round(3).tolist()}")
        check(e <= SHIFT_TOL, f"FftMethod {size}/{patch}: card and CPU differ by {e} px")

    out = {"err": err}
    for label, (n, pairs, dtype) in D_TIMED.items():
        c, p = (x[:pairs].to(getattr(torch, dtype)).contiguous() for x in batches[n])
        check(c.shape[0] == pairs, f"D [{label}]: {c.shape[0]} pairs")
        out[label] = time_fullfused(dev, c, p, label)
    say(f"  max|shift - twin| {err:.3g} px")
    say("[10 kernel D] matches twin and oracle at n = 45 to 480, both designs; uint8, zero, NaN, tie, "
        "masked cases hold")
    return out


#: phase 11's timed shapes of kernel E, float32 pairs: label -> (n, pairs);
#: the first, the conformance diff's, is the kernels line's row
E_TIMED = {"16x120": (120, 16), "4x240": (240, 4), "1x480": (480, 1)}


def old_fused_runner(lib, curr, prev, search_radius: int = 55, centroid_radius: int = 3):
    """A closure running kernel E's design before this one from ``lib`` (C
    interface ``pcfu_phase_correlate_fused(f1r, f1i, f2r, f2i, ...)``) as its
    wrapper did: ``_dft2_real`` of both batches, then the launch; outputs
    and scratch allocated once."""
    import torch

    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck
    from mrs_optic_flow_tpu_torch.ops.phase_correlate import _dft2_real

    p, n, dev = curr.shape[0], curr.shape[-1], curr.device
    pair_bytes = lib.pcfu_scratch_bytes(n)
    chunk = ck._chunk(p, pair_bytes)
    scratch = torch.empty((chunk * pair_bytes,), dtype=torch.uint8, device=dev)
    tab = ck._twiddles(n, dev)
    shift = torch.empty((p, 2), dtype=torch.float32, device=dev)
    maxval = torch.empty((p,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        spectra = (*_dft2_real(curr), *_dft2_real(prev))
        check(lib.pcfu_phase_correlate_fused(
            *(f.data_ptr() for f in spectra), p, n, chunk, search_radius, centroid_radius,
            tab.data_ptr(), scratch.data_ptr(), shift.data_ptr(), maxval.data_ptr(), stream) == 0,
            "the old kernel E's launch failed")
        return shift
    return run


#: the ``__global__`` functions of kernel E's own launches after the forward
#: products (``csrc/phase_correlate_fused.cu``, kernel B's split peak)
E_OWN = re.compile(r"\b(small_kernel|rows_inverse|cols_inverse|peak_split_kernel)\b")


def time_fused(c, p, label: str) -> dict:
    """Kernel E on one float32 batch: through the wrapper and by its own
    device time, split by kernel name into E's own launches (``E_OWN``) and
    the forward products (every other kernel of the call: the stack, the
    GEMMs and whatever the library adds to them), with its launches a call; the
    twin; the ``torch.fft`` chain through its calls and by its own device
    time; the bound; and the design before this one in turns when
    ``--baseline phase_correlate_fused=PATH`` names it."""
    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck
    from mrs_optic_flow_tpu_torch.ops.cuda_kernels import (
        phase_correlate_fused as kernel,
        phase_correlate_fused_ref as twin,
    )
    from mrs_optic_flow_tpu_torch.ops.phase_correlate import phase_correlate_field

    n, pairs = c.shape[-1], c.shape[0]

    def library():
        return phase_correlate_field(c, p, backend="fft")

    by_name = own_by_kernel(lambda: kernel(c, p), 100)
    forward = {k: v for k, v in by_name.items() if not E_OWN.search(k)}
    out = {
        "ms": time_cuda(lambda: kernel(c, p), 100),
        "own_ms": sum(ms for _, ms in by_name.values()),
        "forward_own_ms": sum(ms for _, ms in forward.values()),
        "launches_a_call": sum(k for k, _ in by_name.values()),
        "forward_launches": sum(k for k, _ in forward.values()),
        "plain_ms": time_cuda(lambda: twin(c, p), 20),
        "library_ms": time_cuda(library, 50),
        "library_own_ms": own_ms(library, 50),
    }
    bound_ms, by = bound("phase_correlate_fused", p=pairs, n=n, itemsize=c.element_size())
    out.update(bound_ms=bound_ms, bound_by=by)
    route = "one block a pair" if ck.pcff_small(n) else "staged"
    say(f"  E [{label}] ({route}): {out['ms']:.4f} ms through the wrapper, own {out['own_ms']:.4f} ms "
        f"in {out['launches_a_call']} launches a call: forward {out['forward_own_ms']:.4f} ms in "
        f"{out['forward_launches']}, kernel E {out['own_ms'] - out['forward_own_ms']:.4f} ms in "
        f"{out['launches_a_call'] - out['forward_launches']}; twin {out['plain_ms']:.4f} ms; "
        f"torch.fft route {out['library_ms']:.4f} ms (own {out['library_own_ms']:.4f} ms); bound "
        f"{bound_ms:.6f} ms ({by})")
    for name, (k, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        say(f"    x{k} {ms:.4f} ms  {name[:110]}")
    if "phase_correlate_fused" in BASELINES:
        runs = {"baseline": old_fused_runner(BASELINES["phase_correlate_fused"], c, p),
                "kernel": lambda: kernel(c, p)[0]}
        err = float((runs["baseline"]() - runs["kernel"]()).abs().max())
        check(err <= SHIFT_TOL, f"E [{label}]: the baseline differs by {err} px")
        turns = in_turns(f"kernel E [{label}], with the forward products (max|shift difference| "
                         f"{err:.2e} px)", runs, 100)
        out["baseline_own_ms"] = turns["baseline"]
        out["turns_own_ms"] = turns["kernel"]
    return out


def check_fused_kernel(dev) -> dict:
    """Phase 11.  Returns {"launches": E's launches in the conformance
    check, "err": max shift difference from the twin, label:
    ``time_fused``'s numbers for each of E_TIMED}."""
    import torch

    from mrs_optic_flow_tpu_torch.ops import conformance
    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck
    from mrs_optic_flow_tpu_torch.ops.cuda_kernels import (
        phase_correlate_fused as kernel,
        phase_correlate_fused_ref as twin,
    )

    def on(x):
        return torch.from_numpy(x).to(dev)

    errs, batches = [], {}
    # both designs against twin and oracle; repair F8: uint8 = float32 bit for bit
    for n, pairs in ((120, 1), (45, 1), (97, 1), (170, 1), (171, 1), (240, 1), (480, 16)):
        c8, p8, oracle = patch_pairs(n, pairs, seed=11 if n == 120 else 30 + n)
        c, p = on(c8).float(), on(p8).float()
        batches[n] = (c, p)
        route = "one block a pair" if ck.pcff_small(n) else "staged"
        errs.append(compare_pc(kernel, twin, c, p, f"E n={n} P={c.shape[0]} ({route})", oracle))
        check(all(torch.equal(a, b) for a, b in zip(kernel(on(c8), on(p8)), kernel(c, p))),
              f"E n={n}: uint8 and float32 differ")
    say("  every n: uint8 and float32 bit-identical (F8)")
    # the staged design's scratch with an odd count of odd patches: every
    # array of its layout stays aligned to its type (100 pairs of 171 px go
    # in chunks of 95 and 5)
    for n, keep in ((171, 1), (171, 3), (175, 3), (171, 100)):
        c8, p8, oracle = patch_pairs(n, 25 if keep == 100 else 1, seed=50 + n + keep)
        c, p = on(c8[:keep]).float(), on(p8[:keep]).float()
        errs.append(compare_pc(kernel, twin, c, p, f"E n={n} P={keep} in chunks of "
                               f"{ck._chunk(keep, ck.pcfu_scratch_bytes(n))} (staged)", oracle[:keep]))
    c, p = batches[480]
    chunk = ck._chunk(c.shape[0], ck.pcfu_scratch_bytes(480))
    check(chunk < c.shape[0], f"E n=480: one chunk of {chunk} pairs")
    # the library's forward GEMMs may sum in another order for another
    # batch, so a pair alone agrees with itself in the batch within SHIFT_TOL
    whole = kernel(c, p)[0]
    one = kernel(c[5:6].contiguous(), p[5:6].contiguous())[0]
    gap = float((one - whole[5:6]).abs().max())
    check(gap <= SHIFT_TOL, f"E n=480: P=1 differs by {gap} px from the same pair in {c.shape[0]} "
          f"pairs in chunks of {chunk}")
    say(f"  n=480: {c.shape[0]} pairs in chunks of {chunk}; P=1 within {gap:.3g} px of the same pair "
        f"in the batch")
    for n in (120, 171, 480):
        zero = torch.zeros((2, n, n), dtype=torch.float32, device=dev)
        zs, zm = (x.cpu().numpy() for x in kernel(zero, zero))
        check(np.all(zs == -(n // 2)) and np.all(zm == 0.0), f"E n={n}: zero patches give {zs[0]}, {zm[0]}")
        c, p = batches[n]
        c = c[:4].clone()
        p = p[:4].clone()
        c[1, n // 3, n // 2] = float("nan")  # a NaN pixel in pair 1
        c[2] = 0.0  # pair 2: curr zero, a surface of ties
        p[3] = 0.0  # pair 3: prev zero
        ns, nm = (x.cpu().numpy() for x in kernel(c, p))
        check(np.isnan(ns[1]).all() and np.isnan(nm[1]), f"E n={n}: NaN pair gives {ns[1]}, {nm[1]}")
        check(np.isfinite(ns[0]).all() and np.all(ns[2:] == -(n // 2)) and np.all(nm[2:] == 0.0),
              f"E n={n}: {ns[0]}, one-sided zero pairs give {ns[2:]}, {nm[2:]}")
        errs.append(compare_pc(kernel, twin, c, p, f"E n={n} NaN/one-sided zero"))
    say("  zero, NaN and one-sided zero pairs at n = 120, 171 and 480 as the twin: exactly -(n//2) "
        "with maxval 0")
    mc, mp = (on(x) for x in masked_pair(480, seed=7))
    errs.append(compare_pc(kernel, twin, mc, mp, "E n=480 masked, radius 55"))
    errs.append(compare_pc(kernel, twin, mc, mp, "E n=480 unmasked, radius 240", search_radius=240))
    masked = kernel(mc, mp)[0].cpu().numpy()[0]
    unmasked = kernel(mc, mp, search_radius=240)[0].cpu().numpy()[0]
    check(np.abs(masked - [10.0, 3.0]).max() < 0.5, f"E masked peak {masked}")
    check(np.abs(unmasked - [70.0, 0.0]).max() < 0.5, f"E unmasked peak {unmasked}")
    err = max(errs)

    c, p = batches[120]
    kernel.LAUNCHES = 0
    report = conformance.check(c, p, tolerance_px=CONFORMANCE_TOL)
    launches = kernel.LAUNCHES
    worst = max(report.values())
    say(f"  conformance.check on the card: {len(report)} pairs, worst {worst:.3g} px "
        f"({max(report, key=report.get)}); kernel E launches {launches}")
    check(len(report) == 10 and worst <= CONFORMANCE_TOL, f"conformance {report}")

    out = {"launches": launches, "err": err}
    for label, (n, pairs) in E_TIMED.items():
        c, p = (x[:pairs].contiguous() for x in batches[n])
        check(c.shape[0] == pairs, f"E [{label}]: {c.shape[0]} pairs")
        out[label] = time_fused(c, p, label)
    say(f"  max|shift - twin| {err:.3g} px")
    say("[11 kernel E] matches its twin and the oracle at n = 45 to 480, both designs; uint8, zero, "
        "NaN, tie, masked cases hold; conformance holds on the card")
    return out


def run_long_range_nodes(dev) -> tuple:
    """Phase 12.  Returns (kernel D's launches in node (b), the latency of
    each node)."""
    from mrs_optic_flow_tpu_torch.config import NodeConfig

    frames = render_frames(N_FRAMES, heights=LR_HEIGHTS)
    lr_frames = [i for i, h in enumerate(LR_HEIGHTS) if h < 1.0]
    modes = "".join("L" if h < 1.0 else "S" for h in LR_HEIGHTS[1:])
    check("SL" in modes and "LS" in modes, "the heights must cross takeoff_height both ways")
    latency = {}
    launches_d = 0
    # node (a) also runs the scale/rotation estimator, inside both steps
    for label, patch, name, sr in (
            ("long range (a) 480/120 + scale/rotation", 120, "phase_correlate_frames", True),
            ("long range (b) 480/60", 60, "phase_correlate_fullfused", False)):
        config = NodeConfig(long_range_mode="height_based", takeoff_height=1.0,
                            sample_point_size=patch, scale_rotation=sr)
        node, published, launches, lat = drive_node(dev, config, frames, label, heights=LR_HEIGHTS)
        latency[label] = lat
        short = [m for t, m in published if t == "velocity_out"]
        long_ = [m for t, m in published if t == "velocity_out_longrange"]
        diff = [m for t, m in published if t == "velocity_out_longrange_diff"]
        n_long = len([i for i in lr_frames if i > 0])
        check(len(long_) == len(diff) == n_long and len(short) == N_FRAMES - 1 - n_long,
              f"{label}: {len(short)} short-range and {len(long_)} long-range twists")
        # the first short-range twist is the first-frame copy (zero shift)
        v_short = np.array([tw.linear[:2] for tw in short[1:]])
        v_long = np.array([tw.linear[:2] for tw in long_[1:]])
        e_short = np.abs(v_short - np.array(V_TRUE)).max()
        e_long = np.abs(v_long - np.array(V_TRUE)).max()
        say(f"  {label}: {len(short)} short-range twists, max |v - truth| {e_short:.4f} m/s; "
            f"{len(long_)} long-range, max {e_long:.4f} m/s (diff topic max "
            f"{np.abs([tw.linear[:2] for tw in diff]).max():.3g}); modes {modes}")
        check(e_short <= TWIST_TOL, f"{label}: short-range twist error {e_short}")
        check(e_long <= LR_TWIST_TOL, f"{label}: long-range twist error {e_long}")
        check(all(tw.frame_id == "fcu" and tw.covariance[14] == 666.0 for tw in long_ + diff),
              f"{label}: long-range frame id or covariance")
        check(node.health["frames_processed"] == N_FRAMES - 1, node.health)
        check(launches[name] == N_FRAMES - 1, f"{label}: {launches[name]} {name} launches "
              f"for {N_FRAMES - 1} frames")
        if name == "phase_correlate_fullfused":
            check(launches["phase_correlate_frames"] == 0, f"{label}: kernel A launched")
            launches_d = launches[name]
        check_lr_scale_rotation(dev, node, frames, published, launches, sr, label)
    say("[12 long-range nodes] switch both ways; twists within budget; every frame through its kernel")
    return launches_d, latency


def check_lr_scale_rotation(dev, node, frames, published, launches, sr: bool, label: str) -> None:
    """Phase 12: with scale/rotation, one decode and one kernel B launch a
    processed frame, short and long range alike, each decode the one the
    estimator gives on its own on the node's gray windows (the scene only
    translates, so the decodes themselves carry no truth)."""
    import torch

    from mrs_optic_flow_tpu_torch.models.scale_rotation import ScaleRotationEstimator
    from mrs_optic_flow_tpu_torch.ops.preprocess import center_crop, to_grayscale

    msgs = [m for t, m in published if t == "scale_rotation_out"]
    if not sr:
        check(not msgs and launches["peak_refine_raw"] == 0, f"{label}: scale/rotation ran")
        return
    check(len(msgs) == N_FRAMES - 1, f"{label}: {len(msgs)} scale/rotation messages")
    check(launches["peak_refine_raw"] == N_FRAMES - 1,
          f"{label}: {launches['peak_refine_raw']} kernel B launches for {N_FRAMES - 1} frames")
    # frame 0 only primes the node: the estimator's first frame is frame 1
    est = ScaleRotationEstimator(node.scale_rotation_estimator.config, device=dev)
    state, direct = est.init_state(), []
    for frame in frames[1:]:
        gray = center_crop(to_grayscale(torch.from_numpy(frame).to(dev)), 480, 376)
        state, res = est.step(state, gray)
        direct.append([float(res.scale), float(res.rotation)])
    published_sr = np.array([[m["scale"], m["yaw_rate"] * DT] for m in msgs])
    err = float(np.abs(published_sr - np.array(direct)).max())
    say(f"  {label}: {len(msgs)} scale/rotation decodes, within {err:.3g} of the estimator on the "
        f"node's gray windows; kernel B launches {launches['peak_refine_raw']}")
    check(err <= SR_TWIN_TOL, f"{label}: published decodes differ from the estimator's by {err}")


def check_sad_large(dev) -> dict:
    """Phase 13: kernel C at S = 160 and 240 (R = 21), beyond the node's
    blocks: bit-identical to its twin on integer inputs and on a repeated
    run; timed.  Returns the times by S."""
    rng = np.random.default_rng(13)
    r = 21
    out = {}
    for s, g in ((160, 9), (240, 4)):
        curr, prev, _ = check_sad_exact(dev, rng, g, s, r)
        out[s] = time_sad(dev, curr, prev, s, r, f"[{g}, 43, 43] S={s}", library=True)
    say("[13 kernel C, large blocks] maps bit-identical to the twin")
    return out


TF32_TOL = 1e-6  # decodes, twists (m/s) and shifts (px) with TF32 on process-wide: unchanged


def tf32_sensitive_outputs(dev) -> dict:
    """What the port computes with float32 matrix products, each as one
    array: the scale/rotation decodes of 6 rotating and zooming frames (480²
    log-polar DFTs), the method-4 node's twists on 8 frames (3x3 geometry),
    kernel D's twin and kernel E (whose wrapper makes the forward spectra)
    on a 480 px pair."""
    import torch

    from mrs_optic_flow_tpu_torch.config import NodeConfig
    from mrs_optic_flow_tpu_torch.models.scale_rotation import (
        ScaleRotationConfig,
        ScaleRotationEstimator,
    )
    from mrs_optic_flow_tpu_torch.ops.cuda_kernels import (
        phase_correlate_fullfused_ref,
        phase_correlate_fused,
    )

    est = ScaleRotationEstimator(ScaleRotationConfig(), device=dev)
    state, decodes = est.init_state(), []
    for frame in render_affine(6, SR_STEP_DEG, SR_STEP_ZOOM):
        state, res = est.step(state, torch.from_numpy(frame).to(dev))
        decodes.append([float(res.scale), float(res.rotation)])
    node, published, _, _ = drive_node(dev, NodeConfig(), render_frames(8), "method 4 (TF32 phase)")
    twists = [list(tw.linear) + list(tw.angular) for t, tw in published if t == "velocity_out"]
    mc, mp = (torch.from_numpy(x).to(dev) for x in masked_pair(480, seed=7))
    return {
        "decodes": np.array(decodes),
        "twists": np.array(twists),
        "D twin": np.concatenate([x.cpu().numpy().ravel() for x in phase_correlate_fullfused_ref(mc, mp)]),
        "E": np.concatenate([x.cpu().numpy().ravel() for x in phase_correlate_fused(mc, mp)]),
    }


def check_tf32(dev) -> None:
    """Phase 14 (repair F6): with TF32 matrix products switched on for the
    whole process, every pinned contraction of the port still runs in full
    float32: decodes, twists and D's and E's twins unchanged.  Prints how far
    one unpinned 480² DFT matrix product lands under TF32, then restores the
    setting."""
    import torch

    from mrs_optic_flow_tpu_torch.ops.phase_correlate import _dft_tensors

    check(torch.get_float32_matmul_precision() == "highest", "TF32 phase: the default changed")
    before = tf32_sensitive_outputs(dev)
    x = torch.from_numpy(render_affine(1, 0.0, 1.0)[0].astype(np.float32)).to(dev)
    c, _ = _dft_tensors(480, dev)
    full = x @ c
    torch.set_float32_matmul_precision("high")  # TF32 on (allow_tf32 follows)
    try:
        unpinned = x @ c
        after = tf32_sensitive_outputs(dev)
        check(torch.get_float32_matmul_precision() == "high" and torch.backends.cuda.matmul.allow_tf32,
              "the pinned sites did not restore the caller's TF32 setting")
    finally:
        torch.set_float32_matmul_precision("highest")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 still on after the phase")
    rel = float((unpinned - full).abs().max() / full.abs().max())
    say(f"  an unpinned 480² DFT product under TF32: max |difference| {rel:.3g} of the largest entry")
    for key, want in before.items():
        got = after[key]
        same = np.array_equal(np.isnan(got), np.isnan(want))
        diff = float(np.nanmax(np.abs(got - want))) if got.size else 0.0
        say(f"  {key} with TF32 on: max |difference| {diff:.3g}"
            f"{' (bit-identical)' if np.array_equal(got, want, equal_nan=True) else ''}")
        check(got.shape == want.shape and same and diff <= TF32_TOL, f"TF32 changed the {key}")
    say("[14 TF32] decodes, twists and D's and E's twins unchanged with TF32 on; setting restored")


def check_route_constants() -> None:
    """Phase 2: the engines' route constant, kernels B's and C's geometry
    helpers and kernels D's and E's plans, routes, shared memory and scratch
    agree with the libraries' formulas and the device's limits."""
    import torch

    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    pcf = ck.load_library("phase_correlate_frames")
    sad = ck.load_library("sad_search")
    check(all(pcf.pcf_smem_bytes(n) == ck.pcf_smem_bytes(n) for n in range(1, 481)),
          "kernel A's shared memory formula")
    check(limit == ck.H100_SMEM_OPTIN_BYTES, f"the device allows {limit} B of shared memory a block")
    fits = [n for n in range(1, 481) if pcf.pcf_smem_bytes(n) + ck.STATIC_SMEM_BYTES <= limit]
    check(max(fits) == ck.PCF_MAX_PATCH, f"kernel A fits up to {max(fits)}, the engines route "
          f"up to {ck.PCF_MAX_PATCH}")
    props = torch.cuda.get_device_properties(0)
    sm_limit = props.shared_memory_per_multiprocessor
    # kernel C: the library's geometry is the wrapper's, and every block fits
    for g, s, r in ((1, 120, 21), (9, 120, 21), (16, 120, 21), (9, 160, 21), (4, 240, 21),
                    (9, 120, 0), (9, 8, 3), (1, 256, 32), (3, 1000, 5), (1, 40, 100)):
        geo = ck.sad_geometry(g, s, r)
        got = (sad.sad_smem_bytes(r, geo.xb), sad.sad_scratch_doubles(g, s, r, geo.xb),
               sad.sad_counters(g, s, r, geo.xb))
        check(got == (geo.smem, geo.scratch, geo.counters),
              f"kernel C's geometry at G={g} S={s} R={r}: library {got}, wrapper {geo}")
        check(geo.smem + ck.STATIC_SMEM_BYTES <= limit, f"kernel C at S={s} R={r}: {geo.smem} B")
    node = ck.sad_geometry(9, 120, 21)
    per_sm = sm_limit // (node.smem + ck.STATIC_SMEM_BYTES)
    check(per_sm >= 2, f"kernel C at the node's geometry: {per_sm} blocks an SM by shared memory")
    check(ck.SAD_FILL_BLOCKS == props.multi_processor_count
          and ck.PEAK_FILL_BLOCKS == 2 * props.multi_processor_count,
          f"fill targets {ck.SAD_FILL_BLOCKS}, {ck.PEAK_FILL_BLOCKS} for {props.multi_processor_count} SMs")
    # kernel D: route, plan and shared memory of the library are the wrapper's
    import ctypes

    pcff = ck.load_library("phase_correlate_fullfused")
    pcfu = ck.load_library("phase_correlate_fused")
    radices = (ctypes.c_int * 32)()
    for n in range(1, 481):
        stages = pcff.pcff_plan(n, radices)
        check(tuple(radices[:stages]) == ck.fft_plan(n), f"kernel D's plan of {n}: {list(radices[:stages])}")
        check(pcff.pcff_route(n) == (0 if ck.pcff_small(n) else 1), f"kernel D's route at n={n}")
        check(pcff.pcff_smem_bytes(n) == ck.pcff_smem_bytes(n), f"kernel D's shared memory at n={n}")
        check(pcff.pcff_scratch_bytes(n) == ck.pcff_scratch_bytes(n), f"kernel D's scratch at n={n}")
        check(ck.pcff_smem_bytes(n) + ck.STATIC_SMEM_BYTES <= limit, f"kernel D at n={n} does not fit")
        check(pcfu.pcfu_smem_bytes(n) == ck.pcfu_smem_bytes(n), f"kernel E's shared memory at n={n}")
        check(pcfu.pcfu_scratch_bytes(n) == ck.pcfu_scratch_bytes(n), f"kernel E's scratch at n={n}")
        check(ck.pcfu_smem_bytes(n) + ck.STATIC_SMEM_BYTES <= limit, f"kernel E at n={n} does not fit")
    peak_grid = {(p, n, r): ck.peak_split(p, n, r) for p, n, r in ((1, 480, 240), (4, 480, 240), (64, 120, 55))}
    occupancy = {n: pcf.pcf_blocks_per_sm(n) for n in range(8, ck.PCF_MAX_PATCH + 1, 8)}
    check(min(occupancy.values()) >= 1 and occupancy[120] >= 2,
          f"kernel A's blocks an SM by patch: {occupancy}")
    say(f"  kernel A takes patches up to {ck.PCF_MAX_PATCH} px ({ck.pcf_smem_bytes(ck.PCF_MAX_PATCH)} B "
        f"of {limit}), blocks an SM by patch {occupancy}; kernel C at the node's geometry: "
        f"{node.blocks} blocks of {node.threads} threads, {node.smem} B, {per_sm} an SM by shared "
        f"memory ({sm_limit} B an SM); kernel B (blocks a surface, rows a block): {peak_grid}; kernels D "
        f"and E: one block a pair up to n = {ck.PCFF_MAX_SMALL}, D's plans and routes, D's and E's "
        f"shared memory and scratch match for n = 1..480")


def compare_kernel_a(dev) -> None:
    """Phase 4, with ``--baseline phase_correlate_frames=PATH``: kernel A
    from ``csrc/`` against PATH, another source of kernel A with the same C
    interface, own times in turns at B = 1 and B = 4096 on the uint8 bench
    pairs; the two agree within SHIFT_TOL."""
    import torch

    from oracle import make_accuracy_pairs

    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck

    libs = {"baseline": BASELINES["phase_correlate_frames"],
            "kernel": ck.load_library("phase_correlate_frames")}
    prev_np, curr_np, _, _ = make_accuracy_pairs(np.random.default_rng(1), 64)
    reps = BENCH_BATCH // 64
    prev_all = torch.from_numpy(prev_np).to(dev).repeat(reps, 1, 1)
    curr_all = torch.from_numpy(curr_np).to(dev).repeat(reps, 1, 1)
    tab = ck._twiddles(120, dev)
    for b, n_reps in ((1, 200), (BENCH_BATCH, 5)):
        c, p = curr_all[:b].contiguous(), prev_all[:b].contiguous()

        def runner(lib):
            shift = torch.empty((b, 16, 2), dtype=torch.float32, device=dev)
            maxval = torch.empty((b, 16), dtype=torch.float32, device=dev)
            args = (c.data_ptr(), p.data_ptr(), 1, b, 480, 480, 120, 4, 55, 3, tab.data_ptr(),
                    shift.data_ptr(), maxval.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)

            def run():
                check(lib.pcf_phase_correlate_frames(*args) == 0, "launch failed")
                return shift
            return run

        runs = {name: runner(lib) for name, lib in libs.items()}
        err = float((runs["baseline"]() - runs["kernel"]()).abs().max())
        check(err <= SHIFT_TOL, f"baseline differs by {err} px")
        in_turns(f"kernel A B={b} (max|shift difference| {err:.2e} px)", runs, n_reps)


# --------------------------------------------------------------------------- #
# phase 20: the node's frame graphs                                            #
# --------------------------------------------------------------------------- #

#: phase 20's steady frames a mode, after the frame that primes the node and
#: its first-frame copy (taken eagerly)
GRAPH_FRAMES = 20
#: largest difference [m/s] between a replayed twist and the eager chain's:
#: half a unit in the sixth printed digit
GRAPH_TWIST_TOL = 5e-7
_A, _B, _C, _D = ("phase_correlate_frames", "peak_refine_raw", "sad_search",
                  "phase_correlate_fullfused")
#: the kernels each mode of ``scripts/profile_torch_node.py`` launches on its
#: steady frames, each at least once a frame; every other kernel launches
#: none.  A patch that is not a multiple of 8 (60, 150) takes D; ``backend:
#: fft`` computes its surfaces with cuFFT and takes B for their peaks;
#: ``use_pallas: false`` takes none of the hand kernels
GRAPH_KERNELS = {
    "method4": {_A}, "method4_sr": {_A, _B}, "method3": {_C}, "method5": {_C},
    "lr_only_120": {_A}, "lr_only_60": {_D}, "sr_only_60": {_D},
    "switching_120_sr": {_A, _B}, "switching_60": {_D},
    "method3_ransac": {_C}, "method5_average": {_C}, "method5_ransac": {_C},
    "scale_0.8": {_D}, "scale_1.5": {_A}, "raw_off": {_A}, "fft_sr": {_B}, "plain": set(),
    "float_frames": {_A}, "sr_bilinear": {_A, _B}, "lr_ratio_2": {_A},
}


def eager_chain(node):
    """``node`` with the eager chain its graphs replace: the frame and the
    packed parameters uploaded from pageable memory, the chain's step on
    the node's carries, the states taken by reference, the summary read
    back, each operation launched from the host."""
    import torch

    def run_chain(img, channels, params, cx_eff, simple, long_range):
        gray = node._gray(torch.from_numpy(np.array(img)).to(node.device), channels, cx_eff)
        p = torch.from_numpy(params).to(node.device)
        if simple:
            states = node._frame_step_simple(gray, p)
        elif long_range:
            states = node._frame_step_lr(gray, p)
        else:
            states = node._frame_step(gray, p, cx_eff)
        node.flow_state, node.scale_rot_state, summary, flow = states
        return summary.cpu(), gray, flow

    node._run_chain = run_chain
    return node


def counted_syncs(fn):
    """``fn()`` with the host's synchronisations with the card counted
    (``torch.cuda.set_sync_debug_mode("warn")``, as the bench counts them):
    ``(its result, the count)``."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchronizing" in str(w.message) for w in caught)


def capture_watch(made: list):
    """Wraps the kernels' lazy set-up (libraries, twiddle and DFT tables,
    merge counters, grayscale weights, log-polar taps) so that each one
    made while a CUDA graph is being captured is named in ``made``: the
    eager run before each capture must have made them all.  Returns the
    undo."""
    import torch

    from mrs_optic_flow_tpu_torch.ops import cuda_kernels, logpolar, phase_correlate, preprocess

    undo = []

    def cached(mod, name):
        orig = getattr(mod, name)

        def wrapped(*args):
            misses = orig.cache_info().misses
            out = orig(*args)
            if torch.cuda.is_current_stream_capturing() and orig.cache_info().misses > misses:
                made.append(f"{name}{args[:1]}")
            return out

        wrapped.cache_info = orig.cache_info
        setattr(mod, name, wrapped)
        undo.append((mod, name, orig))

    for mod, name in ((cuda_kernels, "load_library"), (cuda_kernels, "_twiddles"),
                      (cuda_kernels, "_dft_blocks"), (phase_correlate, "_dft_tensors"),
                      (preprocess, "_gray_weights"), (logpolar, "_device_table")):
        cached(mod, name)
    counters = cuda_kernels._counters

    def counters_wrapped(name, device, n):
        before = dict(cuda_kernels._COUNTERS)
        buf = counters(name, device, n)
        if torch.cuda.is_current_stream_capturing() and all(buf is not b for b in before.values()):
            made.append(f"_counters({name})")
        return buf

    cuda_kernels._counters = counters_wrapped
    undo.append((cuda_kernels, "_counters", counters))

    def restore():
        for mod, name, orig in undo:
            setattr(mod, name, orig)

    return restore


def graph_mode(dev, name: str) -> dict:
    """Phase 20, one mode of ``scripts/profile_torch_node.py``: a node on
    its graphs and one on the eager chain, both warmed up, fed the same
    ``GRAPH_FRAMES`` steady frames in turns."""
    import torch

    from mrs_optic_flow_tpu_torch.config import NodeConfig
    from scripts.profile_torch_node import MODES, frames_for

    fields, scene, height = MODES[name]
    frames, heights = frames_for(scene, 2 + GRAPH_FRAMES, height)
    config = NodeConfig(**fields)
    pub = {"graph": [], "eager": []}
    nodes = {"graph": level_node(dev, config, pub["graph"]),
             "eager": eager_chain(level_node(dev, config, pub["eager"]))}
    made: list = []
    restore = capture_watch(made)
    try:
        for node in nodes.values():
            node.warmup()
    finally:
        restore()
    check(not made, f"{name}: made while capturing: {made}")
    runner = nodes["graph"]._graphs
    check(runner.captures == (4 if config.method == 4 else 2), f"{name}: {runner.captures} captures")
    wrappers = kernel_wrappers()
    launches = {k: dict.fromkeys(wrappers, 0) for k in nodes}
    syncs = dict.fromkeys(nodes, 0)
    # the engine's raw window shifts from the flow each chain returns, read
    # after the frame (outside its counted synchronisations): a mode without
    # raw_output publishes none
    flows = {k: [] for k in nodes}
    for label, node in nodes.items():
        def run_chain(*args, _run=node._run_chain, _out=flows[label]):
            out = _run(*args)
            _out.append(out[2])
            return out

        node._run_chain = run_chain
    raw = {k: [] for k in nodes}
    replays, captures = runner.replays, runner.captures
    for i, (frame, h) in enumerate(zip(frames, heights)):
        for label, node in nodes.items():
            if i < 2:  # the frame that primes the node, then the first-frame copy
                feed_frame(node, i, frame, h)
                continue
            for fn in wrappers.values():
                fn.LAUNCHES = 0
            flows[label].clear()
            _, n = counted_syncs(lambda: feed_frame(node, i, frame, h))
            syncs[label] += n
            for k, fn in wrappers.items():
                launches[label][k] += fn.LAUNCHES
            raw[label] += [f.shifts_raw.cpu().numpy() for f in flows[label]]

    def topic(label, t):
        return [m for tp, m in pub[label] if tp == t]

    # the raw window shifts, frame by frame (a long-range frame has fewer windows)
    check(len(raw["graph"]) == len(raw["eager"]) == GRAPH_FRAMES,
          f"{name}: {len(raw['graph'])} chain runs in {GRAPH_FRAMES} frames")
    check(all(a.shape == b.shape and np.array_equal(a, b, equal_nan=True)
              for a, b in zip(raw["graph"], raw["eager"])), f"{name}: the engine's raw shifts differ")
    published = [topic(k, "points_raw_out") for k in nodes]
    check(len(published[0]) == len(published[1]) == (1 + GRAPH_FRAMES if config.raw_output else 0),
          f"{name}: {len(published[0])} raw shift messages")
    check(all(a.shape == b.shape and np.array_equal(a, b, equal_nan=True) for a, b in zip(*published)),
          f"{name}: raw window shifts differ")
    twist = 0.0
    n_twists = 0
    for t in ("velocity_out", "velocity_out_longrange", "velocity_out_longrange_diff"):
        a, b = topic("graph", t), topic("eager", t)
        check([m.stamp for m in a] == [m.stamp for m in b], f"{name}: {t} stamps differ")
        for x, y in zip(a, b):
            u, v = np.array(x.linear + x.angular), np.array(y.linear + y.angular)
            check(np.array_equal(np.isnan(u), np.isnan(v)), f"{name}: {t} NaN differs at {x.stamp}")
            if not np.isnan(u).all():
                twist = max(twist, float(np.nanmax(np.abs(u - v))))
        n_twists += len(a)
    sr_a, sr_b = (np.array([[m[k] for k in ("scale", "vz", "yaw_rate")] for m in topic(label, "scale_rotation_out")],
                           np.float64).reshape(-1, 3) for label in nodes)
    check(sr_a.shape == sr_b.shape and np.array_equal(np.isnan(sr_a), np.isnan(sr_b)),
          f"{name}: scale/rotation messages")
    sr = float(np.nanmax(np.abs(sr_a - sr_b))) if np.isfinite(sr_a).any() else 0.0
    check(n_twists >= GRAPH_FRAMES, f"{name}: {n_twists} twists for {GRAPH_FRAMES + 1} frames")
    check(twist <= GRAPH_TWIST_TOL and sr <= GRAPH_TWIST_TOL,
          f"{name}: replayed twists differ from the eager chain's by {twist} m/s, decodes by {sr}")
    check(launches["graph"] == launches["eager"],
          f"{name}: launches {launches['graph']} replayed, {launches['eager']} eager")
    expected = GRAPH_KERNELS[name]
    check(all(launches["graph"][k] >= GRAPH_FRAMES if k in expected else launches["graph"][k] == 0
              for k in wrappers),
          f"{name}: launches {launches['graph']}, expected {sorted(expected)} each frame and no other")
    check(syncs["graph"] == GRAPH_FRAMES, f"{name}: {syncs['graph']} host synchronisations in {GRAPH_FRAMES} frames")
    check(runner.replays - replays == GRAPH_FRAMES and runner.captures == captures,
          f"{name}: {runner.replays - replays} replays, {runner.captures - captures} captures")
    # every replay advanced the RANSAC generator as the eager chain's frame did
    check(torch.equal(nodes["graph"]._gen.get_state(), nodes["eager"]._gen.get_state()),
          f"{name}: the generators' states differ")
    p50 = {k: float(np.median(topic(k, "processing_latency_out")[2:])) * 1e3 for k in nodes}
    row = {"twist_diff_mps": twist, "decode_diff": sr, "twists": n_twists,
           "syncs_per_frame": syncs["graph"] / GRAPH_FRAMES,
           "eager_syncs_per_frame": syncs["eager"] / GRAPH_FRAMES,
           "p50_ms": p50["graph"], "eager_p50_ms": p50["eager"],
           "launches": {k: v for k, v in launches["graph"].items() if v},
           "launches_per_frame": {k: v / GRAPH_FRAMES for k, v in launches["graph"].items() if v}}
    say(f"  {name}: {json.dumps(row)}")
    return row


def refused_capture(dev) -> dict:
    """Phase 20: a capture that raises fails its frame, and the node's next
    frame tries to capture again: no frame falls back to the eager chain."""
    import torch

    from mrs_optic_flow_tpu_torch.config import NodeConfig
    from mrs_optic_flow_tpu_torch.runtime.msgs import CameraInfo
    from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode

    logs, published = [], []
    node = OpticFlowNode(NodeConfig(), device=dev, publish=lambda t, m: published.append((t, m)),
                         log=logs.append)
    node.on_camera_info(CameraInfo(k=[FX, 0, 376.0, 0, FY, 240.0, 0, 0, 1], d=[0.0] * 5))
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    step = node._frame_step

    def refusing(*args):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("capture refused")
        return step(*args)

    node._frame_step = refusing
    frames = render_frames(5)
    out = [feed_frame(node, i, frames[i]) for i in range(4)]
    node._frame_step = step
    out.append(feed_frame(node, 4, frames[4]))
    failed = [s for s in logs if "capture refused" in s]
    row = {"twists": [tw is not None for tw in out], "captures": node._graphs.captures,
           "failure_logs": len(failed)}
    say(f"  refused capture: {json.dumps(row)}; {failed[:1]}")
    check(row["twists"] == [False, True, False, False, True], f"refused capture: {row}")
    check(row["captures"] == 1 and failed, f"refused capture: {row}")
    return row


def run_frame_graphs(dev) -> dict:
    """Phase 20.  Returns its line's object."""
    import torch

    from scripts.profile_torch_node import MODES

    t0 = time.perf_counter()
    # a process's first synchronisation warning is recorded twice (a bare
    # wait counts 2, the next 1): spend it here, so that each frame's count
    # below is the frame's own
    _, first = counted_syncs(lambda: torch.cuda.current_stream(dev).synchronize())
    _, bare = counted_syncs(lambda: torch.cuda.current_stream(dev).synchronize())
    check(bare == 1, f"a bare wait counts {bare} synchronisations")
    say(f"  a bare wait on the stream counts {first}, then {bare}")
    out = {name: graph_mode(dev, name) for name in MODES}
    out["refused_capture"] = refused_capture(dev)
    out["seconds"] = time.perf_counter() - t0
    say(f"[20 frame graphs] {out['seconds']:.1f} s: replays equal the eager chain in "
        f"{len(MODES)} modes, one host synchronisation a frame; " + json.dumps(out))
    return out


# --------------------------------------------------------------------------- #
# phase 15: serving                                                            #
# --------------------------------------------------------------------------- #

#: phase 15(a)'s per-pair velocities [m/s], pair i at SERVING_V[i % 8]
SERVING_V = [(0.8, -0.5), (-0.6, 0.3), (0.2, 0.9), (-0.9, -0.4),
             (0.5, 0.5), (0.0, -0.8), (0.7, 0.1), (-0.3, -0.2)]
SERVING_OK_SHARE = 0.95  # of the pairs at least
SERVING_BATCH = 512  # ServingLoop's batch
SERVING_REQUESTS = 4096
SERVING_SUB = 64  # pairs of the per-pair get_rt comparison
#: getRT batched against per pair on the same hypotheses, float32: the twist
#: parity of tests/test_torch_node.py (the float32 decomposition moves tran
#: by up to 9e-4 m/s between the two chains, tests/test_torch_batched_geometry.py)
TRAN_PARITY = 1e-3  # m/s
#: the same in float64: tran [m/s] and rot (tests/test_torch_batched_geometry.py
#: holds both chains to 1e-9 there)
F64_PARITY = 1e-4
FLEET_STREAMS = 128
FLEET_TICKS = 10
#: phase 15(c): stream i's integer pixel flow a tick and its height
FLEET_D = [(-8, 5), (6, -3), (-2, -7), (7, 4), (-5, 0), (0, 6), (3, -8), (-4, -4)]
FLEET_H = [1.5, 2.0, 2.5]
FLEET_MASKED = (3, 5)  # (tick, stream) without a frame
FLEET_RESET = (6, 7)  # (tick, stream) reset just before the tick
LR_FLEET_HEIGHT = 0.8  # m
LR_FLEET_TILT = (0.1, -0.08)  # roll, pitch [rad]
LR_FLEET_TICKS = 8
SR_FLEET_STREAMS = 16
SR_FLEET_STEPS = [(2.0, 1.02), (-1.5, 1 / 1.02), (1.0, 1.01), (-2.5, 1.0)]  # (deg, zoom) a tick
SR_FUSED_TOL = 1e-4
def reset_launches() -> dict:
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.LAUNCHES = 0
    return wrappers


@functools.lru_cache(maxsize=1)
def serving_pairs() -> tuple:
    """Phase 5's texture as uint8 480² pairs, one a velocity of
    ``SERVING_V`` at ``HEIGHT`` and ``DT`` (content moved by ``-f v dt / h``,
    an exact Fourier shift), each class on its own part of the texture.
    Returns (prev [K, 480, 480], curr [K, 480, 480], v [K, 2])."""
    from oracle import fourier_shift, smooth_random_image

    tex = smooth_random_image(np.random.default_rng(0), 1024, cutoff=0.25)
    prev, curr = [], []
    for k, (vx, vy) in enumerate(SERVING_V):
        base = np.roll(tex, (61 * k, 97 * k), (0, 1))
        moved = fourier_shift(base, -FX * vx * DT / HEIGHT, -FY * vy * DT / HEIGHT)
        for out, img in ((prev, base), (curr, moved)):
            out.append(np.clip(np.rint(img[:480, :480]), 0, 255).astype(np.uint8))
    return np.stack(prev), np.stack(curr), np.array(SERVING_V)


def worst_err(tran: np.ndarray, truth: np.ndarray, ok: np.ndarray) -> float:
    """Largest ``|v - truth|`` in x or y over the ok rows (0 with none)."""
    err = np.abs(tran[:, :2] - truth).max(axis=1)[ok]
    return float(err.max()) if err.size else 0.0


def check_pipeline_batch(dev, pipe, prev, curr, truth, gen) -> dict:
    """Phase 15(a): ``step_pre`` on the batch under the no-sync block, the
    twists against the truth, and the first ``SERVING_SUB`` pairs' geometry
    against the per-pair ``get_rt`` on the same hypotheses."""
    import torch

    from mrs_optic_flow_tpu_torch.geometry.batched import draw_gumbel, get_rt_batch, gumbel_top4
    from mrs_optic_flow_tpu_torch.geometry.motion import get_rt

    b = prev.shape[0]
    heights = torch.full((b,), HEIGHT, device=dev)
    dts = torch.full((b,), DT, device=dev)
    rates = torch.zeros((b, 4), device=dev)
    rates[:, 3] = 1.0
    c2b = rates[0].clone()
    iters, p = pipe.ransac_iterations, pipe.engine.num_windows
    gumbel = draw_gumbel(iters, p, b, dev, gen)
    pipe.step_pre(prev[:4], curr[:4], heights[:4], dts[:4], rates[:4], c2b, generator=gen)  # warm-up
    wrappers = reset_launches()
    with no_host_sync(dev):
        out = pipe.step_pre(prev, curr, heights, dts, rates, c2b, gumbel=gumbel)
    launches = {k: fn.LAUNCHES for k, fn in wrappers.items()}
    check(launches["phase_correlate_frames"] == 1, f"step_pre launches {launches}")
    ok = out.ok.cpu().numpy()
    tran = out.tran.cpu().numpy()
    emax = worst_err(tran, truth, ok)
    say(f"  step_pre B={b}: {ok.mean():.4f} of the pairs ok, max |v - truth| {emax:.4f} m/s, "
        f"no host sync before the readback")
    check(ok.mean() >= SERVING_OK_SHARE, f"{ok.mean():.4f} of the pairs ok")
    check(emax <= TWIST_TOL, f"twist errors up to {emax} m/s")

    s = SERVING_SUB
    shifts = out.shifts[:s]
    g = gumbel[:, :, :s].contiguous()
    top4 = gumbel_top4(g, torch.isfinite(shifts).all(-1).T)
    parity = {}
    for dtype in (torch.float32, torch.float64):
        # the same sub-batch through the batched and the per-pair chains, on
        # the same hypotheses, neither reading anything back
        x = dict(shifts=shifts.to(dtype), heights=heights[:s].to(dtype), dts=dts[:s].to(dtype),
                 cam=pipe._cam.to(dtype), c2b=c2b.to(dtype), rates=rates[:s].to(dtype))
        kw = dict(frame_size=pipe.frame_size, patch=pipe.sample_point_size, ransac_iterations=iters)
        with no_host_sync(dev):
            sub = get_rt_batch(x["shifts"], x["heights"], x["dts"], pipe.ul_x, x["cam"], pipe._dist,
                               x["c2b"], x["rates"], gumbel=g, **kw)
            ones = [get_rt(x["shifts"][i], x["heights"][i], x["dts"][i], pipe.ul_x, x["cam"], pipe._dist,
                           x["c2b"], x["rates"][i], hyp_idx=top4[:, :, i], **kw) for i in range(s)]
        sub_ok, sub_n, sub_tran, sub_rot = (v.cpu().numpy() for v in (sub.ok, sub.n_inliers, sub.tran, sub.rot))
        one_ok, one_n, one_tran, one_rot = (torch.stack(v).cpu().numpy() for v in zip(
            *((o.ok, o.n_inliers, o.tran, o.rot) for o in ones)))
        check(np.array_equal(one_ok, sub_ok) and np.array_equal(one_n, sub_n),
              f"{dtype}: per-pair ok/n_inliers {one_ok}/{one_n}, batched {sub_ok}/{sub_n}")
        tran_diff = float(np.abs(one_tran - sub_tran)[sub_ok].max(initial=0.0))
        rot_diff = float(np.abs(one_rot - sub_rot)[sub_ok].max(initial=0.0))
        parity[str(dtype).split(".")[-1]] = {"tran": tran_diff, "rot": rot_diff}
        if dtype == torch.float32:
            check(np.array_equal(sub_ok, ok[:s]), "the sub-batch's ok differs from the batch's")
            batch_diff = float(np.nanmax(np.abs(sub_tran - tran[:s])))
            check(tran_diff <= TRAN_PARITY and batch_diff <= TRAN_PARITY,
                  f"float32 tran differs by {tran_diff}, {batch_diff}")
        else:
            check(tran_diff <= F64_PARITY and rot_diff <= F64_PARITY,
                  f"float64 tran differs by {tran_diff}, rot by {rot_diff}")
    say(f"  get_rt_batch on {s} pairs against the per-pair get_rt on the same hypotheses, neither "
        f"synchronising the host: ok and n_inliers equal; float32 max |tran difference| "
        f"{parity['float32']['tran']:.3g} m/s (against the whole batch's {batch_diff:.3g}), |rot| "
        f"{parity['float32']['rot']:.3g}; float64 {parity['float64']['tran']:.3g} and "
        f"{parity['float64']['rot']:.3g}")
    return {"ok_share": float(ok.mean()), "max_twist_err": emax, "get_rt_parity": parity}


def measure_pipeline(dev, pipe, prev, curr, gen) -> dict:
    """Phase 15(b), ``step_pre`` at the batch, one call in flight."""
    import torch

    b = prev.shape[0]
    heights, dts = torch.full((b,), HEIGHT, device=dev), torch.full((b,), DT, device=dev)
    rates = torch.zeros((b, 4), device=dev)
    rates[:, 3] = 1.0
    c2b = rates[0].clone()

    def call():
        return pipe.step_pre(prev, curr, heights, dts, rates, c2b, generator=gen)

    ms = timed_calls(call, 5)
    split = device_split(call, ms)
    out = {"ms": ms, "frame_pairs_per_s": b / ms * 1e3, **split}
    say(f"  step_pre B={b}: {ms:.3f} ms = {out['frame_pairs_per_s']:.1f} frame-pairs/s; device "
        f"{split['device_ms']:.3f} ms (kernel A {split['kernel_a_ms']:.3f}, geometry "
        f"{split['geometry_ms']:.3f}, rest {split['rest_ms']:.3f}), {split['launches']} launches, "
        f"idle {split['idle_share']:.3f}; the trace held {split['kernel_a_in_trace']} of kernel A's 2 "
        f"launches (its time is their median)")
    return out


def measure_serving_loop(dev, pipe, prev_np, curr_np, truth) -> dict:
    """Phase 15(b), ``ServingLoop`` over ``SERVING_REQUESTS`` requests at
    depths 1 and 8; the dispatch of one batch under the no-sync block."""
    import torch

    from mrs_optic_flow_tpu_torch.runtime.serving import ServingLoop, ServingRequest

    k = len(truth)
    reqs = [ServingRequest(prev=prev_np[i % k], curr=curr_np[i % k], height=HEIGHT, dt=DT)
            for i in range(SERVING_REQUESTS)]
    want = truth[np.arange(SERVING_REQUESTS) % k]
    out = {}
    for depth in (1, 8):
        loop = ServingLoop(pipe, batch_size=SERVING_BATCH, depth=depth, seed=depth)
        list(loop.run(reqs[:SERVING_BATCH * depth]))  # warm-up: every staging slot allocated
        wrappers = reset_launches()
        t0 = time.perf_counter()
        with no_host_sync(dev):
            pending = loop._dispatch(reqs[:SERVING_BATCH])
        dispatch_ms = (time.perf_counter() - t0) * 1e3  # the host's part: staging and launches
        check(wrappers["phase_correlate_frames"].LAUNCHES == 1, "dispatch launches")
        loop._collect(*pending)
        wrappers = reset_launches()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        res = list(loop.run(reqs))
        stop.record()
        stop.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ms = start.elapsed_time(stop)
        batches = SERVING_REQUESTS // SERVING_BATCH
        check(wrappers["phase_correlate_frames"].LAUNCHES == batches,
              f"depth {depth}: {wrappers['phase_correlate_frames'].LAUNCHES} kernel A launches "
              f"for {batches} batches")
        ok = np.array([r.ok for r in res])
        emax = worst_err(np.array([r.tran for r in res]), want, ok)
        check(len(res) == SERVING_REQUESTS and ok.mean() >= SERVING_OK_SHARE and emax <= TWIST_TOL,
              f"depth {depth}: {len(res)} results, {ok.mean()} ok, max err {emax}")
        prof_batches = 2
        prof_reqs = reqs[:prof_batches * SERVING_BATCH]
        by = own_by_kernel(lambda: list(loop.run(prof_reqs)), 1)
        a_by = [v for name, v in by.items() if A_KERNEL.search(name)]
        check(len(a_by) == 1, f"kernel A in the trace: {a_by}")
        a_ms = a_by[0][1] / a_by[0][0]  # its median launch, one a batch (see device_split)
        by = {name: v for name, v in by.items() if not A_KERNEL.search(name)}
        dev_ms = sum(v for _, v in by.values()) / prof_batches + a_ms
        copy_ms = sum(v for name, (_, v) in by.items() if "Memcpy" in name) / prof_batches
        per_batch = ms / batches
        out[depth] = {"ms": ms, "wall_ms": wall, "frame_pairs_per_s": SERVING_REQUESTS / ms * 1e3,
                      "device_ms_per_batch": dev_ms, "kernel_a_ms_per_batch": a_ms,
                      "copy_ms_per_batch": copy_ms, "dispatch_host_ms": dispatch_ms,
                      "launches_per_batch": sum(n for n, _ in by.values()) / prof_batches + 1,
                      "idle_share": max(0.0, 1.0 - dev_ms / per_batch)}
        say(f"  ServingLoop batch {SERVING_BATCH} depth {depth}: {SERVING_REQUESTS} requests in "
            f"{ms:.1f} ms = {out[depth]['frame_pairs_per_s']:.1f} frame-pairs/s ({ok.mean():.4f} ok, "
            f"max |v - truth| {emax:.4f} m/s); a batch: {per_batch:.3f} ms, its dispatch "
            f"{dispatch_ms:.3f} ms of host time, device {dev_ms:.3f} ms "
            f"(kernel A {a_ms:.3f}, copies {copy_ms:.3f}), {out[depth]['launches_per_batch']:.0f} "
            f"launches, idle {out[depth]['idle_share']:.3f}")
    return out


def fleet_frames(tex, t: int, n: int, lost=()) -> np.ndarray:
    """BGR 752x480 frames of ``n`` streams at tick ``t``: stream i's view of
    the texture moved by ``t * FLEET_D[i % 8]`` px (exact integer shifts of
    the periodic texture), each stream on its own part of it."""
    frames = np.empty((n, 480, 752, 3), np.uint8)
    for i in range(n):
        dx, dy = FLEET_D[i % len(FLEET_D)]
        view = np.roll(tex, (t * dy + 29 * i, t * dx + 43 * i), (0, 1))[:480, :752]
        frames[i] = view[..., None]
    return frames


def fleet_truth(n: int, heights: np.ndarray) -> np.ndarray:
    """Each stream's velocity [m/s]: ``-d h / (f dt)`` for its flow ``d``
    a tick of ``DT``, over however many ticks its pair spans."""
    d = np.array([FLEET_D[i % len(FLEET_D)] for i in range(n)], float)
    return -d * heights[:, None] / FX / DT


def run_fleets(dev) -> dict:
    """Phase 15(c) and (d): the fleet of ``FLEET_STREAMS`` streams with a
    masked stream, a reset and a checkpoint round trip, the long-range
    fleet, the scale/rotation fleets fused and unfused, and the feeder."""
    import tempfile
    import threading

    from oracle import smooth_random_image

    from mrs_optic_flow_tpu_torch.models import ScaleRotationEstimator
    from mrs_optic_flow_tpu_torch.parallel import BatchPipeline
    from mrs_optic_flow_tpu_torch.runtime import FleetFeeder, FleetServer

    n = FLEET_STREAMS
    tex = np.clip(np.rint(smooth_random_image(np.random.default_rng(0), 1024, cutoff=0.25)), 0,
                  255).astype(np.uint8)
    cam = np.array([[FX, 0, 376.0], [0, FY, 240.0], [0, 0, 1]], np.float32)
    pipe = BatchPipeline(camera_matrix=cam, dist_coeffs=np.zeros(5, np.float32), device=dev)
    heights = np.array([FLEET_H[i % len(FLEET_H)] for i in range(n)])
    out = {}

    # (c) the short-range fleet
    fleet = FleetServer(pipe, n, seed=1)
    a = kernel_wrappers()["phase_correlate_frames"]
    tick_ms, n_ok, n_valid, worst = [], 0, 0, 0.0
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        for t in range(FLEET_TICKS):
            if t == FLEET_RESET[0]:
                fleet.reset(FLEET_RESET[1])
            mask = np.ones(n, bool)
            if t == FLEET_MASKED[0]:
                mask[FLEET_MASKED[1]] = False
            frames = fleet_frames(tex, t, n)
            ck = str(pathlib.Path(tmp) / "fleet")
            if t == FLEET_TICKS - 2:
                fleet.save_state(ck)
            a.LAUNCHES = 0
            t0 = time.perf_counter()
            tick = fleet.tick(frames, np.full(n, t * DT), heights, mask=mask).materialize()
            if t:
                tick_ms.append((time.perf_counter() - t0) * 1e3)
                check(a.LAUNCHES == 1, f"tick {t}: {a.LAUNCHES} kernel A launches")
            expect = mask & (t > 0)
            if t == FLEET_RESET[0]:
                expect[FLEET_RESET[1]] = False
            check(not (tick.ok & ~expect).any(), f"tick {t}: a stream without a valid pair is ok")
            emax = worst_err(tick.tran, fleet_truth(n, heights), tick.ok)
            check(emax <= TWIST_TOL, f"tick {t}: twist errors up to {emax}")
            n_ok, n_valid = n_ok + int(tick.ok.sum()), n_valid + int(expect.sum())
            worst = max(worst, emax)
            if t == FLEET_MASKED[0] + 1:
                s = FLEET_MASKED[1]
                check(abs(tick.dts[s] - 2 * DT) < 1e-9 and tick.ok[s], f"masked stream: dt {tick.dts[s]}")
            if t == FLEET_TICKS - 2:
                # a server restarted from the checkpoint saved before this tick
                resumed = FleetServer(pipe, n, seed=99)
                resumed.load_state(ck)
                again = resumed.tick(frames, np.full(n, t * DT), heights, mask=mask).materialize()
                check(np.array_equal(again.ok, tick.ok)
                      and np.allclose(again.tran, tick.tran, atol=1e-6, rtol=0, equal_nan=True),
                      "the resumed fleet's tick differs from the uninterrupted run's")
        check(n_ok >= SERVING_OK_SHARE * n_valid, f"{n_ok} of {n_valid} valid stream ticks ok")
    p50, p90 = np.percentile(tick_ms, 50), np.percentile(tick_ms, 90)
    say(f"  fleet {n} streams x {FLEET_TICKS} ticks: {n_ok} of {n_valid} valid stream ticks ok, max "
        f"|v - truth| {worst:.4f} m/s; masked stream's dt spans two ticks; reset regated; checkpoint "
        f"resumed to the same tick; tick p50 {p50:.3f} ms, p90 {p90:.3f} ms (upload of {n} BGR "
        f"frames to readback)")
    out["fleet"] = {"streams": n, "tick_p50_ms": p50, "tick_p90_ms": p90, "max_twist_err": worst}

    # (c) the long-range fleet: tilt-corrected heights
    lr = FleetServer(pipe, n, long_range=True)
    lr_h = np.full(n, LR_FLEET_HEIGHT)
    rolls, pitches = np.full(n, LR_FLEET_TILT[0]), np.full(n, LR_FLEET_TILT[1])
    tilt = 1.0 / (np.cos(LR_FLEET_TILT[0]) * np.cos(LR_FLEET_TILT[1]))
    lr_ms, lr_worst = [], 0.0
    for t in range(LR_FLEET_TICKS):
        frames = fleet_frames(tex, t, n)
        a.LAUNCHES = 0
        t0 = time.perf_counter()
        tick = lr.tick(frames, np.full(n, t * DT), lr_h, rolls=rolls, pitches=pitches).materialize()
        if t:
            lr_ms.append((time.perf_counter() - t0) * 1e3)
            check(a.LAUNCHES == 1, f"long-range tick {t}: {a.LAUNCHES} kernel A launches")
            emax = worst_err(tick.tran, fleet_truth(n, lr_h) * tilt, np.ones(n, bool))
            check(tick.ok.all() and emax <= LR_TWIST_TOL, f"long-range tick {t}: {tick.ok.sum()} ok, "
                  f"max err {emax}")
            lr_worst = max(lr_worst, emax)
    say(f"  long-range fleet {n} streams: every stream ok, max |v - truth| {lr_worst:.4f} m/s "
        f"(tilt-corrected); tick p50 {np.percentile(lr_ms, 50):.3f} ms, every tick "
        f"{[round(x, 3) for x in lr_ms]} ms")
    out["long_range_fleet"] = {"tick_p50_ms": float(np.percentile(lr_ms, 50)), "tick_ms": lr_ms,
                               "max_twist_err": lr_worst}

    # (c) scale/rotation fleets, fused and unfused (log-polar 480)
    m = SR_FLEET_STREAMS
    cam_sq = np.array([[FX, 0, 240.0], [0, FY, 240.0], [0, 0, 1]], np.float32)
    sr = ScaleRotationEstimator(device=dev)
    kw = dict(camera_matrix=cam_sq, dist_coeffs=np.zeros(5, np.float32), device=dev)
    fused = FleetServer(BatchPipeline(**kw, scale_rotation=sr), m, seed=2)
    plain = FleetServer(BatchPipeline(**kw), m, scale_rotation=sr, seed=2)
    check(fused._sr_fused and not plain._sr_fused, "fused / unfused")
    steps = [SR_FLEET_STEPS[i % len(SR_FLEET_STEPS)] for i in range(m)]
    seqs = [render_affine(3, deg, zoom, seed=i) for i, (deg, zoom) in enumerate(steps)]
    b = kernel_wrappers()["peak_refine_raw"]
    sr_rot_err = sr_scale_err = fused_diff = 0.0
    for t in range(3):
        frames = np.stack([s[t] for s in seqs])
        ticks = []
        for f in (fused, plain):
            a.LAUNCHES = b.LAUNCHES = 0
            ticks.append(f.tick(frames, np.full(m, t * DT), np.full(m, HEIGHT)).materialize())
            if t:
                check(a.LAUNCHES == 1 and b.LAUNCHES == 1, f"scale/rotation fleet tick {t}: A "
                      f"{a.LAUNCHES}, B {b.LAUNCHES} launches")
        if t:
            tf, tp = ticks
            rot_deg = np.rad2deg(tf.rotation)
            want_deg = np.array([d for d, _ in steps])
            want_scale = 1.0 / np.array([z for _, z in steps])
            sr_rot_err = max(sr_rot_err, float(np.abs(rot_deg - want_deg).max()))
            sr_scale_err = max(sr_scale_err, float(np.abs(tf.scale - want_scale).max()))
            fused_diff = max(fused_diff, float(np.abs(tf.rotation - tp.rotation).max()),
                             float(np.abs(tf.scale - tp.scale).max()))
    say(f"  scale/rotation fleet {m} streams: decodes within {sr_rot_err:.4f} deg and {sr_scale_err:.5f}; "
        f"fused against unfused {fused_diff:.3g}")
    check(sr_rot_err <= SR_ROT_TOL and sr_scale_err <= SR_SCALE_TOL, "scale/rotation decodes")
    check(fused_diff <= SR_FUSED_TOL, f"fused and unfused decodes differ by {fused_diff}")
    out["scale_rotation_fleet"] = {"streams": m, "rot_err_deg": sr_rot_err, "scale_err": sr_scale_err,
                                   "fused_vs_unfused": fused_diff}

    # (d) the feeder: a capture thread fills every ring past its capacity
    feeder = FleetFeeder(FleetServer(pipe, n, seed=3), frame_shape=(480, 752, 3), capacity=2)
    check(feeder.tick(heights) is None, "a tick with no frame")

    def capture(ticks):
        for t in ticks:
            frames = fleet_frames(tex, t, n)
            for i in range(n):
                feeder.push(i, frames[i], t * DT)

    th = threading.Thread(target=capture, args=([0, 1, 2, 3],))
    th.start()
    th.join(timeout=120)
    check(not th.is_alive(), "the capture thread did not finish")
    first = feeder.tick(heights).materialize()  # takes tick 1, skips 0; 2 and 3 were dropped
    check(feeder.dropped == 2 * n and feeder.frames_skipped == n and not first.ok.any(),
          f"dropped {feeder.dropped}, skipped {feeder.frames_skipped}")
    th = threading.Thread(target=capture, args=([4],))
    th.start()
    th.join(timeout=120)
    check(not th.is_alive(), "the capture thread did not finish")
    a.LAUNCHES = 0
    tick = feeder.tick(heights).materialize()
    check(a.LAUNCHES == 1, "feeder tick launches")
    emax = worst_err(tick.tran, fleet_truth(n, heights), tick.ok)
    check(tick.ok.mean() >= SERVING_OK_SHARE and emax <= TWIST_TOL and np.allclose(tick.dts, 3 * DT),
          f"feeder tick: {tick.ok.sum()} ok, max err {emax}")
    say(f"  feeder: {feeder.dropped} frames dropped and {feeder.frames_skipped} skipped for full rings "
        f"of 2; the next tick {tick.ok.sum()} of {n} ok over 3 ticks of motion, max |v - truth| "
        f"{emax:.4f} m/s")
    out["feeder"] = {"dropped": feeder.dropped, "skipped": feeder.frames_skipped}
    return out


def run_serving(dev) -> dict:
    """Phase 15.  Returns the ``serving`` line's object."""
    import torch

    from mrs_optic_flow_tpu_torch.parallel import BatchPipeline

    prev_np, curr_np, v = serving_pairs()
    k = len(v)
    cls = torch.arange(BENCH_BATCH) % k
    prev = torch.from_numpy(prev_np).to(dev)[cls.to(dev)]
    curr = torch.from_numpy(curr_np).to(dev)[cls.to(dev)]
    truth = v[cls.numpy()]
    cam = np.array([[FX, 0, 240.0], [0, FY, 240.0], [0, 0, 1]], np.float32)
    pipe = BatchPipeline(camera_matrix=cam, dist_coeffs=np.zeros(5, np.float32), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"pipeline": check_pipeline_batch(dev, pipe, prev, curr, truth, gen)}
    out["step_pre"] = measure_pipeline(dev, pipe, prev, curr, gen)
    del prev, curr
    torch.cuda.empty_cache()
    out["serving_loop"] = measure_serving_loop(dev, pipe, prev_np, curr_np, v)
    out.update(run_fleets(dev))
    say("[15 serving] step_pre, ServingLoop, fleets and feeder within budget")
    return out


# --------------------------------------------------------------------------- #
# phase 16: flights                                                            #
# --------------------------------------------------------------------------- #

#: tests/test_flightsim.py's budgets, (a) the level flight under both
#: long-range policies with takeoff_height 1.2 m
LEVEL_MODES = (("height_based", 2), ("takeoff_based", 1))
HOST_PRE_TWIST_TOL = 1e-6  # m/s, (e): host and device preprocessing, same pixels
#: (g) the CLI subprocesses: label -> (arguments, exit status wanted)
CLI_TIMEOUT_S = 300


class Flights:
    """Phase 16's flights through the port's ``FlightSimulator`` and node on
    ``dev`` at full width (752x480 renders, 480 crop, 4x4 windows of 120 px,
    ``configs/default.yaml`` through the port's ``load_config``).  Each
    profile is rendered once and flown as often as its checks need.  The
    launch counts are checked on a CUDA device only: on the CPU (a
    rehearsal) the wrappers run their twins and count nothing."""

    def __init__(self, dev):
        self.dev = dev
        self.rows = {}
        #: kernel -> its launches over every flight's frames, the fleet
        #: flight's included
        self.totals = dict.fromkeys(KERNELS, 0)

    def render(self, sim, label: str) -> list:
        t0 = time.perf_counter()
        frames = sim.frames()
        self.rows.setdefault(label, {})["render_s"] = time.perf_counter() - t0
        return frames

    def fly(self, sim, frames, label: str, c2b=(0.0, 0.0, 0.0, 1.0), stream_frames=None, **overrides):
        """One flight: a node from ``load_config(overrides=...)``, warmed up
        on the flight's camera, fed ``stream_frames`` (default ``frames``)
        in the flight's events.  Every kernel's count is set to 0 just
        before the frames and read just after: kernel A on every frame after
        the first, kernel B on every one too with scale/rotation.  Returns
        (node, published, report).  The row also counts ``native.gray_crop``
        calls over the frames (host preprocessing)."""
        from mrs_optic_flow_tpu_torch.runtime import FrameStream

        node, published = self.node(sim, c2b, **overrides)
        stream = FrameStream(node)
        sim.events_into(stream, frames if stream_frames is None else stream_frames)
        rep = self.measure(sim, label, node, published, stream.run)
        return node, published, rep

    def node(self, sim, c2b=(0.0, 0.0, 0.0, 1.0), **overrides):
        """A node on ``dev`` from ``load_config(overrides=...)``, its
        transforms set, warmed up on the flight's camera; (node, the list
        its publications go to)."""
        from mrs_optic_flow_tpu_torch.config import load_config
        from mrs_optic_flow_tpu_torch.runtime import OpticFlowNode

        published = []
        node = OpticFlowNode(load_config(overrides=overrides), device=self.dev,
                             publish=lambda t, m: published.append((t, m)), log=lambda s: None)
        node.set_transforms(c2b)
        node.on_camera_info(sim.scene.camera_info())
        node.warmup()
        return node, published

    def measure(self, sim, label: str, node, published, run):
        """``run()`` feeds ``node`` the flight.  Every kernel's count is set to
        0 just before and read just after: kernel A on every frame after the
        first, kernel B on every one too with scale/rotation.  Returns the
        report; the row also counts ``native.gray_crop`` calls (host
        preprocessing)."""
        from mrs_optic_flow_tpu_torch import native
        from mrs_optic_flow_tpu_torch.runtime.flightsim import evaluate_flight

        wrappers = reset_launches()
        native.gray_crop.CALLS = 0
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
        gray_crops = native.gray_crop.CALLS
        launches = {name: fn.LAUNCHES for name, fn in wrappers.items()}
        for name, count in launches.items():
            self.totals[name] += count
        node.close()
        rep = evaluate_flight(sim.samples, published)
        processed = len(sim.samples) - 1
        if self.dev.type == "cuda":
            check(launches["phase_correlate_frames"] == processed,
                  f"{label}: kernel A launched {launches['phase_correlate_frames']} times "
                  f"for {processed} frames")
            want_b = processed if node.config.scale_rotation else 0
            check(launches["peak_refine_raw"] == want_b,
                  f"{label}: kernel B launched {launches['peak_refine_raw']} times, {want_b} wanted")
        lat = np.array([m for t, m in published if t == "processing_latency_out"][1:]) * 1e3
        row = self.rows.setdefault(label, {})
        row.update({"frames": len(sim.samples), "rmse_xy": rep.rmse_xy, "nees_xy": rep.nees_xy,
                    "p50_ms": float(np.percentile(lat, 50)), "p90_ms": float(np.percentile(lat, 90)),
                    "node_s": wall, "launches_a": launches["phase_correlate_frames"],
                    "launches_b": launches["peak_refine_raw"], "gray_crops": gray_crops})
        say(f"  {label}: rmse_xy {rep.rmse_xy:.4f} m/s, max {rep.max_err_xy:.4f}, nees "
            f"{rep.nees_xy:.4f}, latency p50 {row['p50_ms']:.3f} ms p90 {row['p90_ms']:.3f} ms, "
            f"render {row.get('render_s', 0.0):.2f} s, node {wall:.2f} s; launches A "
            f"{row['launches_a']}, B {row['launches_b']}")
        return rep

    def fly_bag(self, sim, frames, path: str, fmt: str, label: str, **overrides):
        """The flight written by ``record_bag`` (``fmt`` "bag") or
        ``record_bag2`` ("bag2") to ``path`` from ``frames``, its messages read
        once, then replayed through ``replay_bag``/``replay_bag2`` into a
        warmed node (identity camera mount).  The row adds the write and
        read seconds.  Returns (node, published, report)."""
        from mrs_optic_flow_tpu_torch.runtime.rosbag import BagReader, replay_bag
        from mrs_optic_flow_tpu_torch.runtime.rosbag2 import Bag2Reader, replay_bag2

        record, reader, replay = ((sim.record_bag, BagReader, replay_bag) if fmt == "bag"
                                  else (sim.record_bag2, Bag2Reader, replay_bag2))
        t0 = time.perf_counter()
        record(path, frames)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with reader(path) as r:
            n_msgs = sum(1 for _ in r.messages())
        read_s = time.perf_counter() - t0
        check(n_msgs == 1 + 4 * len(sim.samples), f"{label}: {n_msgs} messages in the bag")
        node, published = self.node(sim, **overrides)
        replayed = []
        rep = self.measure(sim, label, node, published,
                           lambda: replayed.append(replay(node, path)))
        check(replayed == [len(sim.samples)], f"{label}: replay reports {replayed} frames")
        self.rows[label].update(write_s=write_s, read_s=read_s, messages=n_msgs)
        return node, published, rep


def check_level_report(rep, node, label: str) -> None:
    """``test_flight_closed_loop``'s trajectory budgets."""
    check(rep.rmse_xy < 0.12 and rep.max_err_xy < 0.35, f"{label}: {rep}")
    check(rep.within_3sigma >= 0.97 and rep.nan_published == 0, f"{label}: {rep}")
    check(all(cov >= 0.95 for cov in rep.per_phase_coverage.values()), f"{label}: {rep}")
    check(rep.dropped_at_switches == 0, f"{label}: {rep}")
    check(node.health["consecutive_failures"] <= 1, f"{label}: {node.health}")
    check(0.03 < rep.nees_xy < 2.0, f"{label}: nees {rep.nees_xy}")


def check_banked_report(rep, node, label: str) -> None:
    """``_assert_banked_budgets`` of ``tests/test_flightsim.py``."""
    check(rep.rmse_xy < 0.11 and rep.max_err_xy < 0.30, f"{label}: {rep}")
    check(rep.nan_published == 0 and rep.within_3sigma >= 0.97, f"{label}: {rep}")
    check(0.03 < rep.nees_xy < 2.0, f"{label}: nees {rep.nees_xy}")
    check(rep.per_phase_rmse["climb"] < 0.09, f"{label}: {rep.per_phase_rmse}")
    check(all(cov >= 0.95 for cov in rep.per_phase_coverage.values()), f"{label}: {rep}")
    check(node.health["consecutive_failures"] <= 1, f"{label}: {node.health}")


def sr_pairs(samples, published, skip: int) -> list:
    """(sample, ``scale_rotation_out`` message) by stamp from ``samples[skip:]``."""
    sr = {round(float(m["stamp"]), 6): m for t, m in published if t == "scale_rotation_out"}
    return [(s, sr[round(s.t, 6)]) for s in samples[skip:] if round(s.t, 6) in sr]


def read_avi(path: str) -> tuple:
    """(width, height, frames [N, H, W, 3] uint8) of an uncompressed BGR24
    top-down AVI as ``runtime/viz.py::VideoWriter`` writes it, read chunk by
    chunk: the header's frame count must equal the ``00db`` chunks."""
    import struct

    data = pathlib.Path(path).read_bytes()
    check(data[:4] == b"RIFF" and data[8:12] == b"AVI ", f"{path}: not an AVI")
    check(struct.unpack_from("<I", data, 4)[0] == len(data) - 8, f"{path}: RIFF size")
    total = struct.unpack_from("<I", data, 32 + 16)[0]  # avih dwTotalFrames
    w, h = struct.unpack_from("<2I", data, 32 + 32)  # avih dwWidth, dwHeight
    movi = data.index(b"movi") + 4
    frames, pos = [], movi
    while data[pos:pos + 4] == b"00db":
        size = struct.unpack_from("<I", data, pos + 4)[0]
        frames.append(np.frombuffer(data, np.uint8, size, pos + 8).reshape(h, w, 3))
        pos += 8 + size
    check(data[pos:pos + 4] == b"idx1", f"{path}: no index after the frames")
    check(total == len(frames), f"{path}: header says {total} frames, {len(frames)} written")
    return w, h, np.stack(frames)


def run_cli(dev, replay_path: str, bags: dict) -> dict:
    """Phase 16(g) and (k): the CLI as subprocesses, all started together,
    each with its own time limit; every one is stopped before this returns.
    ``bags``: format ("bag", "bag2") -> (path, frames in it)."""
    runs = {
        "flight banked": (["--flight", "banked", "--quiet"], 0),
        "flight level, budget 0.001": (["--flight", "level", "--quiet",
                                         "--flight-rmse-budget", "0.001"], 1),
        "synthetic, host_preprocess": (["--synthetic", "--frames", "20", "--quiet", "--set",
                                        "tpu.host_preprocess=true"], 0),
        "replay .ofrec": (["--replay", replay_path, "--quiet"], 0),
    }
    for fmt, (path, _) in bags.items():
        runs[f"bag-info {fmt}"] = (["--bag-info", path], 0)
        runs[f"replay {fmt}"] = (["--replay", path, "--quiet"], 0)
    procs = {}
    try:
        for label, (argv, _) in runs.items():
            procs[label] = subprocess.Popen(
                [sys.executable, "-m", "mrs_optic_flow_tpu_torch", *argv, "--device", str(dev)],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        out = {}
        deadline = time.monotonic() + CLI_TIMEOUT_S
        for label, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            want = runs[label][1]
            check(proc.returncode == want, f"CLI {label}: exit {proc.returncode}, {want} wanted; "
                                           f"stderr {stderr[-2000:]}")
            out[label] = {"rc": proc.returncode, "stdout": stdout,
                          "last_line": stdout.strip().splitlines()[-1]}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    banked = json.loads(out["flight banked"]["last_line"])
    check(banked["rmse_xy"] < 0.15 and banked["nan_published"] == 0
          and set(banked["per_phase_coverage"]) == {"climb", "cruise", "brake", "descent"},
          f"CLI banked flight report {banked}")
    level = json.loads(out["flight level, budget 0.001"]["last_line"])
    check(level["rmse_xy"] < 0.15 and level["nan_published"] == 0, f"CLI level flight {level}")
    check("twists from 20 synthetic frames" in out["synthetic, host_preprocess"]["last_line"],
          out["synthetic, host_preprocess"])
    check("replay frames" in out["replay .ofrec"]["last_line"], out["replay .ofrec"])
    say(f"  CLI: banked exit 0, rmse_xy {banked['rmse_xy']:.4f}; level with budget 0.001 exit 1 "
        f"(rmse_xy {level['rmse_xy']:.4f}); {out['synthetic, host_preprocess']['last_line']}; "
        f"{out['replay .ofrec']['last_line']}")
    say("[16g flights] the CLI's flight gate, synthetic and replay runs exit as wanted")
    # (k) the bags: --bag-info lists every topic with its count, --replay
    # dispatches every frame; each twist line counted
    bag_rows = {}
    for fmt, (path, n_frames) in bags.items():
        info = out[f"bag-info {fmt}"]["stdout"].strip().splitlines()
        check(info[0].startswith(f"{path}: {1 + 4 * n_frames} messages, ") and len(info) == 6,
              f"CLI --bag-info {fmt}: {info}")
        counts = {line.split()[0]: int(line.split()[1]) for line in info[1:]}
        check(counts == {"/camera_info": 1, "/height": n_frames, "/image_raw": n_frames,
                         "/imu": n_frames, "/odometry": n_frames}, f"CLI --bag-info {fmt}: {counts}")
        lines = out[f"replay {fmt}"]["stdout"].strip().splitlines()
        twist_lines = sum(1 for line in lines if " m/s" in line and line.startswith("["))
        summary = lines[-1].split("; health")[0]
        check(summary == f"{twist_lines} twists from {n_frames} replay frames"
              and twist_lines >= n_frames - 1, f"CLI --replay {fmt}: {summary}, {twist_lines} lines")
        bag_rows[fmt] = {"messages": 1 + 4 * n_frames, "twists": twist_lines, "summary": summary}
    check(bag_rows["bag"]["twists"] == bag_rows["bag2"]["twists"], f"CLI bag replays {bag_rows}")
    say(f"[16k flights] CLI --bag-info and --replay of both bags: {bag_rows['bag']['summary']} "
        f"(.bag), {bag_rows['bag2']['summary']} (rosbag2)")
    return {"banked_rmse_xy": banked["rmse_xy"], "level_rmse_xy": level["rmse_xy"], "bags": bag_rows}


class FakeEndpoint:
    """A publisher or subscription of the fake ``rospy``/``rclpy``: its topic,
    message class, callback and the messages published on it."""

    def __init__(self, registry: list, topic: str, typ, cb=None):
        self.topic, self.type, self.cb, self.sent = topic, typ, cb, []
        registry.append(self)

    def publish(self, msg) -> None:
        self.sent.append(msg)


class FakeTime:
    """``rospy.Time``: seconds as a float."""

    def __init__(self, sec: float):
        self.sec = sec

    @staticmethod
    def from_sec(sec: float) -> "FakeTime":
        return FakeTime(sec)

    def to_sec(self) -> float:
        return self.sec


class FakeTfBuffer:
    """A tf2 buffer holding the identity between every pair of frames."""

    def lookup_transform(self, target, source, time_, timeout=None):
        from types import SimpleNamespace

        return SimpleNamespace(transform=SimpleNamespace(rotation=SimpleNamespace(
            x=0.0, y=0.0, z=0.0, w=1.0)))


def fake_msg_types() -> dict:
    """Type key -> a message class with the fields the bridges' builders
    fill (outputs) or a bare class (inputs, which the bridge only names)."""
    from types import SimpleNamespace

    def vec():
        return SimpleNamespace(x=0.0, y=0.0, z=0.0)

    class TwistWithCovarianceStamped:
        def __init__(self):
            self.header = SimpleNamespace(frame_id="", stamp=SimpleNamespace(sec=0, nanosec=0))
            self.twist = SimpleNamespace(twist=SimpleNamespace(linear=vec(), angular=vec()),
                                         covariance=[0.0] * 36)

    class Vector3:
        def __init__(self):
            self.x = self.y = self.z = 0.0

    def scalar(name):
        return type(name, (), {"data": 0})

    types_ = {"TwistWithCovarianceStamped": TwistWithCovarianceStamped, "Vector3": Vector3,
              "Float32": scalar("Float32"), "Int32": scalar("Int32"),
              "Float64MultiArray": scalar("Float64MultiArray")}
    for name in ("Image", "CameraInfo", "Imu", "Odometry", "Float64Stamped",
                 "ControlManagerDiagnostics"):
        types_[name] = type(name, (), {})
    return types_


def fake_rospy():
    from types import SimpleNamespace

    pubs, subs = [], []
    return SimpleNamespace(
        Publisher=lambda topic, typ, queue_size=1: FakeEndpoint(pubs, topic, typ),
        Subscriber=lambda topic, typ, cb, queue_size=1, tcp_nodelay=False: FakeEndpoint(
            subs, topic, typ, cb),
        Time=FakeTime, Duration=lambda s: s, loginfo=lambda *a: None, logwarn=say,
        spin=lambda: None, pubs=pubs, subs=subs)


def fake_rclpy():
    from types import SimpleNamespace

    pubs, subs = [], []
    handle = SimpleNamespace(
        create_publisher=lambda typ, topic, qos: FakeEndpoint(pubs, topic, typ),
        create_subscription=lambda typ, topic, cb, qos: FakeEndpoint(subs, topic, typ, cb),
        get_logger=lambda: SimpleNamespace(info=lambda *a: None, warn=say))
    return SimpleNamespace(create_node=lambda name: handle, spin=lambda h: None,
                           spin_once=lambda h, timeout_sec=0.1: None, pubs=pubs, subs=subs)


@functools.lru_cache(maxsize=None)
def ros_standin():
    """``tests/torch_ros_standin/ros_standin.py``, loaded from its file: the
    stand-in ROS graph's shared module, whose ``ros_messages`` (the bags'
    messages as ROS1 or ROS2 messages, by the bridges' input topics,
    ``BAG_TO_BRIDGE``) feeds phase 16(l)'s bridges and whose graph phase
    19's children run on.  Its ``rospy`` and ``rclpy`` stay off this
    process's path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("ros_standin", STANDIN / "ros_standin.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def fly_bridge(fl, sim, path: str, ros2: bool, label: str, **overrides):
    """Phase 16(l): ``RosBridge`` (or ``Ros2Bridge``) on the fake ``rospy``
    (``rclpy``) builds its node on ``dev``; the ROS1 bag's camera info goes
    in, the bridge warms up, then every message of the bag through the
    subscribers' callbacks, each image callback timed (the row's
    ``callback_p50_ms``/``p90_ms``, the first, which only primes the node,
    left out).  Returns (the bridge's fake publishers, the node's
    publications, the report)."""
    from mrs_optic_flow_tpu_torch.config import load_config
    from mrs_optic_flow_tpu_torch.runtime import Ros2Bridge, RosBridge
    from mrs_optic_flow_tpu_torch.runtime.ros_bridge import _PUBLISHERS

    types_ = fake_msg_types()
    if ros2:
        fake = fake_rclpy()
        bridge = Ros2Bridge(load_config(overrides=overrides), rclpy_module=fake, msg_types=types_,
                            tf_buffer=FakeTfBuffer(), time_cls=lambda: None,
                            duration_cls=lambda seconds: seconds, sensor_qos="sensor",
                            device=fl.dev)
    else:
        fake = fake_rospy()
        bridge = RosBridge(load_config(overrides=overrides), rospy_module=fake, msg_types=types_,
                           tf_buffer=FakeTfBuffer(), device=fl.dev)
    prefix = "~/" if ros2 else "~"
    callbacks = {ep.topic[len(prefix):]: ep.cb for ep in fake.subs}
    messages = ros_standin().ros_messages(path, ros2)
    published, image_ms = [], []
    to_ros = bridge.node.publish
    bridge.node.publish = lambda t, m: (published.append((t, m)), to_ros(t, m))
    callbacks[messages[0][0]](messages[0][1])  # the camera info
    bridge.warmup()

    def run():
        for topic, msg in messages:
            t0 = time.perf_counter()
            callbacks[topic](msg)
            if topic == "camera_in":
                image_ms.append((time.perf_counter() - t0) * 1e3)

    rep = fl.measure(sim, label, bridge.node, published, run)
    fl.rows[label].update(callback_p50_ms=float(np.percentile(image_ms[1:], 50)),
                          callback_p90_ms=float(np.percentile(image_ms[1:], 90)))
    for ep in fake.pubs:
        want = types_[_PUBLISHERS[ep.topic[len(prefix):]].type_key]
        check(all(type(m) is want for m in ep.sent), f"{label}: {ep.topic} published another type")
    return {ep.topic[len(prefix):]: ep.sent for ep in fake.pubs}, published, rep


def sent_twists(sent: dict, ros2: bool) -> dict:
    """topic -> {stamp rounded to 1 us: (linear x, linear y)} of the twists a
    bridge published as ROS messages (the stand-in's ``twists`` form)."""
    def stamp(m):
        st = m.header.stamp
        return round(st.sec + st.nanosec * 1e-9 if ros2 else st.to_sec(), 6)

    return {topic: {stamp(m): (m.twist.twist.linear.x, m.twist.twist.linear.y) for m in sent[topic]}
            for topic in ("velocity_out", "velocity_out_longrange")}


def ros_twist_diff(sent: dict, pub, ros2: bool) -> float:
    """Largest difference [m/s] between the twists a bridge published as ROS
    messages and a replay's, topic by topic and stamp by stamp (x and y)."""
    worst = 0.0
    sent = sent_twists(sent, ros2)
    for topic, a in sent.items():
        b = {round(m.stamp, 6): m.linear[:2] for t, m in pub if t == topic}
        check(a.keys() == b.keys() and len(a) > 0, f"{topic}: bridge stamps differ")
        for k in a:
            worst = max(worst, float(np.abs(np.subtract(a[k], b[k])).max()))
    return worst


def check_bag_flight(rep, label: str) -> None:
    """``test_flight_rosbag_roundtrip``'s budgets of a bag replay of the
    level flight under ``height_based``."""
    check(rep.rmse_xy < 0.15 and rep.nan_published == 0, f"{label}: {rep}")
    check(len(rep.mode_switches) == 2, f"{label}: switches {rep.mode_switches}")
    check(all(cov >= 0.95 for cov in rep.per_phase_coverage.values()), f"{label}: {rep}")


def run_fleet_flight(dev, totals: dict) -> dict:
    """Phase 16(f): ``test_fleet_flight_closed_loop`` on the port: three
    streams of 160 px renders through one ``FleetServer`` with the
    scale/rotation estimator fused, cruising at distinct velocities (stream
    1 drops a frame), then hovering while each yaws at its own rate; kernels
    A and B once a tick after the first, each tick's launches added to
    ``totals`` (kernel -> count)."""
    from mrs_optic_flow_tpu_torch.models import ScaleRotationConfig, ScaleRotationEstimator
    from mrs_optic_flow_tpu_torch.parallel import BatchPipeline
    from mrs_optic_flow_tpu_torch.runtime import FleetServer, SyntheticScene
    from mrs_optic_flow_tpu_torch.utils.quat_np import np_quat_from_rpy

    n, dt = 3, 0.1
    n_cruise, n_yaw = 9, 7
    heights = np.array([2.0, 2.5, 3.0])
    v_world = np.array([[0.8, 0.0], [-0.5, 0.6], [0.0, -0.9]])
    yaw_rates = np.array([0.8, -0.7, 0.6])  # rad/s, phase 2 only
    fx = 120.0
    scenes = [SyntheticScene(width=160, height_px=160, fx=fx, fy=fx, uav_height=heights[i],
                             seed=11 + i, texture_cutoff=0.3, texture_scale=60.0) for i in range(n)]
    k_mat = np.array([[fx, 0, 80.0], [0, fx, 80.0], [0, 0, 1.0]], np.float32)
    sr = ScaleRotationEstimator(ScaleRotationConfig(resolution=128, magnitude=15.0), device=dev)
    pipe = BatchPipeline(frame_size=128, sample_point_size=32, camera_matrix=k_mat,
                         dist_coeffs=np.zeros(5, np.float32), ransac_iterations=32,
                         scale_rotation=sr, device=dev)
    fleet = FleetServer(pipe, n)
    check(fleet._sr_fused, "fleet flight: scale/rotation not fused")
    t_total = 1 + n_cruise + n_yaw
    pos = np.zeros((t_total, n, 2))
    yaw = np.zeros((t_total, n))
    for t in range(1, t_total):
        cruising = t <= n_cruise
        pos[t] = pos[t - 1] + (v_world * dt if cruising else 0.0)
        yaw[t] = yaw[t - 1] + (0.0 if cruising else yaw_rates * dt)
    drop_tick = 5  # stream 1 misses this cruise frame
    errs = {i: {"cru": [], "yaw": []} for i in range(n)}
    rot_errs, tick_ms = [], []
    wrappers = kernel_wrappers()
    for t in range(t_total):
        frames = np.stack([
            np.clip(np.round(scenes[i].render_pose(tuple(pos[t, i]), (0.0, 0.0, yaw[t, i]))),
                    0, 255).astype(np.uint8)
            for i in range(n)
        ])
        mask = np.ones(n, bool)
        if t == drop_tick:
            mask[1] = False
        in_yaw = t > n_cruise
        rate_quats = np.stack([np_quat_from_rpy(0.0, 0.0, yaw_rates[i] if in_yaw else 0.0)
                               for i in range(n)]).astype(np.float32)
        for fn in wrappers.values():
            fn.LAUNCHES = 0
        t0 = time.perf_counter()
        tick = fleet.tick(frames, np.full(n, 100.0 + t * dt), heights, rate_quats=rate_quats,
                          mask=mask).materialize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        for name, fn in wrappers.items():
            totals[name] += fn.LAUNCHES
        if dev.type == "cuda":  # none at the first tick, which has no previous frame
            want = int(t > 0)
            check(wrappers["phase_correlate_frames"].LAUNCHES == want
                  and wrappers["peak_refine_raw"].LAUNCHES == want,
                  f"fleet flight tick {t}: A {wrappers['phase_correlate_frames'].LAUNCHES}, "
                  f"B {wrappers['peak_refine_raw'].LAUNCHES} launches, {want} wanted")
        if t == 0:
            check(not tick.ok.any(), "fleet flight: the first tick published")
            continue
        for i in range(n):
            if t == drop_tick and i == 1:
                check(not tick.ok[i], "fleet flight: the dropped frame published")
                continue
            check(tick.ok[i] and np.all(np.isfinite(tick.tran[i, :2])), (t, i, tick.tran[i]))
            span = 2 if (t == drop_tick + 1 and i == 1) else 1
            v_w = (pos[t, i] - pos[t - span, i]) / (span * dt)
            c, s = np.cos(yaw[t, i]), np.sin(yaw[t, i])
            expect = np.array([[c, -s], [s, c]]).T @ v_w
            errs[i]["yaw" if in_yaw else "cru"].append(np.linalg.norm(tick.tran[i, :2] - expect))
            if in_yaw:
                rot_errs.append(abs(float(tick.rotation[i]) - yaw_rates[i] * dt))
    rmse_c = []
    for i in range(n):
        check(len(errs[i]["cru"]) == n_cruise - (i == 1) and len(errs[i]["yaw"]) == n_yaw, errs[i])
        rmse_c.append(float(np.sqrt(np.mean(np.square(errs[i]["cru"])))))
        check(rmse_c[i] < 0.18, f"fleet flight stream {i}: cruise rmse {rmse_c[i]}")
        check(float(np.max(errs[i]["yaw"])) < 0.5, f"fleet flight stream {i}: {errs[i]['yaw']}")
    check(len(rot_errs) == n * n_yaw, rot_errs)
    check(float(np.median(rot_errs)) < np.deg2rad(2.0) and float(np.max(rot_errs)) < np.deg2rad(3.5),
          f"fleet flight rotation errors {rot_errs}")
    say(f"  (f) fleet flight, 3 streams fused scale/rotation: cruise rmse "
        f"{[round(r, 4) for r in rmse_c]} m/s, rotation error median "
        f"{np.rad2deg(np.median(rot_errs)):.3f} deg max {np.rad2deg(np.max(rot_errs)):.3f}, tick "
        f"p50 {np.percentile(tick_ms[1:], 50):.3f} ms")
    return {"cruise_rmse_xy": rmse_c, "rot_err_median_deg": float(np.rad2deg(np.median(rot_errs))),
            "tick_p50_ms": float(np.percentile(tick_ms[1:], 50))}


def run_flights(dev, rec_dir: pathlib.Path) -> tuple:
    """Phase 16.  Returns the ``flights`` line's object and what phase 19
    holds its children to: (h)'s bags (format -> (path, frames)), the level
    flight's simulator and (l)'s bridges (ROS flavour -> their twists as
    :func:`sent_twists` gives them, the row of their image callbacks).  The
    recordings go to ``rec_dir``, which the caller keeps for phase 19."""
    from mrs_optic_flow_tpu_torch import native
    from mrs_optic_flow_tpu_torch.runtime import SyntheticScene
    from mrs_optic_flow_tpu_torch.runtime.flightsim import (
        FlightSimulator,
        banked_flight_profile,
        banked_yawing_descent_profile,
        takeoff_cruise_descent_profile,
    )

    t_phase = time.perf_counter()
    fl = Flights(dev)
    off = {"long_range_mode": "always_off"}

    # (a) the level flight under both policies with a switch
    level = FlightSimulator(takeoff_cruise_descent_profile())
    level_frames = fl.render(level, "level height_based")
    level_twists = {}
    for mode, n_switches in LEVEL_MODES:
        label = f"level {mode}"
        node, pub, rep = fl.fly(level, level_frames, label,
                                mrs_optic_flow={"long_range_mode": mode, "takeoff_height": 1.2})
        topics = {t for t, _ in pub if t in ("velocity_out", "velocity_out_longrange")}
        check(topics == {"velocity_out", "velocity_out_longrange"}, f"{label}: topics {topics}")
        check(len(rep.mode_switches) == n_switches, f"{label}: switches {rep.mode_switches}")
        check_level_report(rep, node, label)
        level_twists[mode] = pub
    say("[16a flights] the level flight within budget under height_based and takeoff_based")

    # (b) the banked flight: every rate source, the tilt-correction A/B, a 90 deg mount
    banked = FlightSimulator(banked_flight_profile())
    banked_frames = fl.render(banked, "banked imu")
    reps = {}
    for src in ("imu", "odometry", "odometry_diff"):
        node, pub, rep = fl.fly(banked, banked_frames, f"banked {src}",
                                mrs_optic_flow={**off, "ang_rate_source": src})
        check_banked_report(rep, node, f"banked {src}")
        reps[src] = (rep, pub)
    rep_on, pub_on = reps["imu"]
    _, pub_off, rep_off = fl.fly(banked, banked_frames, "banked tilt_correction off",
                                 mrs_optic_flow={**off, "tilt_correction": False})
    check(rep_off.per_phase_rmse["climb"] > 1.6 * rep_on.per_phase_rmse["climb"]
          and rep_off.rmse_xy > rep_on.rmse_xy, (rep_on.per_phase_rmse, rep_off.per_phase_rmse))
    check({m.frame_id for t, m in pub_on if t == "velocity_out"} == {"fcu_untilted"}
          and {m.frame_id for t, m in pub_off if t == "velocity_out"} == {"fcu"}, "frame_ids")
    _, _, rep_dead = fl.fly(banked, banked_frames, "banked deadband 0.35",
                            mrs_optic_flow={**off, "minimum_tilt_correction": 0.35})
    dead_rel = abs(rep_dead.per_phase_rmse["climb"] / rep_off.per_phase_rmse["climb"] - 1.0)
    check(dead_rel <= 1e-6, f"deadband 0.35 against off: {dead_rel} relative")
    mounted = FlightSimulator(banked.samples, mount_rpy=(0.0, 0.0, np.pi / 2))
    mounted_frames = fl.render(mounted, "banked mount yaw pi/2")
    node, _, rep = fl.fly(mounted, mounted_frames, "banked mount yaw pi/2", c2b=mounted.c2b_quat,
                          mrs_optic_flow=off)
    check_banked_report(rep, node, "banked mount yaw pi/2")
    say(f"[16b flights] banked within budget on imu, odometry, odometry_diff and a 90 deg mount; "
        f"climb rmse tilt correction on {rep_on.per_phase_rmse['climb']:.4f}, off "
        f"{rep_off.per_phase_rmse['climb']:.4f} m/s, deadband = off within {dead_rel:.2g}")

    # (c) banked, low, long range all the way, at two mounts
    lr_samples = banked_flight_profile(climb_frames=24, h0=0.9, h_cruise=1.3, h_final=1.0,
                                       v_cruise_xy=(0.7, 0.2), descent_frames=16,
                                       descent_yaw_rate=0.25)
    for mount_yaw in (0.0, np.pi / 2):
        label = f"banked long range mount yaw {mount_yaw:.4f}"
        sim = FlightSimulator(lr_samples, mount_rpy=(0.0, 0.0, mount_yaw))
        node, pub, rep = fl.fly(sim, fl.render(sim, label), label, c2b=sim.c2b_quat,
                                mrs_optic_flow={"long_range_mode": "always_on"})
        check({t for t, _ in pub if t.startswith("velocity_out")}
              >= {"velocity_out_longrange", "velocity_out_longrange_diff"}, f"{label}: topics")
        check(rep.rmse_xy < 0.08 and rep.max_err_xy < 0.20, f"{label}: {rep}")
        check(rep.per_phase_rmse["brake"] < 0.12, f"{label}: {rep.per_phase_rmse}")
        check(rep.nan_published == 0 and 0.03 < rep.nees_xy < 2.0, f"{label}: {rep}")
        check(all(cov >= 0.95 for cov in rep.per_phase_coverage.values()), f"{label}: {rep}")
        check(node.health["consecutive_failures"] <= 1, f"{label}: {node.health}")
    say("[16c flights] banked long range within budget at both mounts")

    # (d) scale/rotation: the level descent, then the banked tilt gate
    sr_kw = dict(scale_rotation=True, scale_rot_lp_resolution=240, mrs_optic_flow=off)
    _, pub, _ = fl.fly(level, level_frames, "level scale/rotation", **sr_kw)
    descent = [s for s in level.samples if s.phase == "descent"][2:]
    pairs = sr_pairs(descent, pub, 0)
    check(len(pairs) >= len(descent) - 2, f"{len(pairs)} decodes for {len(descent)} frames")
    vz = np.array([m["vz"] for _, m in pairs])
    vz_true = np.array([s.vel[2] for s, _ in pairs])
    yaw_rates = np.array([m["yaw_rate"] for _, m in pairs])
    check(np.all(np.isfinite(vz)) and np.all(np.isfinite(yaw_rates)), "descent decodes finite")
    vz_err, yr_err = float(np.median(np.abs(vz - vz_true))), float(np.median(np.abs(yaw_rates - 0.35)))
    check(vz_err < 0.25, f"descent vz median error {vz_err}")
    mid = vz_true < -0.5
    check(mid.any() and np.all(vz[mid] < -0.2), f"mid-descent vz {vz[mid]}")
    check(yr_err < 0.05, f"descent yaw-rate median error {yr_err}")
    fl.rows["level scale/rotation"].update(vz_median_err=vz_err, yaw_rate_median_err=yr_err)

    gate = FlightSimulator(banked_yawing_descent_profile())
    samples = gate.samples
    max_bank = max(np.hypot(s.roll, s.pitch) for s in samples)
    check(0.15 < max_bank < 0.25, f"max bank {max_bank}")
    gate_frames = fl.render(gate, "banked tilt gate")
    _, pub, rep = fl.fly(gate, gate_frames, "banked tilt gate", **sr_kw)
    pairs = sr_pairs(samples, pub, 3)
    check(len(pairs) >= len(samples) - 5, "tilt gate: a decode a frame")
    finite = [(s, m) for s, m in pairs if np.isfinite(m["yaw_rate"])]
    check(len(finite) <= 3 and all(abs(m["yaw_rate"] - s.yaw_rate) < 1.0 for s, m in finite),
          f"tilt gate: decodes through the gate {finite}")
    check(rep.rmse_xy < 0.25 and rep.nan_published == 0, f"tilt gate: {rep}")
    _, pub_open, _ = fl.fly(gate, gate_frames, "banked tilt gate lifted", scale_rotation=True,
                            scale_rot_lp_resolution=240, scale_rot_max_tilt=10.0,
                            scale_rot_max_tilt_rate=1000.0, mrs_optic_flow=off)
    finite_off = [(s, m) for s, m in sr_pairs(samples, pub_open, 3) if np.isfinite(m["yaw_rate"])]
    check(len(finite_off) >= len(samples) - 5, "lifted gate: a finite decode a frame")
    yr = np.array([abs(m["yaw_rate"] - s.yaw_rate) for s, m in finite_off])
    vz_e = np.array([abs(m["vz"] - s.vel[2]) for s, m in finite_off])
    check(yr.max() > 5.0 and np.median(vz_e) > 0.2, f"lifted gate: {yr.max()}, {np.median(vz_e)}")
    tilts = np.array([np.hypot(s.roll, s.pitch) for s, _ in finite_off])
    rates = np.array([np.hypot(s.roll_rate, s.pitch_rate) for s, _ in finite_off])
    for t_max in (0.03, 0.05, 0.08, 0.12):
        for r_max in (0.15, 0.3, 0.5, 1.0):
            surv = (tilts <= t_max) & (rates <= r_max)
            check(not surv.any() or np.median(yr[surv]) > 0.15, (t_max, r_max, yr[surv]))
    broken = yr > 0.15
    check(np.all((tilts[broken] > 0.05) | (rates[broken] > 0.3)), "tilt gate defaults")
    say(f"[16d flights] scale/rotation: descent vz median error {vz_err:.4f} m/s, yaw rate "
        f"{yr_err:.4f} rad/s; the banked tilt gate NaNs all but {len(finite)} decodes, lifted its "
        f"worst yaw-rate error is {yr.max():.2f} rad/s")

    # (e)-(l) write their recordings into rec_dir
    # (e) .ofrec record and replay, host preprocessing, store_video
    rec_path = str(rec_dir / "level.ofrec")
    level.record_ofrec(rec_path, level_frames)
    with native.Replay(rec_path) as rp:
        check(rp.n_frames == len(level.samples), f"{rp.n_frames} frames replayed")
        replayed = [f for _, f in rp]
        for i, (stamp, frame) in enumerate(rp):
            check(stamp == level.samples[i].t, f"frame {i}: stamp {stamp}")
            check(np.array_equal(frame, np.clip(np.rint(level_frames[i]), 0, 255).astype(np.uint8)),
                  f"frame {i} differs from its render")
    _, pub, rep = fl.fly(level, level_frames, "level replayed .ofrec", stream_frames=replayed,
                         mrs_optic_flow={"long_range_mode": "height_based", "takeoff_height": 1.2})
    check(rep.rmse_xy < 0.15 and rep.nan_published == 0, f"replayed flight: {rep}")

    bgr = [np.repeat(f[..., None], 3, axis=-1) for f in replayed]
    _, pub, _ = fl.fly(level, level_frames, "level host_preprocess", stream_frames=bgr,
                       tpu={"host_preprocess": True},
                       mrs_optic_flow={"long_range_mode": "height_based", "takeoff_height": 1.2})
    crops = fl.rows["level host_preprocess"]["gray_crops"]  # every frame after the first
    check(crops == len(level.samples) - 1, f"gray_crop ran {crops} times for "
                                           f"{len(level.samples) - 1} frames")
    host_diff = twist_diff(pub, level_twists["height_based"])
    check(host_diff <= HOST_PRE_TWIST_TOL, f"host preprocessing moved a twist by {host_diff} m/s")

    videos = {}
    for ext in ("ofrec", "avi"):
        path = str(rec_dir / f"overlay.{ext}")
        fl.fly(level, level_frames, f"level store_video .{ext}", store_video=True, video_path=path,
               mrs_optic_flow={"long_range_mode": "height_based", "takeoff_height": 1.2})
        videos[ext] = path
    with native.Replay(videos["ofrec"]) as rp:
        overlay_stamps, overlays = zip(*list(rp))
    check(len(overlays) == len(level.samples) - 1 and overlays[0].shape == (480, 480),
          f"{len(overlays)} overlay frames of {overlays[0].shape}")
    check(list(overlay_stamps) == [s.t for s in level.samples[1:]], "overlay stamps")
    w, h, avi = read_avi(videos["avi"])
    check((w, h) == (480, 480) and len(avi) == len(overlays), f"AVI {w}x{h}, {len(avi)} frames")
    check(all(np.array_equal(a[..., 0], o) and np.array_equal(a[..., 2], o)
              for a, o in zip(avi, overlays)), "the AVI's frames differ from the .ofrec overlays")
    say(f"[16e flights] .ofrec replay bit-exact, replayed rmse_xy {rep.rmse_xy:.4f}; host "
        f"preprocessing: gray_crop on all {crops} frames, twists within {host_diff:.3g} m/s of "
        f"(a); store_video: {len(overlays)} overlays in .ofrec and .avi, equal")

    # (f) the fleet flight
    fleet = run_fleet_flight(dev, fl.totals)
    say("[16f flights] the fleet flight within budget")

    # (h) the level flight through both bag formats, from (a)'s renders
    lr = {"long_range_mode": "height_based", "takeoff_height": 1.2}
    bags, bag_pub = {}, {}
    for fmt, name in (("bag", "level.bag"), ("bag2", "level_bag2")):
        label = f"level {fmt} replay"
        bags[fmt] = (str(rec_dir / name), len(level.samples))
        node, bag_pub[fmt], rep = fl.fly_bag(level, level_frames, bags[fmt][0], fmt, label,
                                             mrs_optic_flow=lr)
        check_bag_flight(rep, label)
        check(not any(np.isnan(m.linear[:2]).any() for t, m in bag_pub[fmt]
                      if t.startswith("velocity_out")), f"{label}: a NaN twist")
    bag_diff = twist_diff(bag_pub["bag"], bag_pub["bag2"])
    check(bag_diff <= HOST_PRE_TWIST_TOL, f"ROS1 and ROS2 replays differ by {bag_diff} m/s")
    say(f"[16h flights] the level flight through .bag and rosbag2 within budget; ROS1 and "
        f"ROS2 twists within {bag_diff:.3g} m/s")

    # (i) the banked flight through both formats
    for fmt, name in (("bag", "banked.bag"), ("bag2", "banked_bag2")):
        label = f"banked {fmt} replay"
        _, _, rep = fl.fly_bag(banked, banked_frames, str(rec_dir / name), fmt, label,
                               mrs_optic_flow=off)
        check(rep.rmse_xy < 0.12 and rep.per_phase_rmse["climb"] < 0.10
              and rep.nan_published == 0, f"{label}: {rep}")
        check(all(cov >= 0.95 for cov in rep.per_phase_coverage.values()), f"{label}: {rep}")
    say("[16i flights] the banked flight through .bag and rosbag2 within budget")

    # (j) the banked flight's scene variants
    for variant, kw in (("lens distortion", {"dist_coeffs": (-0.25, 0.06, 1e-4, -2e-4, -0.004)}),
                        ("principal point 420,230", {"cx": 420.0, "cy": 230.0})):
        label = f"banked {variant}"
        sim = FlightSimulator(banked.samples, scene=SyntheticScene(seed=7, texture_cutoff=0.3, **kw))
        node, _, rep = fl.fly(sim, fl.render(sim, label), label, mrs_optic_flow=off)
        check_banked_report(rep, node, label)
    say("[16j flights] the banked scene variants within the nominal banked budgets")

    # (l) the bridges on fake rospy/rclpy, fed (h)'s ROS1 bag
    bridge_diff, bridges = {}, {}
    for ros2, label in ((False, "level RosBridge"), (True, "level Ros2Bridge")):
        sent, pub, rep = fly_bridge(fl, level, bags["bag"][0], ros2, label, mrs_optic_flow=lr)
        check_bag_flight(rep, label)
        bridges["ros2" if ros2 else "ros1"] = (sent_twists(sent, ros2), fl.rows[label])
        bridge_diff[label] = max(ros_twist_diff(sent, bag_pub["bag"], ros2),
                                 twist_diff(pub, bag_pub["bag"]))
        check(bridge_diff[label] <= HOST_PRE_TWIST_TOL,
              f"{label}: twists {bridge_diff[label]} m/s from (h)'s replay")
    say(f"[16l flights] RosBridge and Ros2Bridge publish (h)'s twists within "
        f"{max(bridge_diff.values()):.3g} m/s, every message of its builders' type")

    # (g) and (k): the CLI
    cli = run_cli(dev, rec_path, bags)
    wall = time.perf_counter() - t_phase
    say(f"[16 flights] {wall:.1f} s")
    return ({"flights": fl.rows, "launches": fl.totals, "fleet_flight": fleet, "cli": cli,
             "host_preprocess_gray_crops": crops, "host_preprocess_twist_diff": host_diff,
             "bag_twist_diff": bag_diff, "bridge_twist_diff": bridge_diff, "wall_s": wall},
            {"bags": bags, "level": level, "bridges": bridges})


# --------------------------------------------------------------------------- #
# phase 19: the node executable, started as the launch systems start it        #
# --------------------------------------------------------------------------- #

#: phase 19's children: label -> (ROS flavour, (h)'s bag format, the
#: arguments after the executable: roslaunch's (``__name:=``, ``__log:=``)
#: or ros2 launch's (``--ros-args ... --``), with (h)'s config as
#: ``extra_args`` and no ``--device``: the card)
LIVE_CONFIG = ["--config", "configs/default.yaml", "--camera-frame", "uav1/bluefox_optflow_optical",
               "--uav-frame", "uav1/fcu", "--set", "mrs_optic_flow.long_range_mode=height_based",
               "--set", "mrs_optic_flow.takeoff_height=1.2"]
LIVE_RUNS = {
    "(a) ROS1": ("ros1", "bag", [*LIVE_CONFIG, "__name:=optic_flow", "__log:={tmp}/optic_flow.log"]),
    "(b) ROS2": ("ros2", "bag2", ["--ros2", *LIVE_CONFIG, "--ros-args", "-r", "__node:=optic_flow",
                                  "-r", "__ns:=/uav1", "--"]),
}
LIVE_TWIST_TOL = 1e-6  # m/s: the same node and kernels on the same card as (l)


def run_live_nodes(dev, ref: dict, tmp: pathlib.Path) -> dict:
    """Phase 19: ``scripts/optic_flow_tpu_torch_node`` as roslaunch (a) and
    ros2 launch (b) start it, without ``--device`` (on the CPU, a rehearsal,
    with ``--device cpu``), its only ROS the stand-in packages of
    ``tests/torch_ros_standin/`` playing (h)'s level-flight ROS1 bag (a) or
    rosbag2 (b); both started together, each with its own time limit, every
    one stopped before this returns.  Each must exit 0 with jax, yaml and
    cv2 blocked, publish (l)'s twists of its flavour within
    ``LIVE_TWIST_TOL`` stamp for stamp, launch kernel A at least once a
    processed frame (on the card) and hold ``check_bag_flight``'s budgets.
    The children find the kernel libraries built (phase 2) and leave them
    as they are.  Returns label -> its row; prints a line each."""
    from types import SimpleNamespace

    from mrs_optic_flow_tpu_torch.ops import cuda_kernels
    from mrs_optic_flow_tpu_torch.runtime.flightsim import evaluate_flight

    standin, level = ros_standin(), ref["level"]
    libs = {}  # kernel -> its library's mtime, which the children must leave as it is
    if dev.type == "cuda":
        libs = {name: cuda_kernels.library_path(name).stat().st_mtime_ns for name in KERNELS}
    procs, spawned, rows = {}, {}, {}
    try:
        for label, (ros, fmt, argv) in LIVE_RUNS.items():
            out = tmp / f"live_{ros}.jsonl"
            env = standin.environment(ref["bags"][fmt][0], str(out))
            argv = [a.format(tmp=tmp) for a in argv] + ([] if dev.type == "cuda" else ["--device", "cpu"])
            spawned[label] = time.time()
            procs[label] = subprocess.Popen([str(REPO / "scripts" / "optic_flow_tpu_torch_node"), *argv],
                                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)
        deadline = time.monotonic() + CLI_TIMEOUT_S
        done = {}
        for label, proc in procs.items():
            _, stderr = proc.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            done[label] = (proc.returncode, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    processed = len(level.samples) - 1
    for label, (ros, fmt, _) in LIVE_RUNS.items():
        rc, stderr = done[label]
        check(rc == 0, f"19{label}: exit {rc}; stderr {stderr[-3000:]}")
        published, summary = standin.read_output(str(tmp / f"live_{ros}.jsonl"))
        check(all(summary["blocked"].values()) and summary["loaded"] == [],
              f"19{label}: {summary['blocked']}, loaded {summary['loaded']}")
        twists = standin.twists(published)
        ref_twists, ref_row = ref["bridges"][ros]
        diff = standin.twist_diff(twists, ref_twists)
        check(diff <= LIVE_TWIST_TOL, f"19{label}: twists {diff} m/s from 16(l)'s")
        launches = summary["launches"]
        if dev.type == "cuda":
            check(launches["phase_correlate_frames"] >= processed,
                  f"19{label}: kernel A launched {launches['phase_correlate_frames']} times for "
                  f"{processed} frames")
        rep = evaluate_flight(level.samples, [
            (r["topic"], SimpleNamespace(stamp=r["stamp"], linear=r["linear"], covariance=r["covariance"]))
            for r in published if "linear" in r])
        check_bag_flight(rep, f"19{label}")
        image_ms = np.array(summary["image_callback_s"][1:]) * 1e3
        check(len(image_ms) == processed, f"19{label}: {len(image_ms) + 1} image callbacks")
        rows[label] = {
            "exit": rc, "twists": sum(map(len, twists.values())), "twist_diff": diff,
            "launches_a": launches["phase_correlate_frames"], "frames": processed + 1,
            "rmse_xy": rep.rmse_xy, "mode_switches": len(rep.mode_switches),
            "callback_p50_ms": float(np.percentile(image_ms, 50)),
            "callback_p90_ms": float(np.percentile(image_ms, 90)),
            "in_process_p50_ms": ref_row["callback_p50_ms"], "in_process_p90_ms": ref_row["callback_p90_ms"],
            "cold_start_s": summary["first_image_wall"] - spawned[label],
        }
        r = rows[label]
        say(f"[19{label} live node] exit 0, {r['twists']} twists, largest difference from 16(l) "
            f"{diff:.3g} m/s, kernel A {r['launches_a']} launches for {processed} frames, rmse_xy "
            f"{rep.rmse_xy:.4f} m/s, image callback p50 {r['callback_p50_ms']:.3f} ms p90 "
            f"{r['callback_p90_ms']:.3f} ms (16(l) in process p50 {r['in_process_p50_ms']:.3f} ms p90 "
            f"{r['in_process_p90_ms']:.3f} ms), cold start {r['cold_start_s']:.2f} s")
    for name, mtime in libs.items():
        check(cuda_kernels.library_path(name).stat().st_mtime_ns == mtime,
              f"19: a child rebuilt {name}'s library")
    if libs:
        say(f"[19 live nodes] the children loaded the {len(libs)} kernel libraries as phase 2 built them")
    return rows


# --------------------------------------------------------------------------- #
# phase 17: OpticFlowCalc, the mesh, the filters and the profiler              #
# --------------------------------------------------------------------------- #

#: phase 17's sizes: pairs of ``sharded_flow_step`` (the bench point) and of
#: the pipeline's steps, the shards of one card, fleet streams and ticks, the
#: scale/rotation fleet's streams, ``ServingLoop``'s batch and requests, and
#: the traced node's frames
SLICE_BENCH_PAIRS = BENCH_BATCH
SLICE_PIPE_PAIRS = 1024
SLICE_SHARDS = 4
SLICE_FLEET_STREAMS = FLEET_STREAMS
SLICE_FLEET_TICKS = 5
SLICE_SR_STREAMS = SR_FLEET_STREAMS
SLICE_SERVING_BATCH = SERVING_BATCH
SLICE_SERVING_REQUESTS = 1024
SLICE_TRACED_FRAMES = 5
SHARD_SHIFT_TOL = 1e-5  # px, sharded against unsharded
#: m/s, sharded against unsharded twists: the bound of the JAX package's
#: multi-chip dry run for the same comparison (``__graft_entry__.py``)
SHARD_TRAN_TOL = 5e-3
SHARD_DECODE_TOL = 1e-4  # scale and rotation [rad], sharded against unsharded
#: the card's float32 filters against the CPU's: relative, or times the
#: largest input component absolute (tests/test_torch_tran_rot_vvel.py)
FILTER_TOL = 1e-6


def shift_diff(a, b) -> float:
    """Largest ``|a - b|`` over the finite entries; NaN where and only where
    the other is NaN."""
    a, b = (np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x, np.float64)
            for x in (a, b))
    check(a.shape == b.shape and np.array_equal(np.isnan(a), np.isnan(b)), "NaN patterns differ")
    return float(np.nan_to_num(np.abs(a - b), nan=0.0).max(initial=0.0))


def add_launches(total: dict, wrappers: dict) -> dict:
    """``wrappers``' counts, added into ``total``; returns the counts."""
    got = {k: fn.LAUNCHES for k, fn in wrappers.items()}
    for k, n in got.items():
        total[k] = total.get(k, 0) + n
    return got


def gray_crops(dev, frames) -> list:
    """``render_frames``' BGR frames as the node's 480² float gray crops."""
    import torch

    from mrs_optic_flow_tpu_torch.ops.preprocess import center_crop, to_grayscale

    return [center_crop(to_grayscale(torch.from_numpy(f).to(dev)), 480, 376).contiguous()
            for f in frames]


def slice_calc(dev, grays, total: dict) -> dict:
    """(a) ``OpticFlowCalc`` over method 4 (kernel A), long range (A at the
    downsampled 120 px), patch 60 (kernel D) and ``BlockMethod`` (kernel C):
    each call against its engine's own step on the same frames, exactly for
    A, within ``SHIFT_TOL`` for D and C; ``raw_output`` filled."""
    import torch

    from mrs_optic_flow_tpu_torch.models import (
        BlockMethod, BlockMethodConfig, FftMethod, FftMethodConfig, OpticFlowCalc,
    )

    cases = [
        ("method 4", lambda: FftMethod(FftMethodConfig(), device=dev), False,
         "phase_correlate_frames", 0.0),
        ("long range", lambda: FftMethod(FftMethodConfig(), device=dev), True,
         "phase_correlate_frames", 0.0),
        ("patch 60", lambda: FftMethod(FftMethodConfig(sample_point_size=60), device=dev), False,
         "phase_correlate_fullfused", SHIFT_TOL),
        ("method 3", lambda: BlockMethod(BlockMethodConfig(), device=dev), False, "sad_search",
         SHIFT_TOL),
    ]
    out = {}
    for label, make, long_range, kernel, tol in cases:
        calc, ref = OpticFlowCalc(make()), make()
        p = ref.num_cells if hasattr(ref, "num_cells") else ref.num_windows
        wrappers = reset_launches()
        got = []
        for g in grays:
            if long_range:
                got.append((calc.process_image_long_range(g), None, None))
            else:
                raw = torch.full((p, 2), math.nan, device=dev)
                got.append((calc.process_image(g, raw_output=raw), raw, calc.last_result.shifts_raw))
        launches = add_launches(total, wrappers)
        state, diff = ref.init_state(), 0.0
        step = ref.step_long_range if long_range else ref.step
        for g, (shifts, raw, raw_ref) in zip(grays, got):
            state, res = step(state, g)
            diff = max(diff, shift_diff(shifts, res.shifts))
            if raw is not None:
                check(shift_diff(raw, raw_ref) == 0.0, f"{label}: raw_output not filled")
        check(diff <= tol, f"OpticFlowCalc {label}: shifts {diff} px from the engine's step")
        if dev.type == "cuda":
            n = launches[kernel]
            check(n == len(grays) if kernel == "phase_correlate_frames" else n >= len(grays),
                  f"OpticFlowCalc {label}: {n} {kernel} launches for {len(grays)} calls")
        out[label] = {"max_shift_diff": diff, kernel: launches[kernel]}
    return out


def slice_mesh(dev, total: dict) -> dict:
    """(b) ``sharded_flow_step`` at the bench point on one card and on
    ``SLICE_SHARDS`` shards of it against ``step_batch``, timed; then
    ``BatchPipeline(mesh=...)``'s ``step_pre`` (under sync-as-error) and
    ``step_long_range`` against the unsharded pipeline with the same
    generator."""
    import torch

    from mrs_optic_flow_tpu_torch.geometry.batched import get_rt_batch
    from mrs_optic_flow_tpu_torch.models import FftMethod, FftMethodConfig
    from mrs_optic_flow_tpu_torch.parallel import BatchPipeline, make_mesh, sharded_flow_step

    cuda = dev.type == "cuda"
    prev_np, curr_np, v = serving_pairs()
    cls = torch.arange(SLICE_BENCH_PAIRS) % len(v)
    prev = torch.from_numpy(prev_np).to(dev)[cls.to(dev)]
    curr = torch.from_numpy(curr_np).to(dev)[cls.to(dev)]
    eng = FftMethod(FftMethodConfig(), device=dev)
    ref = eng.step_batch(prev, curr)
    ref_speed = float(torch.linalg.norm(ref.shifts_raw, dim=-1).mean())
    one = make_mesh() if cuda else make_mesh(device="cpu")
    shards = make_mesh(SLICE_SHARDS, device="cuda:0" if cuda else "cpu")
    check(one.size == (torch.cuda.device_count() if cuda else 1), f"make_mesh(): {one}")
    out = {"step_batch_ms": time_cuda(lambda: eng.step_batch(prev, curr), 5) if cuda else math.nan}
    for label, mesh in (("one card", one), (f"{SLICE_SHARDS} shards", shards)):
        step = sharded_flow_step(eng, mesh)
        wrappers = reset_launches()
        shifts, speed = step(prev, curr)
        n = add_launches(total, wrappers)["phase_correlate_frames"]
        diff = shift_diff(shifts, ref.shifts)
        check(diff <= SHARD_SHIFT_TOL, f"sharded_flow_step {label}: {diff} px from step_batch")
        check(abs(float(speed) - ref_speed) <= 1e-6 * ref_speed, f"{label}: fleet mean speed")
        if cuda:
            check(n == mesh.size, f"sharded_flow_step {label}: {n} kernel A launches")
        ms = time_cuda(lambda: step(prev, curr), 5) if cuda else math.nan
        out[label] = {"shards": mesh.size, "launches": n, "max_shift_diff": diff, "ms": ms,
                      "frame_pairs_per_s": SLICE_BENCH_PAIRS / ms * 1e3}
    out["step_batch_frame_pairs_per_s"] = SLICE_BENCH_PAIRS / out["step_batch_ms"] * 1e3
    del ref

    b = SLICE_PIPE_PAIRS
    prev, curr = prev[:b].contiguous(), curr[:b].contiguous()
    truth = v[cls[:b].numpy()]
    cam = np.array([[FX, 0, 240.0], [0, FY, 240.0], [0, 0, 1]], np.float32)
    kw = dict(camera_matrix=cam, dist_coeffs=np.zeros(5, np.float32))
    plain, sharded = BatchPipeline(**kw, device=dev), BatchPipeline(**kw, mesh=shards, device=dev)
    heights, dts = torch.full((b,), HEIGHT, device=dev), torch.full((b,), DT, device=dev)
    rates = torch.zeros((b, 4), device=dev)
    rates[:, 3] = 1.0
    c2b = rates[0].clone()
    zeros = torch.zeros((b,), device=dev)
    outs, lrs = [], []
    for pipe in (plain, sharded):
        k = SLICE_SHARDS
        pipe.step_pre(prev[:k], curr[:k], heights[:k], dts[:k], rates[:k], c2b)  # warm-up
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        wrappers = reset_launches()
        with no_host_sync(dev):
            outs.append(pipe.step_pre(prev, curr, heights, dts, rates, c2b, generator=gen))
        n = add_launches(total, wrappers)["phase_correlate_frames"] if pipe is sharded else None
        wrappers = reset_launches()
        lrs.append(pipe.step_long_range(prev, curr, heights, dts, zeros, zeros, 0.0))
        n_lr = add_launches(total, wrappers)["phase_correlate_frames"] if pipe is sharded else None
    if cuda:
        check(n == SLICE_SHARDS and n_lr == SLICE_SHARDS, f"mesh pipeline: A launches {n}, {n_lr}")
    u, s = outs
    ok = s.ok.cpu().numpy()
    check(np.array_equal(ok, u.ok.cpu().numpy()), "step_pre: ok differs sharded and unsharded")
    d_shift, d_tran = shift_diff(s.shifts, u.shifts), shift_diff(s.tran, u.tran)
    check(d_shift <= SHARD_SHIFT_TOL and d_tran <= SHARD_TRAN_TOL, f"step_pre: {d_shift}, {d_tran}")
    emax = worst_err(s.tran.cpu().numpy(), truth, ok)
    check(ok.mean() >= SERVING_OK_SHARE and emax <= TWIST_TOL, f"step_pre: {ok.mean()} ok, {emax}")
    # the whole batch's draws, sliced a shard, give the inlier counts of the
    # whole batch's geometry
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    gumbel = sharded._gumbel(None, gen, b)
    geo = dict(frame_size=480, patch=120, ransac_iterations=sharded.ransac_iterations)

    def rt(sl):
        return get_rt_batch(u.shifts[sl], heights[sl], dts[sl], sharded.ul_x, sharded._cam, None, c2b,
                            rates[sl], gumbel=gumbel[..., sl], **geo)

    whole = rt(slice(None))
    k = b // SLICE_SHARDS
    parts = [rt(slice(i * k, (i + 1) * k)) for i in range(SLICE_SHARDS)]
    check(torch.equal(whole.n_inliers, torch.cat([p.n_inliers for p in parts]))
          and torch.equal(whole.ok, s.ok), "n_inliers or ok differ shard by shard")
    lu, ls = lrs
    lr_ok = ls.ok.cpu().numpy()
    check(np.array_equal(lr_ok, lu.ok.cpu().numpy()), "step_long_range: ok differs")
    lr_shift, lr_tran = shift_diff(ls.shifts, lu.shifts), shift_diff(ls.tran, lu.tran)
    check(lr_shift <= SHARD_SHIFT_TOL and lr_tran <= SHARD_TRAN_TOL, f"long range {lr_shift}, {lr_tran}")
    lr_err = worst_err(ls.tran.cpu().numpy(), truth, lr_ok)
    check(lr_ok.mean() >= SERVING_OK_SHARE and lr_err <= LR_TWIST_TOL, f"long range {lr_err}")
    out["pipeline"] = {"pairs": b, "ok_share": float(ok.mean()), "max_shift_diff": d_shift,
                       "max_tran_diff": d_tran, "max_twist_err": emax, "long_range_shift_diff": lr_shift,
                       "long_range_tran_diff": lr_tran, "long_range_twist_err": lr_err}
    return out


def slice_serving(dev, total: dict) -> dict:
    """(c) ``FleetServer`` of BGR 752x480 streams, the fused scale/rotation
    fleet and ``ServingLoop`` over a pipeline sharded ``SLICE_SHARDS`` ways
    on the card, each against the unsharded one with the same seed."""
    from oracle import smooth_random_image

    from mrs_optic_flow_tpu_torch.models import ScaleRotationEstimator
    from mrs_optic_flow_tpu_torch.parallel import BatchPipeline, make_mesh
    from mrs_optic_flow_tpu_torch.runtime import FleetServer
    from mrs_optic_flow_tpu_torch.runtime.serving import ServingLoop, ServingRequest

    cuda = dev.type == "cuda"
    mesh = make_mesh(SLICE_SHARDS, device="cuda:0" if cuda else "cpu")
    out = {}

    n = SLICE_FLEET_STREAMS
    tex = np.clip(np.rint(smooth_random_image(np.random.default_rng(0), 1024, cutoff=0.25)), 0,
                  255).astype(np.uint8)
    kw = dict(camera_matrix=np.array([[FX, 0, 376.0], [0, FY, 240.0], [0, 0, 1]], np.float32),
              dist_coeffs=np.zeros(5, np.float32), device=dev)
    fleets = [FleetServer(BatchPipeline(**kw), n, seed=1),
              FleetServer(BatchPipeline(**kw, mesh=mesh), n, seed=1)]
    heights = np.array([FLEET_H[i % len(FLEET_H)] for i in range(n)])
    diff = worst = 0.0
    for t in range(SLICE_FLEET_TICKS):
        frames = fleet_frames(tex, t, n)
        ticks = []
        for fleet in fleets:
            wrappers = reset_launches()
            ticks.append(fleet.tick(frames, np.full(n, t * DT), heights).materialize())
            got = add_launches(total, wrappers) if fleet is fleets[1] else None
            if t and cuda and got is not None:
                check(got["phase_correlate_frames"] == SLICE_SHARDS, f"fleet tick {t}: {got}")
        u, s = ticks
        check(np.array_equal(u.ok, s.ok), f"fleet tick {t}: ok differs sharded and unsharded")
        diff = max(diff, shift_diff(s.tran, u.tran))
        worst = max(worst, worst_err(s.tran, fleet_truth(n, heights), s.ok))
        check(t == 0 or s.ok.mean() >= SERVING_OK_SHARE, f"fleet tick {t}: {s.ok.mean()} ok")
    check(diff <= SHARD_TRAN_TOL and worst <= TWIST_TOL, f"fleet: {diff} m/s apart, error {worst}")
    out["fleet"] = {"streams": n, "ticks": SLICE_FLEET_TICKS, "max_tran_diff": diff,
                    "max_twist_err": worst}

    m = SLICE_SR_STREAMS
    sr = ScaleRotationEstimator(device=dev)
    kw_sq = dict(kw, camera_matrix=np.array([[FX, 0, 240.0], [0, FY, 240.0], [0, 0, 1]], np.float32))
    fleets = [FleetServer(BatchPipeline(**kw_sq, scale_rotation=sr), m, seed=2),
              FleetServer(BatchPipeline(**kw_sq, scale_rotation=sr, mesh=mesh), m, seed=2)]
    check(all(f._sr_fused for f in fleets), "the scale/rotation leg is not fused")
    steps = [SR_FLEET_STEPS[i % len(SR_FLEET_STEPS)] for i in range(m)]
    seqs = [render_affine(3, deg, zoom, seed=i) for i, (deg, zoom) in enumerate(steps)]
    sr_diff = sr_err = 0.0
    for t in range(3):
        frames = np.stack([q[t] for q in seqs])
        ticks = []
        for fleet in fleets:
            wrappers = reset_launches()
            ticks.append(fleet.tick(frames, np.full(m, t * DT), np.full(m, HEIGHT)).materialize())
            got = add_launches(total, wrappers) if fleet is fleets[1] else None
            if t and cuda and got is not None:
                check(got["phase_correlate_frames"] == SLICE_SHARDS
                      and got["peak_refine_raw"] == SLICE_SHARDS, f"scale/rotation tick {t}: {got}")
        if t:
            u, s = ticks
            sr_diff = max(sr_diff, shift_diff(s.scale, u.scale), shift_diff(s.rotation, u.rotation))
            sr_err = max(sr_err, float(np.abs(np.rad2deg(s.rotation) - [d for d, _ in steps]).max()))
    check(sr_diff <= SHARD_DECODE_TOL and sr_err <= SR_ROT_TOL, f"scale/rotation: {sr_diff}, {sr_err}")
    out["scale_rotation_fleet"] = {"streams": m, "max_decode_diff": sr_diff, "rot_err_deg": sr_err}

    prev_np, curr_np, v = serving_pairs()
    reqs = [ServingRequest(prev=prev_np[i % len(v)], curr=curr_np[i % len(v)], height=HEIGHT, dt=DT)
            for i in range(SLICE_SERVING_REQUESTS)]
    cam = kw_sq["camera_matrix"]
    res = []
    for mesh_arg in (None, mesh):
        pipe = BatchPipeline(camera_matrix=cam, dist_coeffs=np.zeros(5, np.float32), mesh=mesh_arg,
                             device=dev)
        loop = ServingLoop(pipe, batch_size=SLICE_SERVING_BATCH, depth=2, seed=3)
        wrappers = reset_launches()
        res.append(list(loop.run(reqs)))
        got = add_launches(total, wrappers) if mesh_arg is not None else None
    batches = SLICE_SERVING_REQUESTS // SLICE_SERVING_BATCH
    if cuda:
        check(got["phase_correlate_frames"] == batches * SLICE_SHARDS, f"ServingLoop: {got}")
    u, s = res
    check(len(s) == SLICE_SERVING_REQUESTS and all(a.ok == b.ok for a, b in zip(s, u)),
          "ServingLoop: ok differs sharded and unsharded")
    loop_shift = max(shift_diff(a.shifts, b.shifts) for a, b in zip(s, u))
    loop_tran = max(shift_diff(a.tran, b.tran) for a, b in zip(s, u))
    check(loop_shift <= SHARD_SHIFT_TOL and loop_tran <= SHARD_TRAN_TOL,
          f"ServingLoop: {loop_shift} px, {loop_tran} m/s")
    out["serving_loop"] = {"requests": len(s), "max_shift_diff": loop_shift, "max_tran_diff": loop_tran}
    return out


def slice_filters(dev, grays, total: dict) -> dict:
    """(d) ``estimate_tran_rot_vvel`` and the allsac helpers on the card
    against the CPU: ``tests/test_filters.py``'s translation, rotation and
    scale cases, and the 3x3 grid of window shifts of phase 5's first pair
    (method 4 at patch 160, kernel A)."""
    import torch

    from mrs_optic_flow_tpu_torch.filters import (
        allsac_mean_1d, bound_abs_mask, bound_radius_mask, estimate_tran_rot_vvel, rotate_2d,
    )
    from mrs_optic_flow_tpu_torch.models import FftMethod, FftMethodConfig

    def column_major(r):  # cell -> (vx, vy) in the flipped-y frame -> the [9, 2] input
        return np.array([[r[k][0], -r[k][1]] for k in (1, 4, 7, 2, 5, 8, 3, 6, 9)], np.float32)

    c, z = 0.5, 0.25
    eng = FftMethod(FftMethodConfig(sample_point_size=160), device=dev)
    wrappers = reset_launches()
    state, _ = eng.step(eng.init_state(), grays[0])
    _, res = eng.step(state, grays[1])
    add_launches(total, wrappers)
    # field order i + 3j (x fastest) to the column-major r1 r4 r7 r2 ...
    grid = res.shifts.reshape(3, 3, 2).transpose(0, 1).reshape(9, 2)
    cases = {
        "translation": (np.tile(np.float32([4.0, -2.0]), (9, 1)),
                        (40.0, 400.0, 400.0, 2.0, 100.0, 0.1, 5.0, 5.0)),
        "rotation": (column_major({1: (c, c), 9: (-c, -c), 3: (c, -c), 7: (-c, c), 4: (0, c),
                                   6: (0, -c), 2: (c, 0), 8: (-c, 0), 5: (0, 0)}),
                     (1.0, 400.0, 400.0, 2.0, 100.0, 1.0, 5.0, 5.0)),
        "scale": (column_major({1: (-z, z), 9: (z, -z), 3: (z, z), 7: (-z, -z), 4: (-z, 0),
                                6: (z, 0), 2: (0, z), 8: (0, -z), 5: (0, 0)}),
                  (1.0, 400.0, 400.0, 2.0, 100.0, 1.0, 5.0, 5.0)),
        "phase 5 grid": (grid.cpu().numpy(), (160.0, FX, FY, HEIGHT, 0.01, DT, 5.0, 5.0)),
    }
    worst, grid_out = 0.0, None
    for label, (vec, args) in cases.items():
        on_card = estimate_tran_rot_vvel(torch.from_numpy(vec).to(dev), *args)
        on_cpu = estimate_tran_rot_vvel(torch.from_numpy(vec), *args)
        scale = max(1.0, float(np.nanmax(np.abs(vec))))
        for a, b in zip(on_card, on_cpu):
            d = shift_diff(a, b)
            check(d <= FILTER_TOL * max(scale, float(b.abs().nan_to_num().max())),
                  f"tran_rot_vvel {label}: card and CPU {d} apart")
            worst = max(worst, d)
        if label == "phase 5 grid":
            grid_out = [x.cpu().numpy().tolist() for x in on_card]
            mean = np.nanmean(vec, axis=0)
            check(np.abs(np.asarray(grid_out[0]) - mean).max() < 0.05
                  and abs(grid_out[1]) < 0.05 and abs(grid_out[2]) < 0.05,
                  f"phase 5 grid: tran {grid_out[0]}, rot {grid_out[1]}, vvel {grid_out[2]} "
                  f"(mean shift {mean})")
    vals = torch.tensor([1.0, 1.05, 0.98, 5.0, 1.01])
    pts = torch.tensor([[3.0, 4.0], [0.1, 0.1], [np.nan, 1.0]])
    helpers = {
        "allsac_mean_1d": lambda d: allsac_mean_1d(vals.to(d), torch.ones(5, dtype=torch.bool, device=d),
                                                   0.2),
        "rotate_2d": lambda d: (rotate_2d(pts.to(d), 0.7),),
        "bound_abs_mask": lambda d: (bound_abs_mask(pts.to(d), 5.1), bound_abs_mask(vals.to(d), 1.0)),
        "bound_radius_mask": lambda d: (bound_radius_mask(pts.to(d), [3.0, 3.5], 1.0),),
    }
    for label, fn in helpers.items():
        for a, b in zip(fn(dev), fn(torch.device("cpu"))):
            d = shift_diff(a.float(), b.float())
            check(d <= FILTER_TOL * 5.0, f"{label}: card and CPU {d} apart")
            worst = max(worst, d)
    mean, chosen = allsac_mean_1d(vals.to(dev), torch.ones(5, dtype=torch.bool, device=dev), 0.2)
    check(int(chosen) == 4 and abs(float(mean) - np.mean([1.0, 1.05, 0.98, 1.01])) < 1e-6, "allsac_1d")
    return {"max_card_cpu_diff": worst, "phase5_grid": grid_out}


def slice_profiler(dev, frames, total: dict) -> dict:
    """(e) The method-4 node with ``Profiler(event_log_path, trace_dir)``
    under ``start_device_trace``/``stop_device_trace``: the exported trace
    holds kernel A's CUDA kernel and one range a frame program, the event
    log one line a routine call."""
    import tempfile

    from mrs_optic_flow_tpu_torch.config import NodeConfig
    from mrs_optic_flow_tpu_torch.runtime.profiler import Profiler

    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        node = level_node(dev, NodeConfig(), [])
        node.warmup()
        log = pathlib.Path(tmp) / "events.jsonl"
        node.profiler = prof = Profiler("OpticFlow", event_log_path=str(log),
                                        trace_dir=str(pathlib.Path(tmp) / "trace"))
        wrappers = reset_launches()
        prof.start_device_trace()
        feed_node(node, frames[:SLICE_TRACED_FRAMES])
        path = prof.stop_device_trace()
        prof.close()
        n_a = add_launches(total, wrappers)["phase_correlate_frames"]
        lines = [json.loads(x) for x in log.read_text().splitlines()]
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    names = [e.get("name") or "" for e in events]
    counts = {k: st["count"] for k, st in prof.stats().items()}
    logged = {k: sum(1 for e in lines if e["routine"] == k) for k in counts}
    check(logged == counts and len(lines) == sum(counts.values()), f"event log {logged}, stats {counts}")
    frames_run = counts.get("frame_program", 0)
    # the host's range; on the card the trace also mirrors it as a gpu_user_annotation
    ranges = sum(1 for e in events if e.get("name") == "frame_program"
                 and e.get("cat") == "user_annotation")
    a_in_trace = sum(1 for x in names if A_KERNEL.search(x))
    check(frames_run == SLICE_TRACED_FRAMES - 1 and ranges == frames_run,
          f"{frames_run} frame programs, {ranges} ranges in the trace")
    if dev.type == "cuda":
        check(n_a == frames_run and a_in_trace >= 1, f"kernel A: {n_a} launches, {a_in_trace} in the trace")
    return {"log_lines": len(lines), "frame_program_ranges": ranges, "kernel_a_in_trace": a_in_trace,
            "kernel_a_launches": n_a}


def run_slice(dev) -> dict:
    """Phase 17.  Returns its line's object, with ``launches``: each
    kernel's launches on the paths that phase 17 drives (not in the
    comparisons), kernel E none."""
    t0 = time.perf_counter()
    total = {name: 0 for name in KERNELS}
    frames = render_frames(N_FRAMES)
    grays = gray_crops(dev, frames)
    parts = {}

    def part(name, fn):
        t = time.perf_counter()
        got = fn()
        parts[name] = time.perf_counter() - t
        return got

    out = {"calc": part("calc", lambda: slice_calc(dev, grays, total)),
           "mesh": part("mesh", lambda: slice_mesh(dev, total))}
    out.update(part("serving", lambda: slice_serving(dev, total)))
    out["filters"] = part("filters", lambda: slice_filters(dev, grays, total))
    out["profiler"] = part("profiler", lambda: slice_profiler(dev, frames, total))
    out["launches"] = total
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------- #
# phase 18: the measurement and tuning layer                                   #
# --------------------------------------------------------------------------- #

#: kernel A's variants (PCF_THREADS); 256 is the source's default
TOOLS_A_THREADS = (128, 256, 512)
#: kernel C's variants (SAD_TI, SAD_TJ, SAD_WARPS); the first is the default
TOOLS_C_TILES = ((2, 11, 8), (2, 8, 8))
TOOLS_GEOMETRY_SWEEP = (64, 256)
TOOLS_SR_STREAMS = 4
TOOLS_ACCURACY_PAIRS = 8
TOOLS_NODE_FRAMES = 10
#: keys each script's lines must carry, by metric
TOOLS_KEYS = {
    "phase_correlate_frames_threads": ("threads", "batch", "max_err_twin_px", "max_err_oracle_px",
                                       "bit_equal", "ms", "own_ms", "frame_pairs_per_s", "rate_min",
                                       "rate_max", "window_rates", "bound_ms", "bound_share",
                                       "library_ms", "blocks_per_sm", "card"),
    "sad_block_method_ms_per_frame": ("kernel", "plain", "library", "card"),
    "sad_search_tile": ("tile", "geometry", "built", "exact", "bit_equal", "geometry_mirrors_library",
                        "ms", "own_ms", "bound_ms", "bound_share", "card"),
    "scale_rotation_lanczos4_480_ms_per_frame": ("step", "batch_carried", "ignored", "card"),
    "get_rt_batch": ("ransac_iterations", "wall_ms", "device_ms", "kernels", "idle_share", "bound_ms",
                     "bound_by", "bound_materialized_ms", "ops", "bytes", "card"),
    "flow_accuracy_px": ("route", "max_vs_truth_px", "mean_vs_truth_px", "max_vs_oracle_px", "card"),
    "sr_node_decodes": ("rotating", "hovering", "ok", "card"),
    "sr_chain": ("without_sr", "with_sr", "sr_leg", "chain_without_host_sync", "node", "ok", "card"),
}


def start_tool_builds() -> dict:
    """Phase 18's variant builds, started beside phase 2's: ``{"a": ...,
    "c": ...}``, for :func:`run_tools_apart`."""
    from scripts import tune_frames_kernel_torch as tf
    from scripts import tune_sad_kernel_torch as ts

    return {"a": tf.start_builds(TOOLS_A_THREADS), "c": ts.start_builds(TOOLS_C_TILES)}


#: phase 18's process may take this long [s]
TOOLS_TIMEOUT_S = 300


def run_tools_apart(jobs: dict) -> dict:
    """Phase 18 in a process of its own (:func:`tools_process`), after its
    variant builds: in one long process ``torch.profiler``'s traces drop
    device events (phase 15's hold one of two A launches), and after phase
    17 a trace of 200 A launches came back empty three times in a row.  The
    process prints its lines to this one's standard output.  Returns its
    line's object."""
    import tempfile

    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck

    built = {"a": {str(t): r for t, r in ck.finish_variants(jobs["a"]).items()},
             "c": {"x".join(map(str, t)): r for t, r in ck.finish_variants(jobs["c"]).items()}}
    with tempfile.TemporaryDirectory(dir=ck.BUILD_DIR) as tmp:
        io = pathlib.Path(tmp)
        (io / "built.json").write_text(json.dumps(built))
        code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/tests']; "
                "import chip_smoke; chip_smoke.tools_process(sys.argv[2])")
        sys.stdout.flush()
        proc = subprocess.run([sys.executable, "-c", code, str(REPO), tmp], cwd=REPO,
                              timeout=TOOLS_TIMEOUT_S)
        check(proc.returncode == 0, f"phase 18's process exited {proc.returncode}")
        return json.loads((io / "out.json").read_text())


def tools_process(io_dir: str) -> None:
    """Phase 18's process: the variant builds' results from
    ``built.json`` in ``io_dir``, :func:`run_tools` on the card, its object
    into ``out.json``."""
    import torch

    io = pathlib.Path(io_dir)
    built = json.loads((io / "built.json").read_text())
    built = {"a": {int(t): r for t, r in built["a"].items()},
             "c": {tuple(int(v) for v in k.split("x")): r for k, r in built["c"].items()}}
    out = run_tools(torch.device("cuda"), built)
    (io / "out.json").write_text(json.dumps(out))


def finite_values(x, where: str) -> None:
    """Every number in ``x`` (nested dicts and lists) finite, none null."""
    if isinstance(x, dict):
        for k, v in x.items():
            finite_values(v, f"{where}.{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            finite_values(v, f"{where}[{i}]")
    else:
        check(x is not None and (not isinstance(x, float) or math.isfinite(x)), f"{where} = {x}")


def check_tool_rows(rows: list, label: str) -> None:
    check(rows, f"{label}: no line")
    for row in rows:
        if row.get("route") == "summary":
            check(row["ok"], f"{label}: {row}")
            continue
        keys = TOOLS_KEYS[row["metric"]]
        missing = [k for k in keys if k not in row or row[k] is None]
        check(not missing, f"{label}: {row['metric']} lacks {missing}: {row}")
        finite_values({k: row[k] for k in keys}, f"{label}.{row['metric']}")


def run_tools(dev, built: dict) -> dict:
    """Phase 18, given its variant builds' results (``{"a": {threads:
    result}, "c": {tile: result}}``, ``cuda_kernels.finish_variants``).
    Returns its line's object."""
    from mrs_optic_flow_tpu_torch.utils import benchlib
    from scripts import accuracy_report_torch as acc
    from scripts import profile_geometry_torch as pg
    from scripts import tune_frames_kernel_torch as tf
    from scripts import tune_sad_kernel_torch as ts
    from scripts import tune_scale_rotation_torch as tsr
    from scripts import verify_sr_fused_torch as vsr

    t0 = time.perf_counter()
    seconds, out = {}, {}

    def part(name, module, argv, **kw):
        t = time.perf_counter()
        rows = []
        ok = module.run(module.parse_args(argv), rows.append, **kw)
        seconds[name] = time.perf_counter() - t
        for row in rows:
            say(f"  {name}: {json.dumps(row)}")
        check(ok, f"{name}: a check of the script failed")
        check_tool_rows(rows, name)
        return rows

    t = time.perf_counter()
    node = benchlib.measure_node_latency(TOOLS_NODE_FRAMES, warmup=3, n_distinct=8, device=dev)
    seconds["node_latency"] = time.perf_counter() - t
    finite_values(node, "measure_node_latency")
    out["node_latency"] = node

    threads = ",".join(map(str, TOOLS_A_THREADS))
    rows = part("tune_frames", tf, ["--threads", threads, "--batches", f"1,{BENCH_BATCH}", "--iters", "2"],
                built=built["a"])
    check(len(rows) == 2 * len(TOOLS_A_THREADS), f"{len(rows)} kernel A variant lines")
    for r in rows:
        check(max(r["max_err_twin_px"], r["max_err_oracle_px"]) <= SHIFT_TOL, f"kernel A variant {r}")
    check(all(r["bit_equal"] for r in rows if r["threads"] == 256),
          "kernel A built with the default PCF_THREADS differs from the shipped kernel")
    out["kernel_a"] = {f"{r['threads']}x{r['batch']}": {k: r[k] for k in ("own_ms", "ms", "frame_pairs_per_s",
                                                                          "bound_share", "bit_equal")}
                       for r in rows}

    tiles = ",".join("x".join(map(str, t)) for t in TOOLS_C_TILES)
    rows = part("tune_sad", ts, ["--engines", "block_method", "--k", "6", "--reps", "2", "--tiles", tiles],
                built=built["c"])
    variants = [r for r in rows if r["metric"] == "sad_search_tile"]
    check(len(variants) == len(TOOLS_C_TILES) and all(r["exact"] for r in variants),
          "kernel C variants against the twin")
    check(all(r["bit_equal"] for r in variants if r["shipped"]),
          "kernel C built with the default tile differs from the shipped kernel")
    out["kernel_c"] = {"x".join(map(str, r["tile"])): {k: r[k] for k in ("own_ms", "ms", "bound_share", "bit_equal")}
                       for r in variants}

    rows = part("tune_scale_rotation", tsr, ["--configs", "lanczos4_480", "--streams", str(TOOLS_SR_STREAMS),
                                             "--k", "6", "--reps", "2"])
    out["scale_rotation"] = {"step": rows[0]["step"], "batch_carried": rows[0]["batch_carried"]}

    rows = part("profile_geometry", pg, ["--reps", "3"], sweep=list(TOOLS_GEOMETRY_SWEEP), batch=BENCH_BATCH)
    out["geometry"] = {r["ransac_iterations"]: {k: r[k] for k in ("wall_ms", "device_ms", "bound_ms", "bound_by",
                                                                    "bound_materialized_ms", "idle_share")}
                       for r in rows}

    rows = part("accuracy", acc, ["--pairs", str(TOOLS_ACCURACY_PAIRS), "--kernel-tol", str(SHIFT_TOL)])
    out["accuracy"] = {r["route"]: r["max_vs_oracle_px"] for r in rows}

    rows = part("verify_sr", vsr, ["--frames", "4", "--k", "4", "--reps", "2"])
    out["verify_sr"] = {"sr_leg": rows[1]["sr_leg"], "node": rows[1]["node"]}

    # repair F13: the methods-3 and -5 nodes read their frame back once
    from mrs_optic_flow_tpu_torch.config import NodeConfig
    from mrs_optic_flow_tpu_torch.runtime.msgs import ImageMsg

    t = time.perf_counter()
    frames = render_frames(4)
    out["readbacks"] = {}
    for method in (3, 5):
        node = level_node(dev, NodeConfig(method=method), [])
        feed_node(node, frames[:2])
        msgs = iter([ImageMsg(stamp=100.0 + DT * i, data=frames[i]) for i in (2, 3)])
        prof = benchlib.profile_calls(lambda: node.on_image(next(msgs)), 2)
        check(prof["readbacks"] == 1, f"method {method}: {prof['readbacks']} device-to-host copies a frame")
        out["readbacks"][f"method {method}"] = prof["readbacks"]
    seconds["readbacks"] = time.perf_counter() - t

    out["part_seconds"] = seconds
    out["seconds"] = time.perf_counter() - t0
    return out


def twist_diff(pub_a, pub_b) -> float:
    """Largest difference [m/s] between two runs' twists, topic by topic and
    stamp by stamp (x and y; both runs must publish the same stamps)."""
    worst = 0.0
    for topic in ("velocity_out", "velocity_out_longrange"):
        a = {m.stamp: m.linear[:2] for t, m in pub_a if t == topic}
        b = {m.stamp: m.linear[:2] for t, m in pub_b if t == topic}
        check(a.keys() == b.keys(), f"{topic}: stamps differ")
        for k in a:
            worst = max(worst, float(np.abs(np.subtract(a[k], b[k])).max()))
    return worst


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", metavar="NAME=PATH", action="append", default=[],
                        help="also time kernel NAME built from the source PATH in turns with the "
                             "kernel from csrc/ (repeatable)")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device")
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    from mrs_optic_flow_tpu_torch.ops import cuda_kernels

    smi = card_name()
    say(smi)
    check(torch.get_float32_matmul_precision() == "highest", "float32 matmul precision")
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are enabled")
    say(f"[1 device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    tool_jobs = start_tool_builds()  # phase 18's variants, compiled beside the kernels
    logs = cuda_kernels.build()
    for name, log in logs.items():
        cuda_kernels.load_library(name)
        for line in ptxas_lines(log):
            say(f"  ptxas {name}: {line}")
    check_route_constants()
    build_baselines(args.baseline)
    say(f"[2 build] {time.perf_counter() - t0:.1f} s")

    dev = torch.device("cuda")
    err_a = check_kernel(dev)
    ms_a, own_a, plain_a, lib_a, lib_own_a = measure_throughput(dev)
    if "phase_correlate_frames" in BASELINES:
        compare_kernel_a(dev)
    launches_a = run_node(dev)
    check(launches_a >= N_FRAMES - 1, f"{launches_a} kernel launches for {N_FRAMES - 1} processed frames")
    b = check_peak_kernel(dev)
    c = check_sad_kernel(dev)
    launches_b = run_scale_rotation_node(dev)
    launches_c = run_block_matching_nodes(dev)
    d = check_fullfused_kernel(dev)
    e = check_fused_kernel(dev)
    launches_d, _ = run_long_range_nodes(dev)
    run_frame_graphs(dev)
    check_sad_large(dev)
    check_tf32(dev)
    serving = run_serving(dev)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        flights, live_ref = run_flights(dev, pathlib.Path(tmp))
        t19 = time.perf_counter()
        flights["live_nodes"] = run_live_nodes(dev, live_ref, pathlib.Path(tmp))
        say(f"[19 live nodes] {time.perf_counter() - t19:.1f} s")
    slice_out = run_slice(dev)
    mesh = slice_out["mesh"]
    say(f"[17 slice] {slice_out['seconds']:.1f} s; frame-pairs/s at B = {SLICE_BENCH_PAIRS}: step_batch "
        f"{mesh['step_batch_frame_pairs_per_s']:.1f}, sharded_flow_step one card "
        f"{mesh['one card']['frame_pairs_per_s']:.1f}, {SLICE_SHARDS} shards "
        f"{mesh[f'{SLICE_SHARDS} shards']['frame_pairs_per_s']:.1f}; "
        + json.dumps({k: v for k, v in slice_out.items() if k != "seconds"}))
    tools = run_tools_apart(tool_jobs)
    say(f"[18 tools] {tools['seconds']:.1f} s; " + json.dumps({k: v for k, v in tools.items() if k != "seconds"}))

    # each kernel at the shape its row times: (launches, error, ms through
    # the wrapper, own ms, plain ms, library ms or None, library own ms or
    # None, the bound there)
    b1 = b["1x480"]
    d60 = d["64x60 u8"]
    e120 = e["16x120"]
    rows = {
        "phase_correlate_frames": (launches_a, err_a, ms_a, own_a, plain_a, lib_a, lib_own_a,
                                   bound("phase_correlate_frames", b=1, n=120, q=4, itemsize=1)),
        "peak_refine_raw": (launches_b, b["err"], b1["ms"], b1["own_ms"], b1["plain_ms"], None, None,
                            bound("peak_refine_raw", p=1, n=480)),
        "sad_search": (launches_c, c["err"], c["ms"], c["own_ms"], c["plain_ms"], c["library_ms"],
                       c["library_own_ms"], bound("sad_search", g=9, s=120, r=21)),
        "phase_correlate_fullfused": (launches_d, d["err"], d60["ms"], d60["own_ms"], d60["plain_ms"],
                                      d60["library_ms"], d60["library_own_ms"],
                                      (d60["bound_ms"], d60["bound_by"])),
        "phase_correlate_fused": (e["launches"], e["err"], e120["ms"], e120["own_ms"],
                                  e120["plain_ms"], e120["library_ms"], e120["library_own_ms"],
                                  (e120["bound_ms"], e120["bound_by"])),
    }
    say(json.dumps({"serving": {"card": smi, **serving}}))
    say(json.dumps({"flights": {"card": smi, **flights}}))
    say(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": KERNELS[name][0],
        "replaces": KERNELS[name][1],
        "launches": launches,
        "flight_launches": flights["launches"][name],
        "slice_launches": slice_out["launches"][name],
        "max_abs_err": err,
        "ms": ms,
        "own_ms": own,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
        "library_own_ms": lib_own,
    } for name, (launches, err, ms, own, plain_ms, lib_ms, lib_own, (bound_ms, bound_by))
        in rows.items()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
