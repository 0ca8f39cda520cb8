#!/usr/bin/env python3
"""Measure the SAD engines (methods 3 and 5) and sweep kernel C's register
tile on one CUDA card.

    python3 scripts/tune_sad_kernel_torch.py [--k 32] [--tiles 2x11x8,1x11x8,...]
        [--budget-s 900] [--device cuda|cpu]

1. ``BlockMethod.step`` and ``FastSpacedBM.step`` at the reference geometry
   (480 px frames, 120 px blocks, radius 21: 9 cells each) on frames of a
   random texture rolled 3 px a frame, with kernel C (``use_pallas``) and
   with the plain SAD search: the wall time a frame (the slope of
   ``benchlib.measure_scan_slope`` between a ``k/4``- and a ``k``-frame
   chain, each read back once) and the device time, kernels and idle share
   a frame (``benchlib.profile_calls``).  Beside them, as the library line
   and never a route of the engines, ``torch.cdist(p=1)`` computing the same
   SAD maps from the regions' unfold.  One JSON line an engine.
2. Kernel C's register tile: each ``TIxTJxWARPS`` of ``--tiles`` builds
   ``csrc/sad_search.cu`` with ``-DSAD_TI=TI -DSAD_TJ=TJ -DSAD_WARPS=WARPS``
   into its own library under ``build/torch_kernels/`` (all compiles at
   once); its launch geometry comes from ``cuda_kernels.sad_geometry(...,
   tile=(TI, TJ, WARPS))`` and is held to the library's own
   ``sad_smem_bytes``, ``sad_scratch_doubles`` and ``sad_counters``.  Each
   variant's maps must equal the twin's exactly on integer inputs at G = 9
   and G = 1 (and the shipped kernel's, ``bit_equal``); one that fails to
   build or to agree prints a line saying so and is not timed.  Each line:
   the geometry, ``own_ms`` and ``ms`` at G = 9, the bound and its share,
   and the ``ptxas`` lines.

Each line carries the card's ``nvidia-smi`` name and power limit.  With
``--device cpu`` part 1 runs the engines' plain twins on the CPU (no device
time) and part 2 prints each tile's geometry without building it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

S, R = 120, 21  # block and radius: src/BlockMethod.cpp:25-57
DEFAULT_TILES = "2x11x8,1x11x8,2x8x8,4x8x8,2x16x8,2x11x4,2x11x16"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=32, help="frames of the longer chain")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--size", type=int, default=480, help="frame side")
    ap.add_argument("--tiles", default=DEFAULT_TILES, help="comma-separated TIxTJxWARPS")
    ap.add_argument("--engines", default="block_method,fast_spaced_bm")
    ap.add_argument("--budget-s", type=float, default=900.0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def tile_of(spec: str) -> tuple:
    ti, tj, warps = (int(v) for v in spec.split("x"))
    return ti, tj, warps


def defines_of(tile) -> dict:
    return dict(zip(("SAD_TI", "SAD_TJ", "SAD_WARPS"), tile))


def engine_frames(dev, k: int, size: int):
    """``k`` float32 frames: a random uint8-valued texture rolled 3 px a frame."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    base = torch.randint(0, 255, (size, size), generator=gen, device=dev).to(torch.float32)
    return [torch.roll(base, 3 * i, dims=0) for i in range(k)]


def measure_engine(engine, frames, reps: int, dev) -> dict:
    """Wall slope a frame and, on the card, device time a frame."""
    import torch

    from mrs_optic_flow_tpu_torch.utils import benchlib

    holder = {"state": engine.init_state()}

    def steps(n):
        acc = torch.zeros((), device=dev)
        for f in frames[:n]:
            holder["state"], res = engine.step(holder["state"], f)
            acc = acc + torch.nansum(res.shifts) + torch.sum(res.response)
        return acc

    def build(kk):
        return lambda i: float(steps(kk).item())

    k = len(frames)
    slope = benchlib.measure_scan_slope(build, (max(k // 4, 1), k), reps=reps, warmup=1)
    out = {"wall_ms_per_frame": slope["per_item_ms"], "slope_ok": slope["reliable"],
           "chain_medians_ms": slope["med_ms"], "jitter_ms": slope["jitter_ms"]}
    if dev.type == "cuda":
        prof = benchlib.profile_calls(lambda: steps(k), 1)
        out.update(device_ms_per_frame=prof["device_ms"] / k, kernels_per_frame=prof["kernels"] / k,
                   idle_share=prof["idle_share"])
    else:
        out.update(device_ms_per_frame=None, kernels_per_frame=None, idle_share=None)
    return out


def library_line(g: int, dev) -> dict:
    """``torch.cdist(p=1)`` over ``g`` cells' blocks and the unfold of their
    regions: the SAD maps kernel C computes at the engine's shapes, held to
    the plain SAD search and timed (one PyTorch call)."""
    import torch

    from mrs_optic_flow_tpu_torch.ops import block_matching
    from mrs_optic_flow_tpu_torch.utils import benchlib

    d = 2 * R + 1
    curr, prev = sad_inputs(dev, g)
    windows = prev.unfold(1, S, 1).unfold(2, S, 1).reshape(g, d * d, S * S)
    flat = curr.reshape(g, 1, S * S)
    lib_map = torch.cdist(flat, windows, p=1).reshape(g, d, d)
    twin = block_matching.sad_search(curr, prev, block_size=S, scan_radius=R)
    rel = float(((lib_map - twin).abs() / twin.abs().clamp_min(1e-30)).max())
    out = {"route": "torch.cdist(p=1)", "cells": g, "max_rel_diff": rel}
    if dev.type == "cuda":
        out.update(ms=benchlib.time_cuda(lambda: torch.cdist(flat, windows, p=1), 20),
                   own_ms=benchlib.own_ms(lambda: torch.cdist(flat, windows, p=1), 20))
    else:
        out.update(ms=None, own_ms=None)
    return out


def engine_rows(args, dev, base, emit) -> None:
    from mrs_optic_flow_tpu_torch.models import (
        BlockMethod,
        BlockMethodConfig,
        FastSpacedBM,
        FastSpacedBMConfig,
    )

    engines = {"block_method": (BlockMethod, BlockMethodConfig),
               "fast_spaced_bm": (FastSpacedBM, FastSpacedBMConfig)}
    frames = engine_frames(dev, args.k, args.size)
    for name in args.engines.split(","):
        ctor, cfg = engines[name]
        row = {**base, "metric": f"sad_{name}_ms_per_frame", "block": S, "radius": R}
        for key, use_pallas in (("kernel", True), ("plain", False)):
            eng = ctor(cfg(frame_size=args.size, sample_point_size=S, scan_radius=R,
                           use_pallas=use_pallas), device=dev)
            row[key] = measure_engine(eng, frames, args.reps, dev)
        row["library"] = library_line(eng.num_cells, dev)
        t = "device_ms_per_frame" if dev.type == "cuda" else "wall_ms_per_frame"
        row["faster"] = "kernel" if row["kernel"][t] < row["plain"][t] else "plain"
        emit(row)


def start_builds(tiles) -> dict:
    """Start one variant build a tile, all at once: ``{tile: jobs}``."""
    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck

    return {t: ck.start_build(["sad_search"], defines=defines_of(t)) for t in tiles}


def sad_inputs(dev, g: int, seed: int = 5):
    """Integer-valued float32 blocks ``[g, S, S]`` and regions."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    curr = torch.randint(0, 256, (g, S, S), generator=gen, device=dev).to(torch.float32)
    prev = torch.randint(0, 256, (g, S + 2 * R, S + 2 * R), generator=gen, device=dev).to(torch.float32)
    return curr, prev


def tile_rows(args, dev, base, emit, built=None) -> bool:
    """Part 2; ``built``: the variant builds' results
    (``cuda_kernels.finish_variants`` of :func:`start_builds`), when they
    were built earlier.  Returns whether every variant built and agreed."""
    import torch

    from mrs_optic_flow_tpu_torch.ops import block_matching
    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck
    from mrs_optic_flow_tpu_torch.utils import benchlib

    tiles = [tile_of(t) for t in args.tiles.split(",")]
    cuda = dev.type == "cuda"
    if cuda:
        built = built or ck.finish_variants(start_builds(tiles))
    ok = True
    for tile in tiles:
        geo = ck.sad_geometry(9, S, R, tile)
        row = {**base, "metric": "sad_search_tile", "tile": list(tile), "shipped": tile == ck.SAD_TILE,
               "geometry": geo._asdict()}
        if not cuda:
            emit({**row, "built": False, "reason": "CPU run: the variants build with nvcc and run on the card"})
            continue
        if "error" in built[tile]:
            emit({**row, "built": False, "error": built[tile]["error"]})
            ok = False
            continue
        lib = ck.load_variant("sad_search", defines_of(tile))
        row.update(built=True, ptxas=ck.ptxas_lines(built[tile]["log"]))
        # the Python geometry of this tile against the library's own
        mirrors = (lib.sad_smem_bytes(R, geo.xb) == geo.smem
                   and lib.sad_scratch_doubles(9, S, R, geo.xb) == geo.scratch
                   and lib.sad_counters(9, S, R, geo.xb) == geo.counters)
        exact, equal = True, True
        for g in (9, 1):
            curr, prev = sad_inputs(dev, g)
            try:
                got = ck.launch_sad_search(lib, curr, prev, block_size=S, scan_radius=R, tile=tile)
            except (RuntimeError, ValueError) as e:
                emit({**row, "error": f"launch failed: {e}"})
                ok = exact = False
                break
            twin = block_matching.sad_search(curr, prev, block_size=S, scan_radius=R)
            exact &= bool(torch.equal(got, twin))
            equal &= bool(torch.equal(got, ck.launch_sad_search(None, curr, prev, block_size=S,
                                                                scan_radius=R)))
        else:
            row.update(geometry_mirrors_library=mirrors, exact=exact, bit_equal=equal)
            if not (mirrors and exact):
                emit({**row, "error": "the geometry or the maps disagree"})
                ok = False
                continue
            curr, prev = sad_inputs(dev, 9)

            def launch(curr=curr, prev=prev, lib=lib, tile=tile):
                return ck.launch_sad_search(lib, curr, prev, block_size=S, scan_radius=R, tile=tile)

            bound_ms, by = benchlib.bound("sad_search", g=9, s=S, r=R)
            own = benchlib.own_ms(launch, 50)
            emit({**row, "ms": benchlib.time_cuda(launch, 50), "own_ms": own, "bound_ms": bound_ms,
                  "bound_by": by, "bound_share": bound_ms / own})
    return ok


def run(args, emit, built=None) -> bool:
    from mrs_optic_flow_tpu_torch.utils import benchlib
    from mrs_optic_flow_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    base = {"card": benchlib.card_name() if dev.type == "cuda" else "cpu"}
    if args.engines:
        engine_rows(args, dev, base, emit)
    return tile_rows(args, dev, base, emit, built)


def main(argv=None) -> int:
    from mrs_optic_flow_tpu_torch.utils import benchlib

    args = parse_args(argv)

    def emit(row):
        print(json.dumps(row), flush=True)

    with benchlib.time_budget(args.budget_s):
        try:
            return 0 if run(args, emit) else 1
        except TimeoutError as e:
            emit({"metric": "sad_search_tile", "timed_out": str(e)})
            return 3


if __name__ == "__main__":
    sys.exit(main())
