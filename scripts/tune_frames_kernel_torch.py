#!/usr/bin/env python3
"""Sweep kernel A's threads a block on one CUDA card.

    python3 scripts/tune_frames_kernel_torch.py [--threads 128,256,512]
        [--batches 1,16,4096] [--iters 8] [--budget-s 900] [--device cuda|cpu]

Kernel A (``csrc/phase_correlate_frames.cu``) runs one block a window; its
threads a block are the source's ``PCF_THREADS`` (256 when undefined: the
shipped kernel).  Each value of ``--threads`` builds a variant library,
``build/torch_kernels/libphase_correlate_frames_PCF_THREADS<T>.so``, one
``nvcc`` each, all started together.  Each variant is held against the twin
(``phase_correlate_frames_ref``) and the NumPy oracle on 16 of
``tests/oracle.py``'s accuracy pairs (480 px, 120 px windows, uint8) within
0.01 px, and against the shipped kernel on the same pairs (``bit_equal``).
A variant that fails to build or to agree prints a line saying so and is
not timed.  Then, at each batch of ``--batches`` uint8 480² frame pairs of
4x4 windows of 120 px made on the card, one JSON line a (variant, batch):

- ``own_ms``: the kernel's device time a call (``benchlib.own_ms``);
- ``ms``: a launch's time by CUDA events over back-to-back launches;
- ``frame_pairs_per_s`` with ``rate_min``, ``rate_max`` and
  ``window_rates``: ``benchlib.measure_chained_stats`` over
  ``benchlib.make_chained`` launches (each call's input bumped by the last
  result, each window read back);
- ``bound_ms`` and ``bound_by`` (``benchlib.bound``) and ``bound_share``,
  the bound over ``own_ms``;
- ``library_ms``: the stock ``torch.fft`` route on the same pairs
  (``phase_correlate_field(..., backend="fft")``), once a batch;
- ``blocks_per_sm`` (the occupancy query) and the ``ptxas`` lines.

Each line carries the card's ``nvidia-smi`` name and power limit.  With
``--device cpu`` nothing is built: each batch times the twin (the function
kernel A computes) on the CPU, with the keys the card's lines have and
null where a number exists only on the card.
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

SHIFT_TOL = 0.01  # px, a variant against the twin and the oracle
CHECK_PAIRS = 16
PATCH = 120


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", default="128,256,512", help="comma-separated PCF_THREADS values")
    ap.add_argument("--batches", default="1,16,4096", help="comma-separated frame pairs a call")
    ap.add_argument("--size", type=int, default=480, help="frame side (a multiple of 120)")
    ap.add_argument("--iters", type=int, default=8, help="timed calls of measure_chained_stats")
    ap.add_argument("--budget-s", type=float, default=900.0, help="raise TimeoutError after this")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def ms_of(fn, reps: int, dev) -> float:
    """Mean ms of ``fn()``: CUDA events on the card, the host clock on the CPU."""
    from mrs_optic_flow_tpu_torch.utils import benchlib

    return benchlib.time_cuda(fn, reps) if dev.type == "cuda" else benchlib.host_ms(fn, reps)


def check_pairs(dev, size: int):
    """16 accuracy pairs on ``dev`` and their oracle shifts."""
    import torch
    from oracle import make_accuracy_pairs

    prev, curr, _, oracle = make_accuracy_pairs(np.random.default_rng(0), CHECK_PAIRS, size=size,
                                                patch=PATCH)
    return torch.from_numpy(prev).to(dev), torch.from_numpy(curr).to(dev), oracle


def check_variant(launch, dev, pairs) -> dict:
    """A launch function against the twin and the oracle, and against the
    shipped kernel on the card."""
    import torch

    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck

    prev, curr, oracle = pairs
    mine = launch(curr, prev)
    shift = mine[0]
    twin = ck.phase_correlate_frames_ref(curr, prev, patch=PATCH)[0]
    out = {"max_err_twin_px": float((shift - twin).abs().max()),
           "max_err_oracle_px": float(np.abs(shift.cpu().numpy() - oracle).max())}
    out["agrees"] = max(out["max_err_twin_px"], out["max_err_oracle_px"]) <= SHIFT_TOL
    out["bit_equal"] = None
    if dev.type == "cuda":
        shipped = ck.launch_phase_correlate_frames(None, curr, prev, patch=PATCH)
        out["bit_equal"] = all(bool(torch.equal(a, b)) for a, b in zip(mine, shipped))
    return out


def time_batch(launch, curr, prev, dev, iters: int) -> dict:
    """One variant at one batch: own time, launch time, chained rate."""
    from mrs_optic_flow_tpu_torch.utils import benchlib

    b = curr.shape[0]
    reps = max(3, min(200, 4096 // b))
    out = {"ms": ms_of(lambda: launch(curr, prev), reps, dev),
           "own_ms": benchlib.own_ms(lambda: launch(curr, prev), reps) if dev.type == "cuda" else None}

    def step(p, c):
        shift, maxval = launch(c, p)
        return shift, maxval.nansum()

    stats = benchlib.measure_chained_stats(benchlib.make_chained(step), prev, curr, items_per_call=b,
                                           iters=iters, warmup=2)
    out.update(frame_pairs_per_s=stats["rate"], rate_min=stats["rate_min"], rate_max=stats["rate_max"],
               window_rates=stats["window_rates"])
    bound_ms, by = benchlib.bound("phase_correlate_frames", b=b, n=PATCH, q=curr.shape[-1] // PATCH,
                                  itemsize=1)
    out.update(bound_ms=bound_ms, bound_by=by,
               bound_share=bound_ms / out["own_ms"] if out["own_ms"] else None)
    return out


def library_ms(curr, prev, dev) -> float:
    """The stock ``torch.fft`` route on the same pairs, ms a call."""
    import torch

    from mrs_optic_flow_tpu_torch.ops.phase_correlate import phase_correlate_field
    from mrs_optic_flow_tpu_torch.ops.preprocess import patchify

    ms = ms_of(lambda: phase_correlate_field(patchify(curr, PATCH), patchify(prev, PATCH), backend="fft"),
               3, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ms


def start_builds(threads) -> dict:
    """Start one variant build a value of ``threads`` (``PCF_THREADS``), all
    at once: ``{threads: cuda_kernels.start_build's jobs}``."""
    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck

    return {t: ck.start_build(["phase_correlate_frames"], defines={"PCF_THREADS": t}) for t in threads}


def run(args, emit, built=None) -> bool:
    """Every (variant, batch) line through ``emit``; ``built``: the variant
    builds' results (``cuda_kernels.finish_variants`` of
    :func:`start_builds`), when they were built earlier.  Returns whether
    every variant built and agreed."""
    import torch

    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck
    from mrs_optic_flow_tpu_torch.utils import benchlib
    from mrs_optic_flow_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    batches = [int(b) for b in args.batches.split(",")]
    base = {"metric": "phase_correlate_frames_threads", "size": args.size, "patch": PATCH,
            "dtype": "uint8", "card": benchlib.card_name() if cuda else "cpu"}
    pairs = check_pairs(dev, args.size)

    # the variants: (threads, launch function, build facts); the CPU's one "variant" is the twin
    variants, ok = [], True
    if cuda:
        built = built or ck.finish_variants(start_builds([int(t) for t in args.threads.split(",")]))
        for t, result in built.items():
            if "error" in result:
                emit({**base, "threads": t, "built": False, "error": result["error"]})
                ok = False
                continue
            lib = ck.load_variant("phase_correlate_frames", {"PCF_THREADS": t})

            def launch(c, p, lib=lib):
                return ck.launch_phase_correlate_frames(lib, c, p, patch=PATCH)

            facts = {"built": True,
                     "ptxas": [ln for ln in ck.ptxas_lines(result["log"]) if ln.startswith(f"m={PATCH // 8}:")],
                     "blocks_per_sm": lib.pcf_blocks_per_sm(PATCH)}
            variants.append((t, launch, facts))
    else:
        def twin(c, p):
            return ck.phase_correlate_frames_ref(c, p, patch=PATCH)

        variants.append((None, twin, {"built": None, "ptxas": [], "blocks_per_sm": None}))

    checked = []
    for t, launch, facts in variants:
        agree = check_variant(launch, dev, pairs)
        if not agree["agrees"]:
            emit({**base, "threads": t, **facts, **agree, "error": "disagrees with the twin or the oracle"})
            ok = False
            continue
        checked.append((t, launch, {**facts, **agree}))

    size = args.size
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    big = max(batches)
    prev_all = torch.randint(0, 256, (big, size, size), generator=gen, device=dev, dtype=torch.uint8)
    curr_all = torch.randint(0, 256, (big, size, size), generator=gen, device=dev, dtype=torch.uint8)
    for b in batches:
        prev, curr = prev_all[:b], curr_all[:b]
        lib_ms = library_ms(curr, prev, dev)
        for t, launch, facts in checked:
            emit({**base, "threads": t, "batch": b, **facts, **time_batch(launch, curr, prev, dev, args.iters),
                  "library_ms": lib_ms})
    return ok


def main(argv=None) -> int:
    from mrs_optic_flow_tpu_torch.utils import benchlib

    args = parse_args(argv)

    def emit(row):
        print(json.dumps(row), flush=True)

    with benchlib.time_budget(args.budget_s):
        try:
            return 0 if run(args, emit) else 1
        except TimeoutError as e:
            emit({"metric": "phase_correlate_frames_threads", "timed_out": str(e)})
            return 3


if __name__ == "__main__":
    sys.exit(main())
