#!/usr/bin/env python3
"""Sweep kernel G's throughput block shape on one CUDA card.

    python3 scripts/tune_get_rt_kernel_torch.py [--shapes 64x8,128x4,256x1,...]
        [--cases 4096x256x16,512x256x16,1x512x16,...] [--reps 20] [--device cuda|cpu]

Kernel G (``csrc/get_rt.cu``) launches one block a pair in one of two
shapes: up to one pair an SM its latency shape (256 threads), beyond it
its throughput shape, ``GRT_WIDE_THREADS`` threads a block with registers
for ``GRT_WIDE_BLOCKS`` blocks an SM.  Each ``THREADSxBLOCKS`` of
``--shapes`` builds the source with ``-DGRT_WIDE_THREADS=THREADS
-DGRT_WIDE_BLOCKS=BLOCKS`` into its own library under
``build/torch_kernels/`` (all compiles at once) and runs every case of
``--cases``, ``BxIxP`` (pairs, hypotheses, windows; ``B = 1`` is the
node's per-pair path on given hypothesis rows, else the batched path on
Gumbel draws), on ``chip_smoke.g_windows``' inputs.  Each shape's outputs
must equal the shipped build's bit for bit (a shape changes the order of
no arithmetic); each case's line gives ``own_ms`` (``torch.profiler``
kernel time) and ``ms`` (CUDA events over back-to-back calls), with the
shape's ``ptxas`` lines (registers and spills).

``--draws`` adds one line: the shipped build against a copy of the source
whose batched path fills each hypothesis's row of draws from its indices
instead of reading them from the ``[I, P, B]`` tensor (its results are not
getRT's; only its time counts), at each batched case: what reading the
draws in that layout, one 4-byte read a 32-byte sector, costs.

Each line carries the card's ``nvidia-smi`` name and power limit.  With
``--device cpu`` it prints each shape's threads and shared memory a case
from ``cuda_kernels``' mirror of the source, builds nothing and times
nothing.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

DEFAULT_SHAPES = "64x8,256x1,128x4,64x16,32x16,32x32"
#: SMs of an H100: more pairs than this take the throughput shape
H100_SMS = 132
DEFAULT_CASES = "4096x256x16,4096x512x64,1024x256x16,512x256x16,128x256x16,1x512x16"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default=DEFAULT_SHAPES, help="comma-separated THREADSxBLOCKS")
    ap.add_argument("--cases", default=DEFAULT_CASES, help="comma-separated BxIxP")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--draws", action="store_true", help="time the batched path without reading the draws")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def parse(spec: str) -> tuple:
    return tuple(int(v) for v in spec.split("x"))


def case_inputs(dev, b: int, iters: int, p: int):
    """``(args, kw)`` of ``cuda_kernels.launch_get_rt`` for one case."""
    import torch

    import chip_smoke as cs
    from mrs_optic_flow_tpu_torch.geometry.batched import draw_gumbel
    from mrs_optic_flow_tpu_torch.geometry.homography import draw_hypotheses

    gen = torch.Generator(device=dev)
    gen.manual_seed(b * 1000 + p)
    cam, dist = cs.g_camera(dev)
    c2b = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    w = cs.g_windows(max(b, 3), p, seed=11)
    x = {k: torch.from_numpy(v).to(dev) for k, v in w.items() if k != "patch"}
    if b == 1:  # pair 2 (pair 0 has no valid window, pair 1 no finite 1/dt)
        one = [x[k][2:3] for k in ("shifts", "heights", "dts", "rates")]
        hyp = draw_hypotheses(torch.isfinite(one[0][0]).all(-1), iters, gen)
        return ((one[0], one[1], one[2], 136.0, cam, dist, c2b, one[3]),
                dict(frame_size=480, patch=w["patch"], hyp_idx=hyp))
    g = draw_gumbel(iters, p, b, dev, gen)
    return ((x["shifts"], x["heights"], x["dts"], 136.0, cam, None, c2b, x["rates"]),
            dict(frame_size=480, patch=w["patch"], gumbel=g))


def run(args, emit) -> bool:
    import torch

    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck
    from mrs_optic_flow_tpu_torch.utils import benchlib
    from mrs_optic_flow_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    shapes = [parse(s) for s in args.shapes.split(",")]
    cases = [parse(c) for c in args.cases.split(",")]
    if dev.type != "cuda":
        limit = ck.H100_SMEM_OPTIN_BYTES - ck.STATIC_SMEM_BYTES
        for threads, blocks in shapes:
            rows = {}
            for b, iters, p in cases:
                most = threads if b > H100_SMS else ck.GRT_MAX_THREADS
                t = ck.grt_block_threads(p, iters, b > 1, limit, most)
                rows[f"{b}x{iters}x{p}"] = {"threads": t, "smem": ck.grt_smem_bytes(p, t, b > 1)}
            emit({"shape": [threads, blocks], "shipped": (threads, blocks) == ck.GRT_WIDE_SHAPE,
                  "built": False, "reason": "CPU run: nothing built", "card": "cpu", "cases": rows})
        return True

    card = benchlib.card_name()
    jobs = {s: ck.start_build(["get_rt"], defines={"GRT_WIDE_THREADS": s[0], "GRT_WIDE_BLOCKS": s[1]})
            for s in shapes}
    ck.build(["get_rt"])
    built = ck.finish_variants(jobs)
    inputs = {c: case_inputs(dev, *c) for c in cases}
    shipped = {c: ck.launch_get_rt(*a, debug=True, **kw) for c, (a, kw) in inputs.items()}
    ok = True
    for s in shapes:
        row = {"shape": list(s), "shipped": s == ck.GRT_WIDE_SHAPE, "card": card}
        if "error" in built[s]:
            emit({**row, "built": False, "reason": built[s]["error"][-800:]})
            ok = False
            continue
        lib = ck.load_variant("get_rt", {"GRT_WIDE_THREADS": s[0], "GRT_WIDE_BLOCKS": s[1]})
        row.update(built=True, ptxas=ck.ptxas_lines(built[s]["log"]), cases={})
        for c, (a, kw) in inputs.items():
            out = ck.launch_get_rt(*a, debug=True, lib=lib, **kw)
            same = all(torch.equal(torch.nan_to_num(o, nan=7.0), torch.nan_to_num(r, nan=7.0))
                       for o, r in zip(out, shipped[c]))
            ok &= same

            def call(a=a, kw=kw):
                return ck.launch_get_rt(*a, lib=lib, **kw)

            row["cases"]["x".join(map(str, c))] = {
                "own_ms": benchlib.own_ms(call, args.reps), "ms": benchlib.time_cuda(call, 3 * args.reps),
                "bit_equal": same}
        emit(row)
    if args.draws:
        emit({"draws": draw_cost(ck, benchlib, inputs, args.reps), "card": card})
    return ok


#: the batched path's read of a hypothesis's draws, and the index fill that
#: replaces it in the ``--draws`` copy
DRAW_READ = "for (int p = 0; p < P; ++p) my_g[p] = __ldg(g + a.g_sp * p);"
DRAW_FILL = "for (int p = 0; p < P; ++p) my_g[p] = static_cast<float>((i * 131 + p * 31 + pair) % 97);"


def draw_cost(ck, benchlib, inputs: dict, reps: int) -> dict:
    """Own ms of the shipped build and of a copy that fills the draws from
    their indices, at each batched case."""
    import subprocess

    src = (ck.CSRC / ck.SOURCES["get_rt"]).read_text()
    if src.count(DRAW_READ) != 1:
        raise RuntimeError("the batched path's read of the draws is not where this script looks")
    copy = ck.BUILD_DIR / "get_rt_no_draw_read.cu"
    copy.write_text(src.replace(DRAW_READ, DRAW_FILL))
    out = ck.BUILD_DIR / "libget_rt_no_draw_read.so"
    cmd = [ck._nvcc(), *ck.NVCC_FLAGS, *ck.SOURCE_FLAGS["get_rt"], "-o", str(out), str(copy)]
    subprocess.run(cmd, check=True, capture_output=True)
    fill = ck._bind("get_rt", out)
    rows = {}
    for c, (a, kw) in inputs.items():
        if "gumbel" not in kw:
            continue
        shipped = benchlib.own_ms(lambda a=a, kw=kw: ck.launch_get_rt(*a, **kw), reps)
        filled = benchlib.own_ms(lambda a=a, kw=kw: ck.launch_get_rt(*a, lib=fill, **kw), reps)
        rows["x".join(map(str, c))] = {"own_ms": shipped, "no_draw_read_own_ms": filled,
                                       "draw_read_ms": shipped - filled}
    return rows


def main(argv=None) -> int:
    args = parse_args(argv)
    return 0 if run(args, lambda row: print(json.dumps(row), flush=True)) else 1


if __name__ == "__main__":
    sys.exit(main())
