#!/usr/bin/env python3
"""Sweep kernel G's launch shapes and design variants on one CUDA card.

    python3 scripts/tune_get_rt_kernel_torch.py [--shapes 8x2,4x4,16x1,...] [--fills 8,32]
        [--rewrites masked,short,single_buffer,no_draw_read]
        [--cases 4096x256x16,512x256x16,128x256x16,1x512x16,...] [--reps 20] [--device cuda|cpu]

Kernel G (``csrc/get_rt.cu``) gives a pair a block of up to 256 threads up
to one pair an SM, beyond it the power of two of warps that fills
``kFillWarps`` warps an SM, and where that is one warp, the warp layout:
``GRT_PAIRS`` pairs a block, a warp each, with registers for
``GRT_PAIR_BLOCKS`` blocks an SM.  Each ``PAIRSxBLOCKS`` of ``--shapes``
builds the source with ``-DGRT_PAIRS=PAIRS -DGRT_PAIR_BLOCKS=BLOCKS
-DGRT_WARP_LAYOUT=1`` (every batched case through the warp layout, the
fleet's 128 pairs too); each of ``--fills`` builds a copy of the source
with ``kFillWarps`` set to it; each of ``--rewrites`` a copy with that
entry of ``REWRITES`` applied: another scoring form or draw staging, the
same arithmetic.  All compile at once, each into its own library under
``build/torch_kernels/``.  Every build runs every case of ``--cases``,
``BxIxP`` (pairs, hypotheses, windows; ``B = 1`` is the node's per-pair
path on given hypothesis rows, else the batched path on Gumbel draws), on
``chip_smoke.g_windows``' inputs.  Each build's outputs must equal the
shipped build's bit for bit (a launch shape or a form changes the order of
no arithmetic), but ``no_draw_read``'s: it fills the draws from their
indices instead of reading them from the ``[I, P, B]`` tensor, so only its
time counts (what reading the draws costs).  Each case's line gives
``own_ms`` (``torch.profiler`` kernel time), ``ms`` (CUDA events over
back-to-back calls) and the launch (threads a block, shared memory, warp
layout), with the build's ``ptxas`` lines (registers and spills).  The
shipped build is timed first and again last: the two lines' difference is
the noise of the comparison.

Each line carries the card's ``nvidia-smi`` name and power limit.  With
``--device cpu`` it prints each build's launch a case from
``cuda_kernels.grt_launch``, the mirror of the source, builds nothing and
times nothing.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

DEFAULT_SHAPES = "8x2,8x3,8x4,4x4,16x1,16x2"
DEFAULT_FILLS = "8,32"
#: SMs of an H100, for the CPU listing
H100_SMS = 132
DEFAULT_CASES = "4096x256x16,4096x512x64,1024x256x16,512x256x16,128x256x16,1x512x16"

#: name -> {text of csrc/get_rt.cu: its replacement}: the design variants
#: of ``--rewrites``, each text once in the source
REWRITES = {
    # the block layout's batched path scores every window, then masks, as
    # the warp layout and the per-pair path do
    "masked": {
        "      score_one<kP, false>(a, i, my_g, 1, sh, n_valid, my_cnt, my_i, my_h);":
            "      score_one<kP, true>(a, i, my_g, 1, sh, n_valid, my_cnt, my_i, my_h);",
    },
    # the warp layout and the per-pair path test the valid windows only, as
    # the block layout's batched path does
    "short": {
        "      score_one<kP, true>(a, i, my_g, 1, sh, n_valid, my_cnt, my_i, my_h);":
            "      score_one<kP, false>(a, i, my_g, 1, sh, n_valid, my_cnt, my_i, my_h);",
        "      score_one<kP, true>(a, i, tiles + (c & 1) * tile_floats":
            "      score_one<kP, false>(a, i, tiles + (c & 1) * tile_floats",
    },
    # the block layout's batched path copies each hypothesis's draws into its
    # row when it scores it (one row, no copy in flight)
    "single_buffer": {
        "      stage_draws(a, pair, i + nt, draw_row(sh, P, t, nt, k ^ 1));\n"
        "      __pipeline_wait_prior(1);  // all but the group just committed: this row's\n":
            "      __pipeline_wait_prior(0);\n"
            "      const float* g = a.gumbel + a.g_si * i + pair;\n"
            "      for (int p = 0; p < P; ++p) draw_row(sh, P, t, nt, k)[p] = __ldg(g + a.g_sp * p);\n",
    },
    # both batched paths fill the draws from their indices (not getRT's
    # results: a time only)
    "no_draw_read": {
        "for (int p = 0; p < a.p; ++p) __pipeline_memcpy_async(row + p, g + a.g_sp * p, sizeof(float));":
            "for (int p = 0; p < a.p; ++p) row[p] = static_cast<float>((i * 131 + p * 31 + pair) % 97);",
        "__pipeline_memcpy_async(tile + il * (P * W + 1) + p * W + w, g, sizeof(float));":
            "tile[il * (P * W + 1) + p * W + w] = static_cast<float>((i * 131 + p * 31 + pair0 + w) % 97);",
    },
}
#: the rewrite of ``--fills``: kFillWarps
FILL = "constexpr int kMaxThreads = 256, kFillWarps = 16;"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default=DEFAULT_SHAPES, help="comma-separated PAIRSxBLOCKS of the warp layout")
    ap.add_argument("--fills", default=DEFAULT_FILLS, help="comma-separated kFillWarps values")
    ap.add_argument("--rewrites", default=",".join(REWRITES), help="comma-separated names of REWRITES")
    ap.add_argument("--cases", default=DEFAULT_CASES, help="comma-separated BxIxP")
    ap.add_argument("--reps", type=int, default=20)
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


def builds_of(args) -> list:
    """Every build of the sweep: ``("shape", (pairs, blocks))``,
    ``("fill", fill)`` or ``("rewrite", name)``."""
    out = [("shape", parse(s)) for s in args.shapes.split(",") if s]
    out += [("fill", int(f)) for f in args.fills.split(",") if f]
    for name in (n for n in args.rewrites.split(",") if n):
        if name not in REWRITES:
            raise SystemExit(f"no rewrite {name!r}; known: {', '.join(REWRITES)}")
        out.append(("rewrite", name))
    return out


def defines(build: tuple) -> dict:
    """A shape's macros: its pairs and blocks, and every batched case in
    the warp layout."""
    return {"GRT_PAIRS": build[0], "GRT_PAIR_BLOCKS": build[1], "GRT_WARP_LAYOUT": 1}


def label(build: tuple):
    kind, value = build
    return defines(value) if kind == "shape" else {kind: value}


def rewritten(src: str, build: tuple) -> str:
    """The source of a fill or rewrite build; raises where a text it
    replaces is not in ``src`` once (the source changed: update
    ``REWRITES`` or ``FILL``)."""
    kind, value = build
    subs = {FILL: FILL.replace("kFillWarps = 16", f"kFillWarps = {value}")} if kind == "fill" else REWRITES[value]
    for old, new in subs.items():
        if src.count(old) != 1:
            raise ValueError(f"{kind} {value}: the text it replaces is not in get_rt.cu once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def launch(ck, build, case: tuple, sms: int, smem_limit: int) -> dict:
    """The mirror's launch of ``case`` in ``build`` (None or a rewrite: the
    shipped one)."""
    b, iters, p = case
    kw = {}
    if build is not None and build[0] == "shape":
        kw = dict(pairs=build[1][0], warp_layout=True)
    elif build is not None and build[0] == "fill":
        kw = dict(fill=build[1])
    threads, smem, warp = ck.grt_launch(b, p, iters, b > 1, sms, smem_limit, **kw)
    return {"threads": threads, "smem": smem, "warp_layout": warp}


def start(ck, build: tuple):
    """Start ``build``'s compile: ``(job, library path)``."""
    if build[0] == "shape":
        return ck.start_build(["get_rt"], defines=defines(build[1])), ck.variant_path("get_rt", defines(build[1]))
    name = f"get_rt_{build[0]}_{build[1]}"
    cu, so = ck.BUILD_DIR / f"{name}.cu", ck.BUILD_DIR / f"lib{name}.so"
    ck.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu.write_text(rewritten((ck.CSRC / ck.SOURCES["get_rt"]).read_text(), build))
    cmd = [ck._nvcc(), *ck.NVCC_FLAGS, *ck.SOURCE_FLAGS["get_rt"], "-o", str(so), str(cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def finish(ck, job) -> dict:
    """``{"log": ...}`` of a finished compile, or ``{"error": ...}``."""
    if isinstance(job, dict):
        return ck.finish_variants({0: job})[0]
    log = job.communicate()[0]
    return {"log": log} if job.returncode == 0 else {"error": f"nvcc failed ({job.returncode}):\n{log[-2000:]}"}


def run(args, emit) -> bool:
    import torch

    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck
    from mrs_optic_flow_tpu_torch.utils import benchlib
    from mrs_optic_flow_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    builds = builds_of(args)
    cases = [parse(c) for c in args.cases.split(",")]
    if dev.type != "cuda":
        limit = ck.H100_SMEM_OPTIN_BYTES - ck.STATIC_SMEM_BYTES
        src = (ck.CSRC / ck.SOURCES["get_rt"]).read_text()
        for build in builds:
            if build[0] != "shape":
                rewritten(src, build)
            emit({"build": label(build), "shipped": False, "built": False, "reason": "CPU run: nothing built",
                  "card": "cpu", "cases": {"x".join(map(str, c)): launch(ck, build, c, H100_SMS, limit)
                                           for c in cases}})
        return True

    card = benchlib.card_name()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin - ck.STATIC_SMEM_BYTES
    jobs = {b: start(ck, b) for b in builds}
    ck.build(["get_rt"])
    inputs = {c: case_inputs(dev, *c) for c in cases}
    shipped = {c: ck.launch_get_rt(*a, debug=True, **kw) for c, (a, kw) in inputs.items()}

    def timed(lib, build):
        out = {}
        for c, (a, kw) in inputs.items():
            def call(a=a, kw=kw):
                return ck.launch_get_rt(*a, lib=lib, **kw)

            row = launch(ck, build, c, sms, limit)
            try:
                row.update(own_ms=benchlib.own_ms(call, args.reps), ms=benchlib.time_cuda(call, 3 * args.reps))
            except RuntimeError as e:  # a launch the build refuses: reported, the sweep goes on
                row["error"] = str(e)
            out["x".join(map(str, c))] = row
        return out

    emit({"build": "shipped", "card": card, "cases": timed(None, None)})
    ok = True
    for build in builds:
        job, so = jobs[build]
        done = finish(ck, job)
        row = {"build": label(build), "card": card}
        if "error" in done:
            emit({**row, "built": False, "reason": done["error"][-800:]})
            ok = False
            continue
        lib = ck._bind("get_rt", so)
        row.update(built=True, ptxas=ck.ptxas_lines(done["log"]), cases=timed(lib, build))
        for c, (a, kw) in inputs.items():
            case = row["cases"]["x".join(map(str, c))]
            if "error" in case:
                ok = False
                continue
            if build == ("rewrite", "no_draw_read"):
                continue
            out = ck.launch_get_rt(*a, debug=True, lib=lib, **kw)
            same = all(torch.equal(torch.nan_to_num(o, nan=7.0), torch.nan_to_num(r, nan=7.0))
                       for o, r in zip(out, shipped[c]) if o is not None)
            ok &= same
            case["bit_equal"] = same
        emit(row)
    emit({"build": "shipped again", "card": card, "cases": timed(None, None)})
    return ok


def main(argv=None) -> int:
    args = parse_args(argv)
    return 0 if run(args, lambda row: print(json.dumps(row), flush=True)) else 1


if __name__ == "__main__":
    sys.exit(main())
