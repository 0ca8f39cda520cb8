#!/usr/bin/env python3
"""Where one pair's time goes inside kernel G, phase by phase, on one CUDA card.

    python3 scripts/probe_get_rt_spans_torch.py [--cases 1x512x16,128x256x16,512x256x16,4096x256x16]
        [--pair 4000]

Copies ``csrc/get_rt.cu`` into ``build/torch_kernels/`` with its
``GRT_SPAN(k)`` phase marks defined as a ``clock64()`` write (lane 0 of the
pair's warp, into a ``__device__`` array), builds the copy and reads the marks back
after a launch of each case ``BxIxP`` (``scripts/tune_get_rt_kernel_torch.py
::case_inputs``; the node's B = 1 with its body-frame epilogue).  Prints one
JSON line a case: the SM clock cycles of the pair's points, hypotheses (their
draws included), argmax and inlier set, QR refit, inverse iteration,
decomposition, solution selection, twist, outputs and epilogue, beside the
card's ``nvidia-smi`` name and power limit.  The pair is ``--pair`` where the
batch has it, else the last; pair 0 of ``chip_smoke.g_windows`` has no valid
window and takes slow paths, so it is not the default.  The instrumented copy
is for this probe alone; the marks change no arithmetic.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

PHASES = ("points", "hypotheses", "argmax+inliers", "QR", "inverse iteration", "decompose",
          "selection", "twist", "outputs", "epilogue")
#: the source's ``GRT_SPAN(k)`` marks, k = 0 .. len(PHASES), as a write of the
#: SM clock by lane 0 of the probed pair's warp
SPAN = ("#define GRT_SPAN(k) do { if (pair == GRT_PROBE_PAIR && threadIdx.x % 32 == 0) "
        "grt_clock[k] = clock64(); } while (0)\n__device__ long long grt_clock[16];\n")


def instrumented(src: str) -> str:
    """``src`` with ``GRT_SPAN`` defined as a clock mark and a function that
    reads the marks back; raises where a phase has no mark (the source
    changed: put its ``GRT_SPAN`` back)."""
    for k in range(len(PHASES) + 1):
        if f"GRT_SPAN({k});" not in src:
            raise ValueError(f"get_rt.cu marks no GRT_SPAN({k})")
    return SPAN + src + ('\nextern "C" int grt_read_clock(long long* host) {\n'
                         "  return (int)cudaMemcpyFromSymbol(host, grt_clock, sizeof(long long) * 16);\n}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="1x512x16,128x256x16,512x256x16,4096x256x16")
    ap.add_argument("--pair", type=int, default=4000)
    args = ap.parse_args(argv)

    import torch

    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck
    from mrs_optic_flow_tpu_torch.utils.benchlib import card_name
    from scripts.tune_get_rt_kernel_torch import case_inputs, parse

    if not torch.cuda.is_available():
        raise SystemExit("probe_get_rt_spans_torch.py needs a CUDA device")
    dev = torch.device("cuda")
    cases = [parse(c) for c in args.cases.split(",")]
    pairs = sorted({min(args.pair, b - 1) for b, _, _ in cases})
    src = instrumented((ck.CSRC / ck.SOURCES["get_rt"]).read_text())
    ck.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for pair in pairs:  # one build a probed pair, all at once
        cu = ck.BUILD_DIR / f"get_rt_spans_{pair}.cu"
        cu.write_text(src)
        so = ck.BUILD_DIR / f"libget_rt_spans_{pair}.so"
        cmd = [ck._nvcc(), *ck.NVCC_FLAGS, *ck.SOURCE_FLAGS["get_rt"], f"-DGRT_PROBE_PAIR={pair}", "-o", str(so),
               str(cu)]
        jobs[pair] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for pair, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log[-3000:]}")
        lib = ck._bind("get_rt", so)
        lib.grt_read_clock.argtypes = [ctypes.c_void_p]
        libs[pair] = lib
    card = card_name()
    for case in cases:
        pair = min(args.pair, case[0] - 1)
        a, kw = case_inputs(dev, *case)
        if case[0] == 1:  # the node's launch: with its body-frame epilogue
            kw["detilt"] = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
        for _ in range(3):
            ck.launch_get_rt(*a, lib=libs[pair], **kw)
        torch.cuda.synchronize()
        t = (ctypes.c_longlong * 16)()
        libs[pair].grt_read_clock(ctypes.addressof(t))
        spans = {PHASES[k]: t[k + 1] - t[k] for k in range(len(PHASES)) if t[k] and t[k + 1]}
        print(json.dumps({"case": "x".join(map(str, case)), "pair": pair, "cycles": spans,
                          "total": t[len(PHASES)] - t[0], "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
