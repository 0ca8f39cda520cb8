#!/usr/bin/env python3
"""Sub-pixel flow error of every flow route of the PyTorch port against the
oracle, on one CUDA card or on the CPU.

    python3 scripts/accuracy_report_torch.py [--pairs 8] [--size 480] [--device cuda|cpu]

The pairs and the oracle's answers come from ``tests/oracle.py::
make_accuracy_pairs`` (band-limited textures moved by known sub-pixel
Fourier shifts, quantised to uint8 after the shift; the JAX package's
report and bench use the same function).  Each route's shifts (ungated,
``FlowResult.shifts_raw`` through an engine) are held to the truth (max and
mean |error|) and to the oracle (max |error|: the route's fidelity), in px:

- ``A``: ``FftMethod`` at ``size`` / 120 px windows, kernel A;
- ``D patch 60``: ``FftMethod`` at ``size`` / 60 px, kernel D;
- ``D patch 97``: ``FftMethod`` at ``194 * max(1, size // 240)`` / 97 px,
  kernel D on a prime size;
- ``E``: kernel E on the 120 px windows (the ``fused-pallas`` backend of
  ``ops/conformance.py``), with the conformance report of all five
  backends on the same windows;
- ``fft``: ``FftMethod(backend="fft")``, the ``torch.fft`` surfaces and
  kernel B;
- each kernel's twin: ``A twin``, ``D patch 60 twin``, ``D patch 97 twin``,
  ``E twin`` and ``fft twin`` (``use_pallas=False``).

One JSON line for the oracle of each window size against the truth (the
method's own error, which every faithful route shares), one a route, then a
``summary`` line with the worst fidelity of the kernels (A, D, E) against
``--kernel-tol`` (0.01 px) and of every route against the budget (0.1 px,
``BASELINE.md``); the exit code is 1 if either fails.  On the CPU every kernel route runs its twin (the wrappers take the
twins on CPU tensors).
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

BUDGET_PX = 0.1  # BASELINE.md
KERNEL_TOL_PX = 0.01  # the kernels against the oracle (chip_smoke.SHIFT_TOL)
SEED = 42


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--size", type=int, default=480, help="frame side, a multiple of 120")
    ap.add_argument("--kernel-tol", type=float, default=KERNEL_TOL_PX)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def geometries(size: int) -> dict:
    """Route family -> (frame side, window side); the 97 px windows' frame
    is an even multiple of 97 (the engine evens an odd frame side)."""
    return {"120": (size, 120), "60": (size, 60), "97": (2 * 97 * max(1, size // 240), 97)}


def accuracy_pairs(n_pairs: int, size: int, patch: int):
    """``make_accuracy_pairs`` at one geometry, seeded as the JAX report."""
    from oracle import make_accuracy_pairs

    return make_accuracy_pairs(np.random.default_rng(SEED), n_pairs, size=size, patch=patch)


def errors(shifts: np.ndarray, truth: np.ndarray, oracle: np.ndarray) -> dict:
    """Max and mean |shift - truth| and max |shift - oracle| over the
    windows, in px, NaN windows left out and counted."""
    err = np.abs(shifts - truth[:, None, :])
    dev = np.abs(shifts - oracle)
    return {"max_vs_truth_px": float(np.nanmax(err)), "mean_vs_truth_px": float(np.nanmean(err)),
            "max_vs_oracle_px": float(np.nanmax(dev)), "nan_windows": int(np.isnan(shifts).any(-1).sum())}


def route_shifts(n_pairs: int, size: int, dev) -> tuple:
    """Route -> (family, shifts [B, q*q, 2] as numpy); family -> (truth,
    oracle shifts); the conformance report of the five backends on the 120
    px windows."""
    import torch

    from mrs_optic_flow_tpu_torch.models import FftMethod, FftMethodConfig
    from mrs_optic_flow_tpu_torch.ops import conformance
    from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck
    from mrs_optic_flow_tpu_torch.ops.preprocess import patchify

    out, answers, report = {}, {}, None
    for fam, (s, p) in geometries(size).items():
        prev_np, curr_np, truth, oracle = accuracy_pairs(n_pairs, s, p)
        answers[fam] = (truth, oracle)
        prev, curr = torch.from_numpy(prev_np).to(dev), torch.from_numpy(curr_np).to(dev)
        b = prev.shape[0]

        def engine(**kw):
            eng = FftMethod(FftMethodConfig(frame_size=s, sample_point_size=p, **kw), device=dev)
            return eng.step_batch(prev, curr).shifts_raw

        cp, pp = patchify(curr, p).reshape(-1, p, p), patchify(prev, p).reshape(-1, p, p)

        def per_window(fn):
            return fn(cp.contiguous(), pp.contiguous())[0].reshape(b, -1, 2)

        if fam == "120":
            out["A"] = (fam, engine())
            out["A twin"] = (fam, ck.phase_correlate_frames_ref(curr, prev, patch=p)[0])
            out["E"] = (fam, per_window(ck.phase_correlate_fused))
            out["E twin"] = (fam, per_window(ck.phase_correlate_fused_ref))
            out["fft"] = (fam, engine(backend="fft"))
            out["fft twin"] = (fam, engine(backend="fft", use_pallas=False))
            report = conformance.check(cp, pp)
        else:
            out[f"D patch {p}"] = (fam, engine())
            out[f"D patch {p} twin"] = (fam, per_window(ck.phase_correlate_fullfused_ref))
    return {k: (fam, v.cpu().numpy()) for k, (fam, v) in out.items()}, answers, report


def run(args, emit) -> bool:
    from mrs_optic_flow_tpu_torch.utils import benchlib
    from mrs_optic_flow_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    base = {"metric": "flow_accuracy_px", "pairs": args.pairs,
            "card": benchlib.card_name() if dev.type == "cuda" else "cpu"}
    shifts, answers, report = route_shifts(args.pairs, args.size, dev)
    for fam, (truth, oracle) in answers.items():
        s, p = geometries(args.size)[fam]
        err = np.abs(oracle - truth[:, None, :])
        emit({**base, "route": f"oracle {p}", "size": s, "patch": p, "max_vs_truth_px": float(err.max()),
              "mean_vs_truth_px": float(err.mean()), "max_vs_oracle_px": 0.0, "nan_windows": 0})
    worst_kernel, worst_any = 0.0, 0.0
    for route, (fam, sh) in shifts.items():
        truth, oracle = answers[fam]
        s, p = geometries(args.size)[fam]
        row = {**base, "route": route, "size": s, "patch": p, **errors(sh, truth, oracle)}
        if not route.endswith("twin") and route != "fft":
            worst_kernel = max(worst_kernel, row["max_vs_oracle_px"])
        worst_any = max(worst_any, row["max_vs_oracle_px"])
        emit(row)
    ok = worst_kernel <= args.kernel_tol and worst_any <= BUDGET_PX
    emit({**base, "route": "summary", "kernels_max_vs_oracle_px": worst_kernel,
          "kernel_tol_px": args.kernel_tol, "max_vs_oracle_px": worst_any, "budget_px": BUDGET_PX,
          "conformance_max_px": max(report.values()), "conformance": report, "ok": ok})
    return ok


def main(argv=None) -> int:
    args = parse_args(argv)
    return 0 if run(args, lambda row: print(json.dumps(row), flush=True)) else 1


if __name__ == "__main__":
    sys.exit(main())
