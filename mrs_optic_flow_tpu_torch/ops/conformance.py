"""Cross-backend conformance checker (port of
:mod:`mrs_optic_flow_tpu.ops.conformance`).

:func:`check` runs every backend on the same patch batch and reports the
pairwise largest shift disagreement: the bring-up diff for new hardware, the
live version of the reference's dual-path debug machinery
(``src/FftMethod.cpp:1482-1483``).  On CUDA tensors ``"fused-pallas"``
launches kernel E, every ``"+pallas"`` backend kernel B, ``"fft"`` runs
``torch.fft`` and ``"dft"`` the plain float32 matrix-product DFT; on CPU
tensors every kernel is its plain twin.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from mrs_optic_flow_tpu_torch.ops.cuda_kernels import phase_correlate_fused
from mrs_optic_flow_tpu_torch.ops.phase_correlate import phase_correlate_field


def backends() -> Tuple[str, ...]:
    return ("fft", "dft", "fft+pallas", "dft+pallas", "fused-pallas")


def _run(name: str, curr: torch.Tensor, prev: torch.Tensor):
    if name == "fused-pallas":
        return phase_correlate_fused(curr, prev)
    base, _, pal = name.partition("+")
    return phase_correlate_field(curr, prev, backend=base, use_pallas=bool(pal))


def check(curr, prev, *, tolerance_px: float = 0.05) -> Dict[str, float]:
    """Pairwise max |shift| disagreement across backends on one ``[P, N, N]``
    patch batch (tensors on the device to test, or arrays for the CPU).

    Returns ``{"a|b": max_abs_diff_px, ...}``; raises ``AssertionError`` if
    any pair exceeds ``tolerance_px`` (half the 0.1 px budget of
    BASELINE.md) or if a window is NaN in one backend and not in the other.
    """
    curr = torch.as_tensor(curr, dtype=torch.float32).contiguous()
    prev = torch.as_tensor(prev, dtype=torch.float32, device=curr.device).contiguous()
    outs = {name: _run(name, curr, prev)[0].cpu().numpy() for name in backends()}

    report: Dict[str, float] = {}
    names = list(outs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            diff = np.abs(outs[a] - outs[b])
            # NaN must fail, not mask: a NaN `worst` would compare False
            # against the tolerance.  Both NaN in one window is agreement.
            one_sided = np.isnan(outs[a]) != np.isnan(outs[b])
            if one_sided.any():
                raise AssertionError(
                    f"backend pair {a}|{b}: one-sided NaN shifts ({int(one_sided.sum())} windows)"
                )
            report[f"{a}|{b}"] = float(np.max(np.where(np.isnan(diff), 0.0, diff)))
    worst = max(report.values())
    if worst > tolerance_px:
        bad = {k: v for k, v in report.items() if v > tolerance_px}
        raise AssertionError(f"backend disagreement over {tolerance_px} px: {bad}")
    return report
