"""Repair F6 on the CPU: the port's float32 contractions run at full
precision whatever the caller's TF32 setting, and each pinned site gives the
caller's setting back.

The JAX package pins ``Precision.HIGHEST`` at each such contraction; the port
wraps the same sites in ``utils/precision.py::full_float32``.  A spy on
``Tensor.__matmul__``, ``torch.matmul`` and ``torch.einsum`` records the
process's ``float32_matmul_precision`` at every product a site runs, with the
caller set to ``"medium"`` (TF32 on); afterwards the caller's setting must be
back.  On the card, ``chip_smoke.py``'s TF32 phase checks the outputs."""

import numpy as np
import pytest
import torch

from mrs_optic_flow_tpu_torch.geometry import homography, motion
from mrs_optic_flow_tpu_torch.ops import cuda_kernels, phase_correlate
from mrs_optic_flow_tpu_torch.utils import precision

RNG = np.random.default_rng(6)


def _t(*shape):
    return torch.from_numpy(RNG.normal(size=shape).astype(np.float32))


def _h():
    return torch.eye(3) + 0.05 * _t(3, 3)


def _get_rt():
    k = torch.tensor([[420.0, 0.0, 376.0], [0.0, 420.0, 240.0], [0.0, 0.0, 1.0]])
    shifts = torch.full((16, 2), 1.5) + 0.01 * _t(16, 2)
    gen = torch.Generator().manual_seed(0)
    return motion.get_rt(shifts, torch.tensor(2.0), torch.tensor(0.05), 136.0, k, torch.zeros(5),
                         torch.tensor([0.0, 0.0, 0.0, 1.0]), torch.tensor([0.0, 0.0, 0.0, 1.0]),
                         frame_size=480, patch=120, generator=gen, ransac_iterations=16)


#: each pinned site with small inputs
SITES = {
    "_dft2_real": lambda: phase_correlate._dft2_real(_t(2, 12, 12)),
    "_idft2_real_output": lambda: phase_correlate._idft2_real_output(_t(2, 12, 12), _t(2, 12, 12)),
    "_fused_spectra": lambda: cuda_kernels._fused_spectra(_t(12, 4, 12)),
    "_solve_h4": lambda: homography._solve_h4(_t(5, 4, 2), _t(5, 4, 2)),
    "_solve_h_qr_null": lambda: homography._solve_h_qr_null(_t(16, 9), _h()),
    "_sv_middle_3x3": lambda: homography._sv_middle_3x3(_h()),
    "decompose_homography": lambda: homography.decompose_homography(_h()),
    "get_rt": _get_rt,
}


def test_every_pinned_function_has_a_case():
    assert {fn.__name__ for fn in precision.PINNED} == set(SITES) - {"get_rt"}


@pytest.fixture
def spy(monkeypatch):
    """The float32 matmul precision at every product, while the caller runs
    with TF32 on (``"medium"``); the caller's setting back afterwards."""
    seen = []

    def wrap(fn):
        def inner(*args, **kwargs):
            seen.append(torch.get_float32_matmul_precision())
            return fn(*args, **kwargs)
        return inner

    monkeypatch.setattr(torch.Tensor, "__matmul__", wrap(torch.Tensor.__matmul__))
    monkeypatch.setattr(torch, "matmul", wrap(torch.matmul))
    monkeypatch.setattr(torch, "einsum", wrap(torch.einsum))
    torch.set_float32_matmul_precision("medium")
    yield seen
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("site", sorted(SITES))
def test_site_runs_at_highest_and_restores_the_caller(site, spy):
    assert torch.backends.cuda.matmul.allow_tf32
    SITES[site]()
    assert spy and set(spy) == {"highest"}
    assert torch.get_float32_matmul_precision() == "medium"
    assert torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("caller", ["highest", "high", "medium"])
def test_full_float32_restores_every_setting(caller):
    torch.set_float32_matmul_precision(caller)
    try:
        tf32 = torch.backends.cuda.matmul.allow_tf32
        with precision.full_float32():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == caller
        assert torch.backends.cuda.matmul.allow_tf32 == tf32
        with pytest.raises(RuntimeError):  # restored on the way out of an error too
            with precision.full_float32():
                raise RuntimeError("inside")
        assert torch.get_float32_matmul_precision() == caller
    finally:
        torch.set_float32_matmul_precision("highest")


def test_results_do_not_depend_on_the_callers_setting():
    x = _t(3, 16, 16)
    want = phase_correlate.correlation_surface_raw(x, x.flip(-1), backend="dft")
    torch.set_float32_matmul_precision("medium")
    try:
        got = phase_correlate.correlation_surface_raw(x, x.flip(-1), backend="dft")
    finally:
        torch.set_float32_matmul_precision("highest")
    assert torch.equal(got, want)
