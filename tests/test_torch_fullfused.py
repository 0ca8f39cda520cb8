"""Kernels D and E and the conformance diff of the port against the JAX
package on the CPU.

The plain twins of kernel D (``phase_correlate_fullfused_ref``) and kernel E
(``phase_correlate_fused_ref``) against ``phase_correlate_fullfused_pallas``
and ``phase_correlate_fused_pallas`` in interpret mode, on the same uint8
patch pairs made from a seed, at every size kernel D has to take (odd
included, up to the 480 px frame): shifts within 1e-3 px and maxval within
1e-4 relative, as ``tests/test_torch_peak_refine.py``.  Then NaN input, a
shift beyond the search radius, the wrappers' CPU dispatch, the port's
``conformance.check``, kernel C's tiling rule, and the ctypes bindings of
every kernel against the C functions its source declares.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import fourier_shift, phase_correlate_oracle, smooth_random_image
from torch_parity import to_numpy

from mrs_optic_flow_tpu.ops import conformance as jax_conformance
from mrs_optic_flow_tpu.ops import phase_correlate as jax_pc
from mrs_optic_flow_tpu.ops.pallas_kernels import (
    phase_correlate_fullfused_pallas,
    phase_correlate_fused_pallas,
)
from mrs_optic_flow_tpu_torch.ops import conformance, cuda_kernels
from mrs_optic_flow_tpu_torch.ops.cuda_kernels import (
    phase_correlate_fullfused,
    phase_correlate_fullfused_ref,
    phase_correlate_fused,
    phase_correlate_fused_ref,
)

SHIFT_TOL = 1e-3  # px
MAXVAL_RTOL = 1e-4
SIZES = [15, 45, 60, 90, 100, 160, 480]
KERNELS = {
    "D": (phase_correlate_fullfused_ref, phase_correlate_fullfused_pallas),
    "E": (phase_correlate_fused_ref, phase_correlate_fused_pallas),
}


def _patches(n: int, p: int, seed: int):
    """``[p, n, n]`` uint8 pairs: band-limited textures and their copies
    moved by sub-pixel shifts up to n / 6 px."""
    rng = np.random.default_rng(seed)
    curr, prev = [], []
    for _ in range(p):
        base = smooth_random_image(rng, n, cutoff=0.3).astype(np.float64)
        d = rng.uniform(-n / 6, n / 6, 2)
        prev.append(np.clip(np.rint(base), 0, 255).astype(np.uint8))
        curr.append(np.clip(np.rint(fourier_shift(base, d[0], d[1])), 0, 255).astype(np.uint8))
    return np.stack(curr), np.stack(prev)


def _masked_pair(n: int):
    """A strong (70, 0) px shift, beyond the search radius 55, and a weaker
    (10, 3) px copy (as ``chip_smoke.py``'s phase 10)."""
    base = smooth_random_image(np.random.default_rng(7), n, cutoff=0.3).astype(np.float64)
    curr = 0.7 * fourier_shift(base, 70.0, 0.0) + 0.3 * fourier_shift(base, 10.0, 3.0)
    return curr[None].astype(np.float32), base[None].astype(np.float32)


def _run_both(kernel, curr, prev, **kw):
    twin, pallas = KERNELS[kernel]
    js, jm = to_numpy(pallas(jnp.asarray(curr, jnp.float32), jnp.asarray(prev, jnp.float32), **kw))
    ts, tm = to_numpy(twin(torch.from_numpy(curr), torch.from_numpy(prev), **kw))
    return (ts, tm), (js, jm)


def _assert_agree(ours, theirs):
    (ts, tm), (js, jm) = ours, theirs
    np.testing.assert_array_equal(np.isnan(ts), np.isnan(js))
    np.testing.assert_allclose(ts, js, atol=SHIFT_TOL, rtol=0, equal_nan=True)
    np.testing.assert_allclose(tm, jm, rtol=MAXVAL_RTOL, atol=1e-7, equal_nan=True)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_twin_matches_pallas(kernel, n):
    curr, prev = _patches(n, 1 if n == 480 else 4, seed=n)
    ours, theirs = _run_both(kernel, curr, prev)
    _assert_agree(ours, theirs)
    # and the NumPy oracle, patch by patch
    for i in range(curr.shape[0]):
        np.testing.assert_allclose(ours[0][i], phase_correlate_oracle(curr[i], prev[i])[0],
                                   atol=SHIFT_TOL)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_nan_and_zero_patches(kernel):
    curr, prev = _patches(45, 3, seed=1)
    curr = curr.astype(np.float32)
    curr[1, 10, 20] = np.nan
    curr[2] = 0.0  # a zero patch: a surface of ties, the minimum shifted index wins
    ours, theirs = _run_both(kernel, curr, prev.astype(np.float32))
    _assert_agree(ours, theirs)
    ts, tm = ours
    assert np.isfinite(ts[0]).all() and np.isnan(ts[1]).all() and np.isnan(tm[1])
    np.testing.assert_array_equal(ts[2], [-22.0, -22.0])
    assert tm[2] == 0.0


@pytest.mark.parametrize("radius,expect", [(55, (10.0, 3.0)), (240, (70.0, 0.0))])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_shift_beyond_the_search_radius(kernel, radius, expect):
    curr, prev = _masked_pair(480)
    ours, theirs = _run_both(kernel, curr, prev, search_radius=radius)
    _assert_agree(ours, theirs)
    np.testing.assert_allclose(ours[0][0], expect, atol=0.05)


def test_wrappers_run_their_twins_on_cpu_tensors():
    curr, prev = (torch.from_numpy(x) for x in _patches(60, 3, seed=2))
    ref = phase_correlate_fullfused_ref(curr, prev)
    for ours in (phase_correlate_fullfused(curr, prev), phase_correlate_fused(curr, prev)):
        assert all(torch.equal(a, b) for a, b in zip(ours, ref))
    assert phase_correlate_fullfused.LAUNCHES == phase_correlate_fused.LAUNCHES == 0
    # uint8 and float32 patches of the same values: the same result
    f = phase_correlate_fullfused(curr.float(), prev.float())
    assert all(torch.equal(a, b) for a, b in zip(f, ref))


def test_chunks_bound_the_scratch():
    pair_480 = 3 * 480 * 241 * 8  # pcff_scratch_bytes(480)
    assert cuda_kernels._chunk(4096, pair_480) == cuda_kernels.CHUNK_SCRATCH_BYTES // pair_480 == 12
    assert cuda_kernels._chunk(5, pair_480) == 5
    assert cuda_kernels._chunk(10**6, 3 * 8 * 5 * 8) == cuda_kernels.MAX_CHUNK
    assert cuda_kernels._chunk(1, 10**12) == 1


def test_conformance_check_matches_jax():
    curr, prev = _patches(120, 16, seed=3)
    ours = conformance.check(curr, prev)
    theirs = jax_conformance.check(curr, prev)
    assert conformance.backends() == jax_conformance.backends()
    assert list(ours) == list(theirs) and len(ours) == 10
    assert max(ours.values()) <= 0.05
    # each pair's disagreement as JAX reports it, and each backend's shifts
    for pair in ours:
        assert abs(ours[pair] - theirs[pair]) <= SHIFT_TOL, (pair, ours[pair], theirs[pair])
    c32, p32 = curr.astype(np.float32), prev.astype(np.float32)
    for name in conformance.backends():
        ts = to_numpy(conformance._run(name, torch.from_numpy(c32), torch.from_numpy(p32))[0])
        js = to_numpy(jax_conformance._run(name, jnp.asarray(c32), jnp.asarray(p32))[0])
        np.testing.assert_allclose(ts, js, atol=SHIFT_TOL, rtol=0, err_msg=name)


def test_conformance_check_fails_on_disagreement(monkeypatch):
    curr, prev = _patches(32, 2, seed=4)
    run = conformance._run

    def nan_in_fft(name, c, p):
        shift, maxval = run(name, c, p)
        if name == "fft":
            shift = shift.clone()
            shift[0] = float("nan")
        return shift, maxval

    monkeypatch.setattr(conformance, "_run", nan_in_fft)
    with pytest.raises(AssertionError, match="one-sided NaN"):
        conformance.check(curr, prev)

    def off_in_dft(name, c, p):
        shift, maxval = run(name, c, p)
        return (shift + 0.1 if name == "dft" else shift), maxval

    monkeypatch.setattr(conformance, "_run", off_in_dft)
    with pytest.raises(AssertionError, match="disagreement"):
        conformance.check(curr, prev)


@pytest.mark.parametrize("n", [45, 240, 480])
def test_twiddle_tables_up_to_the_frame(n):
    """Every DFT matrix entry kernels D and E read as ``tab[j*k mod n]`` is
    within 6e-13 of the float64-built matrix, odd n and n = 480 included."""
    tab = cuda_kernels._twiddles(n, torch.device("cpu")).numpy()
    c, s = jax_pc._dft_matrices(n)
    idx = np.outer(np.arange(n), np.arange(n)) % n
    assert np.abs(tab[idx, 0] - c).max() < 6e-13 and np.abs(tab[idx, 1] - s).max() < 6e-13


@pytest.mark.parametrize("s,r,parts", [(64, 21, 2), (120, 21, 4), (159, 21, 5), (160, 21, 5),
                                       (240, 21, 8), (240, 40, 8)])
def test_sad_tiling_rule(s, r, parts):
    """Repair F3: kernel C takes any block.  At nine cells each shift's sum
    has one part a 32-row group of block rows (one column band), and every
    block fits two to an SM (H100: 232,448 B a block, 233,472 B an SM)."""
    geo = cuda_kernels.sad_geometry(9, s, r)
    assert geo.parts == parts == -(-s // cuda_kernels.SAD_ROWS) and geo.xb == s
    assert 2 * (geo.smem + cuda_kernels.STATIC_SMEM_BYTES) <= 233_472
    assert geo.smem + cuda_kernels.STATIC_SMEM_BYTES <= cuda_kernels.H100_SMEM_OPTIN_BYTES


#: every C function the wrappers bind: (kernel, function)
BINDINGS = [(name, fn) for name, fns in cuda_kernels._SIGNATURES.items() for fn in fns]
_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _c_type(decl: str):
    decl = " ".join(decl.split())
    return ctypes.c_void_p if "*" in decl else _C_TYPES[decl.rsplit(" ", 1)[0] if " " in decl else decl]


@pytest.mark.parametrize("name,fn", BINDINGS)
def test_bindings_match_the_sources(name, fn):
    """The ctypes signature of each bound C function is the one its source
    declares (pointers as c_void_p), so that kernel D's launch, for one,
    takes kernel B's peak split (k, band_rows) right after the radii."""
    source = (cuda_kernels.CSRC / cuda_kernels.SOURCES[name]).read_text()
    m = re.search(rf"^(int|long long) {fn}\(([^)]*)\)", source, re.M)
    assert m, f"{fn} not declared in {cuda_kernels.SOURCES[name]}"
    params = [p for p in m.group(2).split(",") if p.strip()]
    restype, argtypes = cuda_kernels._SIGNATURES[name][fn]
    assert _C_TYPES[m.group(1)] is restype
    assert [_c_type(p) for p in params] == argtypes, params
    if fn == "pcff_phase_correlate_fullfused":
        names = [p.split()[-1] for p in params]
        assert names[6:10] == ["search_radius", "centroid_radius", "k", "band_rows"]
