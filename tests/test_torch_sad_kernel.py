"""Kernel C's bookkeeping on the CPU: its constants, shared-memory formula
and launch geometry against ``csrc/sad_search.cu``, the footprint at every
block and radius it is held to, a NumPy model of its summation order over
the partition :func:`cuda_kernels.sad_geometry` returns, and the work
behind its bound in ``PERF.md``.  The kernel itself runs only on the card
(``chip_smoke.py`` phases 7 and 13).

Tolerances: on integer-valued inputs the model is bit-identical to the
plain twin (every float32 row partial and the float64 total are exact); on
float inputs within 1e-6 relative (``chip_smoke.SAD_RTOL``: float32 row
partials summed in another order than the twin's).
"""

import pathlib
import re

import numpy as np
import pytest
import torch
from numpy.lib.stride_tricks import sliding_window_view

import chip_smoke
from mrs_optic_flow_tpu_torch.ops import block_matching, cuda_kernels as ck

CU = pathlib.Path(ck.CSRC) / ck.SOURCES["sad_search"]


def _cu_constants() -> dict:
    """The source's integer constants, one that a macro sets taking the
    macro's default (``#define SAD_TI 2`` under ``#ifndef SAD_TI``)."""
    text = CU.read_text()
    macros = dict(re.findall(r"#define (\w+) (\d+)", text))
    return {name: int(macros.get(v, v)) for name, v in re.findall(r"constexpr int (k\w+) = (\w+);", text)}


def test_constants_match_the_source():
    c = _cu_constants()
    assert (c["kTI"], c["kTJ"], c["kRows"], c["kWarps"], c["kMaxBand"]) == (
        ck.SAD_TI, ck.SAD_TJ, ck.SAD_ROWS, ck.SAD_WARPS, ck.SAD_MAX_BAND)


def _cu_functions():
    """The source's ``smem_bytes`` and tile rule as Python functions."""
    text = CU.read_text()
    consts = _cu_constants()
    consts["kTT"] = consts["kTI"] * consts["kTJ"]
    smem = re.search(r"long long smem_bytes\(int xb, int ni, int nj\) \{\s*return (.*?);\s*\}", text, re.S)
    expr = smem.group(1).replace("4LL", "4").replace("imax", "max")
    names = dict(consts, odd=lambda n: n | 1, max=max, min=min, cdiv=lambda a, b: -(-a // b))

    def smem_bytes(xb, ni, nj):
        return eval(expr, {}, dict(names, xb=xb, ni=ni, nj=nj))

    nj_rule = re.search(r"q\.nj = (.*?);", text).group(1).replace("imin", "min")
    ni_rule = re.search(r"q\.ni = (.*?);", text).group(1).replace("imin", "min").replace("q.nj", "nj").replace("/", "//")

    def tiles(r):
        d = 2 * r + 1
        scope = dict(names, n_dit=-(-d // consts["kTI"]), n_djt=-(-d // consts["kTJ"]))
        nj = eval(nj_rule, {}, scope)
        return eval(ni_rule, {}, dict(scope, nj=nj)), nj

    return smem_bytes, tiles


@pytest.mark.parametrize("r", [0, 1, 3, 8, 21, 32, 60, 200])
def test_smem_formula_and_tiles_match_the_source(r):
    smem_bytes, tiles = _cu_functions()
    assert ck._sad_tiles(r) == tiles(r)
    ni, nj = tiles(r)
    for xb in (1, 7, 16, 40, 120, 160, 255, 256):
        assert ck.sad_smem_bytes(r, xb) == smem_bytes(xb, ni, nj)


def test_node_geometry():
    """396 blocks of 8 warps at the node's geometry (3 blocks an SM by
    shared memory and by the 85-register launch bound); 3 column bands at
    G = 1 so that every SM has a block."""
    geo = ck.sad_geometry(9, 120, 21)
    assert (geo.xb, geo.parts, geo.ni, geo.nj, geo.n_dib, geo.threads, geo.blocks) == (
        120, 4, 2, 4, 11, 256, 396)
    assert geo.smem == 38_588
    assert 3 * (geo.smem + ck.STATIC_SMEM_BYTES) <= 233_472
    one = ck.sad_geometry(1, 120, 21)
    assert (one.xb, one.n_xb, one.parts, one.blocks) == (40, 3, 12, 132)


@pytest.mark.parametrize("g", [1, 9])
def test_every_block_and_radius_fits(g):
    """Every (S, R) with S in 1..256 and R in 0..32 fits a block of an H100,
    two blocks an SM, and its geometry covers every shift and pixel."""
    limit = ck.H100_SMEM_OPTIN_BYTES
    for s in range(1, 257):
        for r in range(33):
            geo = ck.sad_geometry(g, s, r)
            assert geo.smem + ck.STATIC_SMEM_BYTES <= limit and 2 * (geo.smem + ck.STATIC_SMEM_BYTES) <= 233_472
            assert geo.threads <= 32 * ck.SAD_WARPS and 1 <= geo.xb <= ck.SAD_MAX_BAND
            d = 2 * r + 1
            assert geo.n_dib * geo.ni * ck.SAD_TI >= d and geo.n_djb * geo.nj * ck.SAD_TJ >= d
            assert geo.n_xb * geo.xb >= s > (geo.n_xb - 1) * geo.xb
            assert geo.n_rg * ck.SAD_ROWS >= s
            assert geo.blocks == g * geo.n_dib * geo.n_djb * geo.parts


@pytest.mark.parametrize("s,r", [(300, 21), (1000, 5), (120, 100)])
def test_large_blocks_and_radii_stay_within_a_block(s, r):
    geo = ck.sad_geometry(1, s, r)
    assert geo.xb <= ck.SAD_MAX_BAND and geo.smem + ck.STATIC_SMEM_BYTES <= ck.H100_SMEM_OPTIN_BYTES


def sad_model(curr: np.ndarray, region: np.ndarray, s: int, r: int) -> np.ndarray:
    """Kernel C's sums in its order: for each part (32-row group, column
    band) of :func:`cuda_kernels.sad_geometry`, each row's float32 sum over
    the band's columns in column order, the 32 rows in float64 in lane
    order, the parts in float64 in part order, one rounding to float32."""
    g = curr.shape[0]
    d = 2 * r + 1
    geo = ck.sad_geometry(g, s, r)
    out = np.empty((g, d, d), dtype=np.float32)
    for c in range(g):
        win = sliding_window_view(region[c], (s, s))  # [d, d, s, s]
        diff = np.abs(curr[c][None, None] - win)  # float32
        total = np.zeros((d, d), dtype=np.float64)
        for rg in range(geo.n_rg):
            for xb in range(geo.n_xb):
                x0, x1 = xb * geo.xb, min(s, (xb + 1) * geo.xb)
                lanes = np.zeros((d, d, ck.SAD_ROWS), dtype=np.float32)
                y0, y1 = rg * ck.SAD_ROWS, min(s, (rg + 1) * ck.SAD_ROWS)
                rows = np.add.accumulate(diff[:, :, y0:y1, x0:x1], axis=-1)[..., -1]
                lanes[..., : y1 - y0] = rows
                part = np.add.accumulate(lanes.astype(np.float64), axis=-1)[..., -1]
                total = total + part
        out[c] = total.astype(np.float32)
    return out


def _blocks(seed, g, s, r, integer):
    rng = np.random.default_rng(seed)
    draw = (lambda shape: rng.integers(0, 256, shape)) if integer else (lambda shape: rng.uniform(0, 255, shape))
    return draw((g, s, s)).astype(np.float32), draw((g, s + 2 * r, s + 2 * r)).astype(np.float32)


def _twin(curr, region, s, r):
    return block_matching.sad_search(torch.from_numpy(curr), torch.from_numpy(region),
                                     block_size=s, scan_radius=r).numpy()


@pytest.mark.parametrize("g", [1, 9])
@pytest.mark.parametrize("s,r", [(16, 4), (24, 8), (40, 21)])
def test_model_bit_identical_on_integers(s, r, g):
    curr, region = _blocks(s + r + g, g, s, r, integer=True)
    np.testing.assert_array_equal(sad_model(curr, region, s, r), _twin(curr, region, s, r))


@pytest.mark.parametrize("g", [1, 9])
@pytest.mark.parametrize("s,r", [(16, 4), (24, 8), (40, 21)])
def test_model_within_rtol_on_floats(s, r, g):
    curr, region = _blocks(100 + s + r + g, g, s, r, integer=False)
    model, twin = sad_model(curr, region, s, r), _twin(curr, region, s, r)
    assert np.max(np.abs(model - twin) / np.abs(twin)) <= chip_smoke.SAD_RTOL


def test_model_partition_has_bands_and_row_groups():
    """The model above runs over more than one part: (40, 21) at G = 1 takes
    2 row groups x 2 column bands of 20."""
    geo = ck.sad_geometry(1, 40, 21)
    assert (geo.n_rg, geo.n_xb, geo.xb) == (2, 2, 20)


#: (g, s, r, operations, bytes, bound ms, bound by) at the shapes of phases
#: 7 and 13: 3 operations a pixel and shift, float32 blocks, regions and maps
KERNEL_C_WORK = [
    (9, 120, 21, 718_891_200, 1_529_748, 0.010730, "operations"),
    (1, 120, 21, 79_876_800, 169_972, 0.0011922, "operations"),
    (16, 120, 21, 1_278_028_800, 2_719_552, 0.019075, "operations"),
    (9, 160, 21, 1_278_028_800, 2_457_108, 0.019075, "operations"),
    (4, 240, 21, 1_278_028_800, 2_223_568, 0.019075, "operations"),
    (9, 120, 0, 388_800, 1_036_836, 0.00030950, "bytes"),
    (9, 8, 3, 84_672, 11_124, 3.3206e-06, "bytes"),
]


@pytest.mark.parametrize("g,s,r,ops,nbytes,ms,by", KERNEL_C_WORK)
def test_kernel_c_work_and_bound(g, s, r, ops, nbytes, ms, by):
    assert chip_smoke.WORK["sad_search"](g=g, s=s, r=r) == (ops, nbytes)
    got_ms, got_by = chip_smoke.bound("sad_search", g=g, s=s, r=r)
    assert got_ms == pytest.approx(ms, rel=1e-4) and got_by == by
