"""Kernel B's split over several blocks a surface, on the CPU: the
blocks-per-surface helper, a model of the split and merge (the window's raw
rows in bands, the column chunks each block reads, the masked-zero seed, the
merge of the blocks' candidates in any order) against the plain twin
``cuda_kernels.peak_refine_raw_ref``, and the work behind B's bound in
``PERF.md``.  The kernel itself runs only on the card (``chip_smoke.py``
phase 6).

Tolerances: peak index, NaN pattern and maxval exact (the same element of
the same surface); shifts within 1e-4 px (``chip_smoke.PEAK_SHIFT_TOL``:
float32 centroid sums taken in another order).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck


@pytest.mark.parametrize("p,n,r,k,band", [
    (1, 480, 240, 240, 2),  # the scale/rotation surface: every row in the window
    (4, 480, 240, 60, 8),
    (64, 120, 55, 5, 23),  # the fft route: 111 window rows
    (16, 120, 55, 16, 7),
    (263, 120, 55, 2, 56),
    (264, 120, 55, 1, 111),  # P alone fills the card
    (5000, 60, 25, 1, 51),
    (1, 15, 3, 7, 1),  # odd n
    (1, 1, 0, 1, 1),
])
def test_peak_split(p, n, r, k, band):
    assert ck.peak_split(p, n, r) == (k, band)
    rows = ck.peak_window_rows(n, r)
    assert k * band >= rows > (k - 1) * band


@pytest.mark.parametrize("n,r", [(480, 240), (480, 55), (171, 55), (240, 55), (240, 240), (97, 3)])
def test_peak_split_is_a_valid_split(n, r):
    """What ``peak::valid_split`` accepts, which kernels B and D check before
    they launch, for every batch (or kernel D chunk) up to 300 pairs: the k
    bands cover the window's rows and none is empty, so k <= n as kernel
    D's scratch assumes."""
    rows = ck.peak_window_rows(n, r)
    for p in range(1, 301):
        k, band = ck.peak_split(p, n, r)
        assert k * band >= rows > (k - 1) * band and 1 <= k <= n, (p, k, band)


def test_peak_split_fills_the_card():
    """At least one block on each of the 132 SMs below PEAK_FILL_BLOCKS
    surfaces (the rows round to whole bands), one a surface from there."""
    for p in (1, 2, 3, 4, 7, 16, 64, 100, 263, 264, 1000):
        k, _ = ck.peak_split(p, 480, 240)
        assert p * k >= ck.PEAK_FILL_BLOCKS // 2 and (k == 1) == (p >= ck.PEAK_FILL_BLOCKS)


def _visited_columns(n: int, r: int, v: int) -> np.ndarray:
    """The raw columns a block reads, as the kernel walks them: chunks of v
    columns meeting 0 .. hi, then those meeting lo .. n - 1 not among them,
    each element kept when it lies in either run."""
    half = n // 2
    masked = half > r
    hi, lo = (r, n - r) if masked else (n - 1, n)
    n_a = hi // v + 1
    c_b = max(lo // v, n_a)
    chunks = list(range(n_a)) + list(range(c_b, n // v))
    cols = [c * v + t for c in chunks for t in range(v)]
    return np.array([x for x in cols if x <= hi or x >= lo])


def _window_rows(n: int, r: int) -> np.ndarray:
    half = n // 2
    masked = half > r
    hi, lo = (r, n - r) if masked else (n - 1, n)
    vr = np.arange(ck.peak_window_rows(n, r))
    return np.where(vr <= hi, vr, vr + lo - hi - 1)


@pytest.mark.parametrize("n", [1, 2, 15, 16, 120, 121, 480])
@pytest.mark.parametrize("r", [0, 3, 7, 8, 55, 60, 240])
def test_visited_rows_and_columns_are_the_window(n, r):
    half = n // 2
    shifted = (np.arange(n) + half) % n
    want = np.flatnonzero(np.abs(shifted - half) <= r)
    np.testing.assert_array_equal(_window_rows(n, r), want)
    for v in (1, 4) if n % 4 == 0 else (1,):
        np.testing.assert_array_equal(_visited_columns(n, r, v), want)


def split_model(raw: np.ndarray, r: int, cr: int, rng=None):
    """Kernel B's result by its split: each block's best (value, shifted
    index) and NaN flag over its band of window rows and the visited
    columns, seeded with the masked zero (0.0, 0) while n / 2 > r; the
    blocks merged in the order ``rng`` shuffles them into; then the
    centroid.  Returns (shift [P, 2], maxval [P], index [P])."""
    p_count, n = raw.shape[0], raw.shape[-1]
    half = n // 2
    k, band = ck.peak_split(p_count, n, r)
    rows = _window_rows(n, r)
    cols = _visited_columns(n, r, 4 if n % 4 == 0 else 1)
    sy = (rows + half) % n
    sx = (cols + half) % n
    idx = sy[:, None] * n + sx[None, :]
    shift = np.empty((p_count, 2), dtype=np.float32)
    maxval = np.empty(p_count, dtype=np.float32)
    index = np.empty(p_count, dtype=np.int64)
    for p in range(p_count):
        vals = raw[p][np.ix_(rows, cols)]
        cands = []
        for b in range(k):
            v, s = vals[b * band:(b + 1) * band], idx[b * band:(b + 1) * band]
            nan = bool(np.isnan(v).any())
            best = (0.0, 0) if half > r else (-np.inf, n * n)
            ok = ~np.isnan(v)
            if ok.any():
                m = v[ok].max()
                s_m = int(s[ok & (v == m)].min())
                if m > best[0] or (m == best[0] and s_m < best[1]):
                    best = (float(m), s_m)
            cands.append((best, nan))
        order = rng.permutation(k) if rng is not None else range(k)
        best, nan = (-np.inf, n * n), False
        for j in order:
            (v, s), f = cands[j]
            nan |= f
            if v > best[0] or (v == best[0] and s < best[1]):
                best = (v, s)
        yc, xc = divmod(best[1], n)
        ys, xs = np.mgrid[max(0, yc - cr):min(n, yc + cr + 1), max(0, xc - cr):min(n, xc + cr + 1)]
        inwin = (np.abs(ys - half) <= r) & (np.abs(xs - half) <= r)
        w = raw[p][(ys - half) % n, (xs - half) % n].astype(np.float32)
        w = np.where(inwin & (w > 0), w, np.float32(0))
        denom = np.float32(w.sum(dtype=np.float32) + np.float32(1.1920928955078125e-07))
        cx = np.float32((w * xs.astype(np.float32)).sum(dtype=np.float32) / denom - half)
        cy = np.float32((w * ys.astype(np.float32)).sum(dtype=np.float32) / denom - half)
        shift[p] = (np.nan, np.nan) if nan else (cx, cy)
        maxval[p] = np.nan if nan else best[0]
        index[p] = best[1]
    return shift, maxval, index


def _check_against_twin(raw: np.ndarray, r: int, cr: int = 3):
    ts, tm, ti = (x.numpy() for x in ck.peak_refine_raw_ref(
        torch.from_numpy(raw), search_radius=r, centroid_radius=cr, with_index=True))
    for seed in (None, 0, 1):
        rng = None if seed is None else np.random.default_rng(seed)
        ms, mm, mi = split_model(raw, r, cr, rng)
        nan = np.isnan(tm)
        np.testing.assert_array_equal(np.isnan(mm), nan)
        np.testing.assert_array_equal(np.isnan(ms), np.isnan(ts))
        np.testing.assert_array_equal(mi[~nan], ti[~nan])
        np.testing.assert_array_equal(mm[~nan], tm[~nan])
        np.testing.assert_allclose(ms, ts, atol=chip_smoke.PEAK_SHIFT_TOL, rtol=0)
    return ms, mm, mi


def _noise(p, n, seed=0):
    return np.random.default_rng(seed).uniform(-0.1, 0.1, (p, n, n)).astype(np.float32)


def test_ties_straddling_two_bands():
    """P = 1, N = 480, r 240: bands of 2 raw rows.  A tie between raw rows 1
    and 2 (two blocks) and between rows 0 and 479 (the first and last)."""
    raw = _noise(2, 480)
    raw[0, 1, 7] = raw[0, 2, 3] = 1.0
    raw[1, 0, 5] = raw[1, 479, 5] = 1.0
    _, _, idx = _check_against_twin(raw[:1], 240)
    assert idx[0] == ((1 + 240) % 480) * 480 + 247  # shifted row 241 < 242
    _, _, idx = _check_against_twin(raw[1:], 240)
    assert idx[0] == 239 * 480 + 245  # raw row 479 sits at shifted row 239


def test_nan_in_one_band_only():
    raw = _noise(1, 480)
    raw[0, 10, 10] = 1.0
    raw[0, 300, 4] = np.nan
    _, mm, _ = _check_against_twin(raw, 240)
    assert np.isnan(mm[0])


def test_nan_outside_the_window_is_masked():
    raw = _noise(4, 120)
    raw[:, 3, 3] = 1.0
    raw[:, 60, 60] = np.nan  # shifted (0, 0): outside radius 55
    raw[2, 60, 2] = np.nan  # shifted row 0: outside
    _, mm, _ = _check_against_twin(raw, 55)
    assert np.isfinite(mm).all()


def test_all_negative_with_a_masked_window():
    """r < n/2: the masked zero at shifted index 0 is the peak."""
    raw = -np.random.default_rng(1).uniform(0.5, 1.0, (2, 120, 120)).astype(np.float32)
    ms, mm, mi = _check_against_twin(raw, 55)
    assert np.all(mm == 0.0) and np.all(mi == 0)


@pytest.mark.parametrize("n,r", [(120, 60), (120, 100), (15, 7), (480, 240)])
def test_all_negative_with_the_whole_surface(n, r):
    """r >= n/2: nothing is masked, the largest negative value wins."""
    raw = -np.random.default_rng(2).uniform(0.5, 1.0, (1, n, n)).astype(np.float32)
    raw[0, 3, 4] = -0.25
    ms, mm, mi = _check_against_twin(raw, r)
    assert mm[0] == np.float32(-0.25)


def test_edge_peak_clamps_the_centroid():
    raw = _noise(1, 120, seed=3)
    raw[0, 60, 63] = 3.0  # shifted (0, 3): the surface's top edge
    raw[0, 60, 64] = raw[0, 61, 63] = 1.0
    _check_against_twin(raw, 60)


@pytest.mark.parametrize("n", [15, 45, 121])
def test_odd_n(n):
    raw = _noise(3, n, seed=n)
    raw[0, 2, n - 3] = 1.0
    raw[1, 1, 1] = raw[1, n - 1, 2] = 0.5  # tie
    raw[2, n // 2, n // 2] = np.nan  # shifted (0, 0)
    raw[2, 0, 1] = 1.0
    for r in (n // 4, n // 2, n):
        _check_against_twin(raw, r)


@pytest.mark.parametrize("p", [1, 4, 64])
def test_batches(p):
    raw = _noise(p, 120, seed=p)
    rng = np.random.default_rng(p)
    for i in range(p):
        raw[i, rng.integers(0, 120), rng.integers(0, 120)] = 1.0
    for r in (55, 60):
        _check_against_twin(raw, r)


def test_scale_rotation_shape():
    raw = _noise(1, 480, seed=5)
    raw[0, 477, 12] = 1.0
    raw[0, 478, 12] = 0.8
    _check_against_twin(raw, 240)


#: (p, n, operations, bytes, bound ms, bound by): one comparison an element,
#: float32 surfaces in, 12 B of shift and maxval a surface out
KERNEL_B_WORK = [
    (1, 480, 230_400, 921_612, 0.00027511, "bytes"),
    (4, 480, 921_600, 3_686_448, 0.0011004, "bytes"),
    (64, 120, 921_600, 3_687_168, 0.0011006, "bytes"),
]


@pytest.mark.parametrize("p,n,ops,nbytes,ms,by", KERNEL_B_WORK)
def test_kernel_b_work_and_bound(p, n, ops, nbytes, ms, by):
    assert chip_smoke.WORK["peak_refine_raw"](p=p, n=n) == (ops, nbytes)
    got_ms, got_by = chip_smoke.bound("peak_refine_raw", p=p, n=n)
    assert got_ms == pytest.approx(ms, rel=1e-4) and got_by == by
