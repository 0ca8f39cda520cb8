"""Kernel D's bookkeeping on the CPU: its FFT plan for every n up to 480,
its route between the one-block and the staged design and its shared memory
against the source, the operation and byte counts behind its bound in
``PERF.md``, and a float32 NumPy model of its stages (in-place mixed-radix
FFT with a generic radix, row packing, odd n, Hermitian split and pack, the
staged design's fused column pass) against a float64 FFT phase correlation.
Kernel E runs on the same stages, so ``tests/test_torch_kernel_e.py`` takes
the FFT model from here.  The kernel itself runs only on the card
(``chip_smoke.py`` phase 10)."""

import math
import pathlib
import re

import numpy as np
import pytest

import chip_smoke
from mrs_optic_flow_tpu_torch.ops import cuda_kernels

CSRC = pathlib.Path(cuda_kernels.CSRC)
CU = (CSRC / cuda_kernels.SOURCES["phase_correlate_fullfused"]).read_text()
STAGES = (CSRC / "fft_stages.cuh").read_text()
EPS = np.float32(1.1920928955078125e-07)
MODEL_SIZES = [15, 45, 60, 97, 150, 171, 240]


def _cu_int(name, text=CU + STAGES):
    """A constant of kernel D's source or of the FFT header both D and E include."""
    return int(eval(re.search(rf"constexpr (?:long long|int) {name} = ([^;]+);", text).group(1)))


def _is_prime(p):
    return p > 1 and all(p % d for d in range(2, int(math.isqrt(p)) + 1))


def test_source_radices_are_the_plans():
    radices = re.search(r"constexpr int kRadices\[5\] = \{([^}]*)\};", STAGES).group(1)
    assert tuple(int(r) for r in radices.split(",")) == cuda_kernels.FFT_RADICES == (8, 4, 2, 3, 5)
    assert _cu_int("kThreads", STAGES) * _cu_int("kGenOut", STAGES) == cuda_kernels.FFT_MAX_GENERIC_RADIX


@pytest.mark.parametrize("n", range(1, 481))
def test_fft_plan(n):
    plan = cuda_kernels.fft_plan(n)
    assert math.prod(plan) == n
    unrolled = [r for r in plan if r in cuda_kernels.FFT_RADICES]
    generic = plan[len(unrolled):]
    # the unrolled radices first, in their order: 8s, at most one 4 or one 2, 3s, 5s
    assert unrolled == sorted(unrolled, key=cuda_kernels.FFT_RADICES.index)
    assert unrolled.count(4) + unrolled.count(2) <= 1
    assert all(_is_prime(p) and p > 5 for p in generic) and list(generic) == sorted(generic)
    assert len(plan) <= _cu_int("kMaxStages", STAGES)


def test_route_and_shared_memory_match_the_source():
    assert _cu_int("kSmallMaxW") == cuda_kernels.PCFF_MAX_SMALL == 170
    assert _cu_int("kSmemOptin") == cuda_kernels.H100_SMEM_OPTIN_BYTES
    assert _cu_int("kStaticReserve") == cuda_kernels.PCFF_STATIC_RESERVE
    assert _cu_int("kSmallThreads") == cuda_kernels.PCFF_SMALL_THREADS
    assert (_cu_int("kLines"), _cu_int("kBand"), _cu_int("kLargeSmemCap")) == (
        cuda_kernels.PCFF_LINES, cuda_kernels.PCFF_BAND, cuda_kernels.PCFF_SMEM_CAP)
    small = [n for n in range(1, 481) if cuda_kernels.pcff_small(n)]
    assert small == list(range(1, 171))
    for n in range(1, 481):
        w = n + n % 2
        smem = cuda_kernels.pcff_smem_bytes(n)
        if n <= 170:
            assert smem == 8 * w * w and cuda_kernels.pcff_scratch_bytes(n) == 0
            assert smem + cuda_kernels.PCFF_STATIC_RESERVE <= cuda_kernels.H100_SMEM_OPTIN_BYTES
        else:
            assert smem == max(4 * n * 8 + 4 * n, 16 * 4 * n) <= cuda_kernels.PCFF_SMEM_CAP
            assert cuda_kernels.pcff_scratch_bytes(n) == 16 * n * (n // 2 + 1) + 12 * n + 4
    # the static shared memory of the one-block design: perm table, the
    # warps' exact bins, block_argmax's three words for each of 32 warps
    warps = cuda_kernels.PCFF_SMALL_THREADS // 32
    assert 2 * 170 + 4 * 8 * warps + 3 * 4 * 32 <= cuda_kernels.PCFF_STATIC_RESERVE


#: (p, n, itemsize, operations, bytes, bound ms, bound by) of kernel D's
#: rows in PERF.md
KERNEL_D_WORK = [
    (64, 60, 1, 21.8427e6, 461_568, 0.000326, "operations"),
    (1, 480, 1, 32.1704e6, 460_812, 0.000480, "operations"),
    (4, 60, 4, 1.36517e6, 115_248, 0.0000344, "bytes"),
    (16, 150, 1, 41.2244e6, 720_192, 0.000615, "operations"),
    (4, 240, 1, 28.7201e6, 460_848, 0.000429, "operations"),
    (64, 45, 1, 11.4710e6, 259_968, 0.000171, "operations"),
    (16, 97, 1, 15.8162e6, 301_280, 0.000236, "operations"),
]


@pytest.mark.parametrize("p,n,itemsize,ops,nbytes,ms,by", KERNEL_D_WORK)
def test_kernel_d_work_and_bound(p, n, itemsize, ops, nbytes, ms, by):
    got_ops, got_bytes = chip_smoke.WORK["phase_correlate_fullfused"](p=p, n=n, itemsize=itemsize)
    assert got_ops == pytest.approx(ops, rel=5e-4) and got_bytes == nbytes
    got_ms, got_by = chip_smoke.bound("phase_correlate_fullfused", p=p, n=n, itemsize=itemsize)
    assert got_ms == pytest.approx(ms, rel=3e-3) and got_by == by


# --------------------------------------------------------------------------- #
# float32 NumPy model of the kernel's stages                                   #
# --------------------------------------------------------------------------- #


def _tab(n):
    return np.exp(-2j * np.pi * np.arange(n) / n).astype(np.complex64)


def _spans(plan, n):
    spans, span = [], n
    for r in plan:
        spans.append(span)
        span //= r
    return spans


def _perm(n):
    """Position of each frequency after the forward transform (``fft::perm``)."""
    plan = cuda_kernels.fft_plan(n)
    pos = np.zeros(n, np.int64)
    k = np.arange(n)
    for r, span in zip(plan, _spans(plan, n)):
        pos += (k % r) * (span // r)
        k = k // r
    return pos


def _stage(x, r, span, tab, inverse):
    """One stage over the last axis of ``x``: groups (block, j) of r
    elements j + m q; forward r-point DFT then W_L^(j k), inverse the
    conjugate twiddle then the inverse DFT.  The unrolled radices and the
    generic one compute the same sums; the model takes both as a matrix."""
    n = x.shape[-1]
    m = span // r
    v = x.reshape(x.shape[:-1] + (n // span, r, m))
    qk = np.outer(np.arange(r), np.arange(r)) % r
    w = tab[qk * (n // r)]
    tw = tab[np.outer(np.arange(r), np.arange(m)) * (n // span)]  # [k, j]
    if inverse:
        v = np.einsum("...qj,qk->...kj", v * np.conj(tw), np.conj(w)).astype(np.complex64)
    else:
        v = (np.einsum("...qj,qk->...kj", v, w) * tw).astype(np.complex64)
    return v.reshape(x.shape)


def _fft(x, inverse=False):
    n = x.shape[-1]
    plan = cuda_kernels.fft_plan(n)
    tab = _tab(n)
    stages = list(zip(plan, _spans(plan, n)))
    for r, span in reversed(stages) if inverse else stages:
        x = _stage(x, r, span, tab, inverse)
    return x


def _split(p, q):
    """(p + conj q) / 2 and (p - conj q) / 2i."""
    c = np.conj(q)
    return ((p + c) * np.float32(0.5)).astype(np.complex64), ((p - c) * np.complex64(-0.5j)).astype(np.complex64)


def _cross_power(f1, f2):
    r = (f1 * np.conj(f2)).astype(np.complex64)
    return (r / np.sqrt(np.abs(r) ** 2 + EPS)).astype(np.complex64)


def _small_surface(curr, prev):
    """The raw surface of one pair as the one-block design computes it in its
    W x W buffer (W = n + n % 2): packed rows, row FFTs, split, column FFTs,
    cross-power with the direct self-conjugate bins, inverse columns, pack,
    inverse rows."""
    n = curr.shape[0]
    odd, h = n % 2, n // 2
    w = n + odd
    s = w // 2
    pm = _perm(n)
    pad = lambda img: np.vstack([img, np.zeros((odd, n), np.float32)])  # noqa: E731
    buf = np.zeros((w, w), np.complex64)
    for k, img in enumerate((curr, prev)):  # 1. rows 2p (curr) and 2p + 1 (prev)
        z = pad(img)
        buf[k::2, :n] = z[0::2] + 1j * z[1::2]
    buf[:, :n] = _fft(buf[:, :n])  # 2.
    out = np.zeros_like(buf)  # 3. [T1 | T2] of real rows 2p, 2p + 1
    for k in range(2):
        rows = buf[k::2, :n]  # [s, n] packed spectra of patch k
        l = np.arange(1, s)
        a, b = _split(rows[:, pm[l]], rows[:, pm[n - l]])
        if odd:  # the lone last row: P(l) itself
            a[-1] = rows[-1, pm[l]]
        out[0::2, k * s + l], out[1::2, k * s + l] = a, b
        p0 = rows[:, pm[0]]
        ph = rows[:, pm[h]].real if not odd else np.zeros(s, np.float32)
        out[0::2, k * s] = p0.real + 1j * ph
        out[1::2, k * s] = p0.imag + 1j * (rows[:, pm[h]].imag if not odd else 0)
    buf = out
    buf[:n] = _fft(buf[:n].T).T  # 4. columns (rows 0 .. n - 1)
    sign = (-1.0) ** np.arange(n)
    exact = [(img.sum(dtype=np.float32), (img * sign[:, None]).sum(dtype=np.float32),
              (img * sign).sum(dtype=np.float32), (img * np.outer(sign, sign)).sum(dtype=np.float32))
             for img in (curr, prev)]
    if odd:  # 5. every slot; F(0, 0) direct
        f1, f2 = buf[:n, :s].copy(), buf[:n, s:].copy()
        f1[0, 0], f2[0, 0] = exact[0][0], exact[1][0]
        buf[:n, :s] = _cross_power(f1, f2)
    else:
        buf[:n, 1:h] = _cross_power(buf[:n, 1:h], buf[:n, h + 1:])
        ky = np.arange(n)
        c1, c2 = buf[pm[ky]], buf[pm[(n - ky) % n]]
        f10, f1h = _split(c1[:, 0], c2[:, 0])
        f20, f2h = _split(c1[:, h], c2[:, h])
        for col0, colh, e in ((f10, f1h, exact[0]), (f20, f2h, exact[1])):
            col0[0], col0[h], colh[0], colh[h] = e
        q = _cross_power(f10, f20) + 1j * _cross_power(f1h, f2h)
        buf[pm[ky], 0] = q
    u = _fft(buf[:n, :s].T, inverse=True).T  # 6. [n, s]
    scale = np.float32(1.0 / (n * n))
    u = np.vstack([u, np.zeros((odd, s), np.complex64)])
    u1, u2 = u[0::2], u[1::2]  # [s, s] each
    v = np.zeros((s, n), np.complex64)  # 7. packed rows in natural frequency order
    l = np.arange(1, h + odd)
    v[:, l] = (u1[:, l] + 1j * u2[:, l]) * scale
    v[:, n - l] = (np.conj(u1[:, l]) + 1j * np.conj(u2[:, l])) * scale
    v[:, 0] = (u1[:, 0].real + 1j * u2[:, 0].real) * scale
    if not odd:
        v[:, h] = (u1[:, 0].imag + 1j * u2[:, 0].imag) * scale
    packed = np.zeros_like(v)
    packed[:, pm] = v
    rows = _fft(packed, inverse=True)  # 8.
    surf = np.zeros((n + odd, n), np.float32)
    surf[0::2], surf[1::2] = rows.real, rows.imag
    return surf[:n]


def _large_surface(curr, prev):
    """The staged design: half spectra T [2, n, n/2 + 1] from the packed row
    FFTs and the Hermitian split (rows_forward); the fused column pass, all
    n rows of the band: forward column FFTs, cross-power, inverse column FFTs
    (cols_fused); row pairs Hermitian-extended, packed and inverted
    (rows_inverse)."""
    n = curr.shape[0]
    odd, nh = n % 2, n // 2 + 1
    pm = _perm(n)
    t = np.zeros((2, n, nh), np.complex64)
    l = np.arange(nh)
    for k, img in enumerate((curr, prev)):
        z = np.vstack([img, np.zeros((odd, n), np.float32)])
        spec = _fft((z[0::2] + 1j * z[1::2]).astype(np.complex64))
        a, b = _split(spec[:, pm[l]], spec[:, pm[(n - l) % n]])
        t[k, 0::2], t[k, 1::2] = a, b[: n // 2]
        if odd:
            t[k, -1] = spec[-1, pm[l]]
    f = _fft(np.transpose(t, (0, 2, 1)))  # [2, nh, n] columns as lines, perm order in ky
    r = _cross_power(f[0], f[1])
    u = _fft(r, inverse=True).T  # [n, nh]
    u = np.vstack([u, np.zeros((odd, nh), np.complex64)])
    u1, u2 = u[0::2], u[1::2]
    scale = np.float32(1.0 / (n * n))
    v = np.zeros((u1.shape[0], n), np.complex64)
    lo = np.arange(1, (n + 1) // 2)
    v[:, lo] = (u1[:, lo] + 1j * u2[:, lo]) * scale
    v[:, n - lo] = (np.conj(u1[:, lo]) + 1j * np.conj(u2[:, lo])) * scale
    v[:, 0] = (u1[:, 0].real + 1j * u2[:, 0].real) * scale
    if not odd:
        v[:, n // 2] = (u1[:, n // 2].real + 1j * u2[:, n // 2].real) * scale
    packed = np.zeros_like(v)
    packed[:, pm] = v
    rows = _fft(packed, inverse=True)
    surf = np.zeros((n + odd, n), np.float32)
    surf[0::2], surf[1::2] = rows.real, rows.imag
    return surf[:n]


def _model_surface(curr, prev):
    n = curr.shape[0]
    return _small_surface(curr, prev) if cuda_kernels.pcff_small(n) else _large_surface(curr, prev)


def _reference_surface(curr, prev):
    r = np.fft.fft2(curr.astype(np.float64)) * np.conj(np.fft.fft2(prev.astype(np.float64)))
    return np.fft.ifft2(r / np.sqrt(np.abs(r) ** 2 + float(EPS))).real


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 12, 19, 97, 171, 240])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_model_is_a_dft_in_perm_order(n, inverse):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))).astype(np.complex64)
    pm = _perm(n)
    assert sorted(pm) == list(range(n))
    if inverse:
        permuted = np.zeros_like(x)
        permuted[:, pm] = x
        got, want = _fft(permuted, inverse=True), np.fft.ifft(x.astype(np.complex128)) * n
    else:
        got, want = _fft(x)[:, pm], np.fft.fft(x.astype(np.complex128))
    np.testing.assert_allclose(got, want, atol=5e-5 * n, rtol=0)


def _pair(n, seed):
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 256, (n, n)).astype(np.float32)
    curr = np.roll(prev, (3 % n, -5 % n), axis=(0, 1))
    curr[: n // 4] = rng.integers(0, 256, (n // 4, n))  # not a pure circular shift
    return curr, prev


@pytest.mark.parametrize("n", MODEL_SIZES)
def test_model_matches_float64_phase_correlation(n):
    curr, prev = _pair(n, n)
    surf = _model_surface(curr, prev)
    np.testing.assert_allclose(surf, _reference_surface(curr, prev), atol=3e-6)


@pytest.mark.parametrize("n", [60, 97, 240])
def test_both_designs_agree(n):
    """The staged design's model on a size the one-block design takes, and
    the other way round: the same surface within float32 rounding."""
    curr, prev = _pair(n, 2 * n)
    np.testing.assert_allclose(_small_surface(curr, prev), _large_surface(curr, prev), atol=3e-6)


@pytest.mark.parametrize("n", [15, 60, 171, 240])
@pytest.mark.parametrize("zero", ["both", "curr", "prev"])
def test_model_keeps_one_sided_zero_pairs_exact(n, zero):
    """Rows pack only with rows of their own patch, so a zero patch has an
    exactly zero spectrum and the surface is a plane of exact zeros: every
    entry a tie, the minimum shifted index wins, as the twin gives."""
    img = np.random.default_rng(7).integers(0, 256, (n, n)).astype(np.float32)
    z = np.zeros_like(img)
    curr, prev = {"both": (z, z), "curr": (z, img), "prev": (img, z)}[zero]
    assert np.all(_model_surface(curr, prev) == 0.0)


def test_model_keeps_exactly_zero_bins_zero():
    """The direct sums keep an exactly zero Nyquist-Nyquist bin zero at
    n = 30 (a size only kernel D takes), as the twin's DFT does."""
    n = 30
    rng = np.random.default_rng(3)
    prev = rng.integers(0, 256, (n, n)).astype(np.float32)
    curr = np.roll(prev, (2, -1), axis=(0, 1))
    checker = np.outer((-1.0) ** np.arange(n), (-1.0) ** np.arange(n))
    curr[0, 0] -= (curr * checker).sum()
    assert (curr * checker).sum() == 0.0
    np.testing.assert_allclose(_small_surface(curr, prev), _reference_surface(curr, prev), atol=2e-6)
