"""Kernel A's bookkeeping on the CPU: its shared-memory formula and route
bound, the operation and byte counts behind its bound in ``PERF.md``, and a
float32 NumPy model of its in-place FFT (buffer positions, permuted order,
Hermitian splits) against a float64 FFT phase correlation.  The kernel
itself runs only on the card (``chip_smoke.py`` phase 3)."""

import math
import pathlib
import re

import numpy as np
import pytest

import chip_smoke
from mrs_optic_flow_tpu_torch.ops import cuda_kernels

CU = pathlib.Path(cuda_kernels.CSRC) / cuda_kernels.SOURCES["phase_correlate_frames"]


def _cu_smem_formula():
    """``pcf_smem_bytes`` as the CUDA source states it, as a function of n."""
    body = re.search(r"long long pcf_smem_bytes\(int n\) \{\s*return (.*?);\s*\}", CU.read_text(), re.S)
    expr = re.sub(r"static_cast<long long>\((.*?)\)", r"(\1)", body.group(1).replace("sizeof(float2)", "8"))
    return lambda n: eval(expr, {}, {"n": n})


def test_smem_formula_matches_the_source():
    formula = _cu_smem_formula()
    for n in range(1, 481):
        assert cuda_kernels.pcf_smem_bytes(n) == formula(n) == n * n * 8
    assert cuda_kernels.pcf_smem_bytes(120) == 115_200


def test_max_patch_follows_from_the_formula():
    limit = cuda_kernels.H100_SMEM_OPTIN_BYTES - cuda_kernels.STATIC_SMEM_BYTES
    assert cuda_kernels.PCF_MAX_PATCH == max(n for n in range(1, 1024) if 8 * n * n <= limit) == 170
    # two blocks of the n = 120 kernel share an SM's 233,472 B, each with the
    # runtime's 1 KB reserve and up to 512 B of static shared memory
    assert 2 * (cuda_kernels.pcf_smem_bytes(120) + 512 + 1024) <= 233_472


@pytest.mark.parametrize("patch", range(8, 201))
def test_frames_kernel_takes(patch):
    assert cuda_kernels.frames_kernel_takes(patch) is (patch % 8 == 0 and patch <= 168)


#: (shape, operations, bytes, bound ms, bound by) of kernel A's rows in
#: PERF.md: n = 120 windows, 4 x 4 a uint8 480 px frame pair
KERNEL_A_WORK = [
    (1, 25.28e6, 460_992, 0.000377, "operations"),
    (4096, 103.53e9, 1_888_223_232, 1.545, "operations"),
]


@pytest.mark.parametrize("b,ops,nbytes,ms,by", KERNEL_A_WORK)
def test_kernel_a_work_and_bound(b, ops, nbytes, ms, by):
    got_ops, got_bytes = chip_smoke.WORK["phase_correlate_frames"](b=b, n=120, q=4, itemsize=1)
    assert got_ops == pytest.approx(ops, rel=5e-4) and got_bytes == nbytes
    got_ms, got_by = chip_smoke.bound("phase_correlate_frames", b=b, n=120, q=4, itemsize=1)
    assert got_ms == pytest.approx(ms, rel=1e-3) and got_by == by


def test_fft_and_direct_dft_counts_per_window():
    """1.58 MFLOP a 120 px window for the FFT count of the bound, against the
    31.6 MFLOP the former direct-DFT kernel A executed (36 n^2 (n/2 + 1):
    two real row DFTs at 4 FLOP a term, two complex column DFTs and the
    inverse column DFT at 8, the real-output row DFT at 4)."""
    n = 120
    assert chip_smoke.pc_flops(n) == pytest.approx(1.5797e6, rel=1e-4)
    assert 5 * n * n * math.log2(n * n) == pytest.approx(994_592, rel=1e-5)
    assert 36 * n * n * (n // 2 + 1) == 31_622_400


# --------------------------------------------------------------------------- #
# float32 NumPy model of the kernel's stages                                   #
# --------------------------------------------------------------------------- #

EPS = np.float32(1.1920928955078125e-07)


def _dft8(v, sign):
    w = np.exp(sign * 2j * np.pi * np.outer(np.arange(8), np.arange(8)) / 8).astype(np.complex64)
    return (v @ w).astype(np.complex64)


def _perm(k, m):
    return (k >> 3) + m * (k & 7)


def _dftm(b, tab, inverse):
    """The kernel's m-point DFT over the last axis (m = 8 m' entries of the
    n-point table): j paired with m - j (u = b_j + b_(m-j), v = b_j -
    b_(m-j)), k with m - k, four real sums a (j, k) pair; (-1)^k for the
    j = m/2 term of an even m."""
    m = b.shape[-1]
    w = tab[8 * np.arange(m)]
    if inverse:
        w = np.conj(w)
    out = np.empty_like(b)
    half = (m - 1) // 2
    u = {j: b[..., j] + b[..., m - j] for j in range(1, half + 1)}
    v = {j: b[..., j] - b[..., m - j] for j in range(1, half + 1)}
    mid = b[..., m // 2] if m % 2 == 0 else np.zeros_like(b[..., 0])
    out[..., 0] = b[..., 0] + mid + sum(u.values(), np.zeros_like(mid))
    for k in range(1, half + 1):
        sign = np.float32(-1.0 if k & 1 else 1.0)
        a = b[..., 0].real + sign * mid.real
        c = b[..., 0].imag + sign * mid.imag
        bs = d = np.zeros_like(a)
        for j in range(1, half + 1):
            tw = w[(j * k) % m]
            a, c = a + u[j].real * tw.real, c + u[j].imag * tw.real
            bs, d = bs + v[j].imag * tw.imag, d + v[j].real * tw.imag
        out[..., k] = a - bs + 1j * (c + d)
        out[..., m - k] = a + bs + 1j * (c - d)
    if m % 2 == 0 and m > 1:
        x = b[..., 0] + sum(((-1) ** j) * u[j] for j in range(1, half + 1))
        out[..., m // 2] = x + ((-1) ** (m // 2)) * mid
    return out


@pytest.mark.parametrize("m", range(1, 22))
def test_symmetric_m_point_dft(m):
    """The pairing of the kernel's m-point DFT, both directions, every m of
    a patch it takes (n = 8 m <= 168)."""
    n = 8 * m
    tab = np.exp(-2j * np.pi * np.arange(n) / n).astype(np.complex64)
    b = np.random.default_rng(m).normal(size=(3, m)) + 1j * np.random.default_rng(m + 1).normal(size=(3, m))
    b = b.astype(np.complex64)
    np.testing.assert_allclose(_dftm(b, tab, False), np.fft.fft(b.astype(np.complex128)), atol=2e-5)
    np.testing.assert_allclose(_dftm(b, tab, True), np.fft.ifft(b.astype(np.complex128)) * m, atol=2e-5)


def _fft(buf, bases, es, n, tab, inverse):
    """In-place four-step FFT of the lines at ``bases`` (element j at
    ``base + j * es``): forward natural -> permuted, inverse permuted ->
    natural, each step on one position set a (line, index) task."""
    m = n // 8
    bases = np.asarray(bases)[:, None]
    steps = ["dftm", "radix8"] if inverse else ["radix8", "dftm"]
    for step in steps:
        if step == "radix8":
            for j1 in range(m):
                pos = bases + es * (j1 + m * np.arange(8))[None]
                tw = tab[j1 * np.arange(8)][None]
                buf[pos] = (_dft8(buf[pos] * np.conj(tw), +1) if inverse
                            else _dft8(buf[pos], -1) * tw)
        else:
            for k2 in range(8):
                pos = bases + es * (np.arange(m) + m * k2)[None]
                buf[pos] = _dftm(buf[pos], tab, inverse)


def _split(a, b):
    """(a + b) / 2 and (a - b) / 2i of a = Z(k), b = conj Z(-k)."""
    return (a + b) * np.float32(0.5), (a - b) * np.complex64(-0.5j)


def _kernel_a_surface(curr, prev):
    """The raw correlation surface of one window, stage by stage as the
    kernel computes it in its one n x n complex buffer."""
    n = curr.shape[0]
    m, h = n // 8, n // 2
    tab = np.exp(-2j * np.pi * np.arange(n) / n).astype(np.complex64)
    buf = np.empty((n, n), np.complex64)
    buf[0::2] = curr[0::2] + 1j * curr[1::2]  # 1. row 2p: curr rows 2p, 2p + 1
    buf[1::2] = prev[0::2] + 1j * prev[1::2]
    flat = buf.reshape(-1)
    _fft(flat, np.arange(n) * n, 1, n, tab, False)  # 2. rows
    for p in range(h):  # 3. split into [T1 | T2] half spectra
        out = np.empty((2, n), np.complex64)
        for s in range(2):
            r = buf[2 * p + s][_perm(np.arange(n), m)]
            l = np.arange(1, h)
            ev, od = _split(r[l], np.conj(r[n - l]))
            out[0, s * h + l], out[1, s * h + l] = ev, od
            out[0, s * h] = r[0].real + 1j * r[h].real
            out[1, s * h] = r[0].imag + 1j * r[h].imag
        buf[2 * p:2 * p + 2] = out
    _fft(flat, np.arange(n), n, n, tab, False)  # 4. columns
    rows = _perm(np.arange(n), m)  # 5. cross-power
    f = buf[rows]
    cp = f[:, 1:h] * np.conj(f[:, h + 1:])
    buf[rows, 1:h] = cp / np.sqrt(np.abs(cp) ** 2 + EPS)
    f10, f1h = _split(f[:, 0], np.conj(f[(-np.arange(n)) % n, 0]))
    f20, f2h = _split(f[:, h], np.conj(f[(-np.arange(n)) % n, h]))
    sign = (-1.0) ** np.arange(n)
    for img, col0, colh in ((curr, f10, f1h), (prev, f20, f2h)):
        # the four self-conjugate bins as direct sums (1. of the kernel)
        col0[0], col0[h] = img.sum(dtype=np.float32), (img * sign[:, None]).sum(dtype=np.float32)
        colh[0], colh[h] = (img * sign).sum(dtype=np.float32), (img * np.outer(sign, sign)).sum(dtype=np.float32)
    r0, rh = f10 * np.conj(f20), f1h * np.conj(f2h)
    buf[rows, 0] = r0 / np.sqrt(np.abs(r0) ** 2 + EPS) + 1j * rh / np.sqrt(np.abs(rh) ** 2 + EPS)
    _fft(flat, np.arange(h), n, n, tab, True)  # 6. columns of the curr half
    scale = np.float32(1.0 / (n * n))
    for p in range(h):  # 7. Hermitian-extended row pairs, permuted order
        u1, u2 = buf[2 * p, :h].copy(), buf[2 * p + 1, :h].copy()
        v = np.empty(n, np.complex64)
        l = np.arange(1, h)
        v[l] = u1[l] + 1j * u2[l]
        v[n - l] = np.conj(u1[l]) + 1j * np.conj(u2[l])
        v[0], v[h] = u1[0].real + 1j * u2[0].real, u1[0].imag + 1j * u2[0].imag
        buf[2 * p, _perm(np.arange(n), m)] = v * scale
    _fft(flat, np.arange(h) * 2 * n, 1, n, tab, True)  # 8. rows 2p
    surf = np.empty((n, n), np.float32)
    surf[0::2], surf[1::2] = buf[0::2].real, buf[0::2].imag
    return surf


def _reference_surface(curr, prev):
    r = np.fft.fft2(curr.astype(np.float64)) * np.conj(np.fft.fft2(prev.astype(np.float64)))
    return np.fft.ifft2(r / np.sqrt(np.abs(r) ** 2 + float(EPS))).real


@pytest.mark.parametrize("n", [8, 16, 24, 40, 120, 168])
def test_fft_model_matches_float64_phase_correlation(n):
    rng = np.random.default_rng(n)
    prev = rng.integers(0, 256, (n, n)).astype(np.float32)
    curr = np.roll(prev, (3 % n, -5 % n), axis=(0, 1))
    curr[: n // 4] = rng.integers(0, 256, (n // 4, n))  # not a pure circular shift
    surf = _kernel_a_surface(curr, prev)
    np.testing.assert_allclose(surf, _reference_surface(curr, prev), atol=2e-6)


def test_fft_model_keeps_exactly_zero_bins_zero():
    """A patch whose Nyquist-Nyquist bin is exactly zero (integer pixels):
    the direct sum keeps it zero, as the twin's DFT does, so the surface
    carries no (-1)^(x+y) ripple."""
    n = 24
    rng = np.random.default_rng(3)
    prev = rng.integers(0, 256, (n, n)).astype(np.float32)
    curr = np.roll(prev, (2, -1), axis=(0, 1))
    checker = np.outer((-1.0) ** np.arange(n), (-1.0) ** np.arange(n))
    curr[0, 0] -= (curr * checker).sum()  # F(n/2, n/2) = 0 exactly
    assert (curr * checker).sum() == 0.0
    np.testing.assert_allclose(_kernel_a_surface(curr, prev), _reference_surface(curr, prev), atol=2e-6)


@pytest.mark.parametrize("zero", ["both", "curr", "prev"])
def test_fft_model_keeps_zero_patches_exact(zero):
    """A zero patch packs only with rows of its own patch, so its spectrum is
    exactly zero and the surface a plane of exact zeros (every entry a tie)."""
    n = 48
    img = np.random.default_rng(7).integers(0, 256, (n, n)).astype(np.float32)
    z = np.zeros_like(img)
    curr, prev = {"both": (z, z), "curr": (z, img), "prev": (img, z)}[zero]
    assert np.all(_kernel_a_surface(curr, prev) == 0.0)
