"""Kernel E's bookkeeping and a float32 NumPy model of it on the CPU.

The wrapper's forward products (``cuda_kernels._fused_spectra``: both patch
batches as one ``[n, 2P, n]`` matrix, ``T = X [Ch | Sh]`` over the half
spectrum, ``G = [C ; S] T``) against ``_dft2_real``; a model of both of the
kernel's designs (the cross-power on load from G's blocks, the other half
by conjugate symmetry, the full complex inverse FFT in the
order ``fft_plan`` gives, rows then columns, and the peak over the search
window) against a float64 phase correlation and against the JAX
``phase_correlate_fused_pallas`` in interpret mode, with NaN, zero and
masked pairs; the staged design's model leaves every entry outside the
window NaN, so the peak model shows it reads none.  Then the route, shared
memory, scratch and launches a chunk against the C source, the work behind
E's bound in ``PERF.md``, and repair F8 (any real dtype, as the JAX function
takes it).  The kernel itself runs only on the card (``chip_smoke.py``
phase 11)."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import fourier_shift, smooth_random_image
from test_torch_kernel_d import EPS, _cross_power, _fft, _perm, _reference_surface
from torch_parity import to_numpy

import chip_smoke
from mrs_optic_flow_tpu.ops.pallas_kernels import phase_correlate_fused_pallas
from mrs_optic_flow_tpu_torch.ops import cuda_kernels
from mrs_optic_flow_tpu_torch.ops.cuda_kernels import phase_correlate_fused
from mrs_optic_flow_tpu_torch.ops.phase_correlate import _dft2_real, _dft_matrices

CSRC = pathlib.Path(cuda_kernels.CSRC)
CU = (CSRC / cuda_kernels.SOURCES["phase_correlate_fused"]).read_text()
STAGES = (CSRC / "fft_stages.cuh").read_text()
SIZES = [15, 45, 60, 97, 120, 170, 171, 240, 480]
SHIFT_TOL = 1e-3  # px, as tests/test_torch_fullfused.py
#: px; the model of kernel E against the JAX kernel, the closest kernel D
#: came to its twin on the card: the half-spectrum forward products must
#: stay this close at every tested n (measured: at most 3.1e-5)
MODEL_SHIFT_TOL = 6.1e-5
MAXVAL_RTOL = 1e-4
CENTROID_RADIUS = 3


# --------------------------------------------------------------------------- #
# the model                                                                    #
# --------------------------------------------------------------------------- #


def _forward(curr, prev):
    """The wrapper's forward products in float32: X [n, 2P, n] (curr, then
    prev), T = X [Ch | Sh] (the first n/2 + 1 columns of C and S, padded to
    h = half_cols(n)), G = [C ; S] T [2n, 2P * 2h]; returns each patch's
    spectrum as complex64 [2P, n, n]: (G00 - G11) + i (G01 + G10) at
    kx <= n/2, conj F(-ky, -kx) beyond, as the kernel loads it."""
    p, n = curr.shape[0], curr.shape[-1]
    h, nh = cuda_kernels.half_cols(n), n // 2 + 1
    c, s = _dft_matrices(n)
    half = np.zeros((n, 2, h), np.float32)
    half[:, 0, :nh], half[:, 1, :nh] = c[:, :nh], s[:, :nh]
    x = np.concatenate([curr, prev]).astype(np.float32).transpose(1, 0, 2)
    t = x.reshape(n * 2 * p, n) @ half.reshape(n, 2 * h)
    g = (np.vstack([c, s]) @ t.reshape(n, 2 * p * 2 * h)).reshape(2, n, 2 * p, 2, h)
    fr = g[0, :, :, 0, :nh] - g[1, :, :, 1, :nh]
    fi = g[0, :, :, 1, :nh] + g[1, :, :, 0, :nh]
    f = np.zeros((2 * p, n, n), np.complex64)
    f[:, :, :nh] = (fr + 1j * fi).astype(np.complex64).transpose(1, 0, 2)
    ky, kx = np.arange(n), np.arange(nh, n)
    f[:, :, nh:] = np.conj(f[:, (n - ky) % n][:, :, n - kx])
    return f


def _window(n, search_radius):
    """The search window's raw rows (and columns), ``peak::window_raw``."""
    rows = cuda_kernels.peak_window_rows(n, search_radius)
    v = np.arange(rows)
    if n // 2 > search_radius:
        v = np.where(v > search_radius, v + n - 2 * search_radius - 1, v)
    return v


def _model_surface(f1, f2, search_radius, staged):
    """The raw surface of one pair as kernel E makes it from the spectra:
    R at (perm(ky), perm(kx)), the inverse row FFTs, then the inverse column
    FFTs, the real part scaled by 1/n^2.  The staged design keeps only the
    window's columns after the row pass and writes only the window's rows:
    every other entry is NaN here."""
    n = f1.shape[-1]
    pm = _perm(n)
    buf = np.zeros((n, n), np.complex64)
    buf[np.ix_(pm, pm)] = _cross_power(f1, f2)
    buf = _fft(buf, inverse=True)  # rows, natural x out
    scale = np.float32(1.0 / (n * n))
    if not staged:
        return (_fft(buf.T, inverse=True).T.real * scale).astype(np.float32)
    win = _window(n, search_radius)
    u = buf[:, win]  # U: rows in perm order of ky, the window's columns
    cols = _fft(u.T, inverse=True).T  # natural y
    surf = np.full((n, n), np.nan, np.float32)
    surf[np.ix_(win, win)] = (cols[win].real * scale).astype(np.float32)
    return surf


def _model_peak(raw, search_radius, centroid_radius=CENTROID_RADIUS):
    """The peak over the window's raw rows and columns only: ties on the
    smallest fftshifted index, the masked entries as the one seed (0.0,
    index 0), NaN in the window gives NaN; the positive-only centroid."""
    n = raw.shape[0]
    h = n // 2
    win = _window(n, search_radius)
    vals = raw[np.ix_(win, win)]
    if np.isnan(vals).any():
        return np.array([np.nan, np.nan], np.float32), np.float32(np.nan)
    s = ((win[:, None] + h) % n) * n + (win[None, :] + h) % n
    best = vals.max()
    best_s = s[vals == best].min()
    if n // 2 > search_radius and (best < 0.0 or (best == 0.0 and best_s > 0)):
        best, best_s = np.float32(0.0), 0
    yc, xc = divmod(int(best_s), n)
    sw = swx = swy = np.float32(0.0)
    for sy in range(max(yc - centroid_radius, 0), min(yc + centroid_radius, n - 1) + 1):
        for sx in range(max(xc - centroid_radius, 0), min(xc + centroid_radius, n - 1) + 1):
            if abs(sy - h) > search_radius or abs(sx - h) > search_radius:
                continue
            v = raw[(sy - h) % n, (sx - h) % n]
            if v > 0.0:
                sw, swx, swy = sw + v, swx + v * np.float32(sx), swy + v * np.float32(sy)
    denom = sw + EPS
    return np.array([swx / denom - h, swy / denom - h], np.float32), np.float32(best)


def _model(curr, prev, search_radius=55):
    """Kernel E on [P, n, n] pairs by its route: (shift [P, 2], maxval [P])."""
    p, n = curr.shape[0], curr.shape[-1]
    f = _forward(curr, prev)
    staged = not cuda_kernels.pcff_small(n)
    out = [_model_peak(_model_surface(f[i], f[p + i], search_radius, staged), search_radius)
           for i in range(p)]
    return np.stack([o[0] for o in out]), np.array([o[1] for o in out])


def _pair(n, seed):
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 256, (n, n)).astype(np.float32)
    curr = np.roll(prev, (3 % n, -5 % n), axis=(0, 1))
    curr[: n // 4] = rng.integers(0, 256, (n // 4, n))  # not a pure circular shift
    return curr, prev


def _patches(n, p, seed):
    """[p, n, n] uint8 pairs: band-limited textures moved by sub-pixel shifts."""
    rng = np.random.default_rng(seed)
    curr, prev = [], []
    for _ in range(p):
        base = smooth_random_image(rng, n, cutoff=0.3).astype(np.float64)
        d = rng.uniform(-n / 6, n / 6, 2)
        prev.append(np.clip(np.rint(base), 0, 255).astype(np.uint8))
        curr.append(np.clip(np.rint(fourier_shift(base, d[0], d[1])), 0, 255).astype(np.uint8))
    return np.stack(curr), np.stack(prev)


def _jax(curr, prev, **kw):
    return to_numpy(phase_correlate_fused_pallas(jnp.asarray(curr), jnp.asarray(prev), **kw))


def _assert_agree(ours, theirs, shift_tol=SHIFT_TOL):
    (ts, tm), (js, jm) = ours, theirs
    np.testing.assert_array_equal(np.isnan(ts), np.isnan(js))
    np.testing.assert_allclose(ts, js, atol=shift_tol, rtol=0, equal_nan=True)
    np.testing.assert_allclose(tm, jm, rtol=MAXVAL_RTOL, atol=1e-7, equal_nan=True)


# --------------------------------------------------------------------------- #
# the forward products                                                         #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n", [15, 120, 171])
def test_fused_spectra_are_the_dft2_real_products(n):
    """G's blocks give _dft2_real's spectra at kx <= n/2 within float32
    rounding, the padding columns are zero, and the NumPy model's spectra
    (the other half by conjugate symmetry) are _dft2_real's everywhere."""
    rng = np.random.default_rng(n)
    curr, prev = (rng.integers(0, 256, (3, n, n)).astype(np.float32) for _ in range(2))
    x = torch.from_numpy(np.ascontiguousarray(np.concatenate([curr, prev]).transpose(1, 0, 2)))
    g = cuda_kernels._fused_spectra(x).numpy()
    h, nh = cuda_kernels.half_cols(n), n // 2 + 1
    assert h % 2 == 0 and nh <= h <= nh + 1 and g.shape == (2 * n, 6 * 2 * h)
    blocks = g.reshape(2, n, 6, 2, h)
    assert not blocks[..., nh:].any()
    fr, fi = (t.numpy() for t in _dft2_real(torch.from_numpy(np.concatenate([curr, prev]))))
    scale = np.abs(fr).max()
    np.testing.assert_allclose((blocks[0, :, :, 0] - blocks[1, :, :, 1]).transpose(1, 0, 2)[..., :nh],
                               fr[..., :nh], atol=2e-6 * scale, rtol=0)
    np.testing.assert_allclose((blocks[0, :, :, 1] + blocks[1, :, :, 0]).transpose(1, 0, 2)[..., :nh],
                               fi[..., :nh], atol=2e-6 * scale, rtol=0)
    f = _forward(curr, prev)
    np.testing.assert_allclose(f.real, fr, atol=2e-6 * scale, rtol=0)
    np.testing.assert_allclose(f.imag, fi, atol=2e-6 * scale, rtol=0)


# --------------------------------------------------------------------------- #
# the model against float64 and against JAX                                    #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n", SIZES)
def test_model_matches_float64_phase_correlation(n):
    """The window of the model's surface, by the route n takes, against a
    float64 FFT phase correlation: at most 7.6e-8 a surface entry at these
    sizes, held to 3e-7."""
    curr, prev = _pair(n, n)
    f = _forward(curr[None], prev[None])
    win = _window(n, 55)
    surf = _model_surface(f[0], f[1], 55, not cuda_kernels.pcff_small(n))
    np.testing.assert_allclose(surf[np.ix_(win, win)], _reference_surface(curr, prev)[np.ix_(win, win)],
                               atol=3e-7)


@pytest.mark.parametrize("n", [60, 171, 240])
def test_both_designs_agree(n):
    """The staged design's model on a size the one-block design takes, and
    the other way round: the same window, bit for bit (the same stages in the
    same order on each line)."""
    curr, prev = _pair(n, 2 * n)
    f = _forward(curr[None], prev[None])
    win = np.ix_(_window(n, 55), _window(n, 55))
    small, staged = (_model_surface(f[0], f[1], 55, s)[win] for s in (False, True))
    np.testing.assert_array_equal(small, staged)


@pytest.mark.parametrize("n", SIZES)
def test_model_matches_pallas(n):
    """Shifts and maxval of the model against the JAX kernel in interpret
    mode on uint8 pairs (the JAX function casts them to float32), shifts
    within MODEL_SHIFT_TOL; ``-s`` prints the difference at each n."""
    curr, prev = _patches(n, 1 if n >= 240 else 2, seed=n)
    ours, theirs = _model(curr.astype(np.float32), prev.astype(np.float32)), _jax(curr, prev)
    print(f"kernel E's model against the JAX kernel at n={n}: max|shift difference| "
          f"{np.abs(ours[0] - theirs[0]).max():.3g} px")
    _assert_agree(ours, theirs, MODEL_SHIFT_TOL)


@pytest.mark.parametrize("n", [15, 60, 120, 171, 240])
@pytest.mark.parametrize("zero", ["both", "curr", "prev"])
def test_model_gives_zero_patches_the_first_tie(n, zero):
    """A zero patch has exactly zero products, so R is exactly zero and the
    surface a plane of exact zeros: every entry a tie, the minimum shifted
    index wins, -(n//2) on both axes with maxval 0, as the JAX kernel gives."""
    img = _patches(n, 1, seed=7)[0].astype(np.float32)
    z = np.zeros_like(img)
    curr, prev = {"both": (z, z), "curr": (z, img), "prev": (img, z)}[zero]
    shift, maxval = _model(curr, prev)
    np.testing.assert_array_equal(shift, [[-(n // 2), -(n // 2)]])
    assert maxval[0] == 0.0
    _assert_agree((shift, maxval), _jax(curr, prev), MODEL_SHIFT_TOL)


@pytest.mark.parametrize("n", [45, 120, 171])
def test_model_propagates_nan(n):
    curr, prev = (x.astype(np.float32) for x in _patches(n, 2, seed=1))
    curr[1, n // 3, n // 2] = np.nan
    with np.errstate(invalid="ignore"):
        shift, maxval = _model(curr, prev)
    assert np.isfinite(shift[0]).all() and np.isnan(shift[1]).all() and np.isnan(maxval[1])
    _assert_agree((shift, maxval), _jax(curr, prev), MODEL_SHIFT_TOL)


@pytest.mark.parametrize("radius,expect", [(55, (10.0, 3.0)), (240, (70.0, 0.0))])
def test_model_masks_the_search_window(radius, expect):
    """At n = 480 (the staged design) a strong shift beyond the search
    radius and a weaker one within it: masked, the weak one wins."""
    base = smooth_random_image(np.random.default_rng(7), 480, cutoff=0.3).astype(np.float64)
    curr = (0.7 * fourier_shift(base, 70.0, 0.0) + 0.3 * fourier_shift(base, 10.0, 3.0))[None]
    curr, prev = curr.astype(np.float32), base[None].astype(np.float32)
    ours = _model(curr, prev, search_radius=radius)
    _assert_agree(ours, _jax(curr, prev, search_radius=radius), MODEL_SHIFT_TOL)
    np.testing.assert_allclose(ours[0][0], expect, atol=0.05)


# --------------------------------------------------------------------------- #
# the source's constants                                                       #
# --------------------------------------------------------------------------- #


def _c_body(name):
    """The body of a function defined in kernel E's source."""
    start = CU.index("{", re.search(rf"^(?!//)\S.* {name}\(", CU, re.M).end())
    depth = 0
    for i in range(start, len(CU)):
        depth += {"{": 1, "}": -1}.get(CU[i], 0)
        if depth == 0:
            return CU[start + 1:i]
    raise AssertionError(name)


def _c_value(name, n):
    """The `return` expression of one of the source's size functions at n,
    with its helpers' rules in Python."""
    expr = re.findall(r"return ([^;]+);", _c_body(name))[-1]
    expr = re.sub(r"(\d+)LL", r"\1", expr).replace("std::max", "max").replace("/", "//")  # int division
    helpers = {"row_lines": lambda n: cuda_kernels._pass_lines(8 * n + 4, cuda_kernels.PCFF_LINES),
               "col_band": lambda n: cuda_kernels._pass_lines(8 * n, cuda_kernels.PCFF_BAND)}
    return eval(expr, helpers, {"n": n})


def test_route_and_resources_match_the_source():
    assert all(_c_value("half_cols", n) == cuda_kernels.half_cols(n) for n in range(1, 481))
    assert "fft::small_route(n)" in _c_body("pcfu_smem_bytes")  # kernel D's route rule
    assert re.search(rf"constexpr int kSmallMaxW = {cuda_kernels.PCFF_MAX_SMALL};", STAGES)
    for n in range(1, 481):
        small = cuda_kernels.pcff_small(n)
        smem = cuda_kernels.pcfu_smem_bytes(n)
        assert smem == _c_value("small_smem" if small else "large_smem", n)
        assert smem + cuda_kernels.PCFF_STATIC_RESERVE <= cuda_kernels.H100_SMEM_OPTIN_BYTES
        scratch = cuda_kernels.pcfu_scratch_bytes(n)
        assert scratch == (0 if small else _c_value("pcfu_scratch_bytes", n))
    # the one-block design's static shared memory: the perm table and
    # block_argmax's three words for each of 32 warps
    assert 2 * cuda_kernels.PCFF_MAX_SMALL + 3 * 4 * 32 <= cuda_kernels.PCFF_STATIC_RESERVE


def test_launches_a_chunk():
    """One launch a chunk on the one-block route, three on the staged route
    (two passes and kernel B's split peak); no direct DFT is left."""
    assert _c_body("launch_small").count("<<<") == 1
    staged = _c_body("run_large")
    assert staged.count("<<<") == 2 and staged.count("peak::launch_split(") == 1
    assert "dft_stages" not in CU and not (CSRC / "dft_stages.cuh").exists()


#: bytes of the staged layout's element types
C_SIZES = {"float2": 8, "float": 4, "int": 4, "unsigned": 4}


def _layout_offsets(c, n):
    """Byte offset and element type of each array of the staged design's
    scratch for a chunk of c pairs of side n, by the assignments of the
    source's ``layout`` in their order (each array starts where the one it
    names ends), and the end of the last one."""
    fields = re.search(r"struct Layout \{(.*?)\};", CU, re.S).group(1)
    types = {f: t for t, f in re.findall(r"^\s+(\w+)\* (\w+);", fields, re.M)}
    offsets, last = {}, None
    for field, rhs in re.findall(r"l\.(\w+) = ([^;]+);", _c_body("layout")):
        if field not in types:
            continue
        inner = re.sub(r"^\w+_cast<\w+\*>\((.*)\)$", r"\1", rhs)
        if inner == "scratch":
            offsets[field] = 0
        else:
            base, count = re.fullmatch(r"l\.(\w+) \+ (.+)", inner).groups()
            count = eval(count.replace("static_cast<size_t>(c)", "c"), {}, {"c": c, "n": n, "mat": n * n})
            offsets[field] = offsets[base] + C_SIZES[types[base]] * count
        last = field
    end = offsets[last] + C_SIZES[types[last]] * c  # c counters
    return {f: (offsets[f], types[f]) for f in offsets}, end


@pytest.mark.parametrize("n", [171, 175, 240, 480])
@pytest.mark.parametrize("c", [1, 3, 95])
def test_staged_scratch_is_aligned(n, c):
    """Every array of the staged scratch starts aligned to its type for any
    chunk c and side n (odd c with odd n included), each surface 16-byte
    aligned where the split peak reads float4 (n % 4 == 0), and the arrays
    fill c * pcfu_scratch_bytes(n) exactly."""
    offsets, end = _layout_offsets(c, n)
    assert list(offsets) == ["u", "surf", "part_val", "part_idx", "part_nan", "counters"]
    for field, (off, t) in offsets.items():
        assert off % C_SIZES[t] == 0, (field, off)
    if n % 4 == 0:
        assert all((offsets["surf"][0] + 4 * n * n * i) % 16 == 0 for i in range(c))
    assert end == c * cuda_kernels.pcfu_scratch_bytes(n)


def test_chunks_stay_within_the_scratch():
    for n in (171, 240, 480):
        pair = cuda_kernels.pcfu_scratch_bytes(n)
        chunk = cuda_kernels._chunk(4096, pair)
        assert chunk * pair <= cuda_kernels.CHUNK_SCRATCH_BYTES
    assert cuda_kernels._chunk(4096, cuda_kernels.pcfu_scratch_bytes(480)) == 12


#: (p, n, operations, bytes, bound ms, bound by) of kernel E's rows in
#: PERF.md, float32 patches
KERNEL_E_WORK = [
    (16, 120, 25.2757e6, 1_843_392, 0.000550, "bytes"),
    (4, 240, 28.7202e6, 1_843_248, 0.000550, "bytes"),
    (1, 480, 32.1704e6, 1_843_212, 0.000550, "bytes"),
]


@pytest.mark.parametrize("p,n,ops,nbytes,ms,by", KERNEL_E_WORK)
def test_kernel_e_work_and_bound(p, n, ops, nbytes, ms, by):
    got_ops, got_bytes = chip_smoke.WORK["phase_correlate_fused"](p=p, n=n, itemsize=4)
    assert got_ops == pytest.approx(ops, rel=5e-4) and got_bytes == nbytes
    got_ms, got_by = chip_smoke.bound("phase_correlate_fused", p=p, n=n, itemsize=4)
    assert got_ms == pytest.approx(ms, rel=3e-3) and got_by == by


# --------------------------------------------------------------------------- #
# repair F8: any real dtype, as the JAX function                               #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n", [45, 120])
def test_uint8_patches_match_pallas(n):
    """uint8 patches straight into the port's entry point and the JAX one."""
    curr, prev = _patches(n, 3, seed=20 + n)
    ours = to_numpy(phase_correlate_fused(torch.from_numpy(curr), torch.from_numpy(prev)))
    _assert_agree(ours, _jax(curr, prev))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float64, torch.float16])
def test_any_real_dtype_gives_the_float32_result(dtype):
    curr, prev = (torch.from_numpy(x) for x in _patches(60, 2, seed=3))
    want = phase_correlate_fused(curr.float(), prev.float())
    got = phase_correlate_fused(curr.to(dtype), prev.to(dtype))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
