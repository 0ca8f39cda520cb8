"""The port's tuning, profiling and accuracy scripts on the CPU, and what
they rest on: ``accuracy_report_torch.py`` against the JAX package's XLA
path on the same pairs, each script's ``main`` at a tiny size with its
documented keys, ``cuda_kernels.build(defines=...)``'s ``nvcc`` argv and
variant library, kernel C's geometry at a variant's tile against a model of
its tiling and against the source's own rule, the sources' ``#ifndef``
defaults, the grayscale weights built once (repair F12) and node frames
that read no scalar back (repair F13).  The variants
themselves build and run only on the card (``chip_smoke.py`` phase 18).

Tolerance: the port's routes against the JAX XLA path within 1e-4 px in
each error (float32 sums in another order; both sit about 1e-5 px from the
float64 oracle).
"""

import json
import pathlib
import re

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (pins torch to one thread)

import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode
from mrs_optic_flow_tpu.models import FftMethod as JaxFftMethod
from mrs_optic_flow_tpu.models import FftMethodConfig as JaxFftMethodConfig
from mrs_optic_flow_tpu_torch.ops import cuda_kernels as ck
from mrs_optic_flow_tpu_torch.ops import preprocess
from mrs_optic_flow_tpu_torch.utils import benchlib
from scripts import accuracy_report_torch as acc
from scripts import profile_geometry_torch as pg
from scripts import profile_staging_torch as pst
from scripts import tune_frames_kernel_torch as tf
from scripts import tune_sad_kernel_torch as ts
from scripts import tune_scale_rotation_torch as tsr
from scripts import verify_sr_fused_torch as vsr

ACC_TOL = 1e-4  # px
ACC_PAIRS, ACC_SIZE = 4, 120


@pytest.fixture(scope="module")
def accuracy_rows():
    rows = []
    assert acc.run(acc.parse_args(["--device", "cpu", "--pairs", str(ACC_PAIRS), "--size", str(ACC_SIZE)]),
                   rows.append)
    return {r["route"]: r for r in rows}


@pytest.fixture(scope="module")
def jax_errors():
    """The JAX package's report on the same pairs, on its XLA path, per
    window size: max and mean |error| against the truth, max against the
    oracle."""
    out = {}
    for size, patch in acc.geometries(ACC_SIZE).values():
        prev, curr, truth, oracle = acc.accuracy_pairs(ACC_PAIRS, size, patch)
        eng = JaxFftMethod(JaxFftMethodConfig(frame_size=size, sample_point_size=patch,
                                              use_pallas=False, backend="dft"))
        shifts = np.asarray(eng.step_batch(jnp.asarray(prev), jnp.asarray(curr)).shifts_raw)
        out[patch] = acc.errors(shifts, truth, oracle)
    return out


ROUTES = ["A", "A twin", "E", "E twin", "fft", "fft twin", "D patch 60", "D patch 60 twin",
          "D patch 97", "D patch 97 twin"]


@pytest.mark.parametrize("route", ROUTES)
def test_accuracy_report_equals_jax(accuracy_rows, jax_errors, route):
    ours, theirs = accuracy_rows[route], jax_errors[accuracy_rows[route]["patch"]]
    for key in ("max_vs_truth_px", "mean_vs_truth_px", "max_vs_oracle_px"):
        assert abs(ours[key] - theirs[key]) <= ACC_TOL, (key, ours[key], theirs[key])
    assert ours["nan_windows"] == theirs["nan_windows"] == 0


def test_accuracy_summary_and_oracle_rows(accuracy_rows):
    summary = accuracy_rows["summary"]
    assert summary["ok"] and summary["kernels_max_vs_oracle_px"] <= acc.KERNEL_TOL_PX
    assert summary["conformance_max_px"] <= 0.05 and len(summary["conformance"]) == 10
    for patch in (120, 60, 97):
        assert accuracy_rows[f"oracle {patch}"]["max_vs_oracle_px"] == 0.0


def _lines(capsys) -> list:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


#: script, argv at a tiny size on the CPU, the keys every line carries
MAINS = {
    "tune_frames": (tf, ["--size", "240", "--batches", "1,2", "--iters", "2"],
                    ("metric", "threads", "batch", "max_err_twin_px", "max_err_oracle_px", "agrees",
                     "bit_equal", "ms", "own_ms", "frame_pairs_per_s", "rate_min", "rate_max",
                     "window_rates", "bound_ms", "bound_by", "bound_share", "library_ms", "card")),
    "tune_sad": (ts, ["--size", "240", "--k", "2", "--reps", "1", "--engines", "block_method",
                      "--tiles", "2x11x8,2x8x8"],
                 ("metric", "card")),
    "tune_scale_rotation": (tsr, ["--size", "64", "--k", "2", "--reps", "1", "--streams", "1,2",
                                  "--configs", "lanczos4_480,bilinear_480"],
                            ("metric", "step", "batch_carried", "ignored", "lp_resolution", "card")),
    "profile_geometry": (pg, ["--reps", "1"],
                         ("metric", "ransac_iterations", "batch", "ops", "bytes", "bytes_materialized",
                          "bound_ms", "bound_by", "bound_materialized_ms", "wall_ms", "device_ms",
                          "kernels", "idle_share", "ok_share", "card")),
    "profile_staging": (pst, ["--streams", "4", "--batch", "6", "--reps", "2", "--workers", "1,3"],
                        ("metric", "workers", "bytes", "ms", "runs_ms", "gbps", "cpus", "pool_workers", "card")),
    "accuracy_report": (acc, ["--pairs", "2", "--size", "120"],
                        ("metric", "route", "card")),
    "verify_sr_fused": (vsr, ["--frames", "3", "--k", "2", "--reps", "1"],
                        ("metric", "ok", "card")),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_script_main_on_the_cpu(name, capsys, monkeypatch):
    module, argv, keys = MAINS[name]
    monkeypatch.setenv("SWEEP", "4,8")
    monkeypatch.setenv("BATCH", "6")
    assert module.main(argv + ["--device", "cpu"]) == 0
    lines = _lines(capsys)
    assert lines
    for line in lines:
        missing = [k for k in keys if k not in line]
        assert not missing, (missing, line)
        assert line["card"] == "cpu"


def test_tune_sad_lines(capsys):
    assert ts.main(["--size", "240", "--k", "2", "--reps", "1", "--engines", "block_method",
                    "--tiles", "2x11x8,1x11x8", "--device", "cpu"]) == 0
    engine, *tiles = _lines(capsys)
    for route in ("kernel", "plain"):
        assert {"wall_ms_per_frame", "slope_ok", "device_ms_per_frame", "kernels_per_frame"} <= set(engine[route])
        assert engine[route]["device_ms_per_frame"] is None  # no device time on the CPU
    assert engine["library"]["route"] == "torch.cdist(p=1)" and engine["library"]["max_rel_diff"] <= 1e-6
    assert [t["tile"] for t in tiles] == [[2, 11, 8], [1, 11, 8]]
    assert tiles[0]["shipped"] and not tiles[1]["shipped"]
    for t in tiles:
        assert t["built"] is False and "CPU run" in t["reason"]
        assert t["geometry"] == ck.sad_geometry(9, 120, 21, tuple(t["tile"]))._asdict()


def test_tune_scale_rotation_lines(capsys):
    assert tsr.main(["--size", "64", "--k", "2", "--reps", "1", "--streams", "1,3",
                     "--configs", "lanczos4_lp256", "--device", "cpu"]) == 0
    (line,) = _lines(capsys)
    assert line["lp_resolution"] == 256 and "not read by the port" in line["ignored"]
    assert [b["streams"] for b in line["batch_carried"]] == [1, 3]
    assert all(b["device_ms"] is None and b["wall_ms"] > 0 for b in line["batch_carried"])


@pytest.mark.parametrize("iterations,p,b", [(64, 16, 4096), (256, 16, 4096), (512, 16, 1), (8, 9, 3)])
def test_geometry_work(iterations, p, b):
    """The geometry's bound, reckoned from the code's tensors: the draws and
    shifts in, the outputs out, the [I, P, B] residuals and [I, 9, B]
    hypotheses each written and read once in the materialised count."""
    w = pg.geometry_work(iterations, p, b)
    assert w["ops"] == (iterations * p * b * pg.OPS_PER_RESIDUAL + iterations * b * pg.OPS_PER_HYPOTHESIS
                        + b * pg.OPS_PER_PAIR_REFIT)
    assert w["bytes"] == 4 * iterations * p * b + 8 * p * b + 24 * b + 48 * b
    assert w["bytes_materialized"] - w["bytes"] == 8 * iterations * b * (p + 9)


def test_geometry_bound_at_the_bench_point():
    """At B = 4096 and 256 hypotheses the Gumbel draws' 67 MB bound it:
    0.020 ms at 3.35 TB/s, above the operations' 0.011 ms."""
    w = pg.geometry_work(256, 16, 4096)
    assert w["bytes"] == pytest.approx(67.4e6, rel=1e-2)
    ms, by = benchlib.bound_of(w["ops"], w["bytes"])
    assert by == "bytes" and ms == pytest.approx(0.0201, rel=1e-2)


class _FakePopen:
    """Records the argv and writes the library where ``-o`` points."""

    argvs: list = []

    def __init__(self, argv, **kw):
        self.argv = argv
        _FakePopen.argvs.append(argv)
        pathlib.Path(argv[argv.index("-o") + 1]).write_bytes(b"lib")
        self.returncode = 0

    def communicate(self):
        return "ptxas info: Used 40 registers", None


@pytest.fixture
def fake_nvcc(monkeypatch, tmp_path):
    _FakePopen.argvs = []
    monkeypatch.setattr(ck, "_nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(ck.subprocess, "Popen", _FakePopen)
    monkeypatch.setattr(ck, "BUILD_DIR", tmp_path)
    return tmp_path


@pytest.mark.parametrize("name,defines,suffix", [
    ("phase_correlate_frames", {"PCF_THREADS": 128}, "PCF_THREADS128"),
    ("sad_search", {"SAD_WARPS": 4, "SAD_TI": 1, "SAD_TJ": 11}, "SAD_TI1_SAD_TJ11_SAD_WARPS4"),
])
def test_build_with_defines(fake_nvcc, name, defines, suffix):
    logs = ck.build([name], defines=defines)
    (argv,) = _FakePopen.argvs
    out = fake_nvcc / f"lib{name}_{suffix}.so"
    assert ck.variant_path(name, defines) == out and out.read_bytes() == b"lib"
    flags = [f"-D{k}={v}" for k, v in sorted(defines.items())]
    assert argv[:len(ck.NVCC_FLAGS) + 1] == ["/cuda/bin/nvcc", *ck.NVCC_FLAGS]
    assert argv[len(ck.NVCC_FLAGS) + 1:] == [*flags, "-o", argv[-2], str(ck.CSRC / ck.SOURCES[name])]
    assert argv[-2].startswith(str(out.with_suffix(""))) and argv[-2].endswith(".tmp")
    assert not ck.library_path(name).exists()  # the shipped library is not touched
    assert logs == {name: "ptxas info: Used 40 registers"}


def test_build_without_defines_is_the_shipped_build(fake_nvcc):
    ck.build(["sad_search", "phase_correlate_frames"])
    assert [a[len(ck.NVCC_FLAGS) + 1] for a in _FakePopen.argvs] == ["-o", "-o"]
    assert ck.library_path("sad_search").exists() and ck.library_path("phase_correlate_frames").exists()


def test_started_builds_finish_later(fake_nvcc):
    jobs = tf.start_builds([128, 512])
    assert set(jobs) == {128, 512} and len(_FakePopen.argvs) == 2
    assert ck.finish_variants(jobs) == {t: {"log": "ptxas info: Used 40 registers"} for t in (128, 512)}
    for t in jobs:
        assert ck.variant_path("phase_correlate_frames", {"PCF_THREADS": t}).exists()


def test_a_failed_variant_leaves_the_others(fake_nvcc, monkeypatch):
    """A variant that does not build is reported as such; the others stay
    usable (the tuning scripts print a line for it and time the rest)."""

    class _Failing(_FakePopen):
        def __init__(self, argv, **kw):
            super().__init__(argv, **kw)
            self.returncode = 2 if "-DSAD_TI=4" in argv else 0

        def communicate(self):
            return ("error: static assertion failed" if self.returncode else "ok"), None

    monkeypatch.setattr(ck.subprocess, "Popen", _Failing)
    got = ck.finish_variants(ts.start_builds([(2, 11, 8), (4, 11, 8)]))
    assert got[(2, 11, 8)] == {"log": "ok"}
    assert "nvcc failed (2)" in got[(4, 11, 8)]["error"] and "static assertion" in got[(4, 11, 8)]["error"]


SAD_CU = (ck.CSRC / ck.SOURCES["sad_search"]).read_text()
PCF_CU = (ck.CSRC / ck.SOURCES["phase_correlate_frames"]).read_text()


def _defaults(text: str) -> dict:
    """``#ifndef X`` / ``#define X value``: each macro's default."""
    return {k: int(v) for k, v in re.findall(r"#ifndef (\w+)\n#define \1 (\d+)\n#endif", text)}


def test_sources_keep_todays_values_as_defaults():
    """The constants lifted under ``#ifndef`` default to the shipped values,
    and the kernels read them from the macros."""
    assert _defaults(PCF_CU) == {"PCF_THREADS": 256}
    assert "constexpr int kThreads = PCF_THREADS;" in PCF_CU
    assert _defaults(SAD_CU) == dict(zip(("SAD_TI", "SAD_TJ", "SAD_WARPS"), ck.SAD_TILE))
    assert ck.SAD_TILE == (ck.SAD_TI, ck.SAD_TJ, ck.SAD_WARPS) == (2, 11, 8)
    for k, macro in (("kTI", "SAD_TI"), ("kTJ", "SAD_TJ"), ("kWarps", "SAD_WARPS")):
        assert re.search(rf"constexpr int {k} = {macro};", SAD_CU)
    # a lane sums each of a warp's shifts: a tile of more than 32 does not build
    assert "static_assert(kTT <= 32" in SAD_CU


def _source_rule(tile):
    """The source's ``make_geometry`` tile rule and ``smem_bytes`` formula
    evaluated with a variant's constants."""
    ti, tj, warps = tile
    names = {"kTI": ti, "kTJ": tj, "kWarps": warps, "kTT": ti * tj, "kRows": 32, "odd": lambda n: n | 1,
             "max": max, "min": min}
    smem = re.search(r"long long smem_bytes\(int xb, int ni, int nj\) \{\s*return (.*?);\s*\}", SAD_CU, re.S)
    smem_expr = smem.group(1).replace("4LL", "4").replace("imax", "max")
    nj_rule = re.search(r"q\.nj = (.*?);", SAD_CU).group(1).replace("imin", "min")
    ni_rule = re.search(r"q\.ni = (.*?);", SAD_CU).group(1).replace("imin", "min").replace("q.nj", "nj")
    ni_rule = ni_rule.replace("/", "//")

    def tiles(r):
        d = 2 * r + 1
        scope = dict(names, n_dit=-(-d // ti), n_djt=-(-d // tj))
        nj = eval(nj_rule, {}, scope)
        return eval(ni_rule, {}, dict(scope, nj=nj)), nj

    return tiles, lambda xb, ni, nj: eval(smem_expr, {}, dict(names, xb=xb, ni=ni, nj=nj))


TILES = [(2, 11, 8), (1, 11, 8), (2, 8, 8), (4, 8, 8), (2, 16, 8), (2, 11, 4), (2, 11, 16), (3, 5, 2)]


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("g,s,r", [(9, 120, 21), (1, 120, 21), (4, 240, 21), (9, 8, 3), (2, 120, 0)])
def test_sad_geometry_of_a_variant(tile, g, s, r):
    """``sad_geometry(..., tile)`` against a model of the tiling: the
    blocks' shift tiles cover every shift of every cell once, the row groups
    and bands every block row and column once, within the block's warps;
    tiles and shared memory as the source's own rule gives them for these
    constants."""
    ti, tj, warps = tile
    geo = ck.sad_geometry(g, s, r, tile)
    d = 2 * r + 1
    src_tiles, src_smem = _source_rule(tile)
    assert (geo.ni, geo.nj) == src_tiles(r)
    assert geo.smem == src_smem(geo.xb, geo.ni, geo.nj)
    assert geo.ni * geo.nj <= warps and geo.threads == 32 * geo.ni * geo.nj
    covered = np.zeros((d, d), int)
    for dib in range(geo.n_dib):
        for djb in range(geo.n_djb):
            for wi in range(geo.ni):
                for wj in range(geo.nj):
                    i0, j0 = (dib * geo.ni + wi) * ti, (djb * geo.nj + wj) * tj
                    covered[i0:i0 + ti, j0:j0 + tj] += 1
    assert (covered == 1).all()
    assert geo.n_rg * 32 >= s > (geo.n_rg - 1) * 32
    assert geo.n_xb * geo.xb >= s > (geo.n_xb - 1) * geo.xb and geo.xb <= ck.SAD_MAX_BAND
    assert geo.blocks == g * geo.n_dib * geo.n_djb * geo.parts and geo.counters == g * geo.n_dib * geo.n_djb
    assert geo.scratch == geo.blocks * geo.ni * ti * geo.nj * tj
    if tile == ck.SAD_TILE:
        assert geo == ck.sad_geometry(g, s, r)


def test_variant_launchers_refuse_the_cpu():
    """The launchers of a variant library run on the card only: no twin
    behind them."""
    x = torch.zeros((1, 120, 120), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA device"):
        ck.launch_phase_correlate_frames(None, x, x, patch=120)
    b, reg = torch.zeros((1, 8, 8)), torch.zeros((1, 14, 14))
    with pytest.raises(ValueError, match="CUDA device"):
        ck.launch_sad_search(None, b, reg, block_size=8, scan_radius=3)


def test_grayscale_weights_are_built_once(monkeypatch):
    """Repair F12: ``to_grayscale`` built its weights from a Python list on
    the frame's device at every call, an upload from host memory that
    synchronises the host with the card once a frame; now once a device."""
    preprocess._gray_weights.cache_clear()
    made = []
    real = torch.tensor
    monkeypatch.setattr(torch, "tensor", lambda *a, **k: made.append(a) or real(*a, **k))
    img = torch.arange(2 * 3 * 3, dtype=torch.float32).reshape(2, 3, 3)
    first = preprocess.to_grayscale(img)
    for _ in range(3):
        assert torch.equal(preprocess.to_grayscale(img), first)
    assert len(made) == 1
    expected = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    torch.testing.assert_close(first, expected, rtol=1e-6, atol=1e-5)
    swapped = preprocess.to_grayscale(img, swap_rb=False)
    torch.testing.assert_close(swapped, img[..., 0] * 0.114 + img[..., 1] * 0.587 + img[..., 2] * 0.299,
                               rtol=1e-6, atol=1e-5)
    assert len(made) == 2


class _ScalarReads(TorchDispatchMode):
    """Counts the reads of a tensor's value back to the host
    (``aten::_local_scalar_dense``: ``.item()``, ``int()``, and an index by
    a 0-dim tensor)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func is torch.ops.aten._local_scalar_dense.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("fields", [{"method": 3}, {"method": 5}, {"scale_rotation": True},
                                    {"long_range_mode": "always_on"}])
def test_node_frames_read_no_scalar_back(fields):
    """Repair F13: a node frame reads its result back once, as one array,
    and no scalar on the way (methods 3 and 5 read 4 and 2 scalars a frame
    on the card: the best probe of the sub-pixel refine and allsac's best
    pair, each an index by a 0-dim tensor).  ``chip_smoke.py`` phase 18
    counts the device-to-host copies on the card."""
    import chip_smoke as cs

    from mrs_optic_flow_tpu_torch.config import NodeConfig

    published = []
    node = cs.level_node(torch.device("cpu"), NodeConfig(**fields), published)
    reads = _ScalarReads()
    with reads:
        cs.feed_node(node, cs.render_frames(3))
    assert reads.count == 0
    assert len([m for t, m in published if t.startswith("velocity_out")]) >= 2
