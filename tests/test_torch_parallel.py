"""Batch sharding of the port (``make_mesh``, ``shard_batch``,
``sharded_flow_step``, ``BatchPipeline(mesh=...)``, and the fleet and
serving loop over it) on the CPU, mirroring every test of
``tests/test_parallel.py``.  The port's mesh is ``make_mesh(8,
device="cpu")``: eight shards of the CPU, the counterpart of the JAX
tests' eight virtual host devices, on which the JAX side runs.

Each test holds the port's sharded run against its unsharded run with the
same generator (``ok`` and ``n_inliers`` equal, shifts within 1e-5 px NaN
for NaN, ``tran`` within 5e-3 m/s, decodes within 1e-5), and the port
against the JAX package under its mesh with the JAX draws injected (``ok``
equal, shifts within 1e-3 px, ``tran`` within 1e-3 m/s and decodes within
1e-3: ``tests/test_torch_pipeline.py``'s float32 tolerances, whose reasons
it gives).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch
from oracle import smooth_random_image
from torch_parity import jax_key_draws, to_numpy

from mrs_optic_flow_tpu.models import FftMethod as JaxFftMethod
from mrs_optic_flow_tpu.models import FftMethodConfig as JaxFftConfig
from mrs_optic_flow_tpu.models import ScaleRotationConfig as JSRConfig
from mrs_optic_flow_tpu.models import ScaleRotationEstimator as JSR
from mrs_optic_flow_tpu.parallel import BatchPipeline as JaxPipeline
from mrs_optic_flow_tpu.parallel import make_mesh as jax_make_mesh
from mrs_optic_flow_tpu.parallel import shard_batch as jax_shard_batch
from mrs_optic_flow_tpu.parallel import sharded_flow_step as jax_sharded_flow_step
from mrs_optic_flow_tpu.runtime import FleetServer as JaxFleet
from mrs_optic_flow_tpu.runtime.serving import ServingLoop as JaxLoop
from mrs_optic_flow_tpu.runtime.serving import ServingRequest as JaxRequest
from mrs_optic_flow_tpu_torch.geometry.batched import get_rt_batch
from mrs_optic_flow_tpu_torch.geometry.motion import get_2dt
from mrs_optic_flow_tpu_torch.models import (
    FftMethod,
    FftMethodConfig,
    ScaleRotationConfig,
    ScaleRotationEstimator,
)
from mrs_optic_flow_tpu_torch.parallel import (
    BatchPipeline,
    Mesh,
    Sharded,
    make_mesh,
    shard_batch,
    sharded_flow_step,
)
from mrs_optic_flow_tpu_torch.runtime import FleetServer
from mrs_optic_flow_tpu_torch.runtime.serving import ServingLoop, ServingRequest

needs_jax_mesh = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

K = np.array([[40.0, 0, 32.0], [0, 40.0, 24.0], [0, 0, 1.0]], np.float32)
#: sharded against unsharded, in the port
SHARD_SHIFT_TOL = 1e-5  # px
SHARD_TRAN_TOL = 5e-3  # m/s
SHARD_DECODE_TOL = 1e-5
#: the port against the JAX package (tests/test_torch_pipeline.py)
SHIFT_TOL = 1e-3  # px
TRAN_TOL = 1e-3  # m/s
DECODE_TOL = 1e-3


def _np(x):
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol):
    a, b = _np(a), _np(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, atol=tol, rtol=0, equal_nan=True)


def _assert_sharded_equal(a, b):
    """Two port ``PipelineOutput``s, sharded against unsharded."""
    np.testing.assert_array_equal(_np(a.ok), _np(b.ok))
    _close(a.shifts, b.shifts, SHARD_SHIFT_TOL)
    _close(a.tran, b.tran, SHARD_TRAN_TOL)
    _close(a.rot, b.rot, SHARD_TRAN_TOL)
    _close(a.scale, b.scale, SHARD_DECODE_TOL)
    _close(a.rotation, b.rotation, SHARD_DECODE_TOL)
    np.testing.assert_allclose(float(a.fleet_mean_speed), float(b.fleet_mean_speed), rtol=1e-6)


def _assert_matches_jax(t, j, sr=False):
    np.testing.assert_array_equal(_np(t.ok), _np(j.ok))
    _close(t.shifts, j.shifts, SHIFT_TOL)
    _close(t.tran, j.tran, TRAN_TOL)
    np.testing.assert_allclose(float(t.fleet_mean_speed), float(j.fleet_mean_speed), rtol=1e-5)
    if sr:
        _close(t.scale, j.scale, DECODE_TOL)
        _close(t.rotation, j.rotation, DECODE_TOL)


def _ctx(b, height=2.0, dt=0.05):
    return (np.full(b, height, np.float32), np.full(b, dt, np.float32),
            np.tile(np.array([0, 0, 0, 1], np.float32), (b, 1)), np.array([0, 0, 0, 1], np.float32))


def _jax_draws(b, iterations, p, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    return keys, torch.from_numpy(np.array(jax.random.gumbel(keys[0], (iterations, p, b))))


# --------------------------------------------------------------------------- #
# the mesh                                                                    #
# --------------------------------------------------------------------------- #


@needs_jax_mesh
def test_make_mesh():
    mesh = make_mesh(8, device="cpu")
    assert mesh.devices.shape == (8,) == jax_make_mesh(8).devices.shape
    assert mesh.axis_names == ("data",) == jax_make_mesh(8).axis_names
    assert make_mesh(4, device="cpu").devices.shape == (4,)
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert make_mesh(device="cpu").size == 1
    assert make_mesh(2, "batch", device="cpu").axis_names == ("batch",)
    assert isinstance(mesh, Mesh) and mesh.first == torch.device("cpu")


def test_make_mesh_on_cuda_without_a_card_raises(monkeypatch):
    """A bare ``"cuda"`` takes cards only, and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="0 CUDA device"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="0 CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2, device="cuda:0")


def test_make_mesh_takes_the_first_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [str(d) for d in make_mesh(2).devices] == ["cuda:0", "cuda:1"]
    assert make_mesh().size == 4
    with pytest.raises(RuntimeError, match="4 CUDA device"):
        make_mesh(5)


def test_shard_batch_splits_evenly_and_raises_otherwise():
    mesh = make_mesh(4, device="cpu")
    x = torch.arange(8 * 3).reshape(8, 3)
    s = shard_batch(x.numpy(), mesh)
    assert isinstance(s, Sharded) and len(s.shards) == 4 and s.shape == (8, 3)
    for i, part in enumerate(s.shards):
        np.testing.assert_array_equal(to_numpy(part), to_numpy(x[2 * i:2 * i + 2]))
    np.testing.assert_array_equal(to_numpy(s.gather()), to_numpy(x))
    with pytest.raises(ValueError, match="does not split evenly"):
        shard_batch(torch.zeros(10, 4, 4), make_mesh(8, device="cpu"))
    with pytest.raises(ValueError, match="sharded over"):
        BatchPipeline(frame_size=48, sample_point_size=12, camera_matrix=K,
                      dist_coeffs=np.zeros(5, np.float32), ransac_iterations=8, device="cpu",
                      mesh=make_mesh(2, device="cpu")).step_pre(
            s, s, *_ctx(8))
    with pytest.raises(ValueError, match="mesh"):
        BatchPipeline(frame_size=48, sample_point_size=12, camera_matrix=K,
                      dist_coeffs=np.zeros(5, np.float32), device="cuda", mesh=mesh)


# --------------------------------------------------------------------------- #
# sharded_flow_step                                                            #
# --------------------------------------------------------------------------- #


def _rolled_pairs(rng, b, size, shift=(1, 2)):
    prev = np.stack([smooth_random_image(rng, size, cutoff=0.45) for _ in range(b)]).astype(np.float32)
    curr = np.stack([np.roll(prev[i], shift, axis=(0, 1)) for i in range(b)])
    return prev, curr


@needs_jax_mesh
def test_sharded_flow_step(rng):
    """``tests/test_parallel.py::test_sharded_flow_step`` on the port, and
    against the unsharded engine and the JAX step under its mesh."""
    mesh = make_mesh(8, device="cpu")
    cfg = dict(frame_size=48, sample_point_size=12, use_pallas=False, backend="fft")
    eng = FftMethod(FftMethodConfig(**cfg), device="cpu")
    step = sharded_flow_step(eng, mesh)
    b = 16
    prev, curr = _rolled_pairs(rng, b, 48)
    shifts, fleet_mean = step(shard_batch(prev, mesh), shard_batch(curr, mesh))
    assert shifts.shape == (b, 16, 2) and shifts.device == mesh.first
    assert 0.0 < float(fleet_mean) < 10.0
    s = to_numpy(shifts)
    assert np.abs(np.nanmedian(s - np.array([2.0, 1.0]), axis=(0, 1))).max() < 0.3
    # plain inputs are scattered the same way; sharded == unsharded
    plain_shifts, plain_mean = step(torch.from_numpy(prev), torch.from_numpy(curr))
    ref = eng.step_batch(torch.from_numpy(prev), torch.from_numpy(curr))
    for out in (shifts, plain_shifts):
        _close(out, ref.shifts, SHARD_SHIFT_TOL)
    speed = torch.linalg.norm(ref.shifts_raw, dim=-1).mean()
    np.testing.assert_allclose([float(fleet_mean), float(plain_mean)], float(speed), rtol=1e-6)
    jmesh = jax_make_mesh(8)
    jstep = jax_sharded_flow_step(JaxFftMethod(JaxFftConfig(**cfg)), jmesh)
    jshifts, jmean = jstep(jax_shard_batch(jnp.asarray(prev), jmesh), jax_shard_batch(jnp.asarray(curr), jmesh))
    _close(shifts, jshifts, SHIFT_TOL)
    np.testing.assert_allclose(float(fleet_mean), float(jmean), rtol=1e-5)


def test_sharded_flow_step_kernel_a_route_and_nan(rng):
    """Kernel A's route (its twin here): each shard's step equals the whole
    batch's, a NaN pair gives NaN shifts in its shard, and the fleet mean
    is NaN with it, as ``jnp.mean`` is."""
    mesh = make_mesh(4, device="cpu")
    eng = FftMethod(FftMethodConfig(frame_size=64, sample_point_size=16, quantize_8bit=False),
                    device="cpu")
    prev, curr = _rolled_pairs(rng, 8, 64, shift=(2, -1))
    prev[5, 3, 3] = np.nan
    shifts, mean = sharded_flow_step(eng, mesh)(prev, curr)
    ref = eng.step_batch(torch.from_numpy(prev), torch.from_numpy(curr))
    _close(shifts, ref.shifts, SHARD_SHIFT_TOL)
    assert np.isnan(to_numpy(shifts)[5]).any() and np.isnan(float(mean))


# --------------------------------------------------------------------------- #
# BatchPipeline under a mesh                                                   #
# --------------------------------------------------------------------------- #


@needs_jax_mesh
def test_batch_pipeline_sharded_matches_unsharded(rng):
    b = 8
    prev = np.stack([smooth_random_image(rng, 64) for _ in range(b)]).astype(np.float32)
    curr = np.stack([np.roll(prev[i], (0, 2), axis=(0, 1)) for i in range(b)])
    ctx = _ctx(b)
    kwargs = dict(frame_size=48, sample_point_size=12, camera_matrix=K,
                  dist_coeffs=np.zeros(5, np.float32), ransac_iterations=32)
    mesh = make_mesh(8, device="cpu")
    plain = BatchPipeline(**kwargs, device="cpu")
    sharded = BatchPipeline(**kwargs, mesh=mesh, device="cpu")
    assert sharded.mesh is mesh and sharded.device == mesh.first
    out_a = plain.step(prev, curr, *ctx, generator=torch.Generator().manual_seed(4))
    out_b = sharded.step(shard_batch(prev, mesh), shard_batch(curr, mesh), *ctx,
                         generator=torch.Generator().manual_seed(4))
    _assert_sharded_equal(out_b, out_a)
    assert to_numpy(out_a.ok).sum() >= b - 1
    # the whole batch's draws, sliced a shard, give each pair the inlier
    # count it has unsharded (the pipeline output does not carry it)
    res = plain.engine.step_batch(plain.preprocess(prev), plain.preprocess(curr))
    args = [torch.from_numpy(a) for a in ctx]

    def rt(sl, draws):
        return get_rt_batch(res.shifts[sl], args[0][sl], args[1][sl], plain.ul_x, plain._cam, None,
                            args[3], args[2][sl], frame_size=48, patch=12, ransac_iterations=32,
                            gumbel=draws)

    gumbel = sharded._gumbel(None, torch.Generator().manual_seed(4), b)
    whole = rt(slice(None), gumbel)
    parts = [rt(slice(i, i + 1), gumbel[..., i:i + 1]) for i in range(b)]
    np.testing.assert_array_equal(to_numpy(whole.n_inliers),
                                  np.concatenate([to_numpy(p.n_inliers) for p in parts]))
    np.testing.assert_array_equal(to_numpy(whole.ok), to_numpy(out_b.ok))
    # against the JAX pipeline under its mesh, with its draws
    jmesh = jax_make_mesh(8)
    keys, gumbel = _jax_draws(b, 32, 16)
    jout = JaxPipeline(**kwargs, mesh=jmesh).step(
        jax_shard_batch(jnp.asarray(prev), jmesh), jax_shard_batch(jnp.asarray(curr), jmesh),
        *(jnp.asarray(a) for a in ctx), keys)
    _assert_matches_jax(sharded.step(prev, curr, *ctx, gumbel=gumbel), jout)


def test_batch_pipeline_uint8_sharded(rng):
    """uint8 frames ride the sharded path and match the float32 results."""
    b = 8
    prev8 = (np.stack([smooth_random_image(rng, 64) for _ in range(b)]) * 127 + 128).astype(np.uint8)
    curr8 = np.stack([np.roll(prev8[i], (0, 2), axis=(0, 1)) for i in range(b)])
    ctx = _ctx(b)
    mesh = make_mesh(8, device="cpu")
    pipe = BatchPipeline(frame_size=64, sample_point_size=16, camera_matrix=K,
                         dist_coeffs=np.zeros(5, np.float32), ransac_iterations=32, mesh=mesh,
                         device="cpu")
    out8 = pipe.step(shard_batch(prev8, mesh), shard_batch(curr8, mesh), *ctx,
                     generator=torch.Generator().manual_seed(0))
    outf = pipe.step(shard_batch(prev8.astype(np.float32), mesh),
                     shard_batch(curr8.astype(np.float32), mesh), *ctx,
                     generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(to_numpy(out8.shifts), to_numpy(outf.shifts))
    np.testing.assert_allclose(to_numpy(out8.tran), to_numpy(outf.tran), atol=1e-6, equal_nan=True)
    assert out8.shifts.device == mesh.first


def _sr_pipes(frame, patch, mesh, **sr_kw):
    """Port and JAX pipelines with a scale/rotation estimator each."""
    cam = np.array([[40.0, 0, frame / 2], [0, 40.0, frame / 2], [0, 0, 1.0]], np.float32)
    kw = dict(frame_size=frame, sample_point_size=patch, camera_matrix=cam,
              dist_coeffs=np.zeros(5, np.float32), ransac_iterations=16)
    cfg = dict(resolution=frame, **sr_kw)
    port = BatchPipeline(**kw, scale_rotation=ScaleRotationEstimator(ScaleRotationConfig(**cfg),
                                                                     device="cpu"),
                         mesh=mesh, device="cpu")
    return port, kw, cfg


@needs_jax_mesh
def test_sr_shard_map_chunked_matches_unsharded(rng):
    """The scale/rotation leg under a mesh: a 16-stream fleet with the leg
    fused over 8 shards (two streams a shard) equals the unsharded fleet,
    carried and stateless, and the JAX fleet and pipeline under theirs."""
    frame, patch, b = 64, 16, 16
    base = smooth_random_image(rng, frame, cutoff=0.4)
    t0 = np.stack([np.roll(base, i % 5, axis=1) for i in range(b)])
    t1 = np.stack([np.roll(base, (i % 5) + 2, axis=0) for i in range(b)])
    mesh = make_mesh(8, device="cpu")
    pipe_m, kw, cfg = _sr_pipes(frame, patch, mesh, magnitude=12.0)
    pipe_u, _, _ = _sr_pipes(frame, patch, None, magnitude=12.0)

    def run(pipe, **fleet_kw):
        srv = FleetServer(pipe, b, **fleet_kw)
        assert srv._sr_fused
        srv.tick(t0, np.zeros(b), np.full(b, 2.0))
        return srv.tick(t1, np.full(b, 0.05), np.full(b, 2.0)).materialize()

    tick_m, tick_u = run(pipe_m), run(pipe_u)
    _close(tick_m.scale, tick_u.scale, SHARD_DECODE_TOL)
    _close(tick_m.rotation, tick_u.rotation, SHARD_DECODE_TOL)
    np.testing.assert_array_equal(tick_m.ok, tick_u.ok)
    _close(tick_m.tran, tick_u.tran, SHARD_TRAN_TOL)

    jmesh = jax_make_mesh(8)
    jpipe = JaxPipeline(**kw, scale_rotation=JSR(JSRConfig(**cfg, lp_batch_chunk=1)), mesh=jmesh)
    jf = JaxFleet(jpipe, b)
    jf.tick(t0, np.zeros(b), np.full(b, 2.0))
    jtick = jf.tick(t1, np.full(b, 0.05), np.full(b, 2.0)).materialize()
    tick_j = run(pipe_m, draws=jax_key_draws(0))
    np.testing.assert_array_equal(tick_j.ok, jtick.ok)
    _close(tick_j.scale, jtick.scale, DECODE_TOL)
    _close(tick_j.rotation, jtick.rotation, DECODE_TOL)
    _close(tick_j.tran, jtick.tran, TRAN_TOL)

    # the stateless leg (both frames resampled) too
    ctx = _ctx(b)
    keys, gumbel = _jax_draws(b, 16, 16)
    out_m = pipe_m.step(shard_batch(t0, mesh), shard_batch(t1, mesh), *ctx, gumbel=gumbel)
    out_u = pipe_u.step(t0, t1, *ctx, gumbel=gumbel)
    _assert_sharded_equal(out_m, out_u)
    jout = jpipe.step(jax_shard_batch(jnp.asarray(t0), jmesh), jax_shard_batch(jnp.asarray(t1), jmesh),
                      *(jnp.asarray(a) for a in ctx), keys)
    _assert_matches_jax(out_m, jout, sr=True)


@needs_jax_mesh
def test_fleet_carried_sr_under_mesh(rng):
    """``test_fleet_carried_sr_production_geometry_under_mesh`` at half its
    geometry, 240 px frames and magnitude 49.9 / 2 (the 480 px case runs
    on the card, ``chip_smoke.py`` phase 17; at 128 px the log-polar
    angle step, 2.8 degrees, is too coarse for the 0.5 degree bound):
    two carried ticks of eight streams, each turned by its own angle, decode
    each stream's rotation; sharded equals unsharded and the JAX fleet
    under its mesh."""
    frame, patch, b = 240, 60, 8
    base = smooth_random_image(rng, frame, cutoff=0.3)
    degs = np.linspace(-3.0, 3.0, b)
    t0 = np.stack([np.roll(base, i, axis=1) for i in range(b)])
    t1 = np.stack([ndi.rotate(t0[i], degs[i], reshape=False, mode="wrap") for i in range(b)])
    mesh = make_mesh(8, device="cpu")
    pipe_m, kw, cfg = _sr_pipes(frame, patch, mesh, magnitude=49.9 / 2)
    pipe_u, _, _ = _sr_pipes(frame, patch, None, magnitude=49.9 / 2)

    def run(pipe, **fleet_kw):
        srv = FleetServer(pipe, b, **fleet_kw)
        assert srv._sr_fused
        srv.tick(t0, np.zeros(b), np.full(b, 2.0))
        return srv.tick(t1, np.full(b, 0.05), np.full(b, 2.0)).materialize()

    tick = run(pipe_m)
    assert np.all(np.isfinite(tick.scale)) and np.all(np.isfinite(tick.rotation))
    np.testing.assert_allclose(np.rad2deg(tick.rotation), degs, atol=0.5)
    np.testing.assert_allclose(tick.scale, 1.0, atol=0.02)
    ref = run(pipe_u)
    _close(tick.scale, ref.scale, SHARD_DECODE_TOL)
    _close(tick.rotation, ref.rotation, SHARD_DECODE_TOL)
    np.testing.assert_array_equal(tick.ok, ref.ok)

    jmesh = jax_make_mesh(8)
    jf = JaxFleet(JaxPipeline(**kw, scale_rotation=JSR(JSRConfig(**cfg)), mesh=jmesh), b)
    jf.tick(t0, np.zeros(b), np.full(b, 2.0))
    jtick = jf.tick(t1, np.full(b, 0.05), np.full(b, 2.0)).materialize()
    ours = run(pipe_m, draws=jax_key_draws(0))
    np.testing.assert_array_equal(ours.ok, jtick.ok)
    _close(ours.scale, jtick.scale, DECODE_TOL)
    _close(ours.rotation, jtick.rotation, DECODE_TOL)


@needs_jax_mesh
def test_serving_loop_under_mesh():
    """``ServingLoop(depth=3)`` over a mesh-sharded pipeline with the
    scale/rotation leg: the loop gets outputs gathered on the mesh's first
    device, results equal the unsharded loop's, and the JAX loop's under
    its mesh with its draws."""
    frame, patch, bs = 64, 16, 8
    reqs = []
    for i in range(18):  # 2 full batches + a padded remainder of 2
        prev = (smooth_random_image(np.random.default_rng(100 + i), frame) * 127 + 128).astype(np.uint8)
        curr = np.roll(prev, (i % 5) - 2, axis=1)
        reqs.append((prev, curr))
    mesh = make_mesh(8, device="cpu")
    pipe, kw, cfg = _sr_pipes(frame, patch, mesh, magnitude=12.0)
    kw["ransac_iterations"] = 32
    pipe = BatchPipeline(**kw, scale_rotation=pipe.scale_rotation, mesh=mesh, device="cpu")
    seen = []
    orig_step = pipe.step

    def spy_step(*args, **kwargs):
        out = orig_step(*args, **kwargs)
        seen.append(out.shifts.device)
        return out

    pipe.step = spy_step
    port_reqs = [ServingRequest(prev=p, curr=c, height=2.0, dt=0.05) for p, c in reqs]
    results = list(ServingLoop(pipe, batch_size=bs, depth=3, seed=5).run(port_reqs))
    assert len(results) == 18 and seen == [mesh.first] * 3
    unsharded = BatchPipeline(**kw, scale_rotation=pipe.scale_rotation, device="cpu")
    ref = list(ServingLoop(unsharded, batch_size=bs, depth=3, seed=5).run(port_reqs))
    for a, b in zip(results, ref):
        assert a.ok == b.ok
        _close(a.shifts, b.shifts, SHARD_SHIFT_TOL)
        _close(a.tran, b.tran, SHARD_TRAN_TOL)
        _close(a.scale, b.scale, SHARD_DECODE_TOL)
        _close(a.rotation, b.rotation, SHARD_DECODE_TOL)

    jmesh = jax_make_mesh(8)
    jpipe = JaxPipeline(**kw, scale_rotation=JSR(JSRConfig(**cfg)), mesh=jmesh)
    jres = list(JaxLoop(jpipe, batch_size=bs, depth=3, seed=5).run(
        [JaxRequest(prev=p, curr=c, height=2.0, dt=0.05) for p, c in reqs]))
    ours = list(ServingLoop(pipe, batch_size=bs, depth=3, draws=jax_key_draws(5)).run(port_reqs))
    for a, b in zip(ours, jres, strict=True):
        assert a.ok == b.ok
        _close(a.shifts, b.shifts, SHIFT_TOL)
        _close(a.tran, b.tran, TRAN_TOL)
        _close(a.scale, b.scale, DECODE_TOL)
        _close(a.rotation, b.rotation, DECODE_TOL)


@needs_jax_mesh
def test_batch_pipeline_long_range(rng):
    """The batched long-range path under a mesh: sharded equals unsharded,
    sample 1 equals get2DT on its shifts, the twists are physical, and the
    JAX pipeline under a 4-device mesh agrees."""
    b = 4
    prev = np.stack([smooth_random_image(rng, 96, cutoff=0.4) for _ in range(b)]).astype(np.float32)
    curr = np.stack([np.roll(prev[i], (4 * (i + 1), -8), axis=(0, 1)) for i in range(b)])
    heights = np.full(b, 3.0, np.float32)
    dts = np.full(b, 0.1, np.float32)
    zeros = np.zeros(b, np.float32)
    kw = dict(frame_size=96, sample_point_size=24, camera_matrix=K,
              dist_coeffs=np.zeros(5, np.float32), crop_cx=48.0)
    mesh = make_mesh(4, device="cpu")
    pipe = BatchPipeline(**kw, mesh=mesh, device="cpu")
    out = pipe.step_long_range(prev, curr, heights, dts, zeros, zeros, 0.0)
    ref = BatchPipeline(**kw, device="cpu").step_long_range(prev, curr, heights, dts, zeros, zeros, 0.0)
    pre = pipe.step_long_range_pre(pipe.preprocess(shard_batch(prev, mesh)),
                                   pipe.preprocess(shard_batch(curr, mesh)),
                                   heights, dts, zeros, zeros, 0.0)
    for o in (out, pre):
        np.testing.assert_array_equal(to_numpy(o.ok), to_numpy(ref.ok))
        for name in ("shifts", "tran", "tran_diff"):
            _close(getattr(o, name), getattr(ref, name), SHARD_SHIFT_TOL)
        np.testing.assert_allclose(float(o.fleet_mean_speed), float(ref.fleet_mean_speed), rtol=1e-6)
    assert out.shifts.shape[0] == b and to_numpy(out.ok).all()
    one = get_2dt(out.shifts[1], 3.0, 0.1, torch.from_numpy(K), 0.0, 0.0, 0.0, long_range_ratio=4)
    np.testing.assert_allclose(to_numpy(out.tran[1]), to_numpy(one.tran), atol=1e-5)
    expect = -np.array([-8.0, 8.0]) * 3.0 / 40.0 / 0.1
    np.testing.assert_allclose(to_numpy(out.tran[1][:2]), expect, rtol=0.2)
    jmesh = jax_make_mesh(4)
    j = JaxPipeline(**kw, mesh=jmesh).step_long_range(
        jax_shard_batch(jnp.asarray(prev), jmesh), jax_shard_batch(jnp.asarray(curr), jmesh),
        *(jnp.asarray(a) for a in (heights, dts, zeros, zeros)), jnp.float32(0.0))
    np.testing.assert_array_equal(to_numpy(out.ok), np.asarray(j.ok))
    _close(out.shifts, j.shifts, SHIFT_TOL)
    _close(out.tran, j.tran, 1e-4)
