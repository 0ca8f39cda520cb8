"""Parity of the port's ``ServingLoop`` with the JAX package's on the CPU,
the JAX loop's key sequence replayed as the port's ``draws`` hook
(``torch_parity.jax_key_draws``): uint8, float32 and float64 frames, a
mixed batch, partial batches, depths 1, 2 and 4, and the scale/rotation
leg.

Tolerances: ``ok`` equal; shifts within 1e-3 px; ``tran`` within 1e-3 m/s
and ``rot`` sample by sample within ``torch_parity.rot_tol``
(``tests/test_torch_batched_geometry.py``; requests turn by up to 1.2
degrees, so ``rot`` is far from the identity); scale and rotation within
1e-3.  The port's own depths give identical
results (the same calls in the same order).
"""

import numpy as np
import pytest
import torch
from oracle import smooth_random_image
from torch_parity import assert_rot_close, jax_key_draws, rotated

from mrs_optic_flow_tpu.models import ScaleRotationConfig as JSRConfig
from mrs_optic_flow_tpu.models import ScaleRotationEstimator as JSR
from mrs_optic_flow_tpu.parallel import BatchPipeline as JaxPipeline
from mrs_optic_flow_tpu.runtime.serving import ServingLoop as JaxLoop
from mrs_optic_flow_tpu.runtime.serving import ServingRequest as JaxRequest
from mrs_optic_flow_tpu_torch.models import ScaleRotationConfig, ScaleRotationEstimator
from mrs_optic_flow_tpu_torch.parallel import BatchPipeline
from mrs_optic_flow_tpu_torch.runtime.serving import ServingLoop, ServingRequest

K = np.array([[40.0, 0, 24.0], [0, 40.0, 24.0], [0, 0, 1.0]], np.float32)
KW = dict(frame_size=48, sample_point_size=12, camera_matrix=K,
          dist_coeffs=np.zeros(5, np.float32), ransac_iterations=32)
DT = 0.05
SHIFT_TOL = 1e-3  # px
TRAN_TOL = 1e-3  # m/s
#: request i's turn between its frames [deg], at TURN[i % 4]
TURN = [0.0, 1.0, -1.2, 0.5]
DECODE_TOL = 1e-3


def _frames(n, dtype=np.uint8, size=48, seed=0):
    out = []
    for i in range(n):
        img = (smooth_random_image(np.random.default_rng(seed + i), size, cutoff=0.4) * 127 + 128)
        prev = img.astype(np.uint8)
        curr = np.roll(rotated(prev, TURN[i % len(TURN)]), ((i % 3) - 1, (i % 5) - 2), axis=(0, 1))
        dt = dtype[i % len(dtype)] if isinstance(dtype, list) else dtype
        out.append((prev.astype(dt), curr.astype(dt), 1.5 + 0.1 * (i % 7)))
    return out


def _run(frames, *, batch_size, depth=2, seed=0, sr=False, kw=KW):
    """(JAX loop results, port loop results) on the same requests."""
    jsr = tsr = None
    if sr:
        cfg = dict(resolution=kw["frame_size"], magnitude=15.0)
        jsr, tsr = JSR(JSRConfig(**cfg)), ScaleRotationEstimator(ScaleRotationConfig(**cfg), device="cpu")
    jreqs = [JaxRequest(prev=p, curr=c, height=h, dt=DT) for p, c, h in frames]
    treqs = [ServingRequest(prev=p, curr=c, height=h, dt=DT) for p, c, h in frames]
    jloop = JaxLoop(JaxPipeline(**kw, scale_rotation=jsr), batch_size=batch_size, seed=seed)
    tloop = ServingLoop(BatchPipeline(**kw, scale_rotation=tsr, device="cpu"), batch_size=batch_size,
                        depth=depth, draws=jax_key_draws(seed))
    return list(jloop.run(jreqs)), list(tloop.run(treqs))


def _assert_results(js, ts, sr=False):
    assert len(js) == len(ts)
    for a, b in zip(ts, js):
        assert a.ok == b.ok
        np.testing.assert_allclose(a.shifts, b.shifts, atol=SHIFT_TOL, rtol=0, equal_nan=True)
        np.testing.assert_allclose(a.tran, b.tran, atol=TRAN_TOL, rtol=0, equal_nan=True)
        assert_rot_close(a.rot, b.rot, DT)
        if sr:
            assert abs(a.scale - b.scale) <= DECODE_TOL and abs(a.rotation - b.rotation) <= DECODE_TOL
        else:
            assert np.isnan([a.scale, a.rotation, b.scale, b.rotation]).all()


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64, [np.uint8, np.float32]],
                         ids=["uint8", "float32", "float64", "mixed"])
def test_serving_loop_matches_jax(dtype):
    """Two full batches and a padded remainder; float64 frames become
    float32 on the host and a mixed batch is promoted, as in the JAX loop."""
    js, ts = _run(_frames(10, dtype), batch_size=4)
    _assert_results(js, ts)
    assert sum(r.ok for r in ts) >= 8


@pytest.mark.parametrize("n,batch_size", [(3, 8), (1, 4), (5, 5)])
def test_partial_and_exact_batches(n, batch_size):
    js, ts = _run(_frames(n, seed=20), batch_size=batch_size, seed=3)
    _assert_results(js, ts)


def test_depths_give_identical_ordered_results():
    frames = _frames(9, seed=40)
    js, ref = _run(frames, batch_size=2, depth=2, seed=1)
    _assert_results(js, ref)
    for depth in (1, 4):
        reqs = [ServingRequest(prev=p, curr=c, height=h, dt=DT) for p, c, h in frames]
        loop = ServingLoop(BatchPipeline(**KW, device="cpu"), batch_size=2, depth=depth,
                           draws=jax_key_draws(1))
        got = list(loop.run(reqs))
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert a.ok == b.ok
            for f in ("shifts", "tran", "rot"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_serving_scale_rotation():
    kw = dict(KW, frame_size=64, sample_point_size=16, camera_matrix=np.array(
        [[40.0, 0, 32.0], [0, 40.0, 32.0], [0, 0, 1.0]], np.float32))
    js, ts = _run(_frames(3, size=64, seed=60), batch_size=2, sr=True, kw=kw)
    _assert_results(js, ts, sr=True)
    assert all(np.isfinite([r.scale, r.rotation]).all() for r in ts)


def test_generator_draws_are_seeded():
    """Without a hook the draws come from the loop's generator: the same
    seed repeats a run."""
    frames = _frames(4, seed=80)
    reqs = [ServingRequest(prev=p, curr=c, height=h, dt=DT) for p, c, h in frames]
    pipe = BatchPipeline(**KW, device="cpu")
    a, b = (list(ServingLoop(pipe, batch_size=2, seed=7).run(reqs)) for _ in range(2))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tran, y.tran)
    assert sum(r.ok for r in a) >= 3
    with pytest.raises(ValueError, match="depth"):
        ServingLoop(pipe, depth=0)
    assert isinstance(ServingLoop(pipe).c2b, torch.Tensor)
