"""Block matching (methods 3 and 5) against the JAX package on the CPU: the
SAD search (kernel C's plain twin against the JAX ``lax.scan`` search and
the Pallas kernel in interpret mode), the per-cell argmin with its noise
gate, the histogram vote, the sub-pixel refinement and both engines, at the
geometry of ``tests/test_node.py`` (frame 96, blocks 24, radius 8, step 8).

Tolerances: SAD maps are exact on integer-valued inputs (every partial sum
is an integer below 2^24) and within 1e-6 relative otherwise (float32 sums
in another order); the bilinear upsample within 1e-4 gray levels (the same
two-tap weights applied in another order); flows exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import smooth_random_image
from torch_parity import run_both, to_numpy

from mrs_optic_flow_tpu.models import BlockMethod as JaxBlockMethod
from mrs_optic_flow_tpu.models import BlockMethodConfig as JaxBlockConfig
from mrs_optic_flow_tpu.models import FastSpacedBM as JaxFastSpacedBM
from mrs_optic_flow_tpu.models import FastSpacedBMConfig as JaxFastConfig
from mrs_optic_flow_tpu.ops import block_matching as jbm
from mrs_optic_flow_tpu_torch.models import (
    BlockMethod,
    BlockMethodConfig,
    FastSpacedBM,
    FastSpacedBMConfig,
    make_engine,
)
from mrs_optic_flow_tpu_torch.ops import block_matching as tbm
from mrs_optic_flow_tpu_torch.ops import cuda_kernels

SMALL = dict(frame_size=96, sample_point_size=24, scan_radius=8)


def _blocks(rng, g, s, r, integer=True):
    if integer:
        curr = rng.integers(0, 256, size=(g, s, s)).astype(np.float32)
        region = rng.integers(0, 256, size=(g, s + 2 * r, s + 2 * r)).astype(np.float32)
    else:
        curr = rng.uniform(0, 255, size=(g, s, s)).astype(np.float32)
        region = rng.uniform(0, 255, size=(g, s + 2 * r, s + 2 * r)).astype(np.float32)
    return curr, region


@pytest.mark.parametrize("s,r", [(16, 4), (24, 8)])
def test_sad_search_exact_against_jax_scan_and_pallas(s, r):
    curr, region = _blocks(np.random.default_rng(s), 3, s, r)
    kw = dict(block_size=s, scan_radius=r)
    j_scan, t = run_both(lambda c, p: jbm.sad_search(c, p, **kw),
                         lambda c, p: cuda_kernels.sad_search(c, p, **kw), curr, region)
    j_pallas = np.asarray(jbm.sad_search_pallas(jnp.asarray(curr), jnp.asarray(region), **kw))
    assert t.shape == (3, 2 * r + 1, 2 * r + 1) and t.dtype == np.float32
    np.testing.assert_array_equal(t, j_scan)
    np.testing.assert_array_equal(t, j_pallas)
    # the brute-force definition, one entry
    np.testing.assert_array_equal(t[1, 2, 5], np.abs(curr[1] - region[1, 2:2 + s, 5:5 + s]).sum())


def test_sad_search_float_inputs():
    curr, region = _blocks(np.random.default_rng(1), 2, 16, 4, integer=False)
    kw = dict(block_size=16, scan_radius=4)
    j, t = run_both(lambda c, p: jbm.sad_search(c, p, **kw),
                    lambda c, p: tbm.sad_search(c, p, **kw), curr, region)
    np.testing.assert_allclose(t, j, rtol=1e-6)


def test_sad_min_flow_noise_gate_and_ties():
    r, d = 2, 5
    sad = np.full((4, d, d), 100.0, np.float32)
    sad[0, 1, 4] = 1.0  # min at dy = -1, dx = +2
    sad[1, r, r] = 50.0  # the centre barely above the minimum
    sad[1, 0, 0] = 49.5
    sad[2, 3, 1] = sad[2, 1, 3] = 7.0  # tie: the lower flat index wins
    sad[3] = 3.0  # flat: every shift ties
    for gate in (None, 0.8):
        j, t = run_both(lambda x: jbm.sad_min_flow(x, r, noise_threshold=gate),
                        lambda x: tbm.sad_min_flow(x, r, noise_threshold=gate), sad)
        np.testing.assert_array_equal(t, j)
    assert t.tolist() == [[2, -1], [0, 0], [1, -1], [0, 0]]


@pytest.mark.parametrize("top_k", [1, 3])
def test_histogram_vote_matches_jax(top_k):
    flow = np.array([[3, -1], [3, -1], [3, 2], [-2, -1], [-2, 2], [1, 4]], np.int32)
    (jx, jy), (tx, ty) = run_both(lambda f: jbm.histogram_vote(f, 4, top_k=top_k),
                                  lambda f: tbm.histogram_vote(f.long(), 4, top_k=top_k), flow)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    # a leading batch dimension votes each row on its own
    bx, by = tbm.histogram_vote(torch.from_numpy(np.stack([flow, -flow])).long(), 4, top_k=top_k)
    np.testing.assert_array_equal(bx[0].numpy(), jx)
    np.testing.assert_array_equal(bx[1].numpy(), np.asarray(jbm.histogram_vote(
        jnp.asarray(-flow), 4, top_k=top_k)[0]))


@pytest.mark.parametrize("scale", [2, 4])
def test_upsample_matches_jax_resize_at_the_borders(scale):
    img = np.random.default_rng(2).uniform(0, 255, size=(12, 10)).astype(np.float32)
    j = np.asarray(jax.image.resize(jnp.asarray(img), (12 * scale, 10 * scale), method="linear"))
    t = to_numpy(tbm._upsample(torch.from_numpy(img), scale))
    np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)
    # the borders in particular: the edge rows and columns
    np.testing.assert_allclose(t[[0, -1]], j[[0, -1]], atol=1e-4, rtol=0)
    np.testing.assert_allclose(t[:, [0, -1]], j[:, [0, -1]], atol=1e-4, rtol=0)


@pytest.mark.parametrize("shift,flow", [((3, -5), (5, -3)), ((-2, 1), (-1, 2)), ((0, 0), (1, 0))])
def test_refine_subpixel_matches_jax(shift, flow):
    base = smooth_random_image(np.random.default_rng(3), 48).astype(np.float32)
    curr = np.roll(base, shift, axis=(0, 1))
    flow = np.asarray(flow, np.int32)
    j, t = run_both(lambda c, p, f: jbm.refine_subpixel(c, p, f),
                    lambda c, p, f: tbm.refine_subpixel(c, p, f), curr, base, flow)
    np.testing.assert_array_equal(t, j)


def test_extract_blocks_matches_jax_including_clamping():
    frame = np.arange(40 * 40, dtype=np.float32).reshape(40, 40)
    origins = np.array([[0, 0], [8, 16], [30, 35], [-3, 2]], np.int32)
    j = np.asarray(jbm._extract_blocks(jnp.asarray(frame), jnp.asarray(origins), 10))
    t = to_numpy(tbm.extract_blocks(torch.from_numpy(frame), origins, 10))
    np.testing.assert_array_equal(t, j)


def _frames(seed, moves):
    base = smooth_random_image(np.random.default_rng(seed), 96).astype(np.float32)
    return [np.roll(base, m, axis=(0, 1)) for m in moves]


ENGINES = {
    "block": (JaxBlockMethod, JaxBlockConfig, BlockMethod, BlockMethodConfig, {}),
    "fast": (JaxFastSpacedBM, JaxFastConfig, FastSpacedBM, FastSpacedBMConfig, {"step_size": 8}),
}


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_step_and_batch_match_jax(name, use_pallas):
    jcls, jcfg, tcls, tcfg, extra = ENGINES[name]
    kw = dict(SMALL, use_pallas=use_pallas, **extra)
    jeng, teng = jcls(jcfg(**kw)), tcls(tcfg(**kw), device="cpu")
    assert teng.grid_side == jeng.grid_side and teng.num_cells == jeng.num_cells
    frames = _frames(4, [(0, 0), (3, -5), (1, -2), (-4, 2)])
    jst, tst = jeng.init_state(), teng.init_state()
    assert tst.first and tst.prev.dtype == torch.float32
    for frame in frames:
        jst, jres = jeng.step(jst, jnp.asarray(frame))
        tst, tres = teng.step(tst, torch.from_numpy(frame))
        for ours, theirs in zip(tres, jres):
            np.testing.assert_array_equal(to_numpy(ours), np.asarray(theirs))
        np.testing.assert_array_equal(to_numpy(tst.prev), np.asarray(jst.prev))
    prev, curr = np.stack(frames[:3]), np.stack(frames[1:])
    jb = jeng.step_batch(jnp.asarray(prev), jnp.asarray(curr))
    tb = teng.step_batch(torch.from_numpy(prev), torch.from_numpy(curr))
    for ours, theirs in zip(tb, jb):
        assert ours.shape[0] == 3
        np.testing.assert_array_equal(to_numpy(ours), np.asarray(theirs))


def test_engines_recover_shifts_and_flat_frames():
    frames = _frames(5, [(0, 0), (3, -5)])
    eng = BlockMethod(BlockMethodConfig(**SMALL), device="cpu")
    st, _ = eng.step(eng.init_state(), torch.from_numpy(frames[0]))
    _, res = eng.step(st, torch.from_numpy(frames[1]))
    assert np.all(np.abs(to_numpy(res.shifts)[0] - [-5, 3]) <= 0.5)
    fast = FastSpacedBM(FastSpacedBMConfig(**SMALL, step_size=8), device="cpu")
    flat = torch.full((96, 96), 128.0)
    st, _ = fast.step(fast.init_state(), flat)
    _, res = fast.step(st, flat)
    assert to_numpy(res.shifts)[0].tolist() == [0.0, 0.0]


def test_make_engine_dispatch():
    assert isinstance(make_engine(3, **SMALL, device="cpu"), BlockMethod)
    assert isinstance(make_engine(5, **SMALL, step_size=8, device="cpu"), FastSpacedBM)
    with pytest.raises(ValueError, match="invalid method"):
        make_engine(6, device="cpu")
