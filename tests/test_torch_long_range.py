"""Long-range mode and the patch-batch route of the port against the JAX
package on the CPU.

- ``FftMethod``: the JAX engine's long-range and patch-batch tests
  (``tests/test_fft_method.py``) run through both engines, plus the
  geometries that kernel A does not take (frame 480 with patches 160, 240
  and 100, the last one a single 480 px window).  The JAX engine runs its
  Pallas kernels in interpret mode; the port runs the kernels' plain twins.
  Shifts agree within 1e-3 px.
- ``get_2dt``: the cases of ``tests/test_geometry.py`` through both, within
  1e-5 relative.
- The node: one synthetic event stream through the port's node and the JAX
  node with ``height_based`` switching (frame 256, 4x4 windows of 64 px),
  ``tpu.long_range_ratio: 2``, ``takeoff_based`` with tracker status, and
  the kernel-D geometry (frame 240, windows of 60 px).  The stream is
  rendered at 2 m while the height topic crosses ``takeoff_height`` both
  ways, so the node switches modes.  Every window is a RANSAC inlier (see
  ``tests/test_torch_node.py``), so every published twist, short and long
  range, agrees within 1e-3 m/s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import smooth_random_image
from torch_parity import to_numpy

from mrs_optic_flow_tpu.config import load_config
from mrs_optic_flow_tpu.geometry.motion import get_2dt as jax_get_2dt
from mrs_optic_flow_tpu.models import FftMethod as JaxFftMethod
from mrs_optic_flow_tpu.models import FftMethodConfig as JaxConfig
from mrs_optic_flow_tpu.runtime import OpticFlowNode as JaxNode
from mrs_optic_flow_tpu.runtime import SyntheticScene
from mrs_optic_flow_tpu_torch.config import NodeConfig
from mrs_optic_flow_tpu_torch.geometry.motion import LONGRANGE_INLIER_THRESHOLD, get_2dt
from mrs_optic_flow_tpu_torch.models import FftMethod, FftMethodConfig
from mrs_optic_flow_tpu_torch.ops import cuda_kernels
from mrs_optic_flow_tpu_torch.runtime.msgs import (
    Float64Stamped,
    ImageMsg,
    Imu,
    Odometry,
    TrackerStatus,
)
from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode

SHIFT_TOL = 1e-3  # px
TWIST_TOL = 1e-3  # m/s
K = np.array([[420.0, 0.0, 376.0], [0.0, 410.0, 240.0], [0.0, 0.0, 1.0]])


def _engines(**kw):
    return JaxFftMethod(JaxConfig(**kw)), FftMethod(FftMethodConfig(**kw), device="cpu")


def _pair(seed, size, roll, cutoff=0.4):
    prev = smooth_random_image(np.random.default_rng(seed), size, cutoff=cutoff)
    return prev, np.roll(prev, roll, axis=(0, 1))


def _assert_results_agree(tres, jres):
    ts, js = to_numpy(tres.shifts), to_numpy(jres.shifts)
    np.testing.assert_array_equal(np.isnan(ts), np.isnan(js))
    np.testing.assert_allclose(ts, js, atol=SHIFT_TOL, rtol=0, equal_nan=True)
    np.testing.assert_allclose(to_numpy(tres.shifts_raw), to_numpy(jres.shifts_raw),
                               atol=SHIFT_TOL, rtol=0)
    np.testing.assert_allclose(to_numpy(tres.response), to_numpy(jres.response), rtol=1e-4)


def _stream_both(jeng, teng, frames, long_range):
    """Step both engines over ``frames``; returns the last results."""
    jst, tst = jeng.init_state(), teng.init_state()
    jstep = jeng.step_long_range if long_range else jeng.step
    tstep = teng.step_long_range if long_range else teng.step
    for f in frames:
        jst, jres = jstep(jst, jnp.asarray(f))
        tst, tres = tstep(tst, torch.from_numpy(np.asarray(f)))
        _assert_results_agree(tres, jres)
        np.testing.assert_array_equal(to_numpy(tst.prev), to_numpy(jst.prev))
    return tres, jres


# --------------------------------------------------------------------------- #
# the engine                                                                   #
# --------------------------------------------------------------------------- #


def test_long_range_grid_shape():
    """tests/test_fft_method.py::test_long_range_grid_shape: 4x downsampled,
    one 120 px window, shift / 4."""
    jeng, teng = _engines(use_pallas=False, backend="fft")
    assert (teng.sq_num, teng.sq_num_lr, teng.patch_lr) == (4, 1, 120)
    tres, _ = _stream_both(jeng, teng, _pair(0, 480, (12, -20)), long_range=True)
    s = to_numpy(tres.shifts)
    assert s.shape == (1, 2)
    assert np.all(np.abs(s - np.array([-5.0, 3.0])) < 0.5), s


@pytest.mark.parametrize("long_range", [False, True])
def test_unaligned_patch_takes_kernel_d_route(long_range):
    """tests/test_fft_method.py::test_unaligned_patch_size: 60 px patches
    (not a multiple of 8) on the patch-batch route, 64 windows; long range
    at that geometry: 2x2 windows of 60 on the 120 px downsampled frame."""
    assert not cuda_kernels.frames_kernel_takes(60)
    jeng, teng = _engines(frame_size=480, sample_point_size=60)
    f0 = smooth_random_image(np.random.default_rng(1), 480, cutoff=0.35)
    tres, _ = _stream_both(jeng, teng, [f0, np.roll(f0, (8, -16), axis=(0, 1))], long_range)
    s = to_numpy(tres.shifts)
    assert s.shape == ((4, 2) if long_range else (64, 2))
    med = np.nanmedian(s, axis=0)
    expect = np.array([-16.0, 8.0]) / (4.0 if long_range else 1.0)
    assert np.abs(med - expect).max() < 0.5, med


def test_step_batch_long_range_matches_single_and_jax():
    """tests/test_fft_method.py::test_step_batch_long_range_matches_single."""
    jeng, teng = _engines(frame_size=96, sample_point_size=24, long_range_ratio=4)
    rng = np.random.default_rng(2)
    prev = np.stack([smooth_random_image(rng, 96, cutoff=0.4) for _ in range(3)])
    curr = np.stack([np.roll(prev[i], (4 * (i + 1), -4), axis=(0, 1)) for i in range(3)])
    tres = teng.step_batch_long_range(torch.from_numpy(prev), torch.from_numpy(curr))
    jres = jeng.step_batch_long_range(jnp.asarray(prev), jnp.asarray(curr))
    assert tuple(tres.shifts.shape) == (3, teng.num_windows_lr, 2)
    _assert_results_agree(tres, jres)
    for i in range(3):
        single, _ = _stream_both(jeng, teng, [prev[i], curr[i]], long_range=True)
        np.testing.assert_allclose(to_numpy(tres.shifts[i]), to_numpy(single.shifts), atol=1e-4)


@pytest.mark.parametrize(
    "frame_size,patch,patch_lr,windows_lr",
    [(360, 120, 90, 1),  # test_long_range_small_downsampled_frame (deviation 5)
     (600, 120, 120, 1)],  # test_long_range_non_multiple_downsample: trimmed 150 -> 120
)
def test_long_range_window_geometry(frame_size, patch, patch_lr, windows_lr):
    jeng, teng = _engines(frame_size=frame_size, sample_point_size=patch)
    assert (teng.patch_lr, teng.num_windows_lr) == (jeng.patch_lr, jeng.num_windows_lr)
    assert (teng.patch_lr, teng.num_windows_lr) == (patch_lr, windows_lr)
    prev, curr = _pair(3, frame_size, (-8, 12))
    single, _ = _stream_both(jeng, teng, [prev, curr], long_range=True)
    np.testing.assert_allclose(to_numpy(single.shifts)[0], [3.0, -2.0], atol=0.3)
    jres = jeng.step_batch_long_range(jnp.asarray(prev)[None], jnp.asarray(curr)[None])
    tres = teng.step_batch_long_range(torch.from_numpy(prev)[None], torch.from_numpy(curr)[None])
    _assert_results_agree(tres, jres)
    np.testing.assert_allclose(to_numpy(tres.shifts[0]), to_numpy(single.shifts), atol=1e-4)


def test_unaligned_patch_uint8_bit_identical():
    """tests/test_fft_method.py::test_unaligned_patch_uint8_exact_bit_identical:
    uint8 and float32 frames of the same values give the same shifts on the
    patch-batch route (frame 300, 3x3 windows of 100)."""
    jeng, teng = _engines(frame_size=300, sample_point_size=100)
    prev8 = (smooth_random_image(np.random.default_rng(4), 300, cutoff=0.4) * 0.5 + 64).astype(np.uint8)
    curr8 = np.roll(prev8, (5, -9), axis=(0, 1))
    r8 = teng.step_batch(torch.from_numpy(prev8)[None], torch.from_numpy(curr8)[None])
    rf = teng.step_batch(torch.from_numpy(prev8).float()[None], torch.from_numpy(curr8).float()[None])
    assert torch.equal(r8.shifts, rf.shifts) and torch.equal(r8.response, rf.response)
    _assert_results_agree(r8, jeng.step_batch(jnp.asarray(prev8)[None], jnp.asarray(curr8)[None]))
    np.testing.assert_allclose(to_numpy(r8.shifts)[0, 4], [-9.0, 5.0], atol=0.3)


@pytest.mark.parametrize("patch,windows", [(160, 9), (240, 4), (100, 1)])
def test_patches_kernel_a_refuses_match_jax(patch, windows):
    """Repair F2: patches beyond kernel A's shared memory (240) and a patch
    that does not divide the frame (100 -> one 480 px window) take kernel
    D's route, in both modes.  Patch 160 took D's route until kernel A's
    one-buffer FFT raised A's bound to 170; it now takes A's.  Every patch
    matches the JAX engine."""
    jeng, teng = _engines(frame_size=480, sample_point_size=patch)
    assert teng.num_windows == windows
    takes_a = {160: True, 240: False, 100: False}[patch]
    assert cuda_kernels.frames_kernel_takes(teng.config.sample_point_size) is takes_a
    frames = list(_pair(5, 480, (6, -10), cutoff=0.3))
    tres, _ = _stream_both(jeng, teng, frames, long_range=False)
    assert np.abs(np.nanmedian(to_numpy(tres.shifts), axis=0) - [-10.0, 6.0]).max() < 0.3
    _stream_both(jeng, teng, frames, long_range=True)


def test_route_rule():
    """Kernel A for multiples of 8 up to its shared-memory bound, kernel D
    for the rest; the bound is A's formula against 232,448 B."""
    assert cuda_kernels.PCF_MAX_PATCH == 170
    assert cuda_kernels.pcf_smem_bytes(170) + cuda_kernels.STATIC_SMEM_BYTES <= 232_448
    assert cuda_kernels.pcf_smem_bytes(171) + cuda_kernels.STATIC_SMEM_BYTES > 232_448
    takes = [n for n in range(1, 481) if cuda_kernels.frames_kernel_takes(n)]
    assert takes == list(range(8, 169, 8))


# --------------------------------------------------------------------------- #
# get_2dt                                                                      #
# --------------------------------------------------------------------------- #

GET_2DT_CASES = {
    # tests/test_geometry.py::test_get_2dt_basic: the first valid shift
    "basic": ([[np.nan, np.nan], [6.0, -3.0]], 2.0, 0.1, 0.0, 0.0, 0.0, 4),
    # ::test_get_2dt_rate_correction
    "rate_correction": ([[0.0, 0.0]], 2.0, 0.1, 0.2, -0.1, 0.0, 4),
    # ::test_get_2dt_rate_correction_axis_map, identity and 90-deg z mounts
    "pitch_identity_mount": ([[0.0, 0.0]], 2.0, 0.1, 0.0, 0.5, np.pi / 2, 4),
    "roll_identity_mount": ([[0.0, 0.0]], 2.0, 0.1, 0.4, 0.0, np.pi / 2, 4),
    "roll_z_mount": ([[0.0, 0.0]], 2.0, 0.1, 0.4, 0.0, 0.0, 4),
    "pitch_z_mount": ([[0.0, 0.0]], 2.0, 0.1, 0.0, 0.5, 0.0, 4),
    # ::test_get_2dt_ratio2_inlier_vote and its fewer-than-3 case
    "ratio2_vote": ([[4.0, -1.0], [4.2, -0.8], [3.9, -1.1], [30.0, 30.0]], 2.0, 0.1, 0.0, 0.0, 0.0, 2),
    "ratio2_too_few": ([[3.9, -1.1], [30.0, 30.0]], 2.0, 0.1, 0.0, 0.0, 0.0, 2),
    # ::test_get_2dt_ratio2_inlier_threshold_is_15: a 3-14 px spread
    "ratio2_spread": ([[0.0, 0.0], [3.0, 4.0], [9.0, 0.0], [0.0, 10.0]], 1.5, 0.05, 0.0, 0.0, 0.0, 2),
    "all_invalid": ([[np.nan, 0.0], [1.0, np.inf]], 2.0, 0.1, 0.1, 0.1, 0.3, 4),
    "zero_dt": ([[1.0, 2.0]], 2.0, 0.0, 0.0, 0.0, 0.0, 4),
}


@pytest.mark.parametrize("case", sorted(GET_2DT_CASES))
def test_get_2dt_matches_jax(case):
    shifts, h, dt, roll, pitch, cam_yaw, ratio = GET_2DT_CASES[case]
    shifts = np.asarray(shifts, np.float32)
    j = jax_get_2dt(jnp.asarray(shifts), jnp.float32(h), jnp.float32(dt), jnp.float32(0.0),
                    jnp.asarray(K, jnp.float32), jnp.float32(roll), jnp.float32(pitch),
                    jnp.float32(cam_yaw), long_range_ratio=ratio)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    t = get_2dt(torch.from_numpy(shifts), f32(h), f32(dt), torch.from_numpy(K.astype(np.float32)),
                f32(roll), f32(pitch), f32(cam_yaw), long_range_ratio=ratio)
    assert bool(t.ok) == bool(j.ok)
    for ours, theirs in ((t.tran, j.tran), (t.tran_diff, j.tran_diff)):
        np.testing.assert_allclose(to_numpy(ours), to_numpy(theirs), rtol=1e-5, atol=1e-6,
                                   equal_nan=True)
        assert np.isnan(to_numpy(ours)).all() != bool(t.ok)


def test_get_2dt_inlier_threshold_is_15():
    assert LONGRANGE_INLIER_THRESHOLD == 15.0
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    spread = torch.tensor([[0.0, 0.0], [3.0, 4.0], [9.0, 0.0], [0.0, 10.0]])
    res = get_2dt(spread, f32(1.5), f32(0.05), torch.from_numpy(K.astype(np.float32)),
                  f32(0.0), f32(0.0), f32(0.0), long_range_ratio=2)
    mean = spread.mean(dim=0).numpy()
    expect = -np.array([mean[0] * 1.5 / K[0, 0] * 2, mean[1] * 1.5 / K[1, 1] * 2, 0.0]) / 0.05
    assert bool(res.ok)
    np.testing.assert_allclose(to_numpy(res.tran), expect, rtol=1e-5)


# --------------------------------------------------------------------------- #
# the node                                                                     #
# --------------------------------------------------------------------------- #

N_FRAMES = 8
DT = 0.05
V_TRUE = (0.8, -0.5)
#: the height topic: short range above takeoff_height 1.0, long range below
HEIGHTS = [2.0, 2.0, 2.0, 0.8, 0.8, 0.8, 2.0, 2.0]
#: the tracker topic for takeoff_based: LandoffTracker is long range
TRACKERS = ["LandoffTracker"] * 4 + ["MpcTracker"] * 4

#: case -> (mrs_optic_flow keys, tpu keys, frame, patch, top-level keys)
NODE_CASES = {
    "height_based": ({"long_range_mode": "height_based", "takeoff_height": 1.0}, {}, 256, 64, {}),
    "ratio_2": ({"long_range_mode": "height_based", "takeoff_height": 1.0},
                {"long_range_ratio": 2}, 256, 64, {}),
    "takeoff_based": ({"long_range_mode": "takeoff_based"}, {}, 256, 64, {}),
    "kernel_d_geometry": ({"long_range_mode": "height_based", "takeoff_height": 1.0}, {}, 240, 60, {}),
    # the estimator runs inside both steps; log-polar 64 and magnitude 20
    # suit the small frame (tests/test_torch_node_modes.py)
    "scale_rotation": ({"long_range_mode": "height_based", "takeoff_height": 1.0}, {}, 256, 64,
                       {"scale_rotation": True, "scale_rot_lp_resolution": 64,
                        "scale_rot_magnitude": 20.0}),
}
SCALE_TOL = 1e-3  # tests/test_torch_node_modes.py: scale 1e-3, rotation 1e-3 rad
YAW_RATE_TOL = 1e-3 / DT
VZ_TOL = 1e-3 / DT * 2.0


def _events(tracker: bool):
    """(handler, message) pairs: camera info, then per frame IMU, odometry,
    height (``HEIGHTS``), the tracker status (``TRACKERS``) when asked, and a
    BGR image rendered at 2 m, moving at ``V_TRUE``."""
    scene = SyntheticScene(width=320, height_px=288, uav_height=2.0, seed=3)
    events = [("on_camera_info", scene.camera_info())]
    for i in range(N_FRAMES):
        t = 100.0 + i * DT
        gray = scene.render_pose((V_TRUE[0] * i * DT, V_TRUE[1] * i * DT))
        bgr = np.repeat(np.clip(np.rint(gray), 0, 255).astype(np.uint8)[..., None], 3, axis=-1)
        events += [
            ("on_imu", Imu(stamp=t, angular_velocity=(0.0, 0.0, 0.0), orientation=(0.0, 0.0, 0.0, 1.0))),
            ("on_odometry", Odometry(stamp=t, orientation=(0.0, 0.0, 0.0, 1.0),
                                     linear_velocity=(V_TRUE[0], V_TRUE[1], 0.0))),
            ("on_height", Float64Stamped(stamp=t, value=HEIGHTS[i])),
        ]
        if tracker:
            events.append(("on_tracker_status", TrackerStatus(active_tracker=TRACKERS[i])))
        events.append(("on_image", ImageMsg(stamp=t, data=bgr)))
    return events


TOPICS = ("velocity_out", "velocity_out_longrange", "velocity_out_longrange_diff", "points_raw_out",
          "scale_rotation_out")


def _drive(node, events, published):
    for handler, msg in events:
        getattr(node, handler)(msg)
    return {topic: [m for t, m in published if t == topic] for topic in TOPICS}


def _run_both(case):
    of, tpu, frame, patch, top = NODE_CASES[case]
    events = _events(tracker=of["long_range_mode"] == "takeoff_based")
    published = []
    config = NodeConfig(frame_size=frame, sample_point_size=patch, **of, **tpu, **top)
    node = OpticFlowNode(config, device="cpu", publish=lambda t, m: published.append((t, m)),
                         log=lambda s: None)
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    ours = _drive(node, events, published)
    published_j = []
    overrides = {"mrs_optic_flow": dict(of, frame_size=frame, sample_point_size=patch), "tpu": tpu,
                 **top}
    jnode = JaxNode(load_config(overrides=overrides),
                    publish=lambda t, m: published_j.append((t, m)), log=lambda s: None)
    jnode.set_transforms((0.0, 0.0, 0.0, 1.0))
    theirs = _drive(jnode, events, published_j)
    assert NodeConfig.from_optic_flow_config(jnode.config) == config
    return node, ours, theirs


@pytest.mark.parametrize("case", sorted(NODE_CASES))
def test_long_range_node_matches_jax(case):
    node, ours, theirs = _run_both(case)
    # frame 0 primes the node; three of frames 1-7 are long range: the
    # height is below takeoff_height at frames 3-5, the landoff tracker is
    # active up to frame 3
    assert len(ours["velocity_out_longrange"]) == 3
    assert len(ours["velocity_out"]) == N_FRAMES - 1 - 3
    for topic in TOPICS[:3]:
        a, b = ours[topic], theirs[topic]
        assert [tw.stamp for tw in a] == [tw.stamp for tw in b], topic
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.linear, y.linear, atol=TWIST_TOL, rtol=0, equal_nan=True)
            np.testing.assert_allclose(x.covariance, y.covariance, rtol=1e-6)
            assert x.frame_id == y.frame_id
    for tw in ours["velocity_out_longrange"] + ours["velocity_out_longrange_diff"]:
        assert tw.frame_id == "fcu" and np.isnan(tw.linear[2]) and np.isnan(tw.angular).all()
        assert tw.covariance[14] == 666.0 and tw.covariance[21] == 666.0
    for a, b in zip(ours["points_raw_out"], theirs["points_raw_out"], strict=True):
        np.testing.assert_allclose(a, np.asarray(b), atol=SHIFT_TOL, rtol=0)
    # scale/rotation: one message a processed frame, short and long range
    sr = NODE_CASES[case][4].get("scale_rotation", False)
    assert len(ours["scale_rotation_out"]) == (N_FRAMES - 1 if sr else 0)
    assert [m["stamp"] for m in ours["scale_rotation_out"]] == [m["stamp"] for m in theirs["scale_rotation_out"]]
    for a, b in zip(ours["scale_rotation_out"], theirs["scale_rotation_out"]):
        assert a["frame_id"] == b["frame_id"]
        for key, tol in (("scale", SCALE_TOL), ("yaw_rate", YAW_RATE_TOL), ("vz", VZ_TOL)):
            np.testing.assert_allclose(a[key], b[key], atol=tol, rtol=0, equal_nan=True)
    assert node.health["frames_processed"] == N_FRAMES - 1


def test_long_range_frames_draw_no_random_numbers():
    """The long-range step takes no RANSAC draws: an always-on node's
    generator is where it started after a stream."""
    published = []
    node = OpticFlowNode(NodeConfig(frame_size=256, sample_point_size=64, long_range_mode="always_on"),
                         publish=lambda t, m: published.append((t, m)), log=lambda s: None, device="cpu")
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    state = node._gen.get_state()
    ours = _drive(node, _events(tracker=False)[:13], published)
    assert len(ours["velocity_out_longrange"]) == 2 and not ours["velocity_out"]
    assert torch.equal(node._gen.get_state(), state)


def test_warmup_runs_both_modes_and_leaves_the_stream_untouched():
    published = []
    node = OpticFlowNode(NodeConfig(frame_size=240, sample_point_size=60, long_range_mode="height_based"),
                         publish=lambda t, m: published.append((t, m)), log=lambda s: None, device="cpu")
    node.on_camera_info(SyntheticScene(width=320, height_px=288).camera_info())
    steps = []
    for name in ("step", "step_long_range"):
        fn = getattr(node.engine, name)
        setattr(node.engine, name, lambda *a, _fn=fn, _name=name: steps.append(_name) or _fn(*a))
    gen_state = node._gen.get_state()
    node.warmup(image_shape=(288, 320, 3))
    assert steps == ["step", "step_long_range"]
    assert not published
    assert node.flow_state.first and node.first_image and not node.got_height
    assert node.health == {"frames_processed": 0, "consecutive_failures": 0, "ready": False}
    assert torch.equal(node._gen.get_state(), gen_state)


@pytest.mark.parametrize(
    "mode,height,tracker,expect",
    [("always_off", 0.1, None, False), ("always_on", 9.0, None, True),
     ("height_based", 0.5, None, True), ("height_based", 1.5, None, False),
     ("takeoff_based", 0.1, "LandoffTracker", True), ("takeoff_based", 0.1, "MpcTracker", False),
     ("takeoff_based", 0.1, None, False)],
)
def test_resolve_long_range_policies(mode, height, tracker, expect):
    node = OpticFlowNode(NodeConfig(frame_size=128, sample_point_size=32, long_range_mode=mode,
                                    takeoff_height=1.0), log=lambda s: None, device="cpu")
    node.on_height(Float64Stamped(stamp=1.0, value=height))
    if tracker is not None:
        node.on_tracker_status(TrackerStatus(active_tracker=tracker))
    assert node._resolve_long_range() is expect
