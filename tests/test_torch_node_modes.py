"""The port's OpticFlowNode in its newer modes against the JAX node on the
CPU, on the same event stream: a nadir camera over the synthetic scene
(``runtime/stream.py``) that yaws and descends while it translates.

- method 4 with ``scale_rotation`` (frame 128 cut from 160x144 frames, 4x4
  windows of 32 px, log-polar 64, magnitude 20 to suit the frame) and
  ``raw_output``, checkpoints read across packages in both directions, the
  tilt gate, and warmup;
- methods 3 and 5 with each ``filter_method`` (frame 96, blocks 24, radius
  8, step 8), one of them with scale/rotation;
- the full ordered publish log (every topic, in order) with ``raw_output``
  and ``scale_rotation`` in short range, long range and method 5: the raw
  shifts go out before the scale/rotation message, as in the JAX node
  (repair F7);
- ``scale_factor`` 1.5 and 0.8 on raw 752x480 frames, the port's config
  copied from the JAX loader's (frame and patch divided by the factor:
  320/80 through kernel A's twin, 600/150 through kernel D's): raw shifts
  within 1e-3 px; twists within SCALE_FACTOR_TWIST_TOL, since the two
  packages draw different RANSAC hypotheses and the 752x480 stream at
  fx 100 leaves windows outside the consensus (at factor 1 the same stream
  agrees within 6e-4 m/s, at 1.5 within 3.3e-3).

Tolerances: twists 1e-3 m/s and raw shifts 1e-3 px as in
``tests/test_torch_node.py``.  On the yawing method-4 stream some windows
fall outside RANSAC's consensus, so the nodes' different random draws give
different twists: there only the raw shifts and the stamps are compared
(``tests/test_torch_node.py`` holds method-4 twists on a stream where every
window is an inlier).  The scale 1e-3 and the rotation 1e-3 rad of
``tests/test_torch_scale_rotation.py``, i.e. 0.02 rad/s of yaw rate and
0.04 m/s of vz at dt 0.05 s and h <= 2 m.  The JAX SAD engines run their
``lax.scan`` route (``tpu.use_pallas: false``): the Pallas kernel compiles
slowly in interpret mode, and ``tests/test_torch_block_matching.py`` holds
kernel C's twin to both exactly.
"""

import numpy as np
import pytest
import torch
from torch_parity import to_numpy

from mrs_optic_flow_tpu.config import load_config
from mrs_optic_flow_tpu.runtime import OpticFlowNode as JaxNode
from mrs_optic_flow_tpu.runtime import SyntheticScene
from mrs_optic_flow_tpu_torch.config import NodeConfig
from mrs_optic_flow_tpu_torch.runtime.msgs import Float64Stamped, ImageMsg, Imu, Odometry
from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode

N_FRAMES = 8
CHECKPOINT_AFTER = 4  # images
DT = 0.05
TWIST_TOL = 1e-3
SCALE_TOL = 1e-3
YAW_RATE_TOL = 1e-3 / DT
VZ_TOL = 1e-3 / DT * 2.0
SR_OVERRIDES = {
    "scale_rotation": True, "scale_rot_lp_resolution": 64, "scale_rot_magnitude": 20.0,
    "mrs_optic_flow": {"frame_size": 128, "sample_point_size": 32},
}
SR_CONFIG = NodeConfig(scale_rotation=True, scale_rot_lp_resolution=64, scale_rot_magnitude=20.0,
                       frame_size=128, sample_point_size=32)
BM_GEOMETRY = {"frame_size": 96, "sample_point_size": 24, "scan_radius": 8, "step_size": 8}


def _events(width, height_px, *, yaw_step, descent, tilt_last=False):
    """(handler, message) pairs: camera info, then per frame IMU, odometry,
    height and a BGR image.  With ``tilt_last`` the last frame's IMU
    reports a roll of 0.1 rad, beyond ``scale_rot_max_tilt``."""
    scene = SyntheticScene(width=width, height_px=height_px, fx=100.0, fy=100.0, seed=3)
    events = [("on_camera_info", scene.camera_info())]
    v = (0.4, -0.3)
    for i in range(N_FRAMES):
        t = 100.0 + i * DT
        h = 2.0 - descent * i
        roll = 0.1 if tilt_last and i == N_FRAMES - 1 else 0.0
        q = (np.sin(roll / 2), 0.0, 0.0, np.cos(roll / 2))
        gray = scene.render_pose((v[0] * i * DT, v[1] * i * DT), rpy=(0.0, 0.0, yaw_step * i), height=h)
        bgr = np.repeat(np.clip(np.rint(gray), 0, 255).astype(np.uint8)[..., None], 3, axis=-1)
        events += [
            ("on_imu", Imu(stamp=t, angular_velocity=(0.0, 0.0, 0.0), orientation=q)),
            ("on_odometry", Odometry(stamp=t, orientation=(0.0, 0.0, 0.0, 1.0),
                                     linear_velocity=(v[0], v[1], 0.0))),
            ("on_height", Float64Stamped(stamp=t, value=h)),
            ("on_image", ImageMsg(stamp=t, data=bgr)),
        ]
    return events


def _drive(node, events, published, checkpoint=None):
    images = 0
    for handler, msg in events:
        getattr(node, handler)(msg)
        if handler == "on_image":
            images += 1
            if checkpoint is not None and images == CHECKPOINT_AFTER:
                node.save_state(checkpoint)
    return {topic: [m for t, m in published if t == topic]
            for topic in ("velocity_out", "points_raw_out", "scale_rotation_out")}


def _after_checkpoint(events):
    images = [i for i, (handler, _) in enumerate(events) if handler == "on_image"]
    return events[images[CHECKPOINT_AFTER - 1] + 1:]


def _port_node(config, published):
    node = OpticFlowNode(config, device="cpu", publish=lambda t, m: published.append((t, m)),
                         log=lambda s: None)
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    return node


def _jax_node(overrides, published):
    node = JaxNode(load_config(overrides=overrides),
                   publish=lambda t, m: published.append((t, m)), log=lambda s: None)
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    return node


def _assert_sr_agree(ours, theirs):
    assert [m["stamp"] for m in ours] == [m["stamp"] for m in theirs]
    for a, b in zip(ours, theirs):
        assert a["frame_id"] == b["frame_id"]
        for key, tol in (("scale", SCALE_TOL), ("yaw_rate", YAW_RATE_TOL), ("vz", VZ_TOL)):
            np.testing.assert_allclose(a[key], b[key], atol=tol, rtol=0, equal_nan=True)


def _assert_twists_agree(ours, theirs):
    assert [tw.stamp for tw in ours] == [tw.stamp for tw in theirs]
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.linear, b.linear, atol=TWIST_TOL, rtol=0, equal_nan=True)
        ang_a, ang_b = np.asarray(a.angular), np.asarray(b.angular)
        np.testing.assert_array_equal(np.isnan(ang_a), np.isnan(ang_b))
        if np.isfinite(ang_a).all():
            # see tests/test_torch_node.py on comparing rates by magnitude
            assert abs(np.linalg.norm(ang_a) - np.linalg.norm(ang_b)) <= TWIST_TOL
        assert a.frame_id == b.frame_id


@pytest.fixture(scope="module")
def sr_runs(tmp_path_factory):
    """The method-4 scale/rotation stream through the port node and the JAX
    node, each checkpointed after CHECKPOINT_AFTER images; then the JAX node
    resumes from the port's checkpoint and replays the rest."""
    tmp = tmp_path_factory.mktemp("sr")
    events = _events(160, 144, yaw_step=0.05, descent=0.025, tilt_last=True)
    published = []
    port_ckpt = str(tmp / "port.npz")
    ours = _drive(_port_node(SR_CONFIG, published), events, published, port_ckpt)
    published = []
    jax_ckpt = str(tmp / "jax.npz")
    node = _jax_node(SR_OVERRIDES, published)
    theirs = _drive(node, events, published, jax_ckpt)
    published.clear()
    node.load_state(port_ckpt)
    jax_resumed = _drive(node, _after_checkpoint(events), published)
    return events, ours, theirs, jax_resumed, jax_ckpt


def test_config_copies_the_new_fields():
    assert NodeConfig.from_optic_flow_config(load_config(overrides=SR_OVERRIDES)) == SR_CONFIG
    cfg = load_config(overrides={"mrs_optic_flow": {"method": 5, "filter_method": "ransac",
                                                    "ransac": {"num_of_iter": 20}},
                                 "tpu": {"use_pallas": False}})
    nc = NodeConfig.from_optic_flow_config(cfg)
    assert (nc.method, nc.filter_method, nc.ransac_num_of_iter) == (5, "ransac", 20)
    assert nc.use_pallas_explicit and not nc.use_pallas


def test_scale_rotation_node_matches_jax(sr_runs):
    _, ours, theirs, _, _ = sr_runs
    assert len(ours["scale_rotation_out"]) == N_FRAMES - 1
    _assert_sr_agree(ours["scale_rotation_out"], theirs["scale_rotation_out"])
    first, gated = ours["scale_rotation_out"][0], ours["scale_rotation_out"][-1]
    assert first["scale"] == 1.0 and first["yaw_rate"] == 0.0  # the estimator's first frame
    assert np.isnan(gated["scale"]) and np.isnan(gated["yaw_rate"])  # the tilt gate
    assert [tw.stamp for tw in ours["velocity_out"]] == [tw.stamp for tw in theirs["velocity_out"]]


def test_raw_output_with_scale_rotation(sr_runs):
    _, ours, theirs, _, _ = sr_runs
    assert len(ours["points_raw_out"]) == N_FRAMES - 1
    for a, b in zip(ours["points_raw_out"], theirs["points_raw_out"], strict=True):
        assert a.shape == (16, 2)
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)


def test_port_resumes_from_jax_checkpoint(sr_runs):
    events, _, theirs, _, jax_ckpt = sr_runs
    published = []
    node = _port_node(SR_CONFIG, published)
    node.load_state(jax_ckpt)
    assert node.scale_rot_state.first is False
    assert node.scale_rot_state.prev_logpolar.dtype == torch.uint8
    ours = _drive(node, _after_checkpoint(events), published)
    k = CHECKPOINT_AFTER - 1  # the JAX node's first output comes from its second image
    _assert_sr_agree(ours["scale_rotation_out"], theirs["scale_rotation_out"][k:])
    assert ours["scale_rotation_out"][0]["scale"] != 1.0  # the carry, not a first frame


def test_jax_resumes_from_port_checkpoint(sr_runs):
    _, ours, _, jax_resumed, _ = sr_runs
    k = CHECKPOINT_AFTER - 1
    _assert_sr_agree(jax_resumed["scale_rotation_out"], ours["scale_rotation_out"][k:])
    for a, b in zip(jax_resumed["points_raw_out"], ours["points_raw_out"][k:], strict=True):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-3, rtol=0)


def test_log_polar_carry_geometry_and_dtype(tmp_path, sr_runs):
    *_, jax_ckpt = sr_runs
    other = _port_node(NodeConfig(scale_rotation=True, scale_rot_lp_resolution=32,
                                  frame_size=128, sample_point_size=32), [])
    with pytest.raises(ValueError, match="log-polar"):
        other.load_state(jax_ckpt)
    float_carry = _port_node(NodeConfig(scale_rotation=True, scale_rot_lp_resolution=64,
                                        frame_size=128, sample_point_size=32,
                                        quantize_8bit=False), [])
    float_carry.load_state(jax_ckpt)
    assert float_carry.scale_rot_state.prev_logpolar.dtype == torch.float32
    assert float_carry.flow_state.prev.dtype == torch.float32
    plain = _port_node(NodeConfig(frame_size=128, sample_point_size=32), [])
    plain.load_state(jax_ckpt)  # a node without the estimator ignores the carry
    assert plain.scale_rot_state is None


def test_warmup_leaves_the_scale_rotation_carry_alone():
    events = _events(160, 144, yaw_step=0.05, descent=0.025)
    published = []
    node = _port_node(SR_CONFIG, published)
    _drive(node, events[:9], published)  # camera info and two frames
    state = node.scale_rot_state
    assert state.first is False
    node.warmup(image_shape=(144, 160, 3))
    assert node.scale_rot_state is state
    assert torch.equal(node.scale_rot_state.prev_logpolar, state.prev_logpolar)


BM_CASES = [(3, "allsac", False), (3, "ransac", False), (3, "average", False),
            (5, "allsac", False), (5, "ransac", False), (5, "average", True)]


@pytest.mark.parametrize("method,filter_method,scale_rotation", BM_CASES)
def test_block_matching_node_matches_jax(method, filter_method, scale_rotation):
    events = _events(128, 112, yaw_step=0.0, descent=0.0)
    sr = dict(scale_rotation=scale_rotation, scale_rot_lp_resolution=32, scale_rot_magnitude=12.0)
    config = NodeConfig(method=method, filter_method=filter_method, **BM_GEOMETRY, **sr)
    published = []
    ours = _drive(_port_node(config, published), events, published)
    overrides = {"mrs_optic_flow": dict(BM_GEOMETRY, method=method, filter_method=filter_method),
                 "tpu": {"use_pallas": False}, **sr}
    published = []
    theirs = _drive(_jax_node(overrides, published), events, published)

    assert len(ours["velocity_out"]) == N_FRAMES - 1
    _assert_twists_agree(ours["velocity_out"], theirs["velocity_out"])
    for tw in ours["velocity_out"]:
        assert np.isnan(tw.linear[2]) and np.isnan(tw.angular).all()
        assert tw.frame_id == "fcu"
    for a, b in zip(ours["points_raw_out"], theirs["points_raw_out"], strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
    if scale_rotation:
        _assert_sr_agree(ours["scale_rotation_out"], theirs["scale_rotation_out"])
        assert len(ours["scale_rotation_out"]) == N_FRAMES - 1
    # the last twists: the truth is (0.4, -0.3) m/s, 1 px of flow per frame
    # is 0.4 m/s at this focal length, and the SAD engines quantize to
    # whole pixels (method 3 refines to a quarter pixel)
    v = np.array([tw.linear[:2] for tw in ours["velocity_out"][1:]])
    assert np.all(np.abs(v - [0.4, -0.3]) <= 0.4), v


@pytest.mark.parametrize(
    "field,value",
    [("method", 3), ("scale_rotation", True), ("use_pallas", False), ("backend", "fft"),
     ("long_range_mode", "height_based")],
)
def test_newly_supported_configs_construct(field, value):
    node = OpticFlowNode(NodeConfig(**{field: value}), device="cpu")
    assert (node.scale_rotation_estimator is not None) == (field == "scale_rotation")
    assert to_numpy(node.flow_state.prev).shape == (480, 480)


#: (port config, JAX overrides) of the publish-order cases, all with
#: raw_output (the default) and scale_rotation
ORDER_CASES = {
    "short range": (SR_CONFIG, SR_OVERRIDES),
    "long range": (
        NodeConfig(scale_rotation=True, scale_rot_lp_resolution=64, scale_rot_magnitude=20.0,
                   frame_size=128, sample_point_size=32, long_range_mode="always_on"),
        {**SR_OVERRIDES, "mrs_optic_flow": {"frame_size": 128, "sample_point_size": 32,
                                            "long_range_mode": "always_on"}}),
    "method 5": (
        NodeConfig(method=5, scale_rotation=True, scale_rot_lp_resolution=32, scale_rot_magnitude=12.0,
                   **BM_GEOMETRY),
        {"mrs_optic_flow": dict(BM_GEOMETRY, method=5), "tpu": {"use_pallas": False},
         "scale_rotation": True, "scale_rot_lp_resolution": 32, "scale_rot_magnitude": 12.0}),
}


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_publish_log_order_matches_jax(case):
    config, overrides = ORDER_CASES[case]
    assert config.raw_output and config.scale_rotation
    events = _events(160, 144, yaw_step=0.02, descent=0.01)
    logs = []
    for make in (lambda pub: _port_node(config, pub), lambda pub: _jax_node(overrides, pub)):
        published = []
        _drive(make(published), events, published)
        logs.append([topic for topic, _ in published])
    ours, theirs = logs
    assert ours == theirs
    # every processed frame: the raw shifts, then scale/rotation
    raw = [i for i, t in enumerate(ours) if t == "points_raw_out"]
    sr = [i for i, t in enumerate(ours) if t == "scale_rotation_out"]
    assert len(raw) == len(sr) == N_FRAMES - 1 and all(r < s for r, s in zip(raw, sr))


SCALE_FACTOR_TWIST_TOL = 1e-2  # m/s


@pytest.mark.parametrize("factor,frame,patch", [(1.5, 320, 80), (0.8, 600, 150)])
def test_scale_factor_node_matches_jax(factor, frame, patch):
    overrides = {"mrs_optic_flow": {"scale_factor": factor}, "tpu": {"use_pallas": False}}
    config = NodeConfig.from_optic_flow_config(load_config(overrides=overrides))
    assert (config.scale_factor, config.frame_size, config.sample_point_size) == (factor, frame, patch)
    events = _events(752, 480, yaw_step=0.0, descent=0.0)
    published = []
    ours = _drive(_port_node(config, published), events, published)
    published = []
    theirs = _drive(_jax_node(overrides, published), events, published)
    assert len(ours["points_raw_out"]) == N_FRAMES - 1
    for a, b in zip(ours["points_raw_out"], theirs["points_raw_out"], strict=True):
        assert a.shape == (16, 2)
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-3, rtol=0)
    twists = ours["velocity_out"]
    assert len(twists) == N_FRAMES - 1
    assert [tw.stamp for tw in twists] == [tw.stamp for tw in theirs["velocity_out"]]
    for a, b in zip(twists, theirs["velocity_out"]):
        np.testing.assert_allclose(a.linear, b.linear, atol=SCALE_FACTOR_TWIST_TOL, rtol=0)
        assert a.frame_id == b.frame_id
