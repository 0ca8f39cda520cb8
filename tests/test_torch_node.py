"""The slice end to end: the port's OpticFlowNode against the JAX node on the
CPU, driven by the same synthetic event stream (``runtime/stream.py``):
frame 256 cut from 320x288 frames, 4x4 windows of 64 px.

With every window a RANSAC inlier, the consensus refit does not depend on
which hypotheses were drawn, so the two nodes' different random draws give
the same twist; 1e-3 m/s covers float32 math in another order.  The angular
rate is compared by magnitude: for the near-identity rotations of level
flight tf2's ``getAxis`` switches to the axis (1, 0, 0) below a threshold
(``geometry/rotations.py::quat_axis_angle``), so the components of a rate of
a few hundredths of a rad/s flip with float rounding while its magnitude
does not.
"""

import numpy as np
import pytest
from torch_parity import to_numpy

from mrs_optic_flow_tpu.config import load_config
from mrs_optic_flow_tpu.runtime import FrameStream, SyntheticScene
from mrs_optic_flow_tpu.runtime import OpticFlowNode as JaxNode
from mrs_optic_flow_tpu_torch.config import NodeConfig
from mrs_optic_flow_tpu_torch.runtime.msgs import Float64Stamped, ImageMsg, Imu, Odometry
from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode

V_TRUE = (0.8, -0.5)
N_FRAMES = 8
CHECKPOINT_AFTER = 4  # frames
TWIST_PARITY = 1e-3  # m/s
TWIST_BUDGET = 0.15  # m/s, as tests/test_node.py
OVERRIDES = {"mrs_optic_flow": {"frame_size": 256, "sample_point_size": 64}}


class _Collect:
    """Takes the place of a FrameStream to record the scene's events."""

    def __init__(self):
        self.events = []

    def add(self, kind, stamp, msg):
        self.events.append((stamp, len(self.events), kind, msg))
        return self


def _events():
    """The stream's events in FrameStream's dispatch order, as (handler
    name, message)."""
    scene = SyntheticScene(width=320, height_px=288, uav_height=2.0, seed=3)
    rec = _Collect()
    scene.trajectory_events(rec, velocity=V_TRUE, n_frames=N_FRAMES, dt=0.05)
    return [(FrameStream.KIND_DISPATCH[kind], msg) for _, _, kind, msg in sorted(rec.events,
                                                                          key=lambda e: e[:2])]


def _drive(node, events, published, checkpoint=None):
    """Dispatch ``events``; after the ``CHECKPOINT_AFTER``-th image, save the
    node's state to ``checkpoint`` when given."""
    images = 0
    for handler, msg in events:
        getattr(node, handler)(msg)
        if handler == "on_image":
            images += 1
            if checkpoint is not None and images == CHECKPOINT_AFTER:
                node.save_state(checkpoint)
    return {topic: [m for t, m in published if t == topic]
            for topic in ("velocity_out", "points_raw_out", "allsac_chosen_out")}


def _port_node(published, config=None):
    node = OpticFlowNode(config or NodeConfig(frame_size=256, sample_point_size=64),
                         publish=lambda t, m: published.append((t, m)), log=lambda s: None, device="cpu")
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    return node


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX node over the whole stream, checkpointed part-way."""
    published = []
    node = JaxNode(load_config(overrides=OVERRIDES),
                   publish=lambda t, m: published.append((t, m)), log=lambda s: None)
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    checkpoint = str(tmp_path_factory.mktemp("ckpt") / "jax_node.npz")
    return _drive(node, _events(), published, checkpoint), checkpoint


def _assert_twists_agree(ours, theirs):
    assert [tw.stamp for tw in ours] == [tw.stamp for tw in theirs]
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.linear, b.linear, atol=TWIST_PARITY, rtol=0)
        assert abs(np.linalg.norm(a.angular) - np.linalg.norm(b.angular)) <= TWIST_PARITY
        np.testing.assert_allclose(a.covariance, b.covariance, rtol=1e-6)
        assert a.frame_id == b.frame_id


def test_node_matches_jax_node(jax_run):
    theirs, _ = jax_run
    published = []
    ours = _drive(_port_node(published), _events(), published)
    assert len(ours["velocity_out"]) == N_FRAMES - 1
    _assert_twists_agree(ours["velocity_out"], theirs["velocity_out"])
    assert ours["allsac_chosen_out"] == theirs["allsac_chosen_out"]
    for a, b in zip(ours["points_raw_out"], theirs["points_raw_out"], strict=True):
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)
    for twists in (ours["velocity_out"], theirs["velocity_out"]):
        # the first twist is the first-frame copy (zero shift)
        v = np.array([tw.linear[:2] for tw in twists[1:]])
        assert np.all(np.abs(v - np.array(V_TRUE)) < TWIST_BUDGET), v


def test_resume_from_jax_checkpoint(jax_run):
    theirs, checkpoint = jax_run
    published = []
    node = _port_node(published)
    node.load_state(checkpoint)
    assert node.got_camera_info and node.got_height and not node.first_image
    events = _events()
    images = [i for i, (handler, _) in enumerate(events) if handler == "on_image"]
    ours = _drive(node, events[images[CHECKPOINT_AFTER - 1] + 1:], published)
    assert len(ours["velocity_out"]) == N_FRAMES - CHECKPOINT_AFTER
    # the JAX node's first twist comes from its second frame
    _assert_twists_agree(ours["velocity_out"], theirs["velocity_out"][CHECKPOINT_AFTER - 1:])


def test_checkpoint_round_trip_and_geometry_check(tmp_path):
    node = _port_node([])
    node.on_camera_info(SyntheticScene(width=320, height_px=288).camera_info())
    node.on_height(Float64Stamped(stamp=1.0, value=2.0))
    path = str(tmp_path / "port")
    node.save_state(path)
    other = _port_node([])
    other.load_state(path)
    np.testing.assert_array_equal(other.camera_matrix, node.camera_matrix)
    assert other.got_height and other.uav_height == 2.0 and other.first_image
    small = _port_node([], NodeConfig(frame_size=128, sample_point_size=64))
    with pytest.raises(ValueError, match="geometry"):
        small.load_state(path)


@pytest.mark.parametrize(
    "fields",
    [{"host_preprocess": True, "long_range_mode": "height_based"}, {"host_preprocess": True},
     {"gui": True}, {"store_video": True}],
)
def test_unsupported_configs_raise(fields):
    """No option of the JAX node is refused any more: host preprocessing,
    the GUI and video recording construct (``test_torch_node_options.py``
    drives them)."""
    node = OpticFlowNode(NodeConfig(**fields), device="cpu", log=lambda s: None)
    assert all(getattr(node.config, k) == v for k, v in fields.items())
    node.close()


def test_warmup_leaves_the_stream_untouched():
    published = []
    node = _port_node(published)
    node.on_camera_info(SyntheticScene(width=320, height_px=288).camera_info())
    gen_state = node._gen.get_state()
    node.warmup(image_shape=(288, 320, 3))
    assert not published
    assert node.flow_state.first and node.first_image and not node.got_height
    assert node.health == {"frames_processed": 0, "consecutive_failures": 0, "ready": False}
    assert bool((node._gen.get_state() == gen_state).all())
    with pytest.raises(RuntimeError, match="camera info"):
        _port_node([]).warmup()


def test_gates_and_fault_containment():
    published = []
    node = _port_node(published)
    assert node.on_image(ImageMsg(stamp=1.0, data=np.zeros((288, 320), np.float32))) is None
    assert not [m for t, m in published if t == "velocity_out"]  # no odometry yet
    node.on_camera_info(SyntheticScene(width=320, height_px=288).camera_info())
    node.on_imu(Imu(stamp=1.0, angular_velocity=(0, 0, 0), orientation=(0, 0, 0, 1)))
    node.on_odometry(Odometry(stamp=1.0, orientation=(0, 0, 0, 1)))
    node.on_height(Float64Stamped(stamp=1.0, value=2.0))
    assert node.on_image(ImageMsg(stamp=1.0, data=np.zeros((288, 320), np.uint8))) is None
    # an image too small for the crop fails inside the frame, contained
    assert node.on_image(ImageMsg(stamp=1.1, data=np.zeros((100, 100), np.uint8))) is None
    assert node.health["consecutive_failures"] == 1
    assert [t for t, _ in published].count("processing_latency_out") == 2
    assert to_numpy(node.flow_state.prev).shape == (256, 256)
