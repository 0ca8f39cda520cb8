"""The node's frame chain on static buffers (``runtime/frame_graph.py``) on
the CPU, where the same body runs that a CUDA graph captures on the card.

- A 21-image stream (20 frames through the chain) through the node equals,
  message by message, the same stream through a node whose chain is the
  eager one it replaces (:func:`_eager`: the frame and the parameters
  uploaded a frame, ``_frame_step``, ``_frame_step_lr`` or
  ``_frame_step_simple`` called on the node's carries, the states handed
  back by reference, one readback), both drawing from generators seeded 0:
  method 4, a ``height_based`` stream that switches mode twice, method 3
  with ``ransac``, method 5 with ``allsac`` and method 4 with
  scale/rotation, and each option that changes the device chain: method 5
  with ``average`` and with ``ransac``, ``scale_factor`` 0.8 and 1.5,
  ``raw_output: false``, ``backend: fft`` with scale/rotation, ``use_pallas:
  false``, ``quantize_8bit: false``, ``scale_rot_interp: bilinear`` and
  ``long_range_ratio: 2``.  Tolerance 0: the two run the same operations
  on the same values.
- ``warmup()`` leaves the carries' values and the generator as they were:
  a node warmed mid-stream publishes what an unwarmed one does; warmed at
  the stream's frame shape, every mode's steady frames run on keys that
  warm-up made.
- ``save_state`` mid-stream, ``load_state`` into a fresh node (given the
  generator's state, which the checkpoint format does not hold) and on:
  the node that flew the whole way.
- The runner's own rules, on stand-ins for ``torch.cuda``'s graph API: a
  key's first steady frame runs eagerly and captures, later ones replay;
  each replay adds the launches its capture counted, which are taken back
  from the capture; the slot holds the tensors the capture read and did
  not make; a capture that raises fails the frame, keeps no graph and
  captures again at the key's next frame.
- The streams against the JAX node (``JAX_CHECKS``): raw window shifts
  within 1e-3 px and twists within 1e-3 m/s (``tests/test_torch_node.py``'s
  tolerances on a stream where every window is a RANSAC inlier), except
  where a comment there gives the reason for another bound or for
  comparing the raw shifts alone.
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

from mrs_optic_flow_tpu.config import load_config
from mrs_optic_flow_tpu.runtime import OpticFlowNode as JaxNode
from mrs_optic_flow_tpu_torch.config import NodeConfig
from mrs_optic_flow_tpu_torch.config import load_config as load_port_config
from mrs_optic_flow_tpu_torch.ops import cuda_kernels
from mrs_optic_flow_tpu_torch.runtime import frame_graph
from mrs_optic_flow_tpu_torch.runtime import node as node_module
from mrs_optic_flow_tpu_torch.runtime.frame_graph import FrameGraphs, FrameSlot
from mrs_optic_flow_tpu_torch.runtime.msgs import Float64Stamped, ImageMsg, Imu, Odometry
from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode
from mrs_optic_flow_tpu_torch.runtime.stream import SyntheticScene

N_IMAGES = 21  # the first primes the stream: 20 frames through the chain
DT = 0.05
V = (0.4, -0.3)  # m/s: 1 and 0.75 px a frame at fx 100, 2 m
#: heights crossing takeoff_height 1.0 m both ways: two switches
SWITCH_HEIGHTS = [1.5] * 7 + [0.8] * 7 + [1.4] * 7
M4 = dict(frame_size=128, sample_point_size=32)
BM = dict(frame_size=96, sample_point_size=24, scan_radius=8, step_size=8)
SR = {"scale_rotation": True, "scale_rot_lp_resolution": 64, "scale_rot_magnitude": 20.0}
SR_STREAM = {"yaw_step": 0.03, "descent": 0.02}
LOW = {"heights": [0.8] * N_IMAGES}
#: mode -> (the YAML's overrides of configs/default.yaml, which both
#: packages' loaders normalise alike: a scale_factor divides frame and
#: patch, 128/32 -> 160/40 at 0.8 and 84/21 at 1.5; the stream)
MODES = {
    "method4": ({"mrs_optic_flow": M4}, {}),
    "height_based": ({"mrs_optic_flow": dict(M4, long_range_mode="height_based", takeoff_height=1.0)},
                     {"heights": SWITCH_HEIGHTS}),
    "method3_ransac": ({"mrs_optic_flow": dict(BM, method=3, filter_method="ransac")}, {}),
    "method5_allsac": ({"mrs_optic_flow": dict(BM, method=5, filter_method="allsac")}, {}),
    "scale_rotation": ({"mrs_optic_flow": M4, **SR}, SR_STREAM),
    # each option that changes the device chain, alone
    "method5_average": ({"mrs_optic_flow": dict(BM, method=5, filter_method="average")}, {}),
    "method5_ransac": ({"mrs_optic_flow": dict(BM, method=5, filter_method="ransac")}, {}),
    "scale_0.8": ({"mrs_optic_flow": dict(M4, scale_factor=0.8)}, {}),
    "scale_1.5": ({"mrs_optic_flow": dict(M4, scale_factor=1.5)}, {}),
    "raw_off": ({"mrs_optic_flow": M4, "raw_output": False}, {}),
    "fft_sr": ({"mrs_optic_flow": M4, **SR, "tpu": {"backend": "fft"}}, SR_STREAM),
    "plain": ({"mrs_optic_flow": M4, "tpu": {"use_pallas": False}}, {}),
    "float_frames": ({"mrs_optic_flow": M4, "tpu": {"quantize_8bit": False}}, {}),
    "sr_bilinear": ({"mrs_optic_flow": M4, **SR, "scale_rot_interp": "bilinear"}, SR_STREAM),
    "lr_ratio_2": ({"mrs_optic_flow": dict(M4, long_range_mode="always_on"),
                    "tpu": {"long_range_ratio": 2}}, LOW),
}
COMPARED = ("velocity_out", "velocity_out_longrange", "velocity_out_longrange_diff",
            "points_raw_out", "scale_rotation_out", "allsac_chosen_out", "max_velocity_out")


def _mode(mode):
    """The port's config of ``mode`` and its stream's arguments."""
    overrides, stream = MODES[mode]
    return load_port_config(overrides=overrides), stream


def _events(*, heights=None, yaw_step=0.0, descent=0.0, n=N_IMAGES):
    """(handler, message) pairs: camera info, then per image IMU, odometry,
    height and a BGR 160x144 frame of a nadir camera moving at ``V``."""
    scene = SyntheticScene(width=160, height_px=144, fx=100.0, fy=100.0, seed=3)
    events = [("on_camera_info", scene.camera_info())]
    for i in range(n):
        t = 100.0 + i * DT
        h = heights[i] if heights is not None else 2.0 - descent * i
        gray = scene.render_pose((V[0] * i * DT, V[1] * i * DT), rpy=(0.0, 0.0, yaw_step * i), height=h)
        bgr = np.repeat(np.clip(np.rint(gray), 0, 255).astype(np.uint8)[..., None], 3, axis=-1)
        events += [
            ("on_imu", Imu(stamp=t, angular_velocity=(0.0, 0.0, 0.0), orientation=(0.0, 0.0, 0.0, 1.0))),
            ("on_odometry", Odometry(stamp=t, orientation=(0.0, 0.0, 0.0, 1.0),
                                     linear_velocity=(V[0], V[1], 0.0))),
            ("on_height", Float64Stamped(stamp=t, value=h)),
            ("on_image", ImageMsg(stamp=t, data=bgr)),
        ]
    return events


def _node(config, published):
    node = OpticFlowNode(config, device="cpu", publish=lambda t, m: published.append((t, m)),
                         log=lambda s: None)
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    return node


def _eager(node):
    """``node`` with the eager chain the static-buffer body replaces: the
    frame and ``params`` uploaded a frame, the chain's step on the node's
    carries, the new states taken by reference, the summary read back.
    Counts its steps in ``node.eager_steps``."""
    node.eager_steps = 0

    def run_chain(img, channels, params, cx_eff, simple, long_range):
        gray = node._gray(torch.from_numpy(np.array(img)).to(node.device), channels, cx_eff)
        p = torch.from_numpy(params).to(node.device)
        if simple:
            states = node._frame_step_simple(gray, p)
        elif long_range:
            states = node._frame_step_lr(gray, p)
        else:
            states = node._frame_step(gray, p, cx_eff)
        node.flow_state, node.scale_rot_state, summary, flow = states
        node.eager_steps += 1
        return summary.cpu(), gray, flow

    node._run_chain = run_chain
    return node


def _feed(node, events):
    for handler, msg in events:
        getattr(node, handler)(msg)


def _flat(msg):
    """A published message as a float vector (NaN compared as equal)."""
    if isinstance(msg, dict):
        return np.array([msg[k] for k in sorted(msg) if k != "frame_id"], np.float64)
    if hasattr(msg, "linear"):
        return np.concatenate([[msg.stamp], msg.linear, msg.angular, msg.covariance])
    return np.asarray(msg, np.float64).reshape(-1)


def _assert_same_log(ours, theirs):
    ours = [(t, m) for t, m in ours if t in COMPARED]
    theirs = [(t, m) for t, m in theirs if t in COMPARED]
    assert [t for t, _ in ours] == [t for t, _ in theirs]
    for (topic, a), (_, b) in zip(ours, theirs):
        np.testing.assert_array_equal(_flat(a), _flat(b), err_msg=topic)
        if hasattr(a, "frame_id"):
            assert a.frame_id == b.frame_id


@pytest.mark.parametrize("mode", list(MODES))
def test_stream_equals_the_eager_chain(mode):
    config, stream = _mode(mode)
    events = _events(**stream)
    ours, theirs = [], []
    node, ref = _node(config, ours), _eager(_node(config, theirs))
    _feed(node, events)
    _feed(ref, events)
    assert ref.eager_steps == N_IMAGES - 1
    # a long-range frame with one 32 px window may publish nothing; most publish
    assert sum(t in ("velocity_out", "velocity_out_longrange") for t, _ in ours) >= N_IMAGES - 3
    if mode == "height_based":
        topics = [t for t, _ in ours if t in ("velocity_out", "velocity_out_longrange")]
        switches = sum(a != b for a, b in zip(topics, topics[1:]))
        assert switches == 2
    _assert_same_log(ours, theirs)
    # the carries and the generator end where the eager chain's do
    assert torch.equal(node.flow_state.prev, ref.flow_state.prev)
    assert node.flow_state.prev is node._carry and node.flow_state.first is False
    if config.scale_rotation:
        assert torch.equal(node.scale_rot_state.prev_logpolar, ref.scale_rot_state.prev_logpolar)
        assert node.scale_rot_state.prev_logpolar is node._sr_carry
    assert torch.equal(node._gen.get_state(), ref._gen.get_state())


@pytest.mark.parametrize("mode", ["scale_rotation", "height_based"])
def test_warmup_keeps_the_carries_and_the_generator(mode):
    config, stream = _mode(mode)
    events = _events(**stream)
    half = 1 + 4 * 10  # camera info and 10 images
    warm, cold = [], []
    node, plain = _node(config, warm), _node(config, cold)
    _feed(node, events[:half])
    carry = node.flow_state.prev.clone()
    lp = node.scale_rot_state.prev_logpolar.clone() if config.scale_rotation else None
    gen = node._gen.get_state()
    node.warmup()
    assert torch.equal(node.flow_state.prev, carry)
    if lp is not None:
        assert torch.equal(node.scale_rot_state.prev_logpolar, lp)
    assert torch.equal(node._gen.get_state(), gen)
    _feed(node, events[half:])
    _feed(plain, events)
    _assert_same_log(warm, cold)


def test_warmup_sees_steady_frames_of_both_shapes_and_modes():
    """On the card these are the frames whose graphs warm-up captures: the
    raw BGR frame and the cropped gray window, in both method-4 modes, each
    with its carry set."""
    node = _node(NodeConfig(**M4), [])
    node.on_camera_info(SyntheticScene(width=160, height_px=144, fx=100.0, fy=100.0).camera_info())
    seen = []
    run = node._graphs.run

    def spy(slot, body, capture):
        seen.append((tuple(slot.frame.shape), capture))
        return run(slot, body, capture)

    node._graphs.run = spy
    node.warmup(image_shape=None)
    assert seen == [((480, 752, 3), True), ((128, 128), True)] * 2
    assert node.flow_state.first and node.first_image


def test_parameter_vector_fields():
    """Each field :func:`pack_params` packs reads back through its ``P_*``
    index or slice, the only unpacking the chains do."""
    fields = dict(height=1.5, dt=0.05, cam=np.arange(9.0).reshape(3, 3) + 10, dist=np.arange(5.0) + 20,
                  c2b=np.arange(4.0) + 30, rate_quat=np.arange(4.0) + 40, detilt=np.arange(4.0) + 50,
                  height_lr=1.6, roll_rate=0.1, pitch_rate=-0.2, cam_yaw=1.25)
    params = node_module.pack_params(**fields)
    assert params.dtype == np.float32 and params.shape == (node_module.P_CAM_YAW + 1,)
    for name, value in fields.items():
        got = params[getattr(node_module, f"P_{name.upper()}")]
        np.testing.assert_array_equal(got, np.ravel(value).astype(np.float32).reshape(np.shape(got)))


@pytest.mark.parametrize("mode", list(MODES))
def test_warmup_makes_every_key_the_stream_uses(mode):
    """A stream warmed up at its frame shape runs every steady frame on a
    key that warm-up made, so that on the card no graph is captured
    mid-stream (under scale_factor too, where the crop's column and the
    resize enter the chain)."""
    config, stream = _mode(mode)
    events = _events(**stream)
    node = _node(config, [])
    _feed(node, events[:1])
    node.warmup(image_shape=events[-1][1].data.shape)
    warm = set(node._graphs._slots)
    captured = []
    run = node._graphs.run

    def spy(slot, body, capture):
        if capture:
            captured.append(slot)
        return run(slot, body, capture)

    node._graphs.run = spy
    _feed(node, events[1:])
    assert len(captured) == N_IMAGES - 2  # every frame after the first-frame copy
    assert set(node._graphs._slots) == warm
    assert all(any(s is slot for s in node._graphs._slots.values()) for slot in captured)


@pytest.mark.parametrize("mode", ["method4", "scale_rotation", "method3_ransac"])
def test_checkpoint_mid_stream_resumes_the_stream(mode, tmp_path):
    config, stream = _mode(mode)
    events = _events(**stream)
    half = 1 + 4 * 10
    whole, first, resumed = [], [], []
    _feed(_node(config, whole), events)
    before = _node(config, first)
    _feed(before, events[:half])
    before.save_state(str(tmp_path / "mid"))
    after = _node(config, resumed)
    after.load_state(str(tmp_path / "mid"))
    # the checkpoint (the JAX node's format) holds no generator state
    after._gen.set_state(before._gen.get_state())
    after.on_camera_info(events[0][1])
    _feed(after, events[half:])
    topics = ("velocity_out", "points_raw_out", "scale_rotation_out")
    n_first = len([m for t, m in first if t in topics])
    _assert_same_log([(t, m) for t, m in whole if t in topics][n_first:],
                     [(t, m) for t, m in resumed if t in topics])


#: the JAX node's tolerances (``tests/test_torch_node.py``'s): raw window
#: shifts [px], twists [m/s], and the scale/rotation decodes as
#: ``tests/test_torch_node_modes.py`` holds them (scale; yaw rate and vz are
#: rotation and scale over dt, vz times the height)
SHIFT_TOL = TWIST_TOL = 1e-3
DECODE_TOL = {"scale": 1e-3, "yaw_rate": 1e-3 / DT, "vz": 2e-3 / DT}
#: raw shifts under scale_factor: the packages' bilinear resamples differ by
#: up to 8e-4 gray levels (float32 rounding in another order), which moves a
#: few pixels across a uint8 rounding boundary of the carried frame; one such
#: pixel moves a 40 or 21 px window's shift by up to 0.01 px
SCALE_SHIFT_TOL = 0.02
#: float32 frames (quantize_8bit: false) keep every rounding difference of
#: the grayscale and the DFT sums, and the cross-power's whitening amplifies
#: it at the frequencies a window barely holds: on this stream the JAX node's
#: own two routes (its Pallas kernel and its XLA path) differ by 0.011 px in
#: one window, and the port differs from either by up to 0.025 px there
FLOAT_SHIFT_TOL, FLOAT_TWIST_TOL = 0.03, 5e-3
#: mode -> {topic: tolerance}.  Twists are compared where every window is in
#: RANSAC's consensus, so that the packages' different draws (the JAX
#: node's jax.random bits cannot be drawn in PyTorch) pick the same set: the
#: yawing scale/rotation stream, the 84 px frames of scale_factor 1.5 (12 to
#: 16 inliers of 16) and filter_method ransac leave windows out, and there
#: the raw shifts (and the decodes) are compared alone
JAX_CHECKS = {
    "method4": {"points_raw_out": SHIFT_TOL, "velocity_out": TWIST_TOL},
    "method5_average": {"points_raw_out": SHIFT_TOL, "velocity_out": TWIST_TOL},
    "scale_0.8": {"points_raw_out": SCALE_SHIFT_TOL, "velocity_out": 5e-3},
    "scale_1.5": {"points_raw_out": SCALE_SHIFT_TOL},
    "raw_off": {"velocity_out": TWIST_TOL},
    "fft_sr": {"points_raw_out": SHIFT_TOL, "scale_rotation_out": DECODE_TOL},
    "plain": {"points_raw_out": SHIFT_TOL, "velocity_out": TWIST_TOL},
    "float_frames": {"points_raw_out": FLOAT_SHIFT_TOL, "velocity_out": FLOAT_TWIST_TOL},
    "sr_bilinear": {"points_raw_out": SHIFT_TOL, "scale_rotation_out": DECODE_TOL},
    "lr_ratio_2": {"points_raw_out": SHIFT_TOL, "velocity_out_longrange": TWIST_TOL},
    "method3_ransac": {"points_raw_out": SHIFT_TOL},
    "method5_ransac": {"points_raw_out": SHIFT_TOL},
}


@pytest.mark.parametrize("mode", list(JAX_CHECKS))
def test_stream_matches_the_jax_node(mode):
    overrides, stream = MODES[mode]
    config = load_port_config(overrides=overrides)
    events = _events(**stream)
    ours, theirs = [], []
    _feed(_node(config, ours), events)
    if config.method != 4:
        # the JAX SAD engines' lax.scan route: their Pallas kernel compiles
        # slowly in interpret mode (tests/test_torch_node_modes.py)
        overrides = {**overrides, "tpu": {**overrides.get("tpu", {}), "use_pallas": False}}
    jax_node = JaxNode(load_config(overrides=overrides),
                       publish=lambda t, m: theirs.append((t, m)), log=lambda s: None)
    jax_node.set_transforms((0.0, 0.0, 0.0, 1.0))
    _feed(jax_node, events)
    assert [t for t, _ in ours if t in COMPARED] == [t for t, _ in theirs if t in COMPARED]
    assert any(t == "points_raw_out" for t, _ in ours) == config.raw_output
    for topic, tol in JAX_CHECKS[mode].items():
        a = [m for t, m in ours if t == topic]
        b = [m for t, m in theirs if t == topic]
        assert len(a) == len(b) == N_IMAGES - 1, topic
        if topic == "scale_rotation_out":
            for key, key_tol in tol.items():
                np.testing.assert_allclose([m[key] for m in a], [m[key] for m in b], atol=key_tol,
                                           rtol=0, err_msg=key)
            continue
        a, b = [_flat(m) for m in a], [_flat(m) for m in b]
        if topic.startswith("velocity_out"):  # stamp and linear velocity
            a, b = [x[:4] for x in a], [x[:4] for x in b]
        np.testing.assert_allclose(np.array(a), np.array(b), atol=tol, rtol=0, err_msg=topic)


# --------------------------------------------------------------------------- #
# the runner's rules, on stand-ins for torch.cuda's graph API                  #
# --------------------------------------------------------------------------- #


class _FakeGraph:
    """Records ``body``'s capture and replays it by calling it again with
    the launch counts switched off, as a graph runs no Python."""

    capturing = None
    registered: list = []

    def __init__(self):
        self.body = None

    def register_generator_state(self, gen):
        _FakeGraph.registered.append(gen)

    def replay(self):
        saved = [fn.LAUNCHES for fn in frame_graph.WRAPPERS]
        self.body()
        for fn, n in zip(frame_graph.WRAPPERS, saved):
            fn.LAUNCHES = n


class _FakeStream:
    cuda_stream = 7

    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_cuda(monkeypatch):
    """``torch.cuda``'s stream and graph calls as the runner makes them."""
    cuda = frame_graph.torch.cuda

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None):
        _FakeGraph.capturing = g
        try:
            yield
        finally:
            _FakeGraph.capturing = None

    monkeypatch.setattr(cuda, "Stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(cuda, "graph", graph)
    _FakeGraph.registered = []
    for fn in frame_graph.WRAPPERS:
        monkeypatch.setattr(fn, "LAUNCHES", 0)
    runner = FrameGraphs(torch.device("cpu"), generators=("gen",))
    runner.device = torch.device("cuda")  # the card's path, on CPU tensors
    return runner


#: a table made before any capture, as the kernels' lazy tables are
TABLE = torch.arange(4.0)


def _counting_body(runs: list, fail_capture=False):
    """A chain that 'launches' kernel A twice and kernel C once a frame and
    reads ``TABLE``."""
    a, c = cuda_kernels.phase_correlate_frames, cuda_kernels.sad_search

    def body():
        if fail_capture and _FakeGraph.capturing is not None:
            raise RuntimeError("capture refused")
        a.LAUNCHES += 2
        c.LAUNCHES += 1
        runs.append(_FakeGraph.capturing is not None)
        made = TABLE * 2.0
        return ("outputs", len(runs), float((made + 1.0).sum()))

    def bind(g):
        g.body = body
        return g

    return body, bind


def test_runner_captures_once_and_replays_with_the_launch_counts(fake_cuda):
    runner = fake_cuda
    slot = FrameSlot(torch.device("cpu"), np.zeros((4, 4), np.uint8), 3)
    runs = []
    body, bind = _counting_body(runs)
    a, c = cuda_kernels.phase_correlate_frames, cuda_kernels.sad_search
    runner.run(slot, body, capture=False)  # a stream's first frame: eager
    assert (a.LAUNCHES, c.LAUNCHES, runner.captures) == (2, 1, 0)
    out = runner.run(slot, body, capture=True)  # eager on the capture stream, then capture
    assert out[:2] == ("outputs", 2) and runs == [False, False, True]
    assert (a.LAUNCHES, c.LAUNCHES, runner.captures) == (4, 2, 1)
    assert slot.launches == {a: 2, c: 1} and slot.outputs[:2] == ("outputs", 3)
    # the graph holds what it read and did not make, and nothing it made
    assert any(t is TABLE for t in slot.inputs) and len(slot.inputs) == 1
    assert _FakeGraph.registered == ["gen"]
    bind(slot.graph)
    for k in range(3):
        assert runner.run(slot, body, capture=True) is slot.outputs
        assert (a.LAUNCHES, c.LAUNCHES) == (4 + 2 * (k + 1), 2 + (k + 1))
    assert runner.replays == 3 and runner.captures == 1


def test_runner_keeps_the_collector_out_of_a_capture(fake_cuda):
    """On the card, a dropped node's graphs that the collector frees inside
    another node's capture are destroyed there, which CUDA refuses, and the
    capture fails: the collector is paused while capturing, and only then."""
    runner = fake_cuda
    slot = FrameSlot(torch.device("cpu"), np.zeros((4, 4), np.uint8), 3)
    collecting = []

    def body():
        collecting.append((_FakeGraph.capturing is not None, gc.isenabled()))
        return ("outputs",)

    runner.run(slot, body, capture=True)
    assert collecting == [(False, True), (True, False)]
    assert gc.isenabled() and runner.captures == 1


def test_runner_capture_failure_raises_and_keeps_no_graph(fake_cuda):
    runner = fake_cuda
    slot = FrameSlot(torch.device("cpu"), np.zeros((4, 4), np.uint8), 3)
    runs = []
    body, _ = _counting_body(runs, fail_capture=True)
    a = cuda_kernels.phase_correlate_frames
    for k in range(2):  # no fallback: every frame of the key tries to capture and fails
        with pytest.raises(RuntimeError, match="capture refused"):
            runner.run(slot, body, capture=True)
        assert slot.graph is None and runner.captures == 0 and runner.replays == 0
        assert gc.isenabled()
        assert a.LAUNCHES == 2 * (k + 1)  # the eager runs' launches only
    runner.close()
    assert not runner._slots


def test_phase_20_names_the_kernels_of_every_mode():
    """``chip_smoke.py``'s phase 20 holds each mode of
    ``scripts/profile_torch_node.py`` to the hand kernels it names."""
    import chip_smoke
    from scripts.profile_torch_node import MODES as CARD_MODES

    assert set(chip_smoke.GRAPH_KERNELS) == set(CARD_MODES)
    assert all(k <= set(chip_smoke.KERNELS) for k in chip_smoke.GRAPH_KERNELS.values())
    assert chip_smoke.GRAPH_KERNELS["plain"] == set()
    assert all(chip_smoke.GRAPH_KERNELS[m] for m in CARD_MODES if m != "plain")
