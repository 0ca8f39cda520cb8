"""The port node's options of the JAX node, their native binding and the
overlay renderer, against the JAX package where it has a twin
(``tests/test_node.py:208-270`` and ``:773-880``, ``tests/test_native.py``,
``tests/test_feeder.py``):

- ``tpu.host_preprocess``: the native fused gray+crop on the host gives the
  twists of the device preprocessing on the same BGR uint8 frames (the gray
  window differs by at most 1 LSB; on these frames, gray replicated into
  three channels, by none, so the twists agree to 1e-6 m/s), runs on every
  frame after the first, and falls back to the device with a throttled log
  for float frames, ``scale_factor != 1`` and an unavailable library;
- ``store_video`` to ``.ofrec`` (the native Recorder) and ``.avi``
  (``viz.VideoWriter``), read back; ``close()``;
- ``gui``: ``cv2.imshow`` of the overlay, disabled with one log line when
  it raises or OpenCV is missing;
- ``viz.flow_overlay``, ``VideoWriter`` and PGM bytes equal to the JAX
  package's; the native bindings equal to the JAX package's;
- ``NativeFeeder`` against the JAX feeder on the same pushes.
"""

import types

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (pins torch to one thread)

from mrs_optic_flow_tpu import native as jax_native
from mrs_optic_flow_tpu.runtime import feeder as jax_feeder
from mrs_optic_flow_tpu.runtime import viz as jax_viz
from mrs_optic_flow_tpu_torch import native
from mrs_optic_flow_tpu_torch.config import load_config
from mrs_optic_flow_tpu_torch.ops.preprocess import center_crop, quantize_u8, to_grayscale
from mrs_optic_flow_tpu_torch.runtime import FrameStream, SyntheticScene
from mrs_optic_flow_tpu_torch.runtime import feeder as port_feeder
from mrs_optic_flow_tpu_torch.runtime import viz as port_viz
from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode

pytestmark = pytest.mark.skipif(not native.available(), reason="no C++ toolchain")

V_TRUE = (0.8, -0.5)
DT = 0.05
HEIGHT = 2.0
HOST_TWIST_TOL = 1e-6  # m/s: the same gray window reaches the engine
N_FRAMES = 5


def _node(published, logs=None, **overrides):
    node = OpticFlowNode(load_config(overrides=overrides or None), device="cpu",
                         publish=lambda t, m: published.append((t, m)),
                         log=(logs.append if logs is not None else lambda s: None))
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    return node


def _as_bgr_u8(frame):
    q = np.clip(np.round(frame), 0, 255).astype(np.uint8)
    return np.repeat(q[:, :, None], 3, axis=2)


def _run(node, bgr=False, seed=4, n_frames=N_FRAMES):
    scene = SyntheticScene(uav_height=HEIGHT, seed=seed)
    stream = FrameStream(node)
    scene.trajectory_events(stream, velocity=V_TRUE, n_frames=n_frames, dt=DT)
    if bgr:
        for ev in stream._events:
            if ev.kind == "image":
                ev.msg.data = _as_bgr_u8(ev.msg.data)
    stream.run()
    return node


def _twists(published):
    return np.array([m.linear for t, m in published if t == "velocity_out"])


def test_host_preprocess_matches_device_path():
    pub_host, pub_dev = [], []
    native.gray_crop.CALLS = native.crop.CALLS = 0
    _run(_node(pub_host, tpu={"host_preprocess": True}), bgr=True)
    assert native.gray_crop.CALLS == N_FRAMES - 1 and native.crop.CALLS == 0
    _run(_node(pub_dev), bgr=True)
    assert native.gray_crop.CALLS == N_FRAMES - 1  # the device path calls nothing native
    v_h, v_d = _twists(pub_host), _twists(pub_dev)
    assert len(v_h) == len(v_d) == N_FRAMES - 1
    np.testing.assert_allclose(v_h, v_d, rtol=0, atol=HOST_TWIST_TOL)
    assert np.abs(v_h[1:, :2] - np.array(V_TRUE)).max() < 0.15


def test_host_preprocess_gray_frames_use_crop():
    """A uint8 gray frame larger than the window is cropped natively."""
    published = []
    native.gray_crop.CALLS = native.crop.CALLS = 0
    node = _node(published, tpu={"host_preprocess": True})
    scene = SyntheticScene(uav_height=HEIGHT, seed=4)
    stream = FrameStream(node)
    scene.trajectory_events(stream, velocity=V_TRUE, n_frames=3, dt=DT)
    for ev in stream._events:
        if ev.kind == "image":
            ev.msg.data = np.clip(np.round(ev.msg.data), 0, 255).astype(np.uint8)
    stream.run()
    assert native.crop.CALLS == 2 and native.gray_crop.CALLS == 0
    assert len(_twists(published)) == 2


@pytest.mark.parametrize("case", ["float_frames", "scale_factor", "unavailable"])
def test_host_preprocess_fallbacks(case):
    """Inputs the native path cannot honour and a library that cannot load
    fall back to device preprocessing, logged (throttled), and the stream
    keeps publishing."""
    published, logs = [], []
    overrides = {"tpu": {"host_preprocess": True}}
    if case == "scale_factor":
        overrides["mrs_optic_flow"] = {"scale_factor": 1.5}
    node = _node(published, logs, **overrides)
    if case == "unavailable":
        node._host_pre = False  # the lazy resolution's "unavailable" state
    native.gray_crop.CALLS = native.crop.CALLS = 0
    _run(node, bgr=case != "float_frames")
    assert native.gray_crop.CALLS == native.crop.CALLS == 0
    assert len(_twists(published)) == N_FRAMES - 1
    if case == "unavailable":
        assert not any("host_preprocess" in s for s in logs)
    else:
        assert sum("cannot honor" in s for s in logs) == 1  # throttled to one a second


def test_host_preprocess_library_that_fails_to_load(monkeypatch):
    published, logs = [], []
    node = _node(published, logs, tpu={"host_preprocess": True})

    def boom():
        raise native.NativeUnavailable("no toolchain")

    monkeypatch.setattr(native, "load", boom)
    _run(node, bgr=True, n_frames=3)
    assert node._host_pre is False
    assert sum("host_preprocess unavailable" in s for s in logs) == 1
    assert len(_twists(published)) == 2


def test_native_gray_crop_within_one_lsb_of_device_preprocessing():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, size=(480, 752, 3), dtype=np.uint8)
    host = native.gray_crop(img, 376, 240, 480)
    dev = quantize_u8(center_crop(to_grayscale(torch.from_numpy(img)), 480, 376)).numpy()
    assert host.shape == dev.shape == (480, 480)
    assert np.abs(host.astype(int) - dev.astype(int)).max() <= 1


@pytest.mark.parametrize("shape,cx,cy,size", [((480, 752), 376, 240, 480), ((100, 90), 10, 95, 64),
                                               ((64, 64), 32, 32, 64)])
def test_native_preprocessing_matches_jax_binding(shape, cx, cy, size):
    rng = np.random.default_rng(3)
    bgr = rng.integers(0, 256, size=(*shape, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, size=shape, dtype=np.uint8)
    for swap in (True, False):
        np.testing.assert_array_equal(native.bgr_to_gray(bgr, swap), jax_native.bgr_to_gray(bgr, swap))
        np.testing.assert_array_equal(native.gray_crop(bgr, cx, cy, size, swap),
                                      jax_native.gray_crop(bgr, cx, cy, size, swap))
    np.testing.assert_array_equal(native.crop(gray, cx, cy, size), jax_native.crop(gray, cx, cy, size))
    with pytest.raises(ValueError, match="exceeds"):
        native.crop(gray, cx, cy, max(shape) + 1)
    with pytest.raises(ValueError, match="exceeds"):
        native.gray_crop(bgr, cx, cy, max(shape) + 1)


def test_recorder_interoperates_with_jax(tmp_path):
    """A recording written by either binding reads back bit for bit through
    the other; a frame of another shape is refused."""
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, size=(4, 48, 64), dtype=np.uint8)
    stamps = [100.0 + 0.05 * i for i in range(4)]
    for write_mod, read_mod, name in ((native, jax_native, "a"), (jax_native, native, "b")):
        path = str(tmp_path / f"{name}.ofrec")
        with write_mod.Recorder(path, width=64, height=48) as rec:
            for s, f in zip(stamps, frames):
                rec.write(s, f)
        with read_mod.Replay(path) as rep:
            assert (rep.width, rep.height, rep.channels, rep.n_frames) == (64, 48, 1, 4)
            got = list(rep)
        assert [s for s, _ in got] == stamps
        np.testing.assert_array_equal(np.stack([f for _, f in got]), frames)
    with native.Recorder(str(tmp_path / "c.ofrec"), width=64, height=48) as rec:
        with pytest.raises(ValueError, match="shape"):
            rec.write(0.0, frames[0][:10])
    with pytest.raises(OSError):
        native.Replay(str(tmp_path / "missing.ofrec"))
    with native.Replay(str(tmp_path / "a.ofrec")) as rep, pytest.raises(IndexError):
        rep.read(4)


def test_store_video_ofrec(tmp_path):
    path = str(tmp_path / "overlay.ofrec")
    published = []
    node = _run(_node(published, store_video=True, video_path=path))
    node.close()
    with native.Replay(path) as rep:
        got = list(rep)
    stamps = [m.stamp for t, m in published if t == "velocity_out"]
    assert [s for s, _ in got] == stamps and len(got) == N_FRAMES - 1
    assert got[0][1].shape == (480, 480) and got[0][1].dtype == np.uint8
    assert (got[1][1] == 255).sum() > 0  # the flow vectors are drawn


def test_store_video_avi(tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "overlay.avi")
    ofrec = str(tmp_path / "overlay.ofrec")
    _run(_node([], store_video=True, video_path=path, video_fps=30)).close()
    _run(_node([], store_video=True, video_path=ofrec)).close()
    cap = cv2.VideoCapture(path)
    assert cap.isOpened()
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == N_FRAMES - 1
    with native.Replay(ofrec) as rep:
        overlays = [f for _, f in rep]
    for want in overlays:
        ok, img = cap.read()
        assert ok and img.shape == (480, 480, 3)
        np.testing.assert_array_equal(img[..., 0], want)
    cap.release()


def test_store_video_unwritable_path_logs_once():
    logs = []
    node = _run(_node([], logs, store_video=True, video_path="/nonexistent/dir/x.avi"), n_frames=3)
    assert sum("could not open video recorder" in s for s in logs) == 1
    node.close()


def test_warmup_records_nothing(tmp_path):
    path = str(tmp_path / "overlay.ofrec")
    node = _node([], store_video=True, video_path=path)
    node.on_camera_info(SyntheticScene().camera_info())
    node.warmup()
    assert node._recorder is None and not node._recorder_opened


def test_gui_overlay(monkeypatch):
    calls = []
    fake = types.SimpleNamespace(imshow=lambda name, img: calls.append((name, img.shape)),
                                 waitKey=lambda ms: None)
    monkeypatch.setitem(__import__("sys").modules, "cv2", fake)
    _run(_node([], gui=True), n_frames=3)
    assert calls and calls[0] == ("optic_flow", (480, 480)) and len(calls) == 2


@pytest.mark.parametrize("cv2_module", ["raising", "missing"])
def test_gui_headless_disables(monkeypatch, cv2_module):
    """A failing ``imshow`` (no display) or no OpenCV at all (the card)
    disables the GUI after one attempt, with one log line."""
    def boom(*a):
        raise RuntimeError("no display")

    fake = None if cv2_module == "missing" else types.SimpleNamespace(imshow=boom,
                                                                       waitKey=lambda ms: None)
    monkeypatch.setitem(__import__("sys").modules, "cv2", fake)
    logs, published = [], []
    node = _run(_node(published, logs, gui=True), n_frames=4)
    assert node._gui_failed is True
    assert sum("gui disabled" in s for s in logs) == 1
    assert len(_twists(published)) == 3


# --------------------------------------------------------------------------- #
# viz against the JAX package                                                  #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("q,size,scale", [(4, 480, 1.0), (4, 480, 4.0), (1, 480, 1.0), (8, 256, 1.0)])
def test_flow_overlay_equals_jax(q, size, scale):
    rng = np.random.default_rng(q * size)
    frame = rng.uniform(-20, 280, size=(size, size)).astype(np.float32)
    shifts = rng.uniform(-30, 30, size=(q * q, 2)).astype(np.float32)
    shifts[::3] = np.nan
    patch = size // q
    np.testing.assert_array_equal(port_viz.flow_overlay(frame, shifts, patch, scale=scale),
                                  jax_viz.flow_overlay(frame, shifts, patch, scale=scale))
    np.testing.assert_array_equal(port_viz.flow_overlay(frame, shifts, None, exaggeration=2.0),
                                  jax_viz.flow_overlay(frame, shifts, None, exaggeration=2.0))


def test_video_writer_and_pgm_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, size=(48, 64), dtype=np.uint8),
              rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8),
              rng.uniform(-5, 300, size=(48, 64)).astype(np.float32)]
    for mod, name in ((port_viz, "port"), (jax_viz, "jax")):
        with mod.VideoWriter(str(tmp_path / f"{name}.avi"), 64, 48, fps=12.5) as w:
            for f in frames:
                w.write(f)
        mod.save_pgm(str(tmp_path / f"{name}.pgm"), frames[2])
    for ext in ("avi", "pgm"):
        assert (tmp_path / f"port.{ext}").read_bytes() == (tmp_path / f"jax.{ext}").read_bytes()
    np.testing.assert_array_equal(port_viz.load_pgm(str(tmp_path / "jax.pgm")),
                                  jax_viz.load_pgm(str(tmp_path / "port.pgm")))
    with pytest.raises(ValueError, match="width % 4"):
        port_viz.VideoWriter(str(tmp_path / "odd.avi"), 62, 48)


# --------------------------------------------------------------------------- #
# NativeFeeder against the JAX feeder                                          #
# --------------------------------------------------------------------------- #

class _FakeNode:
    """What a feeder needs of a node: its config, its camera and on_image."""

    def __init__(self, scale_factor=1.0, frame_size=128, cx=80.0):
        self.config = types.SimpleNamespace(scale_factor=scale_factor, frame_size=frame_size)
        self.camera_matrix = np.array([[100.0, 0, cx], [0, 100.0, 60.0], [0, 0, 1]])
        self.images = []

    def on_image(self, msg):
        self.images.append((msg.stamp, msg.data))


@pytest.mark.parametrize("realtime", [True, False])
def test_native_feeder_matches_jax(realtime):
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, size=(7, 140, 160, 3), dtype=np.uint8)
    feeders = []
    for mod in (port_feeder, jax_feeder):
        node = _FakeNode()
        f = mod.NativeFeeder(node, width=160, height=140, capacity=4, realtime=realtime)
        pushed = [f.push(frames[i], 10.0 + i) for i in range(3)]
        fed = [f.feed_once()]
        pushed += [f.push(frames[i], 10.0 + i) for i in range(3, 7)]  # the ring overflows
        while f.feed_once():
            fed.append(True)
        fed.append(f.feed_once())
        feeders.append((node, f, pushed, fed))
    (pn, pf, p_pushed, p_fed), (jn, jf, j_pushed, j_fed) = feeders
    assert p_pushed == j_pushed and p_fed == j_fed
    assert (pf.frames_fed, pf.frames_skipped, pf.dropped) == (jf.frames_fed, jf.frames_skipped,
                                                               jf.dropped)
    assert [s for s, _ in pn.images] == [s for s, _ in jn.images]
    for (_, a), (_, b) in zip(pn.images, jn.images):
        assert a.shape == (128, 128)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["scale_factor", "crop_outside"])
def test_native_feeder_refuses_what_jax_refuses(case):
    kw = {"scale_factor": 1.5} if case == "scale_factor" else {"cx": 20.0}
    errors = []
    for mod in (port_feeder, jax_feeder):
        try:
            f = mod.NativeFeeder(_FakeNode(**kw), width=160, height=140)
            f.push(np.zeros((140, 160, 3), np.uint8), 1.0)
            f.feed_once()
        except ValueError as e:
            errors.append(str(e))
    assert len(errors) == 2 and errors[0] == errors[1]


def test_native_feeder_thread_drives_the_node():
    published = []
    node = _node(published)
    scene = SyntheticScene(uav_height=HEIGHT, seed=2)
    node.on_camera_info(scene.camera_info())
    for t in range(3):
        from mrs_optic_flow_tpu_torch.runtime.msgs import Float64Stamped, Imu, Odometry

        stamp = 100.0 + t * DT
        node.on_imu(Imu(stamp=stamp, angular_velocity=(0.0, 0.0, 0.0),
                        orientation=(0.0, 0.0, 0.0, 1.0)))
        node.on_odometry(Odometry(stamp=stamp, orientation=(0.0, 0.0, 0.0, 1.0)))
        node.on_height(Float64Stamped(stamp=stamp, value=HEIGHT))
    feeder = port_feeder.NativeFeeder(node, width=752, height=480, realtime=False).start()
    try:
        for t in range(3):
            pos = (V_TRUE[0] * t * DT, V_TRUE[1] * t * DT)
            assert feeder.push(_as_bgr_u8(scene.render(pos)), 100.0 + t * DT)
        import time

        deadline = time.monotonic() + 60
        while feeder.frames_fed < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        feeder.stop()
    assert feeder.frames_fed == 3
    v = _twists(published)
    assert len(v) == 2 and np.abs(v[1, :2] - np.array(V_TRUE)).max() < 0.15


def test_profiler_report_matches_jax():
    """``Profiler.report()`` formats the same statistics as the JAX
    profiler's; a routine adds one sample; a disabled profiler adds none."""
    from mrs_optic_flow_tpu.runtime.profiler import Profiler as JaxProfiler
    from mrs_optic_flow_tpu_torch.runtime.profiler import Profiler

    ours = Profiler("OpticFlow")
    theirs = JaxProfiler("OpticFlow")
    samples = {"frame_program": [0.0161, 0.0204, 0.0153, 0.1], "frame_program_lr": [0.0031]}
    for p in (ours, theirs):
        for k, v in samples.items():
            p._samples[k].extend(v)
    assert ours.report() == theirs.report()
    with ours.routine("stage"):
        pass
    assert ours.stats()["stage"]["count"] == 1
    off = Profiler("x", enabled=False)
    with off.routine("stage"):
        pass
    assert off.report() == "[x] profiler report"
