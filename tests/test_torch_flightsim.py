"""The port's stream harness and flight simulator against the JAX package's,
and closed-loop flights through the port's node on the CPU.

- Profiles: every ``FlightSample`` field equal, bit for bit.
- Renders (``SyntheticScene.render``/``render_pose``, ``FlightSimulator
  .render`` with a mount) and event streams (``events_into``,
  ``trajectory_events``) bit-identical on a few frames at 752x480 and
  160x160, and again after a rendered scene's intrinsics or distortion
  are set anew (repair F10).
- ``evaluate_flight`` on the JAX tests' hand-built published lists gives the
  same ``FlightReport``.
- The mini flight (``test_flight_mini_smoke``'s profile, 160 px renders,
  128 px frames) through the port node and the JAX node on the same frames:
  both within the JAX test's budgets, the same mode switches and coverage,
  ``rmse_xy`` within ``MINI_RMSE_TOL`` of each other.  The two nodes draw
  other RANSAC hypotheses; ``python tests/torch_mini_flight.py`` measured
  the difference over 7 scene seeds x 4 draw seeds on the CPU: at most
  5.21e-5 m/s, median 1.43e-5, at rmse_xy 0.26-0.32 m/s.  The tolerance
  keeps about ten times that.
- The full-width level ``height_based`` flight and the banked ``imu`` flight
  through the port node at the card's budgets (``chip_smoke.py`` phase 16),
  and the ``.ofrec`` round trip; renders shared in module fixtures.
"""

import dataclasses

import numpy as np
import pytest
import torch_parity  # noqa: F401  (pins torch to one thread)

from mrs_optic_flow_tpu.runtime import flightsim as jax_fs
from mrs_optic_flow_tpu.runtime import msgs as jax_msgs
from mrs_optic_flow_tpu.runtime import stream as jax_stream
from mrs_optic_flow_tpu_torch import native
from mrs_optic_flow_tpu_torch.config import load_config
from mrs_optic_flow_tpu_torch.runtime import flightsim as port_fs
from mrs_optic_flow_tpu_torch.runtime import msgs as port_msgs
from mrs_optic_flow_tpu_torch.runtime import stream as port_stream
from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode
from torch_mini_flight import MINI_PROFILE, MINI_SCENE, fly_pair

MINI_RMSE_TOL = 5e-4  # m/s between the port and JAX mini flights

PROFILES = {
    "level": ("takeoff_cruise_descent_profile", {}),
    "level_mini": ("takeoff_cruise_descent_profile", MINI_PROFILE),
    "banked": ("banked_flight_profile", {}),
    "banked_long_range": ("banked_flight_profile", dict(
        climb_frames=24, h0=0.9, h_cruise=1.3, h_final=1.0, v_cruise_xy=(0.7, 0.2),
        descent_frames=16, descent_yaw_rate=0.25)),
    "banked_yawing_descent": ("banked_yawing_descent_profile", {}),
    "banked_yawing_descent_short": ("banked_yawing_descent_profile",
                                    dict(n_frames=10, sway_amp=0.5, sway_period=0.7)),
}


def _assert_samples_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)
        np.testing.assert_array_equal(a.vel_body, b.vel_body)


@pytest.mark.parametrize("name", PROFILES)
def test_profiles_equal_jax(name):
    fn, kw = PROFILES[name]
    _assert_samples_equal(getattr(port_fs, fn)(**kw), getattr(jax_fs, fn)(**kw))


SCENES = {
    "default_752x480": {},
    "mini_160": MINI_SCENE,
    "distorted": {"dist_coeffs": (-0.25, 0.06, 1e-4, -2e-4, -0.004), "seed": 7,
                  "texture_cutoff": 0.3},
    "offcentre": {"cx": 420.0, "cy": 230.0, "seed": 7, "texture_cutoff": 0.3},
}


@pytest.mark.parametrize("name", SCENES)
def test_scene_renders_bit_identical(name):
    kw = SCENES[name]
    ours, theirs = port_stream.SyntheticScene(**kw), jax_stream.SyntheticScene(**kw)
    np.testing.assert_array_equal(ours.texture, theirs.texture)
    assert ours.camera_info() == jax_to_port(theirs.camera_info())
    np.testing.assert_array_equal(ours.render((0.37, -1.2)), theirs.render((0.37, -1.2)))
    np.testing.assert_array_equal(ours.render_pose((0.2, 0.1), (0.1, -0.05, 0.3), height=1.7),
                                  theirs.render_pose((0.2, 0.1), (0.1, -0.05, 0.3), height=1.7))
    mat = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    np.testing.assert_array_equal(ours.render_pose((0.5, 0.5), mat, height=2.2),
                                  theirs.render_pose((0.5, 0.5), mat, height=2.2))


@pytest.mark.parametrize("changes", [
    {"dist_coeffs": [0.2, 0.0, 0.0, 0.0, 0.0]},
    {"dist_coeffs": [0.2, 0.0, 0.0, 0.0, 0.0], "fx": 380.0},
    {"fx": 380.0, "cy": 250.0},
    # cx and cy default to the centre at construction; the scene keeps them
    {"width": 320, "height_px": 288, "cx": 376.0, "cy": 240.0},
])
def test_scene_renders_anew_after_its_intrinsics_change(changes):
    """Repair F10: a scene rendered once, then given other intrinsics or
    distortion, renders as a JAX scene built with them, bit for bit (the
    ray cache is keyed on every attribute the rays depend on)."""
    ours = port_stream.SyntheticScene(seed=7, texture_cutoff=0.3)
    ours.render((0.37, -1.2))
    ours.render_pose((0.2, 0.1), (0.1, -0.05, 0.3))
    for name, value in changes.items():
        setattr(ours, name, value)
    kw = {"seed": 7, "texture_cutoff": 0.3}
    kw.update(changes)
    theirs = jax_stream.SyntheticScene(**kw)
    np.testing.assert_array_equal(ours.render((0.37, -1.2)), theirs.render((0.37, -1.2)))
    np.testing.assert_array_equal(ours.render_pose((0.2, 0.1), (0.1, -0.05, 0.3), height=1.7),
                                  theirs.render_pose((0.2, 0.1), (0.1, -0.05, 0.3), height=1.7))


def jax_to_port(msg):
    """A JAX message as the port's class of the same name and fields."""
    cls = getattr(port_msgs, type(msg).__name__)
    return cls(**{f.name: getattr(msg, f.name) for f in dataclasses.fields(msg)})


class _Collect:
    """Takes the place of a FrameStream to record the events queued."""

    def __init__(self):
        self.events = []

    def add(self, kind, stamp, msg):
        self.events.append((kind, stamp, msg))
        return self


def _assert_events_equal(ours, theirs):
    assert [(k, s) for k, s, _ in ours] == [(k, s) for k, s, _ in theirs]
    for (_, _, a), (_, _, b) in zip(ours, theirs):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, np.ndarray):
                assert va.dtype == vb.dtype
                np.testing.assert_array_equal(va, vb)
            else:
                assert va == vb, f.name


@pytest.mark.parametrize("profile,scene,mount", [
    ("level", {}, (0.0, 0.0, 0.0)),
    ("banked", {}, (0.0, 0.0, np.pi / 2)),
    ("level_mini", MINI_SCENE, (0.0, 0.0, 0.0)),
])
def test_flight_renders_and_events_bit_identical(profile, scene, mount):
    """``FlightSimulator.render`` (with the mount composed into the camera
    attitude), ``c2b_quat`` and ``events_into`` on the first, a middle and
    the last frame of the flight."""
    fn, kw = PROFILES[profile]
    samples_p, samples_j = getattr(port_fs, fn)(**kw), getattr(jax_fs, fn)(**kw)
    idx = [0, len(samples_p) // 2, len(samples_p) - 1]
    sims = (
        port_fs.FlightSimulator([samples_p[i] for i in idx], mount_rpy=mount,
                                scene=port_stream.SyntheticScene(**scene) if scene else None),
        jax_fs.FlightSimulator([samples_j[i] for i in idx], mount_rpy=mount,
                               scene=jax_stream.SyntheticScene(**scene) if scene else None),
    )
    assert sims[0].c2b_quat == sims[1].c2b_quat
    frames = [sim.frames() for sim in sims]
    for a, b in zip(*frames):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    rec = (_Collect(), _Collect())
    for sim, r, f in zip(sims, rec, frames):
        sim.events_into(r, f)
    _assert_events_equal(rec[0].events, rec[1].events)


def test_trajectory_events_bit_identical():
    rec = (_Collect(), _Collect())
    for mod, r in zip((port_stream, jax_stream), rec):
        mod.SyntheticScene(width=320, height_px=288, seed=3).trajectory_events(
            r, velocity=(0.8, -0.5), n_frames=3, dt=0.05)
    _assert_events_equal(rec[0].events, rec[1].events)


def test_frame_stream_orders_by_stamp_then_arrival():
    calls = []

    class Node:
        def __getattr__(self, name):
            return lambda msg: calls.append((name, msg)) or name

    stream = port_stream.FrameStream(Node())
    stream.add("image", 2.0, "i2").add("imu", 1.0, "m1").add("image", 1.0, "i1")
    stream.add("height", 1.0, "h1")
    assert stream.run() == ["on_image", "on_image"]
    assert calls == [("on_imu", "m1"), ("on_image", "i1"), ("on_height", "h1"),
                     ("on_image", "i2")]
    with pytest.raises(ValueError, match="unknown event kind"):
        stream.add("sonar", 0.0, None)


def _mini_sims():
    """The mini flight's simulators of both packages on the same scene."""
    return (port_fs.FlightSimulator(port_fs.takeoff_cruise_descent_profile(**MINI_PROFILE),
                                    scene=port_stream.SyntheticScene(**MINI_SCENE)),
            jax_fs.FlightSimulator(jax_fs.takeoff_cruise_descent_profile(**MINI_PROFILE),
                                   scene=jax_stream.SyntheticScene(**MINI_SCENE)))


def test_record_bag_equals_jax():
    """``record_bag`` of the port writes the JAX simulator's ROS1 bag byte
    for byte (the mini flight, its own renders), and ``record_bag2`` the
    same ``metadata.yaml`` and messages; the JAX readers read the port's
    bags to the messages of the JAX package's own."""
    import tempfile

    from mrs_optic_flow_tpu.runtime import rosbag as jax_rb
    from mrs_optic_flow_tpu.runtime import rosbag2 as jax_rb2

    sims = _mini_sims()
    frames = sims[0].frames()
    with tempfile.TemporaryDirectory() as tmp:
        bags = [f"{tmp}/port.bag", f"{tmp}/jax.bag"]
        dirs = [f"{tmp}/port_bag2", f"{tmp}/jax_bag2"]
        for sim, bag, d in zip(sims, bags, dirs):
            sim.record_bag(bag, frames)
            sim.record_bag2(d, frames)
        assert open(bags[0], "rb").read() == open(bags[1], "rb").read()
        assert (open(f"{dirs[0]}/metadata.yaml").read()
                == open(f"{dirs[1]}/metadata.yaml").read().replace("jax_bag2", "port_bag2"))
        read = []
        for path, reader in ((bags[0], jax_rb.BagReader), (bags[1], jax_rb.BagReader),
                             (dirs[0], jax_rb2.Bag2Reader), (dirs[1], jax_rb2.Bag2Reader)):
            with reader(path) as r:
                read.append(list(r.messages()))
    assert read[0] == read[1] and read[2] == read[3]
    n = len(sims[0].samples)
    assert len(read[0]) == len(read[2]) == 1 + 4 * n


@pytest.mark.parametrize("fmt", ["bag", "bag2"])
def test_mini_flight_bag_roundtrip_matches_jax(fmt, tmp_path):
    """The mini flight written by the JAX writers (``record_bag`` or
    ``record_bag2``), replayed through the port's ``replay_bag``/
    ``replay_bag2`` into the port node and through the JAX package's into
    the JAX node: the same frames, switches and coverage, ``rmse_xy``
    within ``MINI_RMSE_TOL`` (the draws seeded as ``fly_pair``'s)."""
    import jax

    from mrs_optic_flow_tpu.config import load_config as jax_load_config
    from mrs_optic_flow_tpu.runtime import rosbag as jax_rb
    from mrs_optic_flow_tpu.runtime import rosbag2 as jax_rb2
    from mrs_optic_flow_tpu.runtime.node import OpticFlowNode as JaxNode
    from mrs_optic_flow_tpu_torch.runtime import rosbag, rosbag2
    from torch_mini_flight import MINI_OVERRIDES

    port_sim, jax_sim = _mini_sims()
    path = str(tmp_path / ("mini.bag" if fmt == "bag" else "mini_bag2"))
    (jax_sim.record_bag if fmt == "bag" else jax_sim.record_bag2)(path, jax_sim.frames())

    published, jax_pub = [], []
    node = OpticFlowNode(load_config(overrides=MINI_OVERRIDES), device="cpu",
                         publish=lambda t, m: published.append((t, m)), log=lambda s: None)
    node._gen.manual_seed(0)
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    jax_node = JaxNode(jax_load_config(overrides=MINI_OVERRIDES),
                       publish=lambda t, m: jax_pub.append((t, m)), log=lambda s: None,
                       enable_profiler=False)
    jax_node._key = jax.random.PRNGKey(0)
    jax_node.set_transforms((0.0, 0.0, 0.0, 1.0))
    replay, jax_replay = ((rosbag.replay_bag, jax_rb.replay_bag) if fmt == "bag"
                          else (rosbag2.replay_bag2, jax_rb2.replay_bag2))
    assert replay(node, path) == jax_replay(jax_node, path) == len(port_sim.samples)

    rep = port_fs.evaluate_flight(port_sim.samples, published)
    jax_rep = jax_fs.evaluate_flight(jax_sim.samples, jax_pub)
    assert rep.rmse_xy < 0.45 and rep.nan_published == 0, rep
    assert rep.mode_switches == jax_rep.mode_switches and len(rep.mode_switches) >= 1
    assert rep.per_phase_coverage == jax_rep.per_phase_coverage
    assert abs(rep.rmse_xy - jax_rep.rmse_xy) < MINI_RMSE_TOL, (rep.rmse_xy, jax_rep.rmse_xy)


# --------------------------------------------------------------------------- #
# evaluate_flight on the JAX tests' hand-built published lists                 #
# --------------------------------------------------------------------------- #

def _twist(mod, stamp, v=(0.5, 0.0), cov=0.01, topic="velocity_out"):
    return (topic, mod.TwistWithCovarianceStamped.make(
        frame_id="fcu", stamp=stamp, linear=(*v, 0.0), angular=(0.0, 0.0, 0.0), cov_xy=cov))


def _cases(fs, msgs):
    """(samples, published, kwargs) of the JAX tests' evaluate_flight cases
    with the module set ``fs``/``msgs``, plus a mixed-topic case."""

    def sample(t, phase="cruise", vel=(0.5, 0.0, 0.0)):
        return fs.FlightSample(t=t, pos=np.array([0.0, 0.0, 2.0]), vel=np.array(vel), yaw=0.0,
                               yaw_rate=0.0, tracker="MpcTracker", phase=phase)

    tol = 1e-3
    jitter = [sample(100.0 + 0.05 * i) for i in range(6)]
    dense = [sample(100.0 + 1.5 * tol * i) for i in range(6)]
    neighbor = [sample(9.0), sample(9.5), sample(10.0), sample(10.0005)]
    mixed = [sample(100.0 + 0.05 * i, "takeoff" if i < 5 else "cruise",
                    (0.3 + 0.01 * i, -0.1, 0.2)) for i in range(10)]
    mixed_pub = [_twist(msgs, s.t, (0.31 + 0.02 * i, -0.12), 0.004 * (i + 1),
                        "velocity_out_longrange" if i < 4 else "velocity_out")
                 for i, s in enumerate(mixed) if i != 6]
    mixed_pub.append(_twist(msgs, mixed[8].t + 1e-4, (float("nan"), 0.0)))
    mixed_pub.append(("points_raw_out", None))
    return {
        "jitter": (jitter, [_twist(msgs, s.t + 4e-4 * (-1) ** i) for i, s in enumerate(jitter)], {}),
        "jitter_tight": (jitter, [_twist(msgs, s.t + 4e-4 * (-1) ** i)
                                  for i, s in enumerate(jitter)], {"stamp_tol": 1e-5}),
        "consumes": (dense, [_twist(msgs, dense[3].t + 0.75 * tol)], {"stamp_tol": tol}),
        "neighbor": (neighbor, [_twist(msgs, t) for t in (9.9997, 10.0001)], {"stamp_tol": tol}),
        "mixed_topics": (mixed, mixed_pub, {"warmup_frames": 1}),
        "nothing": (jitter, [], {}),
    }


@pytest.mark.parametrize("case", ["jitter", "jitter_tight", "consumes", "neighbor",
                                  "mixed_topics", "nothing"])
def test_evaluate_flight_matches_jax(case):
    s_p, pub_p, kw = _cases(port_fs, port_msgs)[case]
    s_j, pub_j, _ = _cases(jax_fs, jax_msgs)[case]
    ours = dataclasses.asdict(port_fs.evaluate_flight(s_p, pub_p, **kw))
    theirs = dataclasses.asdict(jax_fs.evaluate_flight(s_j, pub_j, **kw))
    assert repr(ours) == repr(theirs)


# --------------------------------------------------------------------------- #
# flights through the port node                                               #
# --------------------------------------------------------------------------- #

def _drive_port(sim, frames, c2b=(0.0, 0.0, 0.0, 1.0), **overrides):
    published = []
    node = OpticFlowNode(load_config(overrides=overrides), device="cpu",
                         publish=lambda t, m: published.append((t, m)), log=lambda s: None)
    node.set_transforms(c2b)
    stream = port_stream.FrameStream(node)
    sim.events_into(stream, frames)
    stream.run()
    return node, published


def test_mini_flight_port_and_jax_nodes_agree():
    """The mini flight on the same float frames through both nodes."""
    (rep, node, published), (jax_rep, jax_node, jax_pub) = fly_pair()

    for r, n in ((rep, node), (jax_rep, jax_node)):
        assert r.rmse_xy < 0.45, r
        assert r.nan_published == 0, r
        assert len(r.mode_switches) >= 1, r.mode_switches
        assert all(cov >= 0.9 for cov in r.per_phase_coverage.values()), r
        assert n.health["consecutive_failures"] <= 1
    assert rep.mode_switches == jax_rep.mode_switches
    assert rep.per_phase_coverage == jax_rep.per_phase_coverage
    assert rep.n_published == jax_rep.n_published
    # which frames went through which mode: the same stamps on each topic
    for topic in ("velocity_out", "velocity_out_longrange"):
        assert ([m.stamp for t, m in published if t == topic]
                == [m.stamp for t, m in jax_pub if t == topic]), topic
    assert abs(rep.rmse_xy - jax_rep.rmse_xy) < MINI_RMSE_TOL, (rep.rmse_xy, jax_rep.rmse_xy)


@pytest.fixture(scope="module")
def level_flight():
    sim = port_fs.FlightSimulator(port_fs.takeoff_cruise_descent_profile())
    return sim, sim.frames()


@pytest.fixture(scope="module")
def banked_flight():
    sim = port_fs.FlightSimulator(port_fs.banked_flight_profile())
    return sim, sim.frames()


def test_level_flight_height_based(level_flight):
    """``test_flight_closed_loop[height_based]``'s budgets on the port node
    at full width (``chip_smoke.py`` phase 16(a) on the card)."""
    sim, frames = level_flight
    node, published = _drive_port(
        sim, frames, mrs_optic_flow={"long_range_mode": "height_based", "takeoff_height": 1.2})
    rep = port_fs.evaluate_flight(sim.samples, published)
    topics = {t for t, _ in published if t in ("velocity_out", "velocity_out_longrange")}
    assert topics == {"velocity_out", "velocity_out_longrange"}
    assert len(rep.mode_switches) == 2, rep.mode_switches
    assert rep.rmse_xy < 0.12 and rep.max_err_xy < 0.35, rep
    assert rep.within_3sigma >= 0.97 and rep.nan_published == 0, rep
    assert all(cov >= 0.95 for cov in rep.per_phase_coverage.values()), rep
    assert rep.dropped_at_switches == 0, rep
    assert node.health["consecutive_failures"] <= 1
    assert 0.03 < rep.nees_xy < 2.0, rep.nees_xy


def test_banked_flight_imu(banked_flight):
    """``_assert_banked_budgets`` on the port node (phase 16(b) on the card)."""
    sim, frames = banked_flight
    node, published = _drive_port(sim, frames, mrs_optic_flow={"long_range_mode": "always_off"})
    rep = port_fs.evaluate_flight(sim.samples, published)
    assert rep.rmse_xy < 0.11 and rep.max_err_xy < 0.30, rep
    assert rep.nan_published == 0 and rep.within_3sigma >= 0.97, rep
    assert 0.03 < rep.nees_xy < 2.0, rep.nees_xy
    assert rep.per_phase_rmse["climb"] < 0.09, rep.per_phase_rmse
    assert all(cov >= 0.95 for cov in rep.per_phase_coverage.values()), rep
    assert node.health["consecutive_failures"] <= 1
    assert {m.frame_id for t, m in published if t == "velocity_out"} == {"fcu_untilted"}


def _replay_port(replay, path, **overrides):
    published = []
    node = OpticFlowNode(load_config(overrides=overrides), device="cpu",
                         publish=lambda t, m: published.append((t, m)), log=lambda s: None)
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    return node, published, replay(node, path)


def test_level_flight_rosbag2_roundtrip(level_flight, tmp_path):
    """``test_flight_rosbag2_roundtrip`` on the port at full width: the level
    flight through ``record_bag2`` (sqlite3 storage, CDR) and
    ``replay_bag2`` into the port node under ``height_based``."""
    from mrs_optic_flow_tpu_torch.runtime.rosbag2 import Bag2Reader, replay_bag2

    sim, frames = level_flight
    path = str(tmp_path / "flight_bag2")
    sim.record_bag2(path, frames)
    with Bag2Reader(path) as reader:
        by_type = reader.topics_by_type()
    assert by_type["sensor_msgs/msg/Image"] == ["/image_raw"]
    assert by_type["mrs_msgs/msg/Float64Stamped"] == ["/height"]

    _, published, n_frames = _replay_port(
        replay_bag2, path, mrs_optic_flow={"long_range_mode": "height_based",
                                           "takeoff_height": 1.2})
    assert n_frames == len(sim.samples)
    rep = port_fs.evaluate_flight(sim.samples, published)
    assert rep.rmse_xy < 0.15 and rep.nan_published == 0, rep
    assert len(rep.mode_switches) == 2, rep.mode_switches
    assert all(cov >= 0.95 for cov in rep.per_phase_coverage.values()), rep


@pytest.mark.parametrize("fmt", ["bag", "bag2"])
def test_banked_flight_bag_roundtrip(banked_flight, fmt, tmp_path):
    """``test_flight_banked_bag_roundtrips`` on the port, one format a case:
    the attitude quaternions and rates survive transport (the climb
    budget)."""
    from mrs_optic_flow_tpu_torch.runtime.rosbag import replay_bag
    from mrs_optic_flow_tpu_torch.runtime.rosbag2 import replay_bag2

    sim, frames = banked_flight
    path = str(tmp_path / ("banked.bag" if fmt == "bag" else "banked_bag2"))
    (sim.record_bag if fmt == "bag" else sim.record_bag2)(path, frames)
    _, published, n_frames = _replay_port(replay_bag if fmt == "bag" else replay_bag2, path,
                                          mrs_optic_flow={"long_range_mode": "always_off"})
    assert n_frames == len(sim.samples)
    rep = port_fs.evaluate_flight(sim.samples, published)
    assert rep.rmse_xy < 0.12, rep
    assert rep.per_phase_rmse["climb"] < 0.10, rep.per_phase_rmse
    assert rep.nan_published == 0, rep
    assert all(cov >= 0.95 for cov in rep.per_phase_coverage.values()), rep


def test_flight_ofrec_roundtrip(level_flight, tmp_path):
    """``record_ofrec`` through the port's native Recorder: stamps and
    frames replay bit-exactly, the JAX package's ``Replay`` reads the same
    file, and the replayed frames fly within budget."""
    if not native.available():
        pytest.skip("native runtime unavailable (no C++ toolchain)")
    from mrs_optic_flow_tpu import native as jax_native

    sim, frames = level_flight
    path = str(tmp_path / "flight.ofrec")
    sim.record_ofrec(path, frames)
    with native.Replay(path) as rep, jax_native.Replay(path) as jrep:
        assert rep.n_frames == jrep.n_frames == len(sim.samples)
        replayed = []
        for i in range(rep.n_frames):
            stamp, frame = rep.read(i)
            assert stamp == sim.samples[i].t
            np.testing.assert_array_equal(frame, np.clip(np.rint(frames[i]), 0, 255).astype(np.uint8))
            jstamp, jframe = jrep.read(i)
            assert jstamp == stamp
            np.testing.assert_array_equal(jframe, frame)
            replayed.append(frame)
    _, published = _drive_port(
        sim, replayed, mrs_optic_flow={"long_range_mode": "height_based", "takeoff_height": 1.2})
    report = port_fs.evaluate_flight(sim.samples, published)
    assert report.rmse_xy < 0.15 and report.nan_published == 0, report
