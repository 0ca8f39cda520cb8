"""CLI runner of the port — the launch-file analog (``launch/optic_flow.launch``).

The port's copy of ``python -m mrs_optic_flow_tpu``: drives
:class:`OpticFlowNode` over a recorded stream (``--replay file.ofrec``, the
native Recorder format; ``--replay flight.bag``, an offline ROS1 rosbag; or
``--replay flight_dir/`` / ``flight.db3`` / ``flight.mcap``, a ROS2
rosbag2 — no ROS needed either way), a synthetic constant-velocity scene
(``--synthetic``), the closed-loop flight simulator as a regression gate
(``--flight``) or a synthetic fleet (``--fleet N``), printing published
twists and the profiler report; ``--ros`` and ``--ros2`` run the node on a
live ROS1 or ROS2 graph, and ``--bag-info`` lists a bag's topics.  Config
overrides take ``key=value`` dotted paths like launch-file substitutions.

Everything that builds a node runs on ``--device`` (default ``cuda``);
without a CUDA device the run fails with status 2 rather than fall back to
the CPU, so CPU runs pass ``--device cpu``.  ``--bag-info`` builds no node.

Examples::

    python -m mrs_optic_flow_tpu_torch --synthetic --frames 20 --velocity 1.0,-0.3
    python -m mrs_optic_flow_tpu_torch --flight banked --quiet
    python -m mrs_optic_flow_tpu_torch --replay flight.bag --quiet
    python -m mrs_optic_flow_tpu_torch --bag-info flight_dir/
    python -m mrs_optic_flow_tpu_torch --replay flight.ofrec --fps 30 \
        --set mrs_optic_flow.long_range_mode=height_based --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys


def _parse_overrides(pairs):
    tree: dict = {}
    for pair in pairs or []:
        key, _, value = pair.partition("=")
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        try:
            parsed = json.loads(value)
        except json.JSONDecodeError:
            parsed = value
        node[parts[-1]] = parsed
    return tree


def filter_ros_remap_args(argv):
    """Drop launch-system-injected arguments so argparse only sees real
    flags:

    - roslaunch (ROS1) appends ``__name:=...`` / ``__log:=...`` / topic
      ``from:=to`` remap pairs;
    - ros2 launch appends a ``--ros-args ... [--]`` section (``-r``
      remaps, ``-p`` params, ``--params-file``), terminated by ``--`` when
      user args follow.
    """
    out = []
    it = iter(argv)
    for a in it:
        if a == "--ros-args":
            for b in it:  # consume through the optional `--` terminator
                if b == "--":
                    break
            continue
        if ":=" not in a:
            out.append(a)
    return out


def _run_bag_info(path):
    """``--bag-info``: topics/types/counts/duration of a ROS1 ``.bag`` or a
    ROS2 rosbag2 (``.db3``/``.mcap`` file / bag directory) — the ``rosbag
    info`` / ``ros2 bag info`` analog, without ROS (runtime/rosbag{,2}.py)."""
    from mrs_optic_flow_tpu_torch.runtime.rosbag2 import Bag2Reader, is_rosbag2

    if is_rosbag2(path):
        reader_ctx = Bag2Reader(path)

        def _types(r):
            return dict(r.topic_types)
    else:
        from mrs_optic_flow_tpu_torch.runtime.rosbag import BagReader

        reader_ctx = BagReader(path)

        def _types(r):
            return {topic: tn for topic, tn in r.connections.values()}

    with reader_ctx as reader:
        counts: dict = {}
        t0 = t1 = None
        for t, topic, _type_name, _raw in reader.messages():
            counts[topic] = counts.get(topic, 0) + 1
            t0 = t if t0 is None else min(t0, t)
            t1 = t if t1 is None else max(t1, t)
        types = _types(reader)
        for topic in types:
            counts.setdefault(topic, 0)
        duration = (t1 - t0) if t1 is not None else 0.0
        print(f"{path}: {sum(counts.values())} messages, {duration:.2f} s")
        width = max((len(t) for t in counts), default=0)
        for topic in sorted(counts):
            print(f"  {topic:<{width}}  {counts[topic]:>7}  {types.get(topic, '?')}")
    return 0


def _run_flight(args, cfg, device):
    """``--flight``: the closed-loop flight simulator as a CLI regression
    gate.  Prints the :class:`FlightReport` as one JSON line; exit 0 iff
    the trajectory budgets hold."""
    import dataclasses

    from mrs_optic_flow_tpu_torch.runtime import FrameStream, OpticFlowNode
    from mrs_optic_flow_tpu_torch.runtime.flightsim import (
        FlightSimulator,
        banked_flight_profile,
        evaluate_flight,
        takeoff_cruise_descent_profile,
    )

    samples = (
        banked_flight_profile() if args.flight == "banked"
        else takeoff_cruise_descent_profile()
    )
    mount = (
        tuple(float(x) for x in args.mount.split(","))
        if args.mount else (0.0, 0.0, 0.0)
    )
    sim = FlightSimulator(samples, mount_rpy=mount)
    frames = sim.frames()
    if args.record:
        sim.record_ofrec(args.record, frames)
    published = []
    node = OpticFlowNode(
        cfg, device=device, publish=lambda t, m: published.append((t, m)),
        log=(lambda s: None) if args.quiet else print,
    )
    node.set_transforms(sim.c2b_quat)
    stream = FrameStream(node)
    sim.events_into(stream, frames)
    stream.run()
    node.close()
    rep = evaluate_flight(samples, published)
    if args.profile:
        print(node.profiler.report(), file=sys.stderr)
    print(json.dumps(dataclasses.asdict(rep)))
    ok = (
        rep.rmse_xy < args.flight_rmse_budget
        and rep.nan_published == 0
        and all(v >= 0.9 for v in rep.per_phase_coverage.values())
        and 0.005 < rep.nees_xy < 2.5
    )
    return 0 if ok else 1


def _run_fleet(ap, args, cfg, device):
    """``--fleet N``: N synthetic camera streams, one batched call a tick."""
    import numpy as np

    from mrs_optic_flow_tpu_torch.parallel import BatchPipeline
    from mrs_optic_flow_tpu_torch.runtime import FleetServer, SyntheticScene

    n = args.fleet
    if n < 1:
        ap.error(f"--fleet needs at least 1 stream, got {n}")
    dt = 1.0 / args.fps
    v = tuple(float(x) for x in args.velocity.split(","))
    scene = SyntheticScene(uav_height=args.height)
    ci = scene.camera_info()
    pipe = BatchPipeline(
        frame_size=cfg.frame_size, sample_point_size=cfg.sample_point_size,
        camera_matrix=ci.matrix(), dist_coeffs=ci.dist(), device=device,
    )
    fleet = FleetServer(pipe, n)
    say = (lambda *a: None) if args.quiet else print
    if args.profile:
        say("[fleet] --profile has no effect in fleet mode "
            "(the profiler belongs to OpticFlowNode)")
    # each stream flies at its own velocity (scaled off the base)
    scales = [0.5 + i / max(n - 1, 1) for i in range(n)]
    heights = np.full(n, args.height)
    prev_tick = None
    for t in range(args.frames):
        frames = np.stack([
            scene.render((v[0] * scales[i] * t * dt, v[1] * scales[i] * t * dt))
            for i in range(n)
        ]).astype(np.uint8)
        tick = fleet.tick(frames, np.full(n, 100.0 + t * dt), heights)
        if prev_tick is not None:  # read back k-1 while k computes
            done = prev_tick.materialize()
            ok = int(done.ok.sum())
            mean_v = np.nanmean(done.tran[done.ok, :2], axis=0) if ok else (np.nan,) * 2
            say(f"[tick {t - 1:3d}] {ok}/{n} streams ok, "
                f"fleet mean v = {mean_v[0]:+.3f} {mean_v[1]:+.3f} m/s "
                f"(true mean {v[0] * np.mean(scales):+.3f} {v[1] * np.mean(scales):+.3f})")
        prev_tick = tick
    if prev_tick is not None:
        done = prev_tick.materialize()
        print(f"[tick {args.frames - 1:3d}] {int(done.ok.sum())}/{n} streams ok")
    return 0


def _run_ros(args, cfg, device):
    """``--ros``: bring the node up on a live ROS1 graph — the deployment
    shape of the reference nodelet (``launch/optic_flow.launch:29``), minus
    the nodelet manager.  ``rospy.init_node`` happens here; topic remapping
    is roslaunch's, via ``launch/optic_flow_tpu.launch``."""
    import rospy  # noqa: PLC0415 — only a ROS1 environment has this

    from mrs_optic_flow_tpu_torch.runtime.ros_bridge import RosBridge

    rospy.init_node("optic_flow")
    bridge = RosBridge(
        cfg,
        camera_frame=args.camera_frame or "camera",
        uav_frame=args.uav_frame or "fcu",
        uav_untilted_frame=args.uav_untilted_frame,
        device=device,
    )
    if not args.no_warmup:
        rospy.loginfo("[OpticFlow]: warming up the kernels")
        bridge.warmup()
        rospy.loginfo("[OpticFlow]: warm; streaming")
    try:
        bridge.spin()
    finally:
        bridge.node.close()  # an AVI's index is written here (repair F14)
    return 0


def _run_ros2(args, cfg, device):
    """``--ros2``: bring the node up on a live ROS2 graph
    (runtime.Ros2Bridge; the rclpy twin of ``--ros``)."""
    import rclpy  # noqa: PLC0415 — only a ROS2 environment has this

    from mrs_optic_flow_tpu_torch.runtime.ros2_bridge import Ros2Bridge

    rclpy.init()
    try:
        bridge = Ros2Bridge(
            cfg,
            camera_frame=args.camera_frame or "camera",
            uav_frame=args.uav_frame or "fcu",
            uav_untilted_frame=args.uav_untilted_frame,
            device=device,
        )
        log = bridge.handle.get_logger().info
        if not args.no_warmup:
            log("[OpticFlow]: warming up the kernels")
            bridge.warmup()
            log("[OpticFlow]: warm; streaming")
        try:
            bridge.spin()
        finally:
            bridge.node.close()  # repair F14, as --ros
    finally:
        rclpy.shutdown()
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mrs_optic_flow_tpu_torch")
    ap.add_argument("--config", help="YAML config path (default: configs/default.yaml)")
    ap.add_argument("--set", dest="overrides", action="append", metavar="KEY=VALUE",
                    help="config override (dotted path), repeatable")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; a run without a CUDA "
                         "device fails unless this is cpu)")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--replay", metavar="FILE",
                     help="replay a recorded stream (.ofrec native Recorder "
                          "format, a ROS1 .bag, or a ROS2 rosbag2 .db3/.mcap "
                          "file / bag directory — no ROS needed)")
    ap.add_argument("--bag-topic", action="append", default=[],
                    metavar="ROLE=TOPIC",
                    help="pin a bag replay role to a topic (roles: image, "
                         "compressed_image, camera_info, imu, odometry, "
                         "height); repeatable — needed when the bag has "
                         "several topics of one type")
    src.add_argument("--bag-info", metavar="BAG",
                     help="print a bag's topics/types/counts (ROS1 .bag or "
                          "rosbag2 .db3/.mcap/directory; the `rosbag info` / "
                          "`ros2 bag info` analog, ROS-free) and exit")
    src.add_argument("--synthetic", action="store_true", help="synthetic scene run")
    src.add_argument("--fleet", type=int, metavar="N",
                     help="synthetic fleet-serving demo: N camera streams, "
                          "one batched device call per tick")
    src.add_argument("--flight", choices=["level", "banked"],
                     help="closed-loop flight-sim regression gate: render "
                          "the trajectory (level = takeoff/cruise/yawing "
                          "descent; banked = acceleration-consistent "
                          "roll/pitch with vz), drive the node end-to-end, "
                          "print the FlightReport as one JSON line; exit 1 "
                          "when the trajectory budgets fail")
    ap.add_argument("--mount", default=None, metavar="R,P,Y",
                    help="--flight camera mount rotation, fixed-axis RPY "
                         "[rad] (e.g. 0,0,1.5708 for the reference's "
                         "90-deg-yawed mounting)")
    ap.add_argument("--flight-rmse-budget", type=float, default=0.15,
                    help="--flight xy-velocity RMSE gate [m/s]")
    src.add_argument("--ros", action="store_true",
                     help="run as a ROS1 node (runtime.RosBridge; needs rospy)")
    src.add_argument("--ros2", action="store_true",
                     help="run as a ROS2 node (runtime.Ros2Bridge; needs rclpy)")
    ap.add_argument("--camera-frame", default=None,
                    help="tf2 camera frame id (--ros live lookups; with "
                         "--replay of a ROS1/ROS2 bag, resolve camera->body "
                         "from the bag's /tf_static//tf instead of identity)")
    ap.add_argument("--uav-frame", default=None,
                    help="tf2 body frame id (see --camera-frame)")
    ap.add_argument("--uav-untilted-frame", default="fcu_untilted",
                    help="--ros: published twist frame id")
    ap.add_argument("--no-warmup", action="store_true",
                    help="--ros: skip the kernels' build and warm-up run before streaming")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--fps", type=float, default=20.0)
    ap.add_argument("--velocity", default="1.0,-0.3", help="synthetic vx,vy [m/s]")
    ap.add_argument("--height", type=float, default=2.0, help="UAV height [m]")
    ap.add_argument("--profile", action="store_true", help="print the profiler report")
    ap.add_argument("--record", metavar="FILE.ofrec",
                    help="with --synthetic or --flight: also record the frame stream")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.bag_info:
        return _run_bag_info(args.bag_info)

    import numpy as np

    from mrs_optic_flow_tpu_torch.config import load_config
    from mrs_optic_flow_tpu_torch.runtime import FrameStream, OpticFlowNode, SyntheticScene
    from mrs_optic_flow_tpu_torch.runtime.msgs import (
        CameraInfo,
        Float64Stamped,
        ImageMsg,
        Imu,
        Odometry,
    )
    from mrs_optic_flow_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:  # no CUDA device: never fall back to the CPU
        ap.error(str(e))
    # `--config ""` (a launch file's unset config arg) = the default
    cfg = load_config(args.config or None, overrides=_parse_overrides(args.overrides))
    dt = 1.0 / args.fps

    if args.ros:
        return _run_ros(args, cfg, device)
    if args.ros2:
        return _run_ros2(args, cfg, device)
    if args.flight:
        return _run_flight(args, cfg, device)
    if args.fleet is not None:
        return _run_fleet(ap, args, cfg, device)

    published = []
    log = (lambda s: None) if args.quiet else print
    node = OpticFlowNode(cfg, device=device, publish=lambda t, m: published.append((t, m)),
                         log=log)
    from mrs_optic_flow_tpu_torch.runtime.rosbag2 import is_rosbag2

    replay_rosbag2 = bool(args.replay) and is_rosbag2(args.replay)
    bag_replay = replay_rosbag2 or (args.replay or "").endswith(".bag")
    bag_tf = bag_replay and bool(args.camera_frame and args.uav_frame)
    if not bag_tf:  # bag tf mode resolves camera->body from /tf_static
        node.set_transforms((0.0, 0.0, 0.0, 1.0))
    if args.synthetic:
        v = tuple(float(x) for x in args.velocity.split(","))
        scene = SyntheticScene(uav_height=args.height)
        stream = FrameStream(node)
        scene.trajectory_events(stream, velocity=v, n_frames=args.frames, dt=dt)
        if args.record:
            from mrs_optic_flow_tpu_torch import native

            with native.Recorder(args.record, width=scene.width,
                                 height=scene.height_px) as rec:
                for i in range(args.frames):
                    t = 100.0 + i * dt
                    pos = (v[0] * i * dt, v[1] * i * dt)
                    # rounded like the engine's quantize_u8, so a replay of
                    # this file matches the run it records
                    rec.write(t, np.clip(np.round(scene.render(pos)), 0, 255)
                              .astype(np.uint8))
        stream.run()
        n_frames = args.frames
        truth = f" (true {v[0]:+.3f} {v[1]:+.3f})"
    elif bag_replay:
        # offline rosbag replay — ROS1 .bag (runtime/rosbag.py) or ROS2
        # .db3/.mcap/bag directory (runtime/rosbag2.py): topics auto-detected
        # by type; level-flight defaults fill roles the bag doesn't carry
        if replay_rosbag2:
            from mrs_optic_flow_tpu_torch.runtime.rosbag2 import replay_bag2 as _replay
        else:
            from mrs_optic_flow_tpu_torch.runtime.rosbag import replay_bag as _replay

        topics = {}
        for pin in args.bag_topic:
            role, sep, topic = pin.partition("=")
            if not sep or not role or not topic:
                ap.error(f"--bag-topic needs ROLE=TOPIC, got {pin!r}")
            topics[role] = topic
        n_frames = _replay(node, args.replay, topics or None,
                           default_height=args.height,
                           camera_frame=args.camera_frame,
                           uav_frame=args.uav_frame)
        truth = ""
    else:
        from mrs_optic_flow_tpu_torch import native

        with native.Replay(args.replay) as rep:
            ci_k = [420.0, 0, rep.width / 2, 0, 420.0, rep.height / 2, 0, 0, 1]
            node.on_camera_info(CameraInfo(k=ci_k, d=[0.0] * 5))
            n_frames = 0
            for stamp, frame in rep:
                n_frames += 1
                node.on_imu(Imu(stamp=stamp, angular_velocity=(0, 0, 0),
                                orientation=(0, 0, 0, 1)))
                node.on_odometry(Odometry(stamp=stamp, orientation=(0, 0, 0, 1)))
                node.on_height(Float64Stamped(stamp=stamp, value=args.height))
                node.on_image(ImageMsg(stamp=stamp, data=frame))
        truth = ""
    node.close()

    twists = [m for t, m in published if t.startswith("velocity_out")]
    for tw in twists:
        print(
            f"[{tw.stamp:10.3f}] {getattr(tw, 'frame_id', '?')}: "
            f"v = {tw.linear[0]:+.3f} {tw.linear[1]:+.3f} {tw.linear[2]:+.3f} m/s"
            + truth
        )
    print(f"{len(twists)} twists from {n_frames}"
          f"{' synthetic' if args.synthetic else ' replay'} frames; "
          f"health: {node.health}")
    if args.profile:
        print(node.profiler.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
