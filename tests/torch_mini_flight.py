"""The mini flight through the port's node and the JAX node on the same
frames (not a test module: ``test_torch_flightsim.py`` imports it).

``test_flight_mini_smoke``'s profile, 160 px renders of ``SyntheticScene``
seeded ``scene_seed``, 128 px frames; the port's node on the CPU with its
RANSAC generator seeded ``draw_seed``, the JAX node with ``PRNGKey(draw_seed)``.
The two nodes draw other RANSAC hypotheses from the same seed, so their
``rmse_xy`` differ by what the draws change.  Run as a script it prints that
difference over scene and draw seeds, the reading behind
``test_torch_flightsim.MINI_RMSE_TOL``:

    python tests/torch_mini_flight.py [--scene-seeds 9,1,2,3,4,5,6] [--draw-seeds 0,1,2,3]
"""

from __future__ import annotations

MINI_OVERRIDES = {"mrs_optic_flow": {"frame_size": 128, "sample_point_size": 32,
                                     "long_range_mode": "height_based", "takeoff_height": 1.7}}
MINI_PROFILE = dict(takeoff_frames=8, cruise_frames=6, descent_frames=8,
                    h0=1.4, h_cruise=2.0, h_final=1.6)
MINI_SCENE = dict(width=160, height_px=160, fx=120.0, fy=120.0, texture_cutoff=0.3,
                  texture_scale=60.0, seed=9)


def fly_pair(scene_seed: int = MINI_SCENE["seed"], draw_seed: int = 0):
    """``((report, node, published) of the port, (report, node, published)
    of JAX)`` for one mini flight on the same float frames."""
    import jax

    from mrs_optic_flow_tpu.config import load_config as jax_load_config
    from mrs_optic_flow_tpu.runtime import flightsim as jax_fs
    from mrs_optic_flow_tpu.runtime import stream as jax_stream
    from mrs_optic_flow_tpu.runtime.node import OpticFlowNode as JaxNode
    from mrs_optic_flow_tpu_torch.config import load_config
    from mrs_optic_flow_tpu_torch.runtime import flightsim as port_fs
    from mrs_optic_flow_tpu_torch.runtime import stream as port_stream
    from mrs_optic_flow_tpu_torch.runtime.node import OpticFlowNode

    scene = {**MINI_SCENE, "seed": scene_seed}
    samples = port_fs.takeoff_cruise_descent_profile(**MINI_PROFILE)
    sim = port_fs.FlightSimulator(samples, scene=port_stream.SyntheticScene(**scene))
    frames = sim.frames()
    published = []
    node = OpticFlowNode(load_config(overrides=MINI_OVERRIDES), device="cpu",
                         publish=lambda t, m: published.append((t, m)), log=lambda s: None)
    node._gen.manual_seed(draw_seed)
    node.set_transforms((0.0, 0.0, 0.0, 1.0))
    stream = port_stream.FrameStream(node)
    sim.events_into(stream, frames)
    stream.run()
    rep = port_fs.evaluate_flight(samples, published)

    jax_samples = jax_fs.takeoff_cruise_descent_profile(**MINI_PROFILE)
    jax_sim = jax_fs.FlightSimulator(jax_samples, scene=jax_stream.SyntheticScene(**scene))
    jax_pub = []
    jax_node = JaxNode(jax_load_config(overrides=MINI_OVERRIDES),
                       publish=lambda t, m: jax_pub.append((t, m)), log=lambda s: None,
                       enable_profiler=False)
    jax_node._key = jax.random.PRNGKey(draw_seed)
    jax_node.set_transforms((0.0, 0.0, 0.0, 1.0))
    stream = jax_stream.FrameStream(jax_node)
    jax_sim.events_into(stream, frames)
    stream.run()
    jax_rep = jax_fs.evaluate_flight(jax_samples, jax_pub)
    return (rep, node, published), (jax_rep, jax_node, jax_pub)


def main(argv=None) -> int:
    import argparse
    import json

    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    torch.set_num_threads(1)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene-seeds", default="9,1,2,3,4,5,6")
    ap.add_argument("--draw-seeds", default="0,1,2,3")
    args = ap.parse_args(argv)
    diffs = []
    for s in (int(v) for v in args.scene_seeds.split(",")):
        for k in (int(v) for v in args.draw_seeds.split(",")):
            (rep, _, _), (jax_rep, _, _) = fly_pair(s, k)
            d = abs(rep.rmse_xy - jax_rep.rmse_xy)
            diffs.append(d)
            print(json.dumps({"scene_seed": s, "draw_seed": k, "rmse_port": rep.rmse_xy,
                              "rmse_jax": jax_rep.rmse_xy, "abs_diff": d}), flush=True)
    diffs.sort()
    print(json.dumps({"pairs": len(diffs), "max_abs_diff": diffs[-1],
                      "median_abs_diff": diffs[len(diffs) // 2]}))
    return 0


if __name__ == "__main__":
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    raise SystemExit(main())
