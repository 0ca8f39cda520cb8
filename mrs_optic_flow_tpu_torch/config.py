"""Node configuration of the port.

:mod:`mrs_optic_flow_tpu.config` loads the YAML tree with ``pyyaml``, which
the port does not depend on.  :class:`NodeConfig` holds the fields the
port's node reads, with defaults equal to ``configs/default.yaml`` after the
JAX loader's normalization; :meth:`NodeConfig.from_optic_flow_config` copies
them from a loaded ``OpticFlowConfig`` so both nodes can run one YAML.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NodeConfig:
    """The YAML parameters of the short-range node path.

    ``method``, ``long_range_mode``, ``scale_rotation``, ``host_preprocess``,
    ``gui`` and ``store_video`` are checked by the node, which rejects any
    value outside the ported path.  ``mxu_passes``, ``half_spectrum``,
    ``pairs_per_step`` and ``band_stack`` are the JAX package's TPU tiling
    knobs: accepted so that a YAML carries over, and ignored.
    """

    method: int = 4
    long_range_mode: str = "always_off"
    scale_rotation: bool = False
    host_preprocess: bool = False
    gui: bool = False
    store_video: bool = False
    ang_rate_source: str = "imu"  # imu | odometry | odometry_diff
    raw_output: bool = True
    max_processing_rate: float = 500.0
    shifted_pts_thr: int = 8
    frame_size: int = 480
    sample_point_size: int = 120
    scale_factor: float = 1.0
    tilt_correction: bool = True
    minimum_tilt_correction: float = 0.0
    analyze_duration: float = 1.0
    max_pixel_speed: float = 80.0  # constraints/max_pixel_speed
    use_pallas: bool = True
    backend: str = "dft"
    quantize_8bit: bool = True
    mxu_passes: int = 3
    half_spectrum: bool = True
    pairs_per_step: int | None = None
    band_stack: int | None = None

    @classmethod
    def from_optic_flow_config(cls, cfg) -> "NodeConfig":
        """Copy the fields from a JAX ``OpticFlowConfig`` by attribute
        (``max_pixel_speed`` from ``cfg.constraints``)."""
        values = {
            f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(cls)
            if f.name != "max_pixel_speed"
        }
        return cls(max_pixel_speed=cfg.constraints.max_pixel_speed, **values)
