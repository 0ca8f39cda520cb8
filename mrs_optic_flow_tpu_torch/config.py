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
    """The YAML parameters of the ported node paths: method 4 short and long
    range, methods 3 and 5, each with or without scale/rotation.

    ``host_preprocess``, ``gui`` and ``store_video`` are checked by the
    node, which rejects any value outside the ported paths.
    ``long_range_ratio`` is the YAML's ``tpu.long_range_ratio``.  ``ransac_num_of_chosen``, ``ransac_num_of_iter`` and
    ``ransac_threshold_rad`` are the YAML's ``ransac`` block.
    ``use_pallas_explicit`` says whether the YAML set ``use_pallas``; the
    SAD engines follow ``use_pallas`` only then.  ``mxu_passes``,
    ``half_spectrum``, ``pairs_per_step`` and ``band_stack`` are the JAX
    package's TPU tiling knobs: accepted so that a YAML carries over, and
    ignored.
    """

    method: int = 4
    long_range_mode: str = "always_off"  # always_off | always_on | height_based | takeoff_based
    takeoff_height: float = 1.0  # [m], the height_based threshold
    long_range_ratio: int = 4
    scale_rotation: bool = False
    host_preprocess: bool = False
    gui: bool = False
    store_video: bool = False
    ang_rate_source: str = "imu"  # imu | odometry | odometry_diff
    raw_output: bool = True
    scale_rot_magnitude: float = 49.9
    scale_rot_output: str = "velocity"  # velocity | altitude
    scale_rot_interp: str = "lanczos4"  # lanczos4 | bilinear
    scale_rot_lp_resolution: int = 0  # 0 = frame_size
    scale_rot_max_tilt: float = 0.05  # [rad], deviation 23
    scale_rot_max_tilt_rate: float = 0.3  # [rad/s]
    max_processing_rate: float = 500.0
    shifted_pts_thr: int = 8
    scan_radius: int = 21
    step_size: int = 24
    frame_size: int = 480
    sample_point_size: int = 120
    filter_method: str = "allsac"  # allsac | ransac | average
    scale_factor: float = 1.0
    tilt_correction: bool = True
    minimum_tilt_correction: float = 0.0
    ransac_num_of_chosen: int = 2
    ransac_num_of_iter: int = 50
    ransac_threshold_rad: float = 1.0
    analyze_duration: float = 1.0
    max_pixel_speed: float = 80.0  # constraints/max_pixel_speed
    use_pallas: bool = True
    use_pallas_explicit: bool = False
    backend: str = "dft"
    quantize_8bit: bool = True
    mxu_passes: int = 3
    half_spectrum: bool = True
    pairs_per_step: int | None = None
    band_stack: int | None = None

    @classmethod
    def from_optic_flow_config(cls, cfg) -> "NodeConfig":
        """Copy the fields from a JAX ``OpticFlowConfig`` by attribute
        (``max_pixel_speed`` from ``cfg.constraints``, the ``ransac_*``
        fields from ``cfg.ransac``)."""
        nested = {
            "max_pixel_speed": cfg.constraints.max_pixel_speed,
            "ransac_num_of_chosen": cfg.ransac.num_of_chosen,
            "ransac_num_of_iter": cfg.ransac.num_of_iter,
            "ransac_threshold_rad": cfg.ransac.threshold_rad,
        }
        values = {
            f.name: nested[f.name] if f.name in nested else getattr(cfg, f.name)
            for f in dataclasses.fields(cls)
        }
        return cls(**values)
