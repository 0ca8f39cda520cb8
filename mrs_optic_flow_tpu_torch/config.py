"""Node configuration of the port and its YAML loader.

:class:`NodeConfig` holds the fields the port's node reads, with defaults
equal to ``configs/default.yaml`` after the loader's normalization.
:func:`load_config` reads a YAML file into a :class:`NodeConfig` with the
JAX package's loading semantics (:mod:`mrs_optic_flow_tpu.config`, the
reference's ``mrs_lib::ParamLoader``, ``src/optic_flow.cpp:814-912``):

- **strict loading**: a missing required parameter raises ``ConfigError``;
- **version gate**: ``version`` must equal :data:`CONFIG_VERSION`;
- **overrides**: nested dicts merged over the tree (the launch-file
  override mechanism, ``launch/optic_flow.launch:31-58``);
- **normalization**: the scale-factor division of ``frame_size`` and
  ``sample_point_size`` (``:867-874``), an even frame size (``:945-947``),
  the method range (``:900-902``), ``num_of_chosen`` 2 under allsac;
- the calibration fallback chain and the optional ``tpu:`` block.

The card has no ``pyyaml``, so the file is read by :func:`read_yaml`, a
reader written with the standard library for the YAML subset that
``configs/*.yaml`` uses (its docstring lists it); anything outside the
subset raises ``ConfigError`` with its line number.
:meth:`NodeConfig.from_optic_flow_config` copies the fields from a JAX
``OpticFlowConfig``, so both nodes can run one configuration.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import warnings
from typing import Any, Mapping, Optional

#: the schema version this package understands (the reference's VERSION
#: constant checked at ``src/optic_flow.cpp:816-822``)
CONFIG_VERSION = "1.0.0"

DEFAULT_CONFIG = pathlib.Path(__file__).resolve().parent.parent / "configs" / "default.yaml"


class ConfigError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class NodeConfig:
    """The YAML parameters the port's node reads: method 4 short and long
    range, methods 3 and 5, each with or without scale/rotation, host
    preprocessing, the GUI and video recording.

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
    video_path: str = "/dev/null"  # .ofrec: native Recorder; else an AVI
    video_fps: int = 30
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


# --------------------------------------------------------------------------- #
# the YAML subset reader                                                       #
# --------------------------------------------------------------------------- #

_KEY_LINE = re.compile(r"([A-Za-z_][A-Za-z0-9_.\-]*)[ ]*:(?:[ \t]+(.*)|)$")
#: YAML 1.1 scalars as pyyaml's resolver reads them
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
#: floats pyyaml reads as floats: a dot is required, an exponent has a sign
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?|\.[0-9]+(?:[eE][-+][0-9]+)?")
_SPECIAL_FLOAT = {
    ".inf": float("inf"), ".Inf": float("inf"), ".INF": float("inf"),
    "+.inf": float("inf"), "+.Inf": float("inf"), "+.INF": float("inf"),
    "-.inf": float("-inf"), "-.Inf": float("-inf"), "-.INF": float("-inf"),
    ".nan": float("nan"), ".NaN": float("nan"), ".NAN": float("nan"),
}
#: numbers in the other forms pyyaml resolves (octal, hex, binary,
#: sexagesimal, underscores): outside the subset
_EXOTIC_NUMBER = re.compile(
    r"[-+]?(?:0b[01_]+|0[0-7_]+|0x[0-9a-fA-F_]+|[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[0-9_]*_[0-9_]*(?:\.[0-9_]*)?(?:[eE][-+][0-9]+)?)"
)
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"


def _fail(lineno: int, what: str) -> ConfigError:
    return ConfigError(f"line {lineno}: {what} (outside the YAML subset that configs/*.yaml uses)")


def _strip_comment(text: str) -> str:
    """``text`` without an inline comment: a ``#`` after whitespace."""
    m = re.search(r"[ \t]#", text)
    return (text[: m.start()] if m else text).rstrip(" \t")


def _quoted(text: str, lineno: int):
    """A single- or double-quoted scalar, then only an optional comment."""
    q = text[0]
    if q == "'":
        m = re.match(r"'((?:[^']|'')*)'", text)
        value = m.group(1).replace("''", "'") if m else None
    else:
        m = re.match(r'"((?:[^"\\]|\\.)*)"', text)
        value = None
        if m:
            try:
                value = json.loads(m.group(0))
            except ValueError:
                raise _fail(lineno, f"an escape that is not JSON's in {m.group(0)}") from None
    if m is None:
        raise _fail(lineno, f"an unterminated or multi-line quoted scalar {text}")
    rest = text[m.end():]
    if rest.strip() and not re.match(r"[ \t]+#", rest):
        raise _fail(lineno, f"text after a quoted scalar: {rest.strip()!r}")
    return value


def _scalar(text: str, lineno: int):
    """A scalar value as pyyaml's ``safe_load`` resolves it."""
    if text[:1] in ("'", '"'):
        return _quoted(text, lineno)
    text = _strip_comment(text)
    if text in _NULL:
        return None
    if text[0] in _INDICATORS and (text[0] not in "-?:" or text[1:2] in ("", " ", "\t")):
        raise _fail(lineno, f"a value starting with {text[0]!r} (flow collection, anchor, alias, "
                            "tag, block scalar or sequence)")
    if ": " in text or text.endswith(":"):
        raise _fail(lineno, f"a mapping inside a value: {text!r}")
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if text in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[text]
    if _EXOTIC_NUMBER.fullmatch(text):
        raise _fail(lineno, f"the number form {text!r}")
    return text


def read_yaml(text: str) -> Optional[dict]:
    """Parse the YAML subset of ``configs/*.yaml`` into nested dicts, as
    ``yaml.safe_load`` would:

    - block maps nested by indentation (spaces);
    - full-line and inline ``#`` comments;
    - quoted (single, or double with JSON's escapes) and bare strings;
    - ints, floats (YAML 1.1: a dot, an exponent with its sign), ``.inf``,
      ``.nan``, booleans (``true``/``false`` and YAML 1.1's ``yes``/``no``/
      ``on``/``off``), ``null``/``~``;
    - a bare ``key:`` with nothing nested under it reads as ``None`` (the
      ``tpu:`` header).

    Sequences, flow collections, anchors and aliases, tags, block scalars,
    multi-line scalars, quoted or non-string keys, duplicate keys, document
    markers and tabs in the indentation raise ``ConfigError`` naming the
    line.  An empty document gives ``None``.
    """
    root: dict = {}
    #: (indent, map) from the root to the innermost open map
    stack: list = []
    #: the last key read with no value: a map may be nested under it
    pending = None  # (parent map, key)
    for lineno, raw in enumerate(text.splitlines(), start=1):
        stripped = raw.strip(" \t\r")
        if not stripped or stripped.startswith("#"):
            continue
        body = raw.lstrip(" ")
        indent = len(raw) - len(body)
        if body.startswith("\t"):
            raise _fail(lineno, "a tab in the indentation")
        if stripped in ("---", "...") or stripped.startswith(("--- ", "%")):
            raise _fail(lineno, "a document marker or directive")
        m = _KEY_LINE.match(body.rstrip(" \t\r"))
        if m is None:
            raise _fail(lineno, f"not a 'key: value' line: {body.strip()!r}")
        key, value_text = m.group(1), m.group(2)
        if not stack:
            stack.append((indent, root))
        elif pending is not None and indent > stack[-1][0]:
            # the first key of a map nested under the pending key
            parent, pkey = pending
            parent[pkey] = {}
            stack.append((indent, parent[pkey]))
        else:
            while stack and stack[-1][0] > indent:
                stack.pop()
            if not stack or stack[-1][0] != indent:
                raise _fail(lineno, "an indentation that matches no enclosing map")
        target = stack[-1][1]
        if _scalar(key, lineno) != key:
            raise _fail(lineno, f"the non-string key {key!r}")
        if key in target:
            raise _fail(lineno, f"the duplicate key {key!r}")
        value_text = (value_text or "").strip(" \t\r")
        if not value_text or value_text.startswith("#"):
            target[key] = None
            pending = (target, key)
        else:
            target[key] = _scalar(value_text, lineno)
            pending = None
    return root or None


# --------------------------------------------------------------------------- #
# the loader                                                                   #
# --------------------------------------------------------------------------- #

def _require(tree: Mapping[str, Any], path: str) -> Any:
    """Strict lookup of a slash-separated path; missing -> ConfigError."""
    node: Any = tree
    for part in path.split("/"):
        if not isinstance(node, Mapping) or part not in node:
            raise ConfigError(f"missing required parameter: {path!r}")
        node = node[part]
    return node


def _merge(base: dict, override: Mapping[str, Any]) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), Mapping):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(
    path: str | pathlib.Path | None = None,
    overrides: Optional[Mapping[str, Any]] = None,
    *,
    expected_version: str = CONFIG_VERSION,
) -> NodeConfig:
    """Load, check and normalize a config tree into a :class:`NodeConfig`.

    ``path`` defaults to the repository's ``configs/default.yaml``;
    ``overrides`` is merged on top (the launch-file override path)."""
    with open(DEFAULT_CONFIG if path is None else path) as f:
        tree = read_yaml(f.read())
    if not isinstance(tree, dict):
        raise ConfigError(f"{path or DEFAULT_CONFIG}: the config is empty")
    if overrides:
        tree = _merge(tree, overrides)

    version = str(_require(tree, "version"))
    if version != expected_version:
        raise ConfigError(
            f"config version {version!r} does not match the framework's "
            f"{expected_version!r} — please update the config (version gate, "
            "src/optic_flow.cpp:816-822)"
        )

    of = "mrs_optic_flow"
    scale_factor = float(_require(tree, f"{of}/scale_factor"))
    frame_size = int(_require(tree, f"{of}/frame_size"))
    sample_point_size = int(_require(tree, f"{of}/sample_point_size"))
    # scale-factor division (src/optic_flow.cpp:867-874)
    if abs(scale_factor - 1.0) > 0.01:
        frame_size = int(frame_size / scale_factor)
        sample_point_size = int(sample_point_size / scale_factor)
    # even frame size (src/optic_flow.cpp:945-947)
    if frame_size % 2 == 1:
        frame_size -= 1

    method = int(_require(tree, f"{of}/method"))
    if method < 3 or method > 5:
        raise ConfigError(
            f"no such optic-flow method {method} (3 = block matching, "
            "4 = FFT, 5 = spaced block matching; src/optic_flow.cpp:900-902)"
        )

    # the calibration block is optional (loadParam with default 1.0,
    # src/optic_flow.cpp:884); the per-axis ratios fall back to the common
    # one (:882-887).  The node does not apply them, like the reference, but
    # a malformed block fails here as it does in the JAX loader.
    calib = tree[of].get("calibration") or {}
    calib_both = float(calib.get("both_velocity_correction_ratio", 1.0))
    float(calib.get("x_velocity_correction_ratio", calib_both))
    float(calib.get("y_velocity_correction_ratio", calib_both))

    filter_method = str(_require(tree, f"{of}/filter_method"))
    num_of_chosen = int(_require(tree, f"{of}/ransac/num_of_chosen"))
    num_of_iter = int(_require(tree, f"{of}/ransac/num_of_iter"))
    threshold_rad = float(_require(tree, f"{of}/ransac/threshold_rad"))
    # allsac cannot honour another hypothesis size (ARCHITECTURE.md deviation
    # 13); the other non-ransac methods warn like the reference (:933-935)
    if filter_method != "ransac" and num_of_chosen != 2:
        if filter_method == "allsac":
            raise ConfigError("with allsac filtering, ransac/num_of_chosen must be 2")
        warnings.warn(
            "[OpticFlow]: When Allsac is enabled, the ransac/num_of_chosen "
            "can be only 2.", stacklevel=2,
        )

    scan_radius = int(_require(tree, f"{of}/scan_radius"))
    # optional block; a bare `tpu:` header reads as None
    tpu = tree.get("tpu") or {}

    def req(name: str):
        return _require(tree, name)

    # in the JAX loader's order, so a file missing several parameters names
    # the same one first; debug, silent_debug, the bounding switches,
    # rotation_correction and the physical constraints other than
    # max_pixel_speed are required but not read by the node
    gui = bool(req("gui"))
    req("debug"), req("silent_debug")
    ang_rate_source, raw_output = str(req("ang_rate_source")), bool(req("raw_output"))
    scale_rotation = bool(req("scale_rotation"))
    scale_rot_magnitude = float(req("scale_rot_magnitude"))
    scale_rot_output = str(req("scale_rot_output"))
    scale_rot_interp = str(tree.get("scale_rot_interp", "lanczos4"))
    scale_rot_lp_resolution = int(tree.get("scale_rot_lp_resolution", 0))
    scale_rot_max_tilt = float(tree.get("scale_rot_max_tilt", 0.05))
    scale_rot_max_tilt_rate = float(tree.get("scale_rot_max_tilt_rate", 0.3))
    store_video, video_path = bool(req("store_video")), str(req("video_path"))
    video_fps = int(req("video_fps"))
    long_range_mode = str(req(f"{of}/long_range_mode"))
    takeoff_height = float(req(f"{of}/takeoff_height"))
    shifted_pts_thr = int(req(f"{of}/shifted_pts_thr"))
    max_processing_rate = float(req(f"{of}/max_processing_rate"))
    step_size = int(req(f"{of}/step_size"))
    req(f"{of}/apply_abs_bouding"), req(f"{of}/apply_rel_bouding"), req(f"{of}/rotation_correction")
    tilt_correction = bool(req(f"{of}/tilt_correction"))
    minimum_tilt_correction = float(req(f"{of}/minimum_tilt_correction"))
    analyze_duration = float(req(f"{of}/filtering/analyze_duration"))
    max_pixel_speed = float(req("constraints/max_pixel_speed"))
    for name in ("max_horizontal_speed", "max_horizontal_acceleration", "max_vertical_speed",
                 "max_yaw_rate", "speed_noise"):
        float(req(f"constraints/{name}"))

    return NodeConfig(
        method=method,
        long_range_mode=long_range_mode,
        takeoff_height=takeoff_height,
        long_range_ratio=int(tpu.get("long_range_ratio", 4)),
        scale_rotation=scale_rotation,
        host_preprocess=bool(tpu.get("host_preprocess", False)),
        gui=gui,
        store_video=store_video,
        video_path=video_path,
        video_fps=video_fps,
        ang_rate_source=ang_rate_source,
        raw_output=raw_output,
        scale_rot_magnitude=scale_rot_magnitude,
        scale_rot_output=scale_rot_output,
        scale_rot_interp=scale_rot_interp,
        scale_rot_lp_resolution=scale_rot_lp_resolution,
        scale_rot_max_tilt=scale_rot_max_tilt,
        scale_rot_max_tilt_rate=scale_rot_max_tilt_rate,
        max_processing_rate=max_processing_rate,
        shifted_pts_thr=shifted_pts_thr,
        scan_radius=scan_radius,
        step_size=step_size,
        frame_size=frame_size,
        sample_point_size=sample_point_size,
        filter_method=filter_method,
        scale_factor=scale_factor,
        tilt_correction=tilt_correction,
        minimum_tilt_correction=minimum_tilt_correction,
        ransac_num_of_chosen=num_of_chosen,
        ransac_num_of_iter=num_of_iter,
        ransac_threshold_rad=threshold_rad,
        analyze_duration=analyze_duration,
        max_pixel_speed=max_pixel_speed,
        use_pallas=bool(tpu.get("use_pallas", True)),
        use_pallas_explicit="use_pallas" in tpu,
        backend=str(tpu.get("backend", "dft")),
        quantize_8bit=bool(tpu.get("quantize_8bit", True)),
        # a YAML `true` means 3 passes, not int(True) == 1
        mxu_passes=3 if tpu.get("mxu_passes", 3) is True else int(tpu.get("mxu_passes", 3)),
        half_spectrum=bool(tpu.get("half_spectrum", True)),
        pairs_per_step=None if tpu.get("pairs_per_step") is None else int(tpu["pairs_per_step"]),
        band_stack=None if tpu.get("band_stack") is None else int(tpu["band_stack"]),
    )
