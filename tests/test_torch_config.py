"""The port's config loader against the JAX package's.

``mrs_optic_flow_tpu_torch.config.load_config`` reads the YAML with its own
reader (the card has no pyyaml) and must give, field by field, what the JAX
``load_config`` gives through ``NodeConfig.from_optic_flow_config``: on
``configs/default.yaml`` and on every case of an override matrix, errors
included (same exception type, same message).  The reader itself is held to
``yaml.safe_load`` (pyyaml is here only for the JAX side) on every file in
``configs/`` and on hand-written snippets, and every construct outside its
subset raises ``ConfigError`` naming its line.
"""

import pathlib
import warnings

import pytest
import yaml

from mrs_optic_flow_tpu import config as jax_config
from mrs_optic_flow_tpu_torch import config as port_config
from mrs_optic_flow_tpu_torch.config import ConfigError, NodeConfig, load_config, read_yaml

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))


def _both(path=None, overrides=None, **kw):
    """(port result, JAX result as a NodeConfig); an exception is returned
    as (type name, message) so both sides compare."""
    out = []
    for load in (lambda: load_config(path, overrides, **kw),
                 lambda: NodeConfig.from_optic_flow_config(
                     jax_config.load_config(path, overrides, **kw))):
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                value = load()
            out.append((value, [str(w.message) for w in caught]))
        except (port_config.ConfigError, jax_config.ConfigError) as e:
            out.append(((type(e).__name__, str(e)), []))
    return out


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_load_config_matches_jax_on_every_file(path):
    (ours, w_ours), (theirs, w_theirs) = _both(path)
    assert isinstance(ours, NodeConfig)
    assert ours == theirs and w_ours == w_theirs


def test_default_path_is_default_yaml():
    assert load_config() == load_config(REPO / "configs" / "default.yaml")
    assert load_config() == NodeConfig()


OVERRIDES = {
    "scale_factor_2.0": {"mrs_optic_flow": {"scale_factor": 2.0}},
    "scale_factor_1.5": {"mrs_optic_flow": {"scale_factor": 1.5}},
    "scale_factor_0.8": {"mrs_optic_flow": {"scale_factor": 0.8}},
    "scale_factor_1.005": {"mrs_optic_flow": {"scale_factor": 1.005}},
    "odd_frame_size": {"mrs_optic_flow": {"frame_size": 481, "sample_point_size": 120}},
    "odd_after_scale": {"mrs_optic_flow": {"frame_size": 455, "scale_factor": 1.3}},
    "method_2": {"mrs_optic_flow": {"method": 2}},
    "method_3": {"mrs_optic_flow": {"method": 3}},
    "method_5": {"mrs_optic_flow": {"method": 5}},
    "method_6": {"mrs_optic_flow": {"method": 6}},
    "allsac_3_chosen": {"mrs_optic_flow": {"ransac": {"num_of_chosen": 3}}},
    "average_3_chosen": {"mrs_optic_flow": {"filter_method": "average",
                                            "ransac": {"num_of_chosen": 3}}},
    "ransac_3_chosen": {"mrs_optic_flow": {"filter_method": "ransac",
                                           "ransac": {"num_of_chosen": 3}}},
    "missing_key": {"mrs_optic_flow": {"takeoff_height": None}},
    "missing_block": {"constraints": "none"},
    "wrong_version": {"version": "0.9.0"},
    "bare_tpu": {"tpu": None},
    "mxu_passes_true": {"tpu": {"mxu_passes": True}},
    "mxu_passes_1": {"tpu": {"mxu_passes": 1}},
    "tpu_block": {"tpu": {"use_pallas": False, "backend": "fft", "pairs_per_step": 2,
                          "band_stack": 1, "long_range_ratio": 2, "quantize_8bit": False,
                          "host_preprocess": True, "half_spectrum": False}},
    "calibration_axes": {"mrs_optic_flow": {"calibration": {"x_velocity_correction_ratio": 1.1}}},
    "no_calibration": {"mrs_optic_flow": {"calibration": None}},
    "recording": {"store_video": True, "video_path": "out.ofrec", "video_fps": 15, "gui": True},
    "scale_rotation_optional": {"scale_rotation": True, "scale_rot_lp_resolution": 240,
                                "scale_rot_interp": "bilinear", "scale_rot_max_tilt": 0.1,
                                "scale_rot_max_tilt_rate": 0.5},
    "strings_cast": {"mrs_optic_flow": {"frame_size": "320", "sample_point_size": "80"}},
}


@pytest.mark.parametrize("name", OVERRIDES)
def test_override_matrix_matches_jax(name, tmp_path):
    """Every normalization, check and fallback of the JAX loader on the
    same tree: values, warnings and errors alike."""
    overrides = OVERRIDES[name]
    if name == "missing_key":
        # a None leaf is a value, not a missing key: drop the key instead
        tree = yaml.safe_load((REPO / "configs" / "default.yaml").read_text())
        del tree["mrs_optic_flow"]["takeoff_height"]
        path = tmp_path / "missing.yaml"
        path.write_text(yaml.safe_dump(tree))
        (ours, w_ours), (theirs, w_theirs) = _both(path)
    else:
        (ours, w_ours), (theirs, w_theirs) = _both(None, overrides)
    assert ours == theirs, (ours, theirs)
    assert w_ours == w_theirs


@pytest.mark.parametrize("name,raises", [
    ("method_2", "no such optic-flow method 2"), ("method_6", "no such optic-flow method 6"),
    ("allsac_3_chosen", "allsac"), ("wrong_version", "does not match"),
    ("missing_block", "missing required parameter"),
])
def test_override_errors(name, raises):
    with pytest.raises(ConfigError, match=raises):
        load_config(overrides=OVERRIDES[name])


def test_average_with_three_chosen_warns():
    with pytest.warns(UserWarning, match="num_of_chosen"):
        cfg = load_config(overrides=OVERRIDES["average_3_chosen"])
    assert cfg.ransac_num_of_chosen == 3 and cfg.filter_method == "average"


@pytest.mark.parametrize("scale,frame,patch", [(2.0, 240, 60), (1.5, 320, 80), (0.8, 600, 150)])
def test_scale_factor_divides_the_sizes(scale, frame, patch):
    """Repair R1: ``scale_factor`` divides ``frame_size`` and
    ``sample_point_size`` at load, in both packages (2.0 gives 240 / 60)."""
    overrides = {"mrs_optic_flow": {"scale_factor": scale}}
    ours = load_config(overrides=overrides)
    theirs = jax_config.load_config(overrides=overrides)
    assert (ours.frame_size, ours.sample_point_size) == (frame, patch)
    assert (theirs.frame_size, theirs.sample_point_size) == (frame, patch)


def test_bare_tpu_header_file(tmp_path):
    """A ``tpu:`` header with nothing under it reads as ``None`` and takes
    the block's defaults."""
    text = (REPO / "configs" / "default.yaml").read_text()
    head = text[: text.index("\ntpu:")]
    path = tmp_path / "bare_tpu.yaml"
    path.write_text(head + "\ntpu:\n  # nothing set\n")
    assert read_yaml(path.read_text())["tpu"] is None
    (ours, _), (theirs, _) = _both(path)
    assert ours == theirs == NodeConfig()


def test_mxu_passes_true_is_three():
    assert load_config(overrides={"tpu": {"mxu_passes": True}}).mxu_passes == 3
    assert load_config(overrides={"tpu": {"mxu_passes": 1}}).mxu_passes == 1


def test_expected_version_gate():
    with pytest.raises(ConfigError, match="version"):
        load_config(expected_version="2.0.0")


# --------------------------------------------------------------------------- #
# the reader                                                                   #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_reader_matches_safe_load_on_configs(path):
    text = path.read_text()
    assert read_yaml(text) == yaml.safe_load(text)


SNIPPETS = {
    "nested": "a:\n  b:\n    c: 1\n  d: 2\ne: 3\n",
    "comments": "# head\na: 1  # inline\n  # indented comment\nb: 'x # not a comment'\n"
                "c: \"y # nor this\"  # but this\nd: e#f\n",
    "strings": "a: hello world\nb: 'it''s'\nc: \"tab\\tnew\\nline\"\nd: /dev/null\n"
               "e: x-y_z.w\nf: \"1.0.0\"\ng: '42'\n",
    "ints": "a: 0\nb: -7\nc: +12\nd: 480\n",
    "floats": "a: 1.0\nb: -0.5\nc: 1.5e+3\nd: 2.E-2\ne: .25\nf: 3.\ng: 1e-3\nh: 1.0e3\n"
              "i: -.5\nj: .inf\nk: -.Inf\n",
    "bools": "a: true\nb: false\nc: True\nd: FALSE\ne: yes\nf: no\ng: on\nh: Off\n",
    "nulls": "a: null\nb: ~\nc:\nd: Null\n",
    "bare_header_then_sibling": "tpu:\nother: 1\n",
    "bare_header_with_comments": "tpu:\n  # only comments\n  # here\nx: 1\n",
    "deep_dedent": "a:\n  b:\n    c:\n      d: 1\ne: 2\n",
    "indent_of_four": "a:\n    b: 1\n    c:\n        d: 2\n",
    "trailing_spaces": "a: 1   \nb:   two  \n",
    "key_with_dots": "a.b: 1\nc-d: 2\n",
    "not_numbers": "a: 08\nb: 1.2.3\nc: 0.5x\nd: 12abc\n",
    "colon_in_value": "a: http://x\nb: c:d\n",
    "empty": "",
    "only_comments": "# nothing\n\n   # here\n",
}


@pytest.mark.parametrize("name", SNIPPETS)
def test_reader_matches_safe_load_on_snippets(name):
    text = SNIPPETS[name]
    ours, theirs = read_yaml(text), yaml.safe_load(text)
    assert ours == theirs or (repr(ours) == repr(theirs)), (ours, theirs)


UNSUPPORTED = {
    "flow_sequence": ("a: 1\nb: [1, 2]\n", 2),
    "flow_map": ("a:\n  b: {c: 1}\n", 2),
    "anchor": ("a: &x 1\n", 1),
    "alias": ("a: 1\nb: *a\n", 2),
    "block_literal": ("a: |\n  text\n", 1),
    "block_folded": ("x: 1\na: >\n  text\n", 2),
    "tag": ("a: !!str 1\n", 1),
    "sequence": ("a:\n  - 1\n  - 2\n", 2),
    "tab_indent": ("a:\n\tb: 1\n", 2),
    "multi_line_quoted": ("a: \"open\n  close\"\n", 1),
    "multi_line_plain": ("a: one\n  two\n", 2),
    "duplicate_key": ("a: 1\nb: 2\na: 3\n", 3),
    "document_marker": ("---\na: 1\n", 1),
    "directive": ("%YAML 1.1\na: 1\n", 1),
    "octal": ("a: 010\n", 1),
    "hex": ("a: 0x1F\n", 1),
    "sexagesimal": ("a: 1:30\n", 1),
    "underscore_number": ("a: 1_000\n", 1),
    "bad_dedent": ("a:\n    b: 1\n  c: 2\n", 3),
    "quoted_key": ("\"a\": 1\n", 1),
    "non_string_key": ("true: 1\n", 1),
    "mapping_in_value": ("a: b: c\n", 1),
    "text_after_quote": ("a: 'x' y\n", 1),
    "non_json_escape": ("a: \"\\x41\"\n", 1),
    "complex_key": ("? a\n: 1\n", 1),
}


@pytest.mark.parametrize("name", UNSUPPORTED)
def test_reader_refuses_unsupported_syntax(name):
    """Outside the subset: ``ConfigError`` naming the line, never a silent
    misparse."""
    text, line = UNSUPPORTED[name]
    with pytest.raises(ConfigError, match=rf"^line {line}: "):
        read_yaml(text)


def test_load_config_empty_file_raises(tmp_path):
    path = tmp_path / "empty.yaml"
    path.write_text("# nothing\n")
    with pytest.raises(ConfigError, match="empty"):
        load_config(path)
