"""The port's config loading against the JAX package's: its YAML subset
reader against PyYAML on the shipped files, the leaf keys (JAX's 109) and
their defaults, the merged field values, and merge_from_list's coercion,
for every key."""
import json
from dataclasses import fields, is_dataclass
from pathlib import Path

import pytest
import yaml

from unet_watermark_tpu.configs import get_cfg_defaults as jax_defaults
from unet_watermark_tpu.configs import update_config as jax_update
from unet_watermark_tpu_torch.configs import (DEFAULT_CONFIG,
                                              get_cfg_defaults,
                                              update_config, yaml_subset)

REPO = Path(__file__).resolve().parents[1]
NAMES = ["unet_watermark.yaml", "unet_watermark_large.yaml",
         "unet_text_watermark.yaml"]
JAX_DIR = REPO / "unet_watermark_tpu" / "configs"
PORT_DIR = DEFAULT_CONFIG.parent


def _paths(node, prefix=""):
    """Every leaf field of the port's tree, as a dotted path."""
    for f in fields(node):
        value = getattr(node, f.name)
        if is_dataclass(value):
            yield from _paths(value, f"{prefix}{f.name}.")
        else:
            yield f"{prefix}{f.name}"


@pytest.mark.parametrize("name", NAMES)
def test_reader_equals_pyyaml_on_the_shipped_files(name):
    for path in (JAX_DIR / name, PORT_DIR / name):
        text = path.read_text()
        assert yaml_subset.load(text) == yaml.safe_load(text)
    assert yaml.safe_load((PORT_DIR / name).read_text()) == \
        yaml.safe_load((JAX_DIR / name).read_text())


def test_reader_equals_pyyaml_across_the_subset():
    text = """# comment
A:
  plain: some text # trailing comment
  quoted: "a # not a comment, \\"escaped\\" \\\\ \\t"
  single: 'it''s'
  ints: [0, -3, +7, 1_000]
  floats: [1.0, -2.5e-3, .5, 1.0e+5, 3.]
  not_floats: [1e-5, 1e5]
  bools: [true, False, yes, NO, on, Off]
  nulls: [null, ~, Null]
  empty:
  inf: .inf
  strings: [a b, "x, y", 'z']
  nested:
    deeper:
      key: value
  list: []
B: 3
"""
    assert yaml_subset.load(text) == yaml.safe_load(text)
    assert yaml_subset.load("") is None and yaml.safe_load("") is None


@pytest.mark.parametrize("text", [
    "A:\n  - 1\n  - 2\n", "A: {b: 1}\n", "A: &x 1\nB: *x\n",
    "A: !!str 1\n", "A: |\n  text\n", "A:\n\tB: 1\n", "A: [1, [2]]\n",
    "A: 0x1F\n", "A: 0755\n", "A: 1:30\n", "---\nA: 1\n", "A: [1, 2\n",
    "A: \"open\n", "A: 1\n  B: 2\n", "  A: 1\n", "A: b: c\n"],
    ids=["block-list", "flow-map", "anchor", "tag", "block-scalar", "tab",
         "nested-flow", "hex", "octal", "sexagesimal", "document",
         "open-list", "open-quote", "bad-indent", "indented", "colon"])
def test_constructs_outside_the_subset_raise(text):
    with pytest.raises(ValueError):
        yaml_subset.load(text)


@pytest.mark.parametrize("name", NAMES)
def test_merged_fields_equal_jax(name):
    """After each shipped file, every field of the port's tree (all 109
    of JAX's leaf keys) holds the value the JAX tree holds after
    update_config."""
    cfg, jcfg = get_cfg_defaults(), jax_defaults()
    update_config(cfg, PORT_DIR / name)
    jax_update(jcfg, str(JAX_DIR / name))
    paths = list(_paths(cfg))
    assert len(paths) == 109
    for path in paths:
        value, jvalue = cfg.get_by_path(path), jcfg.get_by_path(path)
        assert value == jvalue and type(value) is type(jvalue), path


OVERRIDES = [
    ("PREDICT.THRESHOLD", "0.4"), ("PREDICT.THRESHOLD", "1e-1"),
    ("PREDICT.THRESHOLD", "1"), ("PREDICT.BATCH_SIZE", "4"),
    ("PREDICT.BATCH_SIZE", "4.0"), ("PREDICT.TILED", "true"),
    ("PREDICT.TILED", "yes"), ("PREDICT.TILED", "0"),
    ("PREDICT.TILED", "off"), ("PREDICT.TILED", "maybe"),
    ("PREDICT.TEST_SCALES", "[0.5, 1.0]"), ("MODEL.NAME", "Unet"),
    ("MODEL.DECODER_CHANNELS", "[8, 4, 2, 2, 1]"),
    ("PREDICT.INPAINT_WEIGHTS", "w.npz"), ("PREDICT.INPAINT_WEIGHTS", "null"),
    ("DATA.IMG_SIZE", "256"), ("TEXT_WATERMARK.CONNECTIVITY", "4"),
    ("PREDICT.MASK_MODE", "'tight'")]


@pytest.mark.parametrize("key, value", OVERRIDES)
def test_merge_from_list_coerces_as_jax(key, value):
    cfg, jcfg = get_cfg_defaults(), jax_defaults()
    cfg.merge_from_list([key, value])
    jcfg.merge_from_list([key, value])
    got, want = cfg.get_by_path(key), jcfg.get_by_path(key)
    assert got == want and type(got) is type(want)


def test_merge_from_list_refuses_what_jax_refuses():
    for bad in (["PREDICT.THRESHOLD"], ["PREDICT.NO_SUCH_KEY", "1"]):
        for c in (get_cfg_defaults(), jax_defaults()):
            with pytest.raises((ValueError, AttributeError)):
                c.merge_from_list(bad)
    for c in (get_cfg_defaults(), jax_defaults()):
        with pytest.raises(TypeError):
            c.merge_from_list(["PREDICT.TEST_SCALES", "0.5"])


JAX_PATHS = sorted(_paths(jax_defaults()))


def test_leaf_keys_and_defaults_equal_jax():
    cfg, jcfg = get_cfg_defaults(), jax_defaults()
    assert sorted(_paths(cfg)) == JAX_PATHS and len(JAX_PATHS) == 109
    for path in JAX_PATHS:
        value, jvalue = cfg.get_by_path(path), jcfg.get_by_path(path)
        assert value == jvalue and type(value) is type(jvalue), path


def _override(value):
    """A string --opts value that differs from the default `value`: the
    JSON form (which YAML reads back) of the bool negated, the number
    plus one (a float plus 0.25), the string with "x" appended, the list
    with its last element repeated (an empty one gets a string), and a
    string for a None default."""
    if value is None:
        return "text"
    if isinstance(value, bool):
        other = not value
    elif isinstance(value, (int, float)):
        other = value + (0.25 if isinstance(value, float) else 1)
    elif isinstance(value, str):
        other = value + "x"
    else:
        other = list(value) + (list(value[-1:]) or ["x"])
    return json.dumps(other)


@pytest.mark.parametrize("key", JAX_PATHS)
def test_every_key_takes_an_override_as_jax(key):
    """--opts KEY VALUE for each of JAX's keys, VALUE not the default:
    accepted, and coerced to JAX's value and type; and the same key from a
    YAML mapping."""
    default = jax_defaults().get_by_path(key)
    value = _override(default)
    cfg, jcfg = get_cfg_defaults(), jax_defaults()
    cfg.merge_from_list([key, value])
    jcfg.merge_from_list([key, value])
    got, want = cfg.get_by_path(key), jcfg.get_by_path(key)
    assert want != default
    assert got == want and type(got) is type(want)
    *sections, leaf = key.split(".")
    tree = {leaf: jcfg.get_by_path(key)}
    for sec in reversed(sections):
        tree = {sec: tree}
    cfg = get_cfg_defaults().merge_from_dict(tree)
    assert cfg.get_by_path(key) == want
