"""Config parsing, overrides, validation, hashability (SURVEY.md §5.6, N13)."""

import json

import pytest

from hsflow.config import (
    HSConfig,
    MeshConfig,
    PyramidConfig,
    RunConfig,
    config_hash,
    load_config,
)


def test_defaults_match_config1():
    """Driver config 1: 100 iterations, alpha = 1.0 [BASELINE.json]."""
    cfg = HSConfig()
    assert cfg.alpha == 1.0 and cfg.iters == 100
    assert cfg.deriv_variant == "hs_cube"


def test_hashable_for_jit_cache():
    assert hash(HSConfig()) == hash(HSConfig(alpha=1.0))
    assert hash(HSConfig(alpha=0.5)) != hash(HSConfig(alpha=1.0))
    hash(RunConfig())  # nested dataclasses must hash too


def test_validation():
    with pytest.raises(ValueError):
        HSConfig(deriv_variant="sobel")
    with pytest.raises(ValueError):
        HSConfig(backend="cuda")
    with pytest.raises(ValueError):
        HSConfig(iters=-1)
    with pytest.raises(ValueError):
        PyramidConfig(levels=0)
    with pytest.raises(ValueError):
        PyramidConfig(levels=2, iters_per_level=(10,))
    with pytest.raises(ValueError):
        MeshConfig(y=0)


def test_json_load_and_overrides(tmp_path):
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps({"hs": {"alpha": 0.25, "iters": 7}, "pyramid": {"levels": 2}}))
    cfg = load_config(str(p), overrides={"hs.iters": "42", "mesh.y": "4"})
    assert cfg.hs.alpha == 0.25
    assert cfg.hs.iters == 42  # override wins, string coerced to int
    assert cfg.pyramid.levels == 2
    assert cfg.mesh.y == 4


def test_override_tuple_coercion():
    cfg = load_config(overrides={"pyramid.levels": "3", "pyramid.iters_per_level": "50,80,100"})
    assert cfg.pyramid.iters_per_level == (50, 80, 100)


def test_unknown_section_and_field_rejected(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"nope": {}}))
    with pytest.raises(KeyError):
        load_config(str(p))
    with pytest.raises(KeyError):
        load_config(overrides={"hs.gamma": 1})
    with pytest.raises(KeyError):
        load_config(overrides={"alpha": 1})  # not dotted


def test_config_hash_stable_and_distinct():
    a = config_hash(RunConfig())
    b = config_hash(RunConfig())
    c = config_hash(RunConfig(hs=HSConfig(alpha=2.0)))
    assert a == b and a != c and len(a) == 16


def test_mesh_properties():
    m = MeshConfig(batch=2, y=2, x=2)
    assert m.axis_names == ("batch", "y", "x")
    assert m.shape == (2, 2, 2)
