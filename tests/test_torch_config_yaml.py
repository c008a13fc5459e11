"""The port's settings against the JAX package's: its YAML reader against
pyyaml on every configs/*.yaml and on YAML 1.1's scalar typing, and
get_settings (SEMANTIC_KD_CONFIG_PATH, then the environment) against the
JAX get_settings' model_dump(), field by field (exact equality)."""

import math
import warnings
from pathlib import Path

import pytest
import yaml

from sskd_tpu.config import Settings as JSettings
from sskd_tpu.config import get_settings as j_get_settings
from sskd_tpu.config import reset_settings_cache
from sskd_tpu_torch.config import Settings, dump_yaml, get_settings, parse_yaml
from sskd_tpu_torch.exceptions import ConfigError

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))
ENV = {
    "SEMANTIC_KD_SEARCH__HYBRID__FUSION_METHOD": "linear",
    "SEMANTIC_KD_SEARCH__MAXSIM_AGGREGATION": "true",
    "SEMANTIC_KD_CACHE__TTL_SECONDS": "60",
    "SEMANTIC_KD_AUTH__API_KEYS": '["sk_live_a"]',
    "SEMANTIC_KD_RATE_LIMIT__BURST": "3",
    "SEMANTIC_KD_SERVICE__LOG_LEVEL": "warning",
    "SEMANTIC_KD_DEBUG": "true",
    "SEMANTIC_KD_MONITORING__SERVICE_NAME": "sk",
    "SEMANTIC_KD_NOSUCH__FIELD": "1",
}


def test_there_are_four_configs():
    assert [p.name for p in CONFIGS] == ["index.yaml", "kd.yaml", "kd_marginmse_cached.yaml",
                                        "service.yaml"]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_reader_equals_pyyaml_and_round_trips(path, tmp_path):
    text = path.read_text()
    assert parse_yaml(text) == yaml.safe_load(text)
    settings = Settings.from_yaml(path)
    tree = settings.to_dict()
    # what to_yaml writes reads back the same, through either reader
    assert parse_yaml(dump_yaml(tree)) == tree == yaml.safe_load(dump_yaml(tree))
    settings.to_yaml(tmp_path / "out.yaml")
    assert Settings.from_yaml(tmp_path / "out.yaml").to_dict() == tree


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
@pytest.mark.parametrize("with_env", [False, True], ids=["yaml", "yaml+env"])
def test_get_settings_equals_jax(monkeypatch, path, with_env):
    monkeypatch.setenv("SEMANTIC_KD_CONFIG_PATH", str(path))
    for key, value in ENV.items() if with_env else ():
        monkeypatch.setenv(key, value)
    reset_settings_cache()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = j_get_settings()
            got = get_settings()
    finally:
        reset_settings_cache()
    jtree, ttree = want.model_dump(), got.to_dict()
    assert list(ttree) == list(jtree)
    for section in jtree:
        assert ttree[section] == jtree[section], section
    assert got.validate_for_production() == want.validate_for_production()
    # YAML's integer 5000 is the float 5000.0 in both trees
    assert type(ttree["search"]["rerank_timeout_ms"]) is float
    # a field the YAML gives counts as set (serving lets it override an index's own)
    assert got.is_set("index", "nprobe") == (path.name == "index.yaml")


@pytest.mark.parametrize("tree", [
    {},
    {"service": {"environment": "production"}},
    {"service": {"environment": "production"}, "cors": {"allow_origins": ["https://a"]},
     "auth": {"enabled": True, "api_keys": ["k"], "salt": "s"}, "rate_limit": {"enabled": True}},
    {"monitoring": {"prometheus_enabled": False}, "debug": True},
], ids=["defaults", "production", "hardened", "no-metrics"])
def test_production_audit_and_warnings_equal_jax(tree):
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = JSettings.model_validate(tree)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = Settings.from_dict(tree)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert got.validate_for_production() == want.validate_for_production()
    assert got.to_dict() == want.model_dump()


SCALARS = ["true", "yes", "Off", "NO", "0.0", "1e-9", "1.0e-9", "2.0e-05", "1.0e5", '"rrf"',
           "[]", '[a, "b c", 1, 2.5, null]', "0755", "0x1F", "0b101", "-3", "+4", ".5", ".inf",
           "-.inf", ".nan", "~", "null", "", "08", "0.0.0.0", "'it''s'", '"a\\u00e9\\n"',
           "1_000", "abc def", "redis://localhost:6379", "/metrics", "ndcg@10"]


@pytest.mark.parametrize("scalar", SCALARS)
def test_scalars_typed_as_pyyaml_types_them(scalar):
    got = parse_yaml(f"k: {scalar}  # a comment")["k"]
    want = yaml.safe_load(f"k: {scalar}  # a comment")["k"]
    if isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("text", [
    "k: &a 1", "k: !!str 1", "k:\n  - a", "k: 2001-12-14", "k: 1:30", "k: {a: 1}", "k: {}",
    "k: |\n  x", "k: [a, [b]]", "k: a: b", "k: 1\nk: 2", "a:\n\tb: 1", "k: \"open",
    "a: 1\n  b: 2",
])
def test_yaml_outside_the_subset_raises(text):
    with pytest.raises(ConfigError):
        parse_yaml(text)


def test_mesh_of_one_device_loads_and_more_raises():
    """A mesh of one data-parallel device loads, an index sharded over more
    devices too, and more data-parallel devices (data-parallel training is
    ported); below -1 raises, as the JAX package's bound does."""
    assert Settings.from_yaml(ROOT / "configs" / "index.yaml").mesh.data_parallel == 1
    assert Settings.from_dict({"mesh": {"data_parallel": -1}}).mesh.index_parallel == 1
    assert Settings.from_dict({"mesh": {"index_parallel": 4}}).mesh.index_parallel == 4
    assert Settings.from_dict({"mesh": {"data_parallel": 2}}).mesh.data_parallel == 2
    with pytest.raises(ConfigError, match="data_parallel=-2"):
        Settings.from_dict({"mesh": {"data_parallel": -2}})


@pytest.mark.parametrize("bad", [
    {"search": {"hybrid": {"bm25_weight": 0.5}}},
    {"search": {"hybrid": {"fusion_method": "max"}}},
    {"cache": {"ttl_seconds": 0}},
    {"rate_limit": {"burst": 0}},
    {"service": {"workers": 33}},
    {"service": {"log_level": "loud"}},
    {"monitoring": {"prometheus_port": 70000}},
    {"index": {"dtype": "int2"}},
    {"debug": [1]},
], ids=str)
def test_new_fields_are_bounded_as_in_jax(bad):
    with pytest.raises(ConfigError):
        Settings.from_dict(bad)
    with pytest.raises(ValueError):  # pydantic's ValidationError
        JSettings.model_validate(bad)


def test_unknown_fields_raise_where_pydantic_ignores_them():
    """Unknown fields and sections are ignored, as pydantic ignores them
    (the port raised for them until the lax settings; the name is kept)."""
    tree = {"search": {"hybrid": {"nosuch": 1}, "nosuch": 2}, "nosuch": {"a": 1}}
    got = Settings.from_dict(tree)
    assert got.to_dict() == JSettings.model_validate(tree).model_dump()
    assert not got.is_set("search", "hybrid.nosuch") and not got.is_set("search", "nosuch")


def test_plaintext_keys_hash_as_in_jax():
    tree = {"auth": {"api_keys": ["k1", "k2"], "salt": "pepper"}}
    assert Settings.from_dict(tree).auth.api_key_hashes == \
        JSettings.model_validate(tree).auth.api_key_hashes


def test_nested_env_override_is_recorded():
    s = Settings.from_env(environ={"SEMANTIC_KD_SEARCH__HYBRID__RRF_K": "7"})
    assert s.search.hybrid.rrf_k == 7 and s.is_set("search", "hybrid.rrf_k")
