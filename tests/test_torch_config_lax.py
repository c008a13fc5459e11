"""The port's settings take what pydantic's lax mode takes: get_settings()
of both packages on one environment (and YAML at SEMANTIC_KD_CONFIG_PATH),
compared tree for tree (exact equality), and the values both refuse."""

import os
import warnings

import pytest

from sskd_tpu.config import get_settings as j_get_settings
from sskd_tpu.config import reset_settings_cache
from sskd_tpu_torch.config import get_settings
from sskd_tpu_torch.exceptions import ConfigError

FLAGS = ("SEMANTIC_KD_AUTH__ENABLED", "SEMANTIC_KD_RATE_LIMIT__ENABLED", "SEMANTIC_KD_DEBUG")
TAKEN = [
    *[({flag: value}, None) for flag in FLAGS
      for value in ("True", "1", "yes", "on", "0", "false", "Off", "t", "n")],
    ({"SEMANTIC_KD_TRAINING__EPOCHS": "3.0"}, None),
    ({"SEMANTIC_KD_TRAINING__EPOCHS": '"3"'}, None),
    ({"SEMANTIC_KD_TRAINING__EPOCHS": '" 4.00 "'}, None),
    ({"SEMANTIC_KD_TRAINING__EPOCHS": "true"}, None),  # pydantic takes True for 1
    ({"SEMANTIC_KD_RATE_LIMIT__BURST": '"1_000"'}, None),
    ({"SEMANTIC_KD_TRAINING__LEARNING_RATE": "1"}, None),
    ({"SEMANTIC_KD_SEARCH__RERANK_TIMEOUT_MS": '"2.5e3"'}, None),
    ({"SEMANTIC_KD_SEARCH__HYBRID__ENABLED": "Yes"}, None),
    ({}, "auth:\n  enabled: \"true\"\n"),
    ({}, "rate_limit:\n  enabled: 'on'\n  burst: \"3\"\n"),
    ({}, "training:\n  epochs: 3.0\n"),
    ({}, "auth:\n  enabled: true\n  note: kept out\n"),
    ({}, "nosuch:\n  a: 1\nsearch:\n  hybrid:\n    nosuch: 2\n"),
    ({"SEMANTIC_KD_AUTH__ENABLED": "1"}, "auth:\n  enabled: false\n"),
]
REFUSED = [
    ({"SEMANTIC_KD_TRAINING__EPOCHS": "3.5"}, None),
    ({"SEMANTIC_KD_TRAINING__EPOCHS": '"3e0"'}, None),
    ({"SEMANTIC_KD_AUTH__ENABLED": "2"}, None),
    ({"SEMANTIC_KD_AUTH__ENABLED": "maybe"}, None),
    ({"SEMANTIC_KD_DEBUG": '" true"'}, None),
    ({"SEMANTIC_KD_SERVICE__VERSION": "1.0"}, None),  # a float for a str field
    ({"SEMANTIC_KD_CORS__ALLOW_ORIGINS": "[1]"}, None),
    ({}, "training:\n  epochs: 3.5\n"),
    ({}, "auth:\n  enabled: \"maybe\"\n"),
    ({}, "auth: 3\n"),
]


def _ids(case):
    env, text = case
    return ",".join(f"{k[len('SEMANTIC_KD_'):]}={v}" for k, v in env.items()) + (
        f" yaml {text!r}" if text else "")


def _both(monkeypatch, tmp_path, env, yaml_text):
    """(JAX settings or its exception, the port's or its exception)."""
    for key in list(os.environ):
        if key.startswith("SEMANTIC_KD_"):
            monkeypatch.delenv(key)
    if yaml_text is not None:
        (tmp_path / "s.yaml").write_text(yaml_text)
        monkeypatch.setenv("SEMANTIC_KD_CONFIG_PATH", str(tmp_path / "s.yaml"))
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    out = []
    reset_settings_cache()
    try:
        for fn in (j_get_settings, get_settings):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                try:
                    out.append(fn())
                except Exception as e:  # noqa: BLE001 - compared below
                    out.append(e)
    finally:
        reset_settings_cache()
    return out


@pytest.mark.parametrize("case", TAKEN + REFUSED, ids=[_ids(c) for c in TAKEN + REFUSED])
def test_get_settings_takes_what_jax_takes(monkeypatch, tmp_path, case):
    want, got = _both(monkeypatch, tmp_path, *case)
    if case in REFUSED:
        assert isinstance(want, ValueError), want  # pydantic's ValidationError
        assert isinstance(got, ConfigError), got
        return
    assert not isinstance(want, Exception), want
    assert not isinstance(got, Exception), got
    jtree, ttree = want.model_dump(), got.to_dict()
    for section in jtree:
        assert ttree[section] == jtree[section], section
        assert repr(ttree[section]) == repr(jtree[section]), section  # 3 is 3, not 3.0
    assert list(ttree) == list(jtree)
