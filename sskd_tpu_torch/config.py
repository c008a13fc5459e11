"""Configuration of the port (port of sskd_tpu/config.py).

Standard-library dataclasses in place of pydantic, and a reader of its own
in place of pyyaml (the machine with the GPU has neither). Every section and
field of the JAX package is here, with its name, default and bounds:
``student``, ``teacher``, ``loss``, ``training``, ``mining``, ``index``,
``mesh``, ``precision``, ``cors``, ``rate_limit``, ``auth``, ``monitoring``,
``service``, ``search`` (with ``search.hybrid``), ``cache`` and ``data``,
and the top-level ``debug``. ``mesh`` takes ``index_parallel`` > 1 (sharded
serving, :mod:`sskd_tpu_torch.index.sharded`) and ``data_parallel`` > 1
(data-parallel training, one process a data-axis entry:
:mod:`sskd_tpu_torch.parallel.distributed`).

Precedence, as in the JAX package: environment variables
(``SEMANTIC_KD_<SECTION>__<FIELD>=value``, nested by ``__``, values parsed
as JSON when they parse, else kept as strings) over the YAML file named by
``SEMANTIC_KD_CONFIG_PATH`` over the defaults (:func:`get_settings`).
``Settings.from_dict`` takes keyword-style trees, ``Settings.from_yaml`` /
``to_yaml`` read and write the YAML subset of ``configs/*.yaml``
(:func:`parse_yaml`). Values are coerced as pydantic's lax mode coerces them
(:func:`_coerce`: ``"True"``, ``"yes"``, ``1`` or ``"on"`` for a bool, ``3.0``
or ``"3"`` for an int, an int for a float), and unknown sections and fields
are ignored, as pydantic ignores extras. A value that pydantic refuses, a
value outside its bounds, or YAML outside the subset raises
:class:`ConfigError`. ``Settings`` remembers which fields ``from_dict`` /
``from_env`` / ``from_yaml`` were given (:meth:`Settings.is_set`, the
stand-in for pydantic's ``model_fields_set``): serving lets an explicit
``index.nprobe`` override a loaded index's own.
"""

from __future__ import annotations

import json
import math
import os
import re
import warnings
from dataclasses import asdict, dataclass, field, fields
from pathlib import Path
from typing import Any

from sskd_tpu_torch.exceptions import ConfigError

ENV_PREFIX = "SEMANTIC_KD_"
NESTED_DELIMITER = "__"
CONFIG_PATH_ENV = "SEMANTIC_KD_CONFIG_PATH"


def _check(obj, name: str, *, ge=None, le=None, gt=None, choices=None) -> None:
    """Bounds and choices of a field (its type is coerced before, by ``_Section``)."""
    value = getattr(obj, name)
    where = f"{type(obj).__name__}.{name}={value!r}"
    if choices is not None and value not in choices:
        raise ConfigError(f"{where}: must be one of {choices}")
    if ge is not None and value < ge:
        raise ConfigError(f"{where}: must be >= {ge}")
    if le is not None and value > le:
        raise ConfigError(f"{where}: must be <= {le}")
    if gt is not None and value <= gt:
        raise ConfigError(f"{where}: must be > {gt}")


# pydantic's lax-mode bool strings (any case, no surrounding whitespace)
_BOOL_STRINGS = {"0": False, "off": False, "f": False, "false": False, "n": False, "no": False,
                 "1": True, "on": True, "t": True, "true": True, "y": True, "yes": True}
# an int string: ASCII digits with single underscores between them, and an
# all-zero fraction ("3.0", "3_000.00")
_INT_STRING = re.compile(r"^[+-]?[0-9]+(?:_[0-9]+)*(?:\.0+)?$")
_LAX = object()  # _coerce's marker for a value pydantic refuses


def _lax(kind: str, value: Any) -> Any:
    """``value`` as pydantic's lax mode coerces it to ``kind`` ("bool",
    "int", "float", "str" or "list" of str), or ``_LAX``."""
    if kind == "bool":
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)) and value in (0, 1):
            return bool(value)
        if isinstance(value, str):
            return _BOOL_STRINGS.get(value.lower(), _LAX)
        return _LAX
    if kind == "int":
        if isinstance(value, int):  # bool included, as pydantic takes True for 1
            return int(value)
        if isinstance(value, float):
            ok = math.isfinite(value) and value.is_integer() and abs(value) < 2.0**63
            return int(value) if ok else _LAX
        if isinstance(value, str):
            text = value.strip()
            return int(text.split(".")[0].replace("_", "")) if _INT_STRING.match(text) else _LAX
        return _LAX
    if kind == "float":
        if isinstance(value, (int, float)):
            return float(value)
        if isinstance(value, str) and value.isascii():
            try:
                return float(value.strip())
            except ValueError:
                return _LAX
        return _LAX
    if kind == "str":
        return value if isinstance(value, str) else _LAX
    if kind == "list":
        if isinstance(value, (list, tuple)) and all(isinstance(v, str) for v in value):
            return list(value)
        return _LAX
    return value


def _coerce(owner: str, name: str, kind: str, value: Any) -> Any:
    """:func:`_lax`, raising :class:`ConfigError` where pydantic raises."""
    out = _lax(kind, value)
    if out is _LAX:
        what = "a list of strings" if kind == "list" else f"a valid {kind}"
        raise ConfigError(f"{owner}.{name}={value!r}: expected {what}")
    return out


class _Section:
    """Coerces each bool, int, float, str and list field as pydantic's lax
    mode does (YAML's ``5000`` is ``5000.0`` in a float field, the
    environment's ``"True"`` is ``True`` in a bool one), then runs the
    section's own checks."""

    def __post_init__(self):
        for f in fields(self):
            if f.type in ("bool", "int", "float", "str", "list"):
                setattr(self, f.name,
                        _coerce(type(self).__name__, f.name, f.type, getattr(self, f.name)))
        self.validate()

    def validate(self) -> None:
        pass


@dataclass
class StudentModelConfig(_Section):
    model_name: str = "intfloat/e5-small-v2"
    embedding_dim: int = 384
    max_seq_length: int = 512
    normalize_embeddings: bool = True
    query_prefix: str = "query: "
    passage_prefix: str = "passage: "
    pooling: str = "mean"

    def validate(self):
        _check(self, "embedding_dim", ge=1)
        _check(self, "max_seq_length", ge=1, le=8192)
        _check(self, "pooling", choices=("mean", "cls"))


@dataclass
class TeacherModelConfig(_Section):
    """The cross-encoder teacher (sskd_tpu/config.py:44)."""

    model_name: str = "BAAI/bge-reranker-large"
    max_seq_length: int = 512
    batch_size: int = 32

    def validate(self):
        _check(self, "max_seq_length", ge=1, le=8192)
        _check(self, "batch_size", ge=1)


@dataclass
class LossConfig(_Section):
    margin_mse_weight: float = 0.6
    listwise_kd_weight: float = 0.2
    contrastive_weight: float = 0.2
    temperature_start: float = 4.0
    temperature_end: float = 2.0
    contrastive_tau: float = 0.05
    # widen the InfoNCE denominator with every other query's docs in the batch
    in_batch_negatives: bool = False

    def validate(self):
        for name in ("margin_mse_weight", "listwise_kd_weight", "contrastive_weight"):
            _check(self, name, ge=0.0, le=1.0)
        for name in ("temperature_start", "temperature_end", "contrastive_tau"):
            _check(self, name, gt=0.0)
        total = self.margin_mse_weight + self.listwise_kd_weight + self.contrastive_weight
        if abs(total - 1.0) > 1e-6:
            raise ConfigError(f"loss weights must sum to 1.0, got {total}")


@dataclass
class TrainingConfig(_Section):
    epochs: int = 3
    batch_size: int = 32
    learning_rate: float = 2e-5
    weight_decay: float = 0.01
    warmup_ratio: float = 0.1
    max_grad_norm: float = 1.0
    grad_accum_steps: int = 1
    num_docs_per_query: int = 8
    early_stopping_patience: int = 2
    early_stopping_metric: str = "ndcg@10"
    save_steps: int = 0
    eval_steps: int = 0
    # recompute each encoder layer in the backward (torch.utils.checkpoint):
    # "full" keeps only each layer's input, "dots" also its matrix products
    remat: bool = True
    remat_policy: str = "full"
    # the JAX package's dropout-key generator (rbg, unsafe_rbg,
    # threefry2x32). The port draws its masks from torch generators and the
    # dropattn kernels' Philox, so only the default is accepted: any other
    # choice raises rather than being ignored.
    rng_impl: str = "rbg"
    prefetch_batches: int = 2
    seed: int = 42
    output_dir: str = "artifacts/models/kd_student"
    resume: bool = True

    def validate(self):
        for name in ("epochs", "batch_size", "grad_accum_steps"):
            _check(self, name, ge=1)
        _check(self, "num_docs_per_query", ge=2)
        for name in ("early_stopping_patience", "save_steps", "eval_steps", "prefetch_batches"):
            _check(self, name, ge=0)
        _check(self, "seed")
        _check(self, "weight_decay", ge=0.0)
        _check(self, "warmup_ratio", ge=0.0, le=1.0)
        for name in ("learning_rate", "max_grad_norm"):
            _check(self, name, gt=0.0)
        _check(self, "remat_policy", choices=("full", "dots"))
        if self.rng_impl != "rbg":
            raise ConfigError(
                f"TrainingConfig.rng_impl={self.rng_impl!r}: the JAX generators (rbg, "
                "unsafe_rbg, threefry2x32) do not exist in the port, whose dropout masks come "
                "from torch generators and the dropattn kernels' Philox; leave it at 'rbg'"
            )


@dataclass
class MiningConfig(_Section):
    """The three-stage curriculum's knobs (sskd_tpu/config.py MiningConfig):
    the stage, BM25's depth and parameters, the teacher's depth and
    confidence floor, ANCE's picks, margin and in-training refresh, and the
    denoising threshold."""

    stage: int = 3
    bm25_top_k: int = 100
    teacher_top_k: int = 10
    teacher_confidence_threshold: float = 0.6
    ance_top_k: int = 5
    ance_margin: float = 0.1
    ance_refresh_every_n_steps: int = 500
    ance_enabled: bool = True
    ance_warmup_steps: int = 0
    denoise_text_overlap_threshold: float = 0.9
    bm25_k1: float = 1.5
    bm25_b: float = 0.75
    bm25_epsilon: float = 0.25

    def validate(self):
        _check(self, "stage", ge=1, le=3)
        for name in ("bm25_top_k", "teacher_top_k", "ance_top_k",
                     "ance_refresh_every_n_steps"):
            _check(self, name, ge=1)
        _check(self, "ance_warmup_steps", ge=0)
        for name in ("teacher_confidence_threshold", "denoise_text_overlap_threshold",
                     "bm25_b"):
            _check(self, name, ge=0.0, le=1.0)
        for name in ("ance_margin", "bm25_epsilon"):
            _check(self, name, ge=0.0)
        _check(self, "bm25_k1", gt=0.0)


@dataclass
class IndexConfig(_Section):
    """The JAX package's IndexConfig. ``embedding_dim``, ``metric``,
    ``dtype``, ``search_method``, ``block_rows``, ``cluster_rows`` and
    ``refine_m`` are build-time settings (``semantic-kd index build``): a
    loaded index is served as it was recorded, except for an explicitly set
    ``nprobe`` and for ``refine_storage``, where the bf16 refine rows live,
    a deployment choice applied at load (see ``serve/app.py``)."""

    embedding_dim: int = 384
    metric: str = "cosine"
    dtype: str = "float32"
    search_method: str = "approx"
    recall_target: float = 0.99
    block_rows: int = 262144
    default_k: int = 10
    cluster_rows: int = 0  # 0 = auto (about sqrt(N))
    nprobe: int = 64
    # int8 / int4 two-stage refinement: the sweep fetches refine_m candidates,
    # their bf16 rows are rescored; 0 disables
    refine_m: int = 0
    refine_storage: str = "device"  # "device" or "host": where the bf16 refine rows live
    validation_queries: int = 1000
    validation_recall_at_10: float = 0.97

    def validate(self):
        _check(self, "embedding_dim", ge=1)
        _check(self, "metric", choices=("cosine", "dot"))
        _check(self, "dtype", choices=("float32", "bfloat16", "int8", "int4"))
        _check(self, "search_method", choices=("exact", "approx", "clustered"))
        _check(self, "recall_target", ge=0.5, le=1.0)
        _check(self, "block_rows", ge=128)
        _check(self, "default_k", ge=1)
        _check(self, "cluster_rows", ge=0)
        _check(self, "nprobe", ge=1)
        _check(self, "refine_m", ge=0)
        _check(self, "refine_storage", choices=("device", "host"))
        _check(self, "validation_queries", ge=1)
        _check(self, "validation_recall_at_10", ge=0.0, le=1.0)


@dataclass
class MeshConfig(_Section):
    """The JAX package's device mesh. ``index_parallel`` > 1 shards a served
    index over that many devices (one process, a shard a device:
    :mod:`sskd_tpu_torch.parallel.mesh`); ``data_parallel`` > 1 trains over
    that many processes (``train --data-parallel``)."""

    data_axis: str = "data"
    index_axis: str = "index"
    data_parallel: int = -1  # -1 = all devices not used by index_parallel
    index_parallel: int = 1

    def validate(self):
        _check(self, "data_parallel", ge=-1)
        _check(self, "index_parallel", ge=1)


@dataclass
class PrecisionConfig(_Section):
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    index_dtype: str = "float32"

    def validate(self):
        _check(self, "compute_dtype", choices=("float32", "bfloat16"))
        _check(self, "param_dtype", choices=("float32", "bfloat16"))
        _check(self, "index_dtype", choices=("float32", "bfloat16", "int8", "int4"))


@dataclass
class CORSConfig(_Section):
    enabled: bool = True
    allow_origins: list = field(default_factory=lambda: ["*"])
    allow_methods: list = field(default_factory=lambda: ["GET", "POST"])
    allow_headers: list = field(default_factory=lambda: ["*"])
    allow_credentials: bool = False


@dataclass
class RateLimitConfig(_Section):
    enabled: bool = False
    requests_per_minute: int = 60
    burst: int = 10

    def validate(self):
        _check(self, "requests_per_minute", ge=1)
        _check(self, "burst", ge=1)


@dataclass
class AuthConfig(_Section):
    enabled: bool = False
    api_key_hashes: list = field(default_factory=list)
    api_key_header: str = "X-API-Key"
    # plaintext keys (a migration aid): hashed into api_key_hashes each time
    # the section is built, as the JAX validator does, and flagged by the
    # production audit
    api_keys: list = field(default_factory=list)
    salt: str = ""

    def validate(self):
        self._hash_plaintext_keys()

    def _hash_plaintext_keys(self) -> None:
        if self.api_keys:
            from sskd_tpu_torch.serve.middleware import APIKeyAuth

            self.api_key_hashes = list(self.api_key_hashes) + [
                APIKeyAuth.hash_key(k, salt=self.salt) for k in self.api_keys
            ]


@dataclass
class MonitoringConfig(_Section):
    prometheus_enabled: bool = True
    prometheus_path: str = "/metrics"
    # >0 also binds a listener on this port that serves only the metrics
    prometheus_port: int = 0
    opentelemetry_enabled: bool = False
    opentelemetry_endpoint: str = ""
    service_name: str = "semantic-kd"
    # the JAX profiler's port: the port has no such server, so create_app
    # refuses a nonzero value (see serve/app.py)
    jax_profiler_port: int = 0
    log_queries: bool = False
    log_latencies: bool = True

    def validate(self):
        _check(self, "prometheus_port", ge=0, le=65535)
        _check(self, "jax_profiler_port", ge=0, le=65535)


@dataclass
class ServiceConfig(_Section):
    host: str = "0.0.0.0"
    port: int = 8000
    environment: str = "development"
    version: str = "0.1.0"
    micro_batch_window_ms: float = 0.0
    micro_batch_max_size: int = 64
    read_timeout_s: float = 30.0
    idle_timeout_s: float = 75.0
    max_connections: int = 1024
    # worker processes sharing the port (SO_REUSEPORT); more than one is
    # served only on the CPU (one process owns the card)
    workers: int = 1
    log_level: str = "info"

    def validate(self):
        _check(self, "port", ge=1, le=65535)
        _check(self, "environment", choices=("development", "staging", "production"))
        _check(self, "micro_batch_window_ms", ge=0.0)
        _check(self, "micro_batch_max_size", ge=1)
        _check(self, "read_timeout_s", gt=0.0)
        _check(self, "idle_timeout_s", gt=0.0)
        _check(self, "max_connections", ge=1)
        _check(self, "workers", ge=1, le=32)
        _check(self, "log_level", choices=("debug", "info", "warning", "error", "critical"))


@dataclass
class HybridConfig(_Section):
    """BM25 + semantic fusion (serve/hybrid.py)."""

    enabled: bool = False
    bm25_index_path: str = "artifacts/indexes/bm25"
    bm25_weight: float = 0.3
    semantic_weight: float = 0.7
    fusion_method: str = "rrf"
    rrf_k: int = 60
    query_expansion: bool = False
    expansion_docs: int = 3
    expansion_terms: int = 5

    def validate(self):
        _check(self, "bm25_weight", ge=0.0, le=1.0)
        _check(self, "semantic_weight", ge=0.0, le=1.0)
        _check(self, "fusion_method", choices=("rrf", "linear"))
        for name in ("rrf_k", "expansion_docs", "expansion_terms"):
            _check(self, name, ge=1)
        total = self.bm25_weight + self.semantic_weight
        if abs(total - 1.0) > 1e-6:
            raise ConfigError(f"bm25_weight + semantic_weight must sum to 1.0, got {total}")


@dataclass
class CacheConfig(_Section):
    """Query-result and embedding caches (serve/cache.py). Backends other
    than memory are accepted and served from memory with a warning, as in
    the JAX package."""

    enabled: bool = False
    backend: str = "memory"
    redis_url: str = "redis://localhost:6379"  # kept for the settings' parity; unused
    ttl_seconds: float = 3600.0
    max_size: int = 10000
    embedding_cache: bool = True

    def validate(self):
        _check(self, "ttl_seconds", gt=0.0)
        _check(self, "max_size", ge=1)


@dataclass
class SearchConfig(_Section):
    default_k: int = 10
    max_k: int = 100
    rerank_enabled: bool = False
    rerank_top_k: int = 50  # results the teacher rescores
    rerank_timeout_ms: float = 5000.0  # past it, the bi-encoder order is served
    # doc-level MaxSim over chunk hits (utils/chunk.py maxsim_aggregate_topk)
    maxsim_aggregation: bool = False
    hybrid: HybridConfig = field(default_factory=HybridConfig)

    def validate(self):
        _check(self, "default_k", ge=1, le=100)
        _check(self, "max_k", ge=1)
        _check(self, "rerank_top_k", ge=1, le=200)
        _check(self, "rerank_timeout_ms", gt=0.0)
        if isinstance(self.hybrid, dict):
            self.hybrid = HybridConfig(**self.hybrid)


@dataclass
class DataConfig(_Section):
    """Where the pipeline keeps its data and how it chunks it
    (sskd_tpu/config.py DataConfig)."""

    data_dir: str = "data"
    max_samples: int = 0  # 0 = all
    chunk_max_tokens: int = 512
    chunk_stride: int = 80

    def validate(self):
        _check(self, "max_samples", ge=0)
        _check(self, "chunk_max_tokens", ge=8)
        _check(self, "chunk_stride", ge=0)


# in the JAX tree's order
_SECTIONS = {
    "student": StudentModelConfig,
    "teacher": TeacherModelConfig,
    "loss": LossConfig,
    "training": TrainingConfig,
    "mining": MiningConfig,
    "index": IndexConfig,
    "mesh": MeshConfig,
    "precision": PrecisionConfig,
    "cors": CORSConfig,
    "rate_limit": RateLimitConfig,
    "auth": AuthConfig,
    "monitoring": MonitoringConfig,
    "service": ServiceConfig,
    "search": SearchConfig,
    "cache": CacheConfig,
    "data": DataConfig,
}
_NESTED = {("search", "hybrid"): HybridConfig}


@dataclass
class Settings:
    debug: bool = False
    student: StudentModelConfig = field(default_factory=StudentModelConfig)
    teacher: TeacherModelConfig = field(default_factory=TeacherModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    mining: MiningConfig = field(default_factory=MiningConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    cors: CORSConfig = field(default_factory=CORSConfig)
    rate_limit: RateLimitConfig = field(default_factory=RateLimitConfig)
    auth: AuthConfig = field(default_factory=AuthConfig)
    monitoring: MonitoringConfig = field(default_factory=MonitoringConfig)
    service: ServiceConfig = field(default_factory=ServiceConfig)
    search: SearchConfig = field(default_factory=SearchConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    data: DataConfig = field(default_factory=DataConfig)
    # the (section, field) names that from_dict / from_env / from_yaml were
    # given; a field of search.hybrid is ("search", "hybrid.<field>")
    fields_set: frozenset = field(default_factory=frozenset, compare=False, repr=False)

    def __post_init__(self):
        self.debug = _coerce("Settings", "debug", "bool", self.debug)
        self._production_enforcement()

    def _production_enforcement(self) -> None:
        """Warn about unsafe production combinations, as the JAX package does."""
        if self.service.environment == "production":
            if "*" in self.cors.allow_origins:
                warnings.warn("CORS wildcard origin in production", UserWarning, stacklevel=3)
            if not self.auth.enabled:
                warnings.warn("API key auth disabled in production", UserWarning, stacklevel=3)
            if not self.rate_limit.enabled:
                warnings.warn("rate limiting disabled in production", UserWarning, stacklevel=3)

    def validate_for_production(self) -> list[str]:
        """The production audit's problems (the JAX package's list)."""
        problems: list[str] = []
        if "*" in self.cors.allow_origins:
            problems.append("cors.allow_origins contains wildcard")
        if not self.auth.enabled:
            problems.append("auth.enabled is False")
        if self.auth.api_keys:
            problems.append(
                "auth.api_keys holds PLAINTEXT keys (migration aid) — move "
                "the hashes to auth.api_key_hashes and drop the plaintext"
            )
        if not self.rate_limit.enabled:
            problems.append("rate_limit.enabled is False")
        if not self.monitoring.prometheus_enabled:
            problems.append("monitoring.prometheus_enabled is False")
        if self.debug:
            problems.append("debug mode is enabled")
        return problems

    def to_dict(self) -> dict[str, Any]:
        """The tree of the JAX package's ``model_dump()``."""
        return {"debug": self.debug, **{s: asdict(getattr(self, s)) for s in _SECTIONS}}

    def is_set(self, section: str, name: str) -> bool:
        """Whether ``section.name`` was given explicitly (by ``from_dict``,
        ``from_env`` or ``from_yaml``, here or in ``base``) rather than left
        at its default."""
        return (section, name) in self.fields_set

    @classmethod
    def from_dict(cls, data: dict[str, Any], base: "Settings | None" = None) -> "Settings":
        """Settings from a nested ``{section: {field: value}}`` tree (and
        ``debug``), on top of ``base`` (or the defaults). Sections and fields
        the settings do not have are ignored, as pydantic ignores extras."""
        base = base or cls()
        merged = base.to_dict()
        given = set(base.fields_set)
        for section, values in data.items():
            if section == "debug":
                merged["debug"] = values
                given.add(("debug", "debug"))
                continue
            if section not in _SECTIONS:
                continue
            if not isinstance(values, dict):
                raise ConfigError(f"config section {section!r} must be a mapping")
            known = {f.name for f in fields(_SECTIONS[section])}
            for name, value in values.items():
                if name not in known:
                    continue
                nested = _NESTED.get((section, name))
                if nested is None:
                    merged[section][name] = value
                    given.add((section, name))
                    continue
                if not isinstance(value, dict):
                    raise ConfigError(f"config field {section}.{name} must be a mapping")
                sub_known = {f.name for f in fields(nested)}
                for sub, sub_value in value.items():
                    if sub in sub_known:
                        merged[section][name][sub] = sub_value
                        given.add((section, f"{name}.{sub}"))
        return cls(
            debug=merged["debug"],
            **{s: _SECTIONS[s](**merged[s]) for s in _SECTIONS},
            fields_set=frozenset(given),
        )

    @classmethod
    def from_env(cls, base: "Settings | None" = None, environ=None) -> "Settings":
        """Apply ``SEMANTIC_KD_<section>__<field>=value`` overrides (``__``
        nests deeper, ``SEMANTIC_KD_DEBUG`` sets ``debug``); variables that
        name no known field are ignored, as in the JAX package."""
        environ = os.environ if environ is None else environ
        known = (base or cls()).to_dict()
        tree: dict[str, Any] = {}
        for key, value in environ.items():
            if not key.startswith(ENV_PREFIX) or key == CONFIG_PATH_ENV:
                continue
            parts = key[len(ENV_PREFIX):].lower().split(NESTED_DELIMITER)
            node, ok = known, True
            for part in parts[:-1]:
                if isinstance(node, dict) and part in node:
                    node = node[part]
                else:
                    ok = False
                    break
            if not ok or not isinstance(node, dict) or parts[-1] not in node:
                continue
            try:
                parsed = json.loads(value)
            except ValueError:
                parsed = value
            out = tree
            for part in parts[:-1]:
                out = out.setdefault(part, {})
            out[parts[-1]] = parsed
        return cls.from_dict(tree, base)

    # -- YAML ----------------------------------------------------------------

    @classmethod
    def from_yaml(cls, path: str | Path) -> "Settings":
        """Settings from a YAML file in the subset :func:`parse_yaml` reads."""
        with open(path, encoding="utf-8") as f:
            tree = parse_yaml(f.read()) or {}
        if not isinstance(tree, dict):
            raise ConfigError(f"{path}: the top level must be a mapping")
        return cls.from_dict(tree)

    def to_yaml(self, path: str | Path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(dump_yaml(self.to_dict()))


def get_settings() -> Settings:
    """The YAML at ``SEMANTIC_KD_CONFIG_PATH`` (when set), then the
    environment's overrides, then the defaults."""
    config_path = os.environ.get(CONFIG_PATH_ENV)
    base = Settings.from_yaml(config_path) if config_path else None
    return Settings.from_env(base)


# ---------------------------------------------------------------------------
# YAML: the subset of configs/*.yaml (block mappings by indentation, plain
# and quoted scalars, inline [] lists, comments), typed as pyyaml's safe
# loader types plain scalars (YAML 1.1). Anything else raises ConfigError.
# ---------------------------------------------------------------------------

_YAML_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                        r"|on|On|ON|off|Off|OFF)$")
_YAML_TRUE = {"yes", "true", "on"}
_YAML_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_YAML_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                       r"|[-+]?0x[0-9a-fA-F_]+)$")
_YAML_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# plain scalars that pyyaml would read as something this reader does not
# build: sexagesimal numbers, timestamps, merge keys, anchors, tags, aliases
_YAML_OUTSIDE = re.compile(r"^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                           r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)$")
_YAML_INDICATORS = set("&*!|>%@`{}[]\"'")
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_.\-]*)\s*:(?:\s+(.*))?$")


def _yaml_plain(text: str, where: str) -> Any:
    if _YAML_NULL.match(text):
        return None
    if _YAML_BOOL.match(text):
        return text.lower() in _YAML_TRUE
    if _YAML_INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v.startswith("-") else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if len(v) > 1 and v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _YAML_FLOAT.match(text):
        v = text.replace("_", "").lower()
        if v.lstrip("+-") == ".inf":
            return -math.inf if v.startswith("-") else math.inf
        if v == ".nan":
            return math.nan
        return float(v)
    if _YAML_OUTSIDE.match(text) or text[0] in _YAML_INDICATORS or text.startswith(("- ", "? ")) \
            or ": " in text or " #" in text or text.endswith(":"):
        raise ConfigError(f"{where}: {text!r} is outside the YAML subset the port reads")
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _yaml_quoted(text: str, i: int, where: str) -> tuple[str, int]:
    """The quoted scalar starting at ``text[i]`` and the index after it."""
    quote, out, i = text[i], [], i + 1
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and c == '"':
            return "".join(out), i + 1
        if quote == '"' and c == "\\":
            e = text[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            if e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = text[i + 2:i + 2 + n]
                if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                    raise ConfigError(f"{where}: bad escape in {text!r}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
                continue
            raise ConfigError(f"{where}: unknown escape \\{e} in {text!r}")
        out.append(c)
        i += 1
    raise ConfigError(f"{where}: unterminated quoted scalar in {text!r}")


def _strip_comment(text: str) -> str:
    """``text`` without a trailing comment (``#`` at the start or after
    whitespace, outside quotes)."""
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 2
                continue
            if c == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
        elif c in "\"'" and (i == 0 or text[i - 1] in " [,:"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _yaml_value(text: str, where: str) -> Any:
    """A scalar or an inline ``[...]`` list of scalars (comment removed)."""
    if text[0] in "\"'":
        value, end = _yaml_quoted(text, 0, where)
        if text[end:].strip():
            raise ConfigError(f"{where}: text after a quoted scalar: {text!r}")
        return value
    if text[0] == "[":
        if not text.endswith("]"):
            raise ConfigError(f"{where}: unterminated inline list {text!r}")
        items: list = []
        i, body = 0, text[1:-1]
        while True:
            while i < len(body) and body[i] in " \t":
                i += 1
            if i >= len(body):
                if items:
                    raise ConfigError(f"{where}: trailing comma in {text!r}")
                return items
            if body[i] in "\"'":
                value, i = _yaml_quoted(body, i, where)
            else:
                j = body.find(",", i)
                j = len(body) if j < 0 else j
                item = body[i:j].strip()
                if not item or item[0] in "[{":
                    raise ConfigError(f"{where}: {text!r} is outside the YAML subset the port reads")
                value, i = _yaml_plain(item, where), j
            items.append(value)
            while i < len(body) and body[i] in " \t":
                i += 1
            if i >= len(body):
                return items
            if body[i] != ",":
                raise ConfigError(f"{where}: expected ',' in {text!r}")
            i += 1
    return _yaml_plain(text, where)


def parse_yaml(text: str, source: str = "<yaml>") -> Any:
    """The tree that ``yaml.safe_load`` gives for YAML in the subset of
    ``configs/*.yaml``: block mappings nested by indentation (spaces),
    plain, single- and double-quoted scalars typed as pyyaml types them,
    inline ``[...]`` lists of scalars, comments and blank lines.
    Anything else (block sequences, multi-line or block scalars, anchors,
    tags, flow mappings, tabs, duplicate keys) raises :class:`ConfigError`."""
    lines: list[tuple[int, int, str]] = []  # (line number, indent, content)
    for n, raw in enumerate(text.splitlines(), 1):
        if raw.strip() in ("---", "...") and not raw.startswith(" "):
            if raw.strip() == "..." or lines:
                raise ConfigError(f"{source}:{n}: one document only")
            continue
        body = _strip_comment(raw)
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t") or "\t" in body[: len(body) - len(stripped)]:
            raise ConfigError(f"{source}:{n}: tabs in indentation")
        lines.append((n, len(body) - len(stripped), stripped))
    if not lines:
        return None
    if len(lines) == 1 and not _KEY.match(lines[0][2]):
        n, _, content = lines[0]
        return _yaml_value(content, f"{source}:{n}")

    pos = 0

    def mapping(indent: int) -> dict:
        nonlocal pos
        out: dict = {}
        while pos < len(lines):
            n, ind, content = lines[pos]
            where = f"{source}:{n}"
            if ind < indent:
                break
            if ind > indent:
                raise ConfigError(f"{where}: unexpected indentation")
            m = _KEY.match(content)
            if not m:
                raise ConfigError(f"{where}: {content!r} is outside the YAML subset the port reads")
            key, rest = m.group(1), m.group(2)
            if key in out:
                raise ConfigError(f"{where}: duplicate key {key!r}")
            pos += 1
            if rest:
                out[key] = _yaml_value(rest, where)
            elif pos < len(lines) and lines[pos][1] > indent:
                out[key] = mapping(lines[pos][1])
            else:
                out[key] = None
        return out

    tree = mapping(lines[0][1])
    if pos != len(lines):
        n = lines[pos][0]
        raise ConfigError(f"{source}:{n}: unexpected indentation")
    return tree


def _yaml_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        r = repr(value)
        if "e" in r:  # YAML 1.1 floats need a dot and a signed exponent
            mant, exp = r.split("e")
            mant = mant if "." in mant else mant + ".0"
            exp = exp if exp[0] in "+-" else "+" + exp
            r = f"{mant}e{exp}"
        return r
    if isinstance(value, str):
        return json.dumps(value)  # a JSON string is a YAML double-quoted scalar
    raise ConfigError(f"cannot write {value!r} as YAML")


def dump_yaml(tree: dict, indent: int = 0) -> str:
    """``tree`` in the subset :func:`parse_yaml` reads (and pyyaml too)."""
    out = []
    pad = " " * indent
    for key, value in tree.items():
        if isinstance(value, dict):
            out.append(f"{pad}{key}:\n{dump_yaml(value, indent + 2)}")
        elif isinstance(value, list):
            out.append(f"{pad}{key}: [{', '.join(_yaml_scalar(v) for v in value)}]\n")
        else:
            out.append(f"{pad}{key}: {_yaml_scalar(value)}\n")
    return "".join(out)
