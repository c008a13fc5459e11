"""Configuration of the port (port of sskd_tpu/config.py).

Standard-library dataclasses in place of pydantic (the machine with the GPU
has neither pydantic nor pyyaml). The sections the port reads keep the JAX
package's field names, defaults and bounds: ``student``, ``teacher``,
``index``, ``search`` (with the rerank fields), ``service``, ``precision``,
``cors`` and ``monitoring`` for serving, ``loss``, ``training``, ``mining``
(the three-stage curriculum) and ``data`` (the pipeline's data directory
and chunking) for KD training, each with only the fields the port reads.
Sections that later slices need (rate limiting, auth, cache, hybrid) are
not here yet; a ``mesh`` section raises, as data-parallel training is not
ported.

Overrides: ``Settings.from_dict({"index": {"search_method": "exact"}})``
for keyword-style trees, and ``SEMANTIC_KD_<SECTION>__<FIELD>=value``
environment variables through :meth:`Settings.from_env` (values parsed as
JSON when they parse, else kept as strings). A value outside its bounds or
an unknown section or field raises :class:`ConfigError`. ``Settings``
remembers which fields ``from_dict`` / ``from_env`` were given
(:meth:`Settings.is_set`, the stand-in for pydantic's ``model_fields_set``):
serving lets an explicit ``index.nprobe`` override a loaded index's own.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field, fields
from typing import Any

from sskd_tpu_torch.exceptions import ConfigError

ENV_PREFIX = "SEMANTIC_KD_"
NESTED_DELIMITER = "__"


def _check(obj, name: str, *, ge=None, le=None, choices=None, kind=None) -> None:
    value = getattr(obj, name)
    where = f"{type(obj).__name__}.{name}={value!r}"
    if kind is not None and not isinstance(value, kind):
        raise ConfigError(f"{where}: expected {kind}")
    if choices is not None and value not in choices:
        raise ConfigError(f"{where}: must be one of {choices}")
    if ge is not None and value < ge:
        raise ConfigError(f"{where}: must be >= {ge}")
    if le is not None and value > le:
        raise ConfigError(f"{where}: must be <= {le}")


_INT = (int,)
_NUM = (int, float)


@dataclass
class StudentModelConfig:
    model_name: str = "intfloat/e5-small-v2"
    max_seq_length: int = 512
    normalize_embeddings: bool = True
    query_prefix: str = "query: "
    passage_prefix: str = "passage: "
    pooling: str = "mean"

    def __post_init__(self):
        _check(self, "max_seq_length", ge=1, le=8192, kind=_INT)
        _check(self, "pooling", choices=("mean", "cls"))


@dataclass
class TeacherModelConfig:
    """The cross-encoder teacher (sskd_tpu/config.py:44)."""

    model_name: str = "BAAI/bge-reranker-large"
    max_seq_length: int = 512
    batch_size: int = 32

    def __post_init__(self):
        _check(self, "max_seq_length", ge=1, le=8192, kind=_INT)
        _check(self, "batch_size", ge=1, kind=_INT)


@dataclass
class IndexConfig:
    """The JAX package's IndexConfig, the fields the port reads. These are
    build-time settings: a loaded index is served as it was recorded, except
    for an explicitly set ``nprobe`` and for ``refine_storage``, where the
    bf16 refine rows live, a deployment choice applied at load (see
    ``serve/app.py``)."""

    search_method: str = "approx"
    recall_target: float = 0.99
    block_rows: int = 262144
    cluster_rows: int = 0  # 0 = auto (about sqrt(N))
    nprobe: int = 64
    # int8 / int4 two-stage refinement: the sweep fetches refine_m candidates,
    # their bf16 rows are rescored; 0 disables
    refine_m: int = 0
    refine_storage: str = "device"  # "device" or "host": where the bf16 refine rows live
    validation_queries: int = 1000
    validation_recall_at_10: float = 0.97

    def __post_init__(self):
        _check(self, "search_method", choices=("exact", "approx", "clustered"))
        _check(self, "recall_target", ge=0.5, le=1.0, kind=_NUM)
        _check(self, "block_rows", ge=128, kind=_INT)
        _check(self, "cluster_rows", ge=0, kind=_INT)
        _check(self, "nprobe", ge=1, kind=_INT)
        _check(self, "refine_m", ge=0, kind=_INT)
        _check(self, "refine_storage", choices=("device", "host"))
        _check(self, "validation_queries", ge=1, kind=_INT)
        _check(self, "validation_recall_at_10", ge=0.0, le=1.0, kind=_NUM)


@dataclass
class PrecisionConfig:
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        _check(self, "compute_dtype", choices=("float32", "bfloat16"))


@dataclass
class CORSConfig:
    enabled: bool = True
    allow_origins: list = field(default_factory=lambda: ["*"])
    allow_methods: list = field(default_factory=lambda: ["GET", "POST"])
    allow_headers: list = field(default_factory=lambda: ["*"])
    allow_credentials: bool = False


@dataclass
class MonitoringConfig:
    prometheus_enabled: bool = True
    prometheus_path: str = "/metrics"
    log_queries: bool = False
    log_latencies: bool = True


@dataclass
class ServiceConfig:
    environment: str = "development"
    micro_batch_window_ms: float = 0.0
    micro_batch_max_size: int = 64

    def __post_init__(self):
        _check(self, "environment", choices=("development", "staging", "production"))
        _check(self, "micro_batch_window_ms", ge=0.0, kind=_NUM)
        _check(self, "micro_batch_max_size", ge=1, kind=_INT)


@dataclass
class SearchConfig:
    default_k: int = 10
    max_k: int = 100
    rerank_enabled: bool = False
    rerank_top_k: int = 50  # results the teacher rescores
    rerank_timeout_ms: float = 5000.0  # past it, the bi-encoder order is served

    def __post_init__(self):
        _check(self, "default_k", ge=1, le=100, kind=_INT)
        _check(self, "max_k", ge=1, kind=_INT)
        _check(self, "rerank_top_k", ge=1, le=200, kind=_INT)
        _check(self, "rerank_timeout_ms", kind=_NUM)
        if self.rerank_timeout_ms <= 0.0:
            raise ConfigError(f"SearchConfig.rerank_timeout_ms={self.rerank_timeout_ms!r}: "
                              "must be > 0")


@dataclass
class LossConfig:
    margin_mse_weight: float = 0.6
    listwise_kd_weight: float = 0.2
    contrastive_weight: float = 0.2
    temperature_start: float = 4.0
    temperature_end: float = 2.0
    contrastive_tau: float = 0.05
    # widen the InfoNCE denominator with every other query's docs in the batch
    in_batch_negatives: bool = False

    def __post_init__(self):
        for name in ("margin_mse_weight", "listwise_kd_weight", "contrastive_weight"):
            _check(self, name, ge=0.0, le=1.0, kind=_NUM)
        for name in ("temperature_start", "temperature_end", "contrastive_tau"):
            _check(self, name, kind=_NUM)
            if getattr(self, name) <= 0.0:
                raise ConfigError(f"LossConfig.{name}={getattr(self, name)!r}: must be > 0")
        total = self.margin_mse_weight + self.listwise_kd_weight + self.contrastive_weight
        if abs(total - 1.0) > 1e-6:
            raise ConfigError(f"loss weights must sum to 1.0, got {total}")


@dataclass
class TrainingConfig:
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

    def __post_init__(self):
        for name in ("epochs", "batch_size", "grad_accum_steps"):
            _check(self, name, ge=1, kind=_INT)
        _check(self, "num_docs_per_query", ge=2, kind=_INT)
        for name in ("early_stopping_patience", "save_steps", "eval_steps", "prefetch_batches"):
            _check(self, name, ge=0, kind=_INT)
        _check(self, "weight_decay", ge=0.0, kind=_NUM)
        _check(self, "warmup_ratio", ge=0.0, le=1.0, kind=_NUM)
        for name in ("learning_rate", "max_grad_norm"):
            _check(self, name, kind=_NUM)
            if getattr(self, name) <= 0.0:
                raise ConfigError(f"TrainingConfig.{name}={getattr(self, name)!r}: must be > 0")
        _check(self, "remat_policy", choices=("full", "dots"))
        if self.rng_impl != "rbg":
            raise ConfigError(
                f"TrainingConfig.rng_impl={self.rng_impl!r}: the JAX generators (rbg, "
                "unsafe_rbg, threefry2x32) do not exist in the port, whose dropout masks come "
                "from torch generators and the dropattn kernels' Philox; leave it at 'rbg'"
            )


@dataclass
class MiningConfig:
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

    def __post_init__(self):
        _check(self, "stage", ge=1, le=3, kind=_INT)
        for name in ("bm25_top_k", "teacher_top_k", "ance_top_k",
                     "ance_refresh_every_n_steps"):
            _check(self, name, ge=1, kind=_INT)
        _check(self, "ance_warmup_steps", ge=0, kind=_INT)
        for name in ("teacher_confidence_threshold", "denoise_text_overlap_threshold",
                     "bm25_b"):
            _check(self, name, ge=0.0, le=1.0, kind=_NUM)
        for name in ("ance_margin", "bm25_epsilon"):
            _check(self, name, ge=0.0, kind=_NUM)
        _check(self, "bm25_k1", kind=_NUM)
        if self.bm25_k1 <= 0.0:
            raise ConfigError(f"MiningConfig.bm25_k1={self.bm25_k1!r}: must be > 0")


@dataclass
class DataConfig:
    """Where the pipeline keeps its data and how it chunks it
    (sskd_tpu/config.py DataConfig)."""

    data_dir: str = "data"
    max_samples: int = 0  # 0 = all
    chunk_max_tokens: int = 512
    chunk_stride: int = 80

    def __post_init__(self):
        _check(self, "max_samples", ge=0, kind=_INT)
        _check(self, "chunk_max_tokens", ge=8, kind=_INT)
        _check(self, "chunk_stride", ge=0, kind=_INT)


_SECTIONS = {
    "student": StudentModelConfig,
    "teacher": TeacherModelConfig,
    "index": IndexConfig,
    "precision": PrecisionConfig,
    "cors": CORSConfig,
    "monitoring": MonitoringConfig,
    "service": ServiceConfig,
    "search": SearchConfig,
    "loss": LossConfig,
    "training": TrainingConfig,
    "mining": MiningConfig,
    "data": DataConfig,
}


@dataclass
class Settings:
    student: StudentModelConfig = field(default_factory=StudentModelConfig)
    teacher: TeacherModelConfig = field(default_factory=TeacherModelConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    cors: CORSConfig = field(default_factory=CORSConfig)
    monitoring: MonitoringConfig = field(default_factory=MonitoringConfig)
    service: ServiceConfig = field(default_factory=ServiceConfig)
    search: SearchConfig = field(default_factory=SearchConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    mining: MiningConfig = field(default_factory=MiningConfig)
    data: DataConfig = field(default_factory=DataConfig)
    # the (section, field) names that from_dict / from_env were given
    fields_set: frozenset = field(default_factory=frozenset, compare=False, repr=False)

    def to_dict(self) -> dict[str, Any]:
        return {s: asdict(getattr(self, s)) for s in _SECTIONS}

    def is_set(self, section: str, name: str) -> bool:
        """Whether ``section.name`` was given explicitly (by ``from_dict`` or
        ``from_env``, here or in ``base``) rather than left at its default."""
        return (section, name) in self.fields_set

    @classmethod
    def from_dict(cls, data: dict[str, Any], base: "Settings | None" = None) -> "Settings":
        """Settings from a nested ``{section: {field: value}}`` tree, on top
        of ``base`` (or the defaults)."""
        base = base or cls()
        merged = base.to_dict()
        given = set(base.fields_set)
        for section, values in data.items():
            if section == "mesh":
                raise ConfigError(
                    "the mesh section (data-parallel training and sharding) is not "
                    "ported yet: ROADMAP Queue 1 item 7"
                )
            if section not in _SECTIONS:
                raise ConfigError(f"unknown config section {section!r}")
            if not isinstance(values, dict):
                raise ConfigError(f"config section {section!r} must be a mapping")
            known = {f.name for f in fields(_SECTIONS[section])}
            for name, value in values.items():
                if name not in known:
                    raise ConfigError(f"unknown config field {section}.{name}")
                merged[section][name] = value
                given.add((section, name))
        return cls(
            **{s: _SECTIONS[s](**merged[s]) for s in _SECTIONS}, fields_set=frozenset(given)
        )

    @classmethod
    def from_env(cls, base: "Settings | None" = None, environ=None) -> "Settings":
        """Apply ``SEMANTIC_KD_<section>__<field>=value`` overrides; variables
        that name no known section and field are ignored, as in the JAX
        package."""
        environ = os.environ if environ is None else environ
        tree: dict[str, dict[str, Any]] = {}
        for key, value in environ.items():
            if not key.startswith(ENV_PREFIX):
                continue
            parts = key[len(ENV_PREFIX) :].lower().split(NESTED_DELIMITER)
            if len(parts) != 2 or parts[0] not in _SECTIONS:
                continue
            section, name = parts
            if name not in {f.name for f in fields(_SECTIONS[section])}:
                continue
            try:
                tree.setdefault(section, {})[name] = json.loads(value)
            except ValueError:
                tree.setdefault(section, {})[name] = value
        return cls.from_dict(tree, base)


def get_settings() -> Settings:
    """Defaults with the environment's overrides."""
    return Settings.from_env()
