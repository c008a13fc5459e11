"""Exception hierarchy for sskd_tpu_torch.

Copy of sskd_tpu/exceptions.py (the port imports nothing of sskd_tpu).

Mirrors the reference's hierarchy (reference: src/exceptions.py:10-363):
every error carries a stable ``error_code`` plus a ``details`` dict and can be
serialized with ``to_dict()`` for API error payloads.
"""

from __future__ import annotations

from typing import Any


class SemanticKDError(Exception):
    """Base class for all framework errors."""

    error_code: str = "SEMANTIC_KD_ERROR"

    def __init__(self, message: str, details: dict[str, Any] | None = None):
        super().__init__(message)
        self.message = message
        self.details = details or {}

    def to_dict(self) -> dict[str, Any]:
        return {
            "error": self.error_code,
            "message": self.message,
            "details": self.details,
        }

    def __str__(self) -> str:  # pragma: no cover - trivial
        if self.details:
            return f"{self.message} ({self.details})"
        return self.message


# --------------------------------------------------------------------------
# Model errors
# --------------------------------------------------------------------------


class ModelError(SemanticKDError):
    error_code = "MODEL_ERROR"


class ModelLoadError(ModelError):
    error_code = "MODEL_LOAD_ERROR"


class ModelNotFoundError(ModelError):
    error_code = "MODEL_NOT_FOUND"


class EncodingError(ModelError):
    error_code = "ENCODING_ERROR"


class WeightConversionError(ModelError):
    """Raised when HF torch -> Flax parameter conversion fails."""

    error_code = "WEIGHT_CONVERSION_ERROR"


# --------------------------------------------------------------------------
# Index errors
# --------------------------------------------------------------------------


class IndexError_(SemanticKDError):
    """Named with a trailing underscore to avoid shadowing the builtin."""

    error_code = "INDEX_ERROR"


class IndexBuildError(IndexError_):
    error_code = "INDEX_BUILD_ERROR"


class IndexLoadError(IndexError_):
    error_code = "INDEX_LOAD_ERROR"


class IndexNotLoadedError(IndexError_):
    error_code = "INDEX_NOT_LOADED"


class IndexSearchError(IndexError_):
    error_code = "INDEX_SEARCH_ERROR"


class IndexVersionError(IndexError_):
    """On-disk index layout version mismatch."""

    error_code = "INDEX_VERSION_ERROR"


# --------------------------------------------------------------------------
# Data errors
# --------------------------------------------------------------------------


class DataError(SemanticKDError):
    error_code = "DATA_ERROR"


class DatasetNotFoundError(DataError):
    error_code = "DATASET_NOT_FOUND"


class DataIntegrityError(DataError):
    error_code = "DATA_INTEGRITY_ERROR"


class ChecksumMismatchError(DataIntegrityError):
    error_code = "CHECKSUM_MISMATCH"


# --------------------------------------------------------------------------
# Training errors
# --------------------------------------------------------------------------


class TrainingError(SemanticKDError):
    error_code = "TRAINING_ERROR"


class CheckpointError(TrainingError):
    error_code = "CHECKPOINT_ERROR"


class MiningError(TrainingError):
    error_code = "MINING_ERROR"


# --------------------------------------------------------------------------
# Search / serving errors
# --------------------------------------------------------------------------


class SearchError(SemanticKDError):
    error_code = "SEARCH_ERROR"


class ServiceNotReadyError(SemanticKDError):
    error_code = "SERVICE_NOT_READY"


class RerankError(SearchError):
    error_code = "RERANK_ERROR"


# --------------------------------------------------------------------------
# Auth / rate-limit errors
# --------------------------------------------------------------------------


class AuthError(SemanticKDError):
    error_code = "AUTH_ERROR"


class InvalidAPIKeyError(AuthError):
    error_code = "INVALID_API_KEY"


class RateLimitExceededError(SemanticKDError):
    error_code = "RATE_LIMIT_EXCEEDED"

    def __init__(
        self,
        message: str = "Rate limit exceeded",
        retry_after: float = 1.0,
        details: dict[str, Any] | None = None,
    ):
        details = dict(details or {})
        details.setdefault("retry_after", retry_after)
        super().__init__(message, details)
        self.retry_after = retry_after


# --------------------------------------------------------------------------
# Config errors
# --------------------------------------------------------------------------


class ConfigError(SemanticKDError):
    error_code = "CONFIG_ERROR"


class ValidationError_(SemanticKDError):
    error_code = "VALIDATION_ERROR"
