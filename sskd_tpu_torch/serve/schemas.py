"""API request and response schemas (port of sskd_tpu/serve/schemas.py): the
requests (``SearchRequest``, ``EncodeRequest``, ``IndexLoadRequest``) and
``SearchResult``; ``serve/openapi.py`` states every model's JSON schema.

Validation by hand with the JAX package's bounds (pydantic is not on the
machine with the GPU): a request that breaks one raises
:class:`~sskd_tpu_torch.exceptions.ValidationError_`, which the app answers
with 422 and the list of problems.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any

from sskd_tpu_torch.exceptions import ValidationError_


def _field(body: dict, name: str, kind, default, problems: list, *, lo=None, hi=None):
    value = body.get(name, default)
    if kind is int and (isinstance(value, bool) or not isinstance(value, int)):
        problems.append(f"{name}: expected an integer")
        return default
    if kind is not int and not isinstance(value, kind):
        problems.append(f"{name}: expected {kind.__name__}")
        return default
    size = len(value) if isinstance(value, (str, list)) else value
    if lo is not None and size < lo:
        problems.append(f"{name}: below the minimum {lo}")
    if hi is not None and size > hi:
        problems.append(f"{name}: above the maximum {hi}")
    return value


def _object(body: Any) -> dict:
    """The body as a dict; unknown keys are ignored, as pydantic does."""
    if not isinstance(body, dict):
        raise ValidationError_("request body must be a JSON object")
    return body


@dataclass
class SearchRequest:
    query: str
    k: int = 10
    rerank: bool = False
    rerank_top_k: int = 50

    @classmethod
    def parse(cls, body: Any) -> "SearchRequest":
        body = _object(body)
        problems: list[str] = []
        if "query" not in body:
            problems.append("query: field required")
        req = cls(
            query=_field(body, "query", str, "", problems, lo=1, hi=1000),
            k=_field(body, "k", int, 10, problems, lo=1, hi=100),
            rerank=_field(body, "rerank", bool, False, problems),
            rerank_top_k=_field(body, "rerank_top_k", int, 50, problems, lo=1, hi=200),
        )
        if problems:
            raise ValidationError_("invalid search request", {"problems": problems})
        return req


@dataclass
class SearchResult:
    doc_id: str
    score: float
    rank: int
    text: str | None = None

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class EncodeRequest:
    texts: list
    normalize: bool = True

    @classmethod
    def parse(cls, body: Any) -> "EncodeRequest":
        body = _object(body)
        problems: list[str] = []
        if "texts" not in body:
            problems.append("texts: field required")
        texts = _field(body, "texts", list, [], problems, lo=1, hi=100)
        if any(not isinstance(t, str) for t in texts):
            problems.append("texts: every item must be a string")
        req = cls(texts=texts, normalize=_field(body, "normalize", bool, True, problems))
        if problems:
            raise ValidationError_("invalid encode request", {"problems": problems})
        return req


@dataclass
class IndexLoadRequest:
    index_dir: str

    @classmethod
    def parse(cls, body: Any) -> "IndexLoadRequest":
        body = _object(body)
        problems: list[str] = []
        if "index_dir" not in body:
            problems.append("index_dir: field required")
        req = cls(index_dir=_field(body, "index_dir", str, "", problems, lo=1))
        if problems:
            raise ValidationError_("invalid index load request", {"problems": problems})
        return req
