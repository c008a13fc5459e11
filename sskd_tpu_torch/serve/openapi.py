"""OpenAPI 3.1 spec and the ``/docs`` page (port of sskd_tpu/serve/openapi.py).

The JAX package derives the component schemas from its pydantic models;
the port, without pydantic, writes them from the field table below, which
states the request and response models of ``serve/schemas.py`` with the
JAX package's bounds and defaults. The spec (and the HTML rendered from it,
with no assets from elsewhere) equals the JAX package's for the same flags.
Routes that ``create_app`` registers only when enabled (the metrics path,
``/cache/flush``) appear only then.
"""

from __future__ import annotations

import html
import json
from typing import Any

_REF_TEMPLATE = "#/components/schemas/{model}"
_NULLABLE_STRING = {"anyOf": [{"type": "string"}, {"type": "null"}], "default": None}

# model -> [(field, schema, required)], as pydantic writes them
_MODELS: dict[str, list[tuple[str, dict, bool]]] = {
    "SearchRequest": [
        ("query", {"type": "string", "minLength": 1, "maxLength": 1000}, True),
        ("k", {"type": "integer", "default": 10, "minimum": 1, "maximum": 100}, False),
        ("rerank", {"type": "boolean", "default": False}, False),
        ("rerank_top_k", {"type": "integer", "default": 50, "minimum": 1, "maximum": 200}, False),
    ],
    "SearchResult": [
        ("doc_id", {"type": "string"}, True),
        ("text", _NULLABLE_STRING, False),
        ("score", {"type": "number"}, True),
        ("rank", {"type": "integer"}, True),
    ],
    "SearchResponse": [
        ("query", {"type": "string"}, True),
        ("results", {"type": "array",
                     "items": {"$ref": _REF_TEMPLATE.format(model="SearchResult")}}, True),
        ("total_results", {"type": "integer"}, True),
        ("reranked", {"type": "boolean"}, True),
        ("hybrid", {"type": "boolean", "default": False}, False),
        ("latency_ms", {"type": "number"}, True),
    ],
    "EncodeRequest": [
        ("texts", {"type": "array", "items": {"type": "string"}, "minItems": 1,
                   "maxItems": 100}, True),
        ("normalize", {"type": "boolean", "default": True}, False),
    ],
    "EncodeResponse": [
        ("embeddings", {"type": "array",
                        "items": {"type": "array", "items": {"type": "number"}}}, True),
        ("dimension", {"type": "integer"}, True),
        ("num_texts", {"type": "integer"}, True),
        ("latency_ms", {"type": "number"}, True),
    ],
    "IndexLoadRequest": [("index_dir", {"type": "string", "minLength": 1}, True)],
    "HealthResponse": [
        ("status", {"type": "string"}, True),
        ("model_loaded", {"type": "boolean"}, True),
        ("index_loaded", {"type": "boolean"}, True),
        ("index_size", {"type": "integer"}, True),
        ("version", {"type": "string"}, True),
    ],
    "ErrorResponse": [
        ("error", {"type": "string"}, True),
        ("message", {"type": "string"}, True),
        ("details", {"type": "object", "additionalProperties": True}, False),
    ],
}


def _sorted(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _sorted(node[k]) for k in sorted(node)}
    if isinstance(node, list):
        return [_sorted(v) for v in node]
    return node


def component_schemas() -> dict[str, dict]:
    """The JSON schema of each model (keys sorted, properties in field
    order, titles from the names), as pydantic's ``models_json_schema``
    writes them."""
    out = {}
    for model in sorted(_MODELS):
        props = {name: _sorted({**schema, "title": name.title().replace("_", " ")})
                 for name, schema, _ in _MODELS[model]}
        out[model] = {"properties": props,
                      "required": [name for name, _, req in _MODELS[model] if req],
                      "title": model, "type": "object"}
    return out


def _ref(model: str) -> dict[str, str]:
    return {"$ref": _REF_TEMPLATE.format(model=model)}


def _json_body(model: str) -> dict[str, Any]:
    return {"required": True, "content": {"application/json": {"schema": _ref(model)}}}


def _response(description: str, model: str | None = None) -> dict[str, Any]:
    out: dict[str, Any] = {"description": description}
    if model is not None:
        out["content"] = {"application/json": {"schema": _ref(model)}}
    return out


_ERROR_RESPONSES = {
    "422": _response("validation error", "ErrorResponse"),
    "429": _response("rate limited", "ErrorResponse"),
    "503": _response("not ready / index not loaded", "ErrorResponse"),
}


def build_openapi(
    version: str,
    *,
    metrics_path: str | None = None,
    cache_flush: bool = False,
    auth_enabled: bool = False,
) -> dict[str, Any]:
    """The spec of the routes ``create_app`` registered."""
    paths: dict[str, Any] = {
        "/": {"get": {"summary": "Service info: version, environment, endpoint list",
                      "responses": {"200": _response("service info")}}},
        "/health": {"get": {"summary": "Liveness + load state",
                            "responses": {"200": _response("health", "HealthResponse")}}},
        "/ready": {"get": {"summary": "Readiness gate (503 until the model is up)",
                           "responses": {"200": _response("ready"),
                                         "503": _response("not ready", "ErrorResponse")}}},
        "/live": {"get": {"summary": "Bare liveness probe",
                          "responses": {"200": _response("alive")}}},
        "/search": {"post": {
            "summary": "Semantic top-k search (optional cross-encoder "
            "rerank, hybrid BM25 fusion, result cache)",
            "requestBody": _json_body("SearchRequest"),
            "responses": {"200": _response("ranked results", "SearchResponse"),
                          **_ERROR_RESPONSES},
        }},
        "/encode": {"post": {
            "summary": "Embed texts with the student bi-encoder",
            "requestBody": _json_body("EncodeRequest"),
            "responses": {"200": _response("embeddings", "EncodeResponse"), **_ERROR_RESPONSES},
        }},
        "/index/load": {"post": {
            "summary": "Hot-swap the served index from a directory",
            "requestBody": _json_body("IndexLoadRequest"),
            "responses": {"200": _response("index loaded"),
                          "400": _response("bad index dir", "ErrorResponse"),
                          **_ERROR_RESPONSES},
        }},
    }
    if metrics_path:
        paths[metrics_path] = {"get": {"summary": "Prometheus text exposition",
                                       "responses": {"200": {"description": "metrics text"}}}}
    if cache_flush:
        paths["/cache/flush"] = {"post": {
            "summary": "Flush the query-result and embedding caches",
            "responses": {"200": _response("flushed")},
        }}
    spec: dict[str, Any] = {
        "openapi": "3.1.0",
        "info": {
            "title": "Semantic Search API",
            "description": "Production-grade semantic search with "
            "knowledge distillation (TPU-native serving stack)",
            "version": version,
        },
        "paths": paths,
        "components": {"schemas": component_schemas()},
    }
    if auth_enabled:
        spec["components"]["securitySchemes"] = {
            "ApiKeyAuth": {"type": "apiKey", "in": "header", "name": "X-API-Key"}
        }
        spec["security"] = [{"ApiKeyAuth": []}]
    return spec


def render_docs_html(spec: dict[str, Any]) -> str:
    """The API docs as one HTML page: each route with its method, summary,
    request body and responses, then each schema, rendered on the server."""
    info = spec["info"]
    rows: list[str] = []
    for path, methods in spec["paths"].items():
        for method, op in methods.items():
            req_ref = (op.get("requestBody", {}).get("content", {})
                       .get("application/json", {}).get("schema", {}).get("$ref", ""))
            req_name = req_ref.rsplit("/", 1)[-1] if req_ref else "—"
            resps = ", ".join(sorted(op.get("responses", {}))) or "—"
            rows.append(
                f"<tr><td class='m {method}'>{method.upper()}</td>"
                f"<td><code>{html.escape(path)}</code></td>"
                f"<td>{html.escape(op.get('summary', ''))}</td>"
                f"<td>{html.escape(req_name)}</td>"
                f"<td>{html.escape(resps)}</td></tr>"
            )
    schemas = spec.get("components", {}).get("schemas", {})
    schema_blocks = "\n".join(
        f"<details><summary><code>{html.escape(name)}</code></summary>"
        f"<pre>{html.escape(json.dumps(body, indent=2))}</pre></details>"
        for name, body in sorted(schemas.items())
    )
    return f"""<!doctype html>
<html><head><meta charset="utf-8">
<title>{html.escape(info["title"])} — API docs</title>
<style>
 body {{ font: 15px/1.5 system-ui, sans-serif; margin: 2rem auto;
        max-width: 60rem; padding: 0 1rem; color: #1a1a1a; }}
 table {{ border-collapse: collapse; width: 100%; }}
 td, th {{ border-bottom: 1px solid #ddd; padding: .4rem .6rem;
          text-align: left; vertical-align: top; }}
 .m {{ font-weight: 700; }} .get {{ color: #0b7285; }}
 .post {{ color: #5f3dc4; }}
 pre {{ background: #f6f6f6; padding: .8rem; overflow-x: auto; }}
 details {{ margin: .4rem 0; }}
</style></head><body>
<h1>{html.escape(info["title"])}</h1>
<p>{html.escape(info.get("description", ""))} —
version {html.escape(info["version"])}.
Machine-readable spec: <a href="/openapi.json">/openapi.json</a></p>
<table><tr><th></th><th>path</th><th>summary</th><th>request body</th>
<th>responses</th></tr>
{chr(10).join(rows)}
</table>
<h2>Schemas</h2>
{schema_blocks}
</body></html>"""
