"""Serving middleware (port of sskd_tpu/serve/middleware.py, the parts on by
default): request logging, security headers and CORS.

Rate limiting and API-key auth are off by default in the JAX package and
come with a later slice of the port. The request-logging middleware takes
the app's :class:`~sskd_tpu_torch.serve.metrics.Metrics` instead of reading
module-level metrics. Query text never reaches the logs unless
``log_queries`` is set; handlers log ``sha256(query)[:12]``.
"""

from __future__ import annotations

import hashlib
import time

from sskd_tpu_torch.serve.http import Request, Response
from sskd_tpu_torch.serve.metrics import Metrics
from sskd_tpu_torch.utils.logging import get_logger

logger = get_logger("serve")


def hash_query(text: str) -> str:
    """SHA-256[:12] of the query text, for logs."""
    return hashlib.sha256(text.encode()).hexdigest()[:12]


def request_logging_middleware(
    metrics: Metrics, log_queries: bool = False, log_latencies: bool = True
):
    async def mw(request: Request, nxt):
        start = time.perf_counter()
        response = await nxt(request)
        elapsed_ms = (time.perf_counter() - start) * 1000.0
        status = response.status
        level = "error" if status >= 500 else "warning" if status >= 400 else "info"
        line = f"{request.method} {request.path} client={request.client} status={status}"
        if log_latencies:
            line += f" latency_ms={elapsed_ms:.1f}"
        if log_queries and request.method == "POST":
            try:
                body = request.json()
            except ValueError:  # malformed body: already answered 4xx
                body = None
            if isinstance(body, dict) and "query" in body:
                line += f" query={body['query']!r}"
        getattr(logger, level)(line)
        metrics.requests_total.labels(
            method=request.method, path=request.path, status=str(status)
        ).inc()
        metrics.request_duration.labels(path=request.path).observe(elapsed_ms / 1000.0)
        return response

    return mw


SECURITY_HEADERS = {
    "X-Content-Type-Options": "nosniff",
    "X-Frame-Options": "DENY",
    "X-XSS-Protection": "1; mode=block",
    "Strict-Transport-Security": "max-age=31536000; includeSubDomains",
    "Content-Security-Policy": "default-src 'self'",
    "Referrer-Policy": "strict-origin-when-cross-origin",
}


def security_headers_middleware():
    async def mw(request: Request, nxt):
        response = await nxt(request)
        for k, v in SECURITY_HEADERS.items():
            response.headers.setdefault(k, v)
        return response

    return mw


def cors_middleware(
    allow_origins: list[str],
    allow_methods: list[str],
    allow_headers: list[str],
    allow_credentials: bool = False,
):
    wildcard = "*" in allow_origins

    def origin_allowed(origin: str) -> bool:
        return wildcard or origin in allow_origins

    def origin_header(origin: str) -> str:
        # a credentialed response may not use the "*" wildcard: echo the origin
        return origin if (allow_credentials or not wildcard) else "*"

    async def mw(request: Request, nxt):
        origin = request.headers.get("origin", "")
        if request.method == "OPTIONS":
            if origin and origin_allowed(origin):
                headers = {
                    "Access-Control-Allow-Origin": origin_header(origin),
                    "Access-Control-Allow-Methods": ", ".join(allow_methods),
                    "Access-Control-Allow-Headers": ", ".join(allow_headers),
                }
                if allow_credentials:
                    headers["Access-Control-Allow-Credentials"] = "true"
                return Response(b"", status=204, headers=headers)
            return Response(b"", status=204)
        response = await nxt(request)
        if origin and origin_allowed(origin):
            response.headers.setdefault("Access-Control-Allow-Origin", origin_header(origin))
            if allow_credentials:
                response.headers.setdefault("Access-Control-Allow-Credentials", "true")
        return response

    return mw
