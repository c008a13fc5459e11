"""Serving middleware (port of sskd_tpu/serve/middleware.py): rate limiting
(per-client token buckets), API-key auth (SHA-256 or PBKDF2 hashes, never
plaintext), request logging, security headers and CORS.

``create_app`` adds them so that they run in the JAX package's order:
APIKey, then RateLimit, then RequestLogging, then SecurityHeaders, then
CORS; so a request without a key is answered 401 before it spends a token.
The rate-limit and request-logging middlewares take the app's
:class:`~sskd_tpu_torch.serve.metrics.Metrics` instead of reading
module-level metrics. Query text never reaches the logs unless
``log_queries`` is set; handlers log ``sha256(query)[:12]``.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import threading
import time
from typing import Iterable

from sskd_tpu_torch.serve.http import Request, Response
from sskd_tpu_torch.serve.metrics import Metrics
from sskd_tpu_torch.utils.logging import get_logger

logger = get_logger("serve")


class TokenBucket:
    """A token bucket: ``burst`` tokens, refilled at ``rate_per_minute``."""

    def __init__(self, rate_per_minute: int, burst: int):
        self.rate = rate_per_minute / 60.0  # tokens per second
        self.capacity = float(burst)
        self.tokens = float(burst)
        self.last_refill = time.monotonic()

    def _refill(self, now: float) -> None:
        elapsed = now - self.last_refill
        self.tokens = min(self.capacity, self.tokens + elapsed * self.rate)
        self.last_refill = now

    def consume(self, n: float = 1.0) -> bool:
        self._refill(time.monotonic())
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def time_until_available(self, n: float = 1.0) -> float:
        self._refill(time.monotonic())
        deficit = n - self.tokens
        return max(0.0, deficit / self.rate) if self.rate > 0 else float("inf")


class RateLimiter:
    """Per-client token buckets, thread-safe, with stale buckets dropped
    every ``CLEANUP_INTERVAL_S`` and at most ``MAX_BUCKETS`` kept (the
    least recently seen goes first)."""

    CLEANUP_INTERVAL_S = 300.0
    STALE_AFTER_S = 600.0
    MAX_BUCKETS = 10_000
    EXCLUDED_PATHS = ("/health", "/metrics", "/")

    def __init__(self, requests_per_minute: int = 60, burst: int = 10):
        self.requests_per_minute = requests_per_minute
        self.burst = burst
        self._buckets: dict[str, TokenBucket] = {}
        self._last_seen: dict[str, float] = {}
        self._lock = threading.Lock()
        self._last_cleanup = time.monotonic()

    @staticmethod
    def client_key(request: Request) -> str:
        """The first hop of X-Forwarded-For, else the socket's peer."""
        fwd = request.headers.get("x-forwarded-for", "")
        if fwd:
            return fwd.split(",")[0].strip()
        return request.client

    def _cleanup(self, now: float) -> None:
        if now - self._last_cleanup < self.CLEANUP_INTERVAL_S:
            return
        self._last_cleanup = now
        stale = [k for k, seen in self._last_seen.items() if now - seen > self.STALE_AFTER_S]
        for k in stale:
            self._buckets.pop(k, None)
            self._last_seen.pop(k, None)
        if stale:
            logger.debug(f"cleaned up {len(stale)} stale rate-limit buckets")

    def check(self, request: Request) -> tuple[bool, float]:
        """(allowed, seconds until a token is available)."""
        if request.path in self.EXCLUDED_PATHS:
            return True, 0.0
        key = self.client_key(request)
        now = time.monotonic()
        with self._lock:
            self._cleanup(now)
            bucket = self._buckets.get(key)
            if bucket is None:
                if len(self._buckets) >= self.MAX_BUCKETS:
                    oldest = min(self._last_seen, key=self._last_seen.get)
                    self._buckets.pop(oldest, None)
                    self._last_seen.pop(oldest, None)
                bucket = TokenBucket(self.requests_per_minute, self.burst)
                self._buckets[key] = bucket
            self._last_seen[key] = now
            if bucket.consume():
                return True, 0.0
            return False, bucket.time_until_available()

    def middleware(self, metrics: Metrics | None = None):
        async def mw(request: Request, nxt):
            allowed, retry_after = self.check(request)
            if not allowed:
                if metrics is not None:
                    metrics.rate_limit_hits.inc()
                return Response(
                    {"error": "rate limit exceeded"},
                    status=429,
                    headers={"Retry-After": f"{retry_after:.1f}"},
                )
            return await nxt(request)

        return mw


class APIKeyAuth:
    """A set of key hashes: SHA-256, or PBKDF2-HMAC-SHA256 when a salt is
    set. Keys come from the constructor, as plaintext or hashes, and from
    the ``SEMANTIC_KD_API_KEY_HASHES`` environment variable (a JSON list).
    The hashes are the JAX package's: a key made by either verifies in
    the other."""

    EXCLUDED_PATHS = ("/health", "/", "/docs", "/openapi.json", "/live", "/ready")
    PBKDF2_ITERATIONS = 100_000

    def __init__(
        self,
        api_keys: Iterable[str] = (),
        api_key_hashes: Iterable[str] = (),
        salt: str = "",
        header: str = "X-API-Key",
    ):
        self.salt = salt
        self.header = header.lower()
        self._hashes: set[str] = set(api_key_hashes)
        env_hashes = os.environ.get("SEMANTIC_KD_API_KEY_HASHES", "")
        if env_hashes:
            try:
                self._hashes.update(json.loads(env_hashes))
            except json.JSONDecodeError:
                logger.error("SEMANTIC_KD_API_KEY_HASHES is not valid JSON; ignored")
        for key in api_keys:
            self._hashes.add(self.hash_key(key, salt))

    @staticmethod
    def hash_key(key: str, salt: str = "") -> str:
        if salt:
            return hashlib.pbkdf2_hmac(
                "sha256", key.encode(), salt.encode(), APIKeyAuth.PBKDF2_ITERATIONS
            ).hex()
        return hashlib.sha256(key.encode()).hexdigest()

    def add_key(self, key: str) -> str:
        h = self.hash_key(key, self.salt)
        self._hashes.add(h)
        return h

    def remove_key(self, key: str) -> None:
        self._hashes.discard(self.hash_key(key, self.salt))

    def verify(self, key: str | None) -> bool:
        if not key or not self._hashes:
            return False
        candidate = self.hash_key(key, self.salt)
        return any(hmac.compare_digest(candidate, h) for h in self._hashes)

    def middleware(self):
        async def mw(request: Request, nxt):
            # CORS preflights carry no credentials by the spec
            if request.path in self.EXCLUDED_PATHS or request.method == "OPTIONS":
                return await nxt(request)
            if not self.verify(request.headers.get(self.header)):
                return Response(
                    {"error": "invalid or missing API key"},
                    status=401,
                    headers={"WWW-Authenticate": "ApiKey"},
                )
            return await nxt(request)

        return mw


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
