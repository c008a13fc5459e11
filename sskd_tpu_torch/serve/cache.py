"""Query-result and embedding caches (port of sskd_tpu/serve/cache.py).

:class:`TTLCache` is a thread-safe TTL + LRU store (an ``OrderedDict``,
moved to the end on a hit, the least recently used dropped past
``max_size``, expired entries dropped when read; ``clock`` injectable). The
result cache's key is SHA-256 over the normalized query (whitespace
collapsed, casefolded) and every parameter that shapes the response (``k``,
``rerank``, ``rerank_top_k``); the embedding cache's key hashes the exact
text and the normalize flag, since two texts that differ in case may embed
differently. ``/index/load`` clears the result cache, ``POST /cache/flush``
both. The keys are the JAX package's, byte for byte.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Any, Callable

from sskd_tpu_torch.utils.logging import get_logger


class TTLCache:
    """Thread-safe TTL + LRU key-value store."""

    def __init__(
        self,
        max_size: int = 10000,
        ttl_seconds: float = 3600.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_size < 1:
            raise ValueError(f"max_size must be >= 1, got {max_size}")
        if ttl_seconds <= 0:
            raise ValueError(f"ttl_seconds must be > 0, got {ttl_seconds}")
        self.max_size = int(max_size)
        self.ttl_seconds = float(ttl_seconds)
        self._clock = clock
        self._lock = threading.Lock()
        self._store: OrderedDict[str, tuple[float, Any]] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Any | None:
        """The cached value, or None (an expired entry is dropped)."""
        now = self._clock()
        with self._lock:
            entry = self._store.get(key)
            if entry is not None and now >= entry[0]:
                del self._store[key]
                entry = None
            if entry is None:
                self.misses += 1
                return None
            self._store.move_to_end(key)
            self.hits += 1
            return entry[1]

    def put(self, key: str, value: Any) -> None:
        now = self._clock()
        with self._lock:
            self._store[key] = (now + self.ttl_seconds, value)
            self._store.move_to_end(key)
            while len(self._store) > self.max_size:
                self._store.popitem(last=False)

    def clear(self) -> int:
        """Drop every entry; returns how many were dropped."""
        with self._lock:
            n = len(self._store)
            self._store.clear()
            return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"entries": len(self._store), "hits": self.hits, "misses": self.misses}


def normalize_query(query: str) -> str:
    """Whitespace collapsed and casefolded."""
    return " ".join(query.split()).casefold()


def result_cache_key(query: str, k: int, rerank: bool, rerank_top_k: int) -> str:
    payload = f"{normalize_query(query)}\x00k={k}\x00rr={int(rerank)}\x00rrk={rerank_top_k}"
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()


def embedding_cache_key(text: str, normalize: bool) -> str:
    payload = f"{text}\x00n={int(normalize)}"
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()


_SUPPORTED_BACKENDS = ("memory", "in-memory")


def make_caches(cfg) -> tuple[TTLCache | None, TTLCache | None]:
    """(query_cache, embedding_cache) from a ``CacheConfig``: (None, None)
    when the cache is off. Another backend ("redis", "memcached") is served
    from memory with a warning, as in the JAX package."""
    if not cfg.enabled:
        return None, None
    if cfg.backend not in _SUPPORTED_BACKENDS:
        get_logger("serve.cache").warning(
            f"cache.backend={cfg.backend!r} is not shipped; serving from the in-process "
            "memory backend instead"
        )
    query_cache = TTLCache(max_size=cfg.max_size, ttl_seconds=cfg.ttl_seconds)
    embedding_cache = (
        TTLCache(max_size=cfg.max_size, ttl_seconds=cfg.ttl_seconds)
        if cfg.embedding_cache else None
    )
    return query_cache, embedding_cache
