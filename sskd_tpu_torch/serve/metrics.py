"""Prometheus metrics rendered by hand (port of sskd_tpu/serve/metrics.py).

The JAX package uses prometheus_client, which the machine with the GPU does
not have. This module keeps the names, help texts and latency buckets of the
metrics the serving path updates, in one :class:`Metrics` object per app,
rendered in the text exposition format (version 0.0.4). Updates take a lock:
the batcher's worker thread and the event loop both write.
"""

from __future__ import annotations

import threading

LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


def _labels(pairs: list[tuple[str, str]]) -> str:
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}" if pairs else ""


class _Metric:
    kind = ""

    def __init__(self, name: str, help_text: str, labelnames: tuple[str, ...] = ()):
        self.name, self.help, self.labelnames = name, help_text, tuple(labelnames)
        self._lock = threading.Lock()
        self._series: dict[tuple[str, ...], object] = {}

    def labels(self, **values: str) -> "_Series":
        if set(values) != set(self.labelnames):
            raise ValueError(f"{self.name} takes labels {self.labelnames}")
        return _Series(self, tuple(str(values[n]) for n in self.labelnames))

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            series = dict(self._series) or ({(): self._empty()} if not self.labelnames else {})
        for values, state in sorted(series.items()):
            lines += self._lines(list(zip(self.labelnames, values)), state)
        return lines


class _Series:
    def __init__(self, metric: _Metric, values: tuple[str, ...]):
        self.metric, self.values = metric, values

    def inc(self, amount: float = 1.0) -> None:
        self.metric._add(self.values, amount)

    def observe(self, value: float) -> None:
        self.metric._add(self.values, value)

    def set(self, value: float) -> None:
        self.metric._set(self.values, value)


class Counter(_Metric):
    kind = "counter"

    def _empty(self):
        return 0.0

    def _add(self, values, amount):
        with self._lock:
            self._series[values] = self._series.get(values, 0.0) + amount

    def inc(self, amount: float = 1.0) -> None:
        self._add((), amount)

    def _lines(self, labels, state):
        return [f"{self.name}_total{_labels(labels)} {float(state)!r}"]


class Gauge(_Metric):
    kind = "gauge"

    def _empty(self):
        return 0.0

    def _set(self, values, value):
        with self._lock:
            self._series[values] = float(value)

    def set(self, value: float) -> None:
        self._set((), value)

    def _lines(self, labels, state):
        return [f"{self.name}{_labels(labels)} {float(state)!r}"]


class Histogram(_Metric):
    kind = "histogram"

    def _empty(self):
        return ([0] * len(LATENCY_BUCKETS), 0, 0.0)

    def _add(self, values, x):
        with self._lock:
            counts, n, total = self._series.get(values) or self._empty()
            counts = [c + (x <= b) for c, b in zip(counts, LATENCY_BUCKETS)]
            self._series[values] = (counts, n + 1, total + x)

    def observe(self, value: float) -> None:
        self._add((), value)

    def _lines(self, labels, state):
        counts, n, total = state
        out = [
            f"{self.name}_bucket{_labels(labels + [('le', str(le))])} {float(c)!r}"
            for le, c in [*zip(LATENCY_BUCKETS, counts), ("+Inf", n)]
        ]
        out.append(f"{self.name}_count{_labels(labels)} {float(n)!r}")
        out.append(f"{self.name}_sum{_labels(labels)} {float(total)!r}")
        return out


class Metrics:
    """The serving path's metric catalog (names as in the JAX package)."""

    def __init__(self):
        self.requests_total = Counter(
            "semantic_kd_requests", "Total HTTP requests", ("method", "path", "status")
        )
        self.request_duration = Histogram(
            "semantic_kd_request_duration_seconds", "HTTP request latency", ("path",)
        )
        self.encode_latency = Histogram(
            "semantic_kd_encode_latency_seconds", "Query/document encode latency"
        )
        self.search_latency = Histogram(
            "semantic_kd_search_latency_seconds", "Index search latency"
        )
        self.model_load_seconds = Gauge("semantic_kd_model_load_seconds", "Model load wall time")
        self.index_size = Gauge("semantic_kd_index_size", "Number of vectors in the loaded index")
        self.rerank_latency = Histogram(
            "semantic_kd_rerank_latency_seconds", "Teacher rerank latency"
        )
        self.rerank_triggers = Counter(
            "semantic_kd_rerank_trigger", "Searches that requested reranking"
        )
        self.rate_limit_hits = Counter(
            "semantic_kd_rate_limit_hits", "Requests rejected by the rate limiter"
        )
        self.cache_hits = Counter(
            "semantic_kd_cache_hits",
            "Cache hits (result = /search payloads, embedding = /encode vectors)",
            ("cache",),
        )
        self.cache_misses = Counter("semantic_kd_cache_misses", "Cache misses", ("cache",))
        self.cache_entries = Gauge(
            "semantic_kd_cache_entries", "Entries currently held by each cache", ("cache",)
        )
        # never set, as in the JAX package: infra/alert_rules.yml's
        # ThroughputCollapse reads it
        self.queries_per_second = Gauge(
            "semantic_kd_queries_per_second_chip", "Most recent measured search throughput per chip"
        )

    def render(self) -> bytes:
        lines: list[str] = []
        for metric in vars(self).values():
            lines.extend(metric.render())
        return ("\n".join(lines) + "\n").encode()
