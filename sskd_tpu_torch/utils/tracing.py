"""Spans (port of sskd_tpu/utils/tracing.py).

:func:`span` is a context manager that times a block in milliseconds, with
its parent's name (per thread) and attributes, and keeps the record in a
ring buffer of the last ``MAX_SPANS`` (:meth:`_Tracer.recent`); when the
OpenTelemetry SDK is installed and ``monitoring.opentelemetry_enabled`` is
set, each span also goes to OTel. The span names are the JAX package's.

The JAX package's ``start_jax_profiler`` (a JAX profiler server on
``monitoring.jax_profiler_port``) has no counterpart: torch serves no
traces on a port, so ``create_app`` refuses a nonzero port rather than
ignoring it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field

from sskd_tpu_torch.utils.logging import get_logger

logger = get_logger("tracing")

SPAN_ENCODE_QUERY = "encode_query"
SPAN_INDEX_SEARCH = "index_search"
SPAN_RERANK = "rerank"
SPAN_LOAD_MODEL = "load_model"
SPAN_LOAD_INDEX = "load_index"


@dataclass
class Span:
    name: str
    start_s: float
    duration_ms: float = 0.0
    parent: str | None = None
    attributes: dict = field(default_factory=dict)


class _Tracer:
    """In-process tracer with a bounded ring buffer; exports to OTel when
    the SDK is there and configured."""

    MAX_SPANS = 2048

    def __init__(self):
        self.spans: deque[Span] = deque(maxlen=self.MAX_SPANS)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._otel_tracer = None

    def configure_otel(self, endpoint: str = "", service_name: str = "semantic-kd") -> bool:
        """Attach the OTel SDK if it imports; returns whether it did."""
        try:
            from opentelemetry import trace  # type: ignore
        except ImportError:
            logger.warning("opentelemetry SDK not installed; in-process spans only")
            return False
        self._otel_tracer = trace.get_tracer(service_name or "semantic-kd")
        logger.info(f"opentelemetry tracing enabled (service={service_name}, "
                    f"endpoint={endpoint or 'default'})")
        return True

    @contextmanager
    def span(self, name: str, **attributes):
        parent = getattr(self._local, "current", None)
        self._local.current = name
        record = Span(name=name, start_s=time.time(), parent=parent, attributes=attributes)
        otel_cm = (self._otel_tracer.start_as_current_span(name)
                   if self._otel_tracer is not None else None)
        if otel_cm is not None:
            otel_cm.__enter__()
        t0 = time.perf_counter()
        try:
            yield record
        finally:
            record.duration_ms = (time.perf_counter() - t0) * 1000.0
            if otel_cm is not None:
                otel_cm.__exit__(None, None, None)
            self._local.current = parent
            with self._lock:
                self.spans.append(record)

    def recent(self, name: str | None = None, limit: int = 100) -> list[Span]:
        with self._lock:
            spans = list(self.spans)
        if name:
            spans = [s for s in spans if s.name == name]
        return spans[-limit:]

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()


TRACER = _Tracer()
span = TRACER.span
