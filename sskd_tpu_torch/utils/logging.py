"""Structured logging on stdlib. Copy of sskd_tpu/utils/logging.py with its
own logger root, ``sskd_tpu_torch``.

Original notes follow (the reference used loguru,
reference: src/utils/logging.py:10-55 — console + rotating file sink).

Provides the same surface: ``setup_logging(log_file=..., level=...,
rotation_bytes=..., retention=...)`` and ``get_logger(name)``.

Like the reference's ``enqueue=True`` sinks, records are handed to a
background QueueListener thread by default, so a log call on the serving
hot path costs a queue put (~1 µs) instead of a synchronous stream
write+flush (~0.5 ms measured through a pipe — two log lines per request
was ~1 ms/request of event-loop stall). Set ``SSKD_LOG_SYNC=1`` (or
``enqueue=False``) to emit inline, e.g. when debugging a crash where the
tail of the log matters more than latency.
"""

from __future__ import annotations

import atexit
import logging
import logging.handlers
import os
import queue
import sys
from pathlib import Path

_ROOT_NAME = "sskd_tpu_torch"
_CONFIGURED = False
_LISTENER: logging.handlers.QueueListener | None = None

_FORMAT = "%(asctime)s | %(levelname)-8s | %(name)s:%(funcName)s:%(lineno)d - %(message)s"


def _stop_listener() -> None:
    """Flush and stop the background sink thread (idempotent)."""
    global _LISTENER
    if _LISTENER is not None:
        try:
            _LISTENER.stop()
        except Exception:  # pragma: no cover — interpreter teardown races
            pass
        _LISTENER = None


atexit.register(_stop_listener)


def setup_logging(
    log_file: str | Path | None = None,
    level: str = "INFO",
    rotation_bytes: int = 50 * 1024 * 1024,
    retention: int = 10,
    force: bool = False,
    enqueue: bool | None = None,
) -> logging.Logger:
    """Configure console + optional rotating-file logging.

    Matches the reference's behavior of rotation + retention
    (reference: src/utils/logging.py:36-48). Compression is skipped —
    rotated files are small and the stdlib handler doesn't zip.

    ``enqueue`` (default: on unless ``SSKD_LOG_SYNC=1``) routes records
    through a queue to a background writer thread, keeping blocking I/O
    out of the caller — the asyncio serving loop in particular.
    """
    global _CONFIGURED, _LISTENER
    logger = logging.getLogger(_ROOT_NAME)
    if _CONFIGURED and not force:
        return logger

    if enqueue is None:
        enqueue = os.environ.get("SSKD_LOG_SYNC", "0") != "1"

    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    _stop_listener()  # force-reconfigure: retire the previous sink thread
    logger.handlers.clear()
    logger.propagate = False

    sinks: list[logging.Handler] = []
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(logging.Formatter(_FORMAT))
    sinks.append(console)

    if log_file is not None:
        log_path = Path(log_file)
        log_path.parent.mkdir(parents=True, exist_ok=True)
        file_handler = logging.handlers.RotatingFileHandler(
            log_path, maxBytes=rotation_bytes, backupCount=retention
        )
        file_handler.setFormatter(logging.Formatter(_FORMAT))
        sinks.append(file_handler)

    if enqueue:
        q: queue.SimpleQueue = queue.SimpleQueue()
        logger.addHandler(logging.handlers.QueueHandler(q))
        _LISTENER = logging.handlers.QueueListener(
            q, *sinks, respect_handler_level=True
        )
        _LISTENER.start()
    else:
        for h in sinks:
            logger.addHandler(h)

    _CONFIGURED = True
    return logger


def flush_logs() -> None:
    """Drain the queued sink: call before reading a log file the same
    process just wrote (tests, rotation checks). The listener has no public
    flush; its ``stop`` joins the thread after draining, so a stop and a
    restart over the same queue and sinks is a full barrier."""
    global _LISTENER
    if _LISTENER is not None:
        sinks, q = _LISTENER.handlers, _LISTENER.queue
        _stop_listener()
        _LISTENER = logging.handlers.QueueListener(q, *sinks, respect_handler_level=True)
        _LISTENER.start()


def get_logger(name: str | None = None) -> logging.Logger:
    """Child logger under the framework root. Unlike the JAX package's copy,
    asking for a logger configures nothing (importing a module must start no
    thread); entry points call :func:`setup_logging`, and until then records
    of level WARNING and above reach stderr through logging's last resort."""
    if name:
        return logging.getLogger(f"{_ROOT_NAME}.{name}")
    return logging.getLogger(_ROOT_NAME)
