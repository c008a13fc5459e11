"""ctypes binding of the native WordPiece core, ``native/wordpiece.cc``
(port of sskd_tpu/tokenization/native.py:25-225).

ASCII text goes through the C++ core, whose ids and offsets equal the pure
Python tokenizer's (byte offsets are character offsets there); other text
takes the pure Python path, whose offsets are in code points. The binding:

- compiles ``native/wordpiece.cc`` with ``g++`` (the flags of
  ``native/Makefile``) into ``build/native/libwordpiece-<hash>.so`` at the
  root of the checkout, named by the hash of the source and the flags, so an
  unchanged source is not rebuilt; it never loads ``native/libwordpiece.so``;
- links each build to a name of its own and moves it into place with
  ``os.replace``, so a process that finds the library finds all of it, even
  while another process builds the same one;
- builds nothing at import: the first tokenizer that asks for the core
  builds it; without a compiler it logs a warning and the tokenizer stays on
  pure Python (``SSKD_NATIVE_TOKENIZER=0`` keeps it there).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from sskd_tpu_torch.utils.logging import get_logger

logger = get_logger("tokenization.native")

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "wordpiece.cc"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++20", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")

_lock = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LIB_FAILED = False


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libwordpiece-{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the core unless this source is built already; returns the
    library's path. The compiler writes a temporary file that ``os.replace``
    then moves into place."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) for the native tokenizer")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every exported symbol's signature."""
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
    lib.wp_free.argtypes = [ctypes.c_void_p]
    lib.wp_tokenize.restype = ctypes.c_int
    lib.wp_tokenize.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.wp_tokenize_batch.restype = None
    lib.wp_tokenize_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    return lib


def _load_library() -> ctypes.CDLL | None:
    """The bound core, built on first use; None (once, with a warning) when
    it cannot be built or loaded."""
    global _LIB, _LIB_FAILED
    with _lock:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        try:
            path = build_library()
            _LIB = _bind(ctypes.CDLL(str(path)))
            logger.info(f"native wordpiece core loaded from {path}")
        except (subprocess.SubprocessError, OSError, RuntimeError, AttributeError) as e:
            logger.warning(f"native tokenizer unavailable ({e}); pure-python fallback")
            _LIB_FAILED = True
        return _LIB


# text a thread takes before one more thread pays for itself: the core
# tokenizes about 25 MB/s a thread, and starting and joining a thread costs
# tens of microseconds (milliseconds under a container's CPU quota, where a
# thread a core for every 16-query serving batch cost 5 ms on the card's host)
BYTES_PER_THREAD = 16 << 10


def batch_threads(n_bytes: int) -> int:
    """Threads for one batch call of ``n_bytes`` of text:
    ``SSKD_TOKENIZER_THREADS`` when set to a positive count, else one per
    ``BYTES_PER_THREAD``, at most the CPUs this process may use."""
    try:
        forced = int(os.environ.get("SSKD_TOKENIZER_THREADS", "0"))
    except ValueError:  # malformed knob degrades to the default,
        forced = 0  # never a hot-path outage
    if forced > 0:
        return forced
    cpus = min(len(os.sched_getaffinity(0)), os.cpu_count() or 1)
    return max(1, min(cpus, n_bytes // BYTES_PER_THREAD))


class NativeWordPiece:
    """Handle on a C++ vocab. One instance per tokenizer."""

    def __init__(self, vocab: dict[str, int], unk_id: int, lowercase: bool):
        self._lib = _load_library()
        self._handle = None
        self.lowercase = lowercase
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        ordered = sorted(vocab.items(), key=lambda kv: kv[1])
        max_id = ordered[-1][1] if ordered else -1
        lines = [""] * (max_id + 1)
        for token, idx in ordered:
            lines[idx] = token
        blob = "\n".join(lines).encode("utf-8")
        self._handle = self._lib.wp_create(blob, len(blob), unk_id)
        # scratch buffers are thread-local: the serving path tokenizes from
        # executor threads (serve/app.py, serve/batcher.py), and a shared
        # buffer would race
        self._tls = threading.local()

    def __del__(self):  # pragma: no cover - GC timing
        if getattr(self, "_handle", None) and self._lib is not None:
            self._lib.wp_free(self._handle)
            self._handle = None

    def _buffers(self, cap: int):
        tls = self._tls
        if getattr(tls, "cap", 0) < cap:
            tls.cap = max(cap, 2048)
            tls.ids_buf = np.empty(tls.cap, dtype=np.int32)
            tls.off_buf = np.empty(2 * tls.cap, dtype=np.int32)
        return tls.ids_buf, tls.off_buf, tls.cap

    def _call(self, text: str) -> int:
        """Run the C tokenizer into this thread's reusable scratch buffers;
        returns the token count. Buffer contents are valid until the next
        call FROM THE SAME THREAD."""
        data = text.encode("ascii")
        ids_buf, off_buf, cap = self._buffers(max(16, 2 * len(data) + 8))
        n = self._lib.wp_tokenize(
            self._handle,
            data,
            len(data),
            1 if self.lowercase else 0,
            ids_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            off_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            cap,
        )
        if n < 0:  # pragma: no cover - cap is 2x input length
            raise RuntimeError("native tokenizer output buffer overflow")
        return n

    def tokenize_with_offsets(self, text: str):
        """ASCII-only fast path; caller guarantees ``text.isascii()``."""
        n = self._call(text)
        tls = self._tls
        pairs = tls.off_buf[: 2 * n].reshape(n, 2)
        return tls.ids_buf[:n].tolist(), [tuple(p) for p in pairs.tolist()]

    def tokenize_ids_view(self, text: str) -> np.ndarray:
        """Ids only, as an int32 view into this thread's scratch buffer,
        valid until the next call on this instance from the same thread: no
        per-token list is made. Caller guarantees ``text.isascii()``."""
        n = self._call(text)  # allocates this thread's buffers first
        return self._tls.ids_buf[:n]

    def tokenize_ids_matrix(self, texts, cap: int) -> tuple[np.ndarray, np.ndarray]:
        """Batch ids: one C call over all texts, internally multithreaded
        (ctypes drops the GIL for the call, so the std::thread pool gives
        real multicore scaling — the per-text entry point serializes on
        re-entering Python between texts). Returns ``(ids [n, cap] int32,
        counts [n] int32)`` where row i holds ``counts[i]`` valid ids,
        capped at ``cap`` — callers frame to <= cap tokens anyway, so the
        cap loses nothing. Caller guarantees every text is ASCII. Threads:
        ``SSKD_TOKENIZER_THREADS`` when set (as in the JAX package), else
        :func:`batch_threads` of the batch's bytes."""
        n = len(texts)
        if n == 0:
            return (
                np.empty((0, cap), np.int32),
                np.empty((0,), np.int32),
            )
        blob = "".join(texts).encode("ascii")
        n_threads = batch_threads(len(blob))
        ends = np.cumsum(
            np.asarray([len(t) for t in texts], np.int64), dtype=np.int64
        )
        starts = np.concatenate(([0], ends[:-1])).astype(np.int64)
        out_ids = np.empty((n, cap), dtype=np.int32)
        out_counts = np.empty(n, dtype=np.int32)
        self._lib.wp_tokenize_batch(
            self._handle,
            blob,
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            ends.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            n,
            1 if self.lowercase else 0,
            cap,
            out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            out_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            int(n_threads),
        )
        return out_ids, out_counts


def native_available() -> bool:
    return _load_library() is not None
