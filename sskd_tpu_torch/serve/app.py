"""Serving application (port of sskd_tpu/serve/app.py, the ``/search`` path).

Routes: ``/``, ``/health``, ``/ready``, ``/live``, ``POST /search``,
``POST /encode`` and ``/metrics``, on the first-party HTTP stack. Startup
loads the student, with ``search.rerank_enabled`` the cross-encoder teacher
(``teacher.model_name``, :class:`~sskd_tpu_torch.models.teacher.TeacherModel`),
preloads the index when ``preload_index_dir`` is given, builds the
:class:`~sskd_tpu_torch.serve.fused.FusedSearcher`, warms it up and starts
the micro-batcher. Differences from the JAX package:

- every step of startup is fatal when it fails, warmup included (the JAX
  package logs a failed warmup and serves on), but for one case that the
  JAX package tolerates too: a teacher checkpoint directory that cannot be
  read (``OSError``, ``ValueError``, ``ModelLoadError``,
  ``WeightConversionError``, ``ConfigError``) leaves reranking off, and
  ``rerank=true`` is then answered in the bi-encoder's order with
  ``reranked: false``. A CUDA or kernel error while the teacher is built or
  run is not such a case: it fails the startup or the request;
- hybrid search, caches, sharding, ``/docs``, ``/openapi.json`` and
  ``/index/load`` are later slices (ROADMAP).

``/search`` with ``rerank=true`` fetches the request's ``rerank_top_k``
results (default 50, as in the JAX app; ``search.rerank_top_k`` is kept for
the settings' parity), scores (query, text or doc id) pairs with the teacher
in a worker thread at ``teacher.batch_size``, and answers them in the order
of the teacher's logits, which become the scores, with ``reranked: true``.
Past ``search.rerank_timeout_ms`` the bi-encoder's order is served (the
scoring runs on in its thread). Both are counted as in the JAX package
(``semantic_kd_rerank_trigger_total``, ``semantic_kd_rerank_latency_seconds``).

As in the JAX package, a preloaded index is served under the ``index_type``
it records (``exact``, ``approx`` or ``clustered``), of f32, bf16, int8 or
int4 rows, and one with bf16 refine rows through the refined engine
(:class:`~sskd_tpu_torch.serve.fused.FusedSearcher`): ``index.search_method``
is read only where an index is built, which no route of this slice does. An
``index.nprobe`` that the settings were given explicitly overrides the value
saved in a clustered index's ``meta.json``; the default does not.
``index.refine_storage`` (a deployment choice, not saved with the index)
places the refine rows of the loaded index on the device or the host.
"""

from __future__ import annotations

import asyncio
import json
import time

import numpy as np
import torch

from sskd_tpu_torch.config import Settings, get_settings
from sskd_tpu_torch.exceptions import (
    ConfigError,
    ModelLoadError,
    SemanticKDError,
    ValidationError_,
    WeightConversionError,
)
from sskd_tpu_torch.index.builder import IndexBuilder
from sskd_tpu_torch.models.student import StudentModel
from sskd_tpu_torch.models.teacher import TeacherModel
from sskd_tpu_torch.serve.batcher import MicroBatcher
from sskd_tpu_torch.serve.fused import FusedSearcher
from sskd_tpu_torch.serve.http import App, Request, Response
from sskd_tpu_torch.serve.metrics import Metrics
from sskd_tpu_torch.serve.middleware import (
    cors_middleware,
    hash_query,
    request_logging_middleware,
    security_headers_middleware,
)
from sskd_tpu_torch.serve.schemas import EncodeRequest, SearchRequest, SearchResult
from sskd_tpu_torch.utils.logging import get_logger
from sskd_tpu_torch.version import __version__

logger = get_logger("serve.app")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# what a teacher checkpoint that cannot be read raises: reranking stays off
_UNREADABLE_CHECKPOINT = (OSError, ValueError, ModelLoadError, WeightConversionError, ConfigError)


class AppState:
    def __init__(self, settings: Settings):
        self.settings = settings
        self.metrics = Metrics()
        self.student: StudentModel | None = None
        self.teacher: TeacherModel | None = None
        self.index_builder: IndexBuilder | None = None
        self.fused_searcher: FusedSearcher | None = None
        self.search_batcher: MicroBatcher | None = None
        self.ready = False

    @property
    def index_loaded(self) -> bool:
        return self.index_builder is not None and self.index_builder.is_built

    def batched_search(self, items: list[tuple[str, int]]):
        """One encode + search for a micro-batch of (query, k) requests."""
        queries = [q for q, _ in items]
        t0 = time.perf_counter()
        scores, indices = self.fused_searcher.search_texts(queries, k=max(k for _, k in items))
        self.metrics.search_latency.observe(time.perf_counter() - t0)
        return [(scores[i, :k], indices[i, :k]) for i, (_, k) in enumerate(items)]


def _status_for(exc: SemanticKDError) -> int:
    if isinstance(exc, ValidationError_):
        return 422
    if isinstance(exc, ConfigError):
        return 400
    return 500


def create_app(
    settings: Settings | None = None,
    student_model_path: str | None = None,
    device: str | torch.device | None = "cuda",
    preload_index_dir: str | None = None,
) -> App:
    settings = settings or get_settings()
    app = App()
    state = AppState(settings)
    app.state = state

    # middlewares, added inner to outer
    if settings.cors.enabled:
        c = settings.cors
        app.add_middleware(
            cors_middleware(
                c.allow_origins, c.allow_methods, c.allow_headers,
                allow_credentials=c.allow_credentials,
            )
        )
    app.add_middleware(security_headers_middleware())
    app.add_middleware(
        request_logging_middleware(
            state.metrics,
            log_queries=settings.monitoring.log_queries,
            log_latencies=settings.monitoring.log_latencies,
        )
    )

    def startup():
        t0 = time.perf_counter()
        s = settings.student
        state.student = StudentModel(
            student_model_path or s.model_name,
            device=device,
            max_seq_length=s.max_seq_length,
            query_prefix=s.query_prefix,
            passage_prefix=s.passage_prefix,
            normalize=s.normalize_embeddings,
            pooling=s.pooling,
            compute_dtype=_DTYPES[settings.precision.compute_dtype],
        )
        state.metrics.model_load_seconds.set(time.perf_counter() - t0)
        if settings.search.rerank_enabled:
            try:
                state.teacher = TeacherModel(
                    settings.teacher.model_name,
                    device=device,
                    max_seq_length=settings.teacher.max_seq_length,
                )
            except _UNREADABLE_CHECKPOINT:
                logger.exception("teacher checkpoint unreadable: reranking disabled")
                state.teacher = None
        if preload_index_dir:
            builder = IndexBuilder(device=state.student.device).load(preload_index_dir)
            # nprobe is a query-time knob (the cell layout does not depend on
            # it): an explicit setting wins over the index's saved value
            if settings.is_set("index", "nprobe"):
                builder.nprobe = settings.index.nprobe
            # where the bf16 refine rows live is a deployment choice (the
            # rows are the same bytes either way)
            builder.refine_storage = settings.index.refine_storage
            state.index_builder = builder
            state.fused_searcher = FusedSearcher(state.student, builder)
            state.metrics.index_size.set(builder.ntotal)
            state.fused_searcher.warmup(
                max_batch=settings.service.micro_batch_max_size, k=settings.search.default_k
            )
        else:
            state.student.encode_queries(["warmup query"])
        if settings.service.micro_batch_max_size > 1 and state.fused_searcher is not None:
            state.search_batcher = MicroBatcher(
                state.batched_search,
                window_ms=settings.service.micro_batch_window_ms,
                max_size=settings.service.micro_batch_max_size,
            )
        state.ready = True

    async def shutdown():
        state.ready = False
        if state.search_batcher is not None:
            await state.search_batcher.close()
            state.search_batcher = None

    app.on_startup.append(startup)
    app.on_shutdown.append(shutdown)

    def kd_error_handler(request: Request, exc: SemanticKDError) -> Response:
        payload = exc.to_dict()
        if settings.service.environment == "production":
            payload.pop("details", None)
        return Response(payload, status=_status_for(exc))

    def bad_json_handler(request: Request, exc: Exception) -> Response:
        return Response({"error": "invalid JSON body"}, status=422)

    app.add_exception_handler(SemanticKDError, kd_error_handler)
    app.add_exception_handler(json.JSONDecodeError, bad_json_handler)

    @app.get("/")
    async def root(request: Request) -> Response:
        endpoints = ["/health", "/ready", "/live", "/search", "/encode"]
        if settings.monitoring.prometheus_enabled:
            endpoints.append(settings.monitoring.prometheus_path)
        return Response(
            {
                "service": "sskd semantic search (PyTorch/CUDA port)",
                "version": __version__,
                "environment": settings.service.environment,
                "endpoints": endpoints,
            }
        )

    @app.get("/health")
    async def health(request: Request) -> Response:
        return Response(
            {
                "status": "healthy" if state.ready else "starting",
                "model_loaded": state.student is not None,
                "index_loaded": state.index_loaded,
                "index_size": state.index_builder.ntotal if state.index_loaded else 0,
                "version": __version__,
            }
        )

    @app.get("/ready")
    async def ready(request: Request) -> Response:
        if not state.ready:
            return Response({"ready": False}, status=503)
        return Response({"ready": True})

    @app.get("/live")
    async def live(request: Request) -> Response:
        return Response({"alive": True})

    if settings.monitoring.prometheus_enabled:

        @app.route("GET", settings.monitoring.prometheus_path)
        async def metrics_route(request: Request) -> Response:
            return Response(
                state.metrics.render(), media_type="text/plain; version=0.0.4; charset=utf-8"
            )

    @app.post("/search")
    async def search(request: Request) -> Response:
        t_start = time.perf_counter()
        body = SearchRequest.parse(request.json())
        if body.k > settings.search.max_k:
            return Response(
                {
                    "error": "VALIDATION_ERROR",
                    "detail": f"k={body.k} exceeds search.max_k={settings.search.max_k}",
                },
                status=422,
            )
        if not state.ready or state.student is None:
            return Response({"error": "service not ready"}, status=503)
        if not state.index_loaded:
            return Response({"error": "index not loaded"}, status=503)

        fetch_k = body.rerank_top_k if body.rerank else body.k
        k = min(fetch_k, state.index_builder.ntotal)
        if state.search_batcher is not None:
            score_vec, idx_vec = await state.search_batcher.submit((body.query, k))
        else:
            t0 = time.perf_counter()
            scores, indices = state.fused_searcher.search_texts([body.query], k=k)
            state.metrics.search_latency.observe(time.perf_counter() - t0)
            score_vec, idx_vec = scores[0], indices[0]

        b = state.index_builder
        rows = [(int(i), float(s)) for s, i in zip(score_vec, idx_vec) if i >= 0]
        texts = b.get_texts([i for i, _ in rows])
        results = [
            SearchResult(doc_id=b.doc_ids[i], text=t, score=s, rank=r + 1)
            for r, ((i, s), t) in enumerate(zip(rows, texts))
        ]
        reranked = False
        if body.rerank:
            state.metrics.rerank_triggers.inc()
            if state.teacher is not None:
                t0 = time.perf_counter()
                pairs = [(body.query, r.text or r.doc_id) for r in results]
                t_scores = None
                try:
                    t_scores = await asyncio.wait_for(
                        asyncio.to_thread(state.teacher.score, pairs,
                                          settings.teacher.batch_size),
                        timeout=settings.search.rerank_timeout_ms / 1000.0,
                    )
                except asyncio.TimeoutError:
                    logger.warning(f"rerank timed out after {settings.search.rerank_timeout_ms} "
                                   "ms: serving the bi-encoder order")
                state.metrics.rerank_latency.observe(time.perf_counter() - t0)
                if t_scores is not None:
                    order = sorted(range(len(results)), key=lambda i: -t_scores[i])
                    results = [
                        SearchResult(doc_id=results[i].doc_id, text=results[i].text,
                                     score=float(t_scores[i]), rank=r + 1)
                        for r, i in enumerate(order)
                    ]
                    reranked = True
        results = [r.to_dict() for r in results[: body.k]]
        latency_ms = (time.perf_counter() - t_start) * 1000.0
        logger.info(
            f"search qhash={hash_query(body.query)} k={body.k} rerank={reranked} "
            f"latency_ms={latency_ms:.1f}"
        )
        return Response(
            {
                "query": body.query,
                "results": results,
                "total_results": len(results),
                "reranked": reranked,
                "hybrid": False,
                "latency_ms": latency_ms,
            }
        )

    @app.post("/encode")
    async def encode(request: Request) -> Response:
        t_start = time.perf_counter()
        body = EncodeRequest.parse(request.json())
        if not state.ready or state.student is None:
            return Response({"error": "service not ready"}, status=503)
        t0 = time.perf_counter()
        emb = np.asarray(state.student.encode(body.texts, normalize=body.normalize))
        state.metrics.encode_latency.observe(time.perf_counter() - t0)
        return Response(
            {
                "embeddings": emb.tolist(),
                "dimension": int(emb.shape[1]),
                "num_texts": int(emb.shape[0]),
                "latency_ms": (time.perf_counter() - t_start) * 1000.0,
            }
        )

    return app
