"""Serving application (port of sskd_tpu/serve/app.py).

Routes: ``/``, ``/health``, ``/ready``, ``/live``, ``POST /search``,
``POST /encode``, ``POST /index/load``, ``/openapi.json``, ``/docs``, the
metrics path and, with the cache on, ``POST /cache/flush``, on the
first-party HTTP stack. Middlewares run in the JAX package's order: API-key
auth (``auth``), rate limit (``rate_limit``), request logging, security
headers, CORS. Startup loads the student (span ``load_model``), with
``search.rerank_enabled`` the cross-encoder teacher (``teacher.model_name``,
:class:`~sskd_tpu_torch.models.teacher.TeacherModel`), with
``search.hybrid.enabled`` the BM25 arm (:mod:`sskd_tpu_torch.serve.hybrid`),
preloads the index when ``preload_index_dir`` is given, builds the
:class:`~sskd_tpu_torch.serve.fused.FusedSearcher`, warms it up and starts
the micro-batcher. Differences from the JAX package:

- every step of startup is fatal when it fails, warmup included (the JAX
  package logs a failed warmup and serves on), but for the cases that the
  JAX package tolerates too: a teacher checkpoint directory that cannot be
  read (``OSError``, ``ValueError``, ``ModelLoadError``,
  ``WeightConversionError``, ``ConfigError``) leaves reranking off, and
  ``rerank=true`` is then answered in the bi-encoder's order with
  ``reranked: false``; a BM25 directory that cannot be read (``OSError``,
  ``ValueError``, ``DataError``) leaves hybrid search off. A CUDA or kernel
  error is not such a case: it fails the startup or the request;
- a nonzero ``monitoring.jax_profiler_port`` raises :class:`ConfigError`:
  the JAX profiler server has no torch counterpart.

With ``mesh.index_parallel > 1`` a loaded index (preloaded or through
``/index/load``) is lifted onto a mesh of that many devices of the
student's type (:meth:`AppState.maybe_shard_index`, the JAX app's): every
CUDA device, or the CPU entries that ``--cpu-devices`` asked for
(:func:`~sskd_tpu_torch.parallel.mesh.local_devices`); too few raise. It is
then served by :class:`~sskd_tpu_torch.serve.fused.ShardedFusedSearcher`;
texts and doc ids stay on the builder, and host refine storage is ignored
with the JAX app's warning (each shard keeps its refine rows).

``/search`` with ``rerank=true`` fetches the request's ``rerank_top_k``
results (default 50, as in the JAX app; ``search.rerank_top_k`` is kept for
the settings' parity), scores (query, text or doc id) pairs with the teacher
in a worker thread at ``teacher.batch_size`` (span ``rerank``), and answers
them in the order of the teacher's logits, which become the scores, with
``reranked: true``. Past ``search.rerank_timeout_ms`` the bi-encoder's order
is served (the scoring runs on in its thread). With
``search.maxsim_aggregation`` the engine fetches four times the results and
collapses them to documents by their best chunk
(:func:`~sskd_tpu_torch.utils.chunk.maxsim_aggregate_topk`); with the hybrid
arm on, the dense results are fused with BM25's. With ``cache.enabled`` a
repeated ``/search`` is answered from the result cache (``cached: true``; a
degraded rerank is never cached), ``/encode`` encodes only the texts it has
not seen, ``/index/load`` clears the result cache and ``/cache/flush`` both.

As in the JAX package, a preloaded index is served under the ``index_type``
it records (``exact``, ``approx`` or ``clustered``), of f32, bf16, int8 or
int4 rows, and one with bf16 refine rows through the refined engine
(:class:`~sskd_tpu_torch.serve.fused.FusedSearcher`): ``index.search_method``
is read only where an index is built. An ``index.nprobe`` that the settings
were given explicitly overrides the value saved in a clustered index's
``meta.json``; the default does not. ``index.refine_storage`` (a deployment
choice, not saved with the index) places the refine rows of the loaded index
on the device or the host.
"""

from __future__ import annotations

import asyncio
import json
import time
from pathlib import Path

import numpy as np
import torch

from sskd_tpu_torch.config import Settings, get_settings
from sskd_tpu_torch.exceptions import (
    AuthError,
    ConfigError,
    DataError,
    IndexNotLoadedError,
    ModelLoadError,
    RateLimitExceededError,
    SemanticKDError,
    ServiceNotReadyError,
    ValidationError_,
    WeightConversionError,
)
from sskd_tpu_torch.index.builder import IndexBuilder
from sskd_tpu_torch.models.student import StudentModel
from sskd_tpu_torch.models.teacher import TeacherModel
from sskd_tpu_torch.serve.batcher import MicroBatcher
from sskd_tpu_torch.serve.cache import embedding_cache_key, make_caches, result_cache_key
from sskd_tpu_torch.serve.fused import FusedSearcher, ShardedFusedSearcher
from sskd_tpu_torch.serve.http import App, Request, Response
from sskd_tpu_torch.serve.metrics import Metrics
from sskd_tpu_torch.serve.middleware import (
    APIKeyAuth,
    RateLimiter,
    cors_middleware,
    hash_query,
    request_logging_middleware,
    security_headers_middleware,
)
from sskd_tpu_torch.serve.openapi import build_openapi, render_docs_html
from sskd_tpu_torch.serve.schemas import (
    EncodeRequest,
    IndexLoadRequest,
    SearchRequest,
    SearchResult,
)
from sskd_tpu_torch.utils.chunk import maxsim_aggregate_topk
from sskd_tpu_torch.utils.logging import get_logger
from sskd_tpu_torch.utils.tracing import (
    SPAN_INDEX_SEARCH,
    SPAN_LOAD_INDEX,
    SPAN_LOAD_MODEL,
    SPAN_RERANK,
    TRACER,
    span,
)
from sskd_tpu_torch.version import __version__

logger = get_logger("serve.app")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# what a teacher checkpoint that cannot be read raises: reranking stays off
_UNREADABLE_CHECKPOINT = (OSError, ValueError, ModelLoadError, WeightConversionError, ConfigError)
# what a BM25 directory that cannot be read raises: hybrid search stays off
_UNREADABLE_BM25 = (OSError, ValueError, DataError)


class AppState:
    def __init__(self, settings: Settings):
        self.settings = settings
        self.metrics = Metrics()
        self.student: StudentModel | None = None
        self.teacher: TeacherModel | None = None
        self.index_builder: IndexBuilder | None = None
        self.sharded_index = None  # ShardedIndex when mesh.index_parallel > 1
        self.fused_searcher: FusedSearcher | None = None
        self.search_batcher: MicroBatcher | None = None
        self.hybrid = None  # HybridSearcher when search.hybrid.enabled
        self.query_cache = None  # TTLCache of /search payloads when cache.enabled
        self.embedding_cache = None  # TTLCache of /encode rows when also cache.embedding_cache
        self.rate_limiter: RateLimiter | None = None
        self.auth: APIKeyAuth | None = None
        self.ready = False

    @property
    def index_loaded(self) -> bool:
        return self.index_builder is not None and self.index_builder.is_built

    def use_index(self, builder: IndexBuilder) -> None:
        """Serve ``builder``: the settings' query-time knobs applied, the
        fused searcher rebuilt over it."""
        # nprobe is a query-time knob (the cell layout does not depend on
        # it): an explicit setting wins over the index's saved value
        if self.settings.is_set("index", "nprobe"):
            builder.nprobe = self.settings.index.nprobe
        # where the bf16 refine rows live is a deployment choice (the rows
        # are the same bytes either way)
        builder.refine_storage = self.settings.index.refine_storage
        self.maybe_shard_index(builder)
        if self.sharded_index is not None:
            self.fused_searcher = ShardedFusedSearcher(self.student, self.sharded_index)
        else:
            self.fused_searcher = FusedSearcher(self.student, builder)
        self.index_builder = builder
        self.metrics.index_size.set(builder.ntotal)

    def maybe_shard_index(self, builder: IndexBuilder) -> None:
        """Lift ``builder`` onto a mesh when ``mesh.index_parallel > 1``
        (the JAX app's), over the devices of the student's type; texts and
        doc ids stay on the builder."""
        m = self.settings.mesh
        if m.index_parallel <= 1:
            self.sharded_index = None
            return
        from sskd_tpu_torch.index.sharded import ShardedIndex
        from sskd_tpu_torch.parallel.mesh import create_mesh, local_devices

        mesh = create_mesh(data_parallel=1, index_parallel=m.index_parallel,
                           data_axis=m.data_axis, index_axis=m.index_axis,
                           devices=local_devices(self.student.device))
        if builder.refine_storage == "host" and builder._refine is not None:
            # each shard rescores its own candidates against its refine rows
            logger.warning(
                "refine_storage='host' ignored under index_parallel>1: "
                "sharded serving keeps refine rows on-device per shard"
            )
        self.sharded_index = ShardedIndex.from_builder(builder, mesh, axis=m.index_axis)
        logger.info(f"index sharded over {m.index_parallel} devices ({builder.ntotal} rows)")

    def batched_search(self, items: list[tuple[str, int]]):
        """One encode + search for a micro-batch of (query, k) requests."""
        queries = [q for q, _ in items]
        max_k = max(k for _, k in items)
        t0 = time.perf_counter()
        with span(SPAN_INDEX_SEARCH, k=max_k, batch=len(queries)):
            scores, indices = self.fused_searcher.search_texts(queries, k=max_k)
        self.metrics.search_latency.observe(time.perf_counter() - t0)
        return [(scores[i, :k], indices[i, :k]) for i, (_, k) in enumerate(items)]


def _status_for(exc: SemanticKDError) -> int:
    if isinstance(exc, (ServiceNotReadyError, IndexNotLoadedError)):
        return 503
    if isinstance(exc, RateLimitExceededError):
        return 429
    if isinstance(exc, AuthError):
        return 401
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
    if settings.monitoring.jax_profiler_port:
        raise ConfigError(
            f"monitoring.jax_profiler_port={settings.monitoring.jax_profiler_port}: the JAX "
            "profiler server has no counterpart in the port (torch serves no traces on a "
            "port); set it to 0"
        )
    app = App()
    state = AppState(settings)
    app.state = state
    state.query_cache, state.embedding_cache = make_caches(settings.cache)

    # middlewares, added inner to outer: they run APIKey, RateLimit,
    # RequestLogging, SecurityHeaders, CORS
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
    if settings.rate_limit.enabled:
        state.rate_limiter = RateLimiter(settings.rate_limit.requests_per_minute,
                                         settings.rate_limit.burst)
        app.add_middleware(state.rate_limiter.middleware(state.metrics))
    if settings.auth.enabled:
        state.auth = APIKeyAuth(
            api_key_hashes=settings.auth.api_key_hashes,
            salt=settings.auth.salt,
            header=settings.auth.api_key_header,
        )
        app.add_middleware(state.auth.middleware())

    def startup():
        if settings.monitoring.opentelemetry_enabled:
            TRACER.configure_otel(settings.monitoring.opentelemetry_endpoint,
                                  service_name=settings.monitoring.service_name)
        t0 = time.perf_counter()
        s = settings.student
        with span(SPAN_LOAD_MODEL, model=student_model_path or s.model_name):
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
            state.use_index(IndexBuilder(device=state.student.device).load(preload_index_dir))
        h = settings.search.hybrid
        if h.enabled:
            from sskd_tpu_torch.mining.bm25 import BM25Index
            from sskd_tpu_torch.serve.hybrid import HybridSearcher

            try:
                bm25 = BM25Index.load(h.bm25_index_path)
            except _UNREADABLE_BM25:
                logger.exception("BM25 index unreadable: hybrid search disabled")
            else:
                state.hybrid = HybridSearcher(
                    bm25, bm25_weight=h.bm25_weight, semantic_weight=h.semantic_weight,
                    fusion_method=h.fusion_method, rrf_k=h.rrf_k,
                    query_expansion=h.query_expansion, expansion_docs=h.expansion_docs,
                    expansion_terms=h.expansion_terms,
                )
                logger.info(f"hybrid search enabled: {h.fusion_method} fusion, "
                            f"bm25={h.bm25_weight}/semantic={h.semantic_weight}, "
                            f"{bm25.ntotal} lexical docs")
        if state.fused_searcher is not None:
            state.fused_searcher.warmup(
                max_batch=settings.service.micro_batch_max_size, k=settings.search.default_k
            )
        else:
            state.student.encode_queries(["warmup query"])
        if settings.service.micro_batch_max_size > 1:
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
        return Response(
            {
                "service": "sskd semantic search (PyTorch/CUDA port)",
                "version": __version__,
                "environment": settings.service.environment,
                "endpoints": ["/health", "/ready", "/live", "/search", "/encode",
                              "/index/load", "/metrics", "/docs", "/openapi.json"]
                + (["/cache/flush"] if settings.cache.enabled else []),
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

    openapi_spec = build_openapi(
        __version__,
        metrics_path=(settings.monitoring.prometheus_path
                      if settings.monitoring.prometheus_enabled else None),
        cache_flush=settings.cache.enabled,
        auth_enabled=settings.auth.enabled,
    )

    @app.get("/openapi.json")
    async def openapi_json(request: Request) -> Response:
        return Response(openapi_spec)

    @app.get("/docs")
    async def docs_page(request: Request) -> Response:
        return Response(render_docs_html(openapi_spec), media_type="text/html; charset=utf-8")

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

        cache_key = None
        if state.query_cache is not None:
            cache_key = result_cache_key(body.query, body.k, body.rerank, body.rerank_top_k)
            hit = state.query_cache.get(cache_key)
            if hit is not None:
                state.metrics.cache_hits.labels(cache="result").inc()
                payload = dict(hit)
                payload["cached"] = True
                payload["latency_ms"] = (time.perf_counter() - t_start) * 1000.0
                return Response(payload)
            state.metrics.cache_misses.labels(cache="result").inc()

        b = state.index_builder
        fetch_k = body.rerank_top_k if body.rerank else body.k
        use_maxsim = settings.search.maxsim_aggregation
        chunk_k = min(fetch_k * 4 if use_maxsim else fetch_k, b.ntotal)
        if state.search_batcher is not None:
            # concurrent requests coalesce into one encode + one search
            score_vec, idx_vec = await state.search_batcher.submit((body.query, chunk_k))
        else:
            t0 = time.perf_counter()
            with span(SPAN_INDEX_SEARCH, k=chunk_k):
                scores, indices = state.fused_searcher.search_texts([body.query], k=chunk_k)
            state.metrics.search_latency.observe(time.perf_counter() - t0)
            score_vec, idx_vec = scores[0], indices[0]

        idx_row = [int(i) for i in idx_vec if i >= 0]
        score_row = [float(s) for s, i in zip(score_vec, idx_vec) if i >= 0]
        doc_ids = [b.doc_ids[i] for i in idx_row]
        texts = b.get_texts(idx_row)

        if use_maxsim:
            # documents ranked by their best chunk
            text_by_doc = dict(zip(doc_ids, texts))
            agg_scores, doc_ids = maxsim_aggregate_topk(score_row, doc_ids, fetch_k)
            score_row = [float(s) for s in agg_scores]
            texts = [text_by_doc.get(d) for d in doc_ids]

        hybrid_used = False
        if state.hybrid is not None:
            # BM25-only candidates take their text from the index, else
            # from the BM25 index's tokens
            fused = state.hybrid.fuse(body.query, list(zip(doc_ids, score_row)), k=fetch_k)
            text_by_doc = dict(zip(doc_ids, texts))
            doc_ids, score_row, texts = [], [], []
            for d, sc in fused:
                doc_ids.append(d)
                score_row.append(float(sc))
                if d in text_by_doc:
                    texts.append(text_by_doc[d])
                    continue
                pos = b.position_of(d)
                if pos is not None:
                    texts.append(b.get_texts([pos])[0])
                else:
                    try:
                        texts.append(state.hybrid.bm25.get_doc_text(d))
                    except (KeyError, DataError):
                        texts.append(None)
            hybrid_used = True

        results = [
            SearchResult(doc_id=d, text=t, score=sc, rank=r + 1)
            for r, (d, t, sc) in enumerate(zip(doc_ids, texts, score_row))
        ]
        reranked = False
        if body.rerank:
            state.metrics.rerank_triggers.inc()
            if state.teacher is not None:
                t0 = time.perf_counter()
                pairs = [(body.query, r.text or r.doc_id) for r in results]
                t_scores = None
                try:
                    with span(SPAN_RERANK, n_pairs=len(pairs)):
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
            f"hybrid={hybrid_used} latency_ms={latency_ms:.1f}"
        )
        payload = {
            "query": body.query,
            "results": results,
            "total_results": len(results),
            "reranked": reranked,
            "hybrid": hybrid_used,
            "latency_ms": latency_ms,
        }
        if cache_key is not None:
            # a rerank that timed out fell back to the bi-encoder order: not
            # cached, so that the fallback does not outlive the incident
            if not (body.rerank and not reranked):
                state.query_cache.put(
                    cache_key, {k: v for k, v in payload.items() if k != "latency_ms"})
                state.metrics.cache_entries.labels(cache="result").set(len(state.query_cache))
            payload["cached"] = False
        return Response(payload)

    @app.post("/encode")
    async def encode(request: Request) -> Response:
        t_start = time.perf_counter()
        body = EncodeRequest.parse(request.json())
        if not state.ready or state.student is None:
            return Response({"error": "service not ready"}, status=503)
        t0 = time.perf_counter()
        cache = state.embedding_cache
        if cache is not None:
            # only the texts not cached reach the encoder, as one batch
            keys = [embedding_cache_key(t, body.normalize) for t in body.texts]
            rows = [cache.get(k) for k in keys]
            miss = [i for i, r in enumerate(rows) if r is None]
            state.metrics.cache_hits.labels(cache="embedding").inc(len(rows) - len(miss))
            state.metrics.cache_misses.labels(cache="embedding").inc(len(miss))
            if miss:
                fresh = state.student.encode([body.texts[i] for i in miss],
                                             normalize=body.normalize)
                for j, i in enumerate(miss):
                    rows[i] = np.array(fresh[j])  # a copy: a view would pin the batch
                    cache.put(keys[i], rows[i])
                state.metrics.cache_entries.labels(cache="embedding").set(len(cache))
            emb = np.stack(rows)
        else:
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

    @app.post("/index/load")
    async def index_load(request: Request) -> Response:
        body = IndexLoadRequest.parse(request.json())
        index_dir = Path(body.index_dir)
        if not index_dir.is_dir():
            return Response({"error": f"index dir not found: {index_dir}"}, status=400)
        if not state.ready or state.student is None:
            return Response({"error": "service not ready"}, status=503)
        with span(SPAN_LOAD_INDEX, dir=str(index_dir)):
            builder = IndexBuilder(device=state.student.device).load(index_dir)
        state.use_index(builder)
        if state.query_cache is not None:
            # results depend on the index; embeddings do not, and stay
            dropped = state.query_cache.clear()
            state.metrics.cache_entries.labels(cache="result").set(0)
            if dropped:
                logger.info(f"index swap flushed {dropped} cached results")
        return Response({"loaded": True, "index_size": builder.ntotal, "dir": str(index_dir)})

    if settings.cache.enabled:

        @app.post("/cache/flush")
        async def cache_flush(request: Request) -> Response:
            flushed = {"result": 0, "embedding": 0}
            for name, c in (("result", state.query_cache), ("embedding", state.embedding_cache)):
                if c is not None:
                    flushed[name] = c.clear()
                    state.metrics.cache_entries.labels(cache=name).set(0)
            return Response({"flushed": flushed})

    return app
