"""End-to-end KD training pipeline (port of sskd_tpu/cli/pipeline.py;
reference: scripts/train_kd_pipeline.py, 7 steps):

  [1] generate the offline demo set, or fetch MS MARCO from the hub
      (``data/fetch.py``: ``DataError`` without ``datasets`` or a network)
  [2] prepare: chunk to parquet (512 tokens / stride 80), through the port's
      own parquet writer
  [3] build (or reuse) the BM25 index over the passage corpus
  [4] load teacher + student
  [5] build queries/positives/corpus from raw JSONL (is_selected == 1)
  [6] mine the negative curriculum (stage 1..3), cached to
      ``mined_stage{stage}.json`` with a staleness guard
  [7] KD training (AdamW + the combined KD loss), with the stage-3
      in-training ANCE refresh and an optional held-out dev evaluator

``build_training_inputs`` and ``load_eval_inputs`` give the evaluation's
inputs too. The models run on ``device`` (default ``"cuda"``: raises
without CUDA); the tests pass ``device="cpu"``.

Data-parallel (``mesh``, one process a data-axis entry in a
``torch.distributed`` group): rank 0 alone generates, prepares, builds
BM25, loads the teacher, mines and writes; the other ranks wait at a
barrier, then read the raw split and the mined negatives it wrote, and
every rank trains (:class:`~sskd_tpu_torch.kd.train.KDTrainer` over the
mesh).
"""

from __future__ import annotations

import json
from pathlib import Path

from sskd_tpu_torch.config import Settings
from sskd_tpu_torch.data.prepare import _iter_passages_graded
from sskd_tpu_torch.exceptions import DataError
from sskd_tpu_torch.parallel import distributed
from sskd_tpu_torch.utils.logging import get_logger

logger = get_logger("pipeline")


def build_training_inputs(raw_jsonl: Path, max_samples: int | None = None):
    """Step 5: queries, positive texts/ids, and the corpus from raw JSONL
    (reference: train_kd_pipeline.py:191-238 — positives are passages with
    is_selected == 1; corpus ids follow {qid}_passage_{i}).

    The corpus is deduplicated by exact text: MS-MARCO-style rows repeat
    passages across queries, and keeping every copy under its own id makes
    retrieval metrics penalize arbitrary tie-breaks between identical docs
    (a query's own copy ranks below an unlabeled twin). Every duplicate maps
    onto the first-seen canonical id.

    Returns (queries, positives, positive_ids, corpus, graded_rels) —
    graded_rels[i] maps doc_id -> relevance grade > 0 for query i (grade
    defaults to is_selected when the data carries no ``relevance_grade``
    list, so it is binary for real MS MARCO and graded for the demo set)."""
    queries: list[str] = []
    positives: list[list[str]] = []
    positive_ids: list[list[str]] = []
    graded_rels: list[dict[str, float]] = []
    corpus: dict[str, str] = {}
    text_to_id: dict[str, str] = {}
    with open(raw_jsonl) as f:
        for line in f:
            if max_samples and len(queries) >= max_samples:
                break
            row = json.loads(line)
            qid = str(row.get("query_id"))
            qtext = row.get("query", "")
            pos_texts, pos_ids = [], []
            rels: dict[str, float] = {}
            for pi, (text, selected, grade) in enumerate(
                _iter_passages_graded(row)
            ):
                doc_id = text_to_id.get(text)
                if doc_id is None:
                    doc_id = f"{qid}_passage_{pi}"
                    text_to_id[text] = doc_id
                    corpus[doc_id] = text
                if selected == 1:
                    pos_texts.append(text)
                    pos_ids.append(doc_id)
                if grade > 0:
                    rels[doc_id] = max(rels.get(doc_id, 0.0), grade)
            if pos_texts:
                queries.append(qtext)
                positives.append(pos_texts)
                positive_ids.append(pos_ids)
                graded_rels.append(rels)
    return queries, positives, positive_ids, corpus, graded_rels


def load_eval_inputs(raw_jsonl: str | Path, max_samples: int | None = None):
    """(queries, corpus, qrels) for retrieval eval. Prefers a TREC-style
    ``<split>.qrels.jsonl`` sidecar (cross-query ground truth, keyed by
    passage text — the demo generator emits one; see
    sskd_tpu/data/demo.py in the JAX package) and falls back to row-local graded labels.
    Row-local labels understate quality whenever another query's positive
    is interchangeable with this one (the unlabeled-duplicate trap)."""
    raw_jsonl = Path(raw_jsonl)
    queries, positives, positive_ids, corpus, graded = build_training_inputs(
        raw_jsonl, max_samples
    )
    q_map = {f"q{i}": q for i, q in enumerate(queries)}
    qrels = {f"q{i}": rels for i, rels in enumerate(graded)}

    # with_suffix replaces only the final extension, so this resolves for
    # any input suffix (demo.jsonl -> demo.qrels.jsonl, demo -> demo.qrels.jsonl)
    # instead of silently mangling non-.jsonl names.
    sidecar = raw_jsonl.with_suffix(".qrels.jsonl")
    if sidecar.exists():
        by_qid: dict = {}
        with open(sidecar) as f:
            for line in f:
                row = json.loads(line)
                by_qid[row["query_id"]] = row["rels"]
        # rows are consumed in file order, skipping positive-less ones —
        # recover each kept row's query_id to pair with the sidecar
        kept_qids = []
        with open(raw_jsonl) as f:
            for line in f:
                if max_samples and len(kept_qids) >= max_samples:
                    break
                row = json.loads(line)
                if any(s == 1 for _, s, _ in _iter_passages_graded(row)):
                    kept_qids.append(row.get("query_id"))
        text_to_id = {t: d for d, t in corpus.items()}
        for i, qid in enumerate(kept_qids):
            rels_by_text = by_qid.get(qid)
            if rels_by_text is not None:
                qrels[f"q{i}"] = {
                    text_to_id[t]: float(g)
                    for t, g in rels_by_text.items()
                    if t in text_to_id
                }
    return q_map, corpus, qrels


def mined_to_samples(queries, positives, mined, corpus):
    """Assemble KDSamples: positive first (contrastive column 0), mined
    negatives after with teacher scores as soft labels."""
    from sskd_tpu_torch.kd.dataset import KDSample

    samples = []
    for query, pos_texts, negs in zip(queries, positives, mined):
        docs = [pos_texts[0]] + [corpus[c] for c in negs.doc_ids]
        scores = [1.0] + list(negs.scores)
        samples.append(KDSample(query=query, docs=docs, teacher_scores=scores))
    return samples


def _load_mined_cache(cache_path: Path, queries, corpus):
    """The cached mining results, or None when the file is missing or stale:
    the cache is keyed by path only, so a regenerated dataset can leave
    negatives pointing at doc ids that no longer exist; every referenced id
    is checked against the live corpus and the query count."""
    from sskd_tpu_torch.mining.miners import MinedNegatives

    if not cache_path.exists():
        return None
    with open(cache_path) as f:
        raw = json.load(f)
    cached = [MinedNegatives(doc_ids=m["doc_ids"], scores=m["scores"]) for m in raw]
    if len(cached) == len(queries) and all(d in corpus for m in cached for d in m.doc_ids):
        logger.info(f"[6/7] using cached mining results {cache_path}")
        return cached
    logger.warning(
        f"[6/7] cached mining results {cache_path} are stale for the current dataset "
        "(unknown doc ids or query-count mismatch) — re-mining"
    )
    return None


def _prepare_data(settings, data_dir: Path, dataset: str, raw_train: Path, train_parquet: Path,
                  use_demo_data: bool, max_samples) -> None:
    """Steps 1 and 2: the raw split (generated for the demo set) and its
    chunked parquet, each made only when missing."""
    from sskd_tpu_torch.data.demo import generate_demo_dataset
    from sskd_tpu_torch.data.prepare import prepare_dataset
    from sskd_tpu_torch.data.registry import ensure_dirs, get_raw_dir

    ensure_dirs(data_dir, dataset)
    if not raw_train.exists():
        if use_demo_data:
            logger.info("[1/7] generating offline demo dataset")
            generate_demo_dataset(get_raw_dir(data_dir, dataset),
                                  num_samples=max_samples or 200)
        else:
            logger.info("[1/7] fetching dataset from hub")
            from sskd_tpu_torch.data.fetch import fetch_msmarco

            fetch_msmarco(data_dir, max_samples=max_samples)
    else:
        logger.info("[1/7] raw data present, skipping fetch")
    if not train_parquet.exists():
        logger.info("[2/7] preparing chunked parquet")
        prepare_dataset(
            data_dir,
            dataset=dataset,
            max_tokens=settings.data.chunk_max_tokens,
            stride=settings.data.chunk_stride,
            max_samples=max_samples,
        )
    else:
        logger.info("[2/7] prepared parquet present, skipping")


def _bm25(settings, bm25_dir: Path, corpus: dict):
    """Step 3: the persisted BM25 index over ``corpus``, rebuilt and saved
    when missing or stale."""
    from sskd_tpu_torch.mining.bm25 import BM25Index

    if BM25Index.exists(bm25_dir):
        logger.info("[3/7] loading persisted BM25 index")
        bm25 = BM25Index.load(bm25_dir)
        if set(bm25.doc_ids) == set(corpus):
            return bm25
        logger.warning("persisted BM25 id space is stale — rebuilding")
    logger.info("[3/7] building BM25 index over the passage corpus")
    ids = list(corpus.keys())
    bm25 = BM25Index(
        k1=settings.mining.bm25_k1, b=settings.mining.bm25_b,
        epsilon=settings.mining.bm25_epsilon,
    ).build([corpus[i] for i in ids], ids)
    bm25.save(bm25_dir)
    return bm25


def run_train_pipeline(
    settings: Settings,
    data_dir: str | Path = "data",
    output_dir: str | Path | None = None,
    dataset: str = "demo",
    max_samples: int | None = None,
    stage: int | None = None,
    epochs: int | None = None,
    use_demo_data: bool | None = None,
    student_config=None,
    teacher_config=None,
    tokenizer=None,
    mesh=None,
    save_init_to: str | Path | None = None,
    dev_data: str | Path | None = None,
    device="cuda",
) -> dict:
    """The seven steps over ``data_dir``; returns the trainer's result with
    ``num_queries`` and ``corpus_size``. ``student_config`` /
    ``teacher_config`` (the ``--tiny`` runs) build seeded models with a
    vocabulary fitted to the corpus; otherwise ``settings.student.model_name``
    and ``settings.teacher.model_name`` name checkpoints (the port's own or
    the JAX package's) or known architectures. ``mesh``: data-parallel
    training over the processes of a group (module docstring)."""
    from dataclasses import replace

    from sskd_tpu_torch.data.registry import get_chunks_path, get_raw_path
    from sskd_tpu_torch.kd.train import KDTrainer
    from sskd_tpu_torch.mining.miners import build_mining_curriculum, refresh_ance_negatives
    from sskd_tpu_torch.models.student import StudentModel
    from sskd_tpu_torch.models.teacher import TeacherModel
    from sskd_tpu_torch.utils.platform import resolve_device

    device = resolve_device(device)
    if mesh is not None:  # before any work: a mesh this run's processes do not make up
        distributed.data_axis_rank(mesh, device)
    lead = mesh is None or distributed.rank() == 0  # the rank that prepares and writes

    def sync():  # the other ranks wait here for what the lead wrote
        if mesh is not None:
            distributed.barrier()

    data_dir = Path(data_dir)
    output_dir = Path(output_dir or settings.training.output_dir)
    stage = stage or settings.mining.stage
    max_samples = max_samples if max_samples is not None else (
        settings.data.max_samples or None
    )
    if use_demo_data is None:
        use_demo_data = dataset == "demo"

    # [1/7] generate, [2/7] prepare ------------------------------------------
    raw_train = get_raw_path(data_dir, dataset, "train")
    train_parquet = get_chunks_path(data_dir, dataset, "train")
    if lead:
        _prepare_data(settings, data_dir, dataset, raw_train, train_parquet, use_demo_data,
                      max_samples)
    sync()

    # [5/7 first] training inputs: the corpus defines the mining id space
    logger.info("[5/7] building queries/positives/corpus from raw JSONL")
    queries, positives, positive_ids, corpus, _ = build_training_inputs(raw_train, max_samples)
    logger.info(f"    {len(queries)} queries, corpus {len(corpus)} passages")

    # [3/7] BM25 over the same passage-id space the miners look texts up in
    bm25 = _bm25(settings, data_dir / "bm25" / dataset, corpus) if lead else None

    # [4/7] models -----------------------------------------------------------
    logger.info("[4/7] loading models")
    if student_config is not None and tokenizer is None:
        # tiny/demo mode: a corpus-fitted vocabulary instead of the
        # near-character fallback tokenizer
        from sskd_tpu_torch.tokenization import WordPieceTokenizer

        tokenizer = WordPieceTokenizer.build_from_corpus(
            sorted(set(corpus.values()) | set(queries)), vocab_size=2048
        )
        student_config = replace(student_config, vocab_size=tokenizer.vocab_size)
        if teacher_config is not None:
            teacher_config = replace(teacher_config, vocab_size=tokenizer.vocab_size)
    student = StudentModel(
        settings.student.model_name,
        device=device,
        config=student_config,
        tokenizer=tokenizer,
        max_seq_length=settings.student.max_seq_length,
        query_prefix=settings.student.query_prefix,
        passage_prefix=settings.student.passage_prefix,
        normalize=settings.student.normalize_embeddings,
        pooling=settings.student.pooling,
    )
    if save_init_to and lead:
        # the untrained snapshot sharing this run's init and tokenizer: the
        # fair "vanilla" row of the KD comparison
        student.save(save_init_to)
    teacher = None
    if stage >= 2 and lead:
        teacher = TeacherModel(
            settings.teacher.model_name,
            device=device,
            config=teacher_config,
            tokenizer=tokenizer,
            max_seq_length=settings.teacher.max_seq_length,
        )

    # [6/7] mining (with the mined-negatives cache) -----------------------------
    cache_path = output_dir / f"mined_stage{stage}.json"
    mined = _load_mined_cache(cache_path, queries, corpus) if lead else None
    if mined is None and lead:
        logger.info(f"[6/7] mining curriculum stage {stage}")
        mined = build_mining_curriculum(
            stage,
            queries,
            positives,
            corpus,
            bm25,
            teacher=teacher,
            student=student,
            positive_ids_per_query=positive_ids,
            bm25_top_k=settings.mining.bm25_top_k,
            teacher_top_k=settings.mining.teacher_top_k,
            teacher_confidence_threshold=settings.mining.teacher_confidence_threshold,
            ance_top_k=settings.mining.ance_top_k,
            ance_margin=settings.mining.ance_margin,
            teacher_batch_size=settings.teacher.batch_size,
            denoise_threshold=settings.mining.denoise_text_overlap_threshold,
        )
        output_dir.mkdir(parents=True, exist_ok=True)
        with open(cache_path, "w") as f:
            json.dump([{"doc_ids": m.doc_ids, "scores": m.scores} for m in mined], f)
    sync()
    if not lead:  # the negatives rank 0 mined
        mined = _load_mined_cache(cache_path, queries, corpus)
        if mined is None:
            raise DataError(f"rank {distributed.rank()}: {cache_path}, which rank 0 wrote, "
                            "does not match this rank's corpus")

    samples = mined_to_samples(queries, positives, mined, corpus)
    n_empty = sum(1 for m in mined if not m.doc_ids)
    if n_empty > len(mined) // 2:
        logger.warning(
            f"{n_empty}/{len(mined)} queries mined ZERO negatives — with positive-only "
            "samples every KD loss term is 0 and nothing trains. Likely cause: teacher "
            f"confidence threshold ({settings.mining.teacher_confidence_threshold}) filters "
            "all candidates (untrained teacher?). Lower "
            "SEMANTIC_KD_MINING__TEACHER_CONFIDENCE_THRESHOLD or use stage 1."
        )
    n_dev = max(1, len(samples) // 10)
    dev_samples = samples[:n_dev]
    train_samples = samples[n_dev:] or samples

    # stage-3 in-training ANCE refresh: the teacher candidate pool is cached,
    # only the student-adversarial selection reruns with the live student
    negative_refresher = None
    if stage == 3:
        teacher_pool = mined  # the union already holds the rescored candidates

        def negative_refresher(current_student):
            fresh = refresh_ance_negatives(
                current_student, queries, positives, teacher_pool, corpus,
                ance_top_k=settings.mining.ance_top_k, ance_margin=settings.mining.ance_margin,
            )
            fresh_samples = mined_to_samples(queries, positives, fresh, corpus)
            return fresh_samples[n_dev:] or fresh_samples

    # held-out dev evaluator: full-corpus retrieval nDCG@10 over a separate
    # raw split drives early stopping and best-model selection when given
    dev_evaluator = None
    if dev_data is not None:
        from sskd_tpu_torch.kd.eval import KDEvaluator

        dev_q, dcorpus, dev_qrels = load_eval_inputs(Path(dev_data))
        dev_ev = KDEvaluator(k_values=(10,), device=device)

        def dev_evaluator(current_student):
            return dev_ev.evaluate_retrieval(current_student, dev_q, dcorpus, dev_qrels)[
                "ndcg@10"]

    # [7/7] train ------------------------------------------------------------
    logger.info(f"[7/7] KD training: {len(train_samples)} train / {n_dev} dev")
    trainer = KDTrainer(student, settings, mesh=mesh)
    result = trainer.train(
        train_samples,
        dev_samples=dev_samples,
        epochs=epochs,
        output_dir=output_dir,
        negative_refresher=negative_refresher,
        dev_evaluator=dev_evaluator,
    )
    result["num_queries"] = len(queries)
    result["corpus_size"] = len(corpus)
    return result
