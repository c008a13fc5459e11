"""Bundled synthetic dataset generator — the offline stand-in for MS MARCO
(port of sskd_tpu/data/demo.py: the same numpy draws from the same seed, so
the files come out byte for byte the same).

The reference's demo pipeline pulled 200 MS MARCO samples from the HF hub
(reference: scripts/run_demo_pipeline.sh:10-14, src/data/fetch.py:31).
Without network access the demo/e2e path generates a deterministic
synthetic corpus with the same JSONL shape as the fetcher's MS MARCO output
(nested ``passages{passage_text[], is_selected[]}``, reference:
src/data/prepare.py MS MARCO v2.1 format), letting every downstream stage —
chunking, BM25, mining, KD training, index build, serving — run unchanged.

Task design (round 3 — the earlier 16-topic task saturated every trained
arm at recall 1.0, leaving the "KD >= 95% of teacher" acceptance gate
unable to discriminate):

- A hidden CONCEPT PAIRING maps each query-side word to an unrelated
  doc-side word (e.g. queries say "river", relevant docs say "cargo").
  Nothing lexical connects a query to its positive — the mapping must be
  LEARNED from the training split, which is exactly the kind of knowledge
  a cross-encoder teacher acquires better than a small bi-encoder, and
  that distillation can transfer.
- Each query names ``concepts_per_query`` concepts; its positive carries
  all their doc-side words (relevance_grade 2). HARD DISTRACTORS share
  all but one concept (grade 1) — a model with an imperfect mapping ranks
  some of them above the positive, pulling nDCG smoothly off the ceiling.
- Every doc ends with a "see also" tail of query-side words from OTHER
  concepts — the lexical-overlap trap real search data has: BM25 and
  untrained encoders chase the tail words; only the learned mapping finds
  the positive. The tail also gives stage-1 BM25 mining a candidate pool.
- ``is_selected`` stays BINARY (format parity with MS MARCO — training
  positives are is_selected == 1, reference: train_kd_pipeline.py:193-238);
  the GRADED labels ride in a parallel ``relevance_grade`` list consumed
  by the eval path (grade defaults to is_selected when absent, so real
  MS MARCO rows are unaffected).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

# Query-side vocabulary (what users type) and doc-side vocabulary (what
# relevant passages say). The pairing between them is generated per-seed —
# it is the knowledge the models must learn. Words are common, short, and
# unrelated across the two lists.
_QUERY_WORDS = [
    "river", "engine", "garden", "winter", "market", "bridge", "signal",
    "harvest", "mirror", "copper", "thunder", "velvet", "anchor", "lantern",
    "meadow", "timber", "falcon", "marble", "orchard", "compass", "saddle",
    "prairie", "whistle", "granite", "harbor", "beacon", "cinder", "willow",
    "summit", "canyon", "ribbon", "hammer", "clover", "frost", "ember",
    "stream", "ledger", "barrel", "tunnel", "meteor", "pepper", "walnut",
    "spiral", "turbine", "glacier", "pulley", "satchel", "quarry", "piston",
    "trellis", "gutter", "paddle", "magnet", "fossil", "tundra", "cobalt",
    "drizzle", "hearth", "jigsaw", "kernel",
]
_DOC_WORDS = [
    "cargo", "pillow", "sonnet", "radish", "helmet", "mosaic", "pretzel",
    "goblet", "tripod", "sequin", "parsley", "bugle", "magenta", "otter",
    "plywood", "syrup", "dynamo", "crumpet", "gazebo", "hinge", "iceberg",
    "jersey", "kettle", "lagoon", "muffin", "nickel", "oboe", "pigment",
    "quilt", "ratchet", "sandal", "tassel", "ukulele", "vellum", "wombat",
    "yeast", "zipper", "almond", "bobbin", "chisel", "dumpling", "easel",
    "flannel", "griddle", "hamper", "ingot", "jackal", "khaki", "lattice",
    "mallet", "nougat", "ostrich", "pulley2", "raffia", "sprocket", "toffee",
    "umber", "violet", "wharf", "yonder",
]

_QUERY_TEMPLATES = [
    "what is {t}",
    "how does {t} work",
    "explain {t}",
    "facts about {t}",
    "history of {t}",
]

_DOC_TEMPLATES = [
    "{t} guide: this passage covers {t} in detail",
    "{t} overview: an introduction to {t}",
    "notes on {t}: key points about {t}",
    "{t} reference: everything known about {t}",
]

_FILLER = [
    "many researchers study this subject in depth",
    "there are several important aspects to consider",
    "recent developments changed the field significantly",
    "experts continue to debate the finer points",
    "practical applications appear in everyday life",
]


def _doc_text(
    rng, concept_ids, pairing, n_concepts, see_also=2, echo=()
) -> str:
    """A doc-side passage for the given concepts: doc-side words in a
    template, filler, an optional ECHO of query-side words (the partial
    lexical anchor — positives and their hard distractors echo the same
    word, so the echo cannot separate them), and a lexical-trap tail of
    QUERY-side words from other concepts."""
    words = " ".join(pairing[c] for c in concept_ids)
    template = _DOC_TEMPLATES[int(rng.integers(len(_DOC_TEMPLATES)))]
    filler = _FILLER[int(rng.integers(len(_FILLER)))]
    echo_part = (
        f" answers searches about {' '.join(_QUERY_WORDS[c] for c in echo)}."
        if len(echo)
        else ""
    )
    if see_also > 0:
        tail_pool = [c for c in range(n_concepts) if c not in concept_ids]
        tail_ids = rng.choice(tail_pool, size=see_also, replace=False)
        tail = " ".join(_QUERY_WORDS[c] for c in tail_ids)
        tail_part = f" see also {tail}."
    else:
        tail_part = ""
    return f"{template.format(t=words)}.{echo_part} {filler}.{tail_part}"


def generate_demo_dataset(
    output_dir: str | Path,
    num_samples: int = 200,
    passages_per_query: int = 10,
    seed: int = 42,
    splits: tuple[str, ...] = ("train", "validation"),
    split_fractions: tuple[float, ...] = (0.8, 0.2),
    n_concepts: int = 16,
    concepts_per_query: int = 2,
    n_hard: int = 3,
    see_also: int = 0,
) -> dict:
    """Write ``{split}.jsonl`` files + ``_manifest.json`` in the fetcher's
    MS MARCO layout and return the manifest dict
    (reference manifest shape: src/data/fetch.py:14-66).

    Per query: 1 positive (grade 2), ``n_hard`` hard distractors sharing
    all-but-one concept (grade 1), rest random docs with <= 1 shared
    concept (grade 0). Default 200 x 10 passages = 2,000 unique docs.

    ``see_also=0`` is the calibrated demo default (matches the CLI):
    lexical tails put query vocabulary into irrelevant docs, which a
    shared-embedding bi-encoder cannot fully gate — pass ``see_also=2``
    explicitly for the trap-tail variant used by robustness tests.
    """
    rng = np.random.default_rng(seed)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)

    n_concepts = min(n_concepts, len(_QUERY_WORDS), len(_DOC_WORDS))
    # the hidden query-word -> doc-word mapping (seed-deterministic)
    doc_perm = rng.permutation(n_concepts)
    pairing = {c: _DOC_WORDS[doc_perm[c]] for c in range(n_concepts)}
    # mild Zipf-ish exposure skew: rare concepts stay under-trained, which
    # keeps even a well-trained teacher naturally below nDCG 1.0 (the
    # de-saturation the acceptance gate needs to discriminate)
    concept_p = 1.0 / (np.arange(n_concepts) + 3.0) ** 0.8
    concept_p /= concept_p.sum()

    rows = []
    for i in range(num_samples):
        concepts = rng.choice(
            n_concepts, size=concepts_per_query, replace=False, p=concept_p
        )
        concepts = [int(c) for c in concepts]
        topic = " ".join(_QUERY_WORDS[c] for c in concepts)
        template = _QUERY_TEMPLATES[i % len(_QUERY_TEMPLATES)]
        query = template.format(t=topic)

        passage_texts, is_selected, grades = [], [], []
        passage_concepts: list[tuple[list[int], list[int]]] = []
        # the shared echo word: positive AND hard distractors carry the same
        # query-side word, so lexical overlap retrieves the candidate set
        # but only the learned mapping ranks the positive first
        echo = (int(rng.integers(concepts_per_query)),)
        echo_ids = [concepts[e] for e in echo]
        # positive: full concept match
        passage_texts.append(
            _doc_text(rng, concepts, pairing, n_concepts, see_also=see_also, echo=echo_ids)
        )
        is_selected.append(1)
        grades.append(2)
        passage_concepts.append((list(concepts), echo_ids))
        # hard distractors (same echo as the positive, so the echo cannot
        # separate them): with >= 2 concepts/query swap ONE concept for a
        # fresh one (partial semantic match); with 1 concept/query the
        # distractor is a pure lexical trap — it mentions the query word
        # but carries a DIFFERENT concept's doc-side word. Both are
        # "topically related, not the answer": grade 1.
        for h in range(n_hard):
            pool = [c for c in range(n_concepts) if c not in concepts]
            near = list(concepts)
            near[int(rng.integers(concepts_per_query))] = int(rng.choice(pool))
            passage_texts.append(
                _doc_text(rng, near, pairing, n_concepts, see_also=see_also, echo=echo_ids)
            )
            is_selected.append(0)
            grades.append(1)
            passage_concepts.append((near, echo_ids))
        # random docs: no shared concept with the query (cross-query qrels
        # grade real partial overlaps; randoms must be clean irrelevants)
        while len(passage_texts) < passages_per_query:
            cand = [
                int(c)
                for c in rng.choice(
                    n_concepts, size=concepts_per_query, replace=False
                )
            ]
            if set(cand) & set(concepts):
                continue
            passage_texts.append(
                _doc_text(rng, cand, pairing, n_concepts, see_also=see_also)
            )
            is_selected.append(0)
            grades.append(0)
            passage_concepts.append((cand, []))

        rows.append(
            {
                "query_id": i,
                "query": query,
                "passages": {
                    "passage_text": passage_texts,
                    "is_selected": is_selected,
                    "relevance_grade": grades,
                    "_concepts": passage_concepts,
                },
                "answers": [" ".join(pairing[c] for c in concepts)],
                "_query_concepts": list(concepts),
            }
        )

    manifest: dict = {"dataset": "demo", "splits": {}}
    start = 0
    for split, frac in zip(splits, split_fractions):
        count = int(round(num_samples * frac))
        split_rows = rows[start : start + count]
        start += count
        path = out / f"{split}.jsonl"
        with open(path, "w") as f:
            for row in split_rows:
                f.write(json.dumps(row) + "\n")
        # Cross-query qrels sidecar: a query's TRUE relevant docs include
        # other rows' passages (another query on the same concepts has a
        # perfect answer this row never lists). Row-local labels grade
        # those 0 — the classic unlabeled-duplicate trap: with it, even a
        # perfect ranker measures ~0.3 nDCG because interchangeable
        # positives outrank the row's own copy. Ground truth is exactly
        # computable for synthetic data, so emit TREC-style qrels keyed by
        # passage TEXT (ids are assigned later by corpus dedup); the eval
        # path prefers this sidecar (cli/pipeline.py load_eval_inputs).
        # Eval splits only: nothing evaluates on train, and text-keyed
        # qrels scale O(queries x matching docs x text len) — the train
        # sidecar alone measured 49 MB at 600 samples.
        if split == "train":
            manifest["splits"][split] = {
                "file": str(path),
                "num_samples": len(split_rows),
            }
            continue
        doc_concepts: dict[str, tuple] = {}
        for row in split_rows:
            for text, meta in zip(
                row["passages"]["passage_text"], row["passages"]["_concepts"]
            ):
                doc_concepts.setdefault(text, tuple(meta))
        qrels_rows = []
        for row in split_rows:
            q_concepts = set(row["_query_concepts"])
            rels = {}
            for text, (c_ids, echo_c) in doc_concepts.items():
                overlap = len(q_concepts & set(c_ids))
                if overlap == len(q_concepts):
                    rels[text] = 2.0
                elif overlap == len(q_concepts) - 1 and (
                    len(q_concepts) > 1 or set(echo_c) & q_concepts
                ):
                    rels[text] = 1.0
            qrels_rows.append({"query_id": row["query_id"], "rels": rels})
        with open(out / f"{split}.qrels.jsonl", "w") as f:
            for qr in qrels_rows:
                f.write(json.dumps(qr) + "\n")
        manifest["splits"][split] = {
            "file": str(path),
            "num_samples": len(split_rows),
            "qrels_file": str(out / f"{split}.qrels.jsonl"),
        }
    # strip generator-internal metadata before anything else reads the rows
    for row in rows:
        row.pop("_query_concepts", None)
        row["passages"].pop("_concepts", None)
    # rewrite split files without the metadata
    start = 0
    for split, frac in zip(splits, split_fractions):
        count = int(round(num_samples * frac))
        split_rows = rows[start : start + count]
        start += count
        with open(out / f"{split}.jsonl", "w") as f:
            for row in split_rows:
                f.write(json.dumps(row) + "\n")
    with open(out / "_manifest.json", "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest
