"""Host time of the student's batch tokenization, pure Python against the
native WordPiece core, in turns, in a process that serves nothing.

Batches: the serve phase's query batches of ``chip_smoke.py`` (6 seeded
words after "query: ", one query padded to the 16-row bucket, and 64
queries) and one 256-passage chunk of its 520-word corpus as
``encode_documents`` frames it. Each is timed through
``StudentModel.tokenize_batch`` (ids, then the framed arrays), and the
native batch call alone, in turns python, native, native, python; also
``os.sched_getaffinity`` and ``batch_threads``. Prints the card's name and
power limit when there is one, then one JSON object, also written to
``chiprun_out/probe_tokenizer.json``.

    python3 tools/probe_tokenizer.py [--reps 200]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sskd_tpu_torch.models.bert import BertConfig  # noqa: E402
from sskd_tpu_torch.models.student import StudentModel  # noqa: E402
from sskd_tpu_torch.tokenization import native  # noqa: E402

WORDS = (
    "the quick brown fox jumps over a lazy dog and runs to search for semantic meaning "
    "in documents queries passages models training data index vector embedding score "
    "teacher student distillation knowledge what is how why when where who which does can"
).split()


def per_call_ms(fn, reps: int) -> float:
    for _ in range(10):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "probe_tokenizer.json"))
    args = ap.parse_args(argv)
    card = None
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip() or None
    except OSError:
        pass
    print(card, flush=True)
    # the tokenizer and framing only: a tiny model on the CPU holds them
    student = StudentModel("e5", device="cpu", config=BertConfig.tiny(), seed=0)
    tok = student.tokenizer
    core = tok._native_core()
    rng = np.random.default_rng(0)
    queries = [student.query_prefix + " ".join(rng.choice(WORDS, 6)) for _ in range(64)]
    passages = [student.passage_prefix + " ".join(rng.choice(WORDS, 520)) for _ in range(256)]
    batches = {"B=1 (16 rows)": queries[:1] + [student.query_prefix] * 15,
               "B=64": queries, "256 passages": passages}
    out = {"card": card, "cpus": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
           "core_attached": core is not None,
           "sched_getaffinity_us": per_call_ms(lambda: os.sched_getaffinity(0), 2000) * 1e3}
    reps = {"B=1 (16 rows)": args.reps, "B=64": args.reps, "256 passages": 5}
    for name, texts in batches.items():
        n_bytes = sum(len(t) for t in texts)
        row = {"bytes": n_bytes, "threads": native.batch_threads(n_bytes)}
        for turn, mode in enumerate(("python", "native", "native", "python")):
            tok._native, tok._native_tried = (None, True) if mode == "python" else (core, True)
            row[f"{mode}_{turn}_ms"] = per_call_ms(lambda: student.tokenize_batch(texts),
                                                   reps[name])
        if core is not None:
            row["core_batch_call_ms"] = per_call_ms(
                lambda: core.tokenize_ids_matrix(texts, 512), reps[name])
        out[name] = row
    tok._native, tok._native_tried = core, True
    print(json.dumps(out), flush=True)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
