"""The passage reader of raw MS MARCO-style JSONL rows (port of
``_iter_passages_graded``, sskd_tpu/data/prepare.py:47-69).

Both layouts the reference handled (reference: prepare.py:16-135): the
nested ``passages{passage_text[], is_selected[]}`` dict of v2.1 and the
legacy list of passage dicts. The rest of that module writes chunked
parquet through pandas, which the machine with the GPU lacks; it is a later
slice of the port.
"""

from __future__ import annotations

from sskd_tpu_torch.exceptions import DataError


def _iter_passages_graded(row: dict):
    """Yield (passage_text, is_selected, relevance_grade). The grade rides
    in an optional parallel ``relevance_grade`` list (the demo generator
    emits 2 = positive / 1 = hard near-miss / 0 = irrelevant for graded
    nDCG); without it (real MS MARCO) it is is_selected."""
    passages = row.get("passages")
    if passages is None:
        return
    if isinstance(passages, dict):  # v2.1 nested layout
        texts = passages.get("passage_text", [])
        selected = passages.get("is_selected", [0] * len(texts))
        grades = passages.get("relevance_grade", selected)
        for text, sel, grade in zip(texts, selected, grades):
            yield text, int(sel), float(grade)
    elif isinstance(passages, list):  # legacy list-of-dicts layout
        for p in passages:
            sel = int(p.get("is_selected", 0))
            yield p.get("passage_text", ""), sel, float(p.get("relevance_grade", sel))
    else:
        raise DataError(f"unrecognized passages layout: {type(passages)}")
