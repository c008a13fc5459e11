"""IR evaluation metrics, host-side numpy (copy of the parts of
sskd_tpu/utils/metrics.py that the trainer's dev evaluation reads: ``_dcg``
and ``ndcg_at_k``, :21-41). The rest of that module comes with ``kd/eval.py``.

``ndcg_at_k`` keeps the reference's variant: linear gain and an IDCG over the
retrieved labels only (reference: src/utils/metrics.py:27-37).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _dcg(labels: np.ndarray, exponential: bool = False) -> float:
    if labels.size == 0:
        return 0.0
    discounts = 1.0 / np.log2(np.arange(2, labels.size + 2))
    gains = np.power(2.0, labels) - 1.0 if exponential else labels
    return float(np.sum(gains * discounts))


def ndcg_at_k(relevances: Sequence[float], k: int = 10) -> float:
    """nDCG@k with linear gain and IDCG over the retrieved labels;
    ``relevances`` are the graded labels of the retrieved docs in rank order."""
    rel = np.asarray(relevances, dtype=np.float64)[:k]
    dcg = _dcg(rel)
    ideal = _dcg(np.sort(rel)[::-1])
    if ideal == 0.0:
        return 0.0
    return dcg / ideal
