"""KD losses in torch (port of sskd_tpu/kd/losses.py).

- Margin-MSE: ``MSE(s - max(s), t/T - max(t/T))`` over valid docs.
- Listwise KL: ``KL(softmax(t/T) || softmax(s/T)) * T^2``, mean over rows
  with at least one valid doc.
- InfoNCE: ``-log_softmax(s/tau)[:, 0]`` with the positive at column 0, mean
  over rows with at least one valid doc.
- Combined: weighted 0.6 / 0.2 / 0.2; the temperature touches Margin-MSE and
  the listwise term only; ``temperature_at`` anneals it linearly by training
  progress in [0, 1].

Each term is a masked sum over a count (``*_terms`` give both), so that a
data-parallel step can divide each rank's sum by the count over all ranks
(``combined_kd_loss(count_reduce=...)``).

Every function takes a validity ``mask`` [B, N] (1 = real doc, 0 =
padding); masked entries score ``_NEG`` = -1e9, as in the JAX package.
"""

from __future__ import annotations

import torch

_NEG = -1e9


def _masked_max(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask > 0, x, _NEG).amax(dim=-1, keepdim=True)


def margin_mse_terms(student_scores, teacher_scores, mask=None, temperature=1.0):
    """Margin-MSE's masked sum of squared errors and its count (valid docs)."""
    if mask is None:
        mask = torch.ones_like(student_scores)
    mask = mask.to(student_scores.dtype)
    t_soft = teacher_scores / temperature
    s_margin = student_scores - _masked_max(student_scores, mask)
    t_margin = t_soft - _masked_max(t_soft, mask)
    sq = (s_margin - t_margin) ** 2 * mask
    return sq.sum(), mask.sum()


def margin_mse_loss(student_scores, teacher_scores, mask=None, temperature=1.0):
    """MSE between max-relative margins."""
    num, count = margin_mse_terms(student_scores, teacher_scores, mask, temperature)
    return num / count.clamp(min=1.0)


def listwise_kd_terms(student_scores, teacher_scores, mask=None, temperature=1.0):
    """The listwise KL's sum over rows with a valid doc, and their count."""
    if mask is None:
        mask = torch.ones_like(student_scores)
    neg = torch.where(mask > 0, 0.0, _NEG)
    s_logp = torch.log_softmax(student_scores / temperature + neg, dim=-1)
    t_logp = torch.log_softmax(teacher_scores / temperature + neg, dim=-1)
    t_p = torch.exp(t_logp)
    kl = torch.where(mask > 0, t_p * (t_logp - s_logp), 0.0).sum(dim=-1)
    # rows with no valid docs (batch-tail padding) must not dilute the mean
    row_valid = mask.amax(dim=-1)
    return (kl * row_valid).sum(), row_valid.sum()


def listwise_kd_loss(student_scores, teacher_scores, mask=None, temperature=1.0):
    """KL(teacher || student) over the doc list, times T^2, mean over rows
    with a valid doc."""
    num, count = listwise_kd_terms(student_scores, teacher_scores, mask, temperature)
    return num / count.clamp(min=1.0) * temperature**2


def contrastive_terms(student_scores, mask=None, tau: float = 0.05):
    """InfoNCE's negated sum of the positives' log-probabilities over rows
    with a valid doc, and their count."""
    if mask is None:
        mask = torch.ones_like(student_scores)
    neg = torch.where(mask > 0, 0.0, _NEG)
    logp = torch.log_softmax(student_scores / tau + neg, dim=-1)
    row_valid = mask.amax(dim=-1)
    return -(logp[:, 0] * row_valid).sum(), row_valid.sum()


def contrastive_loss(student_scores, mask=None, tau: float = 0.05):
    """InfoNCE with the positive at column 0."""
    num, count = contrastive_terms(student_scores, mask, tau)
    return num / count.clamp(min=1.0)


def temperature_at(progress, t_start: float = 4.0, t_end: float = 2.0) -> float:
    """Linear temperature annealing by training progress in [0, 1]
    (computed in f32, as the JAX package does)."""
    progress = torch.clamp(torch.as_tensor(progress, dtype=torch.float32), 0.0, 1.0)
    return float(t_start + (t_end - t_start) * progress)


def combined_kd_loss(
    student_scores,
    teacher_scores,
    mask=None,
    temperature=4.0,
    margin_mse_weight: float = 0.6,
    listwise_kd_weight: float = 0.2,
    contrastive_weight: float = 0.2,
    tau: float = 0.05,
    contrastive_scores=None,
    contrastive_mask=None,
    count_reduce=None,
) -> dict[str, torch.Tensor]:
    """Weighted three-loss combination; returns the keys {loss, margin_mse,
    listwise_kd, contrastive, temperature}. ``contrastive_scores`` /
    ``contrastive_mask`` widen the InfoNCE term only (in-batch negatives).

    ``count_reduce``, when given, is called with the three terms' counts (a
    list of scalar tensors) and sums them in place over the ranks of a
    data-parallel run before each masked sum is divided: each rank's result
    is then its share of the global batch's loss, and the shares sum to it."""
    mm_n, mm_c = margin_mse_terms(student_scores, teacher_scores, mask, temperature)
    lw_n, lw_c = listwise_kd_terms(student_scores, teacher_scores, mask, temperature)
    ct_s = student_scores if contrastive_scores is None else contrastive_scores
    ct_m = mask if contrastive_scores is None else contrastive_mask
    ct_n, ct_c = contrastive_terms(ct_s, ct_m, tau)
    if count_reduce is not None:
        count_reduce([mm_c, lw_c, ct_c])
    mm = mm_n / mm_c.clamp(min=1.0)
    lw = lw_n / lw_c.clamp(min=1.0) * temperature**2
    ct = ct_n / ct_c.clamp(min=1.0)
    total = margin_mse_weight * mm + listwise_kd_weight * lw + contrastive_weight * ct
    return {
        "loss": total,
        "margin_mse": mm,
        "listwise_kd": lw,
        "contrastive": ct,
        "temperature": torch.as_tensor(temperature, dtype=torch.float32),
    }
