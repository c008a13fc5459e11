"""Knowledge distillation of the bi-encoder student (port of sskd_tpu/kd):
losses, batch packing, the trainer, and the teacher's own training
(``kd/teacher_train.py``). The evaluator, ``kd/eval.py``, is imported from
its module."""

from sskd_tpu_torch.kd.dataset import KDDataset, KDSample, prefetch_batches
from sskd_tpu_torch.kd.losses import (
    combined_kd_loss,
    contrastive_loss,
    listwise_kd_loss,
    margin_mse_loss,
    temperature_at,
)

__all__ = [
    "KDDataset",
    "KDSample",
    "prefetch_batches",
    "margin_mse_loss",
    "listwise_kd_loss",
    "contrastive_loss",
    "combined_kd_loss",
    "temperature_at",
]
