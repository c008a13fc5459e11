"""Knowledge distillation of the bi-encoder student (port of sskd_tpu/kd):
losses, batch packing and the trainer. The evaluation module (``kd/eval.py``)
and the teacher's training are later slices."""

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
