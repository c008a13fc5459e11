"""Plain knowledge-distillation training of the bi-encoder: the losses, the
step and AdamW, in float32.

A batch holds B queries, each with N documents, the first its positive, and
the teacher's score of each document. The student scores a query against
its own documents by the dot product of their embeddings. The loss weighs
three terms, each over the valid documents only:

- Margin-MSE: the squared gap between the student's and the teacher's
  scores relative to each row's best, the teacher's divided by the
  temperature; the mean over valid documents.
- Listwise KL: ``KL(softmax(t / T) || softmax(s / T)) * T^2``, the mean over
  rows with a valid document.
- InfoNCE: ``-log softmax(s / tau)`` of the positive, the same mean.

The update clips the gradients to a global norm (scaling only when the norm
reaches the limit), then takes an AdamW step (b1 0.9, b2 0.999, eps 1e-8,
decay on every parameter) at the rate of a linear warmup from 0 over the
first tenth of the run's updates, the first update at rate 0.
"""

from __future__ import annotations

import torch

from benchmark.reference.bert import Arch, embed

NEG = -1e9


def _max(x, mask):
    return torch.where(mask > 0, x, NEG).amax(dim=-1, keepdim=True)


def kd_loss(s, t, mask, temperature, weights, tau) -> dict[str, torch.Tensor]:
    mask = mask.float()
    t_soft = t / temperature
    sq = ((s - _max(s, mask)) - (t_soft - _max(t_soft, mask))) ** 2 * mask
    mm = sq.sum() / mask.sum().clamp(min=1.0)
    neg = torch.where(mask > 0, 0.0, NEG)
    row = mask.amax(dim=-1)
    rows = row.sum().clamp(min=1.0)
    s_logp = torch.log_softmax(s / temperature + neg, dim=-1)
    t_logp = torch.log_softmax(t / temperature + neg, dim=-1)
    kl = torch.where(mask > 0, t_logp.exp() * (t_logp - s_logp), 0.0).sum(dim=-1)
    lw = (kl * row).sum() / rows * temperature ** 2
    ct = -(torch.log_softmax(s / tau + neg, dim=-1)[:, 0] * row).sum() / rows
    total = weights[0] * mm + weights[1] * lw + weights[2] * ct
    return {"loss": total, "margin_mse": mm, "listwise_kd": lw, "contrastive": ct}


def leaves(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """The tree's tensors by ``/``-joined path."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.update(leaves(value, path))
        else:
            out[path] = value
    return out


def kd_step_loss(tree, arch: Arch, batch: dict, q_seeds, d_seeds, temperature, weights, tau,
                 precision="float32") -> dict[str, torch.Tensor]:
    """The loss terms of one step on a packed batch (tensors on the
    device): ``query_ids``/``query_mask`` [B, Lq], ``doc_ids``/``doc_mask``
    [B, N, Ld], ``doc_valid`` and ``teacher_scores`` [B, N]."""
    q = embed(tree, arch, batch["query_ids"], batch["query_mask"], precision, q_seeds)
    B, N, L = batch["doc_ids"].shape
    d = embed(tree, arch, batch["doc_ids"].reshape(B * N, L), batch["doc_mask"].reshape(B * N, L),
              precision, d_seeds).reshape(B, N, -1)
    scores = torch.einsum("bh,bnh->bn", q, d)
    return kd_loss(scores, batch["teacher_scores"].float(), batch["doc_valid"], temperature,
                   weights, tau)


class AdamW:
    def __init__(self, params: dict[str, torch.Tensor], lr: float, weight_decay: float,
                 max_grad_norm: float, warmup: int):
        self.params = params
        self.lr, self.wd, self.max_norm, self.warmup = lr, weight_decay, max_grad_norm, warmup
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    def rate(self) -> float:
        return self.lr * min(self.count, self.warmup) / self.warmup

    def step(self, grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """One update; returns the clipped gradients it used."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        scale = 1.0 if norm < self.max_norm else self.max_norm / norm
        clipped = {k: g * scale for k, g in grads.items()}
        lr = self.rate()
        self.count += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        with torch.no_grad():
            for k, p in self.params.items():
                g = clipped[k]
                self.m[k] = b1 * self.m[k] + (1 - b1) * g
                self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
                p.mul_(1 - lr * self.wd)
                p.sub_(lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + eps))
        return clipped


SEED_STRIDE = 1_000_003


def step_dropout_seeds(train_seed: int, step: int, layers: int) -> tuple[list[int], list[int]]:
    """The dropout seeds of a step's query and document towers: the step's
    seed (``train_seed * 1,000,003 + step``) draws a seed for each tower
    from a CPU generator, and each tower's seed draws one for the
    embeddings and three a layer."""
    gen = torch.Generator().manual_seed(int(train_seed * SEED_STRIDE + step))
    q_seed, d_seed = torch.randint(0, 2**31 - 1, (2,), generator=gen).tolist()

    def layer_seeds(seed):
        g = torch.Generator().manual_seed(int(seed))
        return torch.randint(0, 2**31 - 1, (1 + 3 * layers,), generator=g).tolist()

    return layer_seeds(q_seed), layer_seeds(d_seed)


def temperature(step: int, total_steps: int, t_start: float, t_end: float) -> float:
    """The temperature, annealed linearly over the run (in float32)."""
    progress = torch.clamp(torch.tensor(step / max(1, total_steps - 1), dtype=torch.float32),
                           0.0, 1.0)
    return float(t_start + (t_end - t_start) * progress)
