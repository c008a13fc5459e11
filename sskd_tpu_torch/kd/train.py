"""KDTrainer: knowledge-distillation training of the bi-encoder student
(port of sskd_tpu/kd/train.py).

The train step encodes the queries and the B x N docs with dropout on
(hidden dropout and, through the ``dropattn`` kernels, dropout on the
attention probabilities), scores each query against its own docs, and takes
the combined KD loss (:mod:`sskd_tpu_torch.kd.losses`); with
``loss.in_batch_negatives`` the InfoNCE term also sees every other query's
docs. Each encoder layer is recomputed in the backward when
``training.remat`` is on.

The optimizer is what the JAX package builds with optax, written out:

- ``clip_by_global_norm``: the gradients are scaled by ``max_norm / norm``
  only when ``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` would
  scale by ``max_norm / (norm + 1e-6)`` always);
- ``adamw`` through ``torch.optim.AdamW`` (b1 0.9, b2 0.999, eps 1e-8, the
  decay on every parameter), its rate from a linear warmup to
  ``learning_rate`` over ``max(1, total * warmup_ratio)`` updates, then a
  linear decay to 0. optax evaluates the schedule at the count *before* the
  update, so the first update uses ``schedule(0) = 0`` and leaves the
  parameters as they were; this trainer does the same;
- ``MultiSteps``: with ``grad_accum_steps`` k > 1 the gradients of k steps
  are averaged and one update is made; the schedule counts updates.

Dropout seeds: step ``n`` draws its query- and doc-tower seeds from
``training.seed`` and ``n``, so a resumed run sees the masks an
uninterrupted one would have.

Data parallelism (``mesh``, the JAX package's sharded jit over the ``data``
axis): one process per data-axis entry, joined by a ``torch.distributed``
group (:mod:`sskd_tpu_torch.parallel.distributed`; the CLI's ``train
--data-parallel N`` starts the processes). Rank ``r`` trains on
``mesh.devices[r][0]`` and takes rows ``[r B/W, (r + 1) B/W)`` of every
global batch (the same shuffle on every rank). The step computes the JAX
step's global loss: each term's masked sum over the rank's rows is divided
by the term's count summed over the ranks, the in-batch negatives are the
doc embeddings and validity of every rank (an all-gather whose backward
sums every rank's gradient on a rank's rows), and the "own docs" mask
compares global rows. Each rank's loss is thus its share of the global
loss, so the gradients are summed over the ranks (one all-reduce) before
clipping, and every rank takes the same AdamW step: the parameters stay
bit-identical, as rank 0's are broadcast at the start. Rank 0 draws the
single-device seeds and rank ``r`` the next pair after rank ``r - 1``'s, so
the ranks' dropout masks differ from each other and from a single-device
run's on the same rows (a recorded divergence: the JAX step draws one mask
over the global batch). Every decision (resume, ANCE refresh, evaluation,
early stopping) is rank 0's, broadcast; only rank 0 writes files, and the
others pass a barrier after them. The output directory must be one
directory that every rank reads (one host, or a shared filesystem).

Checkpoints are the port's own (``torch.save``), under
``output_dir/checkpoints/step_<n>/state.pt``: the parameters, the optimizer
state, step, epoch and best metric; the 3 newest are kept and training
resumes from the newest when ``training.resume`` is on. The best model goes
to ``output_dir/best_model`` through ``StudentModel.save``.
"""

from __future__ import annotations

import json
import math
import shutil
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from sskd_tpu_torch.config import Settings
from sskd_tpu_torch.exceptions import ConfigError
from sskd_tpu_torch.kd.dataset import KDDataset, KDSample, prefetch_batches
from sskd_tpu_torch.kd.losses import combined_kd_loss, temperature_at
from sskd_tpu_torch.parallel import distributed
from sskd_tpu_torch.utils.logging import get_logger
from sskd_tpu_torch.utils.metrics import ndcg_at_k

logger = get_logger("kd.train")

_KEEP_CHECKPOINTS = 3
_SEED_STRIDE = 1_000_003  # step seed = training.seed * stride + step


class KDOptimizer:
    """``optax.chain(clip_by_global_norm, adamw(schedule))``, wrapped in
    ``optax.MultiSteps`` when ``grad_accum_steps`` > 1, over torch
    parameters whose ``.grad`` the train step fills. ``grad_reduce``, when
    given, sums the gradients over the ranks of a data-parallel run in place
    before they are averaged over the accumulated steps and clipped: it is
    called with one flat buffer, of which every ``.grad`` is a view, so the
    backward accumulates into it and one collective reduces it."""

    def __init__(self, params, cfg, total_steps: int, grad_reduce=None):
        self.params = [p for p in params if p.requires_grad]
        self.grad_reduce = grad_reduce
        self._flat = None
        if grad_reduce is not None:
            self._flat = torch.zeros(sum(p.numel() for p in self.params),
                                     dtype=self.params[0].dtype, device=self.params[0].device)
            self._views = [g.view_as(p) for p, g in zip(
                self.params, self._flat.split([p.numel() for p in self.params]))]
        self.learning_rate = cfg.learning_rate
        self.warmup = max(1, int(total_steps * cfg.warmup_ratio))
        self.decay_steps = max(1, total_steps - self.warmup)
        self.max_grad_norm = cfg.max_grad_norm
        self.accum = cfg.grad_accum_steps
        self.adam = torch.optim.AdamW(
            self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay
        )
        self.mini_step = 0  # steps accumulated since the last update
        self.updates = 0  # updates made (optax's count)

    def schedule(self, count: int) -> float:
        """``join_schedules([linear(0, lr, warmup), linear(lr, 0, rest)])``."""
        if count < self.warmup:
            return self.learning_rate * count / self.warmup
        frac = min(count - self.warmup, self.decay_steps) / self.decay_steps
        return self.learning_rate * (1.0 - frac)

    def begin(self) -> None:
        """Before the backward of a step: a new accumulation clears the
        gradients (the last update's stay readable until then)."""
        if self.mini_step:
            return
        if self._flat is None:
            self.adam.zero_grad(set_to_none=True)
            return
        self._flat.zero_()
        for p, g in zip(self.params, self._views):
            p.grad = g

    def step(self) -> None:
        """After the backward of a step: an update every ``accum`` steps."""
        self.mini_step += 1
        if self.mini_step < self.accum:
            return
        self.mini_step = 0
        if self._flat is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
            for p, g in zip(self.params, grads):
                p.grad = g
        else:
            grads = self._views
            self.grad_reduce([self._flat])
        if self.accum > 1:
            torch._foreach_div_(grads, float(self.accum))
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        # optax: g if norm < max_norm else g / norm * max_norm (no sync here)
        scale = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                            self.max_grad_norm / norm)
        torch._foreach_mul_(grads, scale)
        lr = self.schedule(self.updates)
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        self.updates += 1

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "mini_step": self.mini_step,
                "updates": self.updates}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.mini_step = int(state["mini_step"])
        self.updates = int(state["updates"])


class KDTrainer:
    # Teacher-graded tiebreak weight in the dev early-stop signal: one
    # positive misplacement must cost more than any reordering of the
    # graded negatives (see _dev_ndcg).
    _GRADE_WEIGHT = 0.25

    def __init__(self, student, settings: Settings | None = None, mesh=None):
        self.student = student
        self.settings = settings or Settings()
        self.cfg = self.settings.training
        self.loss_cfg = self.settings.loss
        self._opt: KDOptimizer | None = None
        self._total_steps = 0
        self.mesh = mesh
        self.rank, self.world = 0, 1
        if mesh is not None:
            self.rank, self.world = self._check_mesh(mesh)

    def _check_mesh(self, mesh) -> tuple[int, int]:
        """(rank, world) of this process in a data-parallel run over the
        mesh's data axis (its first); the index axis only adds replicas, as
        in JAX, and training ignores it."""
        rank, dp = distributed.data_axis_rank(mesh, self.student.device)
        if self.cfg.batch_size % dp:
            raise ConfigError(f"training.batch_size={self.cfg.batch_size} is not a multiple of "
                              f"the {dp} data-parallel processes")
        return rank, dp

    def _barrier(self) -> None:
        if self.mesh is not None:
            distributed.barrier()

    def _from_rank0(self, obj):
        """Rank 0's ``obj``: what every rank of a data-parallel run decides."""
        return distributed.broadcast_object(obj) if self.mesh is not None else obj

    # ------------------------------------------------------------------
    # Optimizer / train step
    # ------------------------------------------------------------------

    def _make_optimizer(self, total_steps: int) -> KDOptimizer:
        reduce = distributed.all_reduce_sum_ if self.mesh is not None else None
        return KDOptimizer(self.student.module.parameters(), self.cfg, total_steps, reduce)

    def _prepare_module(self) -> None:
        module = self.student.module
        module.train()
        module.encoder.remat = self.cfg.remat_policy if self.cfg.remat else None

    def _step_seed(self, global_step: int) -> int:
        return self.cfg.seed * _SEED_STRIDE + global_step

    def _tower_seeds(self, step_seed: int) -> tuple[int, int]:
        """The query- and doc-tower dropout seeds of this rank at a step:
        the step seed's first pair of draws on rank 0 (the single-device
        seeds), its pair ``r`` on rank ``r``."""
        gen = torch.Generator().manual_seed(int(step_seed))
        draws = torch.randint(0, 2**31 - 1, (2 * (self.rank + 1),), generator=gen).tolist()
        return draws[-2], draws[-1]

    def _train_step(self, batch: dict, progress: float, step_seed: int) -> dict:
        """One step on a packed batch (numpy arrays; in a data-parallel run
        this rank's rows of the global batch): forward, loss, backward,
        optimizer. Returns the loss terms (of the global batch) as device
        scalars."""
        module, dev, lc = self.student.module, self.student.device, self.loss_cfg
        dp = self.mesh is not None
        t = {k: torch.from_numpy(v).to(dev, non_blocking=True) for k, v in batch.items()}
        q_seed, d_seed = self._tower_seeds(step_seed)
        self._opt.begin()
        q_emb = module(t["query_ids"].long(), t["query_mask"], dropout_seed=q_seed)
        B, N, L = t["doc_ids"].shape
        d_emb = module(
            t["doc_ids"].reshape(B * N, L).long(), t["doc_mask"].reshape(B * N, L),
            dropout_seed=d_seed,
        ).reshape(B, N, -1)
        scores = torch.einsum("bh,bnh->bn", q_emb, d_emb)
        temp = temperature_at(progress, lc.temperature_start, lc.temperature_end)
        ct_scores = ct_mask = None
        if lc.in_batch_negatives:
            # every other query's docs widen the InfoNCE denominator; own
            # docs are masked out of the extension (they already occupy the
            # first N columns) and a batch-tail padding row gains no columns
            # (data-parallel: every rank's docs, and global rows for "own")
            valid = t["doc_valid"].float()
            docs, valid_all = d_emb.reshape(B * N, -1), valid.reshape(1, B * N)
            if dp:
                docs = distributed.all_gather_rows(docs)
                valid_all = distributed.all_gather_rows(valid.reshape(B * N)).reshape(1, -1)
            all_s = q_emb @ docs.T
            own = (torch.arange(docs.shape[0], device=dev)[None, :] // N
                   == (torch.arange(B, device=dev) + self.rank * B)[:, None])
            row_live = valid.amax(dim=1, keepdim=True)
            others = valid_all * (~own).float() * row_live
            ct_scores = torch.cat([scores, all_s], dim=1)
            ct_mask = torch.cat([valid, others], dim=1)
        out = combined_kd_loss(
            scores,
            t["teacher_scores"],
            t["doc_valid"],
            temperature=temp,
            margin_mse_weight=lc.margin_mse_weight,
            listwise_kd_weight=lc.listwise_kd_weight,
            contrastive_weight=lc.contrastive_weight,
            tau=lc.contrastive_tau,
            contrastive_scores=ct_scores,
            contrastive_mask=ct_mask,
            count_reduce=distributed.all_reduce_sum_ if dp else None,
        )
        out["loss"].backward()
        self._opt.step()
        aux = {k: v.detach() for k, v in out.items()}
        if dp:  # each rank holds its share of each term: their sums are the batch's
            keys = ("loss", "margin_mse", "listwise_kd", "contrastive")
            terms = torch.stack([aux[k] for k in keys])
            distributed.all_reduce_sum_([terms])
            aux.update(zip(keys, terms))
        return aux

    # ------------------------------------------------------------------
    # Dev evaluation for early stopping
    # ------------------------------------------------------------------

    def _dev_ndcg(self, dev_samples: Sequence[KDSample]) -> float:
        """In-candidate nDCG@10 with the live student: each dev query ranks
        its own doc list, capped to ``max(num_docs_per_query, 10)``. Gains
        blend the binary positive at column 0 (weight 1) with the query's
        min-max-normalised teacher scores (weight ``_GRADE_WEIGHT``, a
        tiebreak that keeps the signal moving once every positive ranks
        first)."""
        n_docs = max(self.cfg.num_docs_per_query, 10)
        doc_lists = [s.docs[:n_docs] for s in dev_samples]
        flat_docs = [d for docs in doc_lists for d in docs]
        if not flat_docs:
            return 0.0
        q = self.student.encode_queries([s.query for s in dev_samples])
        d = self.student.encode_documents(flat_docs)
        vals, offset = [], 0
        for qi, docs in enumerate(doc_lists):
            scores = q[qi] @ d[offset : offset + len(docs)].T
            offset += len(docs)
            order = np.argsort(-scores)
            ts = np.asarray(dev_samples[qi].teacher_scores[: len(docs)], np.float64)
            binary = np.zeros(len(docs), np.float64)
            binary[0] = 1.0  # column 0 is the mined positive
            spread = float(ts.max() - ts.min()) if len(ts) else 0.0
            if spread > 1e-9:
                gains = binary + self._GRADE_WEIGHT * (ts - ts.min()) / spread
            else:  # no informative teacher scores: binary only
                gains = binary
            vals.append(ndcg_at_k(gains[order].tolist(), k=10))
        return float(np.mean(vals)) if vals else 0.0

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------

    @staticmethod
    def _checkpoints(output_dir: Path) -> list[tuple[int, Path]]:
        root = output_dir / "checkpoints"
        found = []
        for d in root.glob("step_*"):
            if (d / "state.pt").exists() and d.name[5:].isdigit():
                found.append((int(d.name[5:]), d))
        return sorted(found)

    def _save_checkpoint(self, output_dir: Path, step: int, epoch: int,
                         best_metric: float) -> None:
        if self.rank == 0:
            self._write_checkpoint(output_dir, step, epoch, best_metric)
        self._barrier()

    def _write_checkpoint(self, output_dir: Path, step: int, epoch: int,
                          best_metric: float) -> None:
        root = output_dir / "checkpoints"
        final = root / f"step_{step}"
        tmp = root / f".step_{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        torch.save(
            {
                "params": self.student.module.state_dict(),
                "opt_state": self._opt.state_dict(),
                "step": step,
                "epoch": epoch,
                "best_metric": float(best_metric),
            },
            tmp / "state.pt",
        )
        shutil.rmtree(final, ignore_errors=True)
        tmp.rename(final)
        for _, old in self._checkpoints(output_dir)[:-_KEEP_CHECKPOINTS]:
            shutil.rmtree(old, ignore_errors=True)

    def _restore_latest(self, output_dir: Path):
        found = self._checkpoints(output_dir)
        path = self._from_rank0(found[-1][1] if found else None)
        if path is None:
            return None
        state = torch.load(path / "state.pt", map_location=self.student.device,
                           weights_only=True)
        self.student.module.load_state_dict(state["params"])
        self._opt.load_state_dict(state["opt_state"])
        return state

    # ------------------------------------------------------------------
    # Main loop
    # ------------------------------------------------------------------

    def _evaluate(self, dev_samples, dev_evaluator) -> float:
        """The dev metric (every rank evaluates, for an evaluator that runs
        collectives; rank 0's value is used)."""
        if dev_evaluator is not None:
            metric = float(dev_evaluator(self.student))
        else:
            metric = self._dev_ndcg(dev_samples)
        return self._from_rank0(metric)

    def _save_best(self, output_dir: Path) -> None:
        if self.rank == 0:
            self.student.save(output_dir / "best_model")
        self._barrier()

    def _sync_parameters(self) -> None:
        """Every rank starts from rank 0's parameters."""
        for p in self.student.module.parameters():
            torch.distributed.broadcast(p.data, src=0)

    def train(
        self,
        train_samples: Sequence[KDSample],
        dev_samples: Sequence[KDSample] | None = None,
        epochs: int | None = None,
        output_dir: str | Path | None = None,
        num_docs: int | None = None,
        query_len: int = 64,
        doc_len: int = 192,
        negative_refresher=None,
        dev_evaluator=None,
    ) -> dict:
        """Train on the student's device. ``dev_evaluator``, when given, is
        called with the live student at each evaluation and returns a scalar
        dev metric; it replaces the in-candidate ``_dev_ndcg`` for early
        stopping and best-model selection. ``negative_refresher``, when
        given, is called with the student at an epoch boundary once
        ``mining.ance_refresh_every_n_steps`` steps have passed since the
        last refresh, and returns fresh samples (or nothing); in a
        data-parallel run rank 0 calls it and sends its samples to the
        others."""
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        output_dir = Path(output_dir or cfg.output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)

        def make_dataset(samples):
            return KDDataset(
                samples,
                self.student.tokenizer,
                num_docs=num_docs or cfg.num_docs_per_query,
                query_len=query_len,
                doc_len=doc_len,
                query_prefix=self.student.query_prefix,
                passage_prefix=self.student.passage_prefix,
            )

        dataset = make_dataset(train_samples)
        steps_per_epoch = dataset.steps_per_epoch(cfg.batch_size)
        total_steps = steps_per_epoch * epochs
        self._total_steps = total_steps
        self._opt = self._make_optimizer(total_steps)
        self._prepare_module()
        if self.mesh is not None:
            self._sync_parameters()

        global_step, start_epoch, best_metric = 0, 0, -math.inf
        if cfg.resume:
            restored = self._restore_latest(output_dir)
            if restored is not None:
                global_step = int(restored["step"])
                start_epoch = int(restored["epoch"])
                best_metric = float(restored["best_metric"])
                logger.info(f"resumed from checkpoint step={global_step} epoch={start_epoch}")

        history: list[dict] = []
        epochs_without_improvement = 0
        mining = self.settings.mining
        last_refresh_step = global_step
        evaluate = bool(dev_samples) or dev_evaluator is not None
        try:
            for epoch in range(start_epoch, epochs):
                if (
                    negative_refresher is not None
                    and mining.ance_enabled
                    and epoch > start_epoch
                    and global_step >= mining.ance_warmup_steps
                    and global_step - last_refresh_step >= mining.ance_refresh_every_n_steps
                ):
                    fresh = self._from_rank0(
                        negative_refresher(self.student) if self.rank == 0 else None)
                    if fresh:
                        dataset = make_dataset(fresh)
                        last_refresh_step = global_step
                        logger.info(f"ANCE refresh at step {global_step}: "
                                    f"{len(fresh)} samples re-mined")
                t0 = time.time()
                terms: dict[str, list] = {
                    "loss": [], "margin_mse": [], "listwise_kd": [], "contrastive": []
                }
                improved_mid_epoch = False
                step_evals: list[dict] = []
                for batch in prefetch_batches(
                    dataset.batches(cfg.batch_size, shuffle=True, seed=cfg.seed + epoch,
                                    shard=(self.rank, self.world)),
                    size=cfg.prefetch_batches,
                ):
                    progress = float(np.float32(global_step / max(1, total_steps - 1)))
                    aux = self._train_step(batch, progress, self._step_seed(global_step))
                    for key in terms:
                        terms[key].append(aux[key])
                    global_step += 1
                    if cfg.save_steps and global_step % cfg.save_steps == 0:
                        self._save_checkpoint(output_dir, global_step, epoch, best_metric)
                    if evaluate and cfg.eval_steps and global_step % cfg.eval_steps == 0:
                        # step evals feed best-model selection and early
                        # stopping through the same evaluator as the epoch end
                        step_ndcg = self._evaluate(dev_samples, dev_evaluator)
                        step_evals.append({"step": global_step, "dev_ndcg@10": step_ndcg})
                        logger.info(f"step {global_step}: dev_ndcg@10={step_ndcg:.4f}")
                        if cfg.early_stopping_metric != "loss" and step_ndcg > best_metric:
                            best_metric = step_ndcg
                            improved_mid_epoch = True
                            self._save_best(output_dir)

                means = {k: float(torch.stack(v).float().mean().cpu()) for k, v in terms.items()}
                record = {
                    "epoch": epoch + 1,
                    "train_loss": means.pop("loss"),
                    "temperature": temperature_at(
                        float(np.float32((global_step - 1) / max(1, total_steps - 1))),
                        self.loss_cfg.temperature_start,
                        self.loss_cfg.temperature_end,
                    ),
                    "seconds": time.time() - t0,
                    **means,
                }
                if step_evals:
                    record["step_evals"] = step_evals
                if evaluate:
                    record["dev_ndcg@10"] = self._evaluate(dev_samples, dev_evaluator)
                if "dev_ndcg@10" in record and cfg.early_stopping_metric != "loss":
                    metric = record["dev_ndcg@10"]
                else:
                    metric = -record["train_loss"]
                metric = self._from_rank0(metric)
                history.append(record)
                logger.info(
                    f"epoch {epoch + 1}/{epochs}: loss={record['train_loss']:.4f} "
                    f"T={record['temperature']:.2f} "
                    + (f"dev_ndcg@10={record['dev_ndcg@10']:.4f} "
                       if "dev_ndcg@10" in record else "")
                    + f"({record['seconds']:.1f}s)"
                )
                if self.rank == 0:
                    with open(output_dir / f"metrics_epoch_{epoch + 1}.json", "w") as f:
                        json.dump(record, f, indent=2)
                self._save_checkpoint(output_dir, global_step, epoch + 1,
                                      max(best_metric, metric))

                if metric > best_metric:
                    best_metric = metric
                    epochs_without_improvement = 0
                    self._save_best(output_dir)
                elif improved_mid_epoch:
                    # a step eval already raised best_metric this epoch
                    epochs_without_improvement = 0
                else:
                    epochs_without_improvement += 1
                    if epochs_without_improvement >= cfg.early_stopping_patience:
                        logger.info(f"early stopping after epoch {epoch + 1} "
                                    f"(patience {cfg.early_stopping_patience})")
                        break
        finally:
            self.student.module.eval()
            self.student.module.encoder.remat = None
        if self.rank == 0:
            with open(output_dir / "history.json", "w") as f:
                json.dump(history, f, indent=2)
        self._barrier()
        return {
            "history": history,
            "best_metric": float(best_metric),
            "global_step": global_step,
            "output_dir": str(output_dir),
        }
