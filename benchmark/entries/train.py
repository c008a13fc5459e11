"""KD training of the student: ``KDTrainer.train`` on samples that carry
their teacher scores, as the cached recipe has them.

Set-up draws the student's weights on the device and the samples from the
seed: distinct queries, each with its positive and negatives drawn from a
pool of passages, enough for ``max_steps`` steps of one epoch. One call of
``train`` then runs it all: its first ``warm_steps`` steps are set-up (the
first three are the ones compared), the measured window opens at the end of
the last of them, and at the first step boundary past the run's seconds the
window closes and the run leaves the call. The window holds no evaluation
and no save.

Afterwards the plain reference packs the first three batches from the same
samples, follows the same three steps in float32 with the same dropout
masks, and gives each step's loss, each leaf's first gradient as the
optimizer took it and each leaf's change after the three steps.
"""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import texts
from benchmark.harness.program import bert_config, tokenizer
from benchmark.harness.weights import draw_tree, sub_seed
from benchmark.reference.bert import arch_from_config
from benchmark.reference.kd import AdamW, kd_step_loss, leaves, step_dropout_seeds, temperature

CHECKED_STEPS = 3


class StopWindow(Exception):
    pass


def tree_path(name: str) -> str:
    """The reference's path of a parameter of the program's ``BiEncoder``."""
    parts = name.split(".")
    if len(parts) > 2 and parts[1] == "layers":
        parts = [parts[0], f"layer_{parts[2]}", *parts[3:]]
    *owner, last = parts
    if last == "weight":
        last = ("embedding" if owner[-1].endswith("embeddings")
                else "scale" if owner[-1].endswith("norm") else "kernel")
    return "/".join([*owner, last])


class Entry:
    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.tr = run.cell.traffic
        self.arch = arch_from_config(self.cfg)
        self.attempted = self.failed = 0
        self.started = 0
        self.window_steps = 0
        self.batches: list[dict] = []
        self.losses: list[float] = []
        self.grad_norms: dict[str, float] = {}
        self.update_norms: dict[str, float] = {}

    # -- set-up ----------------------------------------------------------

    def setup(self) -> None:
        from sskd_tpu_torch.config import Settings
        from sskd_tpu_torch.kd.dataset import KDDataset, KDSample
        from sskd_tpu_torch.kd.train import KDTrainer
        from sskd_tpu_torch.models.student import StudentModel

        run, tr = self.run, self.tr
        self.out_dir = tempfile.mkdtemp(prefix="bench-kd-")
        settings = dict(tr["settings"])
        settings["training"] = {**settings["training"], "output_dir": self.out_dir}
        self.settings = Settings.from_dict(settings)
        t = self.settings.training
        self.batch = t.batch_size
        n_docs = t.num_docs_per_query
        n = self.batch * int(tr["max_steps"])
        rng = np.random.default_rng(sub_seed(run.seed, 3))
        qlens = texts.lengths(tr["query_tokens"], n, rng)
        dlens = texts.lengths(tr["passage_tokens"], int(tr["passage_pool"]), rng)
        self.queries = texts.texts(qlens, rng)
        self.passages = texts.texts(dlens, rng)
        pool = len(self.passages)
        docs = rng.integers(0, pool, (n, n_docs))
        for i in np.flatnonzero([len(set(row)) < n_docs for row in docs.tolist()]):
            docs[i] = rng.choice(pool, n_docs, replace=False)
        pos = rng.normal(5.0, 0.5, n)
        negs = -np.sort(-rng.uniform(-5.0, 0.0, (n, n_docs - 1)), axis=1)
        self.doc_idx = docs
        self.scores = np.concatenate([pos[:, None], negs], axis=1).astype(np.float32)
        self.samples = [KDSample(query=self.queries[i],
                                 docs=[self.passages[j] for j in docs[i]],
                                 teacher_scores=self.scores[i].tolist()) for i in range(n)]
        self.student = StudentModel(self.cfg["source"], device=run.device,
                                    config=bert_config(self.cfg),
                                    params=draw_tree(self.arch, run.seed, run.device))
        self.trainer = KDTrainer(self.student, self.settings)
        self._instrument(KDDataset)

    def _instrument(self, dataset_cls) -> None:
        rec = self.run.recorder
        self._batches = dataset_cls.batches
        inner_batches = dataset_cls.batches

        def batches(ds, *args, **kwargs):
            it = inner_batches(ds, *args, **kwargs)
            while True:
                with rec.span("pack"):
                    item = next(it, None)
                if item is None:
                    return
                yield item

        dataset_cls.batches = batches
        self._dataset_cls = dataset_cls
        self._inner_step = self.trainer._train_step
        self.trainer._train_step = self._step
        # the two towers' forwards, and below in the first step the
        # optimizer's update, named in the trace: what is left of a step's
        # range is its backward
        rec.wrap(self.student.module, "forward", "tower")

    def _step(self, batch: dict, progress: float, step_seed: int) -> dict:
        run, n = self.run, self.started
        module = self.student.module
        if n == 0:
            self.p0 = {k: p.detach().clone() for k, p in module.named_parameters()}
            run.recorder.wrap(self.trainer._opt, "step", "optimizer")
        if n == CHECKED_STEPS:
            self.update_norms = {k: float((p.detach() - self.p0[k]).norm())
                                 for k, p in module.named_parameters()}
            del self.p0
        if n == int(self.tr["warm_steps"]):
            run.open_window()
        if run.recorder.window_open:
            if time.perf_counter() >= run.deadline:
                run.close_window()
                run.tracer.stop()
                raise StopWindow
            self.window_steps += 1
            self.attempted += 1
        if n == int(self.tr["max_steps"]) - 1:
            raise RuntimeError("the samples ran out before the window closed")
        run.tracer.boundary()
        if n < CHECKED_STEPS:
            self.batches.append({k: v.copy() for k, v in batch.items()})
        qm, dm = batch["query_mask"], batch["doc_mask"]
        shape = {"q_rows": qm.shape[0], "q_len": qm.shape[1], "q_lengths": qm.sum(axis=1),
                 "d_rows": dm.shape[0] * dm.shape[1], "d_len": dm.shape[2],
                 "d_lengths": dm.reshape(-1, dm.shape[2]).sum(axis=1)}
        with run.recorder.span("step", **shape):
            aux = self._inner_step(batch, progress, step_seed)
        if n < CHECKED_STEPS:
            self.losses.append(float(aux["loss"]))
        if n == 0:
            state = self.trainer._opt.adam.state
            self.grad_norms = {k: float(state[p]["exp_avg"].norm()) / 0.1 if p in state else 0.0
                               for k, p in module.named_parameters()}
        self.started += 1
        return aux

    # -- the window ------------------------------------------------------

    def window(self) -> None:
        try:
            self.trainer.train(self.samples, epochs=1, output_dir=self.out_dir,
                               query_len=int(self.tr["query_len"]), doc_len=int(self.tr["doc_len"]))
        except StopWindow:
            pass
        else:
            raise RuntimeError("training ended before the window closed")

    def end_to_end(self) -> dict:
        return {"train_samples_per_s": self.window_steps * self.batch / self.run.window_s}

    def release(self) -> None:
        self._dataset_cls.batches = self._batches
        shutil.rmtree(self.out_dir, ignore_errors=True)
        self.student.cleanup()
        del self.trainer, self.student

    # -- the comparison --------------------------------------------------

    def packed(self, step: int) -> dict:
        """The reference's packing of batch ``step``: the epoch's shuffle
        of the samples, ``[CLS] prefix text [SEP]`` framed to the query and
        document lengths."""
        t = self.settings.training
        order = np.arange(len(self.samples))
        np.random.default_rng(t.seed).shuffle(order)
        rows = order[step * self.batch:(step + 1) * self.batch]
        tok, st = tokenizer(), self.settings.student
        q_ids, q_mask = tok.frame([st.query_prefix + self.queries[i] for i in rows],
                                  int(self.tr["query_len"]))
        docs = [st.passage_prefix + self.passages[j] for i in rows for j in self.doc_idx[i]]
        d_ids, d_mask = tok.frame(docs, int(self.tr["doc_len"]))
        B, N = len(rows), self.doc_idx.shape[1]
        L = int(self.tr["doc_len"])
        return {"query_ids": q_ids, "query_mask": q_mask,
                "doc_ids": d_ids.reshape(B, N, L), "doc_mask": d_mask.reshape(B, N, L),
                "doc_valid": np.ones((B, N), np.float32), "teacher_scores": self.scores[rows]}

    def reference(self, precision: str, rows: slice = slice(None)) -> tuple[list, dict, dict]:
        """Losses of the first steps, and by leaf the first clipped gradient's
        norm and the change's norm after the steps. ``rows`` keeps only those
        rows of each batch (a fault: half of the batch left out)."""
        dev = self.run.device
        t, lc = self.settings.training, self.settings.loss
        total = -(-len(self.samples) // self.batch)
        tree = draw_tree(self.arch, self.run.seed, dev)
        params = leaves(tree)
        for p in params.values():
            p.requires_grad_(True)
        p0 = {k: p.detach().clone() for k, p in params.items()}
        opt = AdamW(params, t.learning_rate, t.weight_decay, t.max_grad_norm,
                    max(1, int(total * t.warmup_ratio)))
        weights = (lc.margin_mse_weight, lc.listwise_kd_weight, lc.contrastive_weight)
        losses, grads0 = [], {}
        for step in range(CHECKED_STEPS):
            batch = {k: torch.from_numpy(np.asarray(v)[rows]).to(dev)
                     for k, v in self.packed(step).items()}
            q_seeds, d_seeds = step_dropout_seeds(t.seed, step, self.arch.layers)
            temp = temperature(step, total, lc.temperature_start, lc.temperature_end)
            out = kd_step_loss(tree, self.arch, batch, q_seeds, d_seeds, temp, weights,
                               lc.contrastive_tau, precision)
            grads = torch.autograd.grad(out["loss"], list(params.values()))
            losses.append(float(out["loss"].detach()))
            clipped = opt.step(dict(zip(params, grads)))
            if step == 0:
                grads0 = {k: float(g.norm()) for k, g in clipped.items()}
        changes = {k: float((p.detach() - p0[k]).norm()) for k, p in params.items()}
        return losses, grads0, changes

    def numbers(self, losses, grads, changes, ref) -> dict:
        """Each step's loss against the reference's; by leaf the first
        gradient's norm and the change's norm after the steps, each gap
        against the reference's norm of that leaf or of the median leaf,
        whichever is larger: the worst leaf's and the median leaf's. Leaves
        whose reference gradient is under a thousandth of the median leaf's
        (a key's bias under softmax) move by round-off alone and are left
        out of the change."""
        r_losses, r_grads, r_changes = ref
        g_med = float(np.median(list(r_grads.values())))
        live = [k for k, g in r_grads.items() if g >= 1e-3 * g_med]
        c_med = float(np.median([r_changes[k] for k in live]))
        g_gaps = {k: abs(grads[k] - r_grads[k]) / max(r_grads[k], g_med) for k in r_grads}
        c_gaps = {k: abs(changes[k] - r_changes[k]) / max(r_changes[k], c_med) for k in live}
        self.worst = {"grad": max(g_gaps, key=g_gaps.get), "update": max(c_gaps, key=c_gaps.get)}
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
                "grad_gap": max(g_gaps.values()),
                "grad_gap_median": float(np.median(list(g_gaps.values()))),
                "update_gap": max(c_gaps.values()),
                "update_gap_median": float(np.median(list(c_gaps.values())))}

    def check(self) -> dict:
        mismatch = 0
        for step, got in enumerate(self.batches):
            want = self.packed(step)
            mismatch += sum(int(np.count_nonzero(np.asarray(got[k]) != np.asarray(v)))
                            for k, v in want.items())
        ref = self.reference("float32")
        grads = {tree_path(k): v for k, v in self.grad_norms.items()}
        changes = {tree_path(k): v for k, v in self.update_norms.items()}
        return {"batch_mismatch": float(mismatch),
                **self.numbers(self.losses, grads, changes, ref)}

    def control(self, precision: str) -> dict:
        low = self.reference(precision)
        return self.numbers(low[0], low[1], low[2], self.reference("float32"))

    def faults(self) -> dict:
        """The numbers of the faults a training step can have, read with the
        reference in the program's place: half of the batch left out (the
        mean over the rest), and a step that returns its state unchanged."""
        ref = self.reference("float32")
        half = self.reference("float32", slice(0, self.batch // 2))
        return {"half_batch": self.numbers(half[0], half[1], half[2], ref),
                "unchanged_state": self.numbers(ref[0], ref[1], {k: 0.0 for k in ref[2]}, ref)}
