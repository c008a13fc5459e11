"""A run of each cell, with the chip's look skipped and at a tiny size on
the CPU, comes out correct; with its timed path broken underneath in each
way the cell can break, the same run comes out not correct."""

import numpy as np
import pytest
import torch

from benchmark.harness.core import run_cell
from benchmark.tests.tiny import tiny_cell

SEED = 2**32 + 77


def run(workload):
    torch.manual_seed(0)
    return run_cell(tiny_cell(workload), SEED, 0.4, False, "cpu")


def alter_token(monkeypatch):
    """The first token after ``[CLS]`` of every framed row replaced where
    tokenization makes it."""
    from sskd_tpu_torch.tokenization.wordpiece import WordPieceTokenizer

    for name in ("frame_batch", "frame_pairs"):
        inner = getattr(WordPieceTokenizer, name)

        def framed(self, *args, _inner=inner, **kwargs):
            out = _inner(self, *args, **kwargs)
            out["input_ids"][:, 1] = (out["input_ids"][:, 1] + 7) % 180 + 5
            return out

        monkeypatch.setattr(WordPieceTokenizer, name, framed)


def alter_answer(monkeypatch):
    """Each query's best answer replaced by the next row where the engine
    gives it."""
    from sskd_tpu_torch.serve.fused import FusedSearcher

    inner = FusedSearcher.search_texts

    def search(self, queries, k):
        scores, idx = inner(self, queries, k)
        idx = idx.copy()
        idx[:, 0] = (idx[:, 0] + 1) % self.ntotal
        return scores, idx

    monkeypatch.setattr(FusedSearcher, "search_texts", search)


def alter_row(cls_path):
    """Every row's answer altered where ``forward_batch`` gives it: an
    embedding negated, a logit moved by 0.5."""

    def patch(monkeypatch):
        import importlib

        module, name = cls_path.rsplit(".", 1)
        cls = getattr(importlib.import_module(module), name)
        inner = cls.forward_batch

        def forward(self, batch):
            out = inner(self, batch)
            return -out if out.dim() > 1 else out + 0.5

        monkeypatch.setattr(cls, "forward_batch", forward)

    return patch


def unchanged_state(monkeypatch):
    """The optimizer's step returns the state as it found it."""
    from sskd_tpu_torch.kd.train import KDOptimizer

    monkeypatch.setattr(KDOptimizer, "step", lambda self: None)


def half_batch(monkeypatch):
    """The loss taken over the first half of the batch's rows."""
    import sskd_tpu_torch.kd.train as train

    inner = train.combined_kd_loss

    def loss(s, t, mask=None, **kw):
        h = s.shape[0] // 2
        return inner(s[:h], t[:h], None if mask is None else mask[:h], **kw)

    monkeypatch.setattr(train, "combined_kd_loss", loss)


FAULTS = {
    "search-e5s-msmarco8m-exact": {"token": alter_token, "answer": alter_answer},
    "score-bge-mining-pairs": {
        "token": alter_token, "answer": alter_row("sskd_tpu_torch.models.teacher.TeacherModel")},
    "encode-e5s-msmarco-passages": {
        "token": alter_token, "answer": alter_row("sskd_tpu_torch.models.student.StudentModel")},
    "train-e5s-kd": {"unchanged_state": unchanged_state, "half_batch": half_batch},
}


@pytest.mark.parametrize("workload", sorted(FAULTS))
def test_a_sound_run_is_correct(workload):
    result = run(workload)
    assert result.correct, result.checks
    assert np.isfinite(list(v["value"] for v in result.checks.values())).all()


@pytest.mark.parametrize("workload,fault", [(w, f) for w in sorted(FAULTS) for f in FAULTS[w]])
def test_a_broken_path_is_not_correct(workload, fault, monkeypatch):
    FAULTS[workload][fault](monkeypatch)
    result = run(workload)
    assert not result.correct, result.checks
