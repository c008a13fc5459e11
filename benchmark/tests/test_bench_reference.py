"""The plain reference agrees with the program at a tiny size on the CPU,
for what each cell's entry computes: tokenization and framing, the
bi-encoder and the cross-encoder in float32, int8 rows and exact top-k, the
dropout keep-mask, the KD losses and AdamW."""

import numpy as np
import pytest
import torch

from benchmark.harness.program import bert_config
from benchmark.harness.spec import load_cell
from benchmark.harness.weights import draw_tree
from benchmark.reference import bert as ref
from benchmark.reference.keep_mask import keep_mask
from benchmark.reference.kd import AdamW, kd_loss
from benchmark.reference.search import ExactTopK, quantize
from benchmark.reference.tokenizer import Tokenizer
from benchmark.tests.tiny import TINY_MODEL

TEXTS = ["query: what is the quick brown fox", "passage: semantic search, over an index!",
         "a", "Where DOES the lazy dog run? 42 times"]


def tiny(config_name: str, **over) -> tuple[dict, ref.Arch]:
    cfg = dict(load_cell({"e5-small-v2": "encode-e5s-msmarco-passages",
                          "bge-reranker-large": "score-bge-mining-pairs"}[config_name]).config)
    cfg.update(TINY_MODEL, compute_dtype="float32", **over)
    return cfg, ref.arch_from_config(cfg)


def test_tokenizer_matches_the_programs():
    from sskd_tpu_torch.tokenization import get_default_tokenizer

    prog, mine = get_default_tokenizer(), Tokenizer()
    for text in TEXTS:
        assert mine.tokenize(text) == prog.tokenize(text)
    ids, mask = mine.frame(TEXTS, 12)
    want = prog.encode_batch(TEXTS, max_length=12)
    assert (ids == want["input_ids"]).all() and (mask == want["attention_mask"]).all()
    pairs = list(zip(TEXTS, TEXTS[::-1]))
    ids, mask, types = mine.frame_pairs(pairs, 14)
    want = prog.encode_batch([a for a, _ in pairs], [b for _, b in pairs], max_length=14)
    for got, key in ((ids, "input_ids"), (mask, "attention_mask"), (types, "token_type_ids")):
        assert (got == want[key]).all()


def test_bi_encoder_matches_the_programs():
    from sskd_tpu_torch.models.student import StudentModel

    cfg, arch = tiny("e5-small-v2")
    tree = draw_tree(arch, 5, "cpu")
    student = StudentModel("tiny", device="cpu", config=bert_config(cfg), params=tree)
    got = student.encode(TEXTS)
    ids, mask = Tokenizer().frame(TEXTS, 64)
    want = ref.embed(tree, arch, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert np.abs(got - want).max() < 1e-5


def test_cross_encoder_matches_the_programs():
    from sskd_tpu_torch.models.teacher import TeacherModel

    cfg, arch = tiny("bge-reranker-large", vocab_size=512)
    tree = draw_tree(arch, 6, "cpu", cross_encoder=True)
    teacher = TeacherModel("tiny", device="cpu", config=bert_config(cfg), params=tree)
    pairs = list(zip(TEXTS, TEXTS[::-1]))
    got = np.array(teacher.score(pairs, batch_size=2))
    ids, mask, types = Tokenizer().frame_pairs(pairs, 64)
    want = ref.cross_logits(tree, arch, *(torch.from_numpy(a) for a in (ids, mask, types)))
    assert np.abs(got - want.numpy()).max() < 1e-5


def test_quantization_and_topk_match_the_programs():
    from sskd_tpu_torch.ops.quant import quantize_rows
    from sskd_tpu_torch.ops.topk import cosine_topk

    gen = torch.Generator().manual_seed(3)
    rows = torch.randn(2000, 64, generator=gen)
    rows = rows / rows.norm(dim=1, keepdim=True)
    q = torch.randn(5, 64, generator=gen)
    q = q / q.norm(dim=1, keepdim=True)
    values, scales = quantize(rows)
    want_v, want_s = quantize_rows(rows)
    assert torch.equal(values, want_v.float()) and torch.equal(scales, want_s)
    search = ExactTopK(q, 10, torch.zeros((5, 1), dtype=torch.int64))
    for lo in range(0, 2000, 700):  # in blocks, as the reference sweeps
        search.add_block(lo, values[lo:lo + 700], scales[lo:lo + 700])
    vals, idx = cosine_topk(q, want_v, 10, row_scales=want_s)
    assert torch.equal(search.best_ids, idx.long())
    assert torch.allclose(search.best, vals, rtol=1e-6, atol=1e-7)


def test_keep_mask_matches_the_programs():
    from sskd_tpu_torch.ops.attention import dropout_keep_mask

    for seed, heads, length in ((123, 6, 37), (2**31 - 5, 3, 64)):
        assert torch.equal(keep_mask(seed, heads, length, 0.1),
                           dropout_keep_mask(seed, heads, length, 0.1))


def test_kd_loss_matches_the_programs():
    from sskd_tpu_torch.kd.losses import combined_kd_loss

    gen = torch.Generator().manual_seed(4)
    s, t = torch.randn(6, 8, generator=gen), 3 * torch.randn(6, 8, generator=gen)
    mask = torch.ones(6, 8)
    mask[5] = 0
    mask[2, 6:] = 0
    got = combined_kd_loss(s, t, mask, temperature=3.0)
    want = kd_loss(s, t, mask, 3.0, (0.6, 0.2, 0.2), 0.05)
    for key in ("loss", "margin_mse", "listwise_kd", "contrastive"):
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-6)


def test_adamw_matches_the_programs():
    from sskd_tpu_torch.config import TrainingConfig
    from sskd_tpu_torch.kd.train import KDOptimizer

    gen = torch.Generator().manual_seed(8)
    p_prog = [torch.randn(7, 3, generator=gen, requires_grad=True) for _ in range(2)]
    p_ref = {str(i): p.detach().clone() for i, p in enumerate(p_prog)}
    cfg = TrainingConfig(learning_rate=1e-2, warmup_ratio=0.1, max_grad_norm=1.0,
                         weight_decay=0.01)
    opt = KDOptimizer(p_prog, cfg, total_steps=40)
    mine = AdamW(p_ref, 1e-2, 0.01, 1.0, warmup=4)
    for step in range(3):
        grads = [torch.randn(7, 3, generator=gen) * (5.0 if step == 1 else 0.1)
                 for _ in range(2)]
        opt.begin()
        for p, g in zip(p_prog, grads):
            p.grad = g.clone()
        opt.step()
        mine.step({str(i): g for i, g in enumerate(grads)})
    for i, p in enumerate(p_prog):
        assert torch.allclose(p.detach(), p_ref[str(i)], rtol=1e-6, atol=1e-7)
