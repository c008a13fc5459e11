"""What the entries share to drive the program: its configuration object
from a configuration file, the shapes to warm up, the texts' token counts
as the program's input arrays hold them, and the sample to compare."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.tokenizer import Tokenizer

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOK: Tokenizer | None = None


def tokenizer() -> Tokenizer:
    global _TOK
    if _TOK is None:
        _TOK = Tokenizer()
    return _TOK


def prefix_tokens(prefix: str) -> int:
    return len(tokenizer().tokenize(prefix))


def bert_config(cfg: dict):
    """The program's ``BertConfig`` for a configuration file."""
    from sskd_tpu_torch.models.bert import BertConfig

    roberta = cfg["model_type"] == "xlm-roberta"
    return BertConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg["max_position_embeddings"],
        type_vocab_size=cfg["type_vocab_size"],
        layer_norm_eps=cfg["layer_norm_eps"],
        hidden_dropout=cfg["hidden_dropout_prob"],
        attention_dropout=cfg["attention_probs_dropout_prob"],
        pad_token_id=cfg["pad_token_id"],
        position_style="roberta" if roberta else "bert",
        compute_dtype=DTYPES[cfg["compute_dtype"]],
    )


def forward_describe(batch, *args, **kwargs):
    """A :meth:`Recorder.wrap` describer for ``forward_batch(batch)``: the
    range ``forward B=<rows> L=<length>``, and the shape, real tokens and
    each row's length of the arrays handed over."""
    mask = batch["attention_mask"]
    B, L = mask.shape
    lengths = mask.sum(axis=1)
    return f"forward B={B} L={L}", {"B": B, "L": L, "real": int(lengths.sum()),
                                    "lengths": lengths}


def warm_lengths(real: np.ndarray, batch: int, max_len: int, device) -> list[int]:
    """One real length for each length bucket that a batch of ``batch``
    texts of the lengths ``real`` can pad to: the bucket of its longest,
    which is at least the ``batch``-th shortest length."""
    from sskd_tpu_torch.models.student import bucket_length

    dev = torch.device(device)
    lowest = bucket_length(int(np.sort(real)[batch - 1]), max_len, dev)
    first = {}
    for n in np.unique(real).tolist():
        first.setdefault(bucket_length(n, max_len, dev), n)
    return [n for b, n in sorted(first.items()) if b >= lowest]


def sample(done: np.ndarray, real: np.ndarray, n: int, longest: int, seed: int) -> list[int]:
    """``n`` of the ``done`` positions drawn from ``seed``, and the
    ``longest`` of them by ``real`` length."""
    from benchmark.harness.weights import sub_seed

    rng = np.random.default_rng(sub_seed(seed, 5))
    picked = set(rng.choice(done, min(n, len(done)), replace=False).tolist())
    picked.update(done[np.argsort(-real[done], kind="stable")][:longest].tolist())
    return sorted(picked)
