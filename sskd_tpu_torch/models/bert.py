"""BERT-family encoder as torch modules (port of sskd_tpu/models/bert.py).

One backbone for the bi-encoder student (e5-small-v2 class) and, later, the
cross-encoder teacher (XLM-RoBERTa class). Module and parameter names follow
the Flax tree (``word_embeddings``, ``layers.{i}.attention.query``, ...), so
:mod:`sskd_tpu_torch.models.weights` maps one onto the other by name.

Details kept from the JAX package: erf GELU; an additive attention bias of
``(1 - mask) * finfo(compute_dtype).min / 2``; BERT position ids (0..L-1) or
RoBERTa ones (cumulative over non-pad tokens, offset by the pad id); token
types clipped into the type vocabulary; mean pooling over the mask, then an
f32 L2 normalisation. The modules run inference only: dropout and the
training attention kernels are a later slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from sskd_tpu_torch.ops.attention import scaled_dot_attention


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    pad_token_id: int = 0
    position_style: str = "bert"  # "bert" | "roberta"
    compute_dtype: torch.dtype = field(default=torch.float32)

    @classmethod
    def e5_small_v2(cls, **kw) -> "BertConfig":
        """intfloat/e5-small-v2: 12 layers, hidden 384, 12 heads, FFN 1536."""
        return cls(
            vocab_size=30522,
            hidden_size=384,
            num_layers=12,
            num_heads=12,
            intermediate_size=1536,
            max_position_embeddings=512,
            type_vocab_size=2,
            position_style="bert",
            **kw,
        )

    @classmethod
    def bge_reranker_large(cls, **kw) -> "BertConfig":
        """BAAI/bge-reranker-large: XLM-RoBERTa-large cross-encoder."""
        return cls(
            vocab_size=250002,
            hidden_size=1024,
            num_layers=24,
            num_heads=16,
            intermediate_size=4096,
            max_position_embeddings=514,
            type_vocab_size=1,
            layer_norm_eps=1e-5,
            pad_token_id=1,
            position_style="roberta",
            **kw,
        )

    @classmethod
    def tiny(cls, vocab_size: int = 2048, **kw) -> "BertConfig":
        """Small config for tests (2 layers, hidden 64)."""
        return cls(
            vocab_size=vocab_size,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            intermediate_size=128,
            max_position_embeddings=512,
            **kw,
        )

    @classmethod
    def demo_teacher(cls, vocab_size: int = 2048, **kw) -> "BertConfig":
        """Demo-scale teacher: 4 layers, hidden 128."""
        return cls(
            vocab_size=vocab_size,
            hidden_size=128,
            num_layers=4,
            num_heads=4,
            intermediate_size=512,
            max_position_embeddings=512,
            **kw,
        )


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        h = cfg.hidden_size
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.output = nn.Linear(h, h)

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        B, L, H = hidden.shape
        hd = H // self.num_heads

        def split_heads(x):
            return x.view(B, L, self.num_heads, hd).transpose(1, 2)

        q = split_heads(self.query(hidden))
        k = split_heads(self.key(hidden))
        v = split_heads(self.value(hidden))
        ctx = scaled_dot_attention(q, k, v, attn_bias)
        return self.output(ctx.transpose(1, 2).reshape(B, L, H))


class TransformerLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = SelfAttention(cfg)
        self.attention_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.ffn_output = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.ffn_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        hidden = self.attention_norm(hidden + self.attention(hidden, attn_bias))
        ff = self.ffn_output(F.gelu(self.intermediate(hidden), approximate="none"))
        return self.ffn_norm(hidden + ff)


class BertEncoder(nn.Module):
    """Token ids -> contextual hidden states ``[B, L, H]``."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.embeddings_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(TransformerLayer(cfg) for _ in range(cfg.num_layers))

    def position_ids(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if cfg.position_style == "roberta":
            mask = attention_mask.to(torch.int64)
            return torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id
        L = input_ids.shape[1]
        return torch.arange(L, device=input_ids.device)[None, :].expand_as(input_ids)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None) -> torch.Tensor:
        cfg = self.config
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        hidden = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(self.position_ids(input_ids, attention_mask))
            + self.token_type_embeddings(token_type_ids.clamp(0, cfg.type_vocab_size - 1))
        )
        hidden = self.embeddings_norm(hidden)
        dtype = hidden.dtype
        # additive attention bias: 0 where attended, finfo.min / 2 at padding
        attn_bias = (1.0 - attention_mask[:, None, None, :].to(dtype)) * (
            torch.finfo(dtype).min / 2
        )
        for layer in self.layers:
            hidden = layer(hidden, attn_bias)
        return hidden


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the sequence axis."""
    mask = attention_mask[:, :, None].to(hidden.dtype)
    summed = (hidden * mask).sum(dim=1)
    counts = mask.sum(dim=1).clamp(min=1e-9)
    return summed / counts


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=eps)


class BiEncoder(nn.Module):
    """Student tower: encoder -> mean or CLS pooling -> f32 -> optional L2
    norm. Output ``[B, H]`` f32 embeddings. The module computes in the type
    of its parameters (``module.to(dtype)``)."""

    def __init__(self, config: BertConfig, normalize: bool = True, pooling: str = "mean"):
        super().__init__()
        if pooling not in ("mean", "cls"):
            raise ValueError(f"pooling must be 'mean' or 'cls', got {pooling!r}")
        self.config = config
        self.normalize = normalize
        self.pooling = pooling
        self.encoder = BertEncoder(config)

    def forward(self, input_ids, attention_mask, token_type_ids=None) -> torch.Tensor:
        hidden = self.encoder(input_ids, attention_mask, token_type_ids)
        emb = hidden[:, 0, :] if self.pooling == "cls" else mean_pool(hidden, attention_mask)
        emb = emb.to(torch.float32)
        return l2_normalize(emb) if self.normalize else emb
