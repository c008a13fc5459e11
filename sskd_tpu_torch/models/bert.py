"""BERT-family encoder as torch modules (port of sskd_tpu/models/bert.py).

One backbone for the bi-encoder student (e5-small-v2 class, :class:`BiEncoder`)
and the cross-encoder teacher (XLM-RoBERTa class, :class:`CrossEncoder`).
Module and parameter names follow the Flax tree (``word_embeddings``,
``layers.{i}.attention.query``, ``pooler``, ...), so
:mod:`sskd_tpu_torch.models.weights` maps one onto the other by name.

Details kept from the JAX package: erf GELU; an additive attention bias of
``(1 - mask) * finfo(compute_dtype).min / 2``; BERT position ids (0..L-1) or
RoBERTa ones (cumulative over non-pad tokens, offset by the pad id); token
types clipped into the type vocabulary; mean pooling over the mask, then an
f32 L2 normalisation.

Parameters stay f32; each op casts to ``config.compute_dtype`` as Flax's
``dtype=`` does: :class:`Linear` and :class:`Embedding` use the weights
rounded to the compute type, :class:`LayerNorm` takes its statistics in f32
and returns the compute type. (``torch.autocast`` would return f32 from the
normalisation, which is not what Flax computes.) With gradients off the
rounded weights are cached until the parameter changes.

Training (``module.train()`` and a ``dropout_seed``) turns on dropout: on the embeddings, on each
attention output and FFN output (hidden dropout), and on the attention
probabilities through :func:`~sskd_tpu_torch.ops.attention.dropout_attention`
(the ``dropattn`` kernels). Every mask is a function of ``dropout_seed``: the
encoder draws each layer's seeds from it before the layers run and passes
them in, so a layer recomputed under ``torch.utils.checkpoint`` (``remat``)
draws the same masks again.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from sskd_tpu_torch.exceptions import ConfigError
from sskd_tpu_torch.ops.attention import dropout_attention, scaled_dot_attention


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


class _Cast:
    """Parameter casts to the compute type, cached while gradients are off
    (keyed by the tensor's storage and version, so an in-place update or a
    move to another device makes a new copy)."""

    compute_dtype: torch.dtype

    def _cast(self, name: str) -> torch.Tensor:
        t = getattr(self, name)
        if t is None or t.dtype == self.compute_dtype:
            return t
        if torch.is_grad_enabled():
            return t.to(self.compute_dtype)
        key = (t.data_ptr(), t._version, self.compute_dtype)
        hit = self._casts.get(name)
        if hit is None or hit[0] != key:
            hit = (key, t.to(self.compute_dtype))
            self._casts[name] = hit
        return hit[1]


def release_casts(module: nn.Module, device: torch.device) -> None:
    """Drop the cached casts of every layer of ``module`` and, on CUDA, the
    caching allocator's unused blocks (a model's ``cleanup``)."""
    for layer in module.modules():
        if isinstance(layer, _Cast):
            layer._casts.clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class Linear(_Cast, nn.Linear):
    """``nn.Dense(dtype=compute_dtype)``: f32 parameters, the product in the
    compute type."""

    def __init__(self, in_features: int, out_features: int, compute_dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype
        self._casts: dict = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.compute_dtype), self._cast("weight"), self._cast("bias"))


class Embedding(_Cast, nn.Embedding):
    """``nn.Embed(dtype=compute_dtype)``: gathers from the cast table."""

    def __init__(self, num: int, dim: int, compute_dtype: torch.dtype):
        super().__init__(num, dim)
        self.compute_dtype = compute_dtype
        self._casts: dict = {}

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self._cast("weight"))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm(dtype=compute_dtype)``: statistics, scale and shift in
    f32, the result in the compute type."""

    def __init__(self, dim: int, eps: float, compute_dtype: torch.dtype):
        super().__init__(dim, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


def dropout(x: torch.Tensor, p: float, seed: int | None) -> torch.Tensor:
    """``nn.Dropout(p)``: keep with probability 1 - p, kept values divided by
    1 - p; the mask is drawn from a generator seeded with ``seed``, so the
    same seed draws it again (``seed`` None or ``p`` 0: identity)."""
    if seed is None or p == 0.0:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed))
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.attention_dropout = cfg.attention_dropout
        self.hidden_dropout = cfg.hidden_dropout
        h, cd = cfg.hidden_size, cfg.compute_dtype
        self.query = Linear(h, h, cd)
        self.key = Linear(h, h, cd)
        self.value = Linear(h, h, cd)
        self.output = Linear(h, h, cd)

    def forward(self, hidden, attn_bias, seeds=None) -> torch.Tensor:
        """``seeds``: (attention-dropout seed, output-dropout seed) in
        training, None otherwise."""
        B, L, _ = hidden.shape

        def split_heads(x):
            return x.view(B, L, self.num_heads, -1).transpose(1, 2)

        q = split_heads(self.query(hidden))
        k = split_heads(self.key(hidden))
        v = split_heads(self.value(hidden))
        if seeds is not None and self.attention_dropout > 0.0:
            ctx = dropout_attention(q, k, v, attn_bias[:, 0, 0, :], self.attention_dropout,
                                    seeds[0])
        else:
            ctx = scaled_dot_attention(q, k, v, attn_bias)
        out = self.output(ctx.transpose(1, 2).reshape(B, L, -1))
        return dropout(out, self.hidden_dropout, None if seeds is None else seeds[1])


class TransformerLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        cd = cfg.compute_dtype
        self.hidden_dropout = cfg.hidden_dropout
        self.attention = SelfAttention(cfg)
        self.attention_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cd)
        self.intermediate = Linear(cfg.hidden_size, cfg.intermediate_size, cd)
        self.ffn_output = Linear(cfg.intermediate_size, cfg.hidden_size, cd)
        self.ffn_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cd)

    def forward(self, hidden, attn_bias, seeds=None) -> torch.Tensor:
        """``seeds``: three dropout seeds (attention probabilities, attention
        output, FFN output) in training, None otherwise."""
        attn_seeds = None if seeds is None else seeds[:2]
        hidden = self.attention_norm(hidden + self.attention(hidden, attn_bias, attn_seeds))
        ff = dropout(self.ffn(hidden), self.hidden_dropout, None if seeds is None else seeds[2])
        return self.ffn_norm(hidden + ff)

    def ffn(self, hidden) -> torch.Tensor:
        """The FFN's two products, before dropout, residual and norm."""
        return self.ffn_output(F.gelu(self.intermediate(hidden), approximate="none"))


# matrix products kept by remat policy "dots" (jax.checkpoint_policies
# .checkpoint_dots); everything else in the layer is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = ("full", "dots")


class BertEncoder(nn.Module):
    """Token ids -> contextual hidden states ``[B, L, H]``.

    ``remat`` (None, ``"full"`` or ``"dots"``) recomputes each layer in the
    backward (``torch.utils.checkpoint``, non-reentrant) when gradients are
    on: ``"full"`` keeps only the layer's input, ``"dots"`` also keeps the
    outputs of its matrix products."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        cd = cfg.compute_dtype
        self.remat: str | None = None
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size, cd)
        self.position_embeddings = Embedding(cfg.max_position_embeddings, cfg.hidden_size, cd)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size, cfg.hidden_size, cd)
        self.embeddings_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cd)
        self.layers = nn.ModuleList(TransformerLayer(cfg) for _ in range(cfg.num_layers))

    def position_ids(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if cfg.position_style == "roberta":
            mask = attention_mask.to(torch.int64)
            return torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id
        L = input_ids.shape[1]
        return torch.arange(L, device=input_ids.device)[None, :].expand_as(input_ids)

    def dropout_seeds(self, dropout_seed: int) -> list[int]:
        """The embedding-dropout seed, then three seeds per layer, drawn on
        the host from ``dropout_seed``."""
        gen = torch.Generator().manual_seed(int(dropout_seed))
        n = 1 + 3 * self.config.num_layers
        return torch.randint(0, 2**31 - 1, (n,), generator=gen).tolist()

    def _run_layer(self, layer, hidden, attn_bias, seeds):
        if self.remat is None or not torch.is_grad_enabled():
            return layer(hidden, attn_bias, seeds)
        if self.remat not in REMAT_POLICIES:
            raise ConfigError(f"remat policy must be one of {REMAT_POLICIES}, got {self.remat!r}")
        kw = {}
        if self.remat == "dots":
            kw["context_fn"] = partial(create_selective_checkpoint_contexts, _save_dots)
        return checkpoint(layer, hidden, attn_bias, seeds, use_reentrant=False,
                          preserve_rng_state=False, **kw)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                dropout_seed: int | None = None) -> torch.Tensor:
        """Dropout is on in training mode when a ``dropout_seed`` is given
        (the masks come from it, ``deterministic=False`` in the JAX
        package); without a seed, or in eval mode, the forward is
        deterministic."""
        cfg = self.config
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        seeds = None
        if self.training and dropout_seed is not None:
            seeds = self.dropout_seeds(dropout_seed)
        hidden = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(self.position_ids(input_ids, attention_mask))
            + self.token_type_embeddings(token_type_ids.clamp(0, cfg.type_vocab_size - 1))
        )
        hidden = self.embeddings_norm(hidden)
        hidden = dropout(hidden, cfg.hidden_dropout, None if seeds is None else seeds[0])
        dtype = hidden.dtype
        # additive attention bias: 0 where attended, finfo.min / 2 at padding
        attn_bias = (1.0 - attention_mask[:, None, None, :].to(dtype)) * (
            torch.finfo(dtype).min / 2
        )
        for i, layer in enumerate(self.layers):
            layer_seeds = None if seeds is None else tuple(seeds[1 + 3 * i : 4 + 3 * i])
            hidden = self._run_layer(layer, hidden, attn_bias, layer_seeds)
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
    norm. Output ``[B, H]`` f32 embeddings. Parameters are f32; the encoder
    computes in ``config.compute_dtype``."""

    def __init__(self, config: BertConfig, normalize: bool = True, pooling: str = "mean"):
        super().__init__()
        if pooling not in ("mean", "cls"):
            raise ValueError(f"pooling must be 'mean' or 'cls', got {pooling!r}")
        self.config = config
        self.normalize = normalize
        self.pooling = pooling
        self.encoder = BertEncoder(config)

    def forward(self, input_ids, attention_mask, token_type_ids=None,
                dropout_seed: int | None = None) -> torch.Tensor:
        hidden = self.encoder(input_ids, attention_mask, token_type_ids, dropout_seed)
        emb = hidden[:, 0, :] if self.pooling == "cls" else mean_pool(hidden, attention_mask)
        emb = emb.to(torch.float32)
        return l2_normalize(emb) if self.normalize else emb


class CrossEncoder(nn.Module):
    """Teacher tower: encoder -> the CLS row -> ``pooler`` dense layer in the
    compute type -> tanh -> f32 -> ``classifier`` dense layer to one output
    in f32 (the XLM-R classification head). Output ``[B]`` f32 relevance
    logits. Parameters are f32; the encoder and the pooler compute in
    ``config.compute_dtype``."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.encoder = BertEncoder(config)
        self.pooler = Linear(config.hidden_size, config.hidden_size, config.compute_dtype)
        self.classifier = Linear(config.hidden_size, 1, torch.float32)

    def forward(self, input_ids, attention_mask, token_type_ids=None,
                dropout_seed: int | None = None) -> torch.Tensor:
        hidden = self.encoder(input_ids, attention_mask, token_type_ids, dropout_seed)
        pooled = torch.tanh(self.pooler(hidden[:, 0, :]))
        return self.classifier(pooled.to(torch.float32))[:, 0]
