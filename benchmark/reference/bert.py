"""Plain BERT and XLM-RoBERTa encoders in float32.

The architecture as published: token, position and token-type embeddings,
their layer norm; per layer, multi-head self-attention with an additive mask
over padded keys, the output projection, residual and layer norm, then an
erf-GELU feed-forward block, residual and layer norm. Position ids are
``0 .. L - 1`` (BERT) or the running count of real tokens offset by the
padding id (RoBERTa). The bi-encoder mean-pools over real tokens and
normalizes; the cross-encoder takes the first token through a tanh pooler
and a one-output classifier.

Weights are a tree of tensors in the Flax layout (dense kernels ``[in,
out]``). ``precision`` says how every product's inputs and every residual
sum are stored: ``float32`` for the reference; for the controls, a step
below each configuration's dtype, ``tf32`` (a product's inputs rounded to
TF32's 10-bit mantissa) and ``fp8`` (products' inputs and residual sums
scaled per tensor into float8 e4m3, their gradients into e5m2). TF32 matmul
is off, so ``float32`` products are float32.

Training adds dropout as the configuration states it: on the embeddings, on
each attention output and feed-forward output (a uniform draw from a
generator seeded by the layer's seed, on the tensor's device), and on the
attention probabilities (:mod:`keep_mask`), kept values divided by
``1 - p``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from benchmark.reference.keep_mask import keep_mask

NEG = float(torch.finfo(torch.float32).min) / 2
E4M3_MAX = 448.0


@dataclass(frozen=True)
class Arch:
    hidden: int
    layers: int
    heads: int
    intermediate: int
    vocab: int
    positions: int
    type_vocab: int
    eps: float
    pad_id: int
    position_style: str  # "bert" | "roberta"
    hidden_dropout: float
    attention_dropout: float

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


def arch_from_config(cfg: dict) -> Arch:
    """The encoder's sizes from a configuration file's published keys."""
    roberta = cfg["model_type"] == "xlm-roberta"
    return Arch(
        hidden=cfg["hidden_size"], layers=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"], intermediate=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], positions=cfg["max_position_embeddings"],
        type_vocab=cfg["type_vocab_size"], eps=cfg["layer_norm_eps"],
        pad_id=cfg["pad_token_id"], position_style="roberta" if roberta else "bert",
        hidden_dropout=cfg["hidden_dropout_prob"],
        attention_dropout=cfg["attention_probs_dropout_prob"],
    )


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, nearest, ties away)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """float32 scaled by its absolute maximum into float8 and back."""
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).float() * scale


# forward rounding, and the rounding of the gradient that flows back through
# it: float8 e4m3 forward and e5m2 backward, as float8 training takes them
ROUND = {"tf32": (round_tf32, lambda g: g),
         "fp8": (round_fp8, lambda g: round_fp8(g, torch.float8_e5m2))}


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, precision):
        ctx.precision = precision
        return ROUND[precision][0](x)

    @staticmethod
    def backward(ctx, g):
        return ROUND[ctx.precision][1](g), None


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` stored at ``precision``: a product's input, or an activation
    the configuration's dtype would store; its gradient is stored so too."""
    x = x.float()
    if precision == "float32":
        return x
    return _Rounded.apply(x, precision)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return torch.matmul(rounded(a, precision), rounded(b, precision))


def dense(x, node, precision):
    return matmul(x, node["kernel"], precision) + node["bias"].float()


def layer_norm(x, node, eps):
    return F.layer_norm(x, (x.shape[-1],), node["scale"].float(), node["bias"].float(), eps)


def hidden_dropout(x: torch.Tensor, p: float, seed) -> torch.Tensor:
    if seed is None or p == 0.0:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed))
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), device=x.device))


def encode(tree: dict, arch: Arch, ids: torch.Tensor, mask: torch.Tensor,
           types: torch.Tensor | None = None, precision: str = "float32",
           seeds: list[int] | None = None) -> torch.Tensor:
    """Hidden states ``[B, L, hidden]`` (float32). ``seeds``: dropout seeds
    (the embeddings', then three a layer: attention probabilities, attention
    output, feed-forward output); None for inference."""
    enc = tree["encoder"]
    B, L = ids.shape
    if arch.position_style == "roberta":
        pos = torch.cumsum(mask, dim=1) * mask + arch.pad_id
    else:
        pos = torch.arange(L, device=ids.device)[None, :].expand(B, L)
    if types is None:
        types = torch.zeros_like(ids)
    x = (enc["word_embeddings"]["embedding"].float()[ids]
         + enc["position_embeddings"]["embedding"].float()[pos]
         + enc["token_type_embeddings"]["embedding"].float()[types.clamp(0, arch.type_vocab - 1)])
    x = layer_norm(rounded(x, precision), enc["embeddings_norm"], arch.eps)
    x = hidden_dropout(x, arch.hidden_dropout, None if seeds is None else seeds[0])
    bias = (1.0 - mask.float())[:, None, None, :] * NEG
    h, d = arch.heads, arch.head_dim
    for i in range(arch.layers):
        node = enc[f"layer_{i}"]
        att = node["attention"]
        s_att, s_out, s_ffn = (None, None, None) if seeds is None else seeds[1 + 3 * i: 4 + 3 * i]

        def heads(t):
            return t.view(B, L, h, d).transpose(1, 2)

        q, k, v = (heads(dense(x, att[n], precision)) for n in ("query", "key", "value"))
        probs = torch.softmax(matmul(q, k.transpose(-1, -2), precision) / math.sqrt(d) + bias,
                              dim=-1)
        if s_att is not None and arch.attention_dropout > 0.0:
            keep = keep_mask(s_att, B * h, L, arch.attention_dropout, ids.device).view(B, h, L, L)
            probs = torch.where(keep, probs / (1.0 - arch.attention_dropout), 0.0)
        ctx = matmul(probs, v, precision).transpose(1, 2).reshape(B, L, -1)
        out = hidden_dropout(dense(ctx, att["output"], precision), arch.hidden_dropout, s_out)
        x = layer_norm(rounded(x + out, precision), node["attention_norm"], arch.eps)
        ff = dense(F.gelu(dense(x, node["intermediate"], precision)), node["ffn_output"],
                   precision)
        ff = hidden_dropout(ff, arch.hidden_dropout, s_ffn)
        x = layer_norm(rounded(x + ff, precision), node["ffn_norm"], arch.eps)
    return x


def embed(tree, arch, ids, mask, precision="float32", seeds=None) -> torch.Tensor:
    """Mean-pooled, L2-normalized embeddings ``[B, hidden]``."""
    x = encode(tree, arch, ids, mask, precision=precision, seeds=seeds)
    m = mask.float()[:, :, None]
    pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1e-9)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp(min=1e-12)


def cross_logits(tree, arch, ids, mask, types, precision="float32") -> torch.Tensor:
    """The cross-encoder's relevance logits ``[B]``."""
    x = encode(tree, arch, ids, mask, types, precision=precision)
    pooled = torch.tanh(dense(x[:, 0, :], tree["pooler"], precision))
    return dense(pooled, tree["classifier"], precision)[:, 0]
