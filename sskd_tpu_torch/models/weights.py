"""Carry BiEncoder and CrossEncoder weights between the Flax parameter
layout and the port.

The JAX package keeps parameters as a Flax tree: ``Dense`` kernels
``[in, out]`` with a ``bias``, ``LayerNorm`` ``scale`` / ``bias``, ``Embed``
``embedding`` tables. :func:`bi_encoder_from_jax_params` turns such a tree of
numpy arrays into a ``state_dict`` of :class:`~sskd_tpu_torch.models.bert.
BiEncoder` (``Linear.weight`` is ``[out, in]``, so kernels are transposed),
:func:`cross_encoder_from_jax_params` one of :class:`~sskd_tpu_torch.models.
bert.CrossEncoder` (the encoder, then the ``pooler`` and ``classifier``
head); :func:`jax_params_from_bi_encoder` turns a BiEncoder's state_dict
back into the Flax tree (the export writes it). The port reads no msgpack
and no Flax: callers hand it numpy arrays.

:func:`random_jax_params` draws a Flax-layout tree with the initializers Flax
applies by default (``lecun_normal`` for Dense kernels, ``variance_scaling(1,
fan_in, normal)`` for Embed tables, ones and zeros for LayerNorm, zero
biases) from a numpy seed, with the cross-encoder's two head layers when
asked. It is how the port makes the seeded random weights the JAX package
serves when a model has no weights on disk (sskd_tpu/models/student.py:114-130,
sskd_tpu/models/teacher.py:66-80). The distributions match; the numbers do
not, as JAX's random bits differ from numpy's.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from sskd_tpu_torch.exceptions import ModelLoadError, WeightConversionError
from sskd_tpu_torch.models.bert import BertConfig
from sskd_tpu_torch.models.convert import read_flax_msgpack

_LINEAR_NAMES = ("query", "key", "value", "output")


def _tree(params: Mapping) -> Mapping:
    """Accept ``{"params": {"encoder": ...}}`` or ``{"encoder": ...}``."""
    return params["params"] if "params" in params else params


def _t(x) -> torch.Tensor:
    """numpy array, or a torch tensor (bf16 from a Flax checkpoint), -> f32."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(sd: dict, prefix: str, node: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(node["kernel"]).T.contiguous()
    sd[f"{prefix}.bias"] = _t(node["bias"])


def bi_encoder_from_jax_params(params: Mapping, config: BertConfig) -> dict[str, torch.Tensor]:
    """Flax BiEncoder parameter tree (numpy arrays) -> BiEncoder state_dict (f32)."""
    enc = _tree(params)["encoder"]
    sd: dict[str, torch.Tensor] = {}

    def norm(prefix: str, node: Mapping) -> None:
        sd[f"{prefix}.weight"] = _t(node["scale"])
        sd[f"{prefix}.bias"] = _t(node["bias"])

    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"encoder.{name}.weight"] = _t(enc[name]["embedding"])
    norm("encoder.embeddings_norm", enc["embeddings_norm"])
    for i in range(config.num_layers):
        layer = enc[f"layer_{i}"]
        pre = f"encoder.layers.{i}"
        for name in _LINEAR_NAMES:
            _dense(sd, f"{pre}.attention.{name}", layer["attention"][name])
        norm(f"{pre}.attention_norm", layer["attention_norm"])
        _dense(sd, f"{pre}.intermediate", layer["intermediate"])
        _dense(sd, f"{pre}.ffn_output", layer["ffn_output"])
        norm(f"{pre}.ffn_norm", layer["ffn_norm"])
    return sd


def jax_params_from_bi_encoder(state: Mapping, config: BertConfig) -> dict:
    """BiEncoder state_dict -> the Flax BiEncoder tree ``{"params":
    {"encoder": ...}}`` of f32 numpy arrays, kernels ``[in, out]``: the
    inverse of :func:`bi_encoder_from_jax_params`."""

    def a(name: str) -> np.ndarray:
        return state[name].detach().to("cpu", torch.float32).numpy().copy()

    def dense(prefix: str) -> dict:
        return {"kernel": np.ascontiguousarray(a(f"{prefix}.weight").T),
                "bias": a(f"{prefix}.bias")}

    def norm(prefix: str) -> dict:
        return {"scale": a(f"{prefix}.weight"), "bias": a(f"{prefix}.bias")}

    enc: dict = {name: {"embedding": a(f"encoder.{name}.weight")}
                 for name in ("word_embeddings", "position_embeddings", "token_type_embeddings")}
    enc["embeddings_norm"] = norm("encoder.embeddings_norm")
    for i in range(config.num_layers):
        pre = f"encoder.layers.{i}"
        enc[f"layer_{i}"] = {
            "attention": {name: dense(f"{pre}.attention.{name}") for name in _LINEAR_NAMES},
            "attention_norm": norm(f"{pre}.attention_norm"),
            "intermediate": dense(f"{pre}.intermediate"),
            "ffn_output": dense(f"{pre}.ffn_output"),
            "ffn_norm": norm(f"{pre}.ffn_norm"),
        }
    return {"params": {"encoder": enc}}


def cross_encoder_from_jax_params(params: Mapping,
                                  config: BertConfig) -> dict[str, torch.Tensor]:
    """Flax CrossEncoder parameter tree (numpy arrays: ``encoder``,
    ``pooler``, ``classifier``) -> CrossEncoder state_dict (f32)."""
    tree = _tree(params)
    sd = bi_encoder_from_jax_params(tree, config)
    _dense(sd, "pooler", tree["pooler"])
    _dense(sd, "classifier", tree["classifier"])
    return sd


def checkpoint_state(path: Path, config: BertConfig,
                     cross_encoder: bool = False) -> dict[str, torch.Tensor]:
    """The state_dict of a checkpoint directory: ``weights.pt`` (the port's
    format) when it is there, else ``params.msgpack`` (the JAX package's,
    carried over by :func:`bi_encoder_from_jax_params` or, with
    ``cross_encoder``, :func:`cross_encoder_from_jax_params`). Raises
    :class:`ModelLoadError` for a file it cannot read and
    :class:`WeightConversionError` for a Flax tree that lacks a weight."""
    pt = path / "weights.pt"
    if pt.exists():
        try:
            return torch.load(pt, map_location="cpu", weights_only=True)
        # a truncated or foreign file (read on the CPU, so no device error)
        except (RuntimeError, EOFError, ValueError, pickle.UnpicklingError) as e:
            raise ModelLoadError(f"cannot read {pt}: {e}") from e
    tree = read_flax_msgpack(path / "params.msgpack")
    convert = cross_encoder_from_jax_params if cross_encoder else bi_encoder_from_jax_params
    try:
        return convert(tree, config)
    except (KeyError, TypeError) as e:
        raise WeightConversionError(f"{path / 'params.msgpack'} lacks a weight: {e}") from e


def random_jax_params(config: BertConfig, seed: int = 0, cross_encoder: bool = False) -> dict:
    """A Flax-layout BiEncoder parameter tree drawn with Flax's default
    initializers from ``numpy.random.default_rng(seed)``; with
    ``cross_encoder`` also the CrossEncoder's ``pooler`` ([H, H]) and
    ``classifier`` ([H, 1]) Dense layers, drawn after the encoder, so the
    encoder's numbers do not depend on the head."""
    rng = np.random.default_rng(seed)
    H, inter = config.hidden_size, config.intermediate_size

    def lecun_normal(fan_in: int, fan_out: int) -> np.ndarray:
        # variance_scaling(1, "fan_in", "truncated_normal"): N(0, 1) cut at
        # +-2, scaled so the variance is 1 / fan_in
        std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
        out = rng.standard_normal((fan_in, fan_out))
        bad = np.abs(out) > 2
        while bad.any():
            out[bad] = rng.standard_normal(int(bad.sum()))
            bad = np.abs(out) > 2
        return (out * std).astype(np.float32)

    def dense(fan_in: int, fan_out: int) -> dict:
        return {"kernel": lecun_normal(fan_in, fan_out), "bias": np.zeros(fan_out, np.float32)}

    def embed(n: int) -> dict:
        return {"embedding": (rng.standard_normal((n, H)) / np.sqrt(H)).astype(np.float32)}

    def norm() -> dict:
        return {"scale": np.ones(H, np.float32), "bias": np.zeros(H, np.float32)}

    enc = {
        "word_embeddings": embed(config.vocab_size),
        "position_embeddings": embed(config.max_position_embeddings),
        "token_type_embeddings": embed(config.type_vocab_size),
        "embeddings_norm": norm(),
    }
    for i in range(config.num_layers):
        enc[f"layer_{i}"] = {
            "attention": {name: dense(H, H) for name in _LINEAR_NAMES},
            "attention_norm": norm(),
            "intermediate": dense(H, inter),
            "ffn_output": dense(inter, H),
            "ffn_norm": norm(),
        }
    tree = {"encoder": enc}
    if cross_encoder:
        tree["pooler"] = dense(H, H)
        tree["classifier"] = dense(H, 1)
    return {"params": tree}
