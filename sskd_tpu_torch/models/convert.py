"""Hugging Face checkpoint -> Flax-layout parameter tree (port of
sskd_tpu/models/convert.py).

The converter maps an HF ``state_dict`` onto the same Flax-layout tree of
numpy arrays that the JAX package builds (``{"params": {"encoder": ...,
"pooler": ..., "classifier": ...}}``, ``Dense`` kernels ``[in, out]``), which
:mod:`sskd_tpu_torch.models.weights` then carries into the port's modules.
Supported source layouts, as in the JAX package:

- BERT encoders (e5-small-v2 family): ``bert.`` / bare ``encoder.layer`` keys;
- XLM-RoBERTa sequence classifiers (bge-reranker-large family): ``roberta.``
  keys with a ``classifier.dense`` / ``classifier.out_proj`` head, or a
  BERT-style ``pooler.dense`` / ``classifier`` head.

Checkpoint files: ``pytorch_model.bin`` through ``torch.load(weights_only=
True)``, and ``model.safetensors`` through :func:`read_safetensors`, a reader
of the port's own (the machine with the GPU has no ``safetensors`` package):
an 8-byte little-endian header length, a JSON header, then the raw
little-endian buffers. bf16 tensors come back as their ``uint16`` bits, which
the converter widens to f32 (exactly: a bf16 value is the top half of an f32
one).
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from sskd_tpu_torch.exceptions import WeightConversionError
from sskd_tpu_torch.models.bert import BertConfig

# safetensors dtype names -> numpy little-endian types (BF16 as its bits)
_ST_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2",
    "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
    "U64": "<u8", "U32": "<u4", "U16": "<u2", "U8": "u1", "BOOL": "?",
}


def _t(x) -> np.ndarray:
    """torch tensor or numpy array -> numpy, bf16 widened to f32 (from a
    torch tensor, or its uint16 bits from :func:`read_safetensors`: no
    weight is stored as uint16 otherwise)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return (x.astype(np.uint32) << 16).view(np.float32) if x.dtype == np.uint16 else x


def _strip_prefix(sd: Mapping[str, object]) -> dict[str, np.ndarray]:
    """Normalize key prefixes: drop a leading 'bert.', 'roberta.' or 'model.'."""
    out = {}
    for key, value in sd.items():
        for prefix in ("bert.", "roberta.", "model."):
            if key.startswith(prefix):
                key = key[len(prefix) :]
                break
        out[key] = _t(value)
    return out


def hf_config_to_bert_config(hf_cfg: dict, compute_dtype: torch.dtype | None = None) -> BertConfig:
    """Map an HF ``config.json`` dict onto :class:`BertConfig`."""
    model_type = hf_cfg.get("model_type", "bert")
    return BertConfig(
        vocab_size=hf_cfg["vocab_size"],
        hidden_size=hf_cfg["hidden_size"],
        num_layers=hf_cfg["num_hidden_layers"],
        num_heads=hf_cfg["num_attention_heads"],
        intermediate_size=hf_cfg["intermediate_size"],
        max_position_embeddings=hf_cfg["max_position_embeddings"],
        type_vocab_size=hf_cfg.get("type_vocab_size", 2),
        layer_norm_eps=hf_cfg.get("layer_norm_eps", 1e-12),
        pad_token_id=hf_cfg.get("pad_token_id", 0),
        position_style="roberta" if "roberta" in model_type else "bert",
        compute_dtype=compute_dtype or torch.float32,
    )


def convert_encoder_params(state_dict: Mapping[str, object], config: BertConfig) -> dict:
    """HF encoder state_dict -> the Flax ``encoder`` subtree (numpy)."""
    sd = _strip_prefix(state_dict)

    def req(key: str) -> np.ndarray:
        if key not in sd:
            raise WeightConversionError(f"missing weight {key!r}")
        return sd[key]

    def dense(prefix: str) -> dict:
        # torch [out, in] -> flax [in, out]
        return {"kernel": req(f"{prefix}.weight").T, "bias": req(f"{prefix}.bias")}

    def norm(prefix: str) -> dict:
        return {"scale": req(f"{prefix}.weight"), "bias": req(f"{prefix}.bias")}

    types = "embeddings.token_type_embeddings.weight"
    params = {
        "word_embeddings": {"embedding": req("embeddings.word_embeddings.weight")},
        "position_embeddings": {"embedding": req("embeddings.position_embeddings.weight")},
        "token_type_embeddings": {
            "embedding": req(types) if types in sd
            else np.zeros((config.type_vocab_size, config.hidden_size), np.float32)
        },
        "embeddings_norm": norm("embeddings.LayerNorm"),
    }
    for i in range(config.num_layers):
        base = f"encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "attention": {
                "query": dense(f"{base}.attention.self.query"),
                "key": dense(f"{base}.attention.self.key"),
                "value": dense(f"{base}.attention.self.value"),
                "output": dense(f"{base}.attention.output.dense"),
            },
            "attention_norm": norm(f"{base}.attention.output.LayerNorm"),
            "intermediate": dense(f"{base}.intermediate.dense"),
            "ffn_output": dense(f"{base}.output.dense"),
            "ffn_norm": norm(f"{base}.output.LayerNorm"),
        }
    return params


def convert_cross_encoder(state_dict, config: BertConfig) -> dict:
    """Full parameter tree of the CrossEncoder (teacher). Head mapping:
    XLM-R ``classifier.dense`` -> ``pooler``, ``classifier.out_proj`` ->
    ``classifier``; a BERT-style ``pooler.dense`` + ``classifier`` also."""
    sd = _strip_prefix(state_dict)
    encoder = convert_encoder_params(state_dict, config)

    def dense_from(*names):
        for name in names:
            if f"{name}.weight" in sd:
                return {"kernel": sd[f"{name}.weight"].T, "bias": sd[f"{name}.bias"]}
        raise WeightConversionError(f"no head weight among {names}")

    return {
        "params": {
            "encoder": encoder,
            "pooler": dense_from("classifier.dense", "pooler.dense"),
            "classifier": dense_from("classifier.out_proj", "classifier"),
        }
    }


def read_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file as a numpy array, BF16 as its
    ``uint16`` bits. Raises :class:`WeightConversionError` for a malformed
    file."""
    raw = Path(path).read_bytes()
    if len(raw) < 8:
        raise WeightConversionError(f"{path}: not a safetensors file")
    n = int.from_bytes(raw[:8], "little")
    try:
        header = json.loads(raw[8 : 8 + n])
    except (UnicodeDecodeError, ValueError) as e:
        raise WeightConversionError(f"{path}: unreadable safetensors header: {e}") from e
    body = memoryview(raw)[8 + n :]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info.get("dtype"))
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if dtype is None or not 0 <= begin <= end <= len(body):
            raise WeightConversionError(f"{path}: bad entry {name!r}: {info}")
        arr = np.frombuffer(body[begin:end], dtype=dtype)
        if arr.size != int(np.prod(shape, dtype=np.int64)):
            raise WeightConversionError(f"{path}: {name!r} holds {arr.size} values, not {shape}")
        out[name] = arr.reshape(shape).copy()
    return out


def load_hf_checkpoint(model_dir: str | Path) -> tuple[dict, dict]:
    """Read an HF checkpoint directory -> (state_dict, HF config dict), from
    ``model.safetensors`` or ``pytorch_model.bin``."""
    model_dir = Path(model_dir)
    with open(model_dir / "config.json") as f:
        hf_cfg = json.load(f)
    st_path = model_dir / "model.safetensors"
    pt_path = model_dir / "pytorch_model.bin"
    if st_path.exists():
        sd = read_safetensors(st_path)
    elif pt_path.exists():
        try:
            sd = torch.load(pt_path, map_location="cpu", weights_only=True)
        # a truncated or foreign file (read on the CPU, so no device error)
        except (RuntimeError, EOFError, ValueError, pickle.UnpicklingError) as e:
            raise WeightConversionError(f"cannot read {pt_path}: {e}") from e
    else:
        raise WeightConversionError(f"no weights file in {model_dir}")
    return sd, hf_cfg
