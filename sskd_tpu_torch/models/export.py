"""Quantized model export (port of sskd_tpu/models/export.py).

The product: the student's checkpoint, and ``weights_int8.npz``, every 2-D
float matrix of at least 8 rows quantized per row (symmetric int8, f32
scales) and every other weight kept in f32, with a parity check that runs
the encoder over the dequantized weights and compares embeddings by cosine.

The weights are written under the JAX package's names and layout: the
port's parameters are turned back into the Flax tree
(:func:`~sskd_tpu_torch.models.weights.jax_params_from_bi_encoder`, each
kernel ``[in, out]``) and quantized with the same numpy arithmetic as
``quantize_param_tree``, so the same weights give the same keys, int8
values and scales as the JAX export, and either package's
``load_quantized_weights`` reads the other's file. The checkpoint is the
port's own (``weights.pt``, not ``params.msgpack``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Mapping

import numpy as np

from sskd_tpu_torch.exceptions import ModelError
from sskd_tpu_torch.models.weights import bi_encoder_from_jax_params, jax_params_from_bi_encoder
from sskd_tpu_torch.utils.logging import get_logger

logger = get_logger("models.export")

_VALIDATION_SENTENCES = [
    "what is machine learning",
    "the capital of france is paris",
    "how do neural networks learn",
    "python is a programming language",
]


def _flatten(tree: Mapping, prefix: str = "") -> list[tuple[str, np.ndarray]]:
    """(``a/b/c`` key, leaf) in the order JAX flattens a dict tree (keys sorted)."""
    out = []
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(tree[key], Mapping):
            out += _flatten(tree[key], path)
        else:
            out.append((path, tree[key]))
    return out


def quantize_param_tree(params: Mapping) -> tuple[dict, dict]:
    """Flatten a Flax-layout tree of numpy arrays; quantize 2-D float
    matrices of at least 8 rows to int8 with per-row scales, keep the rest
    f32. Returns (quantized_flat, meta)."""
    quantized: dict[str, dict] = {}
    total_f32 = 0
    total_int8 = 0
    for key, leaf in _flatten(params):
        arr = np.asarray(leaf)
        total_f32 += arr.nbytes
        if arr.ndim == 2 and arr.dtype in (np.float32, np.float64) and arr.shape[0] >= 8:
            absmax = np.maximum(np.abs(arr).max(axis=1), 1e-9)
            scales = (absmax / 127.0).astype(np.float32)
            values = np.clip(np.round(arr / scales[:, None]), -127, 127).astype(np.int8)
            quantized[key] = {"int8": values, "scales": scales}
            total_int8 += values.nbytes + scales.nbytes
        else:
            quantized[key] = {"f32": arr.astype(np.float32)}
            total_int8 += arr.nbytes
    return quantized, {"bytes_f32": int(total_f32), "bytes_quantized": int(total_int8)}


def dequantize_param_tree(template: Mapping, quantized: dict) -> dict:
    """A tree shaped like ``template`` rebuilt from the quantized flat dict."""

    def rebuild(node: Mapping, prefix: str) -> dict:
        out = {}
        for key, value in node.items():
            path = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(value, Mapping):
                out[key] = rebuild(value, path)
                continue
            entry = quantized[path]
            out[key] = (entry["int8"].astype(np.float32) * entry["scales"][:, None]
                        if "int8" in entry else entry["f32"])
        return out

    return rebuild(template, "")


def export_student_model(
    student,
    output_dir: str | Path,
    quantize: bool = True,
    validate: bool = True,
    min_cosine: float = 0.99,
) -> dict:
    """Write the checkpoint (and the int8 weights) under ``output_dir`` and
    check parity: raises :class:`ModelError` when an embedding of the
    dequantized encoder falls below ``min_cosine`` of the original's."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    ckpt_dir = output_dir / "checkpoint"
    student.save(ckpt_dir)
    report: dict = {"checkpoint": str(ckpt_dir)}

    if quantize:
        params = jax_params_from_bi_encoder(student.module.state_dict(), student.config)
        quantized, meta = quantize_param_tree(params)
        qpath = output_dir / "weights_int8.npz"
        arrays = {f"{key}::{kind}": arr
                  for key, entry in quantized.items() for kind, arr in entry.items()}
        np.savez_compressed(qpath, **arrays)
        report["quantized"] = str(qpath)
        report.update(meta)
        report["compression_ratio"] = round(meta["bytes_f32"] / max(1, meta["bytes_quantized"]), 2)

        if validate:
            ref_emb = student.encode(_VALIDATION_SENTENCES)
            original = {k: v.detach().clone() for k, v in student.module.state_dict().items()}
            try:
                student.module.load_state_dict(bi_encoder_from_jax_params(
                    dequantize_param_tree(params, quantized), student.config))
                q_emb = student.encode(_VALIDATION_SENTENCES)
            finally:
                student.module.load_state_dict(original)
            cos = np.sum(ref_emb * q_emb, axis=1) / (
                np.linalg.norm(ref_emb, axis=1) * np.linalg.norm(q_emb, axis=1) + 1e-12
            )
            report["validation_min_cosine"] = float(cos.min())
            report["validation_passed"] = bool(cos.min() >= min_cosine)
            if not report["validation_passed"]:
                raise ModelError(
                    "int8 export failed parity validation",
                    details={"min_cosine": float(cos.min()), "required": min_cosine},
                )
    with open(output_dir / "export_report.json", "w") as f:
        json.dump(report, f, indent=2)
    logger.info(f"exported model to {output_dir}: {report}")
    return report


def load_quantized_weights(npz_path: str | Path) -> dict:
    """``weights_int8.npz`` read back into the flat quantized dict."""
    data = np.load(npz_path)
    out: dict[str, dict] = {}
    for full_key in data.files:
        key, _, kind = full_key.rpartition("::")
        out.setdefault(key, {})[kind] = data[full_key]
    return out
