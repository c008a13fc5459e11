"""Int8 and packed-int4 row quantization of the index matrix (port of
sskd_tpu/ops/quant.py).

Every function takes and returns torch tensors on the caller's device and
follows the arithmetic that XLA runs for the JAX package step for step, so
the stored bytes are identical on the same input: f32 absmax; the scale as
``absmax * f32(1 / 127)`` (XLA rewrites the division by a constant into
that product, which differs from ``absmax / 127`` in the last bit for a few
rows in a hundred); f32 division by the scale; round half to even; clip.

Int4 layout (the "halves" layout): ``packed[:, j]`` holds dim ``j`` in its low
nibble and dim ``j + D/2`` in its high nibble, both biased by +8; values are
clipped to [-7, 7], so the code for -8 never occurs.
"""

from __future__ import annotations

import numpy as np
import torch

from sskd_tpu_torch.utils.platform import resolve_device


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: ``(values int8 [N, D], scales f32 [N])`` with
    ``x ~= values * scales[:, None]``. Also quantizes query batches."""
    x = x.to(torch.float32)
    absmax = torch.clamp(x.abs().amax(dim=1), min=1e-9)
    scales = absmax * (1.0 / 127.0)
    values = torch.clamp(torch.round(x / scales[:, None]), -127, 127).to(torch.int8)
    return values, scales


def dequantize_rows(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return values.to(torch.float32) * scales[:, None]


def quantize_rows_int4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int4 packed two per byte: ``(packed uint8 [N, D/2],
    scales f32 [N])``. D must be even."""
    n, d = x.shape
    if d % 2:
        raise ValueError(f"int4 packing requires even dim, got {d}")
    x = x.to(torch.float32)
    absmax = torch.clamp(x.abs().amax(dim=1), min=1e-9)
    scales = absmax * (1.0 / 7.0)
    q = torch.clamp(torch.round(x / scales[:, None]), -7, 7).to(torch.int32) + 8
    lo, hi = q[:, : d // 2], q[:, d // 2 :]
    packed = (lo | (hi << 4)).to(torch.uint8)
    return packed, scales


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Packed uint8 [N, D/2] -> int8 [N, D] nibble values in [-7, 7]."""
    p = packed.to(torch.int32)
    lo = (p & 15) - 8
    hi = (p >> 4) - 8
    return torch.cat([lo, hi], dim=1).to(torch.int8)


def dequantize_rows_int4(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return unpack_int4(packed).to(torch.float32) * scales[:, None]


def _error_report(x: np.ndarray, recon: np.ndarray) -> dict[str, float]:
    err = np.abs(recon - x)
    denom = np.maximum(np.abs(x), 1e-9)
    cos = np.sum(recon * x, axis=1) / (
        np.linalg.norm(recon, axis=1) * np.linalg.norm(x, axis=1) + 1e-12
    )
    return {
        "max_abs_err": float(err.max()),
        "mean_abs_err": float(err.mean()),
        "max_rel_err": float((err / denom).max()),
        "min_row_cosine": float(cos.min()),
    }


def quantization_error(x: np.ndarray, device: str | torch.device = "cuda") -> dict[str, float]:
    """Parity diagnostics of the int8 rows of ``x`` [N, D] (the export and
    validation step's; reference: scripts/export_to_onnx.py:40-45): the
    largest and mean absolute error of the dequantized rows, the largest
    relative error and the smallest row cosine. Quantized on ``device``."""
    x = np.asarray(x, dtype=np.float32)
    values, scales = quantize_rows(torch.from_numpy(x).to(resolve_device(device)))
    return _error_report(x, dequantize_rows(values, scales).cpu().numpy())


def quantization_error_int4(x: np.ndarray, device: str | torch.device = "cuda") -> dict[str, float]:
    """Same diagnostics as :func:`quantization_error`, int4 path."""
    x = np.asarray(x, dtype=np.float32)
    packed, scales = quantize_rows_int4(torch.from_numpy(x).to(resolve_device(device)))
    return _error_report(x, dequantize_rows_int4(packed, scales).cpu().numpy())
