"""Device selection for the port's entry points (port of
sskd_tpu/utils/platform.py).

The JAX package picks a platform and falls back to the CPU when no
accelerator is found. The port does not fall back: an entry point runs on
CUDA unless its caller asks for the CPU, and raises when CUDA is asked for
(or defaulted to) and is not available.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` and ``"cuda"`` mean the current CUDA device; ``"cpu"`` must
    be asked for. Raises ``RuntimeError`` when CUDA is wanted and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
