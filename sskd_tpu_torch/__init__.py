"""sskd_tpu_torch: the PyTorch / CUDA port of sskd_tpu for NVIDIA Hopper.

The JAX package (``sskd_tpu``) stays the reference; this package mirrors its
layout, imports nothing of it and never imports JAX. Entry points take an
explicit ``device`` (default ``"cuda"``) and raise when CUDA is asked for and
missing; CUDA kernels live in ``csrc/`` and are built at first use.
"""

from sskd_tpu_torch.version import __version__

__all__ = ["__version__"]
