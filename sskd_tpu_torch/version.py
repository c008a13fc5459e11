"""Package version (copy of sskd_tpu/version.py)."""

__version__ = "0.1.0"
