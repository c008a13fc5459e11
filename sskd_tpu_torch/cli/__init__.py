"""Command-line pipeline (port of sskd_tpu/cli): so far the evaluation and
training inputs of ``pipeline.py``."""
