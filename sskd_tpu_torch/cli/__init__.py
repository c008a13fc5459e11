"""Command-line entry point of the port (port of sskd_tpu/cli): ``main.py``,
the ``semantic-kd-torch`` console script, and ``pipeline.py``, the training
and evaluation pipeline it drives."""
