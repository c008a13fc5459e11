"""Data (port of sskd_tpu/data): so far the passage reader of
``prepare.py`` that the evaluation inputs read."""
