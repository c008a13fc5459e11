"""Data (port of sskd_tpu/data): the dataset registry, the offline demo
generator, raw JSONL -> chunked parquet preparation (through the port's own
parquet reader and writer, ``data/parquet.py``) and the integrity checks.
The hub fetcher (``sskd_tpu/data/fetch.py``) is not ported: it needs the
network."""

from sskd_tpu_torch.data.demo import generate_demo_dataset
from sskd_tpu_torch.data.registry import DATASETS, get_dataset_config

__all__ = ["DATASETS", "get_dataset_config", "generate_demo_dataset"]
