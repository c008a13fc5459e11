"""Dataset fetching (port of sskd_tpu/data/fetch.py; reference:
src/data/fetch.py:14-136).

``fetch_msmarco`` downloads MS MARCO v2.1 from the Hugging Face hub through
the ``datasets`` library and writes per-split JSONL and a manifest, file for
file what the JAX package writes. ``datasets`` is imported inside the call:
neither it nor the network is needed to import the port, and a host
without either gets ``DataError`` (the JAX package's message and details),
whose fallback is the bundled synthetic demo set
(:func:`sskd_tpu_torch.data.demo.generate_demo_dataset`), which shares the
JSONL shape. BEIR fetches are explicit stubs, matching the reference
(reference: fetch.py:69-90 — "skipped").
"""

from __future__ import annotations

import json
from pathlib import Path

from sskd_tpu_torch.data.registry import get_manifest_path, get_raw_dir
from sskd_tpu_torch.exceptions import DataError
from sskd_tpu_torch.utils.logging import get_logger

logger = get_logger("data.fetch")


def fetch_msmarco(
    data_dir: str | Path,
    max_samples: int | None = None,
    splits: tuple[str, ...] = ("train", "validation"),
) -> dict:
    """Download ms_marco v2.1 -> data/raw/msmarco/{split}.jsonl + manifest."""
    raw_dir = get_raw_dir(data_dir, "msmarco")
    raw_dir.mkdir(parents=True, exist_ok=True)
    try:
        from datasets import load_dataset
    except ImportError as e:
        raise DataError(f"datasets library unavailable: {e}")

    manifest: dict = {"dataset": "msmarco", "splits": {}}
    for split in splits:
        try:
            ds = load_dataset("ms_marco", "v2.1", split=split)
        except Exception as e:
            raise DataError(
                f"cannot download ms_marco (offline host?): {e}",
                details={"fallback": "use generate_demo_dataset for e2e runs"},
            )
        if max_samples:
            ds = ds.select(range(min(max_samples, len(ds))))
        path = raw_dir / f"{split}.jsonl"
        with open(path, "w") as f:
            for row in ds:
                f.write(json.dumps(dict(row)) + "\n")
        manifest["splits"][split] = {"file": str(path), "num_samples": len(ds)}
        logger.info(f"fetched msmarco/{split}: {len(ds)} samples")
    with open(get_manifest_path(data_dir, "msmarco"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def fetch_beir_dataset(data_dir: str | Path, name: str) -> dict:
    """BEIR fetch — stubbed like the reference (reference: fetch.py:69-90)."""
    logger.warning(f"BEIR fetch for {name!r} skipped (matching reference stub)")
    return {"dataset": name, "splits": {}, "skipped": True}


def fetch_all_datasets(data_dir: str | Path, max_samples: int | None = None) -> dict[str, dict]:
    """Fetch everything in the registry (reference: fetch.py:93-136)."""
    out = {"msmarco": fetch_msmarco(data_dir, max_samples)}
    for name in ("fiqa", "scifact", "trec-covid"):
        out[name] = fetch_beir_dataset(data_dir, name)
    return out
