"""Model registry: versioned model cards with stage promotion (port of
sskd_tpu/registry.py).

A JSON file (the JAX package's ``registry.json`` schema) maps name ->
version -> card: a SHA-256[:12] hash of the weights file, the size in MB,
an optional encode-latency probe, metrics, and a stage promoted dev ->
staging -> production. The hash is taken over ``params.msgpack`` for a
JAX package checkpoint, as the JAX package takes it, so such a checkpoint
registers under the same hash in both packages, and over ``weights.pt``
for one of the port's (which has no ``params.msgpack``).
"""

from __future__ import annotations

import hashlib
import json
import shutil
import time
from datetime import datetime, timezone
from pathlib import Path

from sskd_tpu_torch.exceptions import ModelNotFoundError, ValidationError_
from sskd_tpu_torch.utils.logging import get_logger

logger = get_logger("registry")

STAGES = ("dev", "staging", "production")
WEIGHT_FILES = ("params.msgpack", "weights.pt")  # the JAX package's first


def _weights_hash(model_dir: Path) -> str:
    """SHA-256[:12] over the checkpoint's weights file."""
    for name in WEIGHT_FILES:
        params = model_dir / name
        if params.exists():
            break
    else:
        raise ModelNotFoundError(f"no {' or '.join(WEIGHT_FILES)} under {model_dir}")
    h = hashlib.sha256()
    with open(params, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()[:12]


def _dir_size_mb(path: Path) -> float:
    total = sum(p.stat().st_size for p in path.rglob("*") if p.is_file())
    return round(total / (1024 * 1024), 2)


class ModelRegistry:
    def __init__(self, registry_path: str | Path = "artifacts/registry.json",
                 device: str | None = "cuda"):
        """``device``: where :meth:`register`'s latency probe encodes."""
        self.path = Path(registry_path)
        self.device = device
        self._data: dict = {"models": {}}
        if self.path.exists():
            with open(self.path) as f:
                self._data = json.load(f)

    def _save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(self._data, f, indent=2)

    def register(self, name: str, model_dir: str | Path, metrics: dict | None = None,
                 latency_probe: bool = False) -> dict:
        """Register a new version; returns its card."""
        model_dir = Path(model_dir)
        card = {
            "name": name,
            "version": self._next_version(name),
            "weights_hash": _weights_hash(model_dir),
            "size_mb": _dir_size_mb(model_dir),
            "path": str(model_dir),
            "metrics": metrics or {},
            "stage": "dev",
            "registered_at": datetime.now(timezone.utc).isoformat(),
        }
        if latency_probe:
            card["encode_latency_ms"] = self._probe_latency(model_dir)
        self._data["models"].setdefault(name, {})[card["version"]] = card
        self._data.setdefault("latest", {})[name] = card["version"]
        self._save()
        logger.info(f"registered {name} {card['version']} ({card['weights_hash']})")
        return card

    def _next_version(self, name: str) -> str:
        versions = self._data["models"].get(name, {})
        nums = [int(v.lstrip("v")) for v in versions if v.lstrip("v").isdigit()]
        return f"v{max(nums, default=0) + 1}"

    def _probe_latency(self, model_dir: Path, n: int = 5) -> float:
        from sskd_tpu_torch.models.student import StudentModel

        model = StudentModel(str(model_dir), device=self.device)
        model.encode(["warmup"])
        t0 = time.perf_counter()
        for _ in range(n):
            model.encode(["latency probe sentence"])
        return round((time.perf_counter() - t0) / n * 1000.0, 2)

    def list_models(self) -> dict:
        return {name: sorted(versions) for name, versions in self._data["models"].items()}

    def get(self, name: str, version: str | None = None) -> dict:
        versions = self._data["models"].get(name)
        if not versions:
            raise ModelNotFoundError(f"model {name!r} not registered")
        version = version or self._data.get("latest", {}).get(name)
        if version not in versions:
            raise ModelNotFoundError(f"{name}@{version} not found")
        return versions[version]

    def promote(self, name: str, version: str | None = None) -> dict:
        """dev -> staging -> production."""
        card = self.get(name, version)
        idx = STAGES.index(card["stage"])
        if idx == len(STAGES) - 1:
            raise ValidationError_(f"{name}@{card['version']} already in production")
        card["stage"] = STAGES[idx + 1]
        card["promoted_at"] = datetime.now(timezone.utc).isoformat()
        self._save()
        logger.info(f"promoted {name}@{card['version']} to {card['stage']}")
        return card

    def compare(self, name: str, version_a: str, version_b: str) -> dict:
        a, b = self.get(name, version_a), self.get(name, version_b)
        keys = set(a["metrics"]) | set(b["metrics"])
        return {
            k: {
                version_a: a["metrics"].get(k),
                version_b: b["metrics"].get(k),
                "delta": (round(b["metrics"][k] - a["metrics"][k], 6)
                          if k in a["metrics"] and k in b["metrics"] else None),
            }
            for k in sorted(keys)
        }

    def write_latest_pointer(self, out_path: str | Path) -> None:
        """latest.json: the latest card of each model."""
        with open(out_path, "w") as f:
            json.dump({name: self.get(name) for name in self._data["models"]}, f, indent=2)

    def sync_to(self, remote_dir: str | Path, name: str, version: str | None = None) -> Path:
        """Copy a version's checkpoint and card to ``remote_dir/name/version``."""
        card = self.get(name, version)
        dest = Path(remote_dir) / name / card["version"]
        dest.mkdir(parents=True, exist_ok=True)
        shutil.copytree(card["path"], dest / "model", dirs_exist_ok=True)
        with open(dest / "card.json", "w") as f:
            json.dump(card, f, indent=2)
        return dest
