"""API key lifecycle: generate, list, revoke, rotate (port of sskd_tpu/keys.py).

Keys are ``sk_live_<token_urlsafe(24)>``, kept only as hashes
(:meth:`~sskd_tpu_torch.serve.middleware.APIKeyAuth.hash_key`: SHA-256, or
PBKDF2-HMAC-SHA256 with the file's salt) in a keys.json of mode 600; the
plaintext is returned once, when made. The file and the hashes are the JAX
package's: a key made by either package verifies in the other.
``export_env`` gives the JSON list for ``SEMANTIC_KD_API_KEY_HASHES``.
"""

from __future__ import annotations

import json
import os
import secrets
from datetime import datetime, timezone
from pathlib import Path

from sskd_tpu_torch.exceptions import ValidationError_
from sskd_tpu_torch.serve.middleware import APIKeyAuth
from sskd_tpu_torch.utils.logging import get_logger

logger = get_logger("keys")

KEY_PREFIX = "sk_live_"


class APIKeyManager:
    def __init__(self, keys_path: str | Path = "artifacts/keys.json", salt: str = ""):
        self.path = Path(keys_path)
        self.salt = salt
        self._data: dict = {"keys": {}}
        if self.path.exists():
            with open(self.path) as f:
                self._data = json.load(f)
            self.salt = self._data.get("salt", salt)
        else:
            self._data["salt"] = salt

    def _save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(self._data, f, indent=2)
        os.chmod(self.path, 0o600)

    def generate(self, label: str) -> str:
        """A new key under ``label``; the plaintext is returned once and
        never stored."""
        key = KEY_PREFIX + secrets.token_urlsafe(24)
        self._data["keys"][label] = {
            "hash": APIKeyAuth.hash_key(key, self.salt),
            "created_at": datetime.now(timezone.utc).isoformat(),
            "revoked": False,
        }
        self._save()
        logger.info(f"generated key {label!r}")
        return key

    def list_keys(self) -> dict:
        return {label: {k: v for k, v in info.items() if k != "hash"}
                for label, info in self._data["keys"].items()}

    def revoke(self, label: str) -> None:
        if label not in self._data["keys"]:
            raise ValidationError_(f"unknown key label {label!r}")
        self._data["keys"][label]["revoked"] = True
        self._data["keys"][label]["revoked_at"] = datetime.now(timezone.utc).isoformat()
        self._save()

    def rotate(self, label: str) -> str:
        """Revoke the key under ``label`` (if any) and make a new one."""
        if label in self._data["keys"]:
            self.revoke(label)
        return self.generate(label)

    def active_hashes(self) -> list[str]:
        return [info["hash"] for info in self._data["keys"].values() if not info.get("revoked")]

    def export_env(self) -> str:
        """The JSON list for ``SEMANTIC_KD_API_KEY_HASHES``."""
        return json.dumps(self.active_hashes())
