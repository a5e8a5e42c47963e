"""Client-side persistence: KV store with aliases + keystore.

Mirrors the `sda-client-store` crate: a ``Store`` KV trait with alias
indirection (client-store/src/store.rs:3-40) and a file-based
implementation that doubles as the client keystore
(client-store/src/file.rs:8-73).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

__all__ = ["Filebased", "MemoryStore"]


class _BaseStore:
    """Typed KV with aliases; subclasses supply _read/_write/_del."""

    def put(self, key: str, value) -> None:
        self._write(key, value)

    def get(self, key: str):
        return self._read(key)

    def put_alias(self, alias: str, key: str) -> None:
        self._write(f"alias:{alias}", key)

    def get_alias(self, alias: str) -> Optional[str]:
        return self._read(f"alias:{alias}")

    def get_aliased(self, alias: str):
        key = self.get_alias(alias)
        return self._read(key) if key is not None else None


class MemoryStore(_BaseStore):
    def __init__(self):
        self._data = {}
        self._lock = threading.RLock()

    def _read(self, key):
        with self._lock:
            v = self._data.get(key)
            return json.loads(v) if v is not None else None

    def _write(self, key, value):
        with self._lock:
            self._data[key] = json.dumps(value)


class Filebased(_BaseStore):
    """One JSON file per key under a directory (file.rs jfs semantics)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._lock = threading.RLock()

    def _file(self, key: str) -> str:
        safe = key.replace("/", "_").replace(":", "_")
        return os.path.join(self.path, f"{safe}.json")

    def _read(self, key):
        try:
            with open(self._file(key)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def _write(self, key, value):
        with self._lock:
            tmp = self._file(key) + ".tmp"
            with open(tmp, "w") as f:
                json.dump(value, f)
            os.replace(tmp, self._file(key))
