"""On-disk cache of tuned configs, keyed by regime signature x machine.

Port of ``src/repro/tune/store.py``, with the same file format.  A flat
JSON file (atomic tmp+rename writes) so concurrent benches and a
serving process can share one store; misses are cheap (one dict lookup
after an O(nnz) histogram), hits skip both the simulator sweep and the
measured calibration.  Staleness is structural: the key embeds
:func:`repro_torch.tune.signature.machine_fingerprint`, so a changed
``MachineConfig`` (or torch device) never sees old entries.
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile
from typing import Optional

from repro_torch.tune.config import TunedConfig

STORE_VERSION = 1


class TuneStore:
    """Config cache: in-memory always, mirrored to ``path`` when given."""

    def __init__(self, path: Optional[str | pathlib.Path] = None):
        self.path = pathlib.Path(path) if path is not None else None
        self.hits = 0
        self.misses = 0
        self._entries: dict[str, dict] = {}
        if self.path is not None and self.path.exists():
            try:
                data = json.loads(self.path.read_text())
                if data.get("version") == STORE_VERSION:
                    self._entries = dict(data.get("entries", {}))
            except (json.JSONDecodeError, OSError):
                self._entries = {}  # corrupt store == empty store

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: str) -> Optional[TunedConfig]:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        cfg = TunedConfig.from_json(entry["config"])
        return cfg

    def put(self, key: str, config: TunedConfig, meta: Optional[dict] = None):
        self._entries[key] = {
            "config": config.to_json(),
            "meta": dict(meta or {}),
        }
        if self.path is not None:
            self._flush()

    def _flush(self):
        payload = json.dumps(
            {"version": STORE_VERSION, "entries": self._entries}, indent=2
        )
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=str(self.path.parent), prefix=self.path.name, suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w") as fh:
                fh.write(payload + "\n")
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
