"""Plan cache: amortize SCV preprocessing across repeated graph queries.

Port of ``src/repro/serve/plan_cache.py``.  The prepared plan (the
``Graph`` bundle of ``models/gnn.py``) is cached under a content hash of
the COO adjacency, so hot graphs skip preprocessing; composite (batched)
plans derive their key from the member digests via ``combine_keys``.
Entries are evicted least-recently-used past an entry-count or byte
budget, and optionally expire after a TTL.  Delta re-keying
(``revalidate`` / ``anchor``) comes with the port's delta slice.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.core.formats import COOMatrix


# ---------------------------------------------------------------------------
# content keys
# ---------------------------------------------------------------------------
def coo_content_key(adj: COOMatrix, *, tile: int, cap: Any = None) -> str:
    """Stable content hash of a COO adjacency + plan parameters.

    ``cap`` is the capacity signature: an int for single-cap plans, the
    ascending bucket ladder tuple for nnz-bucketed plans."""
    h = hashlib.blake2b(digest_size=16)
    h.update(f"shape={adj.shape};tile={tile};cap={cap};".encode())
    for a in (adj.rows, adj.cols, adj.vals):
        arr = np.ascontiguousarray(a)
        # frame each array with dtype + length: raw bytes alone would let
        # byte-aliased arrays of different dtypes/lengths collide
        h.update(f"{arr.dtype.str}:{arr.shape[0]};".encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def combine_keys(keys: Iterable[str], *, salt: str = "") -> str:
    """Key for a composite plan derived from already-keyed members."""
    h = hashlib.blake2b(digest_size=16)
    h.update(salt.encode())
    for k in keys:
        h.update(k.encode())
    return h.hexdigest()


def plan_nbytes(plan: Any) -> int:
    """Byte footprint of a cached plan: the numpy arrays and torch tensors
    it holds (dataclass fields, dicts, tuples/lists walked), each counted
    once, wherever it lives (host or device)."""
    seen: set[int] = set()
    total = 0

    def visit(obj):
        nonlocal total
        if obj is None or isinstance(obj, (int, float, str, bool, bytes)):
            return
        oid = id(obj)
        if oid in seen:
            return
        seen.add(oid)
        if isinstance(obj, torch.Tensor):
            total += obj.numel() * obj.element_size()
        elif isinstance(obj, np.ndarray):
            total += int(obj.nbytes)
        elif isinstance(obj, dict):
            for v in obj.values():
                visit(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                visit(v)
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                visit(getattr(obj, f.name))

    visit(plan)
    return total


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PlanCacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    expired: int = 0  # TTL drops (also counted as misses on lookup)
    bytes_in_use: int = 0
    entries: int = 0
    build_seconds: float = 0.0

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0


@dataclasses.dataclass
class _Entry:
    value: Any
    nbytes: int
    created: float = 0.0  # clock() at insertion (TTL anchor)


class PlanCache:
    """Content-addressed LRU cache of prepared aggregation plans.

    ``max_age_s`` (optional) bounds entry staleness: lookups drop entries
    older than the TTL and report a miss.  ``clock`` is injectable for
    tests.  Every public method takes one reentrant lock; it is held across
    ``get_or_build``'s builder so a composite build can nest its member
    builds.
    """

    def __init__(
        self,
        max_entries: int = 256,
        max_bytes: int = 512 * 1024 * 1024,
        max_age_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_entries <= 0:
            raise ValueError("max_entries must be positive")
        if max_bytes <= 0:
            raise ValueError("max_bytes must be positive")
        if max_age_s is not None and max_age_s <= 0:
            raise ValueError("max_age_s must be positive (or None to disable)")
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.max_age_s = max_age_s
        self._clock = clock
        self._entries: OrderedDict[str, _Entry] = OrderedDict()
        self.stats = PlanCacheStats()
        self._build_depth = 0  # nested get_or_build (composite -> members)
        self._lock = threading.RLock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return self._live_entry(key) is not None

    def _live_entry(self, key: str) -> Optional[_Entry]:
        e = self._entries.get(key)
        if e is None:
            return None
        if self.max_age_s is not None and self._clock() - e.created > self.max_age_s:
            self._entries.pop(key)
            self.stats.bytes_in_use -= e.nbytes
            self.stats.expired += 1
            self.stats.entries = len(self._entries)
            return None
        return e

    def get(self, key: str) -> Optional[Any]:
        """Look up a plan; counts a hit/miss and refreshes recency."""
        with self._lock:
            e = self._live_entry(key)
            if e is None:
                self.stats.misses += 1
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return e.value

    def put(self, key: str, value: Any, nbytes: Optional[int] = None) -> None:
        if nbytes is None:
            nbytes = plan_nbytes(value)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.stats.bytes_in_use -= old.nbytes
            if nbytes > self.max_bytes:
                # an entry that can never fit would evict the whole cache
                self.stats.entries = len(self._entries)
                return
            self._entries[key] = _Entry(value, int(nbytes), created=self._clock())
            self.stats.bytes_in_use += int(nbytes)
            self._evict()
            self.stats.entries = len(self._entries)

    def get_or_build(
        self,
        key: str,
        builder: Callable[[], Any],
        nbytes: Optional[int] = None,
    ) -> Any:
        """Return the cached plan for ``key``, building (and caching) it on
        a miss.  Oversized plans are returned but not retained."""
        with self._lock:
            value = self.get(key)
            if value is not None:
                return value
            # build_seconds accumulates only at the outermost nesting level
            self._build_depth += 1
            t0 = time.perf_counter()
            try:
                value = builder()
            finally:
                dt = time.perf_counter() - t0
                self._build_depth -= 1
                if self._build_depth == 0:
                    self.stats.build_seconds += dt
            nb = plan_nbytes(value) if nbytes is None else int(nbytes)
            if nb <= self.max_bytes:
                self.put(key, value, nb)
            return value

    def _evict(self) -> None:
        while self._entries and (
            len(self._entries) > self.max_entries
            or self.stats.bytes_in_use > self.max_bytes
        ):
            _, e = self._entries.popitem(last=False)
            self.stats.bytes_in_use -= e.nbytes
            self.stats.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.stats.bytes_in_use = 0
            self.stats.entries = 0
