"""TunedConfig — the frozen plan-configuration record the autotuner emits.

Port of ``src/repro/tune/config.py`` (the same JSON).  The serving engine
builds its fallback layout from its own config fields and, under
``autotune``, takes one per graph regime from ``tune.Autotuner``.  A
config reaches a built plan through ``tile``, ``bucket_caps`` and ``cap``
only: ``chunk`` and ``dense_threshold_ratio`` are searched and scored by
the tuner's stage 1, as in the reference, but no kernel reads them.  This
module and ``core/scv.py`` are the only two places allowed to define
tile/cap/chunk/ladder values.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.scv import (
    DEFAULT_CAP,
    DEFAULT_CHUNK,
    DEFAULT_LADDER,
    DEFAULT_TILE,
    MXU_VPU_RATIO,
)


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One point in the (T, C, dense-threshold-ratio, ladder) space.

    ``bucket_caps`` is the ascending capacity ladder; an empty tuple means
    single-cap plans at ``cap``.  ``source`` is metadata only, excluded
    from equality.
    """

    tile: int = DEFAULT_TILE
    chunk: int = DEFAULT_CHUNK
    dense_threshold_ratio: float = MXU_VPU_RATIO
    bucket_caps: tuple[int, ...] = DEFAULT_LADDER
    cap: int = DEFAULT_CAP
    source: str = "default"

    def __post_init__(self):
        object.__setattr__(self, "bucket_caps", tuple(int(c) for c in self.bucket_caps))
        if self.tile <= 0 or self.tile & (self.tile - 1):
            raise ValueError(f"tile must be a positive power of two, got {self.tile}")
        if self.chunk <= 0:
            raise ValueError(f"chunk must be positive, got {self.chunk}")
        if not 0.0 < self.dense_threshold_ratio <= 1.0:
            raise ValueError(
                f"dense_threshold_ratio must be in (0, 1], got"
                f" {self.dense_threshold_ratio}"
            )
        caps = self.bucket_caps
        if caps and (list(caps) != sorted(set(caps)) or min(caps) <= 0):
            raise ValueError(f"bucket_caps must be ascending and positive: {caps}")
        if not caps and self.cap <= 0:
            raise ValueError(f"cap must be positive when no ladder, got {self.cap}")

    def __eq__(self, other):
        if not isinstance(other, TunedConfig):
            return NotImplemented
        return self.plan_key == other.plan_key

    def __hash__(self):
        return hash(self.plan_key)

    @property
    def plan_key(self) -> tuple:
        """The fields that change the built plan — ``source`` excluded."""
        return (
            self.tile,
            self.chunk,
            round(self.dense_threshold_ratio, 6),
            self.bucket_caps,
            self.cap if not self.bucket_caps else 0,
        )

    @property
    def cap_signature(self) -> tuple[int, ...] | int:
        """What plan caches salt on: the ladder, or the single cap."""
        return self.bucket_caps if self.bucket_caps else self.cap

    def dense_tile_threshold(self) -> int:
        """nnz above which stage 1 prices a T x T tile as a dense matmul —
        the tuned analogue of :func:`core.scv.dense_tile_threshold`.  Like
        the reference's engine, the port's plans keep
        ``dense_tile_threshold(tile)``: this value is scored, not served."""
        return int(self.tile * self.tile * self.dense_threshold_ratio)

    @classmethod
    def default(cls) -> "TunedConfig":
        return cls()

    def to_json(self) -> dict:
        return {
            "tile": self.tile,
            "chunk": self.chunk,
            "dense_threshold_ratio": self.dense_threshold_ratio,
            "bucket_caps": list(self.bucket_caps),
            "cap": self.cap,
            "source": self.source,
        }

    @classmethod
    def from_json(cls, d: dict) -> "TunedConfig":
        return cls(
            tile=int(d["tile"]),
            chunk=int(d["chunk"]),
            dense_threshold_ratio=float(d["dense_threshold_ratio"]),
            bucket_caps=tuple(int(c) for c in d["bucket_caps"]),
            cap=int(d.get("cap", DEFAULT_CAP)),
            source=str(d.get("source", "cache")),
        )
