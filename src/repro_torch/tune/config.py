"""TunedConfig — the frozen plan-configuration record.

Port of ``src/repro/tune/config.py``.  The serving engine resolves its
fallback plan layout through it; the autotuner that emits tuned configs
is a later slice of the port.  This module and ``core/scv.py`` are the
only two places allowed to define tile/cap/chunk/ladder values.
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
