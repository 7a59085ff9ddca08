"""Distributed SCV aggregation, the historical names (paper §V-G).

Port of ``src/repro/core/dist.py``: a façade over :mod:`core.exec`, which
owns placement (the grid, the span split, the launches, the one merge).

* :data:`DistributedGraph` — alias of :class:`core.exec.ShardedPlan`.
* :func:`distribute_plan` — tile-axis placement of an ``SCVPlan`` or
  ``SCVBucketedPlan`` on ``n_parts`` devices.
* :func:`distribute_tiles` — lift host tiles to a plan, then place it.
* :func:`aggregate_distributed` — run a placed plan.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.exec import (
    PlanExecutor,
    ShardedPlan,
    ShardingDecision,
    aggregate_sharded,
    cuda_pool,
)
from repro_torch.core.scv import SCVBucketedPlan, SCVPlan, SCVTiles, plan_from_tiles

#: The historical name of a placed plan.
DistributedGraph = ShardedPlan


def distribute_plan(
    plan: Union[SCVPlan, SCVBucketedPlan],
    n_parts: int,
    devices: Optional[tuple] = None,
) -> ShardedPlan:
    """Cut a plan into ``n_parts`` equal-nnz tile spans on ``devices``
    (default: the first ``n_parts`` CUDA cards).  Each capacity segment of
    a bucketed plan is cut into its own spans; span p of every segment
    lands on device p.  The decision is ``tiles`` even for ``n_parts ==
    1``, a one-span placement."""
    ex = PlanExecutor(devices=tuple(devices or cuda_pool()[:n_parts]))
    return ex.prepare(plan, decision=ShardingDecision(kind="tiles", tile_parts=n_parts))


def distribute_tiles(
    tiles: SCVTiles, n_parts: int, devices: Optional[tuple] = None
) -> ShardedPlan:
    """Host tiles lifted to a plan (no coverage dummies: each span's chain
    starts from zeros) and placed by :func:`distribute_plan`."""
    return distribute_plan(
        plan_from_tiles(tiles, ensure_coverage=False, with_perm=False), n_parts, devices
    )


def aggregate_distributed(g: ShardedPlan, z: torch.Tensor) -> torch.Tensor:
    """out = Â Z over a placed plan (``core.exec.aggregate_sharded``)."""
    return aggregate_sharded(g, z)
