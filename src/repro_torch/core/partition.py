"""Z-curve partitioning for multi-device aggregation (paper §III-C, §V-G).

Port of ``src/repro/core/partition.py``.  Any contiguous stretch of the
Z-Morton tile order keeps locality, and tiles are fine-grained enough to
split the nonzeros evenly:

1. :func:`split_equal_nnz` cuts the Z-ordered tile list into P spans of
   near-equal nonzero counts (the paper's static split, §V-G), padded to
   one width.
2. :func:`shard_tiles` materialises the stacked spans from the host
   tiles; :func:`shard_plan` does the same gather on a plan's tensor
   leaves where they live, reading nothing back.

``core.exec.PlanExecutor.prepare`` cuts the stacked result into one plan
per span, places the spans on devices, and ``core.exec.aggregate_sharded``
merges their partial outputs once.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from repro_torch.core.scv import SCVBucketedPlan, SCVPlan, SCVTiles


@dataclasses.dataclass(frozen=True)
class Partition:
    """Indices of the tiles of each of P parts, padded to one width with
    ``-1`` (a padded slot becomes a zero-nnz tile)."""

    part_tiles: np.ndarray  # int32[P, tiles_per_part] — indices into the tiles
    nnz_per_part: np.ndarray  # int64[P]
    n_parts: int


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def partition_of(nnz: np.ndarray, n_parts: int) -> Partition:
    """The equal-nnz split of one tile sequence with per-tile counts ``nnz``
    (host).  The greedy prefix rule of the reference's loop, vectorised:
    cut ``b`` falls after the first tile past cut ``b - 1`` whose running
    count reaches ``b / n_parts`` of the total; cuts that never come leave
    empty spans at the end."""
    nnz = np.asarray(nnz).astype(np.int64)
    n_tiles = nnz.shape[0]
    cum = np.cumsum(nnz)
    target = int(cum[-1] if n_tiles else 0) / max(n_parts, 1)
    bounds, last = [0], -1
    for b in range(1, n_parts):
        hit = np.flatnonzero(cum[last + 1:] >= target * b)
        if hit.size == 0:
            break
        last += 1 + int(hit[0])
        bounds.append(last + 1)
    bounds += [n_tiles] * (n_parts + 1 - len(bounds))
    spans = [np.arange(bounds[p], bounds[p + 1], dtype=np.int32) for p in range(n_parts)]
    width = max(max((len(s) for s in spans), default=1), 1)
    part_tiles = np.full((n_parts, width), -1, dtype=np.int32)
    for p, s in enumerate(spans):
        part_tiles[p, : len(s)] = s
    nnz_per_part = np.array([int(nnz[s].sum()) for s in spans], dtype=np.int64)
    return Partition(part_tiles, nnz_per_part, n_parts)


def split_equal_nnz(
    tiles: Union[SCVTiles, SCVPlan, SCVBucketedPlan], n_parts: int
) -> Union[Partition, tuple[Partition, ...]]:
    """Prefix split of the (Z-ordered) tile sequence into ``n_parts`` spans
    of about equal nnz; tiles are never reordered.  Takes host tiles or a
    plan (its ``nnz_in_tile`` is read back once).  A bucketed plan gets one
    :class:`Partition` per capacity segment: each segment is its own
    launch, cut into its own spans along the same curve."""
    if isinstance(tiles, SCVBucketedPlan):
        return tuple(split_equal_nnz(s, n_parts) for s in tiles.segments)
    return partition_of(_host(tiles.nnz_in_tile), n_parts)


def shard_tiles(tiles: SCVTiles, part: Partition) -> SCVTiles:
    """The stacked copy of host tiles: padded slots become zero tiles
    (coordinates 0, nnz 0).  Leading dimension ``P * tiles_per_part``."""
    idx = part.part_tiles.ravel()
    pad = idx < 0
    idx = np.where(pad, 0, idx)

    def take(a, fill=0):
        if a.shape[0] == 0:
            # a ladder rung with no tile: every span slot is padding
            return np.full((len(idx),) + a.shape[1:], fill, a.dtype)
        out = a[idx].copy()
        out[pad] = fill
        return out

    return SCVTiles(
        tile_row=take(tiles.tile_row),
        tile_col=take(tiles.tile_col),
        rows=take(tiles.rows),
        cols=take(tiles.cols),
        vals=take(tiles.vals),
        nnz_in_tile=take(tiles.nnz_in_tile),
        tile=tiles.tile,
        cap=tiles.cap,
        shape=tiles.shape,
        order=tiles.order,
    )


def shard_plan(
    plan: Union[SCVPlan, SCVBucketedPlan],
    part: Union[Partition, tuple[Partition, ...]],
) -> Union[SCVPlan, SCVBucketedPlan]:
    """Gather each part's span out of the plan's leaves, on the plan's
    device (padded slots become zero tiles, perm slots ``-1``); the host
    only builds the index.  A bucketed plan takes the tuple of partitions
    :func:`split_equal_nnz` gives it, segment by segment.

    The result's leaves have leading dimension ``P * tiles_per_part``.  Its
    tile sequence visits block-rows in more than one run (spans share
    boundary rows, padding sits at coordinate 0), so it carries no run
    index (``runs=None``) and is no launchable plan:
    ``core.exec.PlanExecutor.prepare`` cuts it into spans, each with its
    own."""
    if isinstance(plan, SCVBucketedPlan):
        if not isinstance(part, tuple) or len(part) != len(plan.segments):
            raise ValueError(
                "bucketed plan needs one Partition per segment "
                f"({len(plan.segments)}), got {part!r}"
            )
        return dataclasses.replace(
            plan, segments=tuple(shard_plan(s, p) for s, p in zip(plan.segments, part))
        )
    idx = part.part_tiles.ravel()
    pad = torch.from_numpy(idx < 0).to(plan.device)
    index = torch.from_numpy(np.where(idx < 0, 0, idx).astype(np.int64)).to(plan.device)

    def take(a, fill=0):
        if a is None:
            return None
        if a.shape[0] == 0:
            return torch.full((idx.shape[0],) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                              device=a.device)
        out = a[index]
        mask = pad.reshape((-1,) + (1,) * (out.dim() - 1))
        return torch.where(mask, torch.tensor(fill, dtype=out.dtype, device=out.device), out)

    return dataclasses.replace(
        plan,
        tile_row=take(plan.tile_row),
        tile_col=take(plan.tile_col),
        rows=take(plan.rows),
        cols=take(plan.cols),
        vals=take(plan.vals),
        nnz_in_tile=take(plan.nnz_in_tile),
        perm=take(plan.perm, fill=-1),
        runs=None,
    )


def nnz_imbalance(per_part: np.ndarray) -> float:
    """max/mean of a per-part nnz vector (1.0: perfect balance; empty or
    all-zero input reports 1.0)."""
    per_part = np.asarray(per_part)
    mean = per_part.mean() if len(per_part) else 0.0
    return float(per_part.max() / mean) if mean else 1.0


def load_imbalance(
    part: Union[Partition, tuple[Partition, ...]],
    per_segment: bool = False,
) -> Union[float, tuple[float, ...]]:
    """max/mean nnz over the parts (1.0: perfect balance).  For a bucketed
    plan's tuple the per-part nnz is summed over segments (all segments of
    a part run on one device); ``per_segment=True`` gives one ratio per
    segment instead."""
    if isinstance(part, tuple):
        if per_segment:
            return tuple(load_imbalance(p) for p in part)
        return nnz_imbalance(sum(p.nnz_per_part for p in part))
    if per_segment:
        return (load_imbalance(part),)
    return nnz_imbalance(part.nnz_per_part)
