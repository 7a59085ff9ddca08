"""Plan-invariant verifier and COO admission checks.

Port of ``src/repro/core/validate.py``.  ``validate_plan`` takes any
plan-like object (:class:`SCVTiles`, :class:`SCVPlan`,
:class:`SCVBucketedPlan`, a placed ``core.exec.ShardedPlan``, or a graph
or serve composite via ``models.gnn.Graph`` / ``BatchedGraph``) and runs
the invariant chain, returning a machine-readable
:class:`ValidationReport`: per-invariant pass/fail plus the offending
tile / segment indices.  The port's plans hold torch
tensors, possibly on the card; the checks read one host copy of each leaf
(``.cpu()``, which waits for the stream) and run in numpy on the host.

The invariant chain (the reference's, in the same order and under the
same names):

* **shape-aux** — leaf shapes/dtypes consistent with the plan's static
  layout (``[nt, cap]`` entry arrays, integer indices, float values).
* **bounds** — local rows/cols in ``[0, T)``; tile coordinates inside the
  padded block grid.
* **cap** — ``0 <= nnz_in_tile <= cap`` for every tile.
* **packing** — every slot past ``nnz_in_tile`` is structural padding
  (``val == 0``, ``row == col == 0``, ``perm == -1``).
* **order** — over real tiles, ``tile_row`` non-decreasing and, within a
  block-row, ``tile_col`` non-decreasing (the Z-Morton schedule).
* **coverage** / **coverage-contiguity** — every block-row appears (first
  segment only; later segments accumulate), and each block-row forms one
  contiguous run of the schedule.
* **perm** — real slots carry distinct source-entry ids covering
  ``0 .. nnz-1`` once, unioned across segments.
* **ladder** — bucketed segment ``j`` holds only real tiles with
  ``caps[j-1] < nnz <= caps[j]``.
* **reassembly** (optional, ``coo=`` given) — the plan's real entries
  byte-match the source COO.

One invariant is the port's own:

* **run-index** — a plan segment's ``runs`` equals
  ``RunIndex.of(tile_row, nnz_in_tile)`` of that segment (runs, work
  units, launch order, ``max_nnz``, ``n_split_units``; not the counters).
  The CUDA kernel schedules its blocks by that index and the launch
  wrapper sizes shared memory and scratch from it, so an index left
  behind by a patch of the plan's arrays sends the kernel a schedule that
  no longer matches its tiles.
  A chain's plan-level index (``core.scv.PlanRuns``, one vector launch
  over all the segments), once a launch has built it, must equal
  ``PlanRuns.of`` of those per-segment indexes; it is reported, as a
  ``run-index`` failure, only when every segment's own index holds and it
  does not (it is built from them, so a stale segment index is the fault
  to report).
* **transposed** — checked only once a backward has built the plan's
  transposed plan (``ops._ScvChain``): it must equal
  ``core.scv.transposed_plan`` of the plan's current leaves, leaf for
  leaf.  The backward computes ``dZ = Âᵀ g`` through it, and it is kept
  per run index, so leaves changed in place under the same run indexes
  leave it stale (as they leave the run index).

A placed plan (``core.exec.ShardedPlan``) gets the reference's sharded
chain: **shard-span** (each segment holds ``decision.tile_parts`` spans),
every span's own checks without full coverage (a span covers only the
rows it visits) plus its **run-index**, **shard-coverage** (the first
segment's spans jointly visit every block-row), and perm bijectivity and
reassembly over all spans.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.exec import ShardedPlan
from repro_torch.core.formats import COOMatrix
from repro_torch.core.scv import (
    _LEAVES, PlanRuns, RunIndex, SCVBucketedPlan, SCVPlan, SCVTiles, cached_plan_runs,
)


# ---------------------------------------------------------------------------
# report types
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InvariantResult:
    """One invariant checked on one plan / segment."""

    invariant: str  # "order" | "coverage" | "cap" | "packing" | ...
    ok: bool
    segment: Optional[int] = None  # capacity-bucket index, if any
    part: Optional[int] = None  # sharded span index, if any
    offending: tuple[int, ...] = ()  # tile (or segment) indices at fault
    detail: str = ""

    def where(self) -> str:
        loc = []
        if self.segment is not None:
            loc.append(f"segment {self.segment}")
        if self.part is not None:
            loc.append(f"span {self.part}")
        return ", ".join(loc) or "plan"


@dataclasses.dataclass(frozen=True)
class ValidationReport:
    """Machine-readable outcome of :func:`validate_plan`."""

    kind: str  # "tiles" | "plan" | "bucketed" | "sharded" | "graph" | "batched-graph"
    checks: tuple[InvariantResult, ...]

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.checks)

    @property
    def failures(self) -> tuple[InvariantResult, ...]:
        return tuple(c for c in self.checks if not c.ok)

    def failed(self, invariant: str) -> tuple[InvariantResult, ...]:
        return tuple(c for c in self.failures if c.invariant == invariant)

    def summary(self) -> str:
        if self.ok:
            return f"{self.kind}: all {len(self.checks)} invariant checks passed"
        lines = [f"{self.kind}: {len(self.failures)} invariant violation(s)"]
        for c in self.failures:
            off = f" tiles={list(c.offending[:8])}" if c.offending else ""
            lines.append(f"  {c.invariant} @ {c.where()}: {c.detail}{off}")
        return "\n".join(lines)

    def raise_if_failed(self) -> "ValidationReport":
        if not self.ok:
            raise PlanInvariantError(self)
        return self


class PlanInvariantError(ValueError):
    """Raised by ``ValidationReport.raise_if_failed`` (admission boundary)."""

    def __init__(self, report: ValidationReport):
        super().__init__(report.summary())
        self.report = report


# ---------------------------------------------------------------------------
# COO admission checks (serving boundary)
# ---------------------------------------------------------------------------
def check_coo(a: COOMatrix, square: bool = False) -> None:
    """Reject malformed client COO with a clear ``ValueError``.

    Out-of-range / negative indices would shift into a *neighbor's* block
    of a serving composite and silently corrupt co-batched outputs — on
    the GPU, into another request's output strip.
    """
    m, n = a.shape
    if m < 0 or n < 0:
        raise ValueError(f"COO shape must be non-negative, got {a.shape}")
    if square and m != n:
        raise ValueError(f"adjacency must be square, got {a.shape}")
    if not (len(a.rows) == len(a.cols) == len(a.vals)):
        raise ValueError(
            f"COO arrays disagree on nnz: rows={len(a.rows)} "
            f"cols={len(a.cols)} vals={len(a.vals)}"
        )
    if a.nnz == 0:
        return
    rmin, rmax = int(a.rows.min()), int(a.rows.max())
    cmin, cmax = int(a.cols.min()), int(a.cols.max())
    if rmin < 0 or cmin < 0:
        raise ValueError(
            f"COO indices must be non-negative (rows >= {rmin}, cols >= {cmin})"
        )
    if rmax >= m or cmax >= n:
        raise ValueError(
            f"COO indices out of range for shape {a.shape}: "
            f"max row {rmax}, max col {cmax}"
        )
    if not np.all(np.isfinite(a.vals)):
        bad = np.flatnonzero(~np.isfinite(a.vals))
        raise ValueError(
            f"COO values must be finite; {len(bad)} non-finite entries "
            f"(first at {int(bad[0])})"
        )


# ---------------------------------------------------------------------------
# per-plan invariant checks (numpy over host copies of the leaves)
# ---------------------------------------------------------------------------
def _np(a) -> np.ndarray:
    """Host numpy copy of a leaf (a torch tensor anywhere, or an array)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass(frozen=True)
class _PlanView:
    """Host-side snapshot of one plan's arrays (works for SCVTiles too)."""

    tile_row: np.ndarray
    tile_col: np.ndarray
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    nnz_in_tile: np.ndarray
    perm: Optional[np.ndarray]
    tile: int
    cap: int
    shape: tuple[int, int]
    order: str

    @classmethod
    def of(cls, p) -> "_PlanView":
        return cls(
            tile_row=_np(p.tile_row).astype(np.int64),
            tile_col=_np(p.tile_col).astype(np.int64),
            rows=_np(p.rows),
            cols=_np(p.cols),
            vals=_np(p.vals),
            nnz_in_tile=_np(p.nnz_in_tile).astype(np.int64),
            perm=None if p.perm is None else _np(p.perm).astype(np.int64),
            tile=int(p.tile),
            cap=int(p.cap),
            shape=tuple(p.shape),
            order=p.order,
        )

    @property
    def n_tiles(self) -> int:
        return int(self.tile_row.shape[0])

    @property
    def n_row_blocks(self) -> int:
        return -(-self.shape[0] // self.tile)

    @property
    def n_col_blocks(self) -> int:
        return -(-self.shape[1] // self.tile)


def _check_shape_aux(v: _PlanView, loc: dict) -> list[InvariantResult]:
    nt, cap = v.n_tiles, v.cap
    bad = []
    for name, arr, want in (
        ("tile_row", v.tile_row, (nt,)),
        ("tile_col", v.tile_col, (nt,)),
        ("nnz_in_tile", v.nnz_in_tile, (nt,)),
        ("rows", v.rows, (nt, cap)),
        ("cols", v.cols, (nt, cap)),
        ("vals", v.vals, (nt, cap)),
    ):
        if tuple(arr.shape) != want:
            bad.append(f"{name}.shape={tuple(arr.shape)} != {want}")
    if v.perm is not None and tuple(v.perm.shape) != (nt, cap):
        bad.append(f"perm.shape={tuple(v.perm.shape)} != {(nt, cap)}")
    for name, arr in (("rows", v.rows), ("cols", v.cols)):
        if not np.issubdtype(arr.dtype, np.integer):
            bad.append(f"{name}.dtype={arr.dtype} not integer")
    if not np.issubdtype(v.vals.dtype, np.floating):
        bad.append(f"vals.dtype={v.vals.dtype} not floating")
    if v.tile <= 0 or v.cap <= 0:
        bad.append(f"tile={v.tile}, cap={v.cap} must be positive")
    return [InvariantResult("shape-aux", not bad, detail="; ".join(bad), **loc)]


def _check_bounds(v: _PlanView, loc: dict) -> list[InvariantResult]:
    T = v.tile
    slot = np.arange(v.cap)[None, :]
    real = slot < v.nnz_in_tile[:, None]
    bad_local = np.flatnonzero(
        ((v.rows < 0) | (v.rows >= T) | (v.cols < 0) | (v.cols >= T)) & real
        if real.size else np.zeros(0, bool)
    )
    bad_tiles = np.unique(bad_local // max(v.cap, 1)) if bad_local.size else []
    bad_coord = np.flatnonzero(
        (v.tile_row < 0)
        | (v.tile_row >= v.n_row_blocks)
        | (v.tile_col < 0)
        | (v.tile_col >= v.n_col_blocks)
    )
    off = tuple(int(i) for i in np.union1d(bad_tiles, bad_coord))
    detail = ""
    if len(bad_tiles):
        detail += f"local row/col outside [0, {T}) in {len(bad_tiles)} tile(s); "
    if len(bad_coord):
        detail += (
            f"tile coordinates outside {v.n_row_blocks}x{v.n_col_blocks} "
            f"block grid in {len(bad_coord)} tile(s)"
        )
    return [InvariantResult("bounds", not off, offending=off, detail=detail, **loc)]


def _check_cap(v: _PlanView, loc: dict) -> list[InvariantResult]:
    bad = np.flatnonzero((v.nnz_in_tile < 0) | (v.nnz_in_tile > v.cap))
    detail = (
        f"nnz_in_tile outside [0, cap={v.cap}] "
        f"(worst: {int(v.nnz_in_tile[bad[0]])} at tile {int(bad[0])})"
        if bad.size
        else ""
    )
    return [
        InvariantResult(
            "cap", not bad.size, offending=tuple(int(i) for i in bad),
            detail=detail, **loc,
        )
    ]


def _check_packing(v: _PlanView, loc: dict) -> list[InvariantResult]:
    nnz = np.clip(v.nnz_in_tile, 0, v.cap)
    slot = np.arange(v.cap)[None, :]
    pad = slot >= nnz[:, None]
    dirty = pad & ((v.vals != 0) | (v.rows != 0) | (v.cols != 0))
    if v.perm is not None:
        dirty |= pad & (v.perm != -1)
        dirty |= (~pad) & (v.perm < 0)  # real slots must carry a source id
    bad = np.unique(np.nonzero(dirty)[0]) if dirty.size else np.zeros(0, np.int64)
    detail = (
        f"{int(dirty.sum())} padding slot(s) not structurally zero "
        "(val==0, row==col==0, perm==-1) or real slot(s) with perm < 0"
        if bad.size
        else ""
    )
    return [
        InvariantResult(
            "packing", not bad.size, offending=tuple(int(i) for i in bad),
            detail=detail, **loc,
        )
    ]


def _check_order(v: _PlanView, loc: dict) -> list[InvariantResult]:
    """Schedule invariant over real tiles: non-decreasing block-row; inside
    a block-row, non-decreasing ``tile_col`` (the Z-Morton key is monotone
    in ``tile_col`` with the row bits fixed, so one comparison covers both
    supported orders)."""
    real = np.flatnonzero(v.nnz_in_tile > 0)
    r, c = v.tile_row[real], v.tile_col[real]
    bad = []
    step = np.flatnonzero(np.diff(r) < 0)
    bad.extend(real[i + 1] for i in step)
    back = np.flatnonzero((np.diff(r) == 0) & (np.diff(c) < 0))
    bad.extend(real[i + 1] for i in back)
    off = tuple(sorted(int(i) for i in set(bad)))
    detail = (
        f"{len(off)} real tile(s) break the (block-row, Z) schedule order"
        if off
        else ""
    )
    return [InvariantResult("order", not off, offending=off, detail=detail, **loc)]


def _check_coverage(
    v: _PlanView, loc: dict, require_full: bool = True
) -> list[InvariantResult]:
    """Row coverage + run contiguity: every block-row of the padded grid
    appears in ``tile_row`` (when ``require_full``), and each block-row
    forms one contiguous run of the schedule — the CUDA kernel gives a
    run's strip to its own blocks, so a second run of a row would write
    the strip again from a fresh seed and drop the first run's sum."""
    out = []
    if require_full:
        missing = np.setdiff1d(
            np.arange(v.n_row_blocks, dtype=np.int64), np.unique(v.tile_row)
        )
        out.append(
            InvariantResult(
                "coverage",
                not missing.size,
                offending=tuple(int(i) for i in missing),
                detail=(
                    f"{missing.size} block-row(s) have no tile (coverage "
                    "dummy missing) — kernel output undefined there"
                    if missing.size
                    else ""
                ),
                **loc,
            )
        )
    r = v.tile_row
    if r.size:
        change = np.r_[True, r[1:] != r[:-1]]
        first_seen: dict[int, int] = {}
        bad = []
        for i in np.flatnonzero(change):
            row = int(r[i])
            if row in first_seen:
                bad.append(int(i))
            else:
                first_seen[row] = int(i)
        out.append(
            InvariantResult(
                "coverage-contiguity",
                not bad,
                offending=tuple(bad),
                detail=(
                    f"{len(bad)} tile(s) start a second run for an already-"
                    "visited block-row (its strip would be seeded twice)"
                    if bad
                    else ""
                ),
                **loc,
            )
        )
    else:
        out.append(InvariantResult("coverage-contiguity", True, **loc))
    return out


def _real_perm_values(v: _PlanView) -> np.ndarray:
    slot = np.arange(v.cap)[None, :]
    real = slot < np.clip(v.nnz_in_tile, 0, v.cap)[:, None]
    return v.perm[real] if v.perm is not None else np.zeros(0, np.int64)


def _check_perm_bijection(
    views: list[tuple[_PlanView, dict]], kind_loc: dict
) -> list[InvariantResult]:
    """perm values over real slots, unioned across segments, must be a
    bijection onto ``0 .. nnz-1``."""
    if any(v.perm is None for v, _ in views):
        return []  # plans legitimately built without perm
    vals = np.concatenate([_real_perm_values(v) for v, _ in views]) if views else (
        np.zeros(0, np.int64)
    )
    n = vals.size
    ok = True
    detail = ""
    if n:
        uniq, counts = np.unique(vals, return_counts=True)
        dup = uniq[counts > 1]
        if vals.min() < 0:
            ok, detail = False, f"real slot carries negative perm {int(vals.min())}"
        elif dup.size:
            ok, detail = False, (
                f"{dup.size} source entr(ies) gathered more than once "
                f"(first duplicate id {int(dup[0])})"
            )
        elif uniq.size != n or int(vals.max()) != n - 1:
            ok, detail = False, (
                f"perm not onto 0..{n - 1}: {n} real slots cover "
                f"{uniq.size} distinct ids, max {int(vals.max())}"
            )
    return [InvariantResult("perm", ok, detail=detail, **kind_loc)]


def _check_ladder(
    caps: tuple[int, ...], views: list[_PlanView]
) -> list[InvariantResult]:
    if list(caps) != sorted(set(caps)):
        return [
            InvariantResult(
                "ladder", False, detail=f"segment caps not ascending distinct: {caps}"
            )
        ]
    out = []
    for j, v in enumerate(views):
        lo = caps[j - 1] if j else 0
        nnz = v.nnz_in_tile
        # real tiles must land in the half-open bucket (lo, caps[j]];
        # zero-nnz coverage tiles may live in any segment
        bad = np.flatnonzero((nnz > 0) & ((nnz <= lo) | (nnz > caps[j])))
        out.append(
            InvariantResult(
                "ladder",
                not bad.size,
                segment=j,
                offending=tuple(int(i) for i in bad),
                detail=(
                    f"{bad.size} tile(s) outside bucket ({lo}, {caps[j]}] "
                    f"(worst nnz {int(nnz[bad[0]])})"
                    if bad.size
                    else ""
                ),
            )
        )
    return out


#: RunIndex fields the run-index invariant compares (not the counters).
RUN_INDEX_FIELDS = (
    "ptr", "rows", "max_nnz", "units", "unit_ptr", "order", "unit_work",
    "n_tiles", "n_split_units",
)


def run_index_diff(a: RunIndex, b: RunIndex) -> tuple[str, ...]:
    """Names of the :data:`RUN_INDEX_FIELDS` on which two run indexes
    differ (values, shapes or dtypes; tensors compared on the host)."""
    bad = []
    for name in RUN_INDEX_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, int) or isinstance(y, int):
            same = x == y
        else:
            x, y = _np(x), _np(y)
            same = x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
        if not same:
            bad.append(name)
    return tuple(bad)


def _check_run_index(p: SCVPlan, v: _PlanView, loc: dict) -> list[InvariantResult]:
    """``p.runs`` must equal the run index of the segment's own schedule."""
    try:
        want = RunIndex.of(v.tile_row.astype(np.int32), v.nnz_in_tile)
    except ValueError as e:  # a block-row in two runs: no valid index exists
        return [InvariantResult("run-index", False, detail=str(e), **loc)]
    bad = run_index_diff(p.runs, want)
    return [
        InvariantResult(
            "run-index",
            not bad,
            detail=(
                f"run index disagrees with the segment's tiles on {', '.join(bad)} "
                "(built before its arrays changed?)"
                if bad
                else ""
            ),
            **loc,
        )
    ]


#: PlanRuns fields the chain's check compares (not the counters).
PLAN_RUNS_FIELDS = (
    "pieces", "units", "unit_ptr", "order", "run_row", "rows", "unit_work", "n_segments",
    "n_live", "max_nnz", "n_split_units",
)


def _check_chain_index(segments, checks: list, loc: dict) -> list[InvariantResult]:
    """The plan-level index a launch built for the chain over ``segments``
    (if any) must equal the one their run indexes give; reported only when
    every run-index check in ``checks`` held and it does not."""
    from repro_torch.kernels.scv_spmm.ops import chain_groups

    if any(c.invariant == "run-index" and not c.ok for c in checks):
        return []
    bad = []
    for k, positions in enumerate(chain_groups(len(segments))):
        group = tuple(segments[i].runs for i in positions)
        have = cached_plan_runs(group)
        if have is None:
            continue
        want = PlanRuns.of(group)
        for name in PLAN_RUNS_FIELDS:
            x, y = getattr(have, name), getattr(want, name)
            if isinstance(x, int):
                same = x == y
            else:
                x, y = _np(x), _np(y)
                same = x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
            if not same:
                bad.append(f"{name}[{k}]")
    if not bad:
        return []
    return [InvariantResult(
        "run-index", False,
        detail=f"the chain's plan-level index disagrees with its segments' run indexes on "
               f"{', '.join(bad)}", **loc)]


def _check_transposed(plan, loc: dict) -> list[InvariantResult]:
    """The transposed plan a backward built for ``plan`` (if any) must
    equal the one its current leaves give."""
    from repro_torch.core.scv import transposed_plan
    from repro_torch.kernels.scv_spmm.ops import cached_backward

    bw = cached_backward(plan)
    if bw is None:
        return []
    want = transposed_plan(plan)
    have_segs = getattr(bw.plan_t, "segments", (bw.plan_t,))
    want_segs = getattr(want, "segments", (want,))
    bad = []
    if len(have_segs) != len(want_segs):
        bad.append("segments")
    for j, (a, b) in enumerate(zip(have_segs, want_segs)):
        for name in _LEAVES:
            x, y = _np(getattr(a, name)), _np(getattr(b, name))
            if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(x, y):
                bad.append(f"{name}[{j}]")
    return [
        InvariantResult(
            "transposed",
            not bad,
            detail=(
                f"the backward's transposed plan disagrees with the plan's leaves on "
                f"{', '.join(bad)} (leaves changed in place after a backward?)"
                if bad
                else ""
            ),
            **loc,
        )
    ]


def _segment_entries(v: _PlanView) -> np.ndarray:
    """Real entries as a sortable (grow, gcol, val-bits) record array."""
    slot = np.arange(v.cap)[None, :]
    real = slot < np.clip(v.nnz_in_tile, 0, v.cap)[:, None]
    grow = (v.tile_row[:, None] * v.tile + v.rows)[real]
    gcol = (v.tile_col[:, None] * v.tile + v.cols)[real]
    bits = v.vals[real].astype(np.float32).view(np.uint32).astype(np.int64)
    rec = np.stack([grow.astype(np.int64), gcol.astype(np.int64), bits], 1)
    return rec[np.lexsort((rec[:, 2], rec[:, 1], rec[:, 0]))]


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def _validate_single(
    v: _PlanView,
    loc: dict,
    require_full_coverage: bool = True,
    plan: Optional[SCVPlan] = None,
) -> list[InvariantResult]:
    checks = _check_shape_aux(v, loc)
    if not checks[0].ok:  # malformed shapes: later vectorized checks would throw
        return checks
    checks += _check_bounds(v, loc)
    checks += _check_cap(v, loc)
    checks += _check_packing(v, loc)
    checks += _check_order(v, loc)
    checks += _check_coverage(v, loc, require_full=require_full_coverage)
    if plan is not None:
        checks += _check_run_index(plan, v, loc)
    return checks


def _validate_reassembly(
    views: list[_PlanView], coo: COOMatrix, loc: dict
) -> list[InvariantResult]:
    """The plan's real entries byte-match the source COO multiset."""
    got = (
        np.concatenate([_segment_entries(v) for v in views])
        if views
        else np.zeros((0, 3), np.int64)
    )
    got = got[np.lexsort((got[:, 2], got[:, 1], got[:, 0]))]
    bits = np.asarray(coo.vals, np.float32).view(np.uint32).astype(np.int64)
    want = np.stack(
        [np.asarray(coo.rows, np.int64), np.asarray(coo.cols, np.int64), bits], 1
    )
    want = want[np.lexsort((want[:, 2], want[:, 1], want[:, 0]))]
    ok = got.shape == want.shape and bool(np.array_equal(got, want))
    detail = ""
    if not ok:
        if got.shape[0] != want.shape[0]:
            detail = f"plan holds {got.shape[0]} entries, COO has {want.shape[0]}"
        else:
            first = int(np.flatnonzero((got != want).any(1))[0])
            detail = (
                f"entry multiset mismatch at sorted position {first}: "
                f"plan {got[first].tolist()} vs coo {want[first].tolist()}"
            )
    return [InvariantResult("reassembly", ok, detail=detail, **loc)]


def validate_plan(obj: Any, coo: Optional[COOMatrix] = None) -> ValidationReport:
    """Verify the full invariant chain of any plan-like object.

    Accepts :class:`SCVTiles`, :class:`SCVPlan`, :class:`SCVBucketedPlan`,
    ``core.exec.ShardedPlan``, ``models.gnn.Graph`` and
    ``models.gnn.BatchedGraph`` (serve composites).  With ``coo`` given,
    also checks that the plan's real entries byte-match the source COO.  Host-side; returns a
    :class:`ValidationReport` (``.raise_if_failed()`` at admission
    boundaries).
    """
    checks: list[InvariantResult] = []

    if hasattr(obj, "graph"):  # BatchedGraph composite
        inner = validate_plan(obj.graph, coo=coo)
        return ValidationReport(kind="batched-graph", checks=inner.checks)
    if hasattr(obj, "plan") and hasattr(obj, "n_nodes"):  # models.gnn.Graph
        inner = validate_plan(obj.plan, coo=coo)
        return ValidationReport(kind="graph", checks=inner.checks)

    if isinstance(obj, SCVTiles):
        v = _PlanView.of(obj)
        checks += _validate_single(v, {}, require_full_coverage=False)
        checks += _check_perm_bijection([(v, {})], {})
        if coo is not None:
            checks += _validate_reassembly([v], coo, {})
        return ValidationReport(kind="tiles", checks=tuple(checks))

    if isinstance(obj, SCVPlan):
        v = _PlanView.of(obj)
        checks += _validate_single(v, {}, plan=obj)
        checks += _check_chain_index((obj,), checks, {})
        checks += _check_perm_bijection([(v, {})], {})
        checks += _check_transposed(obj, {})
        if coo is not None:
            checks += _validate_reassembly([v], coo, {})
        return ValidationReport(kind="plan", checks=tuple(checks))

    if isinstance(obj, SCVBucketedPlan):
        views = []
        for j, seg in enumerate(obj.segments):
            v = _PlanView.of(seg)
            views.append((v, {"segment": j}))
            # only the first segment's launch defines the whole output;
            # later segments accumulate into the rows they visit
            checks += _validate_single(
                v, {"segment": j}, require_full_coverage=(j == 0), plan=seg
            )
        checks += _check_chain_index(obj.segments, checks, {})
        checks += _check_ladder(obj.caps, [v for v, _ in views])
        checks += _check_perm_bijection(views, {})
        checks += _check_transposed(obj, {})
        if coo is not None:
            checks += _validate_reassembly([v for v, _ in views], coo, {})
        return ValidationReport(kind="bucketed", checks=tuple(checks))

    if isinstance(obj, ShardedPlan):
        return _validate_sharded(obj, coo)

    raise TypeError(
        f"validate_plan: unsupported object {type(obj).__name__}; expected "
        "SCVTiles / SCVPlan / SCVBucketedPlan / ShardedPlan / Graph / "
        "BatchedGraph"
    )


def _validate_sharded(sp: ShardedPlan, coo: Optional[COOMatrix]) -> ValidationReport:
    checks: list[InvariantResult] = []
    tp = sp.decision.tile_parts
    views: list[tuple[_PlanView, dict]] = []
    covered: dict[int, set] = {}
    for j, spans in enumerate(sp.segments):
        if len(spans) != tp:
            checks.append(
                InvariantResult(
                    "shard-span", False, segment=j,
                    detail=f"{len(spans)} spans != decision.tile_parts {tp}",
                )
            )
            continue
        for p, span in enumerate(spans):
            v = _PlanView.of(span)
            loc = {"segment": j, "part": p}
            views.append((v, loc))
            # a span covers only the rows its tiles visit
            checks += _validate_single(v, loc, require_full_coverage=False, plan=span)
            covered.setdefault(j, set()).update(int(r) for r in np.unique(v.tile_row))
    # the spans of the FIRST segment must jointly visit every block-row: the
    # coverage dummies live there only, and each span's chain starts from
    # zeros, so later segments may visit any subset of rows
    if sp.segments:
        first = next((s for spans in sp.segments for s in spans), None)
        nb = first.padded_shape[0] // first.tile if first is not None else 0
        missing = sorted(set(range(nb)) - covered.get(0, set()))
        checks.append(
            InvariantResult(
                "shard-coverage",
                not missing,
                segment=0,
                offending=tuple(missing),
                detail=(
                    f"{len(missing)} block-row(s) unvisited by every span"
                    if missing
                    else ""
                ),
            )
        )
    checks += _check_perm_bijection(views, {})
    if all(len(spans) == tp for spans in sp.segments):
        for p in range(tp):
            chain = sp.span(p)
            if chain is not None:
                checks += _check_chain_index(getattr(chain, "segments", (chain,)), checks,
                                             {"part": p})
                checks += _check_transposed(chain, {"part": p})
    if coo is not None:
        checks += _validate_reassembly([v for v, _ in views], coo, {})
    return ValidationReport(kind="sharded", checks=tuple(checks))
