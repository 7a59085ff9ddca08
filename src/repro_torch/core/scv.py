"""Sparse Compressed Vectors — the SCV tile layout and its executable plans.

Port of ``src/repro/core/scv.py``:

* :class:`SCVTiles` — the host-side tile layout: entries regrouped into
  T x T tiles, each padded to a fixed entry capacity, tiles scheduled so
  that all tiles of one block-row are consecutive.  Built by
  :func:`coo_to_scv_tiles` with vectorized numpy, exactly as the reference.
* :class:`SCVPlan` — the executable plan: the same arrays as torch tensors
  (coverage dummies appended, perm padded), plus the port-only
  :class:`RunIndex` (block-row runs and their work units) the CUDA kernels
  schedule their blocks by.
* :class:`SCVBucketedPlan` — one ``SCVPlan`` segment per entry-capacity
  bucket; the kernel runs one launch per non-empty segment, chained
  through one output tensor.

Plans are dataclasses with tensor leaves and a ``.to(device)``; there is
no pytree registration, because the port runs eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import morton
from repro_torch.core.formats import COOMatrix
from repro_torch.kernels.scv_spmm.ops import ensure_row_coverage

ROW_MAJOR = "row_major"
ZMORTON = "zmorton"

# ---------------------------------------------------------------------------
# Kernel-model constants, copied from the reference.  They were set for the
# TPU (MXU/VPU rates, sublane counts); the port keeps them so its plans
# equal the reference's leaf for leaf, and measures its own on the H100.
# ---------------------------------------------------------------------------
#: VPU FMA-lane rate over MXU MAC rate (v5e: 8x128 lanes vs 128x128 MACs).
MXU_VPU_RATIO = 1.0 / 16.0
#: Entries per vectorized chunk of the reference's TPU kernel.
DEFAULT_CHUNK = 128
#: Geometric ratio between adjacent capacity buckets.
BUCKET_RATIO = 4
#: Maximum number of capacity buckets a plan is split into.
MAX_BUCKETS = 4
#: Smallest per-tile entry capacity (TPU sublane count).
MIN_BUCKET_CAP = 8
#: Default tile size T (block row/column extent of an SCV tile).
DEFAULT_TILE = 64
#: Default single-bucket per-tile capacity when bucketing is disabled.
DEFAULT_CAP = 64
#: Default serving capacity ladder.
DEFAULT_LADDER = (8, 32, 128)


def dense_tile_threshold(tile: int) -> int:
    """nnz above which the reference runs a T x T tile as a dense matmul
    instead of per-entry gather-FMA work:

        T*T*F / MXU_rate < nnz * F / VPU_rate  =>  nnz > T^2 * VPU/MXU
    """
    return int(tile * tile * MXU_VPU_RATIO)


def bucket_caps_for(
    counts: np.ndarray,
    tile: int,
    max_buckets: int = MAX_BUCKETS,
    ratio: int = BUCKET_RATIO,
) -> tuple[int, ...]:
    """Ascending power-of-two capacity ladder covering ``counts``.

    The largest cap is the smallest power of two holding the heaviest tile
    (clamped to T^2 — a tile cannot exceed its dense size); smaller caps
    descend geometrically by ``ratio`` down to ``MIN_BUCKET_CAP``.
    """
    hi = int(counts.max()) if len(counts) else 1
    hi = max(MIN_BUCKET_CAP, min(hi, tile * tile))
    cap = MIN_BUCKET_CAP
    while cap < hi:
        cap *= 2
    caps = [cap]
    while len(caps) < max_buckets and caps[-1] // ratio >= MIN_BUCKET_CAP:
        caps.append(caps[-1] // ratio)
    return tuple(sorted(caps))


def tile_nnz_histogram(a: COOMatrix, tile: int) -> np.ndarray:
    """Per-logical-tile entry counts — the input to ``bucket_caps_for``
    when deriving a ladder before tiles are built."""
    T = int(tile)
    nbc = -(-a.shape[1] // T)
    key = (a.rows // T).astype(np.int64) * nbc + (a.cols // T)
    _, counts = np.unique(key, return_counts=True)
    return counts


# ---------------------------------------------------------------------------
# host tile layout
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SCVTiles:
    """Static-shape tiled SCV (host numpy).

    ``tile_row/tile_col`` give each tile's block coordinates.  Entry arrays
    are padded to ``cap`` per tile; padding entries have val == 0 and
    row == col == 0.  Heavy tiles are split into chains of logical tiles
    sharing coordinates.  Schedule invariant: tiles with equal
    ``tile_row`` are consecutive.
    """

    tile_row: np.ndarray  # int32[nt]
    tile_col: np.ndarray  # int32[nt]
    rows: np.ndarray  # int32[nt, cap] — local row within tile
    cols: np.ndarray  # int32[nt, cap] — local col within tile
    vals: np.ndarray  # f32[nt, cap]
    nnz_in_tile: np.ndarray  # int32[nt]
    tile: int  # T
    cap: int
    shape: tuple[int, int]  # original (unpadded) matrix shape
    order: str
    perm: Optional[np.ndarray] = None  # int64[nt, cap]: source COO entry of each slot (-1 pad)

    @property
    def n_tiles(self) -> int:
        return int(self.tile_row.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.nnz_in_tile.sum())

    @property
    def padded_shape(self) -> tuple[int, int]:
        T = self.tile
        m, n = self.shape
        return (-(-m // T) * T, -(-n // T) * T)


def _auto_cap(counts: np.ndarray, tile: int) -> int:
    """Per-tile entry capacity minimizing padded slots (multiples of 8)."""
    if len(counts) == 0:
        return 8
    cands = []
    hi = int(min(counts.max(), tile * tile))
    c = 8
    while c < hi * 2:
        cands.append(c)
        c *= 2
    cands.append(max(8, hi))
    best, best_slots = cands[0], None
    for c in cands:
        slots = int((-(-counts // c) * c).sum())
        if best_slots is None or slots < best_slots:
            best, best_slots = c, slots
    return int(best)


def _tile_sort(a: COOMatrix, tile: int, order: str):
    """Sort entries into SCV column-vector order within tiles and schedule
    the tiles (block-row grouped; Z-Morton or column order inside a row)."""
    T = int(tile)
    m, n = a.shape
    nbc = -(-n // T)
    trow = (a.rows // T).astype(np.int64)
    tcol = (a.cols // T).astype(np.int64)
    lrow = (a.rows % T).astype(np.int64)
    lcol = (a.cols % T).astype(np.int64)
    tkey = trow * nbc + tcol
    eorder = np.argsort(tkey * (T * T) + lcol * T + lrow, kind="stable")
    tkey_s = tkey[eorder]
    if len(tkey_s):
        start = np.flatnonzero(np.r_[True, tkey_s[1:] != tkey_s[:-1]])
    else:
        start = np.zeros(0, np.int64)
    uniq = tkey_s[start]
    counts = np.diff(np.append(start, len(tkey_s))).astype(np.int64)
    utrow = (uniq // nbc).astype(np.int64)
    utcol = (uniq % nbc).astype(np.int64)
    if order == ZMORTON:
        zkey = morton.morton_encode(utrow, utcol)
        sched = np.lexsort((zkey, utrow))
    elif order == ROW_MAJOR:
        sched = np.lexsort((utcol, utrow))
    else:
        raise ValueError(f"unknown order {order!r}")
    return utrow, utcol, start, counts, sched, eorder, lrow[eorder], lcol[eorder], a.vals[eorder]


def coo_to_scv_tiles(
    a: COOMatrix,
    tile: int,
    cap: Optional[int] = None,
    order: str = ZMORTON,
) -> SCVTiles:
    """COO -> tile layout, by vectorized numpy scatter (no loop over
    tiles).  Heavy tiles (more than ``cap`` entries) split into chains of
    logical tiles sharing coordinates."""
    T = int(tile)
    utrow, utcol, start, counts, sched, eorder, lrow_s, lcol_s, vals_s = _tile_sort(
        a, T, order
    )
    if cap is None:
        cap = _auto_cap(counts, T)
    cap = int(cap)

    nu = len(counts)
    n_chunks = (-(-counts // cap)).astype(np.int64)
    cc = n_chunks[sched]  # chunks per scheduled tile
    nt = int(cc.sum()) if len(cc) else 0
    chunk_tile = np.repeat(sched, cc)
    first = np.cumsum(cc) - cc
    chunk_local = np.arange(nt, dtype=np.int64) - np.repeat(first, cc)

    tile_row = utrow[chunk_tile].astype(np.int32)
    tile_col = utcol[chunk_tile].astype(np.int32)
    nnz_out = np.minimum(
        cap, counts[chunk_tile] - chunk_local * cap
    ).astype(np.int32) if nt else np.zeros(0, np.int32)

    # sorted entry j of tile t lands in chunk chunk_first[t] + j // cap,
    # slot j % cap
    nnz = eorder.shape[0]
    rank = np.empty(nu, np.int64)
    rank[sched] = np.arange(nu, dtype=np.int64)
    chunk_first = first[rank]
    inv = np.repeat(np.arange(nu, dtype=np.int64), counts)
    pos = np.arange(nnz, dtype=np.int64) - np.repeat(start, counts)
    dst = (chunk_first[inv] + pos // cap) * cap + pos % cap
    rows_out = np.zeros(nt * cap, np.int32)
    cols_out = np.zeros(nt * cap, np.int32)
    vals_out = np.zeros(nt * cap, a.vals.dtype)
    perm_out = np.full(nt * cap, -1, np.int64)
    rows_out[dst] = lrow_s
    cols_out[dst] = lcol_s
    vals_out[dst] = vals_s
    perm_out[dst] = eorder
    return SCVTiles(
        tile_row=tile_row,
        tile_col=tile_col,
        rows=rows_out.reshape(nt, cap),
        cols=cols_out.reshape(nt, cap),
        vals=vals_out.reshape(nt, cap),
        nnz_in_tile=nnz_out,
        tile=T,
        cap=cap,
        shape=a.shape,
        order=order,
        perm=perm_out.reshape(nt, cap),
    )


# ---------------------------------------------------------------------------
# executable plans
# ---------------------------------------------------------------------------
def _tensor(a: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if device is None else t.to(device)


#: Most work (tiles + entries) one work unit of the CUDA vector body holds;
#: a single heavier tile is a unit of its own.  Sized on the H100 (PERF.md).
UNIT_WORK = 2048


def _unit_spans(ptr: np.ndarray, nnz: np.ndarray, limit: int):
    """Cut each run ``[ptr[r], ptr[r+1])`` into work units: consecutive tile
    spans of at most ``limit`` work (one tile and its entries each), a tile
    never split.  A run's trailing zero-nnz tiles lie in no unit; a run
    with no entry keeps one empty unit at its start.  Returns the spans'
    (begin, end), each unit's run and work, and whether its run has more
    than one unit."""
    starts, ends = ptr[:-1].astype(np.int64), ptr[1:].astype(np.int64)
    nt = nnz.shape[0]
    if nt == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z, np.zeros(0, bool)
    last_live = np.maximum.reduceat(np.where(nnz > 0, np.arange(1, nt + 1), 0), starts)
    live_end = np.maximum(last_live, starts)  # an all-zero run: an empty span
    cw = np.concatenate([[0], np.cumsum(1 + nnz.astype(np.int64))])
    run_work = cw[live_end] - cw[starts]
    split = run_work > limit
    begin, end, run = [starts], [live_end], [np.arange(starts.size)]
    for r in np.flatnonzero(split):  # few runs: the hubs
        b, stop, cuts = int(starts[r]), int(live_end[r]), []
        while b < stop:
            e = int(np.searchsorted(cw, cw[b] + limit, side="right")) - 1
            e = min(max(e, b + 1), stop)
            cuts.append((b, e))
            b = e
        c = np.array(cuts, np.int64)
        begin.append(c[:, 0])
        end.append(c[:, 1])
        run.append(np.full(len(cuts), r))
    keep = np.concatenate([~split, np.ones(sum(len(b) for b in begin[1:]), bool)])
    begin, end, run = (np.concatenate(a)[keep] for a in (begin, end, run))
    by_run = np.argsort(run, kind="stable")  # runs in order, each run's units in order
    begin, end, run = begin[by_run], end[by_run], run[by_run]
    # a run of one tile heavier than the limit is still one unit: not split
    in_split_run = np.bincount(run, minlength=starts.size)[run] > 1
    return begin, end, run, cw[end] - cw[begin], in_split_run


@dataclasses.dataclass(frozen=True)
class RunIndex:
    """Block-row runs of one segment's tile schedule, and their work units
    (port-only).

    A run is a maximal stretch of consecutive tiles with the same
    ``tile_row``; :meth:`of` refuses a schedule that visits a block-row in
    two runs.  The CUDA vector body schedules its thread blocks by *work
    unit*: a consecutive span of one run's tiles holding at most
    ``UNIT_WORK`` tiles plus entries (a heavier single tile is a unit of its
    own), so a hub block-row's long run is shared by several blocks.  A run
    of one unit has its strip to that unit's block alone; the units of a
    split run each write a partial strip to scratch, and the last of them
    to finish sums the seed and the partials in unit order, so the result
    is deterministic.  A run's trailing zero-nnz tiles (the serving
    composite's tile-count padding) lie in no unit; a run with no entry (a
    coverage dummy) keeps one empty unit, so its strip is still written.
    The scalar body keeps one block per run (``ptr``).

    Everything is computed on the host where plans are built, never by a
    device->host read at launch time: ``max_nnz`` (the heaviest tile's
    entry count) tells the launch wrapper whether a tile takes the dense
    branch, ``n_split_units`` how much scratch a launch needs.
    """

    ptr: torch.Tensor  # int32[n_runs + 1] — first tile of each run, then nt
    rows: np.ndarray  # int32[n_runs] — block-row of each run (host copy)
    max_nnz: int
    units: torch.Tensor  # int32[n_units, 4] — first tile, end tile, run, scratch slot (-1: run not split)
    unit_ptr: torch.Tensor  # int32[n_runs + 1] — first unit of each run, then n_units
    order: torch.Tensor  # int32[n_units] — launch order of the units, heaviest first
    unit_work: np.ndarray  # int64[n_units] — tiles + entries of each unit (host)
    n_tiles: int
    n_split_units: int  # units of runs cut into more than one (each has a scratch slot)
    # per (device, feature blocks): the split runs' arrival counters, zeroed
    # once; the kernel's last block of each run sets its counter back to 0
    _counters: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    @classmethod
    def of(cls, tile_row: np.ndarray, nnz_in_tile: np.ndarray, device=None) -> "RunIndex":
        tr = np.asarray(tile_row)
        nt = tr.shape[0]
        start = (
            np.flatnonzero(np.r_[True, tr[1:] != tr[:-1]])
            if nt else np.zeros(0, np.int64)
        )
        rows = tr[start].astype(np.int32)
        if np.unique(rows).size != rows.size:
            raise ValueError(
                "tile schedule visits a block-row in two separate runs; "
                "tiles of one block-row must be consecutive"
            )
        ptr = np.append(start, nt).astype(np.int32)
        nnz = np.asarray(nnz_in_tile)
        max_nnz = int(nnz.max()) if nnz.size else 0
        begin, end, run, work, split = _unit_spans(ptr, nnz, UNIT_WORK)
        slot = np.full(run.size, -1, np.int64)
        slot[split] = np.arange(int(split.sum()))
        unit_ptr = np.searchsorted(run, np.arange(rows.size + 1)).astype(np.int32)
        return cls(
            ptr=_tensor(ptr, device),
            rows=rows,
            max_nnz=max_nnz,
            units=_tensor(np.stack([begin, end, run, slot], 1).astype(np.int32), device),
            unit_ptr=_tensor(unit_ptr, device),
            order=_tensor(np.argsort(-work, kind="stable").astype(np.int32), device),
            unit_work=work,
            n_tiles=nt,
            n_split_units=int(split.sum()),
        )

    @property
    def n_runs(self) -> int:
        return int(self.rows.shape[0])

    @property
    def n_units(self) -> int:
        return int(self.unit_work.shape[0])

    @property
    def max_unit_work(self) -> int:
        return int(self.unit_work.max()) if self.unit_work.size else 0

    def counters(self, device, n_fblocks: int) -> torch.Tensor:
        """The split runs' arrival counters for launches on ``device`` with
        ``n_fblocks`` feature blocks: int32 ``[n_runs * n_fblocks]``, zeroed
        when first asked for and left at zero by every launch."""
        key = (str(torch.device(device)), n_fblocks)
        if key not in self._counters:
            self._counters[key] = torch.zeros(
                self.n_runs * n_fblocks, dtype=torch.int32, device=device
            )
        return self._counters[key]

    def to(self, device) -> "RunIndex":
        return dataclasses.replace(
            self, ptr=self.ptr.to(device), units=self.units.to(device),
            unit_ptr=self.unit_ptr.to(device), order=self.order.to(device),
        )


_LEAVES = ("tile_row", "tile_col", "rows", "cols", "vals", "nnz_in_tile", "perm")


@dataclasses.dataclass(frozen=True)
class SCVPlan:
    """Executable SCV aggregation plan: tensor leaves + static layout.

    Leaves ``tile_row``, ``tile_col``, ``rows``, ``cols``, ``vals``,
    ``nnz_in_tile`` and ``perm`` equal the reference plan's arrays for the
    same COO (``perm`` may be ``None``).  ``runs`` is the port's own
    schedule index for the CUDA kernel.  A plan always carries its coverage
    dummies — one zero-nnz tile per otherwise-unvisited block-row — and its
    ``perm`` is padded to the covered tile count with ``-1``.
    """

    tile_row: Any  # i32[nt] (coverage dummies included)
    tile_col: Any  # i32[nt]
    rows: Any  # i32[nt, cap] local row within tile
    cols: Any  # i32[nt, cap] local col within tile
    vals: Any  # f32[nt, cap] (0 in padding slots)
    nnz_in_tile: Any  # i32[nt]
    perm: Any  # i32[nt, cap] source COO entry per slot (-1 pad), or None
    tile: int
    cap: int
    shape: tuple[int, int]  # original (unpadded) matrix shape
    order: str
    runs: RunIndex

    @property
    def n_tiles(self) -> int:
        return int(self.tile_row.shape[0])

    @property
    def padded_shape(self) -> tuple[int, int]:
        T = self.tile
        m, n = self.shape
        return (-(-m // T) * T, -(-n // T) * T)

    @property
    def n_row_blocks(self) -> int:
        return self.padded_shape[0] // self.tile

    @property
    def device(self) -> torch.device:
        return self.tile_row.device

    def to(self, device) -> "SCVPlan":
        moved = {
            k: getattr(self, k).to(device)
            for k in _LEAVES if getattr(self, k) is not None
        }
        return dataclasses.replace(self, **moved, runs=self.runs.to(device))

    def with_vals(self, vals) -> "SCVPlan":
        """Same plan, re-weighted entry values (GAT's per-edge attention)."""
        return dataclasses.replace(self, vals=vals)

    def reweighted(self, edge_vals: torch.Tensor) -> "SCVPlan":
        """Same plan, tile values re-gathered from a per-edge array through
        the ``perm`` leaf.  Padding slots carry ``perm == -1`` and gather
        the appended zero."""
        if self.perm is None:
            raise ValueError(
                "per-edge re-weighting needs the plan's perm leaf; this plan "
                "was built without it (with_edges/with_perm disabled)"
            )
        ev = torch.cat([edge_vals, edge_vals.new_zeros(1)])
        return self.with_vals(ev[self.perm.long()].to(self.vals.dtype))


def plan_from_tiles(
    t: SCVTiles, ensure_coverage: bool = True, with_perm: bool = True, device=None
) -> SCVPlan:
    """SCVTiles (host) -> SCVPlan: coverage dummies, perm padding and the
    run index, in one place.  ``device=None`` keeps the leaves on the CPU
    (sharing memory with the host arrays)."""
    tr, tc, rs, cs, vs, nz = (
        t.tile_row, t.tile_col, t.rows, t.cols, t.vals, t.nnz_in_tile,
    )
    if ensure_coverage:
        tr, tc, rs, cs, vs, nz = ensure_row_coverage(
            tr, tc, rs, cs, vs, nz, t.padded_shape[0] // t.tile
        )
    perm = None
    if with_perm and t.perm is not None:
        if t.nnz >= 2**31:  # perm is i32; refuse to wrap silently
            raise ValueError(
                f"entry count {t.nnz} overflows the int32 perm leaf"
            )
        pp = np.full((len(tr), t.cap), -1, np.int32)
        pp[: t.perm.shape[0]] = t.perm.astype(np.int32)
        perm = _tensor(pp, device)
    return SCVPlan(
        tile_row=_tensor(tr, device),
        tile_col=_tensor(tc, device),
        rows=_tensor(rs, device),
        cols=_tensor(cs, device),
        vals=_tensor(vs, device),
        nnz_in_tile=_tensor(nz, device),
        perm=perm,
        tile=t.tile,
        cap=t.cap,
        shape=t.shape,
        order=t.order,
        runs=RunIndex.of(tr, nz, device),
    )


# ---------------------------------------------------------------------------
# nnz-bucketed capacity: per-bucket segments, per-segment cap
# ---------------------------------------------------------------------------
def bucket_tiles(t: SCVTiles, caps) -> tuple[SCVTiles, ...]:
    """Split tiles into capacity buckets: each tile goes to the smallest
    ``cap`` holding its nnz; entry arrays are truncated (or padded) to that
    cap.  Tiles keep their schedule order, so equal block-rows stay
    consecutive within every bucket."""
    caps = tuple(sorted(int(c) for c in caps))
    if len(set(caps)) != len(caps) or not caps:
        raise ValueError(f"caps must be non-empty and distinct, got {caps}")
    nnz = t.nnz_in_tile.astype(np.int64)
    if len(nnz) and int(nnz.max()) > caps[-1]:
        raise ValueError(
            f"heaviest tile has {int(nnz.max())} entries > largest bucket "
            f"cap {caps[-1]}; build tiles with cap <= caps[-1] first"
        )
    which = np.searchsorted(caps, nnz)  # nnz == cap lands in that bucket

    def fit(a: np.ndarray, cap: int, fill) -> np.ndarray:
        if a.shape[1] >= cap:
            return a[:, :cap]
        out = np.full((a.shape[0], cap), fill, a.dtype)
        out[:, : a.shape[1]] = a
        return out

    def subset(mask: np.ndarray, cap: int) -> SCVTiles:
        return SCVTiles(
            tile_row=t.tile_row[mask],
            tile_col=t.tile_col[mask],
            rows=fit(t.rows[mask], cap, 0),
            cols=fit(t.cols[mask], cap, 0),
            vals=fit(t.vals[mask], cap, 0),
            nnz_in_tile=t.nnz_in_tile[mask],
            tile=t.tile,
            cap=cap,
            shape=t.shape,
            order=t.order,
            perm=fit(t.perm[mask], cap, -1) if t.perm is not None else None,
        )

    return tuple(subset(which == b, cap) for b, cap in enumerate(caps))


@dataclasses.dataclass(frozen=True)
class SCVBucketedPlan:
    """Executable SCV plan split into capacity-bucket segments.

    Each segment holds the tiles whose nnz fits its cap.  Aggregation runs
    one kernel launch per non-empty segment, chained through one output
    tensor (``ops.scv_spmm_plan``): coverage dummies live in the first
    segment only, later launches accumulate into the rows they visit.
    """

    segments: tuple[SCVPlan, ...]

    def __post_init__(self):
        if not self.segments:
            raise ValueError("SCVBucketedPlan needs at least one segment")
        caps = [s.cap for s in self.segments]
        if sorted(set(caps)) != caps:
            raise ValueError(f"segment caps must be ascending and distinct: {caps}")
        s0 = self.segments[0]
        for s in self.segments[1:]:
            if (s.tile, s.shape, s.order) != (s0.tile, s0.shape, s0.order):
                raise ValueError("segments disagree on tile/shape/order")

    @property
    def tile(self) -> int:
        return self.segments[0].tile

    @property
    def shape(self) -> tuple[int, int]:
        return self.segments[0].shape

    @property
    def order(self) -> str:
        return self.segments[0].order

    @property
    def caps(self) -> tuple[int, ...]:
        return tuple(s.cap for s in self.segments)

    @property
    def n_tiles(self) -> int:
        return sum(s.n_tiles for s in self.segments)

    @property
    def padded_shape(self) -> tuple[int, int]:
        return self.segments[0].padded_shape

    @property
    def n_row_blocks(self) -> int:
        return self.segments[0].n_row_blocks

    @property
    def device(self) -> torch.device:
        return self.segments[0].device

    @property
    def perm(self):
        """Whether the plan supports per-edge re-weighting (all segments
        carry perm); exposed for feature tests, not for direct indexing."""
        perms = [s.perm for s in self.segments]
        return None if any(p is None for p in perms) else perms

    def to(self, device) -> "SCVBucketedPlan":
        return SCVBucketedPlan(tuple(s.to(device) for s in self.segments))

    def reweighted(self, edge_vals) -> "SCVBucketedPlan":
        return SCVBucketedPlan(
            tuple(s.reweighted(edge_vals) for s in self.segments)
        )


def plan_from_tiles_bucketed(
    t: SCVTiles,
    caps=None,
    ensure_coverage: bool = True,
    with_perm: bool = True,
    config=None,
    device=None,
) -> SCVBucketedPlan:
    """SCVTiles (host) -> nnz-bucketed plan.

    ``caps`` defaults to :func:`bucket_caps_for` over the tile nnz
    histogram; a ``TunedConfig`` may be passed as ``config`` instead.
    Coverage dummies are emitted once per plan, in the first segment only.
    """
    if config is not None:
        if caps is not None:
            raise ValueError("pass caps or config, not both")
        caps = tuple(config.bucket_caps) or (int(config.cap),)
    if caps is None:
        caps = bucket_caps_for(t.nnz_in_tile, t.tile)
    segs = bucket_tiles(t, caps)
    return SCVBucketedPlan(
        tuple(
            plan_from_tiles(
                s,
                ensure_coverage=(ensure_coverage and j == 0),
                with_perm=with_perm,
                device=device,
            )
            for j, s in enumerate(segs)
        )
    )
