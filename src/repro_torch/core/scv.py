"""Sparse Compressed Vectors — the SCV tile layout and its executable plans.

Port of ``src/repro/core/scv.py``:

* :class:`SCVMatrix` — the logical format of the paper's Fig. 1(d):
  fixed-height column vectors in row-major (SCV) or Z-Morton (SCV-Z)
  order, built by :func:`coo_to_scv`.  The simulator replays it.
* :class:`SCVTiles` — the host-side tile layout: entries regrouped into
  T x T tiles, each padded to a fixed entry capacity, tiles scheduled so
  that all tiles of one block-row are consecutive.  Built by
  :func:`coo_to_scv_tiles` with vectorized numpy, exactly as the reference.
* :class:`SCVPlan` — the executable plan: the same arrays as torch tensors
  (coverage dummies appended, perm padded), plus the port-only
  :class:`RunIndex` (block-row runs and their work units) the CUDA kernels
  schedule their blocks by.
* :class:`SCVBucketedPlan` — one ``SCVPlan`` segment per entry-capacity
  bucket; the vector body runs all of them in one launch over the
  plan-level index :class:`PlanRuns` (the reference: one launch per
  non-empty segment, chained through one output tensor).
* :class:`DenseTiles` and :func:`split_hybrid` — the hybrid layout's
  dense part (``core.aggregate.aggregate_hybrid``).

Plans are dataclasses with tensor leaves and a ``.to(device)``; there is
no pytree registration.  ``tree_flatten`` gives the reference's split into
leaves and static fields, which keys a captured forward
(``models.gnn.CapturedForward``).
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
#: Smallest tile count a serving composite's segment is padded to (the
#: counts go up in powers of two from here; an empty segment stays empty).
MIN_TILE_BUCKET = 8


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


def launched_slots(
    counts: np.ndarray,
    tile: int,
    caps: tuple[int, ...],
    n_row_blocks: int = 0,
) -> int:
    """Capacity slots a bucketed plan *launches* for a tile-nnz histogram.

    Mirrors the ``coo_to_scv_tiles(cap=caps[-1])`` +
    :func:`plan_from_tiles_bucketed` layout arithmetic without building the
    plan: a logical tile with ``k`` entries chain-splits at the top cap —
    ``k // caps[-1]`` full chunks occupy top-cap slot rows and the
    remainder lands in the smallest cap holding it.  ``n_row_blocks``
    (when given) adds one ``caps[0]`` slot row per output block row as the
    first-segment coverage-dummy bound — an upper bound, since block rows
    already covered by a first-segment tile need no dummy.

    This is the number the byte model must price (``3 * slots * B`` for
    the rows/cols/vals triple), not logical nnz.
    """
    caps_arr = np.asarray(sorted(int(c) for c in caps), dtype=np.int64)
    if caps_arr.size == 0:
        raise ValueError("caps must be non-empty")
    counts_arr = np.asarray(counts, dtype=np.int64)
    counts_arr = counts_arr[counts_arr > 0]
    top = int(caps_arr[-1])
    slots = int(n_row_blocks) * int(caps_arr[0])
    if counts_arr.size == 0:
        return slots
    slots += int((counts_arr // top).sum()) * top
    rem = counts_arr % top
    rem = rem[rem > 0]
    if rem.size:
        slots += int(caps_arr[np.searchsorted(caps_arr, rem)].sum())
    return slots


def tile_nnz_histogram(a: COOMatrix, tile: int) -> np.ndarray:
    """Per-logical-tile entry counts — the input to ``bucket_caps_for``
    when deriving a ladder before tiles are built."""
    T = int(tile)
    nbc = -(-a.shape[1] // T)
    key = (a.rows // T).astype(np.int64) * nbc + (a.cols // T)
    _, counts = np.unique(key, return_counts=True)
    return counts


# ---------------------------------------------------------------------------
# Logical SCV (paper Fig. 1(d))
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SCVMatrix:
    blk_ptr: np.ndarray  # int32[n_vectors+1] — start of each vector in vals
    vec_row_blk: np.ndarray  # int32[n_vectors] — block-row of each vector
    vec_col: np.ndarray  # int32[n_vectors] — matrix column of each vector
    blk_id: np.ndarray  # int32[nnz] — row offset within vector (< B)
    vals: np.ndarray  # f32[nnz]
    vector_height: int  # B
    order: str  # ROW_MAJOR (SCV) or ZMORTON (SCV-Z)
    shape: tuple[int, int]

    @property
    def n_vectors(self) -> int:
        return int(self.vec_col.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def index_bits_per_entry(self) -> int:
        """log2(B) bits per entry — the storage advantage over COO's
        log2(N) (§III-A)."""
        return max(1, int(np.ceil(np.log2(self.vector_height))))

    def to_coo(self) -> COOMatrix:
        counts = np.diff(self.blk_ptr)
        vrow = np.repeat(self.vec_row_blk, counts).astype(np.int64)
        vcol = np.repeat(self.vec_col, counts).astype(np.int32)
        rows = (vrow * self.vector_height + self.blk_id).astype(np.int32)
        return COOMatrix(rows, vcol, self.vals.copy(), self.shape)


def coo_to_scv(
    a: COOMatrix,
    vector_height: int,
    order: str = ZMORTON,
) -> SCVMatrix:
    """Build SCV/SCV-Z from COO.

    Vectors (non-empty column strips of height B) are enumerated either
    row-major over the (block_row, column) grid — plain SCV, Fig. 2(d) —
    or along a Z-Morton curve over B x B vector *groups* with column order
    inside a group — SCV-Z, Fig. 2(e).
    """
    if order not in (ROW_MAJOR, ZMORTON):
        raise ValueError(f"unknown order {order!r}")
    B = int(vector_height)
    if B <= 0:
        raise ValueError("vector_height must be positive")
    m, n = a.shape

    row_blk = (a.rows // B).astype(np.int64)
    blk_id = (a.rows % B).astype(np.int64)
    col = a.cols.astype(np.int64)

    if order == ROW_MAJOR:
        # vectors ordered (block_row, col); entries within vector by row
        vkey = row_blk * n + col
        entry_key = vkey * B + blk_id
    else:
        # Z-curve over (block_row, col // B) groups, columns in order
        # inside a group, rows in order inside a vector.
        grp = morton.morton_encode(row_blk, col // B).astype(np.uint64)
        # combined key: (zcurve group, local col, local row)
        local_col = (col % B).astype(np.uint64)
        entry_key = (grp * np.uint64(B) + local_col) * np.uint64(B) + blk_id.astype(
            np.uint64
        )
        vkey = grp * np.uint64(B) + local_col  # unique per vector, curve order

    eorder = np.argsort(entry_key, kind="stable")
    vkey_s = np.asarray(vkey)[eorder]
    uniq, start = np.unique(vkey_s, return_index=True)
    counts = np.diff(np.append(start, len(vkey_s)))
    blk_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    first = eorder[start]  # one representative entry per vector
    return SCVMatrix(
        blk_ptr=blk_ptr,
        vec_row_blk=row_blk[first].astype(np.int32),
        vec_col=col[first].astype(np.int32),
        blk_id=blk_id[eorder].astype(np.int32),
        vals=a.vals[eorder],
        vector_height=B,
        order=order,
        shape=a.shape,
    )


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

    @property
    def padding_fraction(self) -> float:
        tot = self.n_tiles * self.cap
        return 1.0 - self.nnz / tot if tot else 0.0

    def to_coo(self) -> COOMatrix:
        """The real entries (slots below each tile's nnz) as COO, in slot
        order."""
        T = self.tile
        rows = (self.tile_row[:, None].astype(np.int64) * T + self.rows).ravel()
        cols = (self.tile_col[:, None].astype(np.int64) * T + self.cols).ravel()
        keep = (np.arange(self.cap)[None, :] < self.nnz_in_tile[:, None]).ravel()
        return COOMatrix(
            rows[keep].astype(np.int32),
            cols[keep].astype(np.int32),
            self.vals.ravel()[keep],
            self.shape,
        )


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


def scv_to_tiles(a: SCVMatrix, cap: Optional[int] = None) -> SCVTiles:
    """Logical SCV -> tile layout at T = the vector height, in its order."""
    return coo_to_scv_tiles(a.to_coo(), a.vector_height, cap=cap, order=a.order)


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
    two runs.  Both CUDA bodies schedule their thread blocks by *work
    unit*: a consecutive span of one run's tiles holding at most
    ``UNIT_WORK`` tiles plus entries (a heavier single tile is a unit of its
    own), so a hub block-row's long run is shared by several blocks.  A run
    of one unit has its strip to that unit's block alone; the units of a
    split run sum their partial strips over a fixed binary tree of the
    run's units, through scratch, and the root adds the seed, so the
    result is deterministic.  A run's trailing zero-nnz tiles (the serving
    composite's tile-count padding) lie in no unit; a run with no entry (a
    coverage dummy) keeps one empty unit, so its strip is still written.
    The scalar body (replacing the TPU's ``_kernel_scalar``) is bound on the
    card by one entry's strip update after another, so it too takes one
    block per unit, and a hub run's entries are walked by several blocks at
    once.  No kernel reads ``ptr``: the ``run-index`` check of
    ``validate_plan`` and host code do.

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
    # host copies of ``ptr`` and of the tiles' nnz, from which the plan-level
    # index of a chain over several segments is built (:class:`PlanRuns`)
    tile_ptr: np.ndarray  # int32[n_runs + 1]
    tile_nnz: np.ndarray  # int32[n_tiles]
    # per (device, feature blocks): the split runs' merge counters, zeroed
    # once; the block that reads a merge-tree node's counter sets it to 0
    _counters: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )
    # the backward of the chain whose first launched segment this index
    # schedules (``ops._ScvChain``): its transposed plan and live-entry
    # index, built at the first backward; one entry, keyed by the run
    # indexes of all the chain's segments (a patched segment gets a new one)
    _backward: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )
    # the plan-level indexes of the chains whose first segment this index
    # schedules (:func:`plan_runs`), keyed by the ids of all their segments'
    # run indexes (a patched segment gets a new one)
    _plans: dict = dataclasses.field(
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
            tile_ptr=ptr,
            tile_nnz=nnz.astype(np.int32),
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
        """The split runs' merge counters for launches on ``device`` with
        ``n_fblocks`` feature blocks: int32 ``[n_units * n_fblocks]`` (one a
        node of a run's merge tree, named by a unit), zeroed when first
        asked for and left at zero by every launch."""
        key = (str(torch.device(device)), n_fblocks)
        if key not in self._counters:
            self._counters[key] = torch.zeros(
                self.n_units * n_fblocks, dtype=torch.int32, device=device
            )
        return self._counters[key]

    def to(self, device) -> "RunIndex":
        return dataclasses.replace(
            self, ptr=self.ptr.to(device), units=self.units.to(device),
            unit_ptr=self.unit_ptr.to(device), order=self.order.to(device),
        )

    @classmethod
    def padded(cls, n_tiles: int, n_row_blocks: int, cap: int, device) -> "RunIndex":
        """Unit tables sized from a segment's leaf shapes alone, for a
        launch captured in a CUDA graph (``models.gnn.CapturedForward``):
        the run index of any segment of ``n_tiles`` tiles of capacity
        ``cap`` over ``n_row_blocks`` block-rows fits them, and
        :meth:`load` copies it in.  The bounds, with ``W = n_tiles * (1 +
        cap)`` the most work such a segment holds: at most ``min(n_tiles,
        n_row_blocks)`` runs; two consecutive units of a split run hold
        more than ``UNIT_WORK`` work together, so a run of work ``w`` has
        fewer than ``2 w / UNIT_WORK + 1`` units, hence fewer than ``n_runs
        + 2 W / UNIT_WORK`` units in all (and never more than tiles) and
        fewer than ``3 W / UNIT_WORK`` in split runs.  ``max_nnz`` is the
        cap, so a launch keeps room for the dense branch whenever a tile
        of this shape could take it.  Units past the loaded ones have run
        -1: the kernels return from them at once."""
        n_runs = min(n_tiles, n_row_blocks)
        work = n_tiles * (1 + cap)
        n_units = min(n_tiles, n_runs + 2 * work // UNIT_WORK)
        pad = np.zeros((n_units, 4), np.int32)
        pad[:, 2:] = -1
        return cls(
            ptr=_tensor(np.zeros(n_runs + 1, np.int32), device),
            rows=np.arange(n_runs, dtype=np.int32),
            max_nnz=int(cap),
            units=_tensor(pad, device),
            unit_ptr=_tensor(np.zeros(n_runs + 1, np.int32), device),
            order=_tensor(np.arange(n_units, dtype=np.int32), device),
            unit_work=np.zeros(n_units, np.int64),
            n_tiles=n_tiles,
            n_split_units=min(n_units, 3 * work // UNIT_WORK),
            tile_ptr=np.zeros(n_runs + 1, np.int32),
            tile_nnz=np.zeros(n_tiles, np.int32),
        )

    def load(self, runs: "RunIndex") -> None:
        """Copy ``runs`` into these padded tables (:meth:`padded`), in place
        on the current stream: its units, then units of run -1 for the rest
        of the grid, with the launch order pointing past ``runs``'s units at
        one of them.  Raises if ``runs`` does not fit."""
        if (runs.n_tiles != self.n_tiles or runs.n_units > self.n_units
                or runs.n_runs > self.n_runs or runs.n_split_units > self.n_split_units):
            raise ValueError(
                f"run index of {runs.n_tiles} tiles, {runs.n_runs} runs, {runs.n_units} "
                f"units ({runs.n_split_units} split) does not fit tables for "
                f"{self.n_tiles} tiles, {self.n_runs} runs, {self.n_units} units "
                f"({self.n_split_units} split)"
            )
        n, k = runs.n_units, runs.n_runs
        self.units[:n].copy_(runs.units)
        self.units[n:, 2].fill_(-1)
        self.unit_ptr[: k + 1].copy_(runs.unit_ptr)
        self.order[:n].copy_(runs.order)
        self.order[n:].fill_(n)

    def clear(self) -> None:
        """Make every unit of these padded tables padding: a launch over
        them writes nothing (a segment that the replayed plan leaves
        empty)."""
        self.units[:, 2].fill_(-1)
        self.order.zero_()


def _live_ranges(runs: "RunIndex"):
    """Each run of one segment's index as the span the kernel walks: its
    block-row, first tile, the end of its last tile holding an entry (a run
    with none: its first tile), and the span's work (tiles + entries)."""
    ptr = runs.tile_ptr.astype(np.int64)
    nnz = runs.tile_nnz.astype(np.int64)
    starts = ptr[:-1]
    last_live = np.maximum.reduceat(np.where(nnz > 0, np.arange(1, nnz.size + 1), 0), starts)
    ends = np.maximum(last_live, starts)
    cw = np.concatenate([[0], np.cumsum(1 + nnz)])
    return runs.rows.astype(np.int64), starts, ends, cw[ends] - cw[starts]


@dataclasses.dataclass(frozen=True)
class PlanRuns:
    """The schedule of one vector-body launch over all the segments of a
    chain (port-only): a bucketed plan's segments, a span's, or one segment
    alone.

    A run is one block-row across every segment: the segments' runs of
    that row, in segment order, each cut to the tiles up to its last entry.
    A run is cut into work units of at most ``UNIT_WORK`` tiles + entries
    (a heavier tile is a unit of its own), walked in segment then tile
    order; a unit is a list of *pieces*, each a span of one segment's
    tiles.  So a light block-row's tiles of every capacity segment are one
    unit and one block, and its strip is written once; the units of a
    heavy run sum their partial strips over a fixed binary tree of the
    run's units and the root adds the seed
    (``csrc/scv_spmm.cu::finish_unit``), as a segment's own split runs do.
    A run whose segments' runs hold no entry keeps one unit of no piece,
    so its strip is still written.  Units launch heaviest first, over the
    whole chain.

    Built on the host from the segments' :class:`RunIndex` host copies
    (:meth:`of`), cached per chain by :func:`plan_runs`; a captured
    forward loads it into tables sized from the segments' shapes
    (:meth:`padded`, :meth:`load`).  No kernel reads ``rows``.
    """

    pieces: torch.Tensor  # int32[n_pieces, 4] — segment, first tile, end tile, 0
    # int32[n_units, 4] — first piece, end piece, run, scratch slot (-1: run not split)
    units: torch.Tensor
    unit_ptr: torch.Tensor  # int32[n_runs + 1] — first unit of each run, then n_units
    order: torch.Tensor  # int32[n_units] — launch order of the units, heaviest first
    run_row: torch.Tensor  # int32[n_runs] — block-row of each run
    rows: np.ndarray  # int32[n_runs] — host copy of run_row
    unit_work: np.ndarray  # int64[n_units] — tiles + entries of each unit (host)
    n_segments: int
    n_live: int  # segments with tiles
    max_nnz: int  # the fullest tile of any segment
    n_split_units: int  # units of runs cut into more than one (each has a scratch slot)
    _counters: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    @classmethod
    def of(cls, runs, device=None, limit: Optional[int] = None) -> "PlanRuns":
        """The plan-level index over the segments whose run indexes are
        ``runs`` (in segment order), with units of at most ``limit`` work
        (default ``UNIT_WORK``)."""
        limit = UNIT_WORK if limit is None else limit
        parts = [(k,) + _live_ranges(r) for k, r in enumerate(runs) if r.n_tiles]
        if parts:
            row, seg, b, e, w = (np.concatenate(a) for a in zip(*(
                (rw, np.full(rw.size, k), bb, ee, ww) for k, rw, bb, ee, ww in parts)))
        else:
            row = seg = b = e = w = np.zeros(0, np.int64)
        by = np.lexsort((seg, row))  # block-row, then segment
        row, seg, b, e, w = row[by], seg[by], b[by], e[by], w[by]
        run_rows, run_of = np.unique(row, return_inverse=True)
        n_runs = run_rows.size
        run_work = np.bincount(run_of, weights=w, minlength=n_runs).astype(np.int64)
        cut = run_work > limit
        # light runs: one unit, its pieces the run's live spans
        keep = (e > b) & ~cut[run_of]
        pieces = [np.stack([seg[keep], b[keep], e[keep]], 1)]
        light = np.flatnonzero(~cut)
        kept_run = run_of[keep]
        units = [np.stack([np.searchsorted(kept_run, light),
                           np.searchsorted(kept_run, light, "right"),
                           light, np.zeros(light.size, np.int64)], 1)]
        work = [run_work[light]]
        n_p = int(keep.sum())
        for r in np.flatnonzero(cut):  # few runs: the hubs
            live = np.flatnonzero((run_of == r) & (e > b))
            tile_work = np.concatenate([1 + runs[seg[i]].tile_nnz[b[i]:e[i]].astype(np.int64)
                                        for i in live])
            bound = np.concatenate([[0], np.cumsum(e[live] - b[live])])
            cw = np.concatenate([[0], np.cumsum(tile_work)])
            lo, n, sub = 0, tile_work.size, 0
            while lo < n:
                hi = int(np.searchsorted(cw, cw[lo] + limit, side="right")) - 1
                hi = min(max(hi, lo + 1), n)
                own = [(int(seg[i]), int(b[i] + max(lo, bound[j]) - bound[j]),
                        int(b[i] + min(hi, bound[j + 1]) - bound[j]))
                       for j, i in enumerate(live) if bound[j] < hi and bound[j + 1] > lo]
                pieces.append(np.array(own, np.int64).reshape(-1, 3))
                units.append(np.array([[n_p, n_p + len(own), r, sub]], np.int64))
                work.append(np.array([cw[hi] - cw[lo]], np.int64))
                n_p += len(own)
                lo, sub = hi, sub + 1
        pieces, units, work = (np.concatenate(a) for a in (pieces, units, work))
        by_run = np.lexsort((units[:, 3], units[:, 2]))  # runs in order, each run's units in order
        units, work = units[by_run], work[by_run]
        counts = np.bincount(units[:, 2], minlength=n_runs)
        split = counts[units[:, 2]] > 1
        units[:, 3] = -1
        units[split, 3] = np.arange(int(split.sum()))
        pieces = np.concatenate([pieces, np.zeros((pieces.shape[0], 1), np.int64)], 1)
        return cls(
            pieces=_tensor(pieces.astype(np.int32), device),
            units=_tensor(units.astype(np.int32), device),
            unit_ptr=_tensor(np.searchsorted(units[:, 2], np.arange(n_runs + 1)).astype(np.int32),
                             device),
            order=_tensor(np.argsort(-work, kind="stable").astype(np.int32), device),
            run_row=_tensor(run_rows.astype(np.int32), device),
            rows=run_rows.astype(np.int32),
            unit_work=work,
            n_segments=len(runs),
            n_live=len(parts),
            max_nnz=max((r.max_nnz for r in runs), default=0),
            n_split_units=int(split.sum()),
        )

    @property
    def n_runs(self) -> int:
        return int(self.rows.shape[0])

    @property
    def n_units(self) -> int:
        return int(self.unit_work.shape[0])

    @property
    def n_pieces(self) -> int:
        return int(self.pieces.shape[0])

    @property
    def max_unit_work(self) -> int:
        return int(self.unit_work.max()) if self.unit_work.size else 0

    def counters(self, device, n_fblocks: int) -> torch.Tensor:
        """The split runs' merge counters (as :meth:`RunIndex.counters`)."""
        key = (str(torch.device(device)), n_fblocks)
        if key not in self._counters:
            self._counters[key] = torch.zeros(
                self.n_units * n_fblocks, dtype=torch.int32, device=device
            )
        return self._counters[key]

    @classmethod
    def padded(cls, shapes, n_row_blocks: int, device) -> "PlanRuns":
        """Tables sized from the segments' shapes alone (``shapes``: each
        segment's ``(n_tiles, cap)``, in order), for a launch captured in a
        CUDA graph: the index of any chain over segments of those shapes
        and ``n_row_blocks`` block-rows fits them, and :meth:`load` copies
        it in.  With ``W`` the most work such segments hold (``sum n_tiles
        * (1 + cap)``) and ``L = UNIT_WORK``: at most ``n_row_blocks`` runs;
        fewer than ``n_runs + 2 W / L`` units (two consecutive units of a
        cut run hold more than ``L``) and never more than tiles, fewer than
        ``3 W / L`` of them in split runs; at most one piece per (segment,
        run) plus one per cut.  ``max_nnz`` is the largest cap, so a launch
        keeps room for the dense branch whenever a tile could take it.
        Units past the loaded ones have run -1: the kernel returns from
        them at once."""
        n_tiles = sum(nt for nt, _ in shapes)
        n_runs = min(n_tiles, n_row_blocks)
        work = sum(nt * (1 + cap) for nt, cap in shapes)
        n_units = max(1, min(n_tiles, n_runs + 2 * work // UNIT_WORK))
        n_pieces = sum(min(nt, n_row_blocks) for nt, _ in shapes) + n_units
        pad = np.zeros((n_units, 4), np.int32)
        pad[:, 2:] = -1
        return cls(
            pieces=_tensor(np.zeros((n_pieces, 4), np.int32), device),
            units=_tensor(pad, device),
            unit_ptr=_tensor(np.zeros(n_runs + 1, np.int32), device),
            order=_tensor(np.arange(n_units, dtype=np.int32), device),
            run_row=_tensor(np.zeros(n_runs, np.int32), device),
            rows=np.arange(n_runs, dtype=np.int32),
            unit_work=np.zeros(n_units, np.int64),
            n_segments=len(shapes),
            n_live=sum(1 for nt, _ in shapes if nt),
            max_nnz=max((int(cap) for _, cap in shapes), default=0),
            n_split_units=min(n_units, 3 * work // UNIT_WORK),
        )

    def load(self, runs: "PlanRuns") -> None:
        """Copy ``runs`` into these padded tables (:meth:`padded`), in place
        on the current stream: its pieces, units, runs and launch order,
        then units of run -1 for the rest of the grid, the launch order
        pointing past ``runs``'s units at one of them.  Raises if ``runs``
        does not fit."""
        if (runs.n_segments != self.n_segments or runs.n_units > self.n_units
                or runs.n_runs > self.n_runs or runs.n_pieces > self.n_pieces
                or runs.n_split_units > self.n_split_units):
            raise ValueError(
                f"plan run index of {runs.n_segments} segments, {runs.n_runs} runs, "
                f"{runs.n_units} units ({runs.n_split_units} split), {runs.n_pieces} pieces "
                f"does not fit tables for {self.n_segments} segments, {self.n_runs} runs, "
                f"{self.n_units} units ({self.n_split_units} split), {self.n_pieces} pieces"
            )
        n, k = runs.n_units, runs.n_runs
        self.pieces[: runs.n_pieces].copy_(runs.pieces)
        self.units[:n].copy_(runs.units)
        self.units[n:, 2].fill_(-1)
        self.unit_ptr[: k + 1].copy_(runs.unit_ptr)
        self.run_row[:k].copy_(runs.run_row)
        self.order[:n].copy_(runs.order)
        self.order[n:].fill_(n)

    def clear(self) -> None:
        """Make every unit of these padded tables padding: a launch over
        them writes nothing."""
        self.units[:, 2].fill_(-1)
        self.order.zero_()


#: Chains a run index keeps plan-level indexes for (:func:`plan_runs`).
_PLANS_KEPT = 4


def plan_runs(runs) -> PlanRuns:
    """The :class:`PlanRuns` of a chain over segments whose run indexes
    are ``runs`` (in segment order), built at its first launch and kept on
    the first segment's run index, keyed by the identity of every one (a
    patched segment gets a new run index, so a new plan-level index).
    Leaves changed in place under the same run indexes leave it stale, as
    they leave the run indexes; ``core.validate.validate_plan`` checks it."""
    runs = tuple(runs)
    cache = runs[0]._plans
    key = tuple(id(r) for r in runs)
    hit = cache.get(key)
    if hit is None or any(a is not b for a, b in zip(hit[0], runs)):
        hit = (runs, PlanRuns.of(runs, runs[0].units.device))
        cache.pop(key, None)
        while len(cache) >= _PLANS_KEPT:
            cache.pop(next(iter(cache)))
        cache[key] = hit
    return hit[1]


def cached_plan_runs(runs) -> Optional[PlanRuns]:
    """The :class:`PlanRuns` that :func:`plan_runs` keeps for a chain over
    ``runs``, or ``None`` (none built yet)."""
    runs = tuple(runs)
    hit = runs[0]._plans.get(tuple(id(r) for r in runs))
    if hit is None or any(a is not b for a, b in zip(hit[0], runs)):
        return None
    return hit[1]


def keep_plan_runs(runs, index: PlanRuns) -> None:
    """Make ``index`` the plan-level index of the chain over ``runs``
    (a captured forward's padded tables, :meth:`PlanRuns.padded`)."""
    runs = tuple(runs)
    runs[0]._plans[tuple(id(r) for r in runs)] = (runs, index)


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

    def tree_flatten(self):
        """Leaves and static fields, split as the reference's pytree splits
        them; ``runs`` is neither (the port's schedule index, derived from
        the leaves' content, which a captured forward copies into tables
        sized from the leaf shapes: :meth:`RunIndex.padded`)."""
        return (
            tuple(getattr(self, k) for k in _LEAVES),
            (self.tile, self.cap, self.shape, self.order),
        )

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
    the vector body once over all segments (``ops.scv_spmm_plan``, on the
    chain's :class:`PlanRuns`), the scalar body once per non-empty
    segment; coverage dummies live in the first segment only, so every
    block-row is a run of the chain.
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

    def tree_flatten(self):
        return (self.segments, ())

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


def plan_entries(plan) -> dict:
    """The live entries of a plan's segments, on the host, in flat slot
    order (segment by segment, each ``n_tiles x cap`` row-major): their
    ``flat`` slot index, segment ``seg``, tile ``t`` and slot ``s``, global
    row ``grow`` and column ``gcol``, value and source COO entry ``perm``
    (``None`` unless every segment carries perm).  Reads the leaves back
    once for a plan on the card."""
    segments = getattr(plan, "segments", (plan,))
    parts, offset = [], 0
    for k, seg in enumerate(segments):
        nt, cap = seg.rows.shape
        nnz = np.minimum(seg.nnz_in_tile.cpu().numpy().astype(np.int64), cap)
        t = np.repeat(np.arange(nt, dtype=np.int64), nnz)
        s = np.arange(t.size, dtype=np.int64) - np.repeat(np.cumsum(nnz) - nnz, nnz)
        tr, tc = seg.tile_row.cpu().numpy(), seg.tile_col.cpu().numpy()
        parts.append(dict(
            flat=offset + t * cap + s, seg=np.full(t.size, k), t=t, s=s,
            grow=tr[t].astype(np.int64) * seg.tile + seg.rows.cpu().numpy()[t, s],
            gcol=tc[t].astype(np.int64) * seg.tile + seg.cols.cpu().numpy()[t, s],
            vals=seg.vals.detach().cpu().numpy()[t, s],
            perm=None if seg.perm is None else seg.perm.cpu().numpy()[t, s].astype(np.int64),
        ))
        offset += nt * cap
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0] if k != "perm"}
    perms = [p["perm"] for p in parts]
    out["perm"] = None if any(p is None for p in perms) else np.concatenate(perms)
    return out


def transposed_plan(plan):
    """The plan of ``Âᵀ`` for ``plan`` (``SCVPlan`` or ``SCVBucketedPlan``),
    built by this module's builders with the forward's tile, order and
    capacities (a single-cap plan stays single-cap; a bucketed one keeps
    its ladder, heavy tiles split at its top cap), coverage dummies
    included, on the plan's device.

    Its entries come in the forward's source-COO order (flat slot order
    without perm), so its leaves equal those built from the transposed
    COO.  Its ``perm`` leaf maps each slot to its forward entry instead:
    the index into the segments' ``vals`` flattened and concatenated
    (-1 on padding), so ``reweighted(flat_vals)`` gathers the current
    forward values.  Backs the backward of ``ops.scv_spmm_plan``."""
    segments = getattr(plan, "segments", (plan,))
    e = plan_entries(plan)
    order = np.argsort(e["perm"], kind="stable") if e["perm"] is not None else slice(None)
    flat = e["flat"][order]
    if sum(s.rows.numel() for s in segments) >= 2**31:
        raise ValueError("forward plan has too many slots for an int32 gather index")
    m, n = plan.shape
    at = COOMatrix(e["gcol"][order].astype(np.int32), e["grow"][order].astype(np.int32),
                   e["vals"][order], (n, m))
    caps = tuple(s.cap for s in segments)
    tiles = coo_to_scv_tiles(at, plan.tile, cap=caps[-1], order=plan.order)
    tiles = dataclasses.replace(tiles, perm=np.where(tiles.perm >= 0, flat[tiles.perm], -1))
    dev = plan.device
    if isinstance(plan, SCVBucketedPlan):
        return plan_from_tiles_bucketed(tiles, caps=caps, device=dev)
    return plan_from_tiles(tiles, device=dev)


# ---------------------------------------------------------------------------
# hybrid dense-tile split
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DenseTiles:
    """Logical tiles dense enough for a dense product (nnz > T^2 *
    ``vpu_mxu_ratio``), densified."""

    tile_row: np.ndarray  # int32[nd]
    tile_col: np.ndarray  # int32[nd]
    blocks: np.ndarray  # f32[nd, T, T]
    tile: int
    shape: tuple[int, int]

    @property
    def n_tiles(self) -> int:
        return int(self.tile_row.shape[0])


def split_hybrid(
    tiles: SCVTiles, vpu_mxu_ratio: float = MXU_VPU_RATIO
) -> tuple[SCVTiles, DenseTiles]:
    """Partition logical tiles (all chain pieces of one coordinate pair
    together) by density: those with more than ``T^2 * vpu_mxu_ratio``
    entries become dense ``T x T`` blocks, ordered by ``tile_row << 32 |
    tile_col``; the rest keep the SCV layout, in schedule order.  The
    default ratio is the reference's TPU constant, kept for parity."""
    T = tiles.tile
    key = tiles.tile_row.astype(np.int64) * (2**32) + tiles.tile_col
    uniq, inv = np.unique(key, return_inverse=True)
    tot = np.zeros(len(uniq), np.int64)
    np.add.at(tot, inv, tiles.nnz_in_tile.astype(np.int64))
    is_dense = (tot > (T * T) * vpu_mxu_ratio)[inv]

    def subset(mask):
        return SCVTiles(
            tile_row=tiles.tile_row[mask],
            tile_col=tiles.tile_col[mask],
            rows=tiles.rows[mask],
            cols=tiles.cols[mask],
            vals=tiles.vals[mask],
            nnz_in_tile=tiles.nnz_in_tile[mask],
            tile=T,
            cap=tiles.cap,
            shape=tiles.shape,
            order=tiles.order,
            perm=tiles.perm[mask] if tiles.perm is not None else None,
        )

    sparse, dpart = subset(~is_dense), subset(is_dense)
    dkey = dpart.tile_row.astype(np.int64) * (2**32) + dpart.tile_col
    duniq, dinv = np.unique(dkey, return_inverse=True)
    blocks = np.zeros((len(duniq), T, T), np.float32)
    keep = np.arange(dpart.cap)[None, :] < dpart.nnz_in_tile[:, None]
    ti = np.repeat(dinv, dpart.cap)[keep.ravel()]
    np.add.at(blocks, (ti, dpart.rows[keep], dpart.cols[keep]), dpart.vals[keep])
    return sparse, DenseTiles(
        tile_row=(duniq >> 32).astype(np.int32),
        tile_col=(duniq & 0xFFFFFFFF).astype(np.int32),
        blocks=blocks,
        tile=T,
        shape=tiles.shape,
    )
