"""Delta plan maintenance: incremental edge mutation for SCV plans.

Port of ``src/repro/stream/delta.py``.  A :class:`DeltaBatch` of edge
inserts/removes and :func:`apply_delta`, which patches ``SCVTiles`` /
``SCVPlan`` / ``SCVBucketedPlan`` / ``Graph`` by splicing only the
Z-Morton tiles the delta touches, instead of re-running the O(nnz)
``coo_to_scv_tiles`` build.

The contract (the reference's, extended to the port's run index): the
patched object equals a from-scratch rebuild on the final COO,

    apply_delta(build(adj), d)  ==  build(apply_coo(adj, d))

leaf for leaf, dtype included, and for plans ``RunIndex`` field for field
(``core.validate.run_index_diff``).  The canonical final COO ordering is
**hole-filling** (see :class:`_IdPlan`): inserts take the removal holes in
ascending order, leftover inserts append, leftover holes are back-filled
by the moved tail survivors — so only the tiles holding delta coordinates
or moved survivors are rewritten, and no O(nnz) pass over the perm arrays
happens.  When removals outnumber inserts the moved survivors are located
by coordinate arithmetic on ``source`` (the pre-delta COO, or a
``Graph``'s own edge arrays), else by one blockwise scan of the perm
leaves.

Plan segments may live on the card.  The splice runs on the host: each
segment's schedule leaves (``tile_row`` / ``tile_col`` / ``nnz_in_tile``)
are read back whole, its entry leaves (``rows`` / ``cols`` / ``vals`` /
``perm``) only at the affected tiles.  The entry leaves are then written
on their own device: a segment whose chunk layout the delta leaves
unchanged (slack-absorbed splices: value updates, inserts into tiles with
room) gets copies of them with the rewritten chunk rows put in, its tile
coordinates shared by identity; a segment whose layout changes (tile birth
or death, a chain that grows or shrinks, a tile crossing a ladder
boundary) gets them re-laid out by one gather of its kept chunks and one
scatter of the re-emitted ones, its schedule leaves merged on the host.
Every patched segment gets a fresh :class:`RunIndex` built by
``RunIndex.of`` on its patched host schedule and placed on the plan's
device; a segment the delta does not touch keeps its plan object, its run
index and that index's counters, all by identity.  Copies between host and
card are counted in :data:`copies`.

Requirements on the input (``ValueError`` otherwise): plans carry the
``perm`` leaf; bucketed plans were chain-split at ``caps[-1]`` (the
``build_graph(bucket_caps=...)`` path); zero-nnz tiles form a trailing
coverage tail (true of every built plan; serving composites interleave
padding tiles and are not patchable — patch the members and reassemble).
A placed plan (``core.exec.ShardedPlan``, or a ``Graph`` holding one) is
refused with a ``TypeError``: patch the plan before placement and place
the patched plan again.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.formats import COOMatrix
from repro_torch.core.scv import RunIndex, SCVBucketedPlan, SCVPlan, SCVTiles


# ---------------------------------------------------------------------------
# host <-> device copies (counted; plans on the card only)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CopyStats:
    """Copies between host and card made by :func:`apply_delta`: bytes and
    host seconds each way (a device->host copy waits for the stream).  One
    record for the process, like the kernel wrapper's launch counts."""

    d2h_bytes: int = 0
    d2h_s: float = 0.0
    h2d_bytes: int = 0
    h2d_s: float = 0.0

    def reset(self) -> None:
        self.d2h_bytes = self.h2d_bytes = 0
        self.d2h_s = self.h2d_s = 0.0


copies = CopyStats()


def _host(a) -> np.ndarray:
    """numpy view (CPU tensor, array) or counted host copy (CUDA tensor)."""
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    if a.device.type == "cpu":
        return a.numpy()
    t0 = time.perf_counter()
    out = a.cpu().numpy()
    copies.d2h_s += time.perf_counter() - t0
    copies.d2h_bytes += out.nbytes
    return out


def _take(a, idx: np.ndarray) -> np.ndarray:
    """Host copy of ``a[idx]``: gathered on ``a``'s device first, so only
    the taken rows cross to the host."""
    if isinstance(a, torch.Tensor) and a.device.type != "cpu":
        return _host(a[torch.from_numpy(np.ascontiguousarray(idx)).to(a.device)])
    return _host(a)[idx]


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def _device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Tensor of ``a`` on ``device`` (shares memory on the CPU)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cpu":
        return t
    t0 = time.perf_counter()
    out = t.to(device)
    copies.h2d_s += time.perf_counter() - t0
    copies.h2d_bytes += a.nbytes
    return out


# ---------------------------------------------------------------------------
# the delta
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DeltaBatch:
    """One batch of edge mutations: removes apply first, then inserts.

    "Remove then insert the same coordinate" is therefore the value-update
    idiom; a removal removes **every** stored entry at its coordinate.
    """

    ins_rows: np.ndarray  # int32[ki]
    ins_cols: np.ndarray  # int32[ki]
    ins_vals: np.ndarray  # f32[ki]
    rem_rows: np.ndarray  # int32[kr]
    rem_cols: np.ndarray  # int32[kr]

    @classmethod
    def of(cls, inserts=(), removes=()) -> "DeltaBatch":
        """Build from ``[(row, col, val), ...]`` / ``[(row, col), ...]``."""
        ins = list(inserts)
        rem = list(removes)
        return cls(
            ins_rows=np.array([e[0] for e in ins], np.int32),
            ins_cols=np.array([e[1] for e in ins], np.int32),
            ins_vals=np.array([e[2] for e in ins], np.float32),
            rem_rows=np.array([e[0] for e in rem], np.int32),
            rem_cols=np.array([e[1] for e in rem], np.int32),
        )

    @property
    def n_insert(self) -> int:
        return int(self.ins_rows.shape[0])

    @property
    def n_remove(self) -> int:
        return int(self.rem_rows.shape[0])

    def __len__(self) -> int:
        return self.n_insert + self.n_remove

    def signature(self) -> bytes:
        """Framed byte digest input for delta-chained cache keys
        (``serve.plan_cache.delta_key``): dtype + length framing per
        array, so byte-aliased deltas of different shapes never collide."""
        parts = [b"delta;"]
        for a in (self.ins_rows, self.ins_cols, self.ins_vals,
                  self.rem_rows, self.rem_cols):
            arr = np.ascontiguousarray(a)
            parts.append(f"{arr.dtype.str}:{arr.shape[0]};".encode())
            parts.append(arr.tobytes())
        return b"".join(parts)


# ---------------------------------------------------------------------------
# admission (mirrors core.validate.check_coo)
# ---------------------------------------------------------------------------
def check_delta(
    delta: DeltaBatch,
    shape: Optional[tuple[int, int]] = None,
    coo: Optional[COOMatrix] = None,
) -> None:
    """Reject malformed deltas with a clear ``ValueError``.

    Structural checks (always): 1-D arrays agreeing on length, in-range
    non-negative node ids when ``shape`` (or ``coo``) is given, finite
    insert values, no duplicate insert or remove coordinates.  With
    ``coo`` given, presence too: every remove must match a stored edge,
    and an insert of a present edge is rejected unless the same coordinate
    is removed in this batch (the value-update idiom).  ``apply_delta``
    re-checks presence locally either way.
    """
    for name in ("ins_rows", "ins_cols", "ins_vals", "rem_rows", "rem_cols"):
        a = getattr(delta, name)
        if np.ndim(a) != 1:
            raise ValueError(f"delta.{name} must be 1-D, got ndim={np.ndim(a)}")
    if not (delta.ins_rows.shape == delta.ins_cols.shape == delta.ins_vals.shape):
        raise ValueError(
            "delta insert arrays disagree on length: "
            f"rows={delta.ins_rows.shape[0]} cols={delta.ins_cols.shape[0]} "
            f"vals={delta.ins_vals.shape[0]}"
        )
    if delta.rem_rows.shape != delta.rem_cols.shape:
        raise ValueError(
            "delta remove arrays disagree on length: "
            f"rows={delta.rem_rows.shape[0]} cols={delta.rem_cols.shape[0]}"
        )
    if shape is None and coo is not None:
        shape = coo.shape
    if shape is not None:
        m, n = shape
        for what, rr, cc in (
            ("insert", delta.ins_rows, delta.ins_cols),
            ("remove", delta.rem_rows, delta.rem_cols),
        ):
            if len(rr) == 0:
                continue
            if int(rr.min()) < 0 or int(cc.min()) < 0:
                raise ValueError(f"delta {what} node ids must be non-negative")
            if int(rr.max()) >= m or int(cc.max()) >= n:
                raise ValueError(
                    f"delta {what} node ids out of range for shape {shape}: "
                    f"max row {int(rr.max())}, max col {int(cc.max())}"
                )
    if delta.n_insert and not np.all(np.isfinite(delta.ins_vals)):
        bad = np.flatnonzero(~np.isfinite(np.asarray(delta.ins_vals)))
        raise ValueError(
            f"delta insert values must be finite; {len(bad)} non-finite "
            f"(first at {int(bad[0])})"
        )
    # duplicate coordinates within each op list are always ambiguous
    span = max(int(shape[1]) if shape is not None else 0, _coord_span(delta))
    ikey = _keys(delta.ins_rows, delta.ins_cols, span)
    rkey = _keys(delta.rem_rows, delta.rem_cols, span)
    for what, k in (("insert", ikey), ("remove", rkey)):
        if len(k) != len(np.unique(k)):
            raise ValueError(
                f"duplicate {what} coordinates in delta (each edge may be "
                f"{what}d at most once per batch)"
            )
    if coo is not None:
        # the stored edges in the delta's rows, sorted: enough to decide
        # presence, without sorting every stored edge
        cand = _in_rows(coo, np.concatenate([delta.rem_rows, delta.ins_rows]))
        ckey = np.sort(_keys(coo.rows[cand], coo.cols[cand], span))
        missing = ~_present(ckey, rkey)
        if missing.any():
            i = int(np.flatnonzero(missing)[0])
            raise ValueError(
                f"delta removes absent edge ({int(delta.rem_rows[i])}, "
                f"{int(delta.rem_cols[i])}); removes must match stored edges"
            )
        clash = _present(ckey, ikey) & ~_present(np.sort(rkey), ikey)
        if clash.any():
            i = int(np.flatnonzero(clash)[0])
            raise ValueError(
                f"delta inserts already-present edge ({int(delta.ins_rows[i])},"
                f" {int(delta.ins_cols[i])}); remove it in the same batch to "
                "update its value"
            )


def _coord_span(delta: DeltaBatch) -> int:
    hi = 0
    for a in (delta.ins_cols, delta.rem_cols):
        if len(a):
            hi = max(hi, int(np.asarray(a).max()) + 1)
    return hi


def _keys(rows, cols, span: int) -> np.ndarray:
    return np.asarray(rows, np.int64) * max(span, 1) + np.asarray(cols, np.int64)


def _in_rows(coo: COOMatrix, rows: np.ndarray) -> np.ndarray:
    """Ascending positions of the stored entries whose row is in ``rows``
    (one O(nnz) pass of indexing)."""
    mark = np.zeros(coo.shape[0], bool)
    mark[np.asarray(rows, np.int64)] = True
    return np.flatnonzero(mark[coo.rows])


def _present(sorted_keys: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Membership of ``query`` in ``sorted_keys`` (boolean per query)."""
    if len(sorted_keys) == 0 or len(query) == 0:
        return np.zeros(len(query), bool)
    idx = np.searchsorted(sorted_keys, query)
    idx = np.minimum(idx, len(sorted_keys) - 1)
    return sorted_keys[idx] == query


# ---------------------------------------------------------------------------
# the id plan: old entry position -> new entry position
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _IdPlan:
    """Bookkeeping for one delta's canonical final-COO ordering.

    **Hole-filling**: inserts take the removal holes in ascending order,
    leftover inserts append at the tail, leftover holes are back-filled by
    the *moved tail survivors* (the surviving entries past the new length
    ``L``, ascending), and the array truncates to ``L``.  Every survivor
    below ``L`` keeps its id.

    The fill queue is ``[insert 0..ki-1] + [tail survivors ascending]``;
    ``queue[j]`` lands at ``targets[j]``.
    """

    nnz_old: int
    ki: int  # insert count
    removed: np.ndarray  # sorted old positions removed
    L: int  # final entry count
    targets: np.ndarray  # ascending new positions receiving the fill queue
    tail_surv: np.ndarray  # ascending old positions of moved survivors


def _id_plan(removed: np.ndarray, nnz_old: int, ki: int) -> _IdPlan:
    kr = len(removed)
    L = nnz_old - kr + ki
    holes_below = removed[removed < L]
    extra = np.arange(nnz_old, L, dtype=np.int64)  # empty unless ki > kr
    targets = np.concatenate([holes_below, extra])
    q = np.arange(max(L, 0), nnz_old, dtype=np.int64)
    tail_surv = q[~_present(removed, q)]
    return _IdPlan(nnz_old, ki, removed, L, targets, tail_surv)


def _map_ids(ids: np.ndarray, p: _IdPlan) -> np.ndarray:
    """New ids for surviving old ids (identity except moved survivors)."""
    if p.tail_surv.size == 0 or ids.size == 0:
        return ids
    idx = np.searchsorted(p.tail_surv, ids)
    idxc = np.minimum(idx, len(p.tail_surv) - 1)
    moved = p.tail_surv[idxc] == ids
    out = ids.copy()
    out[moved] = p.targets[p.ki + idxc[moved]]
    return out


def _fill_array(a: np.ndarray, ins, p: _IdPlan) -> np.ndarray:
    """Apply the id plan to a per-entry array: keep the sub-``L`` prefix,
    scatter the fill queue (inserts then moved survivors) into targets."""
    out = np.empty(p.L, a.dtype)
    c = min(p.L, p.nnz_old)
    out[:c] = a[:c]
    out[p.targets] = np.concatenate([np.asarray(ins, a.dtype), a[p.tail_surv]])
    return out


def _fill_tensor(t: torch.Tensor, ins, p: _IdPlan) -> torch.Tensor:
    """:func:`_fill_array` on a tensor, on its own device."""
    dev = t.device
    out = t.new_empty(p.L)
    c = min(p.L, p.nnz_old)
    out[:c] = t[:c]
    fill = torch.cat([_device(np.asarray(ins, _np_dtype(t)), dev),
                      t[torch.from_numpy(p.tail_surv).to(dev)]])
    out[torch.from_numpy(p.targets).to(dev)] = fill
    return out


# ---------------------------------------------------------------------------
# COO reference semantics (the parity anchor)
# ---------------------------------------------------------------------------
def apply_coo(coo: COOMatrix, delta: DeltaBatch, check: bool = True) -> COOMatrix:
    """Canonical final COO under the hole-filling ordering (see
    :class:`_IdPlan`).  Every ``apply_delta`` overload equals its layer's
    builder applied to this result."""
    if check:
        check_delta(delta, coo=coo)
    span = coo.shape[1]
    cand = _in_rows(coo, delta.rem_rows)
    rkey = np.sort(_keys(delta.rem_rows, delta.rem_cols, span))
    removed = cand[_present(rkey, _keys(coo.rows[cand], coo.cols[cand], span))].astype(np.int64)
    p = _id_plan(removed, coo.nnz, delta.n_insert)
    return COOMatrix(
        rows=_fill_array(coo.rows, delta.ins_rows, p),
        cols=_fill_array(coo.cols, delta.ins_cols, p),
        vals=_fill_array(coo.vals, delta.ins_vals, p),
        shape=coo.shape,
    )


# ---------------------------------------------------------------------------
# splice core (shared by every plan layer)
# ---------------------------------------------------------------------------
#: The per-slot leaves of a chunk list (the rest is its schedule).
_ENTRY_LEAVES = ("rows", "cols", "vals", "perm")


@dataclasses.dataclass
class _Entries:
    """Flat per-entry view of the affected tiles, in build order
    (ascending tile key; within a tile by (local col, local row, id))."""

    tk: np.ndarray  # int64 — tile key trow * nbc + tcol
    lrow: np.ndarray
    lcol: np.ndarray
    vals: np.ndarray
    ids: np.ndarray  # int64 source COO positions


def _delta_tile_keys(delta: DeltaBatch, T: int, nbc: int):
    itk = (delta.ins_rows.astype(np.int64) // T) * nbc + (
        delta.ins_cols.astype(np.int64) // T
    )
    rtk = (delta.rem_rows.astype(np.int64) // T) * nbc + (
        delta.rem_cols.astype(np.int64) // T
    )
    return itk, rtk, np.unique(np.concatenate([itk, rtk]))


def _find_removed(e: _Entries, delta: DeltaBatch, rtk, T: int) -> np.ndarray:
    """Sorted source ids of the entries the delta removes, from the
    gathered delta-tile entries; raises on removes that match nothing."""
    TT = T * T
    ekey = e.tk * TT + e.lcol * T + e.lrow  # globally non-decreasing
    rkey = rtk * TT + (delta.rem_cols.astype(np.int64) % T) * T + (
        delta.rem_rows.astype(np.int64) % T
    )
    hit = np.searchsorted(ekey, rkey, side="right") > np.searchsorted(
        ekey, rkey, side="left"
    )
    if not hit.all():
        i = int(np.flatnonzero(~hit)[0])
        raise ValueError(
            f"delta removes absent edge ({int(delta.rem_rows[i])}, "
            f"{int(delta.rem_cols[i])})"
        )
    return np.sort(e.ids[_present(np.sort(rkey), ekey)])


def _moved_tile_keys(p: _IdPlan, source, perm_views, T: int, nbc: int) -> np.ndarray:
    """Tile keys holding the moved tail survivors.

    With ``source`` (anything with ``.rows`` / ``.cols`` of the pre-delta
    edges) this is coordinate arithmetic on <= ``n_remove`` positions.
    Without it, the perm arrays are scanned blockwise for slots whose id is
    a moved survivor; ``perm_views`` is ``[(ck, perm_2d_loader), ...]``.
    """
    if source is not None:
        rr = _take(source.rows, p.tail_surv).astype(np.int64)
        cc = _take(source.cols, p.tail_surv).astype(np.int64)
        return np.unique((rr // T) * nbc + (cc // T))
    vals = p.tail_surv  # sorted ascending
    keys = []
    block = 1 << 22
    for ck, load_perm in perm_views:
        perm = load_perm()
        flat = perm.reshape(-1)
        chunks = []
        for st in range(0, flat.size, block):
            blk = flat[st : st + block]
            idx = np.minimum(np.searchsorted(vals, blk), len(vals) - 1)
            hits = np.flatnonzero(vals[idx] == blk)
            if hits.size:
                chunks.append((hits + st) // perm.shape[1])
        if chunks:
            keys.append(ck[np.unique(np.concatenate(chunks))])
    return np.unique(np.concatenate(keys)) if keys else np.zeros(0, np.int64)


def _splice_entries(e: _Entries, delta: DeltaBatch, itk, p: _IdPlan, T: int) -> _Entries:
    """Remove + insert + re-id + re-sort the affected tiles' entries.

    ``e`` must contain every entry the delta removes AND every moved tail
    survivor (their ids change).  Raises on inserts of a coordinate still
    present after the removes."""
    TT = T * T
    ekey = e.tk * TT + e.lcol * T + e.lrow  # globally non-decreasing
    removed = _present(p.removed, e.ids)

    skey = ekey[~removed]
    ikey = itk * TT + (delta.ins_cols.astype(np.int64) % T) * T + (
        delta.ins_rows.astype(np.int64) % T
    )
    clash = np.searchsorted(skey, ikey, side="right") > np.searchsorted(
        skey, ikey, side="left"
    )
    if clash.any():
        i = int(np.flatnonzero(clash)[0])
        raise ValueError(
            f"delta inserts already-present edge ({int(delta.ins_rows[i])}, "
            f"{int(delta.ins_cols[i])}); remove it in the same batch to "
            "update its value"
        )
    if len(ikey) != len(np.unique(ikey)):
        raise ValueError("duplicate insert coordinates in delta")

    # survivors keep their ids (moved tail survivors re-mapped), insert j
    # takes targets[j]; one lexsort restores the builder's (tile key,
    # local col, local row, source id) entry order
    tk = np.concatenate([e.tk[~removed], itk])
    lrow = np.concatenate(
        [e.lrow[~removed], (delta.ins_rows.astype(np.int64) % T).astype(e.lrow.dtype)]
    )
    lcol = np.concatenate(
        [e.lcol[~removed], (delta.ins_cols.astype(np.int64) % T).astype(e.lcol.dtype)]
    )
    vals = np.concatenate([e.vals[~removed], delta.ins_vals.astype(e.vals.dtype)])
    ids = np.concatenate([_map_ids(e.ids[~removed], p), p.targets[: p.ki]])
    o = np.lexsort((ids, lrow, lcol, tk))
    return _Entries(tk[o], lrow[o], lcol[o], vals[o], ids[o])


@dataclasses.dataclass
class _Chunks:
    """Chunked (padded [k, cap]) form of a set of entries — the builder's
    emission arithmetic applied to just the affected tiles."""

    ck: np.ndarray  # int64[k] tile key per chunk
    local: np.ndarray  # int64[k] chain index within tile
    nnz: np.ndarray  # int32[k]
    rows: np.ndarray  # [k, cap]
    cols: np.ndarray
    vals: np.ndarray
    perm: np.ndarray  # [k, cap] source ids, -1 pad

    def __len__(self) -> int:
        return len(self.ck)


def _chunk_entries(e: _Entries, cap: int, dtypes) -> _Chunks:
    """Re-emit entries as capacity-``cap`` chunks — identical arithmetic
    to ``coo_to_scv_tiles``: entry j of a tile lands in chain chunk
    ``j // cap``, slot ``j % cap``; zero / -1 padding."""
    rdt, cdt, vdt, ndt, pdt = dtypes
    ne = len(e.tk)
    tstart = (
        np.flatnonzero(np.r_[True, e.tk[1:] != e.tk[:-1]]) if ne else np.zeros(0, np.int64)
    )
    utk = e.tk[tstart]
    tcounts = np.diff(np.append(tstart, ne)).astype(np.int64)
    n_ch = -(-tcounts // cap)
    k = int(n_ch.sum()) if len(n_ch) else 0
    first = np.cumsum(n_ch) - n_ch
    ck = np.repeat(utk, n_ch)
    local = np.arange(k, dtype=np.int64) - np.repeat(first, n_ch)
    nnz = (
        np.minimum(cap, np.repeat(tcounts, n_ch) - local * cap).astype(ndt)
        if k
        else np.zeros(0, ndt)
    )
    pos = np.arange(ne, dtype=np.int64) - np.repeat(tstart, tcounts)
    inv = np.repeat(np.arange(len(utk), dtype=np.int64), tcounts)
    dst = (first[inv] + pos // cap) * cap + pos % cap
    rows = np.zeros(k * cap, rdt)
    cols = np.zeros(k * cap, cdt)
    vals = np.zeros(k * cap, vdt)
    perm = np.full(k * cap, -1, pdt)
    rows[dst] = e.lrow
    cols[dst] = e.lcol
    vals[dst] = e.vals
    perm[dst] = e.ids
    return _Chunks(
        ck, local, nnz,
        rows.reshape(k, cap), cols.reshape(k, cap),
        vals.reshape(k, cap), perm.reshape(k, cap),
    )


def _chunk_locals(ck: np.ndarray) -> np.ndarray:
    """Chain index of each chunk within its (consecutive-equal-key) tile."""
    k = len(ck)
    if not k:
        return np.zeros(0, np.int64)
    run = np.flatnonzero(np.r_[True, ck[1:] != ck[:-1]])
    return np.arange(k, dtype=np.int64) - np.repeat(run, np.diff(np.append(run, k)))


def _affected_chunk_idx(ck: np.ndarray, aff_keys: np.ndarray) -> np.ndarray:
    """Indices of chunks whose tile key is in ``aff_keys`` (ck sorted)."""
    lo = np.searchsorted(ck, aff_keys, side="left")
    hi = np.searchsorted(ck, aff_keys, side="right")
    spans = [np.arange(a, b) for a, b in zip(lo, hi) if b > a]
    return np.concatenate(spans) if spans else np.zeros(0, np.int64)


def _gather_entries(nnz, ck, rows, cols, vals, perm) -> _Entries:
    """Flatten the real slots of the given chunks (rows of the arrays, in
    stored order)."""
    a_nnz = nnz.astype(np.int64)
    keep = np.arange(rows.shape[1])[None, :] < a_nnz[:, None]
    return _Entries(
        tk=np.repeat(ck, a_nnz),
        lrow=rows[keep].astype(np.int64),
        lcol=cols[keep].astype(np.int64),
        vals=vals[keep],
        ids=perm[keep].astype(np.int64),
    )


def _new_positions(ck_u, local_u, ck_n, local_n) -> np.ndarray:
    """Positions of the new (n) chunks when merged with the unaffected (u)
    ones under the global (tile key, chain index) schedule order; the
    unaffected chunks fill the other positions in order.  Both inputs are
    sorted and share no tile key, so one searchsorted merge is exact."""
    span = int(
        max(local_u.max() if len(local_u) else 0,
            local_n.max() if len(local_n) else 0)
    ) + 1
    ku = ck_u * span + local_u
    kn = ck_n * span + local_n
    return np.arange(len(kn), dtype=np.int64) + np.searchsorted(ku, kn)


# ---------------------------------------------------------------------------
# SCVTiles patch (host numpy)
# ---------------------------------------------------------------------------
def _tiles_geometry(t) -> tuple[int, int, int]:
    T = int(t.tile)
    m, n = t.shape
    return T, -(-m // T), -(-n // T)  # T, n_block_rows, n_block_cols


def _apply_tiles(
    t: SCVTiles, delta: DeltaBatch, inplace: bool, source=None
) -> tuple[SCVTiles, _IdPlan]:
    if t.perm is None:
        raise ValueError(
            "apply_delta needs the perm bookkeeping; build tiles with "
            "coo_to_scv_tiles (perm enabled) first"
        )
    nnz = np.asarray(t.nnz_in_tile)
    if len(nnz) and int(nnz.min()) <= 0:
        raise ValueError(
            "apply_delta on SCVTiles requires build-form tiles (no zero-nnz "
            "tiles); patch plans, not composites, for coverage-dummy handling"
        )
    T, _, nbc = _tiles_geometry(t)
    cap = int(t.cap)
    ck = t.tile_row.astype(np.int64) * nbc + t.tile_col.astype(np.int64)
    if len(ck) > 1 and not np.all(ck[1:] >= ck[:-1]):
        raise ValueError("tiles are not in schedule (ascending tile key) order")
    itk, rtk, aff = _delta_tile_keys(delta, T, nbc)
    aff_idx = _affected_chunk_idx(ck, aff)
    n_entries = int(nnz.sum())

    def gather(idx):
        return _gather_entries(
            nnz[idx], ck[idx], t.rows[idx], t.cols[idx], t.vals[idx], t.perm[idx]
        )

    e = gather(aff_idx)
    p = _id_plan(_find_removed(e, delta, rtk, T), n_entries, delta.n_insert)
    if p.L >= 2**31:
        raise ValueError("patched entry count overflows int32 source ids")
    if p.tail_surv.size:
        # moved tail survivors change id: their tiles join the affected set
        moved = _moved_tile_keys(p, source, [(ck, lambda: t.perm)], T, nbc)
        aff_idx = _affected_chunk_idx(ck, np.union1d(aff, moved))
        e = gather(aff_idx)
    merged = _splice_entries(e, delta, itk, p, T)
    new = _chunk_entries(
        merged, cap, (t.rows.dtype, t.cols.dtype, t.vals.dtype, nnz.dtype, t.perm.dtype)
    )

    local = _chunk_locals(ck)
    layout_equal = (
        len(new) == len(aff_idx)
        and np.array_equal(new.ck, ck[aff_idx])
        and np.array_equal(new.local, local[aff_idx])
    )
    if layout_equal:
        if inplace:
            rows, cols, vals = t.rows, t.cols, t.vals
            nz, perm = t.nnz_in_tile, t.perm
        else:
            # functional: copy only the leaves the patch writes; the layout
            # leaves tile_row / tile_col stay shared by identity
            rows, cols, vals = t.rows.copy(), t.cols.copy(), t.vals.copy()
            nz, perm = t.nnz_in_tile.copy(), t.perm.copy()
        rows[aff_idx] = new.rows
        cols[aff_idx] = new.cols
        vals[aff_idx] = new.vals
        nz[aff_idx] = new.nnz
        perm[aff_idx] = new.perm
        if inplace:
            return t, p
        return dataclasses.replace(
            t, rows=rows, cols=cols, vals=vals, nnz_in_tile=nz, perm=perm
        ), p

    # chain lengths changed (tile birth/death or a crossed chunk boundary):
    # interleave the surviving chunks with the re-emitted ones
    un_idx = np.setdiff1d(np.arange(len(ck)), aff_idx, assume_unique=True)
    pos_n = _new_positions(ck[un_idx], local[un_idx], new.ck, new.local)
    relayout = _Relayout(len(ck), aff_idx, pos_n, 0, torch.device("cpu"))
    fresh = dict(tile_row=(new.ck // nbc).astype(t.tile_row.dtype),
                 tile_col=(new.ck % nbc).astype(t.tile_col.dtype), nnz_in_tile=new.nnz,
                 **{f: getattr(new, f) for f in _ENTRY_LEAVES})
    out = {f: relayout.leaf(torch.from_numpy(getattr(t, f)), a, -1 if f == "perm" else 0).numpy()
           for f, a in fresh.items()}
    return dataclasses.replace(t, **out), p


class _Relayout:
    """A re-laid-out chunk list: the kept chunks of the old list (all but
    ``aff_idx``), in order, fill every position but ``pos_n``, where the
    re-emitted chunks go; ``tail`` positions follow (coverage dummies).
    Gathers and scatters run on ``device``, where the leaves live."""

    def __init__(self, n_old: int, aff_idx: np.ndarray, pos_n: np.ndarray, tail: int, device):
        n = n_old - len(aff_idx) + len(pos_n)
        self.size = n + tail
        keep = torch.ones(n_old, dtype=torch.bool, device=device)
        keep[torch.from_numpy(aff_idx).to(device)] = False
        self.pos_n = torch.from_numpy(pos_n).to(device)
        is_new = torch.zeros(n, dtype=torch.bool, device=device)
        is_new[self.pos_n] = True
        self.src = keep.nonzero().squeeze(1)
        self.dst = (~is_new).nonzero().squeeze(1)

    def leaf(self, old: torch.Tensor, new: np.ndarray, fill) -> torch.Tensor:
        """``old`` re-laid out, ``new`` written at the new chunks' rows."""
        out = torch.full((self.size, *old.shape[1:]), fill, dtype=old.dtype, device=old.device)
        out[self.dst] = old[self.src]  # ids outside affected tiles unchanged
        out[self.pos_n] = _device(np.ascontiguousarray(new), old.device)
        return out


# ---------------------------------------------------------------------------
# plan segments (SCVPlan, SCVBucketedPlan): coverage tail and run index kept
# ---------------------------------------------------------------------------
def _real_prefix(nnz: np.ndarray) -> int:
    """Length of the real-tile prefix; built plans keep every zero-nnz
    coverage dummy in one trailing tail."""
    nt_real = int(np.count_nonzero(nnz))
    if nt_real and int(nnz[:nt_real].min()) <= 0:
        raise ValueError(
            "apply_delta needs a built plan (zero-nnz tiles must form a "
            "trailing coverage tail); serving composites are not patchable "
            "— patch the member plans and reassemble"
        )
    return nt_real


def _coverage_tail(tile_row_real: np.ndarray, nbr: int) -> np.ndarray:
    """Block-rows needing a coverage dummy, ascending — matching
    ``ensure_row_coverage``'s append order."""
    counts = np.bincount(tile_row_real.astype(np.int64), minlength=nbr)
    return np.flatnonzero(counts[:nbr] == 0)


class _SegView:
    """Host view of one plan segment's real (non-dummy) chunks.

    The schedule leaves (``tile_row``, ``tile_col``, ``nnz_in_tile``) are
    read whole; the entry leaves only at the affected chunks
    (:meth:`take`), or whole when the perm is scanned (:meth:`full`)."""

    def __init__(self, s: SCVPlan, nbc: int, aff_keys: np.ndarray):
        if s.perm is None:
            raise ValueError(
                "apply_delta needs the plan's perm leaf; this plan was built "
                "without it (with_perm disabled)"
            )
        self.seg = s
        self.tile_row_all = _host(s.tile_row)
        self.nnz_all = _host(s.nnz_in_tile)
        self.k = k = _real_prefix(self.nnz_all)
        self.tile_row = self.tile_row_all[:k]
        self.tile_col = _host(s.tile_col)[:k]
        self.nnz = self.nnz_all[:k]
        self.ck = self.tile_row.astype(np.int64) * nbc + self.tile_col.astype(np.int64)
        if len(self.ck) > 1 and not np.all(self.ck[1:] >= self.ck[:-1]):
            raise ValueError("segment tiles are not in schedule (ascending tile key) order")
        self.aff_idx = _affected_chunk_idx(self.ck, aff_keys)
        self._full: dict = {}

    def full(self, name: str) -> np.ndarray:
        if name not in self._full:
            self._full[name] = _host(getattr(self.seg, name))[: self.k]
        return self._full[name]

    def take(self, name: str, idx: np.ndarray) -> np.ndarray:
        if name in self._full:
            return self._full[name][idx]
        return _take(getattr(self.seg, name), idx)

    def entries(self) -> _Entries:
        idx = self.aff_idx
        return _gather_entries(
            self.nnz[idx], self.ck[idx],
            *(self.take(f, idx) for f in ("rows", "cols", "vals", "perm")),
        )


def _check_chain_split(views: list[_SegView], cap_build: int) -> None:
    """Affected tiles must obey the chain contract reconstruction relies
    on: at most one chunk per tile below the build capacity, and it is the
    chain's last.  Chunks are read in descending-cap order exactly as
    :func:`_gather_segments` reconstructs chains (full chunks live in the
    top segment, the partial tail wherever its nnz bucketed it)."""
    ckc = np.concatenate([v.ck[v.aff_idx] for v in reversed(views)])
    nzc = np.concatenate([v.nnz[v.aff_idx] for v in reversed(views)])
    if not len(ckc):
        return
    o = np.argsort(ckc, kind="stable")
    ckc, nzc = ckc[o], nzc[o]
    last = np.r_[ckc[1:] != ckc[:-1], True]
    bad = nzc[~last] != cap_build
    if bad.any():
        raise ValueError(
            "bucketed plan was not chain-split at caps[-1] "
            f"({cap_build}): an affected tile has a non-final chunk with "
            f"nnz={int(nzc[~last][bad][0])}; rebuild via "
            "build_graph(bucket_caps=...) before applying deltas"
        )


def _gather_segments(views: list[_SegView]) -> _Entries:
    """Reconstruct the affected tiles' entry chains: a descending-cap
    concatenation followed by a stable sort on tile key restores every
    chain (all full chunks in the top segment in chain order, the partial
    chunk last)."""
    parts = [v.entries() for v in reversed(views)]
    e = _Entries(*(np.concatenate([getattr(p, f) for p in parts])
                   for f in ("tk", "lrow", "lcol", "vals", "ids")))
    o = np.argsort(e.tk, kind="stable")
    return _Entries(e.tk[o], e.lrow[o], e.lcol[o], e.vals[o], e.ids[o])


def _patch_segment(
    v: _SegView, newc: _Chunks, sel: np.ndarray, nbr: int, nbc: int, first: bool
) -> SCVPlan:
    """One segment after the splice: its unaffected chunks plus the
    re-emitted chunks ``newc[sel]``, a coverage tail (first segment only)
    and a fresh run index, on the segment's device."""
    s = v.seg
    dev = s.device
    cap_b = s.cap
    ck_n = newc.ck[sel]
    if np.array_equal(ck_n, v.ck[v.aff_idx]):
        # the layout stands: the same chunks at the same positions (the
        # affected tiles lose all their chunks here, so equal keys mean
        # equal chain indices), only their entries and nnz change; write
        # those rows into copies of the entry leaves, on their device
        idx = torch.from_numpy(v.aff_idx).to(dev)
        leaves = {}
        for name in _ENTRY_LEAVES:
            a = getattr(s, name).clone()
            a[idx] = _device(np.ascontiguousarray(getattr(newc, name)[sel][:, :cap_b]), dev)
            leaves[name] = a
        nnz = v.nnz_all.copy()
        nnz[v.aff_idx] = newc.nnz[sel]
        leaves["nnz_in_tile"] = _device(nnz, dev)
        return dataclasses.replace(
            s, **leaves, runs=RunIndex.of(v.tile_row_all, nnz, dev)
        )
    # the layout changes: the schedule leaves are merged on the host (the
    # run index needs them there), the entry leaves on their device
    un_idx = np.setdiff1d(np.arange(v.k), v.aff_idx, assume_unique=True)
    # surviving chunks keep complete chains, so their within-segment chain
    # indices stay valid merge keys
    local_u = _chunk_locals(v.ck)[un_idx]
    pos_n = _new_positions(v.ck[un_idx], local_u, ck_n, _chunk_locals(ck_n))
    host = _Relayout(v.k, v.aff_idx, pos_n, 0, torch.device("cpu"))
    sched = {
        name: host.leaf(torch.from_numpy(old), new, 0).numpy()
        for name, old, new in (
            ("tile_row", v.tile_row, (ck_n // nbc).astype(v.tile_row.dtype)),
            ("tile_col", v.tile_col, (ck_n % nbc).astype(v.tile_col.dtype)),
            ("nnz_in_tile", v.nnz, newc.nnz[sel]),
        )
    }
    # only the first segment owes a coverage-dummy tail (later segments
    # accumulate into the rows they visit)
    missing = _coverage_tail(sched["tile_row"], nbr) if first else np.zeros(0, np.int64)
    kd = len(missing)
    tail = {"tile_row": missing, "tile_col": np.zeros(kd), "nnz_in_tile": np.zeros(kd)}
    sched = {name: np.concatenate([a, tail[name].astype(a.dtype)]) for name, a in sched.items()}
    relayout = _Relayout(v.k, v.aff_idx, pos_n, kd, dev)
    entries = {
        name: relayout.leaf(getattr(s, name), getattr(newc, name)[sel][:, :cap_b],
                            -1 if name == "perm" else 0)
        for name in _ENTRY_LEAVES
    }
    return dataclasses.replace(
        s,
        **entries,
        **{name: _device(a, dev) for name, a in sched.items()},
        runs=RunIndex.of(sched["tile_row"], sched["nnz_in_tile"], dev),
    )


def _apply_segments(
    segments: tuple[SCVPlan, ...], delta: DeltaBatch, source=None
) -> tuple[tuple[SCVPlan, ...], _IdPlan]:
    """Patch one plan's capacity segments (ascending caps; a single-cap
    plan is one segment).  Untouched segments are returned as they are."""
    caps = tuple(s.cap for s in segments)
    cap_build = caps[-1]
    s0 = segments[0]
    T = s0.tile
    m, n = s0.shape
    nbr, nbc = -(-m // T), -(-n // T)
    itk, rtk, aff = _delta_tile_keys(delta, T, nbc)
    views = [_SegView(s, nbc, aff) for s in segments]
    _check_chain_split(views, cap_build)
    e = _gather_segments(views)

    n_entries = int(sum(int(v.nnz.sum()) for v in views))
    p = _id_plan(_find_removed(e, delta, rtk, T), n_entries, delta.n_insert)
    if p.L >= 2**31:
        raise ValueError("patched entry count overflows the int32 perm leaf")
    if p.tail_surv.size:
        # moved tail survivors change id: their tiles join the affected set
        moved = _moved_tile_keys(
            p, source, [(v.ck, lambda v=v: v.full("perm")) for v in views], T, nbc
        )
        aff = np.union1d(aff, moved)
        for v in views:
            v.aff_idx = _affected_chunk_idx(v.ck, aff)
        _check_chain_split(views, cap_build)
        e = _gather_segments(views)
    merged = _splice_entries(e, delta, itk, p, T)
    top = segments[-1]
    newc = _chunk_entries(
        merged, cap_build,
        tuple(_np_dtype(getattr(top, f))
              for f in ("rows", "cols", "vals", "nnz_in_tile", "perm")),
    )
    bucket_of = np.searchsorted(caps, newc.nnz)  # nnz == cap -> that bucket

    out = []
    for b, v in enumerate(views):
        sel = bucket_of == b
        if not sel.any() and not len(v.aff_idx):
            # the delta never touches this segment's chunks: the plan
            # object, its device leaves and its run index (counters
            # included) survive by identity — hole filling keeps every id
            # outside the affected tiles unchanged
            out.append(v.seg)
            continue
        out.append(_patch_segment(v, newc, sel, nbr, nbc, first=(b == 0)))
    return tuple(out), p


def _apply_plan(p: SCVPlan, delta: DeltaBatch, source=None) -> tuple[SCVPlan, _IdPlan]:
    (seg,), idp = _apply_segments((p,), delta, source=source)
    return seg, idp


def _apply_bucketed(
    bp: SCVBucketedPlan, delta: DeltaBatch, source=None
) -> tuple[SCVBucketedPlan, _IdPlan]:
    segs, idp = _apply_segments(bp.segments, delta, source=source)
    return SCVBucketedPlan(segs), idp


# ---------------------------------------------------------------------------
# Graph patch (plan + COO edge arrays)
# ---------------------------------------------------------------------------
def _apply_graph(g, delta: DeltaBatch):
    # the Graph carries its own pre-delta edge arrays: they locate the
    # moved survivors, so the plan patch never falls back to the perm scan
    source = g if g.rows is not None else None
    if isinstance(g.plan, SCVBucketedPlan):
        plan2, idp = _apply_bucketed(g.plan, delta, source=source)
    elif isinstance(g.plan, SCVPlan):
        plan2, idp = _apply_plan(g.plan, delta, source=source)
    else:
        raise TypeError(
            f"cannot patch a Graph holding {type(g.plan).__name__}; patch "
            "before device placement (re-shard the patched plan instead)"
        )
    edges = {}
    if g.rows is not None:
        for name, ins in (("rows", delta.ins_rows), ("cols", delta.ins_cols),
                          ("vals", delta.ins_vals)):
            edges[name] = _fill_tensor(getattr(g, name), ins, idp)
    return dataclasses.replace(g, plan=plan2, **edges)


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------
def apply_delta(
    obj: Any,
    delta: DeltaBatch,
    *,
    inplace: bool = False,
    check: bool = True,
    source: Any = None,
):
    """Patch ``obj`` (SCVTiles / SCVPlan / SCVBucketedPlan / models.gnn
    Graph) with ``delta``; equal to rebuilding the layer from
    ``apply_coo(coo, delta)``.

    ``inplace=True`` (SCVTiles only) mutates the arrays when the chunk
    layout is unchanged (a layout change still returns a fresh object).
    A plan built from those tiles before such a patch may share their
    arrays, while its run index still describes the old ones: it must not
    be served afterwards (``core.validate``'s run-index invariant fails on
    it).  The functional default copies only the leaves the patch writes.
    Plan layers always return new objects but keep untouched segments by
    identity.

    ``source`` (optional, anything with ``.rows`` / ``.cols`` — e.g. the
    pre-delta ``COOMatrix``) lets a net-shrinking delta locate the moved
    tail survivors by coordinate arithmetic instead of scanning the perm
    arrays.  Graphs use their own edge arrays and ignore it.
    """
    plan_shape = getattr(obj, "shape", None)
    if plan_shape is None and hasattr(obj, "plan"):  # models.gnn.Graph
        plan_shape = obj.plan.shape
    if check:
        check_delta(delta, shape=plan_shape)
    if len(delta) == 0:
        return obj
    if isinstance(obj, SCVTiles):
        return _apply_tiles(obj, delta, inplace=inplace, source=source)[0]
    if inplace:
        raise ValueError(
            "inplace patching is only supported for SCVTiles (plan leaves "
            "are shared with the plans built from them)"
        )
    if isinstance(obj, SCVBucketedPlan):
        return _apply_bucketed(obj, delta, source=source)[0]
    if isinstance(obj, SCVPlan):
        return _apply_plan(obj, delta, source=source)[0]
    if hasattr(obj, "plan") and hasattr(obj, "n_nodes"):
        return _apply_graph(obj, delta)
    raise TypeError(f"apply_delta cannot patch {type(obj).__name__}")
