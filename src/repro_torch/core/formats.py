"""COO adjacency, the block-diagonal composition the serving engine
batches with, and the baseline formats the simulator replays.

Host-side numpy, as in the reference (``src/repro/core/formats.py``); the
port keeps its own copy because importing any ``repro.core`` module pulls
in jax.  Besides COO, the baseline formats of the paper's §II-B (CSR,
CSC, BCSR, CSB) and their converters, which the simulator's dataflows
(``simul/dataflows.py``) replay; they give the reference's arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class COOMatrix:
    """Coordinate format: one (row, col, val) tuple per nonzero."""

    rows: np.ndarray  # int32[nnz]
    cols: np.ndarray  # int32[nnz]
    vals: np.ndarray  # f32[nnz]
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def density(self) -> float:
        m, n = self.shape
        return self.nnz / float(m * n) if m and n else 0.0

    def dedup(self) -> "COOMatrix":
        """Sum duplicate coordinates (canonicalization)."""
        m, n = self.shape
        keys = self.rows.astype(np.int64) * n + self.cols
        order = np.argsort(keys, kind="stable")
        keys_s = keys[order]
        vals_s = self.vals[order]
        uniq, start = np.unique(keys_s, return_index=True)
        sums = np.add.reduceat(vals_s, start) if len(start) else vals_s[:0]
        return COOMatrix(
            (uniq // n).astype(np.int32),
            (uniq % n).astype(np.int32),
            sums.astype(self.vals.dtype),
            self.shape,
        )

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.float64)
        np.add.at(out, (self.rows, self.cols), self.vals)
        return out.astype(self.vals.dtype)


def coo_from_dense(a: np.ndarray) -> COOMatrix:
    rows, cols = np.nonzero(a)
    return COOMatrix(
        rows.astype(np.int32), cols.astype(np.int32), a[rows, cols], a.shape
    )


def block_diag_coo(
    mats: Sequence[COOMatrix],
    pad_shape: Optional[tuple[int, int]] = None,
) -> tuple[COOMatrix, np.ndarray, np.ndarray]:
    """Compose matrices into one block-diagonal COO.

    The i-th input occupies rows ``row_off[i]:row_off[i+1]`` and columns
    ``col_off[i]:col_off[i+1]`` of the composite; no cross-block entries
    exist, so aggregation over the composite is exactly the per-matrix
    aggregation stacked (the batching identity the serving engine relies
    on).  ``pad_shape`` grows the composite to at least that shape with
    structurally-empty trailing rows/cols (padding-bucket support).

    Returns ``(composite, row_off, col_off)`` with offset arrays of length
    ``len(mats) + 1``.
    """
    k = len(mats)
    row_off = np.zeros(k + 1, np.int64)
    col_off = np.zeros(k + 1, np.int64)
    for i, a in enumerate(mats):
        row_off[i + 1] = row_off[i] + a.shape[0]
        col_off[i + 1] = col_off[i] + a.shape[1]
    m, n = int(row_off[-1]), int(col_off[-1])
    if pad_shape is not None:
        if pad_shape[0] < m or pad_shape[1] < n:
            raise ValueError(f"pad_shape {pad_shape} smaller than composite ({m}, {n})")
        m, n = int(pad_shape[0]), int(pad_shape[1])
    if k:
        rows = np.concatenate(
            [a.rows.astype(np.int64) + row_off[i] for i, a in enumerate(mats)]
        ).astype(np.int32)
        cols = np.concatenate(
            [a.cols.astype(np.int64) + col_off[i] for i, a in enumerate(mats)]
        ).astype(np.int32)
        vals = np.concatenate([a.vals for a in mats])
    else:
        rows = np.zeros(0, np.int32)
        cols = np.zeros(0, np.int32)
        vals = np.zeros(0, np.float32)
    return COOMatrix(rows, cols, vals, (m, n)), row_off, col_off


# ---------------------------------------------------------------------------
# CSR / CSC
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    row_ptr: np.ndarray  # int32[m+1]
    col_id: np.ndarray  # int32[nnz]
    vals: np.ndarray  # f32[nnz]
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.col_id.shape[0])


@dataclasses.dataclass(frozen=True)
class CSCMatrix:
    col_ptr: np.ndarray  # int32[n+1]
    row_id: np.ndarray  # int32[nnz]
    vals: np.ndarray  # f32[nnz]
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.row_id.shape[0])


def coo_to_csr(a: COOMatrix) -> CSRMatrix:
    m, n = a.shape
    order = np.argsort(a.rows.astype(np.int64) * n + a.cols, kind="stable")
    rows = a.rows[order]
    row_ptr = np.zeros(m + 1, dtype=np.int32)
    np.add.at(row_ptr, rows + 1, 1)
    row_ptr = np.cumsum(row_ptr, dtype=np.int64).astype(np.int32)
    return CSRMatrix(row_ptr, a.cols[order], a.vals[order], a.shape)


def coo_to_csc(a: COOMatrix) -> CSCMatrix:
    m, n = a.shape
    order = np.argsort(a.cols.astype(np.int64) * m + a.rows, kind="stable")
    cols = a.cols[order]
    col_ptr = np.zeros(n + 1, dtype=np.int32)
    np.add.at(col_ptr, cols + 1, 1)
    col_ptr = np.cumsum(col_ptr, dtype=np.int64).astype(np.int32)
    return CSCMatrix(col_ptr, a.rows[order], a.vals[order], a.shape)


def csr_to_coo(a: CSRMatrix) -> COOMatrix:
    rows = np.repeat(
        np.arange(a.shape[0], dtype=np.int32), np.diff(a.row_ptr)
    )
    return COOMatrix(rows, a.col_id.copy(), a.vals.copy(), a.shape)


def csc_to_coo(a: CSCMatrix) -> COOMatrix:
    cols = np.repeat(
        np.arange(a.shape[1], dtype=np.int32), np.diff(a.col_ptr)
    )
    return COOMatrix(a.row_id.copy(), cols, a.vals.copy(), a.shape)


# ---------------------------------------------------------------------------
# BCSR — blocked CSR with dense B x B blocks (paper §II-B.3)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BCSRMatrix:
    row_ptr: np.ndarray  # int32[n_blk_rows+1], in units of blocks
    col_id: np.ndarray  # int32[n_blocks] — block-column of each stored block
    blocks: np.ndarray  # f32[n_blocks, B, B] — dense storage (the liability)
    block_size: int
    shape: tuple[int, int]

    @property
    def n_blocks(self) -> int:
        return int(self.col_id.shape[0])

    @property
    def stored_values(self) -> int:
        """Dense storage footprint — the BCSR overhead the paper calls out."""
        return self.n_blocks * self.block_size * self.block_size


def coo_to_bcsr(a: COOMatrix, block_size: int) -> BCSRMatrix:
    m, n = a.shape
    B = block_size
    nbr = -(-m // B)
    nbc = -(-n // B)
    brow = a.rows // B
    bcol = a.cols // B
    keys = brow.astype(np.int64) * nbc + bcol
    order = np.argsort(keys, kind="stable")
    keys_s = keys[order]
    uniq, start = np.unique(keys_s, return_index=True)
    blocks = np.zeros((len(uniq), B, B), dtype=a.vals.dtype)
    # scatter entries into their dense block
    blk_of_entry = np.searchsorted(uniq, keys_s)
    np.add.at(
        blocks,
        (blk_of_entry, a.rows[order] % B, a.cols[order] % B),
        a.vals[order],
    )
    ubrow = (uniq // nbc).astype(np.int32)
    ubcol = (uniq % nbc).astype(np.int32)
    row_ptr = np.zeros(nbr + 1, dtype=np.int32)
    np.add.at(row_ptr, ubrow + 1, 1)
    row_ptr = np.cumsum(row_ptr).astype(np.int32)
    return BCSRMatrix(row_ptr, ubcol, blocks, B, a.shape)


# ---------------------------------------------------------------------------
# CSB — compressed sparse blocks (paper §III-A): sparse B x B tiles with
# relative (log2 B-bit) coordinates.  SCV == CSB with block width 1.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CSBMatrix:
    blk_ptr: np.ndarray  # int32[n_blocks+1] into vals
    blk_row: np.ndarray  # int32[n_blocks] — block-row coordinate
    blk_col: np.ndarray  # int32[n_blocks] — block-col coordinate
    row_id: np.ndarray  # int32[nnz] — row offset *within* block
    col_id: np.ndarray  # int32[nnz] — col offset *within* block
    vals: np.ndarray  # f32[nnz]
    block_h: int
    block_w: int
    shape: tuple[int, int]

    @property
    def n_blocks(self) -> int:
        return int(self.blk_row.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])


def coo_to_csb(
    a: COOMatrix,
    block_h: int,
    block_w: int,
    block_order: Optional[np.ndarray] = None,
) -> CSBMatrix:
    """Tile into block_h x block_w sparse blocks.

    Within a block, entries are stored column-major (column-vector order —
    the SCV processing discipline, §III-A "we propose using a column-major
    storage format").  Block order defaults to row-major over the block
    grid; pass a permutation of block indices (e.g. from Z-Morton) to
    reorder — §III-C.
    """
    m, n = a.shape
    nbc = -(-n // block_w)
    brow = (a.rows // block_h).astype(np.int64)
    bcol = (a.cols // block_w).astype(np.int64)
    bkey = brow * nbc + bcol
    # column-major within block: sort by (block, local col, local row)
    lrow = (a.rows % block_h).astype(np.int64)
    lcol = (a.cols % block_w).astype(np.int64)
    within = lcol * block_h + lrow
    order = np.argsort(bkey * (block_h * block_w) + within, kind="stable")
    bkey_s = bkey[order]
    uniq, start = np.unique(bkey_s, return_index=True)
    counts = np.diff(np.append(start, len(bkey_s)))
    ubrow = (uniq // nbc).astype(np.int32)
    ubcol = (uniq % nbc).astype(np.int32)
    if block_order is not None:
        assert len(block_order) == len(uniq)
        perm = np.asarray(block_order)
        # reorder blocks; entries regrouped accordingly
        entry_order = np.concatenate(
            [np.arange(start[b], start[b] + counts[b]) for b in perm]
        ) if len(uniq) else np.arange(0)
        ubrow, ubcol, counts = ubrow[perm], ubcol[perm], counts[perm]
    else:
        entry_order = np.arange(len(order))
    order = order[entry_order.astype(np.int64)] if len(order) else order
    blk_ptr = np.concatenate(
        [[0], np.cumsum(counts)]
    ).astype(np.int32)
    return CSBMatrix(
        blk_ptr,
        ubrow,
        ubcol,
        (a.rows[order] % block_h).astype(np.int32),
        (a.cols[order] % block_w).astype(np.int32),
        a.vals[order],
        block_h,
        block_w,
        a.shape,
    )
