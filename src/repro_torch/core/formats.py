"""COO adjacency and the block-diagonal composition the serving engine
batches with.

Host-side numpy, as in the reference (``src/repro/core/formats.py``); the
port keeps its own copy because importing any ``repro.core`` module pulls
in jax.  Only what the port's path needs is here: the CSR/CSC/BCSR/CSB
baselines stay with the reference until a slice needs them.
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
