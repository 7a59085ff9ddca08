"""Z-Morton ordering utilities (paper §III-C).

Z-Morton maps 2-D block coordinates to a 1-D curve position by bit
interleaving, recursively visiting top-left, top-right, bottom-left,
bottom-right quadrants.  The paper uses a *modified* Z-Morton where a set of
column vectors (one B x B tile worth) forms a single curve element; we expose
both the raw interleave and the tile-level ordering.

All functions are pure numpy (format construction is host-side
preprocessing, exactly as the paper's "statically generated from the COO
format" — §III-C).  A copy of ``src/repro/core/morton.py``.
"""
from __future__ import annotations

import numpy as np

_PART_MASKS_64 = (
    (0x0000_0000_FFFF_FFFF, 32),
    (0x0000_FFFF_0000_FFFF, 16),
    (0x00FF_00FF_00FF_00FF, 8),
    (0x0F0F_0F0F_0F0F_0F0F, 4),
    (0x3333_3333_3333_3333, 2),
    (0x5555_5555_5555_5555, 1),
)


def _part1by1(x: np.ndarray) -> np.ndarray:
    """Spread the low 32 bits of x so there is a 0 bit between each bit."""
    x = x.astype(np.uint64) & np.uint64(0x0000_0000_FFFF_FFFF)
    # descending shifts, each mask paired with its own shift
    for mask, shift in _PART_MASKS_64[1:]:
        x = (x | (x << np.uint64(shift))) & np.uint64(mask)
    return x


def _compact1by1(x: np.ndarray) -> np.ndarray:
    """Inverse of _part1by1: gather every other bit into the low half."""
    x = x.astype(np.uint64) & np.uint64(0x5555_5555_5555_5555)
    # ascending shifts; mask of level i pairs with shift of level i-1
    pairs = [
        (0x3333_3333_3333_3333, 1),
        (0x0F0F_0F0F_0F0F_0F0F, 2),
        (0x00FF_00FF_00FF_00FF, 4),
        (0x0000_FFFF_0000_FFFF, 8),
        (0x0000_0000_FFFF_FFFF, 16),
    ]
    for mask, shift in pairs:
        x = (x | (x >> np.uint64(shift))) & np.uint64(mask)
    return x


def morton_encode(row: np.ndarray, col: np.ndarray) -> np.ndarray:
    """Interleave (row, col) -> Z-curve key.  row occupies the odd bits so
    that the curve sweeps top-left, top-right, bottom-left, bottom-right —
    matching the paper's Fig. 2(e) traversal."""
    row = np.asarray(row)
    col = np.asarray(col)
    return (_part1by1(row) << np.uint64(1)) | _part1by1(col)


def morton_decode(key: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    key = np.asarray(key, dtype=np.uint64)
    row = _compact1by1(key >> np.uint64(1))
    col = _compact1by1(key)
    return row.astype(np.int64), col.astype(np.int64)


def morton_order(rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """argsort of (rows, cols) along the Z curve (stable)."""
    return np.argsort(morton_encode(rows, cols), kind="stable")


def zcurve_tiles(n_tile_rows: int, n_tile_cols: int) -> np.ndarray:
    """Enumerate all (tile_row, tile_col) pairs in Z order.

    Returns an int64 array of shape (n_tile_rows * n_tile_cols, 2).
    Handles non-square / non-power-of-two grids by generating the curve on
    the enclosing power-of-two square and filtering — the standard approach.
    """
    side = 1 << int(np.ceil(np.log2(max(n_tile_rows, n_tile_cols, 1))))
    keys = np.arange(side * side, dtype=np.uint64)
    r, c = morton_decode(keys)
    keep = (r < n_tile_rows) & (c < n_tile_cols)
    return np.stack([r[keep], c[keep]], axis=1)
