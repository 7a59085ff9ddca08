"""Admission checks for client COO input.

Port of ``check_coo`` from ``src/repro/core/validate.py``; the plan
invariant verifier (``validate_plan``) comes with a later slice.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.formats import COOMatrix


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
