"""Public SCV SpMM entry points over loose tile arrays and over plans.

Port of the forward half of ``src/repro/kernels/scv_spmm/ops.py``:

* ``ensure_row_coverage`` — zero-nnz dummy tiles for unvisited block-rows
  (host numpy, as in the reference);
* ``scv_spmm`` — one aggregation over loose tile arrays;
* ``scv_spmm_plan`` — one aggregation over an ``SCVPlan`` or
  ``SCVBucketedPlan``: one kernel launch per non-empty capacity segment,
  chained in place through one output tensor.

Each launch goes through ``scv_spmm.scv_spmm_runs``, which runs the CUDA
kernel for CUDA tensors and the plain version for CPU tensors.  The
reference's custom VJP comes with the training slice of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.scv_spmm.scv_spmm import scv_spmm_runs


def ensure_row_coverage(
    tile_row: np.ndarray,
    tile_col: np.ndarray,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    nnz_in_tile: np.ndarray,
    n_row_blocks: int,
):
    """Append one zero-nnz dummy tile per unvisited block-row (host-side)."""
    if rows.ndim != 2 or cols.ndim != 2 or vals.ndim != 2:
        raise ValueError(
            "entry arrays must be 2-D [n_tiles, cap]; got rows.ndim="
            f"{rows.ndim}, cols.ndim={cols.ndim}, vals.ndim={vals.ndim} "
            "(reshape 1-D per-entry arrays to (n_tiles, cap) first)"
        )
    missing = np.setdiff1d(
        np.arange(n_row_blocks, dtype=np.int32), np.unique(tile_row)
    )
    if len(missing) == 0:
        return tile_row, tile_col, rows, cols, vals, nnz_in_tile
    k, cap = len(missing), rows.shape[1]
    return (
        np.concatenate([tile_row, missing]),
        np.concatenate([tile_col, np.zeros(k, tile_col.dtype)]),
        np.concatenate([rows, np.zeros((k, cap), rows.dtype)]),
        np.concatenate([cols, np.zeros((k, cap), cols.dtype)]),
        np.concatenate([vals, np.zeros((k, cap), vals.dtype)]),
        np.concatenate([nnz_in_tile, np.zeros(k, nnz_in_tile.dtype)]),
    )


def _infer_nnz(rows, cols, vals) -> torch.Tensor:
    """Per-tile nnz from structural padding: one past the last slot that is
    not (val == 0, row == col == 0)."""
    if vals.shape[1] == 0:
        return torch.zeros(vals.shape[0], dtype=torch.int32, device=vals.device)
    slot = torch.arange(1, vals.shape[1] + 1, dtype=torch.int32, device=vals.device)
    is_real = (vals != 0) | (rows != 0) | (cols != 0)
    return torch.where(is_real, slot, 0).amax(dim=1).to(torch.int32)


def scv_spmm(
    tile_row: torch.Tensor,
    tile_col: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    z: torch.Tensor,
    *,
    tile: int,
    n_rows: int,
    nnz_in_tile: torch.Tensor | None = None,
) -> torch.Tensor:
    """out = Â Z over loose tile arrays.  Returns f32[n_rows, F].

    Loose arrays carry no run index, so this one-shot entry point reads
    ``tile_row`` back to the host to build it; the serving and model paths
    go through :func:`scv_spmm_plan`, whose plans carry theirs.  The
    output starts from zeros, so block-rows no tile visits are defined
    without coverage dummies."""
    from repro_torch.core.scv import RunIndex

    out = torch.zeros((n_rows, z.shape[1]), dtype=torch.float32, device=z.device)
    if tile_row.shape[0] == 0:
        return out
    if nnz_in_tile is None:
        nnz_in_tile = _infer_nnz(rows, cols, vals)
    runs = RunIndex.of(tile_row.cpu().numpy(), tile_row.device)
    ints = (t.to(torch.int32).contiguous()
            for t in (tile_row, tile_col, nnz_in_tile, rows, cols))
    floats = (t.to(torch.float32).contiguous() for t in (vals, z))
    return scv_spmm_runs(*ints, *floats, out, runs, tile=tile, accumulate=True)


def scv_spmm_plan(plan, z: torch.Tensor, *, init: str = "coverage") -> torch.Tensor:
    """``scv_spmm`` over an ``SCVPlan`` or ``SCVBucketedPlan``; returns the
    padded ``[n_rows_p, F]`` output.

    One launch per non-empty segment, all writing one output tensor in
    place.  With ``init="coverage"`` the first non-empty segment defines
    every row (the plan builders put the coverage dummies there) and later
    segments accumulate into the rows they visit.  ``init="zeros"`` starts
    the chain from an explicit zero tensor instead, so rows that no segment
    visits are defined too."""
    if init not in ("coverage", "zeros"):
        raise ValueError(f"init must be 'coverage' or 'zeros', got {init!r}")
    segments = getattr(plan, "segments", (plan,))
    n_rows, n_cols = segments[0].padded_shape[0], segments[0].shape[1]
    if z.dim() != 2 or z.shape[0] < n_cols:
        raise ValueError(
            f"z of shape {tuple(z.shape)} lacks rows for the plan's {n_cols} columns"
        )
    z = z.to(torch.float32).contiguous()
    shape = (n_rows, z.shape[1])
    out = None
    if init == "zeros":
        out = torch.zeros(shape, dtype=torch.float32, device=z.device)
    for seg in segments:
        if seg.n_tiles == 0:  # empty segment: nothing to launch
            if out is None:
                out = torch.zeros(shape, dtype=torch.float32, device=z.device)
            continue
        accumulate = out is not None
        if out is None:
            out = torch.empty(shape, dtype=torch.float32, device=z.device)
        scv_spmm_runs(
            seg.tile_row, seg.tile_col, seg.nnz_in_tile, seg.rows, seg.cols,
            seg.vals, z, out, seg.runs, tile=seg.tile, accumulate=accumulate,
        )
    return out
