"""Public SCV SpMM entry points over loose tile arrays and over plans.

Port of ``src/repro/kernels/scv_spmm/ops.py``:

* ``ensure_row_coverage`` — zero-nnz dummy tiles for unvisited block-rows
  (host numpy, as in the reference);
* ``scv_spmm`` — one aggregation over loose tile arrays;
* ``scv_spmm_plan`` — one aggregation over an ``SCVPlan`` or
  ``SCVBucketedPlan``: one kernel launch per non-empty capacity segment,
  chained in place through one output tensor.

Each launch goes through ``scv_spmm.scv_spmm_runs``, which runs the CUDA
kernel for CUDA tensors and the plain version for CPU tensors.  Both entry
points run their whole chain of launches inside one
``torch.autograd.Function`` (:class:`_ScvChain`), the counterpart of the
reference's custom VJPs (``ops.py:96-192``): the output carries a
``grad_fn``, and the backward gives ``d/dvals`` of every segment and
``d/dz`` in plain PyTorch, as the reference leaves them to XLA.
"""
from __future__ import annotations

from typing import NamedTuple

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


class _Segment(NamedTuple):
    """The integer leaves of one launch (its values travel apart, as a
    differentiable input of :class:`_ScvChain`)."""

    tile_row: torch.Tensor
    tile_col: torch.Tensor
    nnz_in_tile: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    runs: object  # core.scv.RunIndex
    tile: int


def _entry_grads(seg: _Segment, vals, z, g, dz, need_dvals: bool):
    """The reference's ``_entry_grads`` (``ops.py:115``) for one launch,
    over its live entries only: returns ``dvals = <g[row], z[col]>`` (zero
    past each tile's nnz) if asked for, and adds ``A_seg^T g`` into ``dz``
    if given."""
    if not need_dvals and dz is None:
        return None
    slot = torch.arange(vals.shape[1], device=vals.device)
    t_idx, s_idx = (slot[None, :] < seg.nnz_in_tile[:, None]).nonzero(as_tuple=True)
    grow = seg.tile_row.long()[t_idx] * seg.tile + seg.rows[t_idx, s_idx].long()
    gcol = seg.tile_col.long()[t_idx] * seg.tile + seg.cols[t_idx, s_idx].long()
    g_rows = g[grow]
    dvals = None
    if need_dvals:
        dvals = torch.zeros_like(vals)
        dvals[t_idx, s_idx] = (g_rows * z[gcol]).sum(-1)
    if dz is not None:
        dz.index_add_(0, gcol, g_rows * vals[t_idx, s_idx][:, None])
    return dvals


class _ScvChain(torch.autograd.Function):
    """A whole chain of launches, ``out = [0 +] sum_k A_k z``, as one
    differentiable op of ``z`` and of each segment's values.

    Forward: the launches, as the wrapper runs them (the first seeds the
    strips it visits, later ones accumulate; with ``zeros`` the chain
    starts from an explicit zero output).  Backward, per segment, the
    reference's ``_entry_grads``; ``d/dacc = g`` along the chain means every
    segment sees the same ``g``.  ``index_add_`` sums ``dz`` with atomics on
    the card, in no fixed order."""

    @staticmethod
    def forward(ctx, segs, n_rows, zeros, body, dense_threshold, z, *vals):
        out = None
        if zeros or not segs:
            out = torch.zeros((n_rows, z.shape[1]), dtype=torch.float32, device=z.device)
        for seg, v in zip(segs, vals):
            accumulate = out is not None
            if out is None:
                out = torch.empty((n_rows, z.shape[1]), dtype=torch.float32, device=z.device)
            scv_spmm_runs(
                seg.tile_row, seg.tile_col, seg.nnz_in_tile, seg.rows, seg.cols, v, z,
                out, seg.runs, tile=seg.tile, accumulate=accumulate, body=body,
                dense_threshold=dense_threshold,
            )
        ctx.segs = segs
        ctx.save_for_backward(z, *vals)
        return out

    @staticmethod
    def backward(ctx, g):
        z, *vals = ctx.saved_tensors
        need = ctx.needs_input_grad
        g = g.contiguous()
        dz = torch.zeros_like(z) if need[5] else None
        dvals = [
            _entry_grads(seg, v, z, g, dz, need_dvals=need[6 + k])
            for k, (seg, v) in enumerate(zip(ctx.segs, vals))
        ]
        return (None, None, None, None, None, dz, *dvals)


def _chain(segs, vals, z, n_rows, zeros, body, dense_threshold) -> torch.Tensor:
    return _ScvChain.apply(
        tuple(segs), n_rows, zeros, body, dense_threshold,
        z.to(torch.float32).contiguous(),
        *(v.to(torch.float32).contiguous() for v in vals),
    )


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
    body: str = "vector",
    dense_threshold: int | None = None,
) -> torch.Tensor:
    """out = Â Z over loose tile arrays.  Returns f32[n_rows, F].

    Loose arrays carry no run index, so this one-shot entry point reads
    ``tile_row`` and the tiles' nnz back to the host to build it; the
    serving and model paths go through :func:`scv_spmm_plan`, whose plans
    carry theirs.  The output starts from zeros, so block-rows no tile
    visits are defined without coverage dummies.  ``body`` and
    ``dense_threshold`` as for :func:`scv_spmm_plan`."""
    from repro_torch.core.scv import RunIndex

    if tile_row.shape[0] == 0:
        return torch.zeros((n_rows, z.shape[1]), dtype=torch.float32, device=z.device)
    if nnz_in_tile is None:
        nnz_in_tile = _infer_nnz(rows, cols, vals)
    ints = [t.to(torch.int32).contiguous()
            for t in (tile_row, tile_col, nnz_in_tile, rows, cols)]
    runs = RunIndex.of(ints[0].cpu().numpy(), ints[2].cpu().numpy(), tile_row.device)
    seg = _Segment(*ints, runs=runs, tile=tile)
    return _chain([seg], [vals], z, n_rows, True, body, dense_threshold)


def scv_spmm_plan(
    plan,
    z: torch.Tensor,
    *,
    init: str = "coverage",
    body: str = "vector",
    dense_threshold: int | None = None,
) -> torch.Tensor:
    """``scv_spmm`` over an ``SCVPlan`` or ``SCVBucketedPlan``; returns the
    padded ``[n_rows_p, F]`` output.

    One launch per non-empty segment, all writing one output tensor in
    place.  With ``init="coverage"`` the first non-empty segment defines
    every row (the plan builders put the coverage dummies there) and later
    segments accumulate into the rows they visit.  ``init="zeros"`` starts
    the chain from an explicit zero tensor instead, so rows that no segment
    visits are defined too.  ``body`` picks the kernel body (``"vector"``
    or ``"scalar"``); ``dense_threshold`` (vector body; ``None``: the
    reference's ``dense_tile_threshold(T)``) is the nnz above which a tile
    takes the dense branch, a negative one turning the branch off.
    Differentiable in ``z`` and in each segment's ``vals``."""
    if init not in ("coverage", "zeros"):
        raise ValueError(f"init must be 'coverage' or 'zeros', got {init!r}")
    segments = getattr(plan, "segments", (plan,))
    n_rows, n_cols = segments[0].padded_shape[0], segments[0].shape[1]
    if z.dim() != 2 or z.shape[0] < n_cols:
        raise ValueError(
            f"z of shape {tuple(z.shape)} lacks rows for the plan's {n_cols} columns"
        )
    live = [s for s in segments if s.n_tiles]  # empty segments launch nothing
    segs = [_Segment(s.tile_row, s.tile_col, s.nnz_in_tile, s.rows, s.cols, s.runs, s.tile)
            for s in live]
    # an empty first segment leaves the first launch nothing to seed: the
    # chain then starts from zeros, as the reference's does
    zeros = init == "zeros" or segments[0].n_tiles == 0
    return _chain(segs, [s.vals for s in live], z, n_rows, zeros, body, dense_threshold)
