"""Public SCV SpMM entry points over loose tile arrays and over plans.

Port of ``src/repro/kernels/scv_spmm/ops.py``:

* ``ensure_row_coverage`` — zero-nnz dummy tiles for unvisited block-rows
  (host numpy, as in the reference);
* ``scv_spmm`` — one aggregation over loose tile arrays;
* ``scv_spmm_plan`` — one aggregation over an ``SCVPlan`` or
  ``SCVBucketedPlan``: the vector body in one kernel launch over all the
  capacity segments (``scv_spmm.scv_spmm_chain``; the reference launches
  once per non-empty segment, chained through the output), the scalar
  body one launch per non-empty segment (``scv_spmm.scv_spmm_runs``).

Each launch runs the CUDA kernel for CUDA tensors and the plain version
for CPU tensors.  Both entry points run their whole chain inside one
``torch.autograd.Function`` (:class:`_ScvChain`), the counterpart of the
reference's custom VJPs (``ops.py:96-192``): the output carries a
``grad_fn``.  The backward gives ``d/dz = Âᵀ g`` through the same kernel
over the plan of ``Âᵀ`` (built once per graph, at its first backward), so
gradients are summed in a fixed order on the card as the forward is, and
``d/dvals`` of every segment as a gather and a row-sum over its live
entries.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.scv_spmm.scv_spmm import MAX_SEGMENTS, scv_spmm_chain, scv_spmm_runs


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


class _Backward:
    """What the backward of a chain over ``plan`` needs beyond the forward,
    built once per graph at its first backward and kept on the run index of
    the chain's first launched segment (``RunIndex._backward``):

    * ``plan_t`` — the plan of ``Âᵀ`` (``core.scv.transposed_plan``), so
      ``dZ = Âᵀ g`` is one more forward chain through the kernel, summed
      in a fixed order;
    * per launched segment, its live entries' tile and slot and their
      global row and column (``live``: int64 tensors on the plan's
      device), so ``d/dvals`` needs no ``nonzero()`` and no backward reads
      the card back.

    Both are built from one read of the plan back to the host.  A chain
    whose segments' run indexes differ (a patched plan, a new placement)
    keys another entry and replaces this one; a plan whose leaves were
    changed in place under the same run indexes is caught by the
    ``transposed`` check of ``core.validate.validate_plan``."""

    def __init__(self, plan):
        from repro_torch.core.scv import plan_entries, transposed_plan

        self.plan_t = transposed_plan(plan)
        e = plan_entries(plan)
        segments = getattr(plan, "segments", (plan,))
        self.live = [
            tuple(torch.from_numpy(e[f][e["seg"] == k]).to(seg.device)
                  for f in ("t", "s", "grow", "gcol"))
            for k, seg in enumerate(segments) if seg.n_tiles
        ]


def cached_backward(plan):
    """The :class:`_Backward` a chain over ``plan`` has built, or ``None``
    (none yet, or one built for segments with other run indexes)."""
    segments = getattr(plan, "segments", (plan,))
    live = [s for s in segments if s.n_tiles]
    hit = live[0].runs._backward.get("entry") if live else None
    if hit is None or len(hit[0]) != len(segments) or any(
            r is not s.runs for r, s in zip(hit[0], segments)):
        return None
    return hit[1]


def _backward_data(plan) -> _Backward:
    """The chain's :class:`_Backward`, from its cache or built now (for a
    plan with a launched segment)."""
    bw = cached_backward(plan)
    if bw is None:
        bw = _Backward(plan)
        segments = getattr(plan, "segments", (plan,))
        first = next(s for s in segments if s.n_tiles)
        first.runs._backward["entry"] = (tuple(s.runs for s in segments), bw)
    return bw


def _run(segments, vals, z, n_rows, zeros, body, dense_threshold) -> torch.Tensor:
    """The launches of a chain over a plan's ``segments`` (each with its
    values): the first seeds the strips it visits, later ones accumulate;
    with ``zeros`` (or no segment with tiles) the chain starts from an
    explicit zero output.  The vector body takes every segment in one
    launch (:func:`scv_spmm.scv_spmm_chain`; a plan of more than
    ``MAX_SEGMENTS`` segments in one launch per group of them), the scalar
    body one launch per segment with tiles."""
    out = None
    if zeros or not any(s.n_tiles for s in segments):
        out = torch.zeros((n_rows, z.shape[1]), dtype=torch.float32, device=z.device)
    if body == "vector":
        groups = chain_groups(len(segments))
    else:
        groups = [(i,) for i in range(len(segments))]
    for group in groups:
        if not any(segments[i].n_tiles for i in group):
            continue
        accumulate = out is not None
        if out is None:
            out = torch.empty((n_rows, z.shape[1]), dtype=torch.float32, device=z.device)
        if body == "vector":
            scv_spmm_chain([segments[i] for i in group], [vals[i] for i in group], z, out,
                           accumulate=accumulate, dense_threshold=dense_threshold)
        else:
            seg = segments[group[0]]
            scv_spmm_runs(seg.tile_row, seg.tile_col, seg.nnz_in_tile, seg.rows, seg.cols,
                          vals[group[0]], z, out, seg.runs, tile=seg.tile,
                          accumulate=accumulate, body=body, dense_threshold=dense_threshold)
    return out


def _with_vals(segments, vals):
    """Each segment's values: those given for the segments with tiles, in
    order, and a segment's own (never read) for the others."""
    it = iter(vals)
    return [next(it) if s.n_tiles else s.vals for s in segments]


def _launched(plan):
    """The segments of ``plan`` a chain launches, and whether it must start
    from zeros: an empty first segment leaves the first launch nothing to
    seed, so the chain then starts from zeros, as the reference's does."""
    segments = getattr(plan, "segments", (plan,))
    return [s for s in segments if s.n_tiles], segments[0].n_tiles == 0


def chain_groups(n_segments: int) -> list[range]:
    """The segment positions each vector launch of a chain over
    ``n_segments`` segments takes, ``MAX_SEGMENTS`` at a time (the
    kernel's segment table)."""
    return [range(i, min(i + MAX_SEGMENTS, n_segments))
            for i in range(0, n_segments, MAX_SEGMENTS)]


def chain_launches(plan, body: str = "vector") -> int:
    """Kernel launches one chain over ``plan`` makes (:func:`_run`): the
    vector body one per group of :func:`chain_groups` holding a segment
    with tiles, the scalar body one per segment with tiles."""
    segments = getattr(plan, "segments", (plan,))
    if body != "vector":
        return sum(1 for s in segments if s.n_tiles)
    return sum(1 for g in chain_groups(len(segments)) if any(segments[i].n_tiles for i in g))


class _ScvChain(torch.autograd.Function):
    """A whole chain of launches over ``plan``, ``out = [0 +] sum_k A_k z``,
    as one differentiable op of ``z`` and of each launched segment's
    values.

    Backward (the reference's ``_entry_grads``, ``ops.py:115``; ``d/dacc =
    g`` along the chain, so every segment sees the same ``g``):

    * ``dZ = Âᵀ g`` is a forward chain over the transposed plan
      (:class:`_Backward`) with ``g`` as the dense operand and the forward
      values gathered into its slots: the same kernels as the forward on
      the card, the plain version on the CPU, summed in a fixed order;
    * ``d/dvals[j] = <g[row_j], z[col_j]>`` over each segment's live
      entries, a gather and a row-sum (zero past each tile's nnz).

    Neither reads the card back after the first backward of a graph."""

    @staticmethod
    def forward(ctx, plan, n_rows, zeros, body, dense_threshold, z, *vals):
        segs, empty_first = _launched(plan)
        ctx.plan, ctx.segs = plan, segs
        ctx.run = (body, dense_threshold)
        ctx.save_for_backward(z, *vals)
        segments = getattr(plan, "segments", (plan,))
        return _run(segments, _with_vals(segments, vals), z, n_rows, zeros or empty_first,
                    body, dense_threshold)

    @staticmethod
    def backward(ctx, g):
        z, *vals = ctx.saved_tensors
        need = ctx.needs_input_grad
        g = g.contiguous()
        if not ctx.segs:
            return (None, None, None, None, None, torch.zeros_like(z) if need[5] else None)
        bw = _backward_data(ctx.plan)
        dz = None
        if need[5]:
            # the forward's values, gathered into the transposed slots
            plan_t = bw.plan_t.reweighted(torch.cat([v.reshape(-1) for v in vals]))
            _, empty_first = _launched(plan_t)
            segs_t = getattr(plan_t, "segments", (plan_t,))
            n_t = plan_t.padded_shape[0]
            out_t = _run(segs_t, [s.vals for s in segs_t], g, n_t, empty_first, *ctx.run)
            dz = torch.zeros_like(z)
            k = min(z.shape[0], n_t)
            dz[:k] = out_t[:k]
        dvals = []
        for j, v in enumerate(vals):
            if not need[6 + j]:
                dvals.append(None)
                continue
            t, s, grow, gcol = bw.live[j]
            d = torch.zeros_like(v)
            d[t, s] = (g[grow] * z[gcol]).sum(-1)
            dvals.append(d)
        return (None, None, None, None, None, dz, *dvals)


def _chain(plan, z, n_rows, zeros, body, dense_threshold) -> torch.Tensor:
    segs, _ = _launched(plan)
    return _ScvChain.apply(
        plan, n_rows, zeros, body, dense_threshold,
        z.to(torch.float32).contiguous(),
        *(s.vals.to(torch.float32).contiguous() for s in segs),
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
    from repro_torch.core.scv import ZMORTON, RunIndex, SCVPlan

    if tile_row.shape[0] == 0:
        return torch.zeros((n_rows, z.shape[1]), dtype=torch.float32, device=z.device)
    if nnz_in_tile is None:
        nnz_in_tile = _infer_nnz(rows, cols, vals)
    tr, tc, nz, rs, cs = (t.to(torch.int32).contiguous()
                          for t in (tile_row, tile_col, nnz_in_tile, rows, cols))
    plan = SCVPlan(
        tile_row=tr, tile_col=tc, rows=rs, cols=cs, vals=vals, nnz_in_tile=nz, perm=None,
        tile=tile, cap=int(rows.shape[1]), shape=(n_rows, int(z.shape[0])), order=ZMORTON,
        runs=RunIndex.of(tr.cpu().numpy(), nz.cpu().numpy(), tile_row.device),
    )
    return _chain(plan, z, n_rows, True, body, dense_threshold)


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

    The vector body takes all segments in one launch (per
    ``MAX_SEGMENTS``), the scalar body one launch per non-empty segment,
    all writing one output tensor in place.  With ``init="coverage"`` the
    first segment's coverage dummies make every block-row a run, so the
    chain defines every row (the scalar body: the first non-empty segment
    defines them and later segments accumulate into the rows they visit).
    ``init="zeros"`` starts the chain from an explicit zero tensor instead,
    seeding every strip from it, so rows that no segment visits are
    defined too.  ``body`` picks the kernel body (``"vector"``
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
    return _chain(plan, z, n_rows, init == "zeros", body, dense_threshold)
