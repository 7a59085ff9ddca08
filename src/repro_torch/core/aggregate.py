"""Aggregation (Eq. (3): H' = Â · Z) with pluggable sparse backends.

Port of ``src/repro/core/aggregate.py``.  ``aggregate(A, Z)`` dispatches
on the format object, as the reference does:

* ``torch.Tensor`` / ``np.ndarray`` — dense matmul (oracle, tiny graphs)
* ``COOMatrix`` / ``CSRMatrix``    — gather + ``index_add_`` in row order
* ``CSCMatrix``                    — gather + ``index_add_`` in column order
* ``BCSRMatrix``                   — one ``T x T`` block product per stored block
* ``SCVMatrix`` / ``SCVTiles``     — the SCV plan built from it, run by the kernel
* ``SCVPlan`` / ``SCVBucketedPlan`` — the SCV kernel chain (``aggregate_scv_plan``)
* ``core.exec.ShardedPlan``        — its device grid

The baselines (dense, COO, CSR, CSC, BCSR, the hybrid's dense part) are
PyTorch ops on ``z``'s device: they are the paper's comparison points and
the tests' oracles, not kernels.  Every SCV format goes through
``ops.scv_spmm_plan``: the CUDA kernel chain for a CUDA ``z``, its plain
version for a CPU one.  The device of ``z`` decides; the reference's
``backend=`` has no counterpart and nothing falls back from one device to
the other.  ``**kw`` of the SCV paths (``body=``, ``dense_threshold=``,
``init=``) goes to ``scv_spmm_plan``.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.exec import ShardedPlan, aggregate_sharded
from repro_torch.core.formats import BCSRMatrix, COOMatrix, CSCMatrix, CSRMatrix
from repro_torch.core.scv import (
    RunIndex,
    SCVBucketedPlan,
    SCVMatrix,
    SCVPlan,
    SCVTiles,
    plan_from_tiles,
    scv_to_tiles,
    split_hybrid,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.scv_spmm.ops import scv_spmm_plan


# ---------------------------------------------------------------------------
# device-array bundles
# ---------------------------------------------------------------------------
def csr_device_arrays(a: CSRMatrix, device="cuda") -> dict[str, torch.Tensor]:
    """The CSR entries as COO arrays on ``device`` (rows in order)."""
    dev = resolve_device(device)
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int32), np.diff(a.row_ptr))
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in (("rows", rows), ("cols", a.col_id), ("vals", a.vals))}


def scv_device_arrays(
    t: SCVTiles, ensure_coverage: bool = True, device="cuda"
) -> dict[str, torch.Tensor]:
    """The tile arrays on ``device``; with ``ensure_coverage`` a zero-nnz
    dummy tile is appended for every unvisited block-row.  A dict view of
    :func:`plan_from_tiles` (no perm), as in the reference."""
    p = plan_from_tiles(
        t, ensure_coverage=ensure_coverage, with_perm=False, device=resolve_device(device)
    )
    return {k: getattr(p, k)
            for k in ("tile_row", "tile_col", "rows", "cols", "vals", "nnz_in_tile")}


def _as(z: torch.Tensor, a: Any, dtype=None) -> torch.Tensor:
    """Host array or tensor ``a`` on ``z``'s device."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device=z.device, dtype=dtype)


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------
def aggregate_coo_segsum(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    z: torch.Tensor,
    n_rows: int,
) -> torch.Tensor:
    """Row-major (CSR-style) aggregation: gather Z rows, weighted sum into
    output rows.  Also the tests' oracle, independent of the SCV layout."""
    gathered = z[cols.long()] * vals[:, None].to(z.dtype)
    out = torch.zeros((n_rows, z.shape[1]), dtype=z.dtype, device=z.device)
    return out.index_add_(0, rows.long(), gathered)


def aggregate_coo_scatter(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    z: torch.Tensor,
    n_rows: int,
) -> torch.Tensor:
    """Column-major (CSC-style) aggregation: zero the output, then
    scatter-add each entry's weighted Z row into its output row.  In
    PyTorch this is :func:`aggregate_coo_segsum`'s op; what differs is the
    entries' order (by column here, by row there)."""
    return aggregate_coo_segsum(rows, cols, vals, z, n_rows)


def aggregate_dense(a, z: torch.Tensor) -> torch.Tensor:
    """``a @ z`` in ``z``'s dtype (fp32: whether cuBLAS may use TF32 is the
    caller's ``torch.backends.cuda.matmul.allow_tf32``)."""
    return _as(z, a, z.dtype) @ z


def aggregate_bcsr(
    a: BCSRMatrix, z: torch.Tensor, arrays: Optional[dict] = None
) -> torch.Tensor:
    """Dense-block path: every stored block does a full ``B x B @ B x F``
    (``torch.bmm``), summed over its block-row with ``index_add_``: BCSR's
    storage liability becomes a compute liability (paper §II-B.3).
    ``arrays`` (from :func:`bcsr_device_arrays`) keeps the blocks on the
    device between calls."""
    B = a.block_size
    m, n = a.shape
    mp, np_ = -(-m // B) * B, -(-n // B) * B
    arr = arrays if arrays is not None else bcsr_device_arrays(a, z.device)
    zp = torch.zeros((np_, z.shape[1]), dtype=z.dtype, device=z.device)
    zp[: z.shape[0]] = z
    ztiles = zp.view(np_ // B, B, z.shape[1])
    prod = torch.bmm(arr["blocks"].to(z.dtype), ztiles[arr["col_id"].long()])
    out = torch.zeros((mp // B, B, z.shape[1]), dtype=z.dtype, device=z.device)
    out.index_add_(0, arr["blk_rows"].long(), prod)
    return out.view(mp, z.shape[1])[:m]


def bcsr_device_arrays(a: BCSRMatrix, device="cuda") -> dict[str, torch.Tensor]:
    """The stored blocks, their block columns and block-rows on ``device``."""
    dev = resolve_device(device)
    blk_rows = np.repeat(np.arange(len(a.row_ptr) - 1, dtype=np.int32), np.diff(a.row_ptr))
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in (("blocks", a.blocks), ("col_id", a.col_id), ("blk_rows", blk_rows))}


def aggregate_scv_tiles(
    t: SCVTiles, z: torch.Tensor, *, arrays: Optional[dict] = None, **kw
) -> torch.Tensor:
    """SCV aggregation over the tile layout: the plan from
    :func:`scv_device_arrays` (coverage dummies included) on ``z``'s
    device, run by ``ops.scv_spmm_plan``; returns ``[t.shape[0], F]``.
    ``arrays`` passes such a dict in; its run index is then built from
    ``tile_row`` and ``nnz_in_tile`` read back to the host."""
    if arrays is None:
        p = plan_from_tiles(t, with_perm=False, device=z.device)
    else:
        tr, nz = arrays["tile_row"], arrays["nnz_in_tile"]
        p = SCVPlan(
            tile_row=tr, tile_col=arrays["tile_col"], rows=arrays["rows"],
            cols=arrays["cols"], vals=arrays["vals"], nnz_in_tile=nz, perm=None,
            tile=t.tile, cap=int(arrays["vals"].shape[1]), shape=t.shape, order=t.order,
            runs=RunIndex.of(tr.cpu().numpy(), nz.cpu().numpy(), tr.device),
        )
    return scv_spmm_plan(p, z, **kw)[: t.shape[0]]


def aggregate_scv_plan(p, z: torch.Tensor, **kw) -> torch.Tensor:
    """SCV aggregation over a plan; returns ``[p.shape[0], F]``.  A placed
    plan runs its grid (``core.exec.aggregate_sharded``).  Gradients reach
    ``z`` and the plan's values (GAT's re-weighted ones among them) through
    ``ops.scv_spmm_plan``'s autograd Function."""
    if isinstance(p, ShardedPlan):
        return aggregate_sharded(p, z, **kw)
    return scv_spmm_plan(p, z, **kw)[: p.shape[0]]


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def aggregate(a, z: torch.Tensor, **kw: Any) -> torch.Tensor:
    """H' = Â Z for any supported adjacency format, on ``z``'s device."""
    n_rows = a.shape[0]
    if isinstance(a, (np.ndarray, torch.Tensor)):
        return aggregate_dense(a, z)
    if isinstance(a, COOMatrix):
        return aggregate_coo_segsum(
            _as(z, a.rows), _as(z, a.cols), _as(z, a.vals), z, n_rows
        )
    if isinstance(a, CSRMatrix):
        d = csr_device_arrays(a, z.device)
        return aggregate_coo_segsum(d["rows"], d["cols"], d["vals"], z, n_rows)
    if isinstance(a, CSCMatrix):
        cols = np.repeat(np.arange(a.shape[1], dtype=np.int32), np.diff(a.col_ptr))
        return aggregate_coo_scatter(
            _as(z, a.row_id), _as(z, cols), _as(z, a.vals), z, n_rows
        )
    if isinstance(a, BCSRMatrix):
        return aggregate_bcsr(a, z)
    if isinstance(a, SCVMatrix):
        return aggregate_scv_tiles(scv_to_tiles(a), z, **kw)
    if isinstance(a, SCVTiles):
        return aggregate_scv_tiles(a, z, **kw)
    if isinstance(a, (SCVPlan, SCVBucketedPlan, ShardedPlan)):
        return aggregate_scv_plan(a, z, **kw)
    raise TypeError(f"unsupported adjacency format: {type(a)}")


def aggregate_hybrid(t: SCVTiles, z: torch.Tensor, **kw) -> torch.Tensor:
    """Hybrid: tiles past the density rule of :func:`split_hybrid` as dense
    ``T x T`` products (``torch.bmm`` + ``index_add_``, as the reference
    computes them with an ``einsum`` outside its kernel), the rest through
    :func:`aggregate_scv_tiles`."""
    sparse, dense = split_hybrid(t)
    out = aggregate_scv_tiles(sparse, z, **kw)
    if dense.n_tiles:
        T = dense.tile
        np_cols = -(-t.shape[1] // T) * T
        zp = torch.zeros((np_cols, z.shape[1]), dtype=z.dtype, device=z.device)
        zp[: z.shape[0]] = z
        ztiles = zp.view(np_cols // T, T, z.shape[1])
        prod = torch.bmm(
            _as(z, dense.blocks, z.dtype), ztiles[_as(z, dense.tile_col).long()]
        ).float()
        upd = torch.zeros((t.padded_shape[0] // T, T, z.shape[1]),
                          dtype=torch.float32, device=z.device)
        upd.index_add_(0, _as(z, dense.tile_row).long(), prod)
        out = out + upd.view(-1, z.shape[1])[: out.shape[0]]
    return out
