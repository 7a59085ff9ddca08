"""Plain PyTorch versions of the SCV SpMM kernel's bodies.

Port of ``src/repro/kernels/scv_spmm/ref.py``, plus the dense-tile branch:

* ``scv_spmm_reference`` — a gather of Z rows and one ``index_add_`` into
  the output.  The plain version of the scalar body and of the vector
  body's sparse branch (the same function, entry by entry).
* ``scv_spmm_dense_reference`` — the dense branch: the chosen tiles
  densified to ``[n, T, T]`` (duplicates summed), times their Z blocks.
* ``scv_spmm_vector_reference`` — the vector body: tiles over the dense
  threshold through the dense version, the rest through the gather.

The launch wrapper takes them for CPU tensors, the CPU tests hold the port
against the reference with them, and ``chip_smoke.py`` compares the CUDA
kernels with them on the card.  They are never the CUDA path of the port.
"""
from __future__ import annotations

import torch


def _live_vals(vals: torch.Tensor, nnz_in_tile: torch.Tensor | None) -> torch.Tensor:
    """``vals`` with the slots past each tile's nnz zeroed."""
    if nnz_in_tile is None:
        return vals
    slot = torch.arange(vals.shape[1], device=vals.device)[None, :]
    return torch.where(slot < nnz_in_tile[:, None], vals, 0.0)


def scv_spmm_reference(
    tile_row: torch.Tensor,  # i32[nt]
    tile_col: torch.Tensor,  # i32[nt]
    rows: torch.Tensor,  # i32[nt, cap] local row within tile
    cols: torch.Tensor,  # i32[nt, cap] local col within tile
    vals: torch.Tensor,  # f32[nt, cap] (0 for padding slots)
    z: torch.Tensor,  # [n_cols, F] dense combined features
    *,
    tile: int,
    n_rows: int,
    nnz_in_tile: torch.Tensor | None = None,  # i32[nt] — masks padding slots
) -> torch.Tensor:
    """out[tile_row*T + rows] += vals * z[tile_col*T + cols]  (f32)."""
    out = torch.zeros((n_rows, z.shape[1]), dtype=torch.float32, device=z.device)
    if tile_row.shape[0] == 0:
        return out
    vals = _live_vals(vals, nnz_in_tile)
    gcols = (tile_col[:, None].long() * tile + cols).reshape(-1)
    grows = (tile_row[:, None].long() * tile + rows).reshape(-1)
    gathered = z[gcols].float() * vals.reshape(-1, 1).float()
    return out.index_add_(0, grows, gathered)


def scv_spmm_dense_reference(
    tile_row: torch.Tensor,  # i32[nd] — the tiles to densify
    tile_col: torch.Tensor,  # i32[nd]
    rows: torch.Tensor,  # i32[nd, cap]
    cols: torch.Tensor,  # i32[nd, cap]
    vals: torch.Tensor,  # f32[nd, cap]
    z: torch.Tensor,  # [n_cols, F]
    *,
    tile: int,
    n_rows: int,
    nnz_in_tile: torch.Tensor | None = None,
) -> torch.Tensor:
    """The dense branch over every tile given: D_t (T x T) from the
    tile's entries, duplicates summed, then ``out[strip] += D_t @ Z_block``.
    Z rows past ``z.shape[0]`` count as zero, as in the kernel."""
    T = tile
    n, f = tile_row.shape[0], z.shape[1]
    out = torch.zeros((n_rows, f), dtype=torch.float32, device=z.device)
    if n == 0:
        return out
    vals = _live_vals(vals, nnz_in_tile).float()
    d = torch.zeros((n, T, T), dtype=torch.float32, device=z.device)
    which = torch.arange(n, device=z.device)[:, None].expand_as(rows)
    d.index_put_((which, rows.long(), cols.long()), vals, accumulate=True)
    block_rows = tile_col[:, None].long() * T + torch.arange(T, device=z.device)
    zp = z.float()
    n_blocks_rows = int(block_rows.max()) + 1
    if zp.shape[0] < n_blocks_rows:
        zp = torch.cat([zp, zp.new_zeros((n_blocks_rows - zp.shape[0], f))])
    part = torch.bmm(d, zp[block_rows])  # [n, T, F]
    strip_rows = tile_row[:, None].long() * T + torch.arange(T, device=z.device)
    return out.index_add_(0, strip_rows.reshape(-1), part.reshape(-1, f))


def dense_tiles(nnz_in_tile: torch.Tensor, dense_threshold: int) -> torch.Tensor:
    """Which tiles take the dense branch: ``0 <= threshold < nnz`` (the
    reference's rule, ``scv_spmm.py:147-148``)."""
    if dense_threshold < 0:
        return torch.zeros_like(nnz_in_tile, dtype=torch.bool)
    return nnz_in_tile > dense_threshold


def scv_spmm_vector_reference(
    tile_row, tile_col, rows, cols, vals, z, *, tile: int, n_rows: int,
    nnz_in_tile: torch.Tensor, dense_threshold: int,
) -> torch.Tensor:
    """The vector body: tiles over ``dense_threshold`` densified (see
    :func:`scv_spmm_dense_reference`), the others gathered."""
    dense = dense_tiles(nnz_in_tile, dense_threshold)
    sparse = ~dense
    kw = dict(tile=tile, n_rows=n_rows)
    out = scv_spmm_reference(
        tile_row[sparse], tile_col[sparse], rows[sparse], cols[sparse], vals[sparse], z,
        nnz_in_tile=nnz_in_tile[sparse], **kw,
    )
    if bool(dense.any()):
        out += scv_spmm_dense_reference(
            tile_row[dense], tile_col[dense], rows[dense], cols[dense], vals[dense], z,
            nnz_in_tile=nnz_in_tile[dense], **kw,
        )
    return out


def scv_spmm_reference_plan(
    plan, z: torch.Tensor, *, body: str = "scalar", dense_threshold: int | None = None,
) -> torch.Tensor:
    """Plain version over an ``SCVPlan`` or ``SCVBucketedPlan``.  Returns
    the padded ``[n_rows_p, F]`` output, like ``ops.scv_spmm_plan``;
    segment partials are summed.  ``body="scalar"`` gathers every entry;
    ``body="vector"`` sends tiles over ``dense_threshold`` (``None``: the
    reference's ``dense_tile_threshold(T)``) through the dense version."""
    from repro_torch.core.scv import dense_tile_threshold

    n_rows = plan.padded_shape[0]
    segments = getattr(plan, "segments", (plan,))
    out = torch.zeros((n_rows, z.shape[1]), dtype=torch.float32, device=z.device)
    for seg in segments:
        args = (seg.tile_row, seg.tile_col, seg.rows, seg.cols, seg.vals, z)
        kw = dict(tile=seg.tile, n_rows=n_rows, nnz_in_tile=seg.nnz_in_tile)
        if body == "vector":
            thr = dense_tile_threshold(seg.tile) if dense_threshold is None else dense_threshold
            out = out + scv_spmm_vector_reference(*args, dense_threshold=thr, **kw)
        elif body == "scalar":
            out = out + scv_spmm_reference(*args, **kw)
        else:
            raise ValueError(f"unknown kernel body {body!r}")
    return out
