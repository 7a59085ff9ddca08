"""Plain PyTorch version of the SCV SpMM kernel.

Port of ``src/repro/kernels/scv_spmm/ref.py``: a gather of Z rows and one
``index_add_`` into the output.  It is the kernel's plain version: the
launch wrapper takes it for CPU tensors, the CPU tests hold the port
against the reference with it, and ``chip_smoke.py`` compares the CUDA
kernel with it on the card.  It is never the CUDA path of the port.
"""
from __future__ import annotations

import torch


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
    if nnz_in_tile is not None:
        slot = torch.arange(vals.shape[1], device=vals.device)[None, :]
        vals = torch.where(slot < nnz_in_tile[:, None], vals, 0.0)
    gcols = (tile_col[:, None].long() * tile + cols).reshape(-1)
    grows = (tile_row[:, None].long() * tile + rows).reshape(-1)
    gathered = z[gcols].float() * vals.reshape(-1, 1).float()
    return out.index_add_(0, grows, gathered)


def scv_spmm_reference_plan(plan, z: torch.Tensor) -> torch.Tensor:
    """Plain version over an ``SCVPlan`` or ``SCVBucketedPlan``.  Returns
    the padded ``[n_rows_p, F]`` output, like ``ops.scv_spmm_plan``;
    segment partials are summed."""
    n_rows = plan.padded_shape[0]
    segments = getattr(plan, "segments", (plan,))
    out = torch.zeros((n_rows, z.shape[1]), dtype=torch.float32, device=z.device)
    for seg in segments:
        zp = z
        if z.shape[0] < seg.padded_shape[1]:
            zp = z.new_zeros((seg.padded_shape[1], z.shape[1]))
            zp[: z.shape[0]] = z
        out = out + scv_spmm_reference(
            seg.tile_row, seg.tile_col, seg.rows, seg.cols, seg.vals, zp,
            tile=seg.tile, n_rows=n_rows, nnz_in_tile=seg.nnz_in_tile,
        )
    return out
