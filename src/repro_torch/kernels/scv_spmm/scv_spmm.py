"""Launch wrapper for the SCV SpMM CUDA kernel (``csrc/scv_spmm.cu``).

Counterpart of ``scv_spmm_pallas`` (``src/repro/kernels/scv_spmm/
scv_spmm.py:197``).  One call computes one segment of a plan into ``out``
in place: ``out = A_seg @ Z`` on the rows the segment visits, or, with
``accumulate=True``, ``out += A_seg @ Z`` there (the TPU kernel's aliased
``acc`` operand).  Rows the segment does not visit keep their contents.

Dispatch is by device: a CUDA tensor launches the kernel on the current
stream or raises; a CPU tensor takes the plain version (``ref.py``).
There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.scv_spmm import ref
from repro_torch.kernels.scv_spmm.build import load_library

#: Kernel launches since the count was last set to 0.  A plain int: it
#: rises by one for each launch that the kernel accepted, and nowhere else
#: (the CPU path and a refused launch add nothing).
launches = 0

MAX_THREADS = 128  # feature columns per block; one thread per column
SMEM_BYTES = 48 * 1024  # shared memory a block gets without opting in


def threads_for(n_feat: int, tile: int) -> int:
    """Threads per block: the feature width rounded up to whole warps, at
    most ``MAX_THREADS``, shrunk until the ``tile x threads`` f32 strip
    fits in shared memory."""
    threads = min(MAX_THREADS, -(-n_feat // 32) * 32)
    while threads > 32 and tile * threads * 4 > SMEM_BYTES:
        threads -= 32
    if tile * threads * 4 > SMEM_BYTES:
        raise ValueError(
            f"tile {tile} needs a {tile}x32 f32 strip of {tile * 128} bytes, "
            f"more than the {SMEM_BYTES} bytes of shared memory a block gets"
        )
    return threads


def _check(tile_row, tile_col, nnz_in_tile, rows, cols, vals, z, out, runs, tile):
    dev = z.device
    named = {
        "tile_row": tile_row, "tile_col": tile_col, "nnz_in_tile": nnz_in_tile,
        "rows": rows, "cols": cols, "vals": vals, "z": z, "out": out,
        "runs.ptr": runs.ptr,
    }
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, z on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("tile_row", "tile_col", "nnz_in_tile", "rows", "cols", "runs.ptr"):
        if named[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {named[name].dtype}")
    for name in ("vals", "z", "out"):
        if named[name].dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {named[name].dtype}")
    nt = tile_row.shape[0]
    if tile_row.dim() != 1 or tile_col.shape != (nt,) or nnz_in_tile.shape != (nt,):
        raise ValueError("tile_row, tile_col and nnz_in_tile must be 1-D of one length")
    if vals.dim() != 2 or vals.shape[0] != nt or not rows.shape == cols.shape == vals.shape:
        raise ValueError(
            f"rows/cols/vals must be [n_tiles={nt}, cap]; got {tuple(rows.shape)}, "
            f"{tuple(cols.shape)}, {tuple(vals.shape)}"
        )
    if z.dim() != 2 or out.dim() != 2 or out.shape[1] != z.shape[1]:
        raise ValueError(
            f"z and out must be 2-D with one feature width; got {tuple(z.shape)}, "
            f"{tuple(out.shape)}"
        )
    if out.shape[0] % tile:
        raise ValueError(f"out rows {out.shape[0]} not a multiple of tile {tile}")
    n_runs = runs.rows.shape[0]
    if runs.ptr.shape != (n_runs + 1,) or (nt > 0) != (n_runs > 0):
        raise ValueError(f"run index of {n_runs} runs does not fit {nt} tiles")
    if n_runs:
        if np.unique(runs.rows).size != n_runs:
            # two blocks would own one output strip and race on it
            raise ValueError("a block-row appears in two runs of one segment")
        if int(runs.rows.min()) < 0 or int(runs.rows.max()) >= out.shape[0] // tile:
            raise ValueError("a run's block-row lies outside out")


def scv_spmm_runs(
    tile_row: torch.Tensor,  # i32[nt]
    tile_col: torch.Tensor,  # i32[nt]
    nnz_in_tile: torch.Tensor,  # i32[nt]
    rows: torch.Tensor,  # i32[nt, cap]
    cols: torch.Tensor,  # i32[nt, cap]
    vals: torch.Tensor,  # f32[nt, cap]
    z: torch.Tensor,  # f32[n_cols, F]
    out: torch.Tensor,  # f32[n_rows_p, F], written in place
    runs,  # core.scv.RunIndex of this segment
    *,
    tile: int,
    accumulate: bool,
) -> torch.Tensor:
    """One SCV SpMM over one plan segment, into ``out``; returns ``out``.

    ``z`` must hold every column the entries name (``z.shape[0]`` at least
    the plan's column count); the caller guarantees it, as
    ``ops.scv_spmm_plan`` does."""
    global launches
    _check(tile_row, tile_col, nnz_in_tile, rows, cols, vals, z, out, runs, tile)
    if z.device.type == "cpu":
        part = ref.scv_spmm_reference(
            tile_row, tile_col, rows, cols, vals, z,
            tile=tile, n_rows=out.shape[0], nnz_in_tile=nnz_in_tile,
        )
        # the kernel leaves unvisited rows as they were; the plain version
        # writes zeros there, which is what a covered first segment gives
        return out.add_(part) if accumulate else out.copy_(part)
    if z.device.type != "cuda":
        raise ValueError(f"no SCV SpMM kernel for device {z.device}")
    n_runs = runs.rows.shape[0]
    n_feat = z.shape[1]
    if n_runs == 0 or n_feat == 0:
        return out
    threads = threads_for(n_feat, tile)
    lib = load_library()
    def ptr(t: torch.Tensor) -> ctypes.c_void_p:
        return ctypes.c_void_p(t.data_ptr())

    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        rc = lib.scv_spmm_runs(
            ptr(tile_row), ptr(tile_col), ptr(nnz_in_tile), ptr(rows), ptr(cols),
            ptr(vals), ptr(runs.ptr), ptr(z), ptr(out),
            n_runs, vals.shape[1], n_feat, tile, threads, int(accumulate),
            ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"scv_spmm_runs launch failed with CUDA error {rc}")
    launches += 1
    return out
