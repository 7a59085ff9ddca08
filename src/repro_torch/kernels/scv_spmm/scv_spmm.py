"""Launch wrapper for the SCV SpMM CUDA kernels (``csrc/scv_spmm.cu``).

Counterpart of ``scv_spmm_pallas`` (``src/repro/kernels/scv_spmm/
scv_spmm.py:197``).  One call computes one segment of a plan into ``out``
in place: ``out = A_seg @ Z`` on the rows the segment visits, or, with
``accumulate=True``, ``out += A_seg @ Z`` there (the TPU kernel's aliased
``acc`` operand).  Rows the segment does not visit keep their contents.
``body="vector"`` runs the vector body (sparse gather branch, and the
dense-tile branch for tiles over ``dense_threshold``); ``body="scalar"``
the per-entry scalar body.

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

#: Kernel launches since the counts were last set to 0.  Plain ints: each
#: rises by one for each launch that the kernel accepted, and nowhere else
#: (the CPU path and a refused launch add nothing).
#: ``launches`` counts the vector body (kernel table rows 1 and 2),
#: ``dense_launches`` those of its launches in which a tile took the dense
#: branch (row 3; they count in ``launches`` too), ``scalar_launches`` the
#: scalar body (row 4).
launches = 0
dense_launches = 0
scalar_launches = 0

MAX_THREADS = 128  # feature columns per block; one thread per column
SMEM_BYTES = 48 * 1024  # shared memory a block gets without opting in
SMEM_OPT_IN_BYTES = 227 * 1024  # the most a block may opt in to (H100)
SCALAR_STAGE = 256  # entries the scalar body stages in shared memory at a time
BODIES = ("vector", "scalar")


def reset_counts() -> None:
    """Set every launch count to 0."""
    global launches, dense_launches, scalar_launches
    launches = dense_launches = scalar_launches = 0


def extra_smem(tile: int, body: str, dense: bool) -> int:
    """Shared memory a block needs beside its strip: D (``tile x ldd``
    f32, ``ldd`` = tile rounded up to 4) when the dense branch runs, the
    staged entries for the scalar body."""
    if body == "scalar":
        return 12 * SCALAR_STAGE
    return 4 * tile * (-(-tile // 4) * 4) if dense else 0


def threads_for(n_feat: int, tile: int, extra: int = 0) -> int:
    """Threads per block: the feature width rounded up to whole warps, at
    most ``MAX_THREADS``, shrunk until the ``tile x threads`` f32 strip
    and ``extra`` bytes fit the 48 KB a block gets by default.  Where no
    width fits (a large tile with the dense branch's D), the full width
    opts in to more shared memory, up to ``SMEM_OPT_IN_BYTES``."""
    full = min(MAX_THREADS, -(-n_feat // 32) * 32)
    for threads in range(full, 0, -32):
        if tile * threads * 4 + extra <= SMEM_BYTES:
            return threads
    if tile * full * 4 + extra <= SMEM_OPT_IN_BYTES:
        return full
    raise ValueError(
        f"tile {tile} needs {tile * full * 4 + extra} bytes of shared memory "
        f"(strip and {extra} more), over the {SMEM_OPT_IN_BYTES} a block may "
        "opt in to"
    )


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
    if runs.max_nnz > vals.shape[1]:
        raise ValueError(f"a tile holds {runs.max_nnz} entries, over the cap {vals.shape[1]}")
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
    body: str = "vector",
    dense_threshold: int | None = None,
) -> torch.Tensor:
    """One SCV SpMM over one plan segment, into ``out``; returns ``out``.

    ``z`` must hold every column the entries name (``z.shape[0]`` at least
    the plan's column count); the caller guarantees it, as
    ``ops.scv_spmm_plan`` does.  ``dense_threshold`` (vector body only;
    ``None``: the reference's ``dense_tile_threshold(tile)``) sends each
    tile with ``nnz > dense_threshold >= 0`` through the dense branch; a
    negative one turns the branch off.  Whether a tile of the launch does
    so is read on the host from ``runs.max_nnz``."""
    global launches, dense_launches, scalar_launches
    if body not in BODIES:
        raise ValueError(f"unknown kernel body {body!r}")
    _check(tile_row, tile_col, nnz_in_tile, rows, cols, vals, z, out, runs, tile)
    if dense_threshold is None:
        from repro_torch.core.scv import dense_tile_threshold

        dense_threshold = dense_tile_threshold(tile)
    dense = body == "vector" and 0 <= dense_threshold < runs.max_nnz
    if z.device.type == "cpu":
        kw = dict(tile=tile, n_rows=out.shape[0], nnz_in_tile=nnz_in_tile)
        args = (tile_row, tile_col, rows, cols, vals, z)
        part = (ref.scv_spmm_vector_reference(*args, dense_threshold=dense_threshold, **kw)
                if dense else ref.scv_spmm_reference(*args, **kw))
        # the kernel leaves unvisited rows as they were; the plain version
        # writes zeros there, which is what a covered first segment gives
        return out.add_(part) if accumulate else out.copy_(part)
    if z.device.type != "cuda":
        raise ValueError(f"no SCV SpMM kernel for device {z.device}")
    n_runs = runs.rows.shape[0]
    n_feat = z.shape[1]
    if n_runs == 0 or n_feat == 0:
        return out
    threads = threads_for(n_feat, tile, extra_smem(tile, body, dense))
    lib = load_library()

    def ptr(t: torch.Tensor) -> ctypes.c_void_p:
        return ctypes.c_void_p(t.data_ptr())

    pointers = (ptr(tile_row), ptr(tile_col), ptr(nnz_in_tile), ptr(rows), ptr(cols),
                ptr(vals), ptr(runs.ptr), ptr(z), ptr(out))
    ints = (n_runs, vals.shape[1], n_feat, tile, threads, int(accumulate))
    with torch.cuda.device(z.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(z.device).cuda_stream)
        if body == "scalar":
            rc = lib.scv_spmm_runs_scalar(*pointers, *ints, stream)
        else:
            # D is given room only when a tile of this launch is dense
            rc = lib.scv_spmm_runs(*pointers, *ints, z.shape[0],
                                   dense_threshold if dense else -1, stream)
    if rc != 0:
        raise RuntimeError(f"scv_spmm_runs ({body}) launch failed with CUDA error {rc}")
    if body == "scalar":
        scalar_launches += 1
    else:
        launches += 1
        dense_launches += int(dense)
    return out
