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
UNIT_ENTRIES = 256  # entries the vector body stages at a time (16 bytes each)
UNIT_HEADERS = 256  # tile headers the vector body stages at a time
BODIES = ("vector", "scalar")


def reset_counts() -> None:
    """Set every launch count to 0."""
    global launches, dense_launches, scalar_launches
    launches = dense_launches = scalar_launches = 0


def smem_bytes(tile: int, threads: int, body: str = "vector", dense: bool = False) -> int:
    """Shared memory one block of the kernel takes (the C entries' own
    count): the ``tile x threads`` f32 strip, and for the vector body the
    staged entries and headers, plus the dense branch's ``tile x threads``
    f32 Z block when a tile of the launch is dense; for the scalar body its
    staged entries."""
    strip = 4 * tile * threads
    if body == "scalar":
        return strip + 12 * SCALAR_STAGE
    headers = 4 * (5 * UNIT_HEADERS + 4)  # five header arrays, one a header longer, 3 counts
    return strip * (2 if dense else 1) + 16 * UNIT_ENTRIES + headers


def threads_for(n_feat: int, tile: int, body: str = "vector", dense: bool = False) -> int:
    """Threads per block: the feature width rounded up to whole warps, at
    most ``MAX_THREADS``.  The vector body keeps the full width, so that a
    block stages its entries for as many columns as it can, and opts in to
    more than 48 KB of shared memory where it needs to; it shrinks only
    where the full width does not fit ``SMEM_OPT_IN_BYTES``.  The scalar
    body keeps its measured configuration: the widest that fits the 48 KB
    a block gets by default, else the widest that fits the opt-in."""
    full = min(MAX_THREADS, -(-n_feat // 32) * 32)
    limits = (SMEM_BYTES, SMEM_OPT_IN_BYTES) if body == "scalar" else (SMEM_OPT_IN_BYTES,)
    for limit in limits:
        for threads in range(full, 0, -32):
            if smem_bytes(tile, threads, body, dense) <= limit:
                return threads
    raise ValueError(
        f"tile {tile} needs {smem_bytes(tile, 32, body, dense)} bytes of shared "
        f"memory even at 32 threads, over the {SMEM_OPT_IN_BYTES} a block may opt in to"
    )


def _check(tile_row, tile_col, nnz_in_tile, rows, cols, vals, z, out, runs, tile):
    dev = z.device
    named = {
        "tile_row": tile_row, "tile_col": tile_col, "nnz_in_tile": nnz_in_tile,
        "rows": rows, "cols": cols, "vals": vals, "z": z, "out": out,
        "runs.ptr": runs.ptr, "runs.units": runs.units, "runs.unit_ptr": runs.unit_ptr,
        "runs.order": runs.order,
    }
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, z on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("tile_row", "tile_col", "nnz_in_tile", "rows", "cols", "runs.ptr",
                 "runs.units", "runs.unit_ptr", "runs.order"):
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
    if runs.ptr.shape != (n_runs + 1,) or (nt > 0) != (n_runs > 0) or runs.n_tiles != nt:
        raise ValueError(f"run index of {n_runs} runs over {runs.n_tiles} tiles does not fit "
                         f"{nt} tiles")
    n_units = runs.n_units
    if (runs.units.shape != (n_units, 4) or runs.unit_ptr.shape != (n_runs + 1,)
            or runs.order.shape != (n_units,) or n_units < n_runs
            or not 0 <= runs.n_split_units <= n_units):
        raise ValueError(f"unit index of {n_units} units does not fit {n_runs} runs")
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
    so is read on the host from ``runs.max_nnz``.  The vector body launches
    one block per (work unit, feature block) of ``runs``, the scalar body
    one per (run, feature block).  Launches that share ``runs`` must be
    ordered on one stream: the split runs' counters are the run index's."""
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
    n_feat = z.shape[1]
    if runs.n_runs == 0 or n_feat == 0:
        return out
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        rc = _launch(load_library(), tile_row, tile_col, nnz_in_tile, rows, cols, vals, z,
                     out, runs, tile, accumulate, body, dense_threshold if dense else -1,
                     stream)
    if rc != 0:
        raise RuntimeError(f"scv_spmm_runs ({body}) launch failed with CUDA error {rc}")
    if body == "scalar":
        scalar_launches += 1
    else:
        launches += 1
        dense_launches += int(dense)
    return out


def _launch(lib, tile_row, tile_col, nnz_in_tile, rows, cols, vals, z, out, runs, tile,
            accumulate, body, dense_threshold, stream) -> int:
    """One launch through the C entries; returns their CUDA error code.
    ``dense_threshold`` is negative when no tile of the launch is dense,
    and only then does the kernel keep no room for the Z block.  The vector
    body's scratch (one partial strip per unit of a split run) is a
    ``torch.empty`` on ``z``'s device; its counters are the run index's,
    zeroed once per device and width."""
    n_feat = z.shape[1]
    dense = dense_threshold >= 0
    threads = threads_for(n_feat, tile, body, dense)

    def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    tiles = (ptr(tile_row), ptr(tile_col), ptr(nnz_in_tile), ptr(rows), ptr(cols), ptr(vals))
    shape = (vals.shape[1], n_feat, tile, threads, int(accumulate))
    if body == "scalar":
        return lib.scv_spmm_runs_scalar(*tiles, ptr(runs.ptr), ptr(z), ptr(out),
                                        runs.n_runs, *shape, ctypes.c_void_p(stream))
    scratch = counters = None
    if runs.n_split_units:
        # freed when this returns, while the launch may still run: the caching
        # allocator hands the memory on only to work queued after it on this stream
        scratch = torch.empty((runs.n_split_units, tile, n_feat), dtype=torch.float32,
                              device=z.device)
        counters = runs.counters(z.device, -(-n_feat // threads))
    return lib.scv_spmm_runs(*tiles, ptr(runs.units), ptr(runs.unit_ptr), ptr(runs.order),
                             ptr(z), ptr(out), ptr(scratch), ptr(counters), runs.n_units,
                             *shape, z.shape[0], dense_threshold, ctypes.c_void_p(stream))
