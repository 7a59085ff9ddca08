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
#: (the CPU path and a refused launch add nothing; a launch captured into a
#: CUDA graph adds nothing until the graph replays it).
#: ``launches`` counts the vector body (kernel table rows 1 and 2),
#: ``dense_launches`` those of its launches in which a tile took the dense
#: branch (row 3; they count in ``launches`` too), ``scalar_launches`` the
#: scalar body (row 4).
launches = 0
dense_launches = 0
scalar_launches = 0
#: Launches recorded into a CUDA graph being captured: ``(runs, body,
#: dense_threshold)`` per launch, ``runs`` the launch's run index.  A
#: captured launch runs only when the graph replays, so the counts rise
#: then, by :func:`launch_counts` over the run index the replay loaded
#: (:func:`add_counts`); the capturer takes its entries off this list.
captured: list = []

MAX_THREADS = 128  # feature columns per block; one thread per column
SMEM_BYTES = 48 * 1024  # shared memory a block gets without opting in
SMEM_OPT_IN_BYTES = 227 * 1024  # the most a block may opt in to (H100)
SCALAR_STAGES = 2  # stages in the scalar body's ring of staged entries
SCALAR_QUADS = 128  # 16-byte quads of each entry array (rows, cols, vals) a stage holds
SCALAR_PIECES = 32  # tile slices a stage's chunk holds at most
UNIT_ENTRIES = 256  # entries the vector body stages at a time (16 bytes each)
UNIT_HEADERS = 256  # tile headers the vector body stages at a time
BODIES = ("vector", "scalar")


def reset_counts() -> None:
    """Set every launch count to 0."""
    global launches, dense_launches, scalar_launches
    launches = dense_launches = scalar_launches = 0


def launch_counts(body: str, dense_threshold: int, max_nnz: int) -> tuple[int, int, int]:
    """``(launches, dense_launches, scalar_launches)`` that one launch adds:
    a vector launch is dense when a tile of its run index (``max_nnz``, its
    fullest tile) passes ``dense_threshold >= 0``."""
    if body == "scalar":
        return (0, 0, 1)
    return (1, int(0 <= dense_threshold < max_nnz), 0)


def add_counts(counts) -> None:
    """Add ``(launches, dense_launches, scalar_launches)`` to the counts:
    one launch's, or a replayed CUDA graph's (:func:`launch_counts`)."""
    global launches, dense_launches, scalar_launches
    launches += counts[0]
    dense_launches += counts[1]
    scalar_launches += counts[2]


def smem_bytes(tile: int, threads: int, body: str = "vector", dense: bool = False) -> int:
    """Shared memory one block of the kernel takes (the C entries' own
    count): the ``tile x threads`` f32 strip, and for the vector body the
    staged entries and headers, plus the dense branch's ``tile x threads``
    f32 Z block when a tile of the launch is dense; for the scalar body its
    ring of stages (each: three arrays of ``4 * SCALAR_QUADS`` entries and
    the chunk's plan) and a flag."""
    strip = 4 * tile * threads
    if body == "scalar":
        plan = 8 * SCALAR_PIECES + 4 * (4 * SCALAR_PIECES + 1) + 8  # struct Chunk
        stage = 48 * SCALAR_QUADS + -(-plan // 8) * 8  # struct Stage, before its alignment
        return strip + SCALAR_STAGES * (-(-stage // 16) * 16) + 16
    headers = 4 * (5 * UNIT_HEADERS + 4)  # five header arrays, one a header longer, 3 counts
    return strip * (2 if dense else 1) + 16 * UNIT_ENTRIES + headers


def threads_for(n_feat: int, tile: int, body: str = "vector", dense: bool = False) -> int:
    """Threads per block: the feature width rounded up to whole warps, at
    most ``MAX_THREADS``, so that a block stages its entries for as many
    columns as it can; above 48 KB of shared memory the kernel opts in, and
    the width shrinks only where it does not fit ``SMEM_OPT_IN_BYTES``.
    Both bodies take this rule.  For the scalar body it was measured
    against the widest width within the 48 KB a block gets by default (at
    T = 128 and F = 128: 64 threads, two feature blocks, each staging every
    entry): the same time on the H100 (``PERF.md``, kernel table row 4)."""
    full = min(MAX_THREADS, -(-n_feat // 32) * 32)
    for threads in range(full, 0, -32):
        if smem_bytes(tile, threads, body, dense) <= SMEM_OPT_IN_BYTES:
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
        "runs.units": runs.units, "runs.unit_ptr": runs.unit_ptr, "runs.order": runs.order,
    }
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, z on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("tile_row", "tile_col", "nnz_in_tile", "rows", "cols", "runs.units",
                 "runs.unit_ptr", "runs.order"):
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
    check_runs(runs, nt, vals.shape[1], out.shape[0] // tile)


def check_runs(runs, n_tiles: int, cap: int, n_row_blocks: int) -> None:
    """The host checks of a segment's run index against its ``n_tiles``
    tiles of capacity ``cap`` and an output of ``n_row_blocks`` strips;
    every launch runs them, and a captured forward runs them on each plan
    before copying its run index into the graph's tables."""
    n_runs = runs.rows.shape[0]
    if runs.ptr.shape != (n_runs + 1,) or (n_tiles > 0) != (n_runs > 0) or runs.n_tiles != n_tiles:
        raise ValueError(f"run index of {n_runs} runs over {runs.n_tiles} tiles does not fit "
                         f"{n_tiles} tiles")
    n_units = runs.n_units
    if (runs.units.shape != (n_units, 4) or runs.unit_ptr.shape != (n_runs + 1,)
            or runs.order.shape != (n_units,) or n_units < n_runs
            or not 0 <= runs.n_split_units <= n_units):
        raise ValueError(f"unit index of {n_units} units does not fit {n_runs} runs")
    if runs.max_nnz > cap:
        raise ValueError(f"a tile holds {runs.max_nnz} entries, over the cap {cap}")
    if n_runs:
        if np.unique(runs.rows).size != n_runs:
            # two blocks would own one output strip and race on it
            raise ValueError("a block-row appears in two runs of one segment")
        if int(runs.rows.min()) < 0 or int(runs.rows.max()) >= n_row_blocks:
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
    one block per (work unit, feature block) of ``runs``, and so does the
    scalar body.  Launches that share ``runs`` must be ordered on one
    stream: the split runs' counters are the run index's."""
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
    if torch.cuda.is_current_stream_capturing():
        captured.append((runs, body, dense_threshold))
    else:
        add_counts(launch_counts(body, dense_threshold, runs.max_nnz))
    return out


def _launch(lib, tile_row, tile_col, nnz_in_tile, rows, cols, vals, z, out, runs, tile,
            accumulate, body, dense_threshold, stream) -> int:
    """One launch through the C entries; returns their CUDA error code.
    ``dense_threshold`` is negative when no tile of the launch is dense,
    and only then does the kernel keep no room for the Z block.  Both
    bodies' scratch (one partial strip per unit of a split run) is a
    ``torch.empty`` on ``z``'s device; their counters are the run index's,
    zeroed once per device and feature-block count."""
    n_feat = z.shape[1]
    dense = dense_threshold >= 0
    threads = threads_for(n_feat, tile, body, dense)

    def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    scratch = counters = None
    if runs.n_split_units:
        # freed when this returns, while the launch may still run: the caching
        # allocator hands the memory on only to work queued after it on this stream
        scratch = torch.empty((runs.n_split_units, tile, n_feat), dtype=torch.float32,
                              device=z.device)
        counters = runs.counters(z.device, -(-n_feat // threads))
    args = (ptr(tile_row), ptr(tile_col), ptr(nnz_in_tile), ptr(rows), ptr(cols), ptr(vals),
            ptr(runs.units), ptr(runs.unit_ptr), ptr(runs.order), ptr(z), ptr(out),
            ptr(scratch), ptr(counters), runs.n_units, vals.shape[1], n_feat, tile, threads,
            int(accumulate))
    if body == "scalar":
        return lib.scv_spmm_runs_scalar(*args, ctypes.c_void_p(stream))
    return lib.scv_spmm_runs(*args, z.shape[0], dense_threshold, ctypes.c_void_p(stream))
