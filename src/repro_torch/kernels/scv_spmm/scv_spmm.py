"""Launch wrapper for the SCV SpMM CUDA kernels (``csrc/scv_spmm.cu``).

Counterpart of ``scv_spmm_pallas`` (``src/repro/kernels/scv_spmm/
scv_spmm.py:197``).  :func:`scv_spmm_chain` runs the vector body once over
a chain of capacity segments (a bucketed plan's, or a span's) into ``out``
in place: ``out = A @ Z`` on the rows the segments visit, or, with
``accumulate=True``, ``out += A @ Z`` there (the TPU kernel's aliased
``acc`` operand, which the TPU chains once per segment).  Rows no segment
visits keep their contents.  :func:`scv_spmm_runs` computes one segment:
the vector body (sparse gather branch, and the dense-tile branch on the
tensor cores for tiles over ``dense_threshold``) over that segment alone,
or ``body="scalar"``, the per-entry scalar body.

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
#: ``launches`` counts the vector body (kernel table rows 1 and 2; one per
#: chain), ``chain_launches`` those of its launches over more than one
#: segment with tiles (row 2, the TPU's accumulate mode), ``dense_launches``
#: those in which a tile took the dense branch (row 3; both count in
#: ``launches`` too), ``scalar_launches`` the scalar body (row 4; one per
#: segment).
launches = 0
chain_launches = 0
dense_launches = 0
scalar_launches = 0
#: Launches recorded into a CUDA graph being captured: ``(runs, body,
#: dense_threshold)`` per launch, ``runs`` the launch's run index (a
#: ``PlanRuns`` for the vector body, a ``RunIndex`` for the scalar).  A
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
MAX_SEGMENTS = 16  # capacity segments one vector launch takes (its segment table)
STRIP_PAD = 8  # strip columns past the threads, dense branch on
DENSE_PAD = 4  # D's columns past its depth
BODIES = ("vector", "scalar")


def reset_counts() -> None:
    """Set every launch count to 0."""
    global launches, chain_launches, dense_launches, scalar_launches
    launches = chain_launches = dense_launches = scalar_launches = 0


def launch_counts(body: str, dense_threshold: int, runs) -> tuple[int, int, int, int]:
    """``(launches, dense_launches, scalar_launches, chain_launches)`` that
    one launch on the run index ``runs`` adds: a vector launch is dense when
    a tile of it (``runs.max_nnz``, its fullest tile) passes ``dense_threshold
    >= 0``, and a chain when more than one of its segments holds tiles."""
    if body == "scalar":
        return (0, 0, 1, 0)
    return (1, int(0 <= dense_threshold < runs.max_nnz), 0, int(runs.n_live > 1))


def add_counts(counts) -> None:
    """Add ``(launches, dense_launches, scalar_launches, chain_launches)``
    to the counts: one launch's, or a replayed CUDA graph's
    (:func:`launch_counts`)."""
    global launches, chain_launches, dense_launches, scalar_launches
    launches += counts[0]
    dense_launches += counts[1]
    scalar_launches += counts[2]
    chain_launches += counts[3]


def smem_bytes(tile: int, threads: int, body: str = "vector", dense: bool = False) -> int:
    """Shared memory one block of the kernel takes (the C entries' own
    count).  The vector body: the ``tile x stride`` f32 strip (``stride =
    threads``, or ``threads + STRIP_PAD`` when a tile of the launch is
    dense), then with the dense branch on D (``tile_m x (tile_k +
    DENSE_PAD)``, ``tile_k`` and ``tile_m`` the tile rounded up to 8 and
    16), then the staged entries and headers.
    The scalar body: the ``tile x threads`` strip, its ring of stages (each:
    three arrays of ``4 * SCALAR_QUADS`` entries and the chunk's plan) and a
    flag."""
    if body == "scalar":
        plan = 8 * SCALAR_PIECES + 4 * (4 * SCALAR_PIECES + 1) + 8  # struct Chunk
        stage = 48 * SCALAR_QUADS + -(-plan // 8) * 8  # struct Stage, before its alignment
        return 4 * tile * threads + SCALAR_STAGES * (-(-stage // 16) * 16) + 16
    stride = threads + (STRIP_PAD if dense else 0)
    floats = tile * stride
    if dense:
        tile_k, tile_m = -(-tile // 8) * 8, -(-tile // 16) * 16
        floats += tile_m * (tile_k + DENSE_PAD)
    headers = 4 * (5 * UNIT_HEADERS + 4)  # five header arrays, one a header longer, 3 counts
    return 4 * floats + 16 * UNIT_ENTRIES + headers


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


def check_plan_runs(pr, n_segments: int, n_row_blocks: int) -> None:
    """The host checks of a chain's plan-level run index (``PlanRuns``)
    against its ``n_segments`` segments and an output of ``n_row_blocks``
    strips; every chain launch runs them, after each segment's own."""
    if pr.n_segments != n_segments:
        raise ValueError(f"plan run index of {pr.n_segments} segments does not fit a chain "
                         f"of {n_segments}")
    n_runs, n_units = pr.n_runs, pr.n_units
    if (pr.pieces.dim() != 2 or pr.pieces.shape[1] != 4 or pr.units.shape != (n_units, 4)
            or pr.unit_ptr.shape != (n_runs + 1,) or pr.order.shape != (n_units,)
            or pr.run_row.shape != (n_runs,) or n_units < n_runs
            or not 0 <= pr.n_split_units <= n_units):
        raise ValueError(f"plan unit index of {n_units} units does not fit {n_runs} runs")
    if n_runs:
        if np.unique(pr.rows).size != n_runs:
            raise ValueError("a block-row appears in two runs of one chain")
        if int(pr.rows.min()) < 0 or int(pr.rows.max()) >= n_row_blocks:
            raise ValueError("a run's block-row lies outside out")


def scv_spmm_chain(
    segments,  # SCVPlan segments of one plan (or span), in order; at most MAX_SEGMENTS
    vals,  # f32[nt_k, cap_k] per segment: the values each segment computes with
    z: torch.Tensor,  # f32[n_cols, F]
    out: torch.Tensor,  # f32[n_rows_p, F], written in place
    *,
    accumulate: bool,
    dense_threshold: int | None = None,
    runs=None,  # core.scv.PlanRuns of the chain; None: core.scv.plan_runs of its segments
) -> torch.Tensor:
    """One launch of the vector body over every segment of a chain, into
    ``out``; returns ``out``.  ``out = A @ Z`` on the rows the segments
    visit (a covered first segment visits every row), or ``out += A @ Z``
    with ``accumulate``.  Segments without tiles take no part.

    ``dense_threshold`` as for :func:`scv_spmm_runs`; whether a tile of the
    launch is dense is read on the host from ``runs.max_nnz``.  The launch
    takes one block per (work unit, feature block) of the plan-level run
    index: a block-row's tiles of every segment form one run.  Launches
    that share ``runs`` must be ordered on one stream (its split runs'
    counters).  On the CPU: the plain version of each segment, summed into
    ``out`` in segment order, as a chain of launches would."""
    from repro_torch.core.scv import dense_tile_threshold, plan_runs

    if not 0 < len(segments) <= MAX_SEGMENTS or len(vals) != len(segments):
        raise ValueError(f"a chain launch takes 1 to {MAX_SEGMENTS} segments with one values "
                         f"array each; got {len(segments)} and {len(vals)}")
    live = [(s, v) for s, v in zip(segments, vals) if s.n_tiles]
    tile = segments[0].tile
    for s, v in live:
        _check(s.tile_row, s.tile_col, s.nnz_in_tile, s.rows, s.cols, v, z, out, s.runs, tile)
    if dense_threshold is None:
        dense_threshold = dense_tile_threshold(tile)
    if z.device.type == "cpu":
        for s, v in live:
            args = (s.tile_row, s.tile_col, s.rows, s.cols, v, z)
            kw = dict(tile=tile, n_rows=out.shape[0], nnz_in_tile=s.nnz_in_tile)
            if 0 <= dense_threshold < s.runs.max_nnz:
                part = ref.scv_spmm_vector_reference(*args, dense_threshold=dense_threshold, **kw)
            else:
                part = ref.scv_spmm_reference(*args, **kw)
            # the plain version writes zeros on rows the segment does not
            # visit, which is what a covered first segment gives
            out.add_(part) if accumulate else out.copy_(part)
            accumulate = True
        return out
    if z.device.type != "cuda":
        raise ValueError(f"no SCV SpMM kernel for device {z.device}")
    if runs is None:
        runs = plan_runs(tuple(s.runs for s in segments))
    check_plan_runs(runs, len(segments), out.shape[0] // tile)
    if runs.n_runs == 0 or z.shape[1] == 0:
        return out
    dense = 0 <= dense_threshold < runs.max_nnz
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        rc = _launch_vector(load_library(), segments, vals, z, out, runs, tile, accumulate,
                            dense_threshold if dense else -1, stream)
    if rc != 0:
        raise RuntimeError(f"scv_spmm_chain launch failed with CUDA error {rc}")
    _count(runs, "vector", dense_threshold)
    return out


def _count(runs, body: str, dense_threshold: int) -> None:
    """One accepted launch: counted now, or recorded for the replays of the
    CUDA graph that a capturing stream records it into."""
    if torch.cuda.is_current_stream_capturing():
        captured.append((runs, body, dense_threshold))
    else:
        add_counts(launch_counts(body, dense_threshold, runs))


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
    so is read on the host from ``runs.max_nnz``.  The vector body is
    :func:`scv_spmm_chain` over this one segment (its plan-level index
    built from ``runs``); the scalar body launches one block per (work
    unit, feature block) of ``runs``.  Launches that share ``runs`` must be
    ordered on one stream: the split runs' counters are the run index's."""
    if body not in BODIES:
        raise ValueError(f"unknown kernel body {body!r}")
    if body == "vector":
        from repro_torch.core.scv import ZMORTON, SCVPlan

        seg = SCVPlan(tile_row=tile_row, tile_col=tile_col, rows=rows, cols=cols, vals=vals,
                      nnz_in_tile=nnz_in_tile, perm=None, tile=tile, cap=int(vals.shape[1]),
                      shape=(out.shape[0], z.shape[0]), order=ZMORTON, runs=runs)
        return scv_spmm_chain((seg,), (vals,), z, out, accumulate=accumulate,
                              dense_threshold=dense_threshold)
    _check(tile_row, tile_col, nnz_in_tile, rows, cols, vals, z, out, runs, tile)
    if z.device.type == "cpu":
        part = ref.scv_spmm_reference(tile_row, tile_col, rows, cols, vals, z, tile=tile,
                                      n_rows=out.shape[0], nnz_in_tile=nnz_in_tile)
        return out.add_(part) if accumulate else out.copy_(part)
    if z.device.type != "cuda":
        raise ValueError(f"no SCV SpMM kernel for device {z.device}")
    if runs.n_runs == 0 or z.shape[1] == 0:
        return out
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        rc = _launch_scalar(load_library(), tile_row, tile_col, nnz_in_tile, rows, cols, vals,
                            z, out, runs, tile, accumulate, stream)
    if rc != 0:
        raise RuntimeError(f"scv_spmm_runs ({body}) launch failed with CUDA error {rc}")
    _count(runs, body, -1)
    return out


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _scratch(runs, tile: int, n_feat: int, threads: int, device):
    """A launch's scratch (one partial strip per unit of a split run), a
    ``torch.empty`` on ``device``, and the run index's counters; ``(None,
    None)`` when no run is split.  The scratch is freed when the launch
    wrapper returns, while the launch may still run: the caching allocator
    hands the memory on only to work queued after it on this stream."""
    if not runs.n_split_units:
        return None, None
    scratch = torch.empty((runs.n_split_units, tile, n_feat), dtype=torch.float32, device=device)
    return scratch, runs.counters(device, -(-n_feat // threads))


def _launch_vector(lib, segments, vals, z, out, runs, tile, accumulate, dense_threshold,
                   stream) -> int:
    """One vector launch through the C entry; returns its CUDA error code.
    ``dense_threshold`` is negative when no tile of the launch is dense,
    and only then does the kernel keep no room for D."""
    n_feat = z.shape[1]
    threads = threads_for(n_feat, tile, "vector", dense_threshold >= 0)
    scratch, counters = _scratch(runs, tile, n_feat, threads, z.device)
    n = len(segments)

    def table(ts):
        return (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))

    return lib.scv_spmm_runs(
        n, table(s.tile_col for s in segments), table(s.nnz_in_tile for s in segments),
        table(s.rows for s in segments), table(s.cols for s in segments), table(vals),
        (ctypes.c_int * n)(*(int(v.shape[1]) for v in vals)),
        _ptr(runs.pieces), _ptr(runs.units), _ptr(runs.unit_ptr), _ptr(runs.order),
        _ptr(runs.run_row), _ptr(z), _ptr(out), _ptr(scratch), _ptr(counters),
        runs.n_units, n_feat, tile, threads, int(accumulate), z.shape[0], dense_threshold,
        ctypes.c_void_p(stream))


def _launch_scalar(lib, tile_row, tile_col, nnz_in_tile, rows, cols, vals, z, out, runs, tile,
                   accumulate, stream) -> int:
    """One scalar launch through the C entry; returns its CUDA error code."""
    n_feat = z.shape[1]
    threads = threads_for(n_feat, tile, "scalar")
    scratch, counters = _scratch(runs, tile, n_feat, threads, z.device)
    return lib.scv_spmm_runs_scalar(
        _ptr(tile_row), _ptr(tile_col), _ptr(nnz_in_tile), _ptr(rows), _ptr(cols), _ptr(vals),
        _ptr(runs.units), _ptr(runs.unit_ptr), _ptr(runs.order), _ptr(z), _ptr(out),
        _ptr(scratch), _ptr(counters), runs.n_units, vals.shape[1], n_feat, tile, threads,
        int(accumulate), ctypes.c_void_p(stream))


def blocks_per_sm(tile: int, n_feat: int, dense: bool) -> int:
    """Blocks of the vector body one SM of the current card holds at once,
    at the width :func:`threads_for` gives (measured only)."""
    threads = threads_for(n_feat, tile, "vector", dense)
    blocks = ctypes.c_int(0)
    rc = load_library().scv_spmm_runs_occupancy(tile, threads, int(dense), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed with CUDA error {rc}")
    return blocks.value
