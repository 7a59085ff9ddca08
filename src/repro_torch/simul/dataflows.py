"""Per-format dataflows: entry order, compute schedule, and traffic.

Port of ``src/repro/simul/dataflows.py`` (host numpy, the same numbers).

Each ``run_<format>`` returns (ComputeResult, TrafficResult) for one
aggregation pass Â·Z with F feature columns, under the paper's shared-
memory budget (§V-A: 64 kB A / 64 kB Z / 256 kB PS).

Feature passes: a dataflow that pins a PS strip of R rows can only hold
F_pass = mem_ps / (4 R) feature columns at once; wider feature matrices
process in ceil(F / F_pass) passes, re-reading A and Z each pass — the
iso-memory discipline behind the paper's Fig. 12 height sweep.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.formats import COOMatrix, coo_to_bcsr, coo_to_csb
from repro_torch.core.scv import (
    ROW_MAJOR,
    ZMORTON,
    bucket_caps_for,
    coo_to_scv,
    launched_slots,
    tile_nnz_histogram,
)
from repro_torch.simul.machine import (
    ComputeResult,
    MachineConfig,
    compute_bcsr_blocks,
    compute_csc_fixed_rows,
    compute_csr_row_barrier,
    compute_entry_stream,
    compute_multipass,
)
from repro_torch.simul.memory import TrafficResult, directmapped_hits

E = 4  # bytes per value
IDX = 4  # bytes per 32-bit index


def _csr_order(a: COOMatrix) -> np.ndarray:
    return np.argsort(a.rows.astype(np.int64) * a.shape[1] + a.cols, kind="stable")


def _csc_order(a: COOMatrix) -> np.ndarray:
    return np.argsort(a.cols.astype(np.int64) * a.shape[0] + a.rows, kind="stable")


def run_csr(a: COOMatrix, f: int, cfg: MachineConfig):
    order = _csr_order(a)
    row_nnz = np.bincount(a.rows, minlength=a.shape[0])
    comp = compute_csr_row_barrier(row_nnz, f, cfg)
    # Z is gathered per entry; only mem_z worth of rows stay resident
    cols_stream = a.cols[order]
    z_rows_fit = max(1, cfg.mem_z_bytes // (E * f))
    hits = directmapped_hits(cols_stream, z_rows_fit)
    z_miss = cols_stream[~hits]
    bytes_a = a.nnz * (E + IDX) + (a.shape[0] + 1) * IDX
    bytes_z = float(len(z_miss)) * f * E
    bytes_ps = float((row_nnz > 0).sum()) * f * E  # each PS row written once
    traffic = TrafficResult(bytes_a, bytes_z, bytes_ps, z_miss, f * E)
    return comp, traffic


def run_csc(a: COOMatrix, f: int, cfg: MachineConfig):
    order = _csc_order(a)
    rows_stream = a.rows[order]
    comp = compute_csc_fixed_rows(rows_stream, f, cfg)
    col_nnz = np.bincount(a.cols, minlength=a.shape[1])
    bytes_a = a.nnz * (E + IDX) + (a.shape[1] + 1) * IDX
    bytes_z = float((col_nnz > 0).sum()) * f * E  # each Z row read once
    # PS thrash: only mem_ps worth of rows resident; misses pay read+write
    ps_rows_fit = max(1, cfg.mem_ps_bytes // (E * f))
    hits = directmapped_hits(rows_stream, ps_rows_fit)
    ps_miss = rows_stream[~hits]
    bytes_ps = float(len(ps_miss)) * 2 * f * E
    # the irregular stream that reaches cache/DRAM is the PS stream
    traffic = TrafficResult(bytes_a, bytes_z, bytes_ps, ps_miss, f * E)
    return comp, traffic


def run_scv(
    a: COOMatrix,
    f: int,
    cfg: MachineConfig,
    height: int = 512,
    order: str = ZMORTON,
):
    scv = coo_to_scv(a, height, order=order)
    counts = np.diff(scv.blk_ptr)
    rows_in_order = (
        np.repeat(scv.vec_row_blk.astype(np.int64), counts) * height + scv.blk_id
    )
    comp = compute_entry_stream(rows_in_order, f, cfg)
    f_pass = int(np.clip(cfg.mem_ps_bytes // (E * height), 8, f))
    passes = -(-f // f_pass)
    # A: value + within-vector offset (log2 B bits, byte-rounded) + blk_ptr
    idx_bytes = max(1, scv.index_bits_per_entry // 8)
    bytes_a = (scv.nnz * (E + idx_bytes) + scv.n_vectors * IDX) * passes
    # Z: one row slice per vector per pass (the SCV reuse guarantee)
    bytes_z = float(scv.n_vectors) * f_pass * E * passes
    # PS: distinct rows touched, written once per pass (f_pass columns each)
    touched = np.unique(rows_in_order)
    bytes_ps = float(len(touched)) * f * E  # once per pass x f_pass = f total
    z_stream = np.concatenate([scv.vec_col.astype(np.int64)] * passes) if passes > 1 else scv.vec_col.astype(np.int64)
    traffic = TrafficResult(bytes_a, bytes_z, bytes_ps, z_stream, f_pass * E)
    return comp, traffic


def run_scv_bucketed(
    a: COOMatrix,
    f: int,
    cfg: MachineConfig,
    tile: int,
    caps=None,
):
    """:func:`run_scv` with the adjacency stream priced at the *launched*
    bucketed capacity slots instead of logical nnz.

    The device plan ships three 32-bit arrays (rows/cols/vals) per
    capacity slot, padding included, so ``bytes_a``
    becomes ``3 * slots * E`` per feature pass, with ``slots`` from
    :func:`core.scv.launched_slots` (chain-split at the top cap, remainder
    in the smallest fitting cap, first-segment coverage dummies).  Compute
    cycles and the Z/PS traffic terms are unchanged: padding slots are
    masked, they cost bytes, not MACs.  Returns ``(comp, traffic, slots)``.
    """
    counts = tile_nnz_histogram(a, tile)
    if caps is None:
        caps = bucket_caps_for(counts, tile)
    comp, traffic = run_scv(a, f, cfg, height=tile)
    n_row_blocks = -(-a.shape[0] // int(tile))
    slots = launched_slots(counts, tile, caps, n_row_blocks=n_row_blocks)
    f_pass = int(np.clip(cfg.mem_ps_bytes // (E * int(tile)), 8, f))
    passes = -(-f // f_pass)
    bytes_a = float(3 * slots * E) * passes
    traffic = TrafficResult(
        bytes_a, traffic.bytes_z, traffic.bytes_ps,
        traffic.z_row_stream, traffic.feature_bytes,
    )
    return comp, traffic, slots


def run_scv_width(
    a: COOMatrix,
    f: int,
    cfg: MachineConfig,
    height: int = 64,
    width: int = 1,
):
    """Fig. 13: SCV-like tiles of ``width`` columns (width 1 == SCV).  A
    single nonzero in a tile forces all ``width`` Z rows to be fetched."""
    csb = coo_to_csb(a, height, width)
    counts = np.diff(csb.blk_ptr)
    rows_in_order = (
        np.repeat(csb.blk_row.astype(np.int64), counts) * height + csb.row_id
    )
    comp = compute_entry_stream(rows_in_order, f, cfg)
    f_pass = int(np.clip(cfg.mem_ps_bytes // (E * height), 8, f))
    passes = -(-f // f_pass)
    idx_bytes = 2 * max(1, int(np.ceil(np.log2(max(height, width, 2)))) // 8 + 1)
    bytes_a = (csb.nnz * (E + idx_bytes) + csb.n_blocks * 3 * IDX) * passes
    bytes_z = float(csb.n_blocks) * width * f_pass * E * passes
    touched = np.unique(rows_in_order)
    bytes_ps = float(len(touched)) * f * E
    # stream at tile-column granularity: feature_bytes scales with width
    z_stream = np.repeat(csb.blk_col.astype(np.int64), 1)
    if passes > 1:
        z_stream = np.concatenate([z_stream] * passes)
    traffic = TrafficResult(bytes_a, bytes_z, bytes_ps, z_stream, width * f_pass * E)
    return comp, traffic


def run_bcsr(a: COOMatrix, f: int, cfg: MachineConfig, block: int = 16):
    b = coo_to_bcsr(a, block)
    comp = compute_bcsr_blocks(b.n_blocks, block, f, cfg)
    f_pass = int(np.clip(cfg.mem_ps_bytes // (E * block), 8, f))
    passes = -(-f // f_pass)
    bytes_a = (float(b.n_blocks) * block * block * E + b.n_blocks * IDX) * passes
    bytes_z = float(b.n_blocks) * block * f_pass * E * passes
    brow = np.repeat(np.arange(len(b.row_ptr) - 1), np.diff(b.row_ptr))
    bytes_ps = float(len(np.unique(brow))) * block * f * E
    z_stream = b.col_id.astype(np.int64)
    if passes > 1:
        z_stream = np.concatenate([z_stream] * passes)
    traffic = TrafficResult(bytes_a, bytes_z, bytes_ps, z_stream, block * f_pass * E)
    return comp, traffic


def run_multipass(a: COOMatrix, f: int, cfg: MachineConfig):
    """MP (§II-B.4): Z is streamed sequentially once; entries process in
    the pass whose cached Z span covers their column."""
    order = _csc_order(a)
    rows_stream = a.rows[order]
    cols_stream = a.cols[order]
    cols_per_pass = max(1, cfg.cache_bytes // (E * f))
    passes = max(1, -(-a.shape[1] // cols_per_pass))
    comp = compute_multipass(rows_stream, passes, a.nnz, f, cfg)
    bytes_a = float(a.nnz) * (E + IDX) * passes
    col_nnz = np.bincount(a.cols, minlength=a.shape[1])
    bytes_z = float((col_nnz > 0).sum()) * f * E  # sequential, once overall
    entry_pass = cols_stream // cols_per_pass
    rp = np.unique(rows_stream.astype(np.int64) * passes + entry_pass)
    bytes_ps = float(len(rp)) * 2 * f * E
    z_stream = np.sort(np.unique(cols_stream)).astype(np.int64)  # sequential
    traffic = TrafficResult(bytes_a, bytes_z, bytes_ps, z_stream, f * E)
    return comp, traffic


RUNNERS = {
    "csr": run_csr,
    "csc": run_csc,
    "scv": lambda a, f, cfg, **kw: run_scv(a, f, cfg, order=ROW_MAJOR, **kw),
    "scv_z": lambda a, f, cfg, **kw: run_scv(a, f, cfg, order=ZMORTON, **kw),
    "bcsr": run_bcsr,
    "mp": run_multipass,
}
