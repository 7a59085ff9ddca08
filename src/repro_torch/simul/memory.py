"""Memory-hierarchy model: shared local memory -> cache -> DRAM (paper §V-A).

Port of ``src/repro/simul/memory.py`` (host numpy, the same numbers).

Level 1 — *shared local memory* (64 kB A / 64 kB Z / 256 kB PS): residency
is decided analytically per dataflow, because choosing what stays resident
is exactly what the sparse formats differ in.  Misses become traffic to the
cache (Fig. 9's metric).

Level 2 — *cache* (2 MB): simulated direct-mapped at Z-row granularity on
the Z miss stream (A is a stream — bypassed; PS strips are streaming
write-backs — write-around).  This level is where SCV-Z's Z-Morton order
pays off: consecutive vector groups re-touch nearby Z rows.

Level 3 — *DRAM*: row-buffer model (mini-Ramulator): per cache-miss Z row,
the first line activates a DRAM row, subsequent sequential lines hit it;
random re-activations pay the miss penalty.  MAT = mean access time over
the simulated stream, as in §V-D.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.simul.machine import MachineConfig


@dataclasses.dataclass(frozen=True)
class DramConfig:
    row_bytes: int = 2048
    n_banks: int = 8
    t_cache_hit: float = 12.0  # cycles, on-chip cache service
    t_rb_hit: float = 24.0  # DRAM access, row buffer open
    t_rb_miss: float = 64.0  # precharge + activate + CAS


@dataclasses.dataclass
class TrafficResult:
    bytes_a: float
    bytes_z: float
    bytes_ps: float
    z_row_stream: np.ndarray  # row-granular Z accesses that missed shared mem
    feature_bytes: int  # bytes of one Z/PS row slice in this dataflow

    @property
    def total_bytes(self) -> float:
        return self.bytes_a + self.bytes_z + self.bytes_ps


@dataclasses.dataclass
class MemoryResult:
    traffic: TrafficResult  # processor -> cache (Fig. 9)
    cache_misses: int
    cache_accesses: int
    dram_bytes: float
    mat: float  # mean access time, cycles (Fig. 10)
    stall_cycles: float  # VPE-stall contribution (Fig. 11)


def directmapped_hits(stream: np.ndarray, n_sets: int) -> np.ndarray:
    """Vectorized direct-mapped simulation at row granularity.

    A row access hits iff the previous access to its set carried the same
    tag.  Implemented with a stable sort by (set, time).
    """
    if len(stream) == 0:
        return np.zeros(0, dtype=bool)
    n_sets = max(1, int(n_sets))
    sets = stream % n_sets
    order = np.argsort(sets, kind="stable")
    s_sorted = sets[order]
    v_sorted = stream[order]
    hit_sorted = np.zeros(len(stream), dtype=bool)
    same_set = s_sorted[1:] == s_sorted[:-1]
    hit_sorted[1:] = same_set & (v_sorted[1:] == v_sorted[:-1])
    hits = np.zeros(len(stream), dtype=bool)
    hits[order] = hit_sorted
    return hits


def dram_mat(
    miss_rows: np.ndarray, feature_bytes: int, dram: DramConfig
) -> tuple[float, float]:
    """(mean access time in cycles, total access count) for the DRAM-level
    stream of missed Z rows.  Each Z row spans ceil(feature_bytes/row_bytes)
    DRAM rows; sequential lines within an open row hit the row buffer."""
    if len(miss_rows) == 0:
        return dram.t_rb_hit, 0.0
    lines = max(1, feature_bytes // 64)
    rows_spanned = max(1, -(-feature_bytes // dram.row_bytes))
    # DRAM row id of the first line of each accessed Z row
    dram_rows = (miss_rows.astype(np.int64) * feature_bytes) // dram.row_bytes
    banks = dram_rows % dram.n_banks
    order = np.argsort(banks, kind="stable")
    b_s, r_s = banks[order], dram_rows[order]
    new_row = np.ones(len(miss_rows), dtype=bool)
    new_row[1:] = (b_s[1:] != b_s[:-1]) | (r_s[1:] != r_s[:-1])
    activations = float(new_row.sum()) * rows_spanned
    accesses = float(len(miss_rows)) * lines
    hits = max(0.0, accesses - activations)
    mat = (hits * dram.t_rb_hit + activations * dram.t_rb_miss) / max(accesses, 1.0)
    return mat, accesses


def finish_memory(
    traffic: TrafficResult, cfg: MachineConfig, dram: DramConfig
) -> MemoryResult:
    """Run the cache + DRAM levels on a dataflow's Z miss stream."""
    fb = max(4, traffic.feature_bytes)
    n_sets = cfg.cache_bytes // fb
    hits = directmapped_hits(traffic.z_row_stream, n_sets)
    n_acc = len(traffic.z_row_stream)
    n_miss = int((~hits).sum())
    miss_rows = traffic.z_row_stream[~hits]
    mat, dram_accesses = dram_mat(miss_rows, fb, dram)
    dram_bytes = float(n_miss) * fb + traffic.bytes_a + traffic.bytes_ps
    # VPE stalls: every shared-memory miss stalls its VPE (§V-E): cache
    # hits cost t_cache_hit, misses cost the measured MAT per line.
    lines = max(1, fb // 64)
    stall = (
        (n_acc - n_miss) * dram.t_cache_hit
        + n_miss * mat * lines
        + (traffic.bytes_a + traffic.bytes_ps) / 64.0 * dram.t_cache_hit
    ) / cfg.n_vpe
    return MemoryResult(
        traffic=traffic,
        cache_misses=n_miss,
        cache_accesses=n_acc,
        dram_bytes=dram_bytes,
        mat=mat,
        stall_cycles=stall,
    )
