"""Compute-cycle model of the paper's queue-based vector processor (§IV/V).

Port of ``src/repro/simul/machine.py``: the modelled machine's constants
(:class:`MachineConfig`) and the vectorized event models that turn a
dataflow's entry order into VPE-cycles, with the reference's assumptions:

* one nonzero costs ``ceil(F / N_PE)`` VPE-cycles (a scalar x vector FMA
  over the feature row), so MACs = nnz * F for every sparse format (BCSR's
  dense blocks are the deliberate exception);
* CSR runs one output row at a time (``ceil(k / N_VPE)`` issue slots a
  row), CSC owns output row i on VPE ``i mod N_VPE``, SCV's arbiter
  assigns entries greedily and serializes only per output row, and MP
  adds one arbiter scan cycle per deferred entry per extra pass.

All models return VPE-cycles; idle = N_VPE * makespan - busy.  The
executor's byte model (``core.exec.placement_bytes``) reads the element
width and the DRAM rate from :class:`MachineConfig`, the tuner the rest.
The values are the reference's, the paper's modelled vector processor:
none is a property of the H100.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

HAZARD_WINDOW = 3  # cycles: 2-cycle write-to-read latency + issue (§IV-B)


@dataclasses.dataclass(frozen=True)
class MachineConfig:
    n_vpe: int = 8
    n_pe: int = 64
    queue_depth: int = 16
    mem_a_bytes: int = 64 * 1024  # adjacency partition of local memory
    mem_z_bytes: int = 64 * 1024  # combined-feature partition
    mem_ps_bytes: int = 256 * 1024  # partial-sum partition
    cache_bytes: int = 2 * 1024 * 1024
    cache_line: int = 64
    dram_gbps: float = 1.0  # paper: Ramulator HBM default, 1 Gb/s noted
    bytes_per_elem: int = 4

    @property
    def total_macs_per_cycle(self) -> int:
        return self.n_vpe * self.n_pe

    def fingerprint(self) -> str:
        """Stable short hash over every field: a tuned-config cache keyed on
        it goes stale when any constant changes.  Equal to the reference's
        for equal fields."""
        payload = ";".join(
            f"{f.name}={getattr(self, f.name)!r}" for f in dataclasses.fields(self)
        )
        return hashlib.blake2b(payload.encode(), digest_size=8).hexdigest()


@dataclasses.dataclass
class ComputeResult:
    cycles: float  # makespan in cycles
    busy: float  # sum of VPE busy cycles
    idle: float  # N_VPE * makespan - busy
    macs: float


def _entry_cost(f: int, cfg: MachineConfig) -> int:
    return -(-f // cfg.n_pe)


def compute_entry_stream(
    rows_in_order: np.ndarray, f: int, cfg: MachineConfig
) -> ComputeResult:
    """SCV (and CSB-like) greedy queue scheduling: near-ideal makespan;
    the only critical path is a single output row's serialized updates."""
    c = _entry_cost(f, cfg)
    nnz = len(rows_in_order)
    busy = float(nnz) * c
    ideal = busy / cfg.n_vpe
    deg_max = int(np.bincount(rows_in_order.astype(np.int64)).max()) if nnz else 0
    makespan = max(ideal, deg_max * c)
    return ComputeResult(
        cycles=makespan,
        busy=busy,
        idle=cfg.n_vpe * makespan - busy,
        macs=float(nnz) * f,
    )


def compute_csc_fixed_rows(
    rows_in_order: np.ndarray, f: int, cfg: MachineConfig
) -> ComputeResult:
    """CSC: output row i is owned by VPE (i % N_VPE) (§V-B fixed mapping):
    makespan = max ownership load (hub rows skew it)."""
    c = _entry_cost(f, cfg)
    nnz = len(rows_in_order)
    busy = float(nnz) * c
    loads = np.bincount(rows_in_order % cfg.n_vpe, minlength=cfg.n_vpe) * c
    makespan = max(busy / cfg.n_vpe, float(loads.max()))
    return ComputeResult(
        cycles=makespan,
        busy=busy,
        idle=cfg.n_vpe * makespan - busy,
        macs=float(nnz) * f,
    )


def compute_csr_row_barrier(
    row_nnz: np.ndarray, f: int, cfg: MachineConfig
) -> ComputeResult:
    """CSR: one output row at a time; a row with k nonzeros fills
    ceil(k / N_VPE) issue slots and the remaining VPE slots idle
    (§II-B.2 row-sequential dataflow + §V-B imbalance discussion)."""
    c = _entry_cost(f, cfg)
    active = row_nnz[row_nnz > 0].astype(np.int64)
    slots = -(-active // cfg.n_vpe)  # ceil
    makespan = float(slots.sum()) * c
    busy = float(active.sum()) * c
    return ComputeResult(
        cycles=makespan,
        busy=busy,
        idle=cfg.n_vpe * makespan - busy,
        macs=float(active.sum()) * f,
    )


def compute_bcsr_blocks(
    n_blocks: int, block: int, f: int, cfg: MachineConfig
) -> ComputeResult:
    """BCSR: dense B x B blocks — every stored zero is a real MAC."""
    c = _entry_cost(f, cfg)
    per_block = block * block * c  # dense MACs over the block
    busy = float(n_blocks) * per_block
    # blocks parallelize cleanly (regular): idle only from the tail
    makespan = -(-n_blocks // cfg.n_vpe) * per_block
    return ComputeResult(
        cycles=float(makespan),
        busy=busy,
        idle=cfg.n_vpe * makespan - busy,
        macs=float(n_blocks) * block * block * f,
    )


def compute_multipass(
    rows_in_order: np.ndarray,
    n_passes: int,
    nnz: int,
    f: int,
    cfg: MachineConfig,
) -> ComputeResult:
    """MP: CSC-like compute + one arbiter scan cycle per deferred entry per
    pass (the "increased computation workload" of §II-B.4)."""
    base = compute_entry_stream(rows_in_order, f, cfg)
    rescan = float(nnz) * max(0, n_passes - 1) / cfg.n_vpe
    return ComputeResult(
        cycles=base.cycles + rescan,
        busy=base.busy,
        idle=base.idle + rescan * cfg.n_vpe,
        macs=base.macs,
    )
