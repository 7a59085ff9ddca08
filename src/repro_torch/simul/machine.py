"""The modelled machine's constants.

Port of ``MachineConfig`` from ``src/repro/simul/machine.py`` (the
cycle models beside it come with the simulator/tuner slice).  The
executor's byte model (``core.exec.placement_bytes``) reads the element
width and the DRAM rate from it; the tuner slice reads the rest.  The
values are the reference's, the paper's modelled vector processor: none
is a property of the H100.
"""
from __future__ import annotations

import dataclasses
import hashlib


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
