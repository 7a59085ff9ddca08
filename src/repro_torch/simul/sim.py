"""Top-level simulation API (paper §V-A methodology).

Port of ``src/repro/simul/sim.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

from repro_torch.core.formats import COOMatrix
from repro_torch.simul import dataflows
from repro_torch.simul.machine import ComputeResult, MachineConfig
from repro_torch.simul.memory import DramConfig, MemoryResult, finish_memory


@dataclasses.dataclass
class SimResult:
    fmt: str
    compute: ComputeResult
    memory: MemoryResult

    @property
    def compute_cycles(self) -> float:  # Fig. 7 metric
        return self.compute.cycles

    @property
    def idle_cycles(self) -> float:  # Fig. 8 metric
        return self.compute.idle

    @property
    def traffic_bytes(self) -> float:  # Fig. 9 metric
        return self.memory.traffic.total_bytes

    @property
    def mat(self) -> float:  # Fig. 10 metric
        return self.memory.mat

    @property
    def total_cycles(self) -> float:  # Fig. 11 metric
        return self.compute.cycles + self.memory.stall_cycles


def simulate(
    adj: COOMatrix,
    f: int,
    fmt: str,
    cfg: MachineConfig | None = None,
    dram: DramConfig | None = None,
    **kw: Any,
) -> SimResult:
    cfg = cfg or MachineConfig()
    dram = dram or DramConfig()
    comp, traffic = dataflows.RUNNERS[fmt](adj, f, cfg, **kw)
    mem = finish_memory(traffic, cfg, dram)
    return SimResult(fmt, comp, mem)


def geomean(xs) -> float:
    xs = [x for x in xs if x > 0 and math.isfinite(x)]
    return float(np.exp(np.mean(np.log(xs)))) if xs else float("nan")
