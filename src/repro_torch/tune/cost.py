"""Stage-1 analytic cost model: simulator cycles + slot-priced traffic.

Port of ``src/repro/tune/cost.py`` (host numpy, the same numbers).  One
byte model for two callers: :func:`plan_slot_bytes` prices the plan
triple (rows/cols/vals) at *launched* capacity slots — the number
:func:`core.scv.launched_slots` computes from a histogram — for the
tuner and for ``core.exec.placement_bytes`` alike.  :func:`predict_cost`
is what stage 1 of the tuner ranks candidates by:
``simul.dataflows.run_scv_bucketed`` compute cycles plus DRAM-bandwidth
time over the slot-priced traffic, plus a per-launch charge (one kernel
launch per ladder segment).  Every constant here belongs to the
reference's model of the paper's machine, not to the H100: stage 1
scores as the reference scores, and stage 2 measures the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.formats import COOMatrix
from repro_torch.core.scv import launched_slots, tile_nnz_histogram
from repro_torch.simul.dataflows import E, run_scv_bucketed
from repro_torch.simul.machine import MachineConfig
from repro_torch.tune.config import TunedConfig

#: Modeled clock of the simulated vector processor (paper §V: 1 GHz-class).
CLOCK_HZ = 1e9
#: Per-kernel-launch overhead charged per ladder segment: the reference's
#: fraction, fitted to its own serving A/B (2-deep against 3-deep ladders),
#: not a hardware constant.
LAUNCH_OVERHEAD_S = 2e-3


def plan_slot_bytes(n_slots: int, machine: MachineConfig | None = None) -> float:
    """Bytes of the plan triple at ``n_slots`` capacity slots: rows + cols +
    vals, one element each per slot, padding included."""
    if machine is None:
        machine = MachineConfig()
    return 3.0 * float(n_slots) * machine.bytes_per_elem


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Stage-1 prediction for one candidate config on one graph."""

    seconds: float  # the ranking key
    compute_s: float
    traffic_s: float
    launch_s: float
    cycles: float
    traffic_bytes: float
    n_slots: int
    n_launches: int

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def predict_cost(
    adj: COOMatrix,
    config: TunedConfig,
    n_features: int,
    machine: MachineConfig | None = None,
    compute=None,
) -> CostEstimate:
    """Analytic seconds for aggregating ``adj`` under ``config``.

    ``compute`` optionally injects a precomputed ``run_scv_bucketed``
    result for this (graph, tile): cycles depend only on the tile, so the
    tuner shares one simulator run across every candidate at that tile.
    """
    if machine is None:
        machine = MachineConfig()
    caps = tuple(config.bucket_caps) or (int(config.cap),)
    if compute is None:
        comp, traffic, slots = run_scv_bucketed(
            adj, n_features, machine, config.tile, caps=caps
        )
        traffic_bytes = float(traffic.total_bytes)
    else:
        # cycles and Z/PS traffic depend only on the tile; re-price the
        # plan triple (bytes_a) at this candidate's ladder
        comp, traffic, _ = compute
        slots = launched_slots(
            tile_nnz_histogram(adj, config.tile),
            config.tile,
            caps,
            n_row_blocks=-(-adj.shape[0] // config.tile),
        )
        f_pass = int(np.clip(
            machine.mem_ps_bytes // (E * config.tile), 8, n_features
        ))
        passes = -(-n_features // f_pass)
        bytes_a = plan_slot_bytes(slots, machine) * passes
        traffic_bytes = bytes_a + float(traffic.bytes_z) + float(traffic.bytes_ps)
    traffic_s = traffic_bytes * 8.0 / (machine.dram_gbps * 1e9)
    compute_s = float(comp.cycles) / CLOCK_HZ
    n_launches = len(caps)
    launch_s = n_launches * LAUNCH_OVERHEAD_S
    return CostEstimate(
        seconds=compute_s + traffic_s + launch_s,
        compute_s=compute_s,
        traffic_s=traffic_s,
        launch_s=launch_s,
        cycles=float(comp.cycles),
        traffic_bytes=traffic_bytes,
        n_slots=int(slots),
        n_launches=n_launches,
    )


def plan_launched_slots(plan) -> int:
    """Launched capacity slots of a built plan (``SCVPlan`` or
    ``SCVBucketedPlan``), coverage dummies included: ``n_tiles x cap`` per
    segment, read from leaf shapes, so it never waits for the device."""
    segments = getattr(plan, "segments", (plan,))
    return int(sum(s.n_tiles * s.cap for s in segments))
