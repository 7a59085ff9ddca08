"""Slot-priced plan bytes: the part of the reference's cost model the
executor shares.

Port of ``plan_slot_bytes`` and ``plan_launched_slots`` from
``src/repro/tune/cost.py`` (``predict_cost`` comes with the tuner slice).
The executor's byte model prices the plan triple at launched capacity
slots through :func:`plan_slot_bytes`, as the tuner does.
"""
from __future__ import annotations

from repro_torch.simul.machine import MachineConfig


def plan_slot_bytes(n_slots: int, machine: MachineConfig | None = None) -> float:
    """Bytes of the plan triple at ``n_slots`` capacity slots: rows + cols +
    vals, one element each per slot, padding included."""
    if machine is None:
        machine = MachineConfig()
    return 3.0 * float(n_slots) * machine.bytes_per_elem


def plan_launched_slots(plan) -> int:
    """Launched capacity slots of a built plan (``SCVPlan`` or
    ``SCVBucketedPlan``), coverage dummies included: ``n_tiles x cap`` per
    segment, read from leaf shapes, so it never waits for the device."""
    segments = getattr(plan, "segments", (plan,))
    return int(sum(s.n_tiles * s.cap for s in segments))
