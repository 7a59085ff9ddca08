"""Fault-tolerance runtime pieces: heartbeats, straggler detection,
elastic re-meshing, deterministic restart.

Port of ``src/repro/train/fault.py``: host logic, unchanged.

* ``Heartbeat`` — per-worker liveness with a wall-clock deadline; the
  launcher marks a worker dead after ``timeout_s``.
* ``StragglerDetector`` — per-step-time EWMA + z-score; a worker whose
  step time exceeds mean + k*std for ``patience`` consecutive steps is
  flagged so the launcher can demote or replace it.
* ``elastic_mesh_shapes`` — given the surviving chip count, the largest
  (data, model) shape that keeps the model axis whole; train state is
  reloaded from the latest checkpoint (``checkpoint.py``).
* ``DataSkipper`` — deterministic batch skipping, so a restarted run sees
  exactly the batches it would have (same seed, skip to step).
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict


@dataclasses.dataclass
class Heartbeat:
    timeout_s: float = 60.0
    _last: dict = dataclasses.field(default_factory=dict)

    def beat(self, worker: int, now: float | None = None):
        self._last[worker] = time.monotonic() if now is None else now

    def dead_workers(self, known: list[int], now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return [
            w
            for w in known
            if now - self._last.get(w, -1e18) > self.timeout_s
        ]


@dataclasses.dataclass
class StragglerDetector:
    k_sigma: float = 3.0
    patience: int = 3
    decay: float = 0.9
    _mean: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    _var: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    _strikes: dict = dataclasses.field(default_factory=lambda: defaultdict(int))
    _seen: dict = dataclasses.field(default_factory=lambda: defaultdict(int))

    def observe(self, worker: int, step_time: float) -> bool:
        """Returns True when the worker is flagged as a straggler."""
        m, v = self._mean[worker], self._var[worker]
        self._seen[worker] += 1
        if self._seen[worker] < 3:  # warm-up
            self._mean[worker] = step_time if m == 0 else 0.5 * (m + step_time)
            return False
        sigma = max(v**0.5, 1e-6, 0.05 * m)
        if step_time > m + self.k_sigma * sigma:
            self._strikes[worker] += 1
        else:
            self._strikes[worker] = 0
            self._mean[worker] = self.decay * m + (1 - self.decay) * step_time
            self._var[worker] = self.decay * v + (1 - self.decay) * (step_time - m) ** 2
        return self._strikes[worker] >= self.patience


def elastic_mesh_shapes(n_chips: int, model_parallel: int = 16) -> tuple[int, int]:
    """Largest (data, model) shape with the model axis preserved.  Chips
    not forming a full data replica are parked (elastic scale-down).
    Scale-up is the same function with a larger n_chips."""
    data = max(1, n_chips // model_parallel)
    return data, model_parallel


@dataclasses.dataclass
class DataSkipper:
    """Deterministic resume: data order is a pure function of (seed, step),
    so skipping to `start_step` replays nothing and loses nothing."""

    seed: int
    batch_ids_seen: int = 0

    def skip_to(self, step: int, batches_per_step: int = 1):
        self.batch_ids_seen = step * batches_per_step

    def next_batch_id(self) -> int:
        i = self.batch_ids_seen
        self.batch_ids_seen += 1
        return i
