"""Simulator-pruned autotuner for SCV plan configuration (port of
``src/repro/tune``).

Public surface:

* :class:`TunedConfig` — frozen (T, C, ratio, ladder) record; the only
  sanctioned carrier of tile/cap/chunk values outside ``core/scv.py``.
* :class:`Autotuner` — two-stage search (the reference's analytic prune,
  then the kernel chain measured on the tuner's device) with an on-disk
  :class:`TuneStore` cache.
* ``histogram_signature`` / ``machine_fingerprint`` / ``cache_key`` — the
  regime-keyed cache scheme; the fingerprint names the torch device.
"""
from repro_torch.tune.autotuner import Autotuner, ScoredCandidate, TuneResult, spearman
from repro_torch.tune.config import TunedConfig
from repro_torch.tune.cost import (
    CostEstimate,
    plan_launched_slots,
    plan_slot_bytes,
    predict_cost,
)
from repro_torch.tune.signature import (
    cache_key,
    histogram_signature,
    machine_fingerprint,
    quantize_histogram,
)
from repro_torch.tune.store import TuneStore

__all__ = [
    "Autotuner",
    "CostEstimate",
    "ScoredCandidate",
    "TuneResult",
    "TuneStore",
    "TunedConfig",
    "cache_key",
    "histogram_signature",
    "machine_fingerprint",
    "plan_launched_slots",
    "plan_slot_bytes",
    "predict_cost",
    "quantize_histogram",
    "spearman",
]
