"""stream/: delta plan maintenance for dynamic graphs.

Port of ``src/repro/stream/``.  :class:`DeltaBatch` + :func:`apply_delta`
patch SCV plans incrementally (Z-Morton tile splice, ladder-crossing
re-bucket only, a fresh run index for every patched segment) instead of
re-running the O(nnz) ``coo_to_scv_tiles`` build;
``serve.plan_cache.PlanCache.revalidate`` and
``serve.graph_engine.GraphServeEngine.update`` ride on it.
"""
from repro_torch.stream.delta import (
    DeltaBatch,
    apply_coo,
    apply_delta,
    check_delta,
)

__all__ = [
    "DeltaBatch",
    "apply_coo",
    "apply_delta",
    "check_delta",
]
