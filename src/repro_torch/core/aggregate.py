"""Aggregation (Eq. (3): H' = Â · Z).

Port of the plan path of ``src/repro/core/aggregate.py``:

* ``aggregate_scv_plan`` — the SCV kernel over an ``SCVPlan`` or
  ``SCVBucketedPlan`` (the CUDA kernel for CUDA tensors, its plain version
  for CPU tensors), differentiable in ``z`` and in the plan's values;
* ``aggregate_coo_segsum`` — row-major gather + ``index_add_`` over COO
  arrays, independent of the SCV layout: the tests' oracle.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.scv_spmm.ops import scv_spmm_plan


def aggregate_coo_segsum(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    z: torch.Tensor,
    n_rows: int,
) -> torch.Tensor:
    """Gather Z rows, weighted sum into output rows."""
    gathered = z[cols.long()] * vals[:, None].to(z.dtype)
    out = torch.zeros((n_rows, z.shape[1]), dtype=z.dtype, device=z.device)
    return out.index_add_(0, rows.long(), gathered)


def aggregate_scv_plan(p, z: torch.Tensor) -> torch.Tensor:
    """SCV aggregation over a plan; returns ``[p.shape[0], F]``.  Gradients
    reach ``z`` and the plan's values (GAT's re-weighted ones among them)
    through ``ops.scv_spmm_plan``'s autograd Function."""
    return scv_spmm_plan(p, z)[: p.shape[0]]
