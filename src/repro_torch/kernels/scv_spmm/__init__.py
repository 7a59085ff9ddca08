"""SCV SpMM: the CUDA kernel (csrc/), its launch wrapper, plain version and
plan-level entry points.

Exports what the reference's package does.  ``scv_spmm`` here is the op
(``ops.scv_spmm``), as in the reference, so the package attribute hides the
launch-wrapper submodule of the same name: reach that one by its full name,
``importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")``."""
from repro_torch.kernels.scv_spmm.ops import ensure_row_coverage, scv_spmm
from repro_torch.kernels.scv_spmm.ref import scv_spmm_reference

__all__ = ["scv_spmm", "scv_spmm_reference", "ensure_row_coverage"]
