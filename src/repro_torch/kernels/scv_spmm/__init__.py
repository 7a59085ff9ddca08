"""SCV SpMM: the CUDA kernel (csrc/), its launch wrapper, plain version and
plan-level entry points."""
