"""PyTorch/CUDA port of the SCV-GNN system (``src/repro/`` is the JAX
reference it is held against).

Module paths mirror ``src/repro/``, so each module's counterpart sits at
the same relative path.  The package imports ``torch`` and ``numpy`` only:
never ``jax``, and nothing of the ``repro`` package.  Every SCV aggregation
of a CUDA tensor runs the hand-written ``sm_90a`` kernel in
``kernels/scv_spmm/csrc/scv_spmm.cu``; a CPU tensor takes the kernel's
plain PyTorch version.
"""
