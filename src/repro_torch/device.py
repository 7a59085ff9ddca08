"""Device resolution shared by the port's entry points.

Entry points (``models.gnn.build_graph``, ``serve.graph_engine.
GraphServeEngine``, ``launch.graph_serve``) default to ``"cuda"`` and
raise when no GPU is present: a run that silently fell back to the CPU
would report CPU numbers under the GPU's name.  Callers that want the CPU
(the tests) ask for it with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no
    CUDA device is available, or a CUDA index past the cards present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type == "cuda" and dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {str(dev)!r} requested but only {torch.cuda.device_count()} "
            "CUDA device(s) are present"
        )
    return dev
