"""Device resolution shared by the port's entry points.

Entry points (``models.gnn.build_graph``, ``serve.graph_engine.
GraphServeEngine``, ``launch.graph_serve``) default to ``"cuda"`` and
raise when no GPU is present: a run that silently fell back to the CPU
would report CPU numbers under the GPU's name.  Callers that want the CPU
(the tests) ask for it with ``device="cpu"``.
"""
from __future__ import annotations

import gc

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


def capture_graph(graph: torch.cuda.CUDAGraph, stream: torch.cuda.Stream, fn):
    """Capture ``fn()`` into ``graph`` on ``stream``; returns what ``fn``
    returns (the graph's static outputs).

    ``capture_begin``/``capture_end``, not ``torch.cuda.graph``: that
    context also synchronises the device, collects garbage and empties the
    allocator's cache first, which a capture on a stream of its own does
    not need (on the H100 it made each capture several times slower).  Nor
    may the garbage collector run inside it: captures and the objects that
    own them can refer to each other, so only a collection frees some CUDA
    graphs, and freeing one while this capture is underway invalidates it.
    A step that cannot be captured (a host sync inside it) raises here.
    """
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                return fn()
            finally:
                graph.capture_end()
    finally:
        if collecting:
            gc.enable()
