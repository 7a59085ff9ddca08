"""Trace-hazard analysis of the captured forward.

Port of ``src/repro/core/tracecheck.py`` onto
``models.gnn.CapturedForward``, the port's counterpart of one
``jax.jit`` per padding bucket: the serving forward is captured in a CUDA
graph at most once per bucket, and that discipline decays silently (an
unhashable or array-valued static field, a float64 tensor leaking in, an
index leaf of another width) with no test failing until someone counts.

* :func:`check_static_aux` — walk graphs, composites and plans (anything
  with a ``tree_flatten``), flag static fields that are unhashable or hold
  a tensor or array.
* :func:`check_leaf_dtypes` — flag float64 leaves and integer (index)
  leaves that are not int32.
* :func:`eval_shape_hazards` — run a forward once, eagerly, on its inputs'
  device (torch has no abstract evaluation), and flag outputs that are
  not float32, or a raise.
* :class:`CaptureCounter` and :func:`bucket_signature` — the captured
  forward and its key; :func:`trace_check` drives one over example graphs
  per model and reports any signature captured more than
  ``max_retraces_per_bucket`` times.

The hazard kinds are the reference's strings, so two reports compare kind
for kind; ``index-dtype`` is the port's own (with jax's x64 off every
index leaf is int32 there), and ``weak-type`` never fires, because torch
has no weak types.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.models.gnn import CapturedForward, forward_key


# ---------------------------------------------------------------------------
# report types
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TraceHazard:
    kind: str  # "unhashable-aux" | "array-aux" | "float64-leak" | "index-dtype"
    #           | "weak-type" | "bad-output-dtype" | "retrace-bound"
    #           | "trace-error"
    where: str  # tree path / model name / bucket signature
    detail: str


@dataclasses.dataclass(frozen=True)
class TraceReport:
    """Outcome of :func:`trace_check` (or the standalone checkers)."""

    hazards: tuple[TraceHazard, ...]
    #: ((model, bucket_signature), captures) — one entry per distinct
    #: signature exercised.
    retraces: tuple[tuple[tuple[str, str], int], ...] = ()

    @property
    def ok(self) -> bool:
        return not self.hazards

    def of_kind(self, kind: str) -> tuple[TraceHazard, ...]:
        return tuple(h for h in self.hazards if h.kind == kind)

    def summary(self) -> str:
        lines = []
        if self.retraces:
            worst = max(n for _, n in self.retraces)
            lines.append(
                f"{len(self.retraces)} trace bucket(s), worst {worst} trace(s)"
            )
        if not self.hazards:
            lines.append("no trace hazards")
        for h in self.hazards:
            lines.append(f"  {h.kind} @ {h.where}: {h.detail}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# static aux / leaf hazards
# ---------------------------------------------------------------------------
def _is_arraylike(x: Any) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def check_static_aux(tree: Any, where: str = "plan") -> list[TraceHazard]:
    """Flag static fields a capture key cannot hold.

    Recurses through containers and through every object with a
    ``tree_flatten`` (graphs, composites, plans).  A static field that
    fails ``hash()`` cannot key a capture; one that holds a tensor or an
    array would key it on the object's identity, so every freshly built
    plan would be captured again.
    """
    out: list[TraceHazard] = []

    def scan_aux(a: Any, path: str) -> None:
        if _is_arraylike(a):
            out.append(TraceHazard(
                "array-aux", path,
                "tensor or array in a static field: a key holding it is the "
                "object's identity, so equal plans are captured again at every build",
            ))
        elif isinstance(a, (list, tuple)):
            for i, c in enumerate(a):
                scan_aux(c, f"{path}[{i}]")
        elif isinstance(a, dict):
            for k, c in a.items():
                scan_aux(c, f"{path}[{k!r}]")

    def walk(obj: Any, path: str) -> None:
        if _is_arraylike(obj) or obj is None:
            return
        if isinstance(obj, (list, tuple)):
            for i, c in enumerate(obj):
                walk(c, f"{path}[{i}]")
        elif isinstance(obj, dict):
            for k, c in obj.items():
                walk(c, f"{path}[{k!r}]")
        elif hasattr(obj, "tree_flatten"):
            children, aux = obj.tree_flatten()
            name = type(obj).__name__
            try:
                hash(aux)
            except TypeError as e:
                out.append(TraceHazard(
                    "unhashable-aux", f"{path}:{name}",
                    f"static fields are unhashable ({e}); no capture key can hold them",
                ))
            scan_aux(aux, f"{path}:{name}.aux")
            walk(children, path)
        # anything else is a plain static value (int, string, decision, ...)

    walk(tree, where)
    return out


def _leaves(tree: Any) -> list:
    """Tensor and array leaves, in walk order."""
    out: list = []

    def walk(obj: Any) -> None:
        if _is_arraylike(obj):
            out.append(obj)
        elif isinstance(obj, (list, tuple)):
            for c in obj:
                walk(c)
        elif isinstance(obj, dict):
            for c in obj.values():
                walk(c)
        elif hasattr(obj, "tree_flatten"):
            walk(obj.tree_flatten()[0])

    walk(tree)
    return out


def check_leaf_dtypes(tree: Any, where: str = "plan") -> list[TraceHazard]:
    """Flag float64 leaves, and integer (index) leaves that are not int32."""
    out: list[TraceHazard] = []
    for i, leaf in enumerate(_leaves(tree)):
        dt = leaf.dtype
        if dt in (torch.float64, np.float64):
            out.append(TraceHazard(
                "float64-leak", f"{where}:leaf[{i}]",
                "float64 leaf (a host array skipped the f32 conversion and "
                "will promote everything it touches)",
            ))
        is_int = (not dt.is_floating_point and not dt.is_complex and dt != torch.bool
                  if isinstance(dt, torch.dtype) else np.issubdtype(dt, np.integer))
        if is_int and dt not in (torch.int32, np.int32):
            out.append(TraceHazard(
                "index-dtype", f"{where}:leaf[{i}]",
                f"index leaf of dtype {dt}: the kernels read int32 and refuse it",
            ))
    return out


def eval_shape_hazards(
    fn: Callable, *args, where: str = "forward", **kwargs
) -> list[TraceHazard]:
    """Run ``fn(*args)`` once, eagerly, without autograd, on its inputs'
    device, and flag outputs that are float64 or not float32.  A raise is
    itself reported: a forward that cannot run is the worst hazard."""
    try:
        with torch.inference_mode():
            outs = fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 — any failure is the finding
        return [TraceHazard("trace-error", where, f"{type(e).__name__}: {e}")]
    out: list[TraceHazard] = []
    for i, s in enumerate(_leaves(outs)):
        if s.dtype in (torch.float64, np.float64):
            out.append(TraceHazard("float64-leak", f"{where}:out[{i}]",
                                   "forward output is float64"))
        if s.dtype not in (torch.float32, np.float32):
            out.append(TraceHazard("bad-output-dtype", f"{where}:out[{i}]",
                                   f"forward output dtype {s.dtype} is not float32"))
    return out


# ---------------------------------------------------------------------------
# capture counting
# ---------------------------------------------------------------------------
class CaptureCounter(CapturedForward):
    """A captured forward whose ``traces`` counts its captures: the number
    of CUDA graphs it minted (on the CPU, of keys), the quantity the
    padding buckets bound.  The counterpart of ``RetraceCounter``."""

    @property
    def traces(self) -> int:
        return self.captures


def bucket_signature(*trees: Any) -> str:
    """The expected capture key of a call: ``models.gnn.forward_key``, the
    key the captured forward files its captures under.  Two calls with
    equal signatures must share one capture."""
    return forward_key(*trees)


def trace_check(
    models: dict[str, tuple],
    examples: dict[str, list],
    forward: Optional[Callable] = None,
    max_retraces_per_bucket: int = 1,
) -> TraceReport:
    """Run the full trace-hazard analysis over example workloads.

    ``models`` maps a name to ``(params, cfg)`` (the serving engine's
    registry shape); ``examples`` maps the same names to a list of
    ``(graph, x)`` pairs.  ``forward`` defaults to ``models.gnn.gnn_forward``.

    For each model: static-field and leaf-dtype hazards on every example,
    one eager run of the first, then a :class:`CaptureCounter` over
    ``forward`` driven over all examples, calls grouped by
    :func:`bucket_signature`.  A signature captured more than
    ``max_retraces_per_bucket`` times is a ``retrace-bound`` hazard.
    """
    if forward is None:
        from repro_torch.models.gnn import gnn_forward as forward

    hazards: list[TraceHazard] = []
    retraces: list[tuple[tuple[str, str], int]] = []
    for name, (params, cfg) in models.items():
        exs = examples.get(name, [])
        if not exs:
            continue
        for i, (g, x) in enumerate(exs):
            hazards += check_static_aux(g, where=f"{name}[{i}]")
            hazards += check_leaf_dtypes((g, x), where=f"{name}[{i}]")
        g0, x0 = exs[0]
        hazards += eval_shape_hazards(
            lambda p, g_, x_: forward(p, cfg, g_, x_),
            params, g0, x0, where=f"{name}:eval_shape",
        )
        counter = CaptureCounter(forward)
        per_bucket: dict[str, int] = {}
        for i, (g, x) in enumerate(exs):
            sig = bucket_signature(g, x)
            before = counter.traces
            try:
                counter(params, cfg, g, x)
            except Exception as e:  # noqa: BLE001 — a failed capture is the finding
                hazards.append(
                    TraceHazard("trace-error", f"{name}[{i}]", f"{type(e).__name__}: {e}")
                )
                continue
            per_bucket[sig] = per_bucket.get(sig, 0) + (counter.traces - before)
        for sig, n in per_bucket.items():
            retraces.append(((name, sig), n))
            if n > max_retraces_per_bucket:
                hazards.append(TraceHazard(
                    "retrace-bound", f"{name}:{sig[:80]}...",
                    f"{n} captures for one padding bucket (bound is "
                    f"{max_retraces_per_bucket}): equal signatures are not sharing one",
                ))
    return TraceReport(hazards=tuple(hazards), retraces=tuple(retraces))
