"""Trip-count-aware HLO cost extraction.

A copy of ``src/repro/launch/hlocost.py`` (pure Python: it reads HLO text
and imports no JAX), kept name for name.  Nothing in the port produces HLO:
its dry run (``launch/dryrun.py``) counts an eager step on ``meta``
instead.  What this parser reads is HLO text that JAX compiled elsewhere,
as the port's tests feed it.

XLA's ``compiled.cost_analysis()`` counts a ``while`` body ONCE regardless
of its trip count (verified empirically — a 10-step scan reports the same
flops as a 1-step scan).  Every model here scans over layers, KV blocks,
SSD chunks and loss chunks, so we parse the post-optimization HLO
ourselves and multiply each computation's costs by the product of
enclosing loop trip counts (``backend_config={"known_trip_count":{"n":N}}``
on each while op, with a cond-constant fallback).

Extracted per device:
  * flops              — dot ops: 2 x prod(output) x contracted size
                         (+ convolutions, rare here); elementwise ignored
                         (sub-% for these models)
  * hbm_bytes          — Σ over non-fused top-level ops of (operand +
                         output buffer sizes): the post-fusion HLO's
                         memory-traffic model (each fusion reads operands
                         from HBM, writes its output)
  * collective_bytes   — per collective kind, output-shape bytes x trips
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
    "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "c64": 8, "c128": 16, "s4": 1, "u4": 1,
}

_SHAPE_RE = re.compile(r"\b([a-z]\d*[a-z0-9]*)\[([\d,]*)\]")
_OP_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.*?)\s*([\w\-]+)\((.*)$")
_CALLED_RE = re.compile(r"(?:calls|body|condition|to_apply)=%([\w.\-]+)")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_OPERAND_RE = re.compile(r"%([\w.\-]+)")

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _shape_dims(type_str: str):
    """First shape's dims in a type string."""
    m = _SHAPE_RE.search(type_str)
    if not m:
        return None
    return [int(d) for d in m.group(2).split(",") if d]


@dataclasses.dataclass
class Op:
    name: str
    kind: str
    out_type: str
    rest: str  # operand list + attrs
    line: str


def parse_computations(hlo: str) -> dict[str, list[Op]]:
    comps: dict[str, list[Op]] = {}
    cur = None
    for line in hlo.splitlines():
        ls = line.rstrip()
        header = re.match(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->.*\{", ls.strip())
        if header and (ls.strip().endswith("{")):
            cur = header.group(1)
            comps[cur] = []
            if ls.strip().startswith("ENTRY"):
                comps["__entry__"] = comps[cur]
            continue
        if cur is None:
            continue
        if ls.strip() == "}":
            cur = None
            continue
        m = _OP_RE.match(ls)
        if m:
            comps[cur].append(Op(m.group(1), m.group(3), m.group(2), m.group(4), ls))
    return comps


@dataclasses.dataclass
class CostTotals:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: dict = None
    collective_counts: dict = None

    def __post_init__(self):
        if self.collective_bytes is None:
            self.collective_bytes = dict.fromkeys(COLLECTIVES, 0.0)
        if self.collective_counts is None:
            self.collective_counts = dict.fromkeys(COLLECTIVES, 0.0)


# ops whose operands/outputs are views, not HBM traffic
_VIEW_OPS = {
    "parameter", "tuple", "get-tuple-element", "bitcast", "constant",
    "after-all", "iota", "partition-id", "replica-id",
}


def analyze(hlo: str) -> CostTotals:
    comps = parse_computations(hlo)
    # shape table: op name -> output type string (names unique post-opt)
    shapes: dict[str, str] = {}
    for ops in comps.values():
        for op in ops:
            shapes[op.name] = op.out_type
    # parameters: "%p = f32[..] parameter(0)" are ops too (covered above)

    trip_cache: dict[str, int] = {}

    def trip_count(op: Op) -> int:
        m = _TRIP_RE.search(op.line)
        if m:
            return int(m.group(1))
        # fallback: largest s32 constant in the condition computation
        mc = re.search(r"condition=%([\w.\-]+)", op.line)
        if mc and mc.group(1) in comps:
            best = 1
            for o in comps[mc.group(1)]:
                for c in re.findall(r"constant\((\d+)\)", o.line):
                    best = max(best, int(c))
            return best
        return 1

    # which computations are fusion bodies (their ops are not HBM traffic)
    fusion_bodies = set()
    for ops in comps.values():
        for op in ops:
            if op.kind == "fusion":
                for called in _CALLED_RE.findall(op.line):
                    fusion_bodies.add(called)

    totals = CostTotals()
    visited_stack = []

    def dot_flops(op: Op) -> float:
        out_dims = _shape_dims(op.out_type) or []
        out_n = 1
        for d in out_dims:
            out_n *= d
        lhs = _OPERAND_RE.search(op.rest)
        mcd = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", op.line)
        k = 1
        if lhs and mcd and lhs.group(1) in shapes:
            ldims = _shape_dims(shapes[lhs.group(1)]) or []
            for idx in mcd.group(1).split(","):
                if idx and int(idx) < len(ldims):
                    k *= ldims[int(idx)]
        return 2.0 * out_n * k

    def conv_flops(op: Op) -> float:
        # approximate: 2 x prod(output) x (kernel spatial x in_channels)
        out_dims = _shape_dims(op.out_type) or []
        out_n = 1
        for d in out_dims:
            out_n *= d
        ops_names = _OPERAND_RE.findall(op.rest)
        k = 1
        if len(ops_names) >= 2 and ops_names[1] in shapes:
            kd = _shape_dims(shapes[ops_names[1]]) or []
            for d in kd[:-1]:  # all but output-feature dim (layout-dependent approx)
                k *= d
        return 2.0 * out_n * k

    def _fusion_param_read_bytes(body: str, param_idx: int, full: int) -> int:
        """If fusion body only dynamic-slices from parameter i, the real
        read is the slice, not the whole buffer (scan weight slicing)."""
        if body not in comps:
            return full
        pname = None
        for o in comps[body]:
            if o.kind == "parameter" and o.rest.startswith(f"{param_idx})"):
                pname = o.name
        if pname is None:
            return full
        sliced = None
        dus_update = None
        for o in comps[body]:
            if f"%{pname}" in o.rest or f"%{pname}," in o.rest:
                if o.kind == "dynamic-slice":
                    sliced = _shape_bytes(o.out_type)
                elif o.kind == "dynamic-update-slice":
                    # in-place update: only the update slice is touched
                    names = _OPERAND_RE.findall(o.rest.split("),")[0])
                    if len(names) >= 2 and names[1] in shapes:
                        dus_update = _shape_bytes(shapes[names[1]])
                else:
                    return full  # some use reads the whole buffer
        if sliced is not None:
            return sliced
        if dus_update is not None:
            return dus_update
        return full

    def _fusion_out_bytes(op: Op) -> int:
        """If the fusion root is a dynamic-update-slice, only the update
        slice is written (in-place update of the big buffer)."""
        full = _shape_bytes(op.out_type)
        for body in _CALLED_RE.findall(op.line):
            if body not in comps or not comps[body]:
                continue
            root = comps[body][-1]
            if root.kind == "dynamic-update-slice":
                names = _OPERAND_RE.findall(root.rest.split("),")[0])
                if len(names) >= 2 and names[1] in shapes:
                    return _shape_bytes(shapes[names[1]])
        return full

    def op_hbm_bytes(op: Op) -> float:
        if op.kind in _VIEW_OPS:
            return 0.0
        if op.kind == "dynamic-slice":
            return 2.0 * _shape_bytes(op.out_type)
        bodies = _CALLED_RE.findall(op.line) if op.kind == "fusion" else []
        total = _fusion_out_bytes(op) if op.kind == "fusion" else _shape_bytes(op.out_type)
        arglist = op.rest.split("),")[0]
        for i, name in enumerate(_OPERAND_RE.findall(arglist)):
            if name not in shapes:
                continue
            full = _shape_bytes(shapes[name])
            if bodies:
                full = _fusion_param_read_bytes(bodies[0], i, full)
            total += full
        return total

    def walk(comp_name: str, mult: float, in_fusion: bool):
        if comp_name not in comps:
            return
        key = (comp_name, in_fusion)
        if key in visited_stack:  # defensive: no recursion in HLO, but be safe
            return
        visited_stack.append(key)
        for op in comps[comp_name]:
            kind = op.kind
            if kind == "dot":
                totals.flops += mult * dot_flops(op)
            elif kind == "convolution":
                totals.flops += mult * conv_flops(op)
            base = kind.replace("-start", "")
            if base in COLLECTIVES and not kind.endswith("-done"):
                nbytes = _shape_bytes(op.out_type)
                totals.collective_bytes[base] += mult * nbytes
                totals.collective_counts[base] += mult
            if not in_fusion and kind not in ("while", "conditional", "call"):
                totals.hbm_bytes += mult * op_hbm_bytes(op)
            if kind == "while":
                t = trip_count(op)
                for called in _CALLED_RE.findall(op.line):
                    walk(called, mult * t, in_fusion)
                # while's own tuple shuffling is cheap; skip op bytes
            elif kind == "fusion":
                for called in _CALLED_RE.findall(op.line):
                    walk(called, mult, True)
            elif kind in ("call", "conditional", "custom-call", "map", "reduce",
                          "sort", "scatter", "select-and-scatter", "reduce-window"):
                for called in _CALLED_RE.findall(op.line):
                    walk(called, mult, True if kind != "call" else in_fusion)
        visited_stack.pop()

    walk("__entry__", 1.0, False)
    return totals
