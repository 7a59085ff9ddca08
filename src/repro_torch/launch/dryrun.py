"""Dry run: every (arch x shape) cell laid over a production mesh, its
bytes per device counted from the shard shapes, and one step's FLOPs
counted on ``meta``.  Port of ``src/repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-780m \\
        --shape decode_32k [--multi-pod] [--out results.json] [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The reference lowers and compiles each cell for 256 or 512 forced host
devices and reads the compiled HLO.  The port makes no HLO, and its loops
run in Python, so no trip count hides.  :func:`dryrun_cell` instead

* builds the cell on ``meta`` (no memory): the params from
  ``spec.init(None, device="meta")`` (bf16 with a float32 master for a
  ``master_weights`` train cell) and ``abstract_opt_state`` for a train
  cell, ``input_specs`` for the batch, ``state_specs`` for a decode cell;
* resolves every tree's shardings on the 16x16 (or 2x16x16) mesh laid over
  the pool of ``--device`` (``train/sharding.py``'s rules, as the
  reference's), and counts each position's argument and output bytes
  from the shard shapes (every position holds blocks of one shape);
* runs the step once on ``meta`` under
  ``torch.utils.flop_counter.FlopCounterMode``: dots, matmuls and
  convolutions, forward, backward and remat's recompute for a train cell
  (``flops_total``), while :class:`LiveBytes` follows every tensor the run
  allocates and frees, giving the peak a one-device eager run holds
  (``whole_cell["peak_bytes"]``); ``fits_one_card`` compares it with one
  H100's 80 GB;
* with ``--device cuda``, runs the cells that fit once more on the card
  (:func:`run_cell`): ``max_memory_allocated`` and the step's ms by CUDA
  events.

``flops_per_device`` is what position (0, 0) runs (:func:`position_count`):
for a train cell, data group 0's forward and backward split over its
"model" positions as the SPMD step splits them (``train/tp.py``), run on
``meta``, the FLOPs of position 0's share and of what the group computes
whole; a prefill or decode step runs whole on one device.  A train cell's
``collective_bytes_per_device`` and ``collective_counts`` are those of the
port's SPMD step (``configs/common.py::spmd_step``), counted from the
shard shapes (:func:`spmd_collectives`): its param gathers, its gradient
reduce-scatter, and the tensor-parallel collectives of its products that
the same run on ``meta`` records.

Keys the port cannot know are ``null``, never 0: ``lower_s`` and
``compile_s`` (nothing is lowered or compiled), ``bytes_per_device`` and
``xla_*_uncorrected`` (the compiled HLO's traffic and cost model), the
collectives of a prefill or decode cell (the port runs those steps on one
device, with no collective), ``memory["temp_bytes"]`` and
``memory["alias_bytes"]`` (the compiler's buffer assignment and donation),
and ``memory["output_bytes"]`` of a prefill cell (its output shardings are
the compiler's choice).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import time
import weakref

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs import ARCHS
from repro_torch.configs.common import SHAPES, abstract_opt_state, bf16_params
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import device_pool, make_production_mesh
from repro_torch.models import layers as L
from repro_torch.train import sharding as shd
from repro_torch.train import tp
from repro_torch.tree import leaves, tree_map

CARD_BYTES = 80e9  # one H100's device memory

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
    "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
    "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"(f64|f32|bf16|f16|s64|u64|s32|u32|s16|u16|s8|u8|pred|f8e4m3fn|f8e5m2)\[([\d,]*)\]")


def collective_bytes(hlo_text: str) -> dict:
    """Sum output-shape bytes of each collective op (per device)."""
    out = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
           "all-to-all": 0, "collective-permute": 0}
    counts = dict.fromkeys(out, 0)
    for line in hlo_text.splitlines():
        m = re.search(r"=\s*(.*?)\s*(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)(-start|-done)?\(", line)
        if not m or (m.group(3) == "-done"):
            continue
        kind = m.group(2)
        shapes = _SHAPE_RE.findall(m.group(1))
        nbytes = 0
        for dt, dims in shapes:
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * _DTYPE_BYTES[dt]
        out[kind] += nbytes
        counts[kind] += 1
    out["counts"] = counts
    return out


def _spec_tree_to_shardings(mesh, shapes, axes_tree, rules):
    return tree_map(
        lambda x, ax: shd.NamedSharding(mesh, shd._resolve(x.shape, ax, rules, mesh)),
        shapes,
        axes_tree,
    )


def _batch_shardings(mesh, batch):
    def one(x):
        # shard the leading (batch) dim over as many data-like axes as the
        # size divides (long_500k has global_batch=1 -> fully replicated)
        assign, size = [], 1
        for a in ("pod", "data"):
            if a in mesh.shape and x.shape[0] % (size * mesh.shape[a]) == 0:
                assign.append(a)
                size *= mesh.shape[a]
        ax = tuple(assign) if len(assign) != 1 else assign[0]
        spec = shd.P(*((ax if assign else None,) + (None,) * (len(x.shape) - 1)))
        return shd.NamedSharding(mesh, spec)

    return tree_map(one, batch)


class LiveBytes(TorchDispatchMode):
    """The bytes of tensor storage alive while a run goes on, and their
    peak: ``base`` (the arguments) plus every storage an op creates, until
    it is freed.  On ``meta`` this is what the same eager run would hold on
    a device (no allocator rounding, caching or library workspaces)."""

    def __init__(self, args):
        super().__init__()
        self._args = [t.untyped_storage() for t in leaves(args)]  # alive throughout
        self._tracked = {id(s) for s in self._args}
        self.live = self.peak = sum(s.nbytes() for s in {id(s): s for s in self._args}.values())

    def _free(self, key, nbytes):
        self._tracked.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if id(st) not in self._tracked:
                    self._tracked.add(id(st))
                    self.live += st.nbytes()
                    weakref.finalize(st, self._free, id(st), st.nbytes())
        self.peak = max(self.peak, self.live)
        return out


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def cell_trees(spec, shape_name, reduced=False) -> dict:
    """The cell's step arguments on ``meta``: ``params``, their logical
    axes, ``batch``, and ``opt`` (train) or ``state`` with its axes
    (decode)."""
    shape = SHAPES[shape_name]
    params, axes = spec.init(None, reduced=reduced, device="meta")
    cell = {"params": params, "axes": axes, "batch": spec.input_specs(shape_name, reduced)}
    if shape.kind == "train":
        master = spec.master_weights and not reduced
        if master:
            cell["params"] = bf16_params(params)
        cell["opt"] = abstract_opt_state(cell["params"], master)
    elif shape.kind == "decode":
        cell["state"], cell["state_axes"] = spec.state_specs(shape_name, reduced)
    return cell


def cell_step(spec, shape_name, reduced=False):
    """``(step, argument names)``: the cell's step function and which of
    :func:`cell_trees` it takes, in order."""
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return spec.make_train_step(reduced=reduced), ("params", "opt", "batch")
    if shape.kind == "prefill":
        return spec.make_prefill_step(shape, reduced=reduced), ("params", "batch")
    return spec.make_decode_step(shape, reduced=reduced), ("params", "state", "batch")


def cell_shardings(mesh, cell) -> dict:
    """NamedSharding trees for the arguments of :func:`cell_trees`."""
    pshard = shd.make_param_sharding(mesh, cell["params"], cell["axes"])
    out = {"params": pshard, "batch": _batch_shardings(mesh, cell["batch"])}
    if "opt" in cell:
        out["opt"] = {"m": pshard, "v": pshard, "step": shd.NamedSharding(mesh, shd.P())}
        if "master" in cell["opt"]:
            out["opt"]["master"] = pshard
    if "state" in cell:
        out["state"] = _spec_tree_to_shardings(mesh, cell["state"], cell["state_axes"],
                                               shd.ACT_RULES)
    return out


COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def spmd_collectives(params, pshard, microbatch: int, once: bool = False,
                     activations: dict | None = None) -> tuple:
    """``(bytes, counts)`` a mesh position's collectives move in one SPMD
    train step, by kind, counted as the reference counts HLO collectives
    (each op's output bytes): every microbatch gathers the batch axes'
    factor of each param leaf stored split over them, to the block the
    position computes with (``sharding.compute_sharding``; all-gather), or
    once a step with ``once`` (``gather_params_once``); each leaf's
    float32 gradient is reduce-scattered to its shard once a step (an
    all-reduce of the whole for a leaf held whole everywhere); and
    ``activations``, the tensor-parallel collectives of the step's
    products (kind -> ``[bytes, count]``, from :func:`position_count`).
    From shapes alone: ``params`` may be on ``meta``."""
    nbytes, counts = dict.fromkeys(COLLECTIVES, 0), dict.fromkeys(COLLECTIVES, 0)

    def add(kind, shape, itemsize, times=1):
        nbytes[kind] += times * itemsize * math.prod(shape)
        counts[kind] += times

    for x, sh in zip(leaves(params), leaves(pshard)):
        whole, block = tuple(x.shape), sh.shard_shape(x.shape)
        compute = shd.compute_sharding(sh).shard_shape(x.shape)
        if block != compute:
            add("all-gather", compute, x.element_size(), 1 if once else microbatch)
        add("reduce-scatter" if block != whole else "all-reduce", block, 4)
    for kind, (b, n) in (activations or {}).items():
        nbytes[kind] += b
        counts[kind] += n
    return nbytes, counts


_BACKWARD_CALLS = (torch.autograd.grad, torch.autograd.backward, torch.Tensor.backward)


class _PositionTags(TorchFunctionMode):
    """While a group's step runs: each torch call tags the autograd nodes
    it made (those behind its outputs not tagged by an earlier call) with
    its position (``tp.current_position``; ``None`` at home), and marks
    the ops it dispatches as made by that position."""

    def __init__(self):
        super().__init__()
        self.stack = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _BACKWARD_CALLS:  # the backward's ops take their nodes' tags
            return func(*args, **(kwargs or {}))
        pos = tp.current_position()
        self.stack.append(pos)
        try:
            out = func(*args, **(kwargs or {}))
        finally:
            self.stack.pop()
        todo = [t.grad_fn for t in tree_leaves(out)
                if isinstance(t, torch.Tensor) and t.grad_fn is not None]
        while todo:  # the nodes this call made: those not tagged yet
            node = todo.pop()
            if node is None or "tp_position" in node.metadata:
                continue
            node.metadata["tp_position"] = pos
            todo.extend(nxt for nxt, _ in node.next_functions)
        return out


class _PositionFlops(TorchDispatchMode):
    """The FLOPs (``torch.utils.flop_counter``'s formulas) of the ops that
    position 0 runs: those of its share and those computed at home (which
    every position of the reference computes).  An op dispatched by a
    torch call takes the call's position; one of remat's recompute, the
    position whose share is being recomputed; an op of the backward, the
    position tagged on the autograd node that runs it."""

    def __init__(self, tags: _PositionTags):
        super().__init__()
        self.tags = tags
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            if self.tags.stack:
                pos = self.tags.stack[-1]
            elif L.RECOMPUTING:  # remat's recompute: the forward's code again
                pos = tp.current_position()
            else:
                node = torch._C._current_autograd_node()
                pos = None if node is None else node.metadata.get("tp_position")
            if pos in (None, 0):
                self.flops += count(*args, **(kwargs or {}), out_val=out)
        return out


def _depth(spec, reduced):
    """``(units, at)``: how many times the arch repeats its layer unit (a
    pattern group, a Mamba2 block, a shared-attention group, an
    encoder-decoder layer pair), and ``at(n)``, the spec cut to ``n``."""
    cfg = spec.cfg(reduced)
    if spec.kind == "lm":
        units, field = cfg.n_rep, lambda n: {"n_layers": cfg.first_dense + cfg.pattern_len * n}
    elif spec.kind == "hybrid":
        units, field = cfg.n_shared_calls, lambda n: {"n_mamba": cfg.share_every * n}
    else:
        units, field = cfg.n_layers, lambda n: {"n_layers": n}

    def at(n):
        cut = dataclasses.replace(cfg, **field(n))
        return dataclasses.replace(spec, **({"reduced": cut} if reduced else {"config": cut}))

    return units, at


def position_count(spec, shape_name, mesh, reduced=False, batch=None) -> dict:
    """What position (0, 0) of ``mesh`` runs in the cell's step, counted
    on ``meta``: ``flops`` and, for a train cell, ``activations``, the
    tensor-parallel collectives of its products (kind -> ``[bytes,
    count]``, forward, backward and remat's recompute).  A train cell runs
    data group 0's forward and backward over its "model" positions, with
    the param blocks they compute with, at the group's microbatch (the
    step runs ``microbatch`` of them: the counts are multiplied by it);
    ``batch`` (tensors on ``meta``) stands for the shape's.  The layers
    repeat one unit, so the counts are affine in the depth: they are
    taken at one and two units and carried to the arch's depth.  Prefill
    and decode steps run whole on one device, so position (0, 0) runs all
    of the counted step."""
    shape = SHAPES[shape_name]
    if shape.kind != "train":
        return {"flops": count_step(spec, shape_name, reduced)["flops"], "activations": {}}
    units, at = _depth(spec, reduced)
    one = _group_count(at(1), shape_name, mesh, reduced, batch)
    if units == 1:
        return one
    two = _group_count(at(2), shape_name, mesh, reduced, batch)

    def carry(a, b):
        return a + (units - 1) * (b - a)

    kinds = dict.fromkeys(list(one["activations"]) + list(two["activations"]))
    acts = {}
    for kind in kinds:
        a, b = one["activations"].get(kind, [0, 0]), two["activations"].get(kind, [0, 0])
        acts[kind] = [carry(a[0], b[0]), carry(a[1], b[1])]
    return {"flops": carry(one["flops"], two["flops"]), "activations": acts}


def _group_count(spec, shape_name, mesh, reduced, batch) -> dict:
    """:func:`position_count` of a train cell at the spec's depth."""
    cell = cell_trees(spec, shape_name, reduced)
    if batch is not None:
        cell["batch"] = batch
    k = 1 if reduced else spec.train_microbatch
    b = next(iter(cell["batch"].values())).shape[0] // k
    kept, G = shd.batch_groups(mesh, b)
    row = shd.group_positions(mesh, kept)[0]
    M = len(row)
    pshard = shd.make_param_sharding(mesh, cell["params"], cell["axes"])

    def blocks(x, sh):
        view, split = shd.compute_sharding(sh), shd.model_split_dim(sh)
        parts = [torch.empty(view.shard_shape(x.shape), dtype=x.dtype, device="meta")
                 .requires_grad_(x.is_floating_point())
                 for _ in range(M if split is not None else 1)]
        return tp.Split(parts, split, x.shape) if split is not None else parts[0]

    params = tree_map(blocks, cell["params"], pshard)
    batch = {n: x[: b // G] for n, x in cell["batch"].items()}
    group = tp.Group([torch.device("meta")] * M) if M > 1 else None
    tags = _PositionTags()
    with tp.recording() as rec, tp.use_group(group), tags, _PositionFlops(tags) as counter:
        with torch.enable_grad():
            loss = spec.loss_fn(reduced)(params, batch)
            torch.autograd.grad(loss, tp.flatten(leaves(params)), allow_unused=True)
    return {"flops": k * counter.flops,
            "activations": {kind: [k * nb, k * n] for kind, (nb, n) in rec.items()}}


def count_step(spec, shape_name, reduced=False) -> dict:
    """One step run on ``meta``: its FLOPs (``FlopCounterMode``), the peak
    bytes it holds (:class:`LiveBytes`), its arguments' and outputs' whole
    bytes, and the trees (for the shardings)."""
    cell = cell_trees(spec, shape_name, reduced)
    step, names = cell_step(spec, shape_name, reduced)
    args = [cell[n] for n in names]
    with FlopCounterMode(display=False) as flops, LiveBytes(args) as live:
        out = step(*args)
    return dict(cell=cell, names=names, out=out, flops=float(flops.get_total_flops()),
                peak_bytes=live.peak, argument_bytes=_tree_bytes(args),
                output_bytes=_tree_bytes(out))


def _materialize(spec, cell, names, reduced, dev):
    """The cell's arguments on ``dev``: params drawn from seed 0 there,
    tokens uniform over the vocabulary, every other leaf zeros."""
    gen = torch.Generator(device=dev).manual_seed(0)
    params, _ = spec.init(gen, reduced=reduced, device=dev)
    out = {"params": tree_map(lambda t, like: t.to(like.dtype), params, cell["params"])}
    for n in names[1:]:
        out[n] = tree_map(lambda t: torch.zeros(tuple(t.shape), dtype=t.dtype, device=dev),
                          cell[n])
    if "tokens" in out["batch"]:
        tokens = out["batch"]["tokens"]
        out["batch"]["tokens"] = torch.randint(0, getattr(spec.cfg(reduced), "vocab"),
                                               tuple(tokens.shape), generator=gen,
                                               device=dev, dtype=tokens.dtype)
    if "master" in out.get("opt", {}):
        out["opt"]["master"] = tree_map(lambda p: p.to(torch.float32), params)
    return [out[n] for n in names]


def run_cell(spec, shape_name, device, reduced=False) -> dict:
    """The cell's step run twice on ``device``: the peak memory the card
    allocated (``max_memory_allocated``, beside what the process held
    before, ``allocated_before``) and each call's ms (CUDA events; the host
    clock on another device, where no memory is read)."""
    dev = resolve_device(device)
    cell = cell_trees(spec, shape_name, reduced)
    step, names = cell_step(spec, shape_name, reduced)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev) if cuda else None
    args = _materialize(spec, cell, names, reduced, dev)
    ms = []
    for _ in range(2):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = step(*args)
            end.record()
            torch.cuda.synchronize(dev)
            ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = step(*args)
            ms.append(1e3 * (time.perf_counter() - t0))
        # a sum is inf or nan if any entry is (isfinite would copy each leaf)
        finite = all(bool(torch.isfinite(t.sum(dtype=torch.float32)))
                     for t in leaves(out) if t.is_floating_point())
        del out
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    del args
    if cuda:
        torch.cuda.empty_cache()
    return {"device": torch.cuda.get_device_name(dev) if cuda else str(dev),
            "max_memory_allocated": peak, "allocated_before": before,
            "ms_first": ms[0], "ms": ms[1],
            "clock": "cuda events" if cuda else "host", "finite": finite}


def dryrun_cell(arch_name: str, shape_name: str, multi_pod: bool = False,
                verbose: bool = True, device="cuda") -> dict:
    spec = ARCHS[arch_name]
    if shape_name not in spec.shapes:
        return {"arch": arch_name, "shape": shape_name, "status": "skipped",
                "note": spec.skip_notes}
    mesh = make_production_mesh(multi_pod=multi_pod, devices=device_pool(device))
    t0 = time.time()
    counted = count_step(spec, shape_name)
    cell, out = counted["cell"], counted["out"]
    shardings = cell_shardings(mesh, cell)
    arg_bytes = sum(shd.shard_bytes(cell[n], shardings[n]) for n in counted["names"])
    kind = SHAPES[shape_name].kind
    scalar = shd.NamedSharding(mesh, shd.P())
    if kind == "train":
        out_shardings = (shardings["params"], shardings["opt"],
                         tree_map(lambda _: scalar, out[2]))
    elif kind == "decode":
        out_shardings = (_batch_shardings(mesh, out[0]), shardings["state"])
    out_bytes = shd.shard_bytes(out, out_shardings) if kind != "prefill" else None
    coll_bytes = coll_counts = None
    position = position_count(spec, shape_name, mesh) if kind == "train" else \
        {"flops": counted["flops"]}
    if kind == "train":
        coll_bytes, coll_counts = spmd_collectives(cell["params"], shardings["params"],
                                                   spec.train_microbatch,
                                                   activations=position["activations"])
    whole = {"argument_bytes": counted["argument_bytes"],
             "output_bytes": counted["output_bytes"], "peak_bytes": counted["peak_bytes"]}
    result = {
        "arch": arch_name,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "status": "ok",
        "lower_s": None,
        "compile_s": None,
        "count_s": time.time() - t0,
        "flops_per_device": position["flops"],
        "flops_total": counted["flops"],
        "bytes_per_device": None,
        "xla_flops_per_device_uncorrected": None,
        "xla_bytes_per_device_uncorrected": None,
        "collective_bytes_per_device": coll_bytes,
        "collective_counts": coll_counts,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": None,
            "alias_bytes": None,
        },
        "n_params": spec.param_count(),
        "n_active_params": spec.active_param_count(),
        "devices": len(mesh.distinct_devices),
        "whole_cell": whole,
        "fits_one_card": counted["peak_bytes"] <= CARD_BYTES,
        "card": None,
    }
    if result["fits_one_card"] and resolve_device(device).type == "cuda":
        result["card"] = run_cell(spec, shape_name, mesh.distinct_devices[0])
    if verbose:
        print(json.dumps(result, indent=1))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the mesh's pool (default every card: cells that fit one run "
                         "there); 'cpu' counts only")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for a, spec in ARCHS.items():
            for s in spec.shapes:
                cells.append((a, s))
    else:
        cells = [(args.arch, args.shape)]

    t0 = time.time()
    results = []
    for a, s in cells:
        try:
            results.append(dryrun_cell(a, s, multi_pod=args.multi_pod, device=args.device))
        except Exception as e:  # a failing cell is a bug — surface it loudly
            results.append({"arch": a, "shape": s, "status": "FAILED",
                            "error": f"{type(e).__name__}: {e}"})
            print(f"FAILED {a} x {s}: {e}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    ok = sum(1 for r in results if r["status"] == "ok")
    print(f"\n{ok}/{len(results)} cells counted OK in {time.time() - t0:.1f} s")
    return results


if __name__ == "__main__":
    main()
