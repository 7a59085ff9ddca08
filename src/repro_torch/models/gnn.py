"""GNN model zoo (the paper's own family): GCN, GraphSAGE, GIN, GAT.

Port of ``src/repro/models/gnn.py``.  Every model aggregates through
``core.aggregate.aggregate_scv_plan``, so on a CUDA graph every
aggregation is the SCV kernel, and gradients flow back through it (the
kernel chain is one ``torch.autograd.Function``): ``gnn_loss`` trains.
A graph whose plan ``core.exec.PlanExecutor.prepare_graph`` placed (a
``ShardedPlan``) aggregates over its device grid the same way; the
layers do not know the difference.
The combinations (``h @ W``) are plain ``torch.matmul``.
:data:`gnn_forward_captured` (a :class:`CapturedForward`) is the
counterpart of the reference's ``gnn_forward_jit``: on a CUDA device it
captures the inference forward once per key (the reference's jit
signature) in a CUDA graph and replays it for every later call.

Parameters are plain nested dicts of tensors, ``{"layer0": {"w": ...}}``,
named as in the reference so :func:`params_from_jax` can carry the
reference's weights over.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.aggregate import aggregate_scv_plan
from repro_torch.core.formats import COOMatrix, block_diag_coo
from repro_torch.core.scv import (
    DEFAULT_TILE,
    MIN_TILE_BUCKET,
    PlanRuns,
    RunIndex,
    SCVBucketedPlan,
    SCVPlan,
    bucket_caps_for,
    coo_to_scv_tiles,
    keep_plan_runs,
    plan_from_tiles,
    plan_from_tiles_bucketed,
    plan_runs,
    tile_nnz_histogram,
)
from repro_torch.device import capture_graph, resolve_device
from repro_torch.kernels.scv_spmm.ops import chain_groups


@dataclasses.dataclass
class Graph:
    """Device-ready graph: the SCV plan, plus the COO edge arrays that only
    GAT's attention reads (batched composites may omit them)."""

    n_nodes: int
    plan: "SCVPlan | SCVBucketedPlan | ShardedPlan"
    rows: Optional[torch.Tensor] = None  # i32[E] (normalized adjacency entries)
    cols: Optional[torch.Tensor] = None
    vals: Optional[torch.Tensor] = None  # f32[E]

    @property
    def device(self) -> torch.device:
        return self.plan.device

    def to(self, device) -> "Graph":
        edges = {k: getattr(self, k).to(device) for k in ("rows", "cols", "vals")
                 if getattr(self, k) is not None}
        return dataclasses.replace(self, plan=self.plan.to(device), **edges)

    def tree_flatten(self):
        """Leaves and static fields, as the reference's pytree splits them."""
        return (self.plan, self.rows, self.cols, self.vals), (self.n_nodes,)


def build_graph(
    adj: COOMatrix,
    tile: int = DEFAULT_TILE,
    backend_cap: Optional[int] = None,
    with_edges: bool = True,
    bucket_caps=None,
    config=None,
    device="cuda",
) -> Graph:
    """COO adjacency -> :class:`Graph` on ``device``.

    ``bucket_caps`` selects the nnz-bucketed plan layout: ``"auto"``
    derives the ladder from the tile nnz histogram, an ascending tuple pins
    it, ``None`` keeps the single-cap :class:`SCVPlan`.  ``config`` — a
    ``tune.config.TunedConfig`` — carries tile and ladder (or single cap)
    as one object, exclusive with the explicit layout arguments.
    """
    dev = resolve_device(device)
    if config is not None:
        if bucket_caps is not None or backend_cap is not None or tile != DEFAULT_TILE:
            raise ValueError(
                "config carries tile/cap/ladder; don't also pass them explicitly"
            )
        tile = config.tile
        if config.bucket_caps:
            bucket_caps = tuple(config.bucket_caps)
        else:
            backend_cap = config.cap
    if bucket_caps is not None and backend_cap is not None:
        raise ValueError(
            "backend_cap and bucket_caps are mutually exclusive: the "
            "bucket ladder defines every capacity (chain-split at caps[-1])"
        )
    if bucket_caps is not None:
        if bucket_caps == "auto":
            caps = bucket_caps_for(tile_nnz_histogram(adj, tile), tile)
        else:
            caps = tuple(int(c) for c in bucket_caps)
            if list(caps) != sorted(set(caps)) or caps[0] <= 0:
                raise ValueError(
                    f"bucket_caps must be ascending distinct positives, got {caps}"
                )
        tiles = coo_to_scv_tiles(adj, tile, cap=caps[-1])
        plan = plan_from_tiles_bucketed(tiles, caps=caps, device=dev)
    else:
        tiles = coo_to_scv_tiles(adj, tile, cap=backend_cap)
        plan = plan_from_tiles(tiles, device=dev)
    rows = cols = vals = None
    if with_edges:
        rows, cols, vals = (
            torch.from_numpy(a).to(dev) for a in (adj.rows, adj.cols, adj.vals)
        )
    return Graph(n_nodes=adj.shape[0], plan=plan, rows=rows, cols=cols, vals=vals)


def _agg(g: Graph, z: torch.Tensor, edge_vals=None) -> torch.Tensor:
    """Aggregate with optional per-edge re-weighting (GAT; a placed plan
    re-weights each span through its own perm)."""
    plan = g.plan
    if edge_vals is not None:
        plan = plan.reweighted(edge_vals)
    return aggregate_scv_plan(plan, z)[: g.n_nodes]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def _dense(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen) / math.sqrt(max(1, shape[0]))


def init_gcn_layer(gen, d_in, d_out):
    return {"w": _dense(gen, (d_in, d_out))}


def gcn_layer(p, g: Graph, h):
    z = h @ p["w"]  # combination, Eq. (2)
    return _agg(g, z)  # aggregation, Eq. (3)


def init_sage_layer(gen, d_in, d_out):
    return {
        "w_self": _dense(gen, (d_in, d_out)),
        "w_neigh": _dense(gen, (d_in, d_out)),
    }


def sage_layer(p, g: Graph, h):
    neigh = _agg(g, h @ p["w_neigh"])
    return h @ p["w_self"] + neigh


def init_gin_layer(gen, d_in, d_out):
    return {
        "w1": _dense(gen, (d_in, d_out)),
        "w2": _dense(gen, (d_out, d_out)),
        "eps": torch.zeros(()),
    }


def gin_layer(p, g: Graph, h):
    agg = _agg(g, h)  # sum aggregation over raw features
    z = (1.0 + p["eps"]) * h + agg
    return torch.relu(z @ p["w1"]) @ p["w2"]


def init_gat_layer(gen, d_in, d_out):
    return {
        "w": _dense(gen, (d_in, d_out)),
        "a_src": _dense(gen, (d_out,)),
        "a_dst": _dense(gen, (d_out,)),
    }


def gat_layer(p, g: Graph, h):
    """Single-head GAT: per-edge attention -> SCV aggregation with
    re-weighted values."""
    if g.rows is None:
        raise ValueError(
            "GAT needs the graph's COO edge arrays; build the plan with "
            "with_edges=True (serving: assemble_batched_graph(with_edges=True))"
        )
    z = h @ p["w"]
    # row n_nodes is a sink past the graph: a captured forward's padding
    # edges point there, so they touch no real row's softmax
    e_src = F.pad(z @ p["a_src"], (0, 1))  # [N + 1]
    e_dst = z @ p["a_dst"]
    rows, cols = g.rows.long(), g.cols.long()
    logits = F.leaky_relu(e_src[rows] + e_dst[cols], 0.2)
    # edge softmax per destination row (stable)
    n = g.n_nodes + 1
    rmax = torch.full((n,), -1e30, dtype=logits.dtype, device=logits.device)
    rmax = rmax.scatter_reduce(0, rows, logits, "amax", include_self=True)
    ex = torch.exp(logits - rmax[rows])
    denom = torch.zeros((n,), dtype=ex.dtype, device=ex.device)
    denom = denom.index_add_(0, rows, ex)
    alpha = ex / torch.clamp_min(denom[rows], 1e-9)
    return _agg(g, z, edge_vals=alpha)


_LAYERS = {
    "gcn": (init_gcn_layer, gcn_layer),
    "sage": (init_sage_layer, sage_layer),
    "gin": (init_gin_layer, gin_layer),
    "gat": (init_gat_layer, gat_layer),
}


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str  # gcn | sage | gin | gat
    d_in: int
    d_hidden: int
    n_classes: int
    n_layers: int = 2


def init_gnn(generator: torch.Generator, cfg: GNNConfig, device="cuda") -> dict:
    """Random weights from ``generator`` (drawn on the CPU, so one seed
    gives the same weights on every device), placed on ``device``."""
    dev = resolve_device(device)
    init_fn, _ = _LAYERS[cfg.kind]
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {
        f"layer{i}": {
            k: v.to(dev)
            for k, v in init_fn(generator, dims[i], dims[i + 1]).items()
        }
        for i in range(cfg.n_layers)
    }


def params_from_jax(params, device="cuda") -> dict:
    """The reference's param tree (``{"layer0": {"w": array}}``, arrays as
    numpy or anything ``np.asarray`` takes) as the port's f32 tensors."""
    dev = resolve_device(device)
    return {
        layer: {
            k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in ps.items()
        }
        for layer, ps in params.items()
    }


def gnn_forward(params, cfg: GNNConfig, g: Graph, x: torch.Tensor) -> torch.Tensor:
    """Full multi-layer forward; ReLU between layers."""
    _, layer_fn = _LAYERS[cfg.kind]
    h = x
    for i in range(cfg.n_layers):
        h = layer_fn(params[f"layer{i}"], g, h)
        if i + 1 < cfg.n_layers:
            h = torch.relu(h)
    return h


def gnn_loss(params, cfg: GNNConfig, g: Graph, x, labels, mask) -> torch.Tensor:
    """Masked mean cross-entropy of the forward's logits (the reference's
    ``gnn_loss``, ``src/repro/models/gnn.py:416``)."""
    logits = gnn_forward(params, cfg, g, x)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


# ---------------------------------------------------------------------------
# batched multi-graph forward (serving path)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BatchedGraph:
    """Many small graphs composed into one block-diagonal ``Graph``.

    Request i owns composite rows ``node_offsets[i] : node_offsets[i] +
    node_counts[i]``; every other row is structural padding.
    ``n_real_nodes`` is the total real node count, not a row boundary.
    """

    graph: Graph
    node_offsets: np.ndarray  # int64[k+1]
    node_counts: np.ndarray  # int64[k]
    n_real_nodes: int

    @property
    def n_graphs(self) -> int:
        return len(self.node_counts)

    def tree_flatten(self):
        """As the reference: the composite is the only child; the member
        layout is static (int tuples)."""
        return (self.graph,), (
            tuple(int(o) for o in self.node_offsets),
            tuple(int(c) for c in self.node_counts),
            self.n_real_nodes,
        )

    def to(self, device) -> "BatchedGraph":
        return dataclasses.replace(self, graph=self.graph.to(device))


def build_batched_graph(
    adjs: list[COOMatrix],
    tile: int = DEFAULT_TILE,
    backend_cap: Optional[int] = None,
    pad_nodes: Optional[int] = None,
    device="cuda",
) -> BatchedGraph:
    """Compose per-request adjacencies into one block-diagonal ``Graph`` on
    ``device``: ``core.formats.block_diag_coo`` (padded with empty rows to
    ``pad_nodes``), then :func:`build_graph` over the composite.  The
    serving engine assembles the same composite from cached member plans
    instead (``serve.graph_engine.assemble_batched_graph``)."""
    for a in adjs:
        if a.shape[0] != a.shape[1]:
            raise ValueError(f"adjacency must be square, got {a.shape}")
    n_real = int(sum(a.shape[0] for a in adjs))
    pad_shape = None
    if pad_nodes is not None:
        if pad_nodes < n_real:
            raise ValueError(f"pad_nodes={pad_nodes} < total nodes {n_real}")
        pad_shape = (pad_nodes, pad_nodes)
    comp, row_off, _ = block_diag_coo(adjs, pad_shape=pad_shape)
    g = build_graph(comp, tile=tile, backend_cap=backend_cap, device=device)
    return BatchedGraph(
        graph=g,
        node_offsets=row_off,
        node_counts=np.diff(row_off),
        n_real_nodes=n_real,
    )


def batch_features(bg: BatchedGraph, xs) -> torch.Tensor:
    """Stack per-request feature matrices into the composite node space
    (zeros in padding rows): one host fill, one copy to the device."""
    if len(xs) != bg.n_graphs:
        raise ValueError(f"{len(xs)} feature blocks for {bg.n_graphs} graphs")
    d = int(np.asarray(xs[0]).shape[1]) if xs else 0
    x = np.zeros((bg.graph.n_nodes, d), np.float32)
    for i, xi in enumerate(xs):
        s = int(bg.node_offsets[i])
        x[s : s + int(bg.node_counts[i])] = np.asarray(xi, np.float32)
    return torch.from_numpy(x).to(bg.graph.device)


def split_outputs(bg: BatchedGraph, out: torch.Tensor) -> list[np.ndarray]:
    """Scatter the composite output back into per-request blocks.  The copy
    to the host is the wave's device sync point; blocks are copies, not
    views, so a retained output does not pin the whole composite."""
    host = out.cpu().numpy()
    return [
        host[int(s) : int(s) + int(c)].copy()
        for s, c in zip(bg.node_offsets[: bg.n_graphs], bg.node_counts)
    ]


def gnn_forward_batched(params, cfg: GNNConfig, bg: BatchedGraph, xs) -> list:
    """One forward over the block-diagonal composite; per-request outputs."""
    out = gnn_forward(params, cfg, bg.graph, batch_features(bg, xs))
    return split_outputs(bg, out)


# ---------------------------------------------------------------------------
# the forward captured in a CUDA graph (counterpart of gnn_forward_jit)
# ---------------------------------------------------------------------------
_PLAN_LEAVES = ("tile_row", "tile_col", "rows", "cols", "vals", "nnz_in_tile", "perm")


def _segments(plan) -> tuple:
    return getattr(plan, "segments", (plan,))


def _key_tiles(j: int, s) -> int:
    """Tiles segment ``j`` stands for in a capture key: its own count, but
    a later segment left empty counts as the serving engine's smallest tile
    bucket, so the composites of one padding bucket share one key whether
    or not a capacity segment is empty.  (The first segment seeds the
    output, so an empty one is a key of its own.)"""
    return s.n_tiles if s.n_tiles or j == 0 else MIN_TILE_BUCKET


def edge_capacity(plan) -> int:
    """Entry slots of ``plan`` (each real edge fills one) as a capture key
    counts them: the length a captured forward pads a graph's edge arrays
    to."""
    return sum(_key_tiles(j, s) * s.cap for j, s in enumerate(_segments(plan)))


def _sign(obj, out: list) -> None:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        out.append(repr(obj))
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        out.append(f"{tuple(obj.shape)}:{obj.dtype}:{getattr(obj, 'device', 'host')}")
    elif isinstance(obj, (list, tuple)):
        out.append(f"{type(obj).__name__}(")
        for c in obj:
            _sign(c, out)
        out.append(")")
    elif isinstance(obj, dict):
        out.append("{")
        for k in sorted(obj):
            out.append(f"{k!r}:")
            _sign(obj[k], out)
        out.append("}")
    elif isinstance(obj, Graph):
        # the edge arrays by dtype and device only: a captured forward pads
        # them to edge_capacity(plan), which the plan's key already fixes
        out.append(f"Graph({obj.n_nodes},")
        _sign(obj.plan, out)
        for e in (obj.rows, obj.cols, obj.vals):
            out.append("None" if e is None else f"edges:{e.dtype}:{e.device}")
        out.append(")")
    elif isinstance(obj, (SCVPlan, SCVBucketedPlan)):
        out.append(f"{type(obj).__name__}(")
        for j, s in enumerate(_segments(obj)):
            nt = _key_tiles(j, s)
            out.append(f"seg{(s.tile, s.cap, s.shape, s.order)!r}(")
            for k in _PLAN_LEAVES:
                leaf = getattr(s, k)
                out.append("None" if leaf is None else
                           f"{(nt,) + tuple(leaf.shape[1:])}:{leaf.dtype}:{leaf.device}")
            out.append(")")
        out.append(")")
    elif hasattr(obj, "tree_flatten"):
        children, aux = obj.tree_flatten()
        out.append(f"{type(obj).__name__}{aux!r}(")
        _sign(children, out)
        out.append(")")
    else:
        out.append(repr(obj))


def forward_key(*trees) -> str:
    """The key of a captured forward: every static field (the config, a
    graph's node count, a plan's tile, caps, order and shape, a composite's
    member layout), every tensor leaf's shape, dtype and device, and for a
    graph's edge arrays whether they are there (their padded length follows
    from the plan).  A later capacity segment left empty counts as the
    smallest tile bucket (:func:`_key_tiles`).  Two calls with equal keys
    share one capture, as two calls with one jit signature share one trace
    in the reference; a plan's run index is not part of the key (a capture
    copies it into tables sized from the plan's shapes)."""
    out: list = []
    _sign(trees, out)
    return "".join(out)


class _Capture:
    """One key's CUDA graph: static inputs (the parameters, the features,
    each segment's leaves and padded run-index tables, each vector launch's
    padded plan-level tables, padded edge arrays), the graph, its static
    output, and the launches its capture recorded."""

    def __init__(self, forward, params, cfg, g: Graph, x: torch.Tensor, owner):
        kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")

        dev = x.device
        self.owner = owner
        self.params = {layer: {k: v.clone() for k, v in ps.items()}
                       for layer, ps in params.items()}
        self.x = x.clone()
        segs = []
        for j, s in enumerate(_segments(g.plan)):
            nt = _key_tiles(j, s)
            leaves = {}
            for k in _PLAN_LEAVES:
                leaf = getattr(s, k)
                if leaf is not None:
                    shape = (nt,) + tuple(leaf.shape[1:])
                    leaves[k] = torch.full(shape, -1 if k == "perm" else 0,
                                           dtype=leaf.dtype, device=dev)
            runs = RunIndex.padded(nt, s.n_row_blocks, s.cap, dev)
            segs.append(dataclasses.replace(s, **leaves, runs=runs))
        plan = SCVBucketedPlan(tuple(segs)) if isinstance(g.plan, SCVBucketedPlan) else segs[0]
        # each vector launch's plan-level tables, sized from its segments'
        # shapes and found by the chain through its segments' run indexes
        self._plans = []
        for group in chain_groups(len(segs)):
            pr = PlanRuns.padded([(segs[i].n_tiles, segs[i].cap) for i in group],
                                 segs[0].n_row_blocks, dev)
            keep_plan_runs(tuple(segs[i].runs for i in group), pr)
            self._plans.append((group, pr))
        edges = {}
        if g.rows is not None:
            n_edges = edge_capacity(g.plan)
            edges = dict(
                rows=torch.full((n_edges,), g.n_nodes, dtype=g.rows.dtype, device=dev),
                cols=torch.zeros((n_edges,), dtype=g.cols.dtype, device=dev),
                vals=torch.zeros((n_edges,), dtype=g.vals.dtype, device=dev),
            )
        self.g = Graph(n_nodes=g.n_nodes, plan=plan, **edges)
        launch_of = {id(s.runs): ("segment", j) for j, s in enumerate(segs)}
        launch_of.update({id(pr): ("chain", k) for k, (_, pr) in enumerate(self._plans)})
        # the run index each captured launch runs on at the next replay (a
        # segment's, or a chain's plan-level index): None where it runs no unit
        self._loaded: dict = {}
        self._n_edges = -1
        # the call runs eagerly on the side stream first, which also makes
        # the library's and cuBLAS's lazy state there; then the capture, on
        # the same stream, over the static inputs (which need no values for
        # it; the split runs' counters are made inside it, zeroed by the
        # graph)
        cur = torch.cuda.current_stream(dev)
        side = owner.side_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.first = forward(params, cfg, g, x)
        n_before = len(kmod.captured)
        self.graph = torch.cuda.CUDAGraph()
        try:
            self.out = capture_graph(self.graph, side,
                                     lambda: forward(self.params, cfg, self.g, self.x))
            self.launches = [(launch_of[id(r)], body, threshold)
                             for r, body, threshold in kmod.captured[n_before:]]
        finally:
            del kmod.captured[n_before:]
        cur.wait_stream(side)
        self.first.record_stream(cur)

    def _copy(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        dst.copy_(src)
        self.owner.copy_bytes += src.numel() * src.element_size()

    def load(self, params, g: Graph, x: torch.Tensor) -> None:
        """Copy one call's inputs into the static ones, on the current
        stream, after the host checks that each launch of the forward runs
        on its run index (each segment's, and each vector launch's
        plan-level index over its segments)."""
        from repro_torch.kernels.scv_spmm.scv_spmm import check_plan_runs, check_runs

        segments = _segments(g.plan)
        for j, (s, st) in enumerate(zip(segments, _segments(self.g.plan))):
            if not s.n_tiles:  # a later segment left empty: no unit runs
                self._loaded[("segment", j)] = None
                st.runs.clear()
                continue
            check_runs(s.runs, s.n_tiles, s.cap, s.n_row_blocks)
            self._loaded[("segment", j)] = s.runs
            st.runs.load(s.runs)
            for k in _PLAN_LEAVES:
                if getattr(st, k) is not None:
                    self._copy(getattr(st, k), getattr(s, k))
        for k, (group, pr) in enumerate(self._plans):
            real = None
            if any(segments[i].n_tiles for i in group):
                real = plan_runs(tuple(segments[i].runs for i in group))
                check_plan_runs(real, len(group), segments[0].n_row_blocks)
                pr.load(real)
            else:
                pr.clear()
            self._loaded[("chain", k)] = real
        if g.rows is not None:
            n = g.rows.shape[0]
            if n > self.g.rows.shape[0]:
                raise ValueError(f"{n} edges over the plan's {self.g.rows.shape[0]} slots")
            for k in ("rows", "cols", "vals"):
                self._copy(getattr(self.g, k)[:n], getattr(g, k))
            if n != self._n_edges:  # padding edges into the sink row
                self.g.rows[n:].fill_(g.n_nodes)
                self.g.cols[n:].zero_()
                self.g.vals[n:].zero_()
                self._n_edges = n
        for layer, ps in params.items():
            for k, v in ps.items():
                self._copy(self.params[layer][k], v)
        self._copy(self.x, x)

    def replay(self, params, g: Graph, x: torch.Tensor) -> torch.Tensor:
        """Load, replay, and add to the launch counts each captured launch
        whose segments hold tiles in ``g``, counted by the rule the eager
        wrapper applies to the run index it ran on (a launch over segments
        left empty runs no unit, and the eager chain makes none)."""
        kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")

        self.load(params, g, x)
        self.graph.replay()
        for which, body, threshold in self.launches:
            runs = self._loaded[which]
            if runs is not None:
                kmod.add_counts(kmod.launch_counts(body, threshold, runs))
        return self.out.clone()


class CapturedForward:
    """``forward(params, cfg, g, x)`` (default :func:`gnn_forward`) for
    inference, captured in a CUDA graph once per key (:func:`forward_key`),
    the counterpart of the reference's ``gnn_forward_jit``.

    On a CUDA device a new key runs the call eagerly on a side stream (its
    result is the call's), then captures the forward there over static
    copies of its inputs.  With ``defer=True`` a new key's calls run
    eagerly on the current stream instead, until :meth:`capture_pending`
    captures the key from the inputs of its first call: the serving engine
    calls it when no wave is queued or in flight, so no capture lands on a
    live wave.  A call on a captured key copies its tensors in, replays,
    and returns a clone of the static output.  Each segment's run index,
    and each vector launch's plan-level index, is copied into tables sized
    from the segments' shapes (``core.scv.RunIndex.padded``,
    ``core.scv.PlanRuns.padded``), so composites of one padding bucket
    share one capture; its host checks run on every plan before the copy.
    The kernels' launch counts rise at every replay by the launches the
    capture recorded, each counted over the run index the replay loaded.
    On the CPU a key holds nothing and the call runs ``forward`` eagerly,
    counted all the same.

    Counts: ``captures`` the keys minted (a key's first call), ``replays``
    the calls on a captured key (on the CPU, on a known key; together the
    counterpart of ``gnn_forward_jit._cache_size()``), ``deferred`` the
    calls on a key still waiting for :meth:`capture_pending`, ``graphs``
    the CUDA graphs captured (one per key at most), ``copy_bytes`` the bytes
    copied in, ``capture_seconds`` the host time of captures (each with its
    eager run).

    A placed plan (``core.exec.ShardedPlan``) is refused: its spans run on
    per-slot streams, eagerly.  Training stays eager too (the plain
    backward syncs the host).
    """

    def __init__(self, forward=None, defer: bool = False):
        self.forward = forward if forward is not None else gnn_forward
        self.defer = defer
        self._entries: dict = {}  # key -> _Capture, or None while eager
        self._pending: dict = {}  # key -> [calls, (params, cfg, g, x) of its first call]
        self._streams: dict = {}
        self.captures = 0
        self.replays = 0
        self.deferred = 0
        self.graphs = 0
        self.copy_bytes = 0
        self.capture_seconds = 0.0

    def side_stream(self, dev: torch.device) -> torch.cuda.Stream:
        """The stream this object captures on, on ``dev`` (one for all its
        keys, as ``torch.cuda.graph`` keeps one)."""
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        return self._streams[dev]

    def _capture(self, key, params, cfg, g: Graph, x: torch.Tensor) -> "_Capture":
        t0 = time.perf_counter()
        entry = _Capture(self.forward, params, cfg, g, x, self)
        self.capture_seconds += time.perf_counter() - t0
        self._entries[key] = entry
        self.graphs += 1
        return entry

    def __call__(self, params, cfg: GNNConfig, g: Graph, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.core.exec import ShardedPlan

        if isinstance(g.plan, ShardedPlan):
            raise ValueError("a placed plan runs eagerly: call gnn_forward")
        key = forward_key(params, cfg, g, x)
        with torch.inference_mode():
            if key in self._pending:
                self._pending[key][0] += 1
                self.deferred += 1
                return self.forward(params, cfg, g, x)
            if key in self._entries:
                self.replays += 1
                entry = self._entries[key]
                if entry is None:
                    return self.forward(params, cfg, g, x)
                return entry.replay(params, g, x)
            self.captures += 1
            if x.device.type != "cuda":
                self._entries[key] = None
                return self.forward(params, cfg, g, x)
            if self.defer:
                self._pending[key] = [1, (params, cfg, g, x)]
                return self.forward(params, cfg, g, x)
            entry = self._capture(key, params, cfg, g, x)
            first, entry.first = entry.first, None
            return first

    def capture_pending(self, limit: Optional[int] = None) -> list:
        """Capture up to ``limit`` (default all) keys that are waiting, the
        most called first, each from its first call's inputs; returns their
        ``(cfg, g)``.  Each capture runs the forward once eagerly first (on
        its side stream), so each adds one forward's launches to the
        kernels' counts."""
        done = []
        with torch.inference_mode():
            while self._pending and (limit is None or len(done) < limit):
                key = max(self._pending, key=lambda k: self._pending[k][0])
                params, cfg, g, x = self._pending.pop(key)[1]
                self._capture(key, params, cfg, g, x).first = None
                done.append((cfg, g))
        return done

    def clear_cache(self) -> None:
        """Drop every capture and its memory (the counts stay): the next
        call of each key captures again."""
        self._entries.clear()
        self._pending.clear()


#: The module's captured forward over :func:`gnn_forward`.
gnn_forward_captured = CapturedForward()
