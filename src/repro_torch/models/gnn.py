"""GNN model zoo (the paper's own family): GCN, GraphSAGE, GIN, GAT.

Port of ``src/repro/models/gnn.py``.  Every model aggregates through
``core.aggregate.aggregate_scv_plan``, so on a CUDA graph every
aggregation is the SCV kernel, and gradients flow back through it (the
kernel chain is one ``torch.autograd.Function``): ``gnn_loss`` trains.
A graph whose plan ``core.exec.PlanExecutor.prepare_graph`` placed (a
``ShardedPlan``) aggregates over its device grid the same way; the
layers do not know the difference.
The combinations (``h @ W``) are plain ``torch.matmul``.  The port runs
eagerly: there is no counterpart of ``gnn_forward_jit``.

Parameters are plain nested dicts of tensors, ``{"layer0": {"w": ...}}``,
named as in the reference so :func:`params_from_jax` can carry the
reference's weights over.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.aggregate import aggregate_scv_plan
from repro_torch.core.formats import COOMatrix, block_diag_coo
from repro_torch.core.scv import (
    DEFAULT_TILE,
    SCVBucketedPlan,
    SCVPlan,
    bucket_caps_for,
    coo_to_scv_tiles,
    plan_from_tiles,
    plan_from_tiles_bucketed,
    tile_nnz_histogram,
)
from repro_torch.device import resolve_device


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
    e_src = z @ p["a_src"]  # [N]
    e_dst = z @ p["a_dst"]
    rows, cols = g.rows.long(), g.cols.long()
    logits = F.leaky_relu(e_src[rows] + e_dst[cols], 0.2)
    # edge softmax per destination row (stable)
    rmax = torch.full((g.n_nodes,), -1e30, dtype=logits.dtype, device=logits.device)
    rmax = rmax.scatter_reduce(0, rows, logits, "amax", include_self=True)
    ex = torch.exp(logits - rmax[rows])
    denom = torch.zeros((g.n_nodes,), dtype=ex.dtype, device=ex.device)
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
