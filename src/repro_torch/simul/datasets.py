"""Synthetic graphs matching the paper's Table I statistics.

Port of ``src/repro/simul/datasets.py``: the Table I specs, the
Chung-Lu power-law generator, GCN normalization and :func:`load`, host
numpy as in the reference.  Nothing is downloaded: :func:`load` generates
a graph with a dataset's node and edge counts, scaled down to
``max_edges``.  Its seed mixes in ``hash(name)``, which Python salts per
process, so it gives the reference's graph within one process only.  A
full-graph run at a dataset's scale calls ``powerlaw_graph(spec.nodes,
spec.edges, seed=...)`` and ``gcn_normalize`` directly, so the graph is
the same in every process.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.formats import COOMatrix


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    nodes: int
    edges: int
    feature_size: int
    category: str  # "ultra" | "highly"  (Fig. 6 split)


# Table I, verbatim.
TABLE_I: dict[str, DatasetSpec] = {
    "mag": DatasetSpec("mag", 1_939_743, 21_111_007, 128, "ultra"),
    "products": DatasetSpec("products", 2_449_029, 61_859_140, 100, "ultra"),
    "arxiv": DatasetSpec("arxiv", 169_343, 1_166_243, 128, "ultra"),
    "pubmed": DatasetSpec("pubmed", 19_717, 88_651, 500, "ultra"),
    "cora": DatasetSpec("cora", 19_793, 126_842, 8_710, "ultra"),
    "citeseer": DatasetSpec("citeseer", 3_327, 9_228, 3_703, "ultra"),
    "reddit": DatasetSpec("reddit", 232_965, 114_615_892, 602, "highly"),
    "proteins": DatasetSpec("proteins", 132_534, 39_561_252, 8, "highly"),
    "cobuy_computer": DatasetSpec("cobuy_computer", 13_752, 491_722, 767, "highly"),
    "cobuy_photo": DatasetSpec("cobuy_photo", 7_650, 238_163, 745, "highly"),
}


@dataclasses.dataclass(frozen=True)
class GraphData:
    spec: DatasetSpec
    adj: COOMatrix  # weighted normalized adjacency (with self loops)
    feature_size: int
    scale: float  # nodes/edges scale factor applied vs Table I


def powerlaw_graph(
    n: int, m: int, alpha: float = 2.1, seed: int = 0
) -> COOMatrix:
    """Chung-Lu style: P(edge u->v) ∝ w_u * w_v with Zipf weights."""
    rng = np.random.default_rng(seed)
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-1.0 / (alpha - 1.0))
    rng.shuffle(w)
    p = w / w.sum()
    # sample with replacement, dedup: overdraw slightly to land near m
    draw = int(m * 1.15) + 16
    src = rng.choice(n, size=draw, p=p)
    dst = rng.choice(n, size=draw, p=p)
    key = src.astype(np.int64) * n + dst
    key = np.unique(key)
    rng.shuffle(key)
    key = key[:m]
    rows = (key // n).astype(np.int32)
    cols = (key % n).astype(np.int32)
    vals = np.ones(len(key), np.float32)
    return COOMatrix(rows, cols, vals, (n, n))


def powerlaw_edges(n: int, m: int, seed: int = 0, alpha: float = 2.1) -> COOMatrix:
    """Exactly ``m`` unique edges with Zipf-weighted endpoints and integer
    weights 1-3: the dense-block graph of the reference's kernel benchmark
    (a copy of ``benchmarks/kernel_bench.py::powerlaw_edges``, same draws
    for the same seed).

    Unlike :func:`powerlaw_graph` it draws in rounds until ``m`` unique
    pairs exist.  With ``m`` near ``n^2 / 4`` hub blocks fill whole tiles.
    Small integer weights keep every partial sum exact in f32, so any
    accumulation order gives the same bits.  A node may link to itself."""
    rng = np.random.default_rng(seed)
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-1.0 / (alpha - 1.0))
    rng.shuffle(w)
    p = w / w.sum()
    keys: np.ndarray = np.zeros(0, np.int64)
    while len(keys) < m:
        draw = int((m - len(keys)) * 1.5) + 1024
        src = rng.choice(n, size=draw, p=p)
        dst = rng.choice(n, size=draw, p=p)
        keys = np.unique(np.concatenate([keys, src.astype(np.int64) * n + dst]))
    rng.shuffle(keys)
    keys = keys[:m]
    rows = (keys // n).astype(np.int32)
    cols = (keys % n).astype(np.int32)
    vals = rng.integers(1, 4, size=m).astype(np.float32)
    return COOMatrix(rows, cols, vals, (n, n))


def gcn_normalize(a: COOMatrix) -> COOMatrix:
    """Â = D^-1/2 (A + I) D^-1/2 — the weighted adjacency of GCN."""
    n = a.shape[0]
    rows = np.concatenate([a.rows, np.arange(n, dtype=np.int32)])
    cols = np.concatenate([a.cols, np.arange(n, dtype=np.int32)])
    vals = np.concatenate([a.vals, np.ones(n, np.float32)])
    deg = np.zeros(n, np.float64)
    np.add.at(deg, rows, vals)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    w = (dinv[rows] * vals * dinv[cols]).astype(np.float32)
    return COOMatrix(rows, cols, w, (n, n))


def load(
    name: str,
    max_edges: int = 2_000_000,
    normalize: bool = True,
    seed: int = 0,
) -> GraphData:
    spec = TABLE_I[name]
    scale = min(1.0, max_edges / spec.edges)
    n = max(64, int(spec.nodes * scale))
    m = max(256, int(spec.edges * scale))
    adj = powerlaw_graph(n, m, seed=seed + hash(name) % 2**16)
    if normalize:
        adj = gcn_normalize(adj)
    return GraphData(spec=spec, adj=adj, feature_size=spec.feature_size, scale=scale)


def dataset_names(category: str | None = None) -> list[str]:
    return [
        k for k, v in TABLE_I.items() if category is None or v.category == category
    ]
