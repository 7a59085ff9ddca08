"""Batched multi-graph SCV inference engine.

Port of ``src/repro/serve/graph_engine.py``.  Requests carry a whole graph
(adjacency + node features + model name); a wave fuses many small graphs
into one block-diagonal composite, so each GNN layer runs one SCV
aggregation over the whole wave — one kernel launch per non-empty
capacity segment.

* **Plan cache** — per-graph plans and assembled composites are
  content-addressed and LRU-cached (``plan_cache.py``).
* **Composite assembly from cached plans** — member plans are kept on the
  host, so a composite is index arithmetic over their arrays (vectorized
  numpy, no re-tiling), copied to the engine's device once and cached
  there (``metrics()`` times the two: ``assemble_seconds``,
  ``copy_seconds``).  The composite's run index is computed on the host,
  from the composite schedule.
* **Padding buckets** — composite node counts round up to a fixed ladder,
  and tile counts to powers of two, so composites come in few shapes.
* **Scheduling** — ``serve/scheduler.py`` owns intake, wave formation,
  deadline admission and the async loop (``start()`` / ``stop()``).
* **Tracked graphs** — a request with a ``graph_id`` registers its
  adjacency; ``update(graph_id, delta)`` advances it by an edge delta and
  patches its cached member plan on the host (``stream.apply_delta``,
  re-keyed by ``plan_cache.delta_key``), so the next wave's composite is
  assembled from the patched member and copied to the device.
* **Debug validation** — ``GraphEngineConfig.debug_validate`` runs
  ``core.validate.validate_plan`` on every composite the engine builds.
* **Multi-device routing** — a composite over ``shard_nodes_threshold``
  nodes or ``shard_nnz_threshold`` entries is placed by a
  ``core.exec.PlanExecutor`` (tile spans x feature slabs over its pool)
  and cached placed: the decision is part of the composite key, so a hot
  oversized batch reuses its placement.  A composite that holds an
  updated member has a new key, so it is assembled and placed again,
  never patched while placed.
* **Autotuned layouts** — with ``GraphEngineConfig.autotune`` each graph
  regime (quantized tile-nnz histogram x machine fingerprint) resolves its
  own tile and ladder through ``tune.Autotuner`` on the engine's device;
  waves group by resolved config, and member and composite keys carry it.
  Only tile, ladder and cap reach the plan, as in the reference.
* **Captured forward** — an unplaced wave's forward runs through the
  engine's ``models.gnn.CapturedForward``: on a CUDA device one CUDA graph
  per padding bucket (the reference's ``gnn_forward_jit``), replayed for
  every later wave of the bucket.  A bucket's waves run eagerly until the
  scheduler is idle (no wave queued or in flight, or ``run()`` served its
  last wave), which is when the engine captures it: no capture sits on a
  request's latency.  Placed waves run eagerly.

The engine runs on ``device`` (default ``"cuda"``; it raises when no GPU
is present, and the tests pass ``device="cpu"``); a placed composite's
output device is the engine's.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core.exec import PlanExecutor, ShardedPlan, pool_device
from repro_torch.core.formats import COOMatrix
from repro_torch.core.scv import (
    DEFAULT_CAP,
    DEFAULT_LADDER,
    DEFAULT_TILE,
    MIN_TILE_BUCKET,
    RunIndex,
    SCVBucketedPlan,
    SCVPlan,
)
from repro_torch.core.validate import check_coo, validate_plan
from repro_torch.device import resolve_device
from repro_torch.kernels.scv_spmm.ops import chain_groups, chain_launches
from repro_torch.models.gnn import (
    BatchedGraph,
    CapturedForward,
    Graph,
    batch_features,
    build_graph,
    gnn_forward,
    split_outputs,
)
from repro_torch.serve.plan_cache import PlanCache, combine_keys, coo_content_key
from repro_torch.serve.scheduler import (
    AdmissionRejected,
    EngineOverloaded,
    Scheduler,
    _Control,
)
from repro_torch.stream import DeltaBatch, apply_coo, apply_delta, check_delta
from repro_torch.tune import Autotuner, TuneStore, TunedConfig

__all__ = [
    "AdmissionRejected",
    "EngineOverloaded",
    "GraphEngineConfig",
    "GraphRequest",
    "GraphServeEngine",
    "assemble_batched_graph",
    "plan_launches",
]


@dataclasses.dataclass
class GraphRequest:
    """One inference request: run ``model`` over (adj, x).

    ``adj`` may be omitted when ``graph_id`` names a graph the engine
    already tracks (registered by an earlier request that carried both):
    the wave then serves the tracked graph's *current* adjacency, after
    every ``update()`` applied so far.
    """

    rid: int
    adj: Optional[COOMatrix] = None  # normalized adjacency (e.g. gcn_normalize)
    x: Optional[np.ndarray] = None  # f32[n_nodes, d_in]
    model: str = "default"
    # stable identity of a delta-tracked graph: a request carrying both
    # graph_id and adj (re)registers the adjacency under it
    graph_id: Optional[str] = None
    # latency budget in seconds, relative to submit time (None = serve
    # whenever); see the scheduler's admission control and shedding
    deadline_s: Optional[float] = None
    out: Optional[np.ndarray] = None  # f32[n_nodes, n_classes] when done
    done: bool = False
    error: Optional[str] = None  # set when ejected as failed or shed
    retries: int = 0  # failed waves this request has been part of
    isolate: bool = False  # re-serve alone (failure isolation)
    t_submit: float = 0.0  # time.monotonic() at admission
    t_done: float = 0.0  # time.monotonic() at completion
    # set on every terminal transition — async callers block on it
    event: Optional[threading.Event] = None

    @property
    def latency_s(self) -> Optional[float]:
        return self.t_done - self.t_submit if self.done else None

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until this request reaches a terminal state; returns the
        output or raises ``RuntimeError`` with the failure/shed reason."""
        if self.event is not None and not self.event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not done after {timeout}s")
        if self.error is not None:
            raise RuntimeError(f"request {self.rid}: {self.error}")
        if not self.done:
            raise RuntimeError(f"request {self.rid} is not done")
        return self.out


@dataclasses.dataclass
class GraphEngineConfig:
    max_batch_graphs: int = 16
    max_batch_nodes: int = 4096
    tile: int = DEFAULT_TILE
    cap: int = DEFAULT_CAP  # per-tile entry capacity when bucket_caps is off
    # nnz-bucketed plans on one fixed ascending capacity ladder shared by
    # every member plan, so composites fuse segment by segment.  The empty
    # tuple selects single-cap plans at ``cap``.
    bucket_caps: tuple[int, ...] = DEFAULT_LADDER
    # per-regime plan configuration (tune.Autotuner): each graph regime
    # (quantized tile-nnz histogram x machine fingerprint) resolves its own
    # tile and ladder instead of the literals above, which stay the
    # fallback for empty graphs.  Waves group by resolved config; member
    # and composite keys carry it.  A store hit costs one O(nnz) histogram
    # per request per wave; a miss runs the stage-1 simulator sweep, and
    # with autotune_calibrate the kernel chain timed on the engine's device
    autotune: bool = False
    autotune_store: Optional[str] = None  # TuneStore path (None = in-memory)
    autotune_calibrate: bool = False
    node_buckets: tuple[int, ...] = (256, 512, 1024, 2048, 4096)
    cache_entries: int = 256
    cache_bytes: int = 256 << 20
    plan_ttl_s: Optional[float] = None  # expire cached plans after this age
    completed_history: int = 1024  # recent requests kept for inspection
    max_retries: int = 1  # failed waves a request survives before ejection
    # --- async scheduler (serve/scheduler.py) ---------------------------
    max_wave_delay_ms: float = 2.0
    target_wave_size: Optional[int] = None
    intake_capacity: int = 4096
    latency_window: int = 4096
    service_ema_alpha: float = 0.2
    # every N updates a tracked graph's entry is re-homed from its
    # delta-chained key to the content key of its current adjacency
    # (PlanCache.anchor); 0 disables
    anchor_every: int = 16
    # run validate_plan on every composite the engine builds (a host pass
    # over the composite's leaves: for bisecting plan corruption)
    debug_validate: bool = False
    # multi-device routing (core.exec.PlanExecutor): a composite whose
    # padded node count exceeds shard_nodes_threshold or whose total nnz
    # exceeds shard_nnz_threshold runs placed on the executor's pool; None
    # disables a trigger, and both None keep every wave on one device
    shard_nodes_threshold: Optional[int] = None
    shard_nnz_threshold: Optional[int] = None

    def __post_init__(self):
        for field in ("max_batch_graphs", "max_batch_nodes", "tile", "cap"):
            if getattr(self, field) <= 0:
                raise ValueError(f"{field} must be positive")
        if self.bucket_caps:
            caps = tuple(int(c) for c in self.bucket_caps)
            if list(caps) != sorted(set(caps)) or caps[0] <= 0:
                raise ValueError(
                    f"bucket_caps must be ascending distinct positives, got {caps}"
                )
        for field in ("shard_nodes_threshold", "shard_nnz_threshold"):
            v = getattr(self, field)
            if v is not None and v <= 0:
                raise ValueError(f"{field} must be positive (or None)")
        if self.completed_history < 0:
            raise ValueError("completed_history must be >= 0")
        if self.anchor_every < 0:
            raise ValueError("anchor_every must be >= 0")
        if self.node_buckets and self.max_batch_nodes > max(self.node_buckets):
            raise ValueError(
                f"max_batch_nodes={self.max_batch_nodes} exceeds the largest "
                f"node bucket ({max(self.node_buckets)}); extend node_buckets "
                f"(or set node_buckets=() for power-of-two padding)"
            )


# ---------------------------------------------------------------------------
# composite assembly from per-graph plans
# ---------------------------------------------------------------------------
def _bucket_nodes(n: int, buckets: tuple[int, ...], tile: int) -> int:
    """Smallest bucket >= n; past the ladder, the next power of two."""
    for b in sorted(buckets):
        if b >= n:
            return -(-b // tile) * tile
    p = 1
    while p < n:
        p *= 2
    return -(-p // tile) * tile


def _cat(parts, pad_blocks, dtype):
    # convert per block BEFORE concatenating: mixing int32 members with
    # default-float64 pads would promote the whole composite to f64
    blocks = [np.asarray(p, dtype) for p in parts]
    blocks += [np.asarray(b, dtype) for b in pad_blocks]
    return np.concatenate(blocks) if blocks else np.zeros(0, dtype)


def _assemble_segment(
    segs: list[SCVPlan],
    blk_off: np.ndarray,
    n_aligned: int,
    pad_nodes: int,
    T: int,
    cap: int,
    order: str,
    entry_off: Optional[np.ndarray],
    first_segment: bool,
    device,
) -> SCVPlan:
    """Fuse one capacity segment across (host) members into the composite
    segment on ``device``.

    Member tile coordinates shift by the member's block offset.  Then two
    pad blocks follow: zero-nnz coverage tiles for the bucket-padding
    block-rows at the tail (first segment only), then tile-count padding
    up to the next power of two, repeating the *last* tile's coordinates
    with nnz 0 — so the padding joins the last block-row run and adds
    nothing.  ``entry_off`` (per-member edge offsets) enables the
    composite perm.
    """
    k = len(segs)
    nts = np.array([s.n_tiles for s in segs], np.int64)
    nt_members = int(nts.sum())
    n_cov = pad_nodes // T - n_aligned // T if first_segment else 0
    nt = nt_members + n_cov
    nt_bucket = MIN_TILE_BUCKET
    while nt_bucket < nt:
        nt_bucket *= 2
    n_fill = nt_bucket - nt if nt else 0  # an empty composite stays empty

    shift = np.repeat(blk_off[:k], nts)  # per-tile block-diagonal offset
    cov_rows = np.arange(n_aligned // T, pad_nodes // T, dtype=np.int64)[:n_cov]
    tile_row = _cat([s.tile_row for s in segs], [cov_rows], np.int64)
    tile_row[:nt_members] += shift
    tile_col = _cat(
        [s.tile_col for s in segs], [np.zeros(n_cov, np.int64)], np.int64
    )
    tile_col[:nt_members] += shift
    last_r = tile_row[nt - 1] if nt else 0
    last_c = tile_col[nt - 1] if nt else 0
    tile_row = np.concatenate([tile_row, np.full(n_fill, last_r)]).astype(np.int32)
    tile_col = np.concatenate([tile_col, np.full(n_fill, last_c)]).astype(np.int32)

    n_pad = n_cov + n_fill
    rows2 = _cat([s.rows for s in segs], [np.zeros((n_pad, cap))], np.int32)
    cols2 = _cat([s.cols for s in segs], [np.zeros((n_pad, cap))], np.int32)
    vals2 = _cat([s.vals for s in segs], [np.zeros((n_pad, cap))], np.float32)
    nnz2 = _cat([s.nnz_in_tile for s in segs], [np.zeros(n_pad)], np.int32)

    perm = None
    if entry_off is not None:
        perm = np.full((nt + n_fill, cap), -1, np.int32)
        if k:
            pstack = np.concatenate([np.asarray(s.perm, np.int64) for s in segs])
            poff = np.repeat(entry_off[:k], nts)[:, None]
            perm[:nt_members] = np.where(
                pstack >= 0, pstack + poff, -1
            ).astype(np.int32)

    def to(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    return SCVPlan(
        tile_row=to(tile_row),
        tile_col=to(tile_col),
        rows=to(rows2),
        cols=to(cols2),
        vals=to(vals2),
        nnz_in_tile=to(nnz2),
        perm=None if perm is None else to(perm),
        tile=T,
        cap=cap,
        shape=(pad_nodes, pad_nodes),
        order=order,
        runs=RunIndex.of(tile_row, nnz2, device),
    )


def assemble_batched_graph(
    plans: list[Graph],
    tile: int,
    pad_nodes: int,
    with_edges: bool = True,
    device=None,
) -> BatchedGraph:
    """Fuse per-graph plans (on the host) into one block-diagonal plan on
    ``device`` (``None``: the host).

    Member i's tile coordinates shift by ``starts[i] // tile`` and its COO
    rows/cols by ``starts[i]``.  Bucketed members (all on one ladder)
    compose segment by segment into an ``SCVBucketedPlan``; single-cap
    members compose to one ``SCVPlan``.  ``with_edges`` builds the
    composite COO edge arrays + perm, which only GAT reads.
    """
    T = tile
    k = len(plans)
    for g in plans:
        if g.plan.device.type != "cpu":
            raise ValueError(
                "assemble_batched_graph composes host member plans; member "
                f"plan is on {g.plan.device}"
            )
    bucketed = any(isinstance(g.plan, SCVBucketedPlan) for g in plans)
    if bucketed:
        ladders = {g.plan.caps if isinstance(g.plan, SCVBucketedPlan) else (g.plan.cap,)
                   for g in plans}
        if len(ladders) > 1:
            raise ValueError(
                f"member plans disagree on bucket ladder: {sorted(ladders)}"
            )
        ladder = ladders.pop()
    else:
        caps = {g.plan.cap for g in plans}
        if len(caps) > 1:
            raise ValueError(f"member plans disagree on cap: {sorted(caps)}")
        ladder = (caps.pop() if caps else 8,)
    orders = {g.plan.order for g in plans}
    if len(orders) > 1:
        raise ValueError(f"member plans disagree on order: {sorted(orders)}")
    order = orders.pop() if orders else "zmorton"

    starts = np.zeros(k + 1, np.int64)
    for i, g in enumerate(plans):
        if g.plan.tile != T:
            raise ValueError(f"member plan tiled at {g.plan.tile}, engine at {T}")
        starts[i + 1] = starts[i] + -(-g.n_nodes // T) * T
    n_aligned = int(starts[-1])
    pad_nodes = -(-max(pad_nodes, n_aligned) // T) * T
    blk_off = starts // T

    # --- composite COO edge arrays (GAT re-weighting only) ---
    entry_off = None
    erows = ecols = evals = None
    if with_edges:
        for g in plans:
            if g.rows is None or g.plan.perm is None:
                raise ValueError(
                    "with_edges=True needs member plans built with edges/perm"
                )
        edge_counts = np.array([int(g.rows.shape[0]) for g in plans], np.int64)
        entry_off = np.concatenate([[0], np.cumsum(edge_counts)])
        if entry_off[-1] >= 2**31:  # composite perm is i32
            raise ValueError(
                f"composite entry count {entry_off[-1]} overflows the "
                "int32 perm leaf"
            )
        rows = _cat([g.rows for g in plans], [], np.int64)
        cols = _cat([g.cols for g in plans], [], np.int64)
        eshift = np.repeat(starts[:k], edge_counts)
        erows = torch.from_numpy((rows + eshift).astype(np.int32)).to(device)
        ecols = torch.from_numpy((cols + eshift).astype(np.int32)).to(device)
        evals = torch.from_numpy(_cat([g.vals for g in plans], [], np.float32)).to(device)

    def member_segments(g: Graph) -> tuple[SCVPlan, ...]:
        return g.plan.segments if isinstance(g.plan, SCVBucketedPlan) else (g.plan,)

    composed = [
        _assemble_segment(
            [member_segments(g)[j] for g in plans],
            blk_off, n_aligned, pad_nodes, T, cap, order, entry_off,
            first_segment=(j == 0), device=device,
        )
        for j, cap in enumerate(ladder)
    ]
    plan = SCVBucketedPlan(tuple(composed)) if bucketed else composed[0]
    graph = Graph(n_nodes=pad_nodes, plan=plan, rows=erows, cols=ecols, vals=evals)
    return BatchedGraph(
        graph=graph,
        node_offsets=starts,
        node_counts=np.array([g.n_nodes for g in plans], np.int64),
        n_real_nodes=int(sum(g.n_nodes for g in plans)),
    )


def plan_launches(plan) -> int:
    """Kernel launches one aggregation over ``plan`` costs: one for the
    whole chain of capacity segments when a segment holds tiles (the vector
    body takes them all in one launch, ``kernels/scv_spmm/ops.py::_run``;
    the reference launches once per non-empty segment).  A placed plan
    launches, on each of its ``feature_parts`` grid columns, one per span
    whose segments hold an entry (``core.exec.aggregate_sharded`` skips the
    others; the reference counts every segment on every device).  Read
    from leaf shapes and the host run indexes, so it never touches device
    memory.  The forward multiplies by ``GNNConfig.n_layers``."""
    if isinstance(plan, ShardedPlan):
        live = [[s for s in span if s.runs.max_nnz > 0] for span in zip(*plan.segments)]
        return sum(len(chain_groups(len(segs))) for segs in live) * plan.decision.feature_parts
    return chain_launches(plan)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _TrackedGraph:
    """Current state of a delta-tracked graph: the adjacency after every
    applied delta, and the plan-cache key its member plan lives under (the
    delta-chained lineage of its registration-time content key)."""

    adj: COOMatrix
    key: str
    updates_since_anchor: int = 0  # see GraphEngineConfig.anchor_every
    # resolved plan configuration, as of registration or the last anchor
    # (deltas in between may drift the regime); metrics() reports it
    config: Optional[TunedConfig] = None


class GraphServeEngine:
    """Drives GNN models over batches of graph requests on ``device``.

    ``models`` maps a model name to ``(params, GNNConfig)``; the engine
    keeps its own copy of each param tree on its device.  Requests pick a
    model by name and are batched per model (mixed kinds cannot share a
    forward).  ``executor`` places the composites over a shard threshold;
    when a threshold is set and none is given, a ``PlanExecutor`` over
    every CUDA card.  Its pool's first device must be the engine's.
    """

    def __init__(
        self,
        models: dict[str, tuple],
        cfg: Optional[GraphEngineConfig] = None,
        device="cuda",
        executor: Optional[PlanExecutor] = None,
    ):
        self.device = resolve_device(device)
        self.models = {
            name: ({layer: {k: v.to(self.device) for k, v in ps.items()}
                    for layer, ps in params.items()}, mcfg)
            for name, (params, mcfg) in models.items()
        }
        self.cfg = cfg = cfg if cfg is not None else GraphEngineConfig()
        if executor is None and (
            cfg.shard_nodes_threshold is not None or cfg.shard_nnz_threshold is not None
        ):
            executor = PlanExecutor()
        if executor is not None and executor.devices[0] != pool_device(self.device):
            raise ValueError(
                f"the executor's output device {executor.devices[0]} is not the "
                f"engine's {self.device}"
            )
        self.executor = executor
        self.plan_cache = PlanCache(
            max_entries=cfg.cache_entries,
            max_bytes=cfg.cache_bytes,
            max_age_s=cfg.plan_ttl_s,
        )
        self.scheduler = Scheduler(self)
        self.completed: deque[GraphRequest] = deque(maxlen=cfg.completed_history)
        self.failed: deque[GraphRequest] = deque(maxlen=cfg.completed_history)
        self.shed: deque[GraphRequest] = deque(maxlen=cfg.completed_history)
        self.n_completed = 0
        self.n_failed = 0
        self.n_rejected = 0  # AdmissionRejected at submit
        self.last_completed: list[GraphRequest] = []  # from the latest run()
        self.n_batches = 0  # composite waves served
        self.n_sharded_batches = 0  # of those, waves placed by the executor
        self.n_launches = 0  # SCV kernel launches (see plan_launches)
        # unplaced waves' forward, captured once per padding bucket on a CUDA
        # device when the scheduler is idle (eager on the CPU, keys counted
        # all the same)
        self.forward = CapturedForward(defer=True)
        self.serve_seconds = 0.0
        # delta-tracked graphs (see update()): graph_id -> current state
        self._graphs: dict[str, _TrackedGraph] = {}
        self.n_graph_updates = 0
        # host seconds: applying updates, assembling composites on the host
        # (member builds included), copying them to the device (and placing
        # those over a shard threshold)
        self.update_seconds = 0.0
        self.assemble_seconds = 0.0
        self.copy_seconds = 0.0
        # the engine-config literals as one TunedConfig: every wave's
        # layout, or under cfg.autotune the layout of empty graphs only
        self._fallback_config = TunedConfig(
            tile=cfg.tile, bucket_caps=tuple(cfg.bucket_caps), cap=cfg.cap
        )
        self.tuner: Optional[Autotuner] = None
        if cfg.autotune:
            self.tuner = Autotuner(
                store=TuneStore(cfg.autotune_store),
                calibrate=cfg.autotune_calibrate,
                device=self.device,
            )
        self._resolved_configs: dict[str, TunedConfig] = {}
        # submit-side registration and the wave consumer both resolve
        self._tune_lock = threading.Lock()

    def submit(
        self,
        req: GraphRequest,
        *,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> GraphRequest:
        """Validate and enqueue a request; returns it.

        Raises ``AdmissionRejected`` when its ``deadline_s`` is infeasible
        at the current queue depth, and ``EngineOverloaded`` when the
        bounded intake stays full (at once with ``block=False``)."""
        if req.model not in self.models:
            raise KeyError(f"unknown model {req.model!r}; have {list(self.models)}")
        if req.adj is not None:
            # out-of-range indices would land in a neighbour's block of the
            # composite and corrupt co-batched outputs
            check_coo(req.adj, square=True)
            if req.graph_id is not None:
                # (re)register: adj + graph_id resets the tracked state
                self._graphs[req.graph_id] = _TrackedGraph(
                    adj=req.adj,
                    key=self._member_content_key(req.adj),
                    config=self._resolve_config(req.adj),
                )
        elif req.graph_id is None:
            raise ValueError("request needs adj (or a tracked graph_id)")
        else:
            self._tracked(req.graph_id)
        adj = self._resolve_adj(req)
        if req.x is None:
            raise ValueError("request needs node features x")
        if req.x.shape[0] != adj.shape[0]:
            raise ValueError(
                f"features rows {req.x.shape[0]} != nodes {adj.shape[0]}"
            )
        _, mcfg = self.models[req.model]
        if req.x.ndim != 2 or req.x.shape[1] != mcfg.d_in:
            raise ValueError(
                f"features shape {req.x.shape} incompatible with model "
                f"{req.model!r} (d_in={mcfg.d_in})"
            )
        req.t_submit = now = time.monotonic()
        if req.event is None:
            req.event = threading.Event()
        try:
            self.scheduler.admit(req, now)
        except AdmissionRejected:
            self.n_rejected += 1
            raise
        if not self.scheduler.queue.put(req, block=block, timeout=timeout):
            raise EngineOverloaded(
                f"intake queue full ({self.cfg.intake_capacity} requests)"
                + (f" after waiting {timeout}s" if timeout is not None else "")
            )
        return req

    # -- tracked graphs ----------------------------------------------------
    def _tracked(self, graph_id: str) -> _TrackedGraph:
        st = self._graphs.get(graph_id)
        if st is None:
            raise KeyError(
                f"unknown graph_id {graph_id!r}; submit once with adj= to "
                "register it"
            )
        return st

    @property
    def queue(self) -> list[GraphRequest]:
        """Read-only snapshot of the queued requests, as the reference's
        engine gives it.  Intake is owned by the scheduler's
        ``IntakeQueue`` (bounded, thread-safe), so every path goes through
        its admission accounting."""
        return self.scheduler.queue.items()

    def _resolve_config(self, adj: COOMatrix) -> TunedConfig:
        """The plan configuration a wave uses for ``adj``: the tuner's
        resolution for its regime under ``cfg.autotune``, else the
        engine-config fallback.  A store hit costs one tile-nnz histogram."""
        if self.tuner is None or adj.nnz == 0:
            return self._fallback_config
        with self._tune_lock:
            tcfg = self.tuner.tune(adj)
            self._resolved_configs[self.tuner.last_result.key] = tcfg
        return tcfg

    def _member_content_key(self, adj: COOMatrix) -> str:
        tcfg = self._resolve_config(adj)
        return coo_content_key(adj, tile=tcfg.tile, cap=tcfg.cap_signature)

    def _resolve_adj(self, req: GraphRequest) -> COOMatrix:
        """The adjacency a wave serves for ``req``: the tracked graph's
        current state when the request rides a graph_id, else its own.
        Resolved at wave time, so an ``update()`` landing between submit
        and run is served."""
        if req.graph_id is not None:
            return self._graphs[req.graph_id].adj
        return req.adj

    def update(self, graph_id: str, delta: DeltaBatch) -> str:
        """Apply an edge delta to a tracked graph; returns its new plan key.

        With the async loop running, the delta goes through the
        scheduler's control channel and is applied between waves, so a
        patch never runs while a wave reads the same member plan; this
        call blocks until the loop acknowledges, so every request
        submitted after it returns serves the post-delta graph.  Without
        the loop it applies inline.

        ``stream.check_delta`` admits the delta against the tracked
        adjacency; the adjacency advances by ``apply_coo``; a live cached
        member plan is patched on the host by ``stream.apply_delta`` and
        re-keyed under ``delta_key(old, delta)`` (``revalidated``) instead
        of becoming a rebuild.  Composite entries need no invalidation:
        their keys combine the member keys.
        """
        if self.scheduler.running:
            ctrl = _Control(apply=lambda: self._apply_update(graph_id, delta))
            self.scheduler.queue.put_control(ctrl)
            while not ctrl.done.wait(0.05):
                if not self.scheduler.running:
                    # the loop exited between enqueue and apply: drain the
                    # control here (pop_controls is atomic: applied once)
                    self.scheduler._apply_controls()
                    break
            if not ctrl.done.is_set():
                self.scheduler._apply_controls()
            if ctrl.error is not None:
                raise ctrl.error
            return ctrl.result
        return self._apply_update(graph_id, delta)

    def _apply_update(self, graph_id: str, delta: DeltaBatch) -> str:
        t0 = time.perf_counter()
        st = self._tracked(graph_id)
        check_delta(delta, coo=st.adj)
        if len(delta) == 0:
            return st.key
        st.adj = apply_coo(st.adj, delta, check=False)
        st.key = self.plan_cache.revalidate(
            st.key, delta, patch=lambda g: apply_delta(g, delta, check=False)
        )
        self.n_graph_updates += 1
        st.updates_since_anchor += 1
        if self.cfg.anchor_every and st.updates_since_anchor >= self.cfg.anchor_every:
            st.key = self.plan_cache.anchor(st.key, self._member_content_key(st.adj))
            st.config = self._resolve_config(st.adj)
            st.updates_since_anchor = 0
        self.update_seconds += time.perf_counter() - t0
        return st.key

    def tracked_adj(self, graph_id: str) -> COOMatrix:
        """The current adjacency of a tracked graph (after every update)."""
        return self._tracked(graph_id).adj

    # -- plans -------------------------------------------------------------
    def _shard_decision(self, adjs, bucket: int, mcfg):
        """Placement decision for a composite, or None for one device: a
        composite goes to the executor when its padded node count or total
        nnz exceeds a threshold.  A function of the workload numbers and
        the pool only, so equal batches reach the same placement and the
        decision can key the composite cache."""
        if self.executor is None:
            return None
        nnz = sum(a.nnz for a in adjs)
        over = (
            self.cfg.shard_nodes_threshold is not None
            and bucket > self.cfg.shard_nodes_threshold
        ) or (
            self.cfg.shard_nnz_threshold is not None
            and nnz > self.cfg.shard_nnz_threshold
        )
        if not over:
            return None
        # the narrowest width any layer aggregates bounds useful Z-sharding
        n_feat = min(mcfg.d_in, mcfg.d_hidden, mcfg.n_classes)
        decision = self.executor.decide_for(nnz, n_feat, n_rows=bucket)
        return None if decision.kind == "replicated" else decision

    def _batch_plan(self, batch: list[GraphRequest]) -> BatchedGraph:
        """Composite plan for a batch, keyed by member keys so a hot batch
        resolves before any member plan is touched.  Member plans are
        built and cached on the host; the composite is assembled there and
        copied to the engine's device once, then placed by the executor
        when over a shard threshold.  The salt carries the model-kind
        component (edges for GAT only) and the sharding decision
        (``shard=``), so a placed composite is cached placed.

        A tracked member is keyed by its delta-chained key, resolved here
        at wave time with its current adjacency, so a wave after an update
        can never hit a composite from before it."""
        adjs = [self._resolve_adj(r) for r in batch]
        # the scheduler grouped the wave by resolved config, so the head's
        # is every member's
        tcfg = self._resolve_config(adjs[0])
        T = tcfg.tile
        _, mcfg = self.models[batch[0].model]
        with_edges = mcfg.kind == "gat"
        cap_sig = tcfg.cap_signature
        member_keys = [
            self._graphs[r.graph_id].key if r.graph_id is not None
            else coo_content_key(a, tile=T, cap=cap_sig)
            for r, a in zip(batch, adjs)
        ]
        aligned = sum(-(-a.shape[0] // T) * T for a in adjs)
        bucket = _bucket_nodes(aligned, self.cfg.node_buckets, T)
        decision = self._shard_decision(adjs, bucket, mcfg)
        ckey = combine_keys(
            member_keys,
            salt=f"batch;bucket={bucket};tile={T};caps={cap_sig};"
            f"edges={int(with_edges)};"
            f"shard={decision.signature if decision else 'none'};",
        )

        def build() -> BatchedGraph:
            t0 = time.perf_counter()
            plans = [
                self.plan_cache.get_or_build(
                    k, lambda a=a: build_graph(a, config=tcfg, device="cpu")
                )
                for k, a in zip(member_keys, adjs)
            ]
            bg = assemble_batched_graph(plans, T, bucket, with_edges=with_edges)
            if self.cfg.debug_validate:
                validate_plan(bg).raise_if_failed()  # on the host copy
            t1 = time.perf_counter()
            bg = bg.to(self.device)
            if decision is not None:
                bg = dataclasses.replace(bg, graph=self.executor.prepare_graph(
                    bg.graph, decision=decision))
                if self.cfg.debug_validate:
                    validate_plan(bg).raise_if_failed()  # the placement
            self.assemble_seconds += t1 - t0
            self.copy_seconds += time.perf_counter() - t1
            return bg

        return self.plan_cache.get_or_build(ckey, build)

    # -- serving -----------------------------------------------------------
    def run(self) -> list[GraphRequest]:
        """Serve every queued request synchronously; returns the newly
        completed ones (see ``Scheduler.drain`` for failure semantics)."""
        if self.scheduler.running:
            raise RuntimeError(
                "the async scheduler loop is running; use wait_idle() to "
                "block on completion or stop() before sync run()"
            )
        return self.scheduler.drain()

    def _dispatch_wave(self, wave: list[GraphRequest]):
        """Assemble a wave's composite and launch its forward; returns
        ``(bg, out)`` with ``out`` still being computed on the device, so
        the scheduler can assemble the next wave meanwhile."""
        bg = self._batch_plan(wave)
        params, mcfg = self.models[wave[0].model]
        placed = isinstance(bg.graph.plan, ShardedPlan)
        with torch.inference_mode():
            x = batch_features(bg, [r.x for r in wave])
            out = (gnn_forward if placed else self.forward)(params, mcfg, bg.graph, x)
        return bg, out

    def _capture_idle(self, limit: Optional[int] = None) -> int:
        """Capture up to ``limit`` padding buckets whose waves ran eagerly
        so far (the scheduler calls this with no wave queued or in flight);
        returns how many.  Each capture runs the forward once eagerly
        first, and its launches count as the engine's."""
        done = self.forward.capture_pending(limit)
        for mcfg, g in done:
            self.n_launches += plan_launches(g.plan) * mcfg.n_layers
        return len(done)

    def _finish_wave(self, wave, bg, out) -> list[GraphRequest]:
        """Copy a dispatched wave's outputs to the host (the device sync
        point), complete its requests, and account the wave."""
        outs = split_outputs(bg, out)
        self.n_batches += 1
        if isinstance(bg.graph.plan, ShardedPlan):
            self.n_sharded_batches += 1
        _, mcfg = self.models[wave[0].model]
        # every model kind aggregates once per layer
        self.n_launches += plan_launches(bg.graph.plan) * mcfg.n_layers
        now = time.monotonic()
        done = []
        for r, o in zip(wave, outs):
            r.out = o
            r.done = True
            r.t_done = now
            self.completed.append(r)
            self.n_completed += 1
            if r.t_submit:
                self.scheduler.record_latency(now - r.t_submit)
            if r.event is not None:
                r.event.set()
            done.append(r)
        return done

    # -- terminal transitions (called by the scheduler) --------------------
    def _shed_request(self, req: GraphRequest, msg: str) -> None:
        req.error = msg
        self.shed.append(req)
        if req.event is not None:
            req.event.set()

    def _eject_failed(self, req: GraphRequest, msg: str) -> None:
        req.error = msg
        self.failed.append(req)
        self.n_failed += 1
        if req.event is not None:
            req.event.set()

    # -- async lifecycle ---------------------------------------------------
    def start(self) -> None:
        """Start the continuous-batching scheduler loop."""
        self.scheduler.start()

    def stop(self, timeout: Optional[float] = None, drain: bool = True) -> None:
        """Stop the scheduler loop (draining queued work first by default)."""
        self.scheduler.stop(timeout=timeout, drain=drain)

    @property
    def running(self) -> bool:
        return self.scheduler.running

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until the intake queue is empty and no wave is in flight
        (async mode); returns False on timeout."""
        deadline = (
            time.monotonic() + timeout if timeout is not None else None
        )
        sched = self.scheduler
        while (
            sched.queue.depth()
            or sched.queue.has_controls()
            or sched._inflight
        ):
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.002)
        return True

    def metrics(self) -> dict:
        s = self.plan_cache.stats
        sched = self.scheduler
        lat = sched.latency_percentiles()
        return {
            "device": str(self.device),
            "batches": self.n_batches,
            "sharded_batches": self.n_sharded_batches,
            # SCV kernel launches: one per non-empty capacity segment per
            # layer — see plan_launches()
            "launches": self.n_launches,
            "completed": self.n_completed,
            "failed": self.n_failed,
            "shed": sched.n_shed,
            "rejected": self.n_rejected,
            "waves": sched.n_waves,
            "wave_fill": sched.wave_fill,
            "queue_depth": sched.queue.depth(),
            "queue_depth_by_group": sched.queue_depth_by_group(),
            "latency_count": lat["count"],
            "latency_p50_s": lat["p50_s"],
            "latency_p99_s": lat["p99_s"],
            "latency_mean_s": lat["mean_s"],
            "service_ema_s": sched.service_emas(),
            "async_running": sched.running,
            "serve_seconds": self.serve_seconds,
            "plan_cache_hits": s.hits,
            "plan_cache_misses": s.misses,
            "plan_cache_evictions": s.evictions,
            "plan_cache_expired": s.expired,
            "plan_cache_revalidated": s.revalidated,
            "plan_cache_anchored": s.anchored,
            "graph_updates": self.n_graph_updates,
            "tracked_graphs": len(self._graphs),
            "update_seconds": self.update_seconds,
            "assemble_seconds": self.assemble_seconds,
            "copy_seconds": self.copy_seconds,
            # the captured forward of unplaced waves: keys minted, calls
            # replayed, calls run eagerly while their key waited for an idle
            # capture, CUDA graphs captured, bytes copied into the captures'
            # static inputs, host seconds of captures (each with its eager
            # run)
            "forward_captures": self.forward.captures,
            "forward_replays": self.forward.replays,
            "forward_deferred": self.forward.deferred,
            "forward_graphs": self.forward.graphs,
            "forward_copy_bytes": self.forward.copy_bytes,
            "forward_capture_seconds": self.forward.capture_seconds,
            "plan_cache_bytes": s.bytes_in_use,
            "plan_cache_entries": s.entries,
            "plan_cache_hit_rate": s.hit_rate,
            "plan_build_seconds": s.build_seconds,
            # per regime (key = histogram signature x machine fingerprint)
            # the resolved config, and per tracked graph its config as of
            # its registration or last anchor
            "autotune_enabled": self.tuner is not None,
            "autotune_searches": self.tuner.searches if self.tuner else 0,
            "autotune_cache_hits": self.tuner.cache_hits if self.tuner else 0,
            "resolved_configs": {
                k: c.to_json() for k, c in self._resolved_configs.items()
            },
            "tracked_graph_configs": {
                gid: st.config.to_json()
                for gid, st in self._graphs.items()
                if st.config is not None
            },
        }
