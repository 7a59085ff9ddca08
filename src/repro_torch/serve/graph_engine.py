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
  there.  The composite's run index is computed here, on the host, from
  the composite schedule.
* **Padding buckets** — composite node counts round up to a fixed ladder,
  and tile counts to powers of two, so composites come in few shapes.
* **Scheduling** — ``serve/scheduler.py`` owns intake, wave formation,
  deadline admission and the async loop (``start()`` / ``stop()``).

The engine runs on ``device`` (default ``"cuda"``; it raises when no GPU
is present, and the tests pass ``device="cpu"``).  Delta updates,
multi-device routing, autotuned layouts and debug validation come with
later slices of the port; :class:`GraphEngineConfig` refuses them.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core.formats import COOMatrix
from repro_torch.core.scv import (
    DEFAULT_CAP,
    DEFAULT_LADDER,
    DEFAULT_TILE,
    RunIndex,
    SCVBucketedPlan,
    SCVPlan,
)
from repro_torch.core.validate import check_coo
from repro_torch.device import resolve_device
from repro_torch.models.gnn import (
    BatchedGraph,
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
)
from repro_torch.tune.config import TunedConfig

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
    """One inference request: run ``model`` over (adj, x)."""

    rid: int
    adj: Optional[COOMatrix] = None  # normalized adjacency (e.g. gcn_normalize)
    x: Optional[np.ndarray] = None  # f32[n_nodes, d_in]
    model: str = "default"
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


#: GraphEngineConfig fields the port does not serve yet -> the slice that
#: brings each (ROADMAP.md, "Modules to port").
_LATER_SLICES = {
    "autotune": "the simulator/tuner slice (tune/autotuner.py)",
    "shard_nodes_threshold": "the sharding slice (core/exec.py)",
    "shard_nnz_threshold": "the sharding slice (core/exec.py)",
    "debug_validate": "the checks slice (core/validate.py::validate_plan)",
}


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
    # --- options of the reference that later slices of the port bring ---
    autotune: bool = False
    shard_nodes_threshold: Optional[int] = None
    shard_nnz_threshold: Optional[int] = None
    debug_validate: bool = False

    def __post_init__(self):
        for field, slice_name in _LATER_SLICES.items():
            if getattr(self, field) not in (None, False):
                raise ValueError(
                    f"{field} is not in the PyTorch port yet; it comes with "
                    f"{slice_name}"
                )
        for field in ("max_batch_graphs", "max_batch_nodes", "tile", "cap"):
            if getattr(self, field) <= 0:
                raise ValueError(f"{field} must be positive")
        if self.bucket_caps:
            caps = tuple(int(c) for c in self.bucket_caps)
            if list(caps) != sorted(set(caps)) or caps[0] <= 0:
                raise ValueError(
                    f"bucket_caps must be ascending distinct positives, got {caps}"
                )
        if self.completed_history < 0:
            raise ValueError("completed_history must be >= 0")
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
    nt_bucket = 8
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
    """Kernel launches one aggregation over ``plan`` costs: one per
    non-empty capacity segment (empty segments are skipped at dispatch —
    ``kernels/scv_spmm/ops.scv_spmm_plan``).  Read from leaf shapes, so it
    never touches device memory.  The forward multiplies by
    ``GNNConfig.n_layers``."""
    segments = getattr(plan, "segments", (plan,))
    return sum(1 for s in segments if s.n_tiles > 0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
class GraphServeEngine:
    """Drives GNN models over batches of graph requests on ``device``.

    ``models`` maps a model name to ``(params, GNNConfig)``; the engine
    keeps its own copy of each param tree on its device.  Requests pick a
    model by name and are batched per model (mixed kinds cannot share a
    forward).
    """

    def __init__(
        self,
        models: dict[str, tuple],
        cfg: Optional[GraphEngineConfig] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.models = {
            name: ({layer: {k: v.to(self.device) for k, v in ps.items()}
                    for layer, ps in params.items()}, mcfg)
            for name, (params, mcfg) in models.items()
        }
        self.cfg = cfg = cfg if cfg is not None else GraphEngineConfig()
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
        self.n_launches = 0  # SCV kernel launches (see plan_launches)
        self.serve_seconds = 0.0
        # the plan layout of every wave (per-graph tuned layouts come with
        # the autotune slice)
        self.layout = TunedConfig(
            tile=cfg.tile, bucket_caps=tuple(cfg.bucket_caps), cap=cfg.cap
        )

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
        if req.adj is None:
            raise ValueError("request needs adj")
        # out-of-range indices would land in a neighbour's block of the
        # composite and corrupt co-batched outputs
        check_coo(req.adj, square=True)
        if req.x is None:
            raise ValueError("request needs node features x")
        if req.x.shape[0] != req.adj.shape[0]:
            raise ValueError(
                f"features rows {req.x.shape[0]} != nodes {req.adj.shape[0]}"
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

    # -- plans -------------------------------------------------------------
    def _batch_plan(self, batch: list[GraphRequest]) -> BatchedGraph:
        """Composite plan for a batch, keyed by member content hashes so a
        hot batch resolves before any member plan is touched.  Member
        plans are built and cached on the host; the composite is assembled
        there and copied to the engine's device once.  The salt carries
        the model-kind component (edges for GAT only)."""
        adjs = [r.adj for r in batch]
        tcfg = self.layout
        T = tcfg.tile
        _, mcfg = self.models[batch[0].model]
        with_edges = mcfg.kind == "gat"
        cap_sig = tcfg.cap_signature
        member_keys = [coo_content_key(a, tile=T, cap=cap_sig) for a in adjs]
        aligned = sum(-(-a.shape[0] // T) * T for a in adjs)
        bucket = _bucket_nodes(aligned, self.cfg.node_buckets, T)
        ckey = combine_keys(
            member_keys,
            salt=f"batch;bucket={bucket};tile={T};caps={cap_sig};"
            f"edges={int(with_edges)};",
        )

        def build() -> BatchedGraph:
            plans = [
                self.plan_cache.get_or_build(
                    k, lambda a=a: build_graph(a, config=tcfg, device="cpu")
                )
                for k, a in zip(member_keys, adjs)
            ]
            return assemble_batched_graph(
                plans, T, bucket, with_edges=with_edges, device=self.device
            )

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
        with torch.inference_mode():
            out = gnn_forward(
                params, mcfg, bg.graph, batch_features(bg, [r.x for r in wave])
            )
        return bg, out

    def _finish_wave(self, wave, bg, out) -> list[GraphRequest]:
        """Copy a dispatched wave's outputs to the host (the device sync
        point), complete its requests, and account the wave."""
        outs = split_outputs(bg, out)
        self.n_batches += 1
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
            "plan_cache_bytes": s.bytes_in_use,
            "plan_cache_entries": s.entries,
            "plan_cache_hit_rate": s.hit_rate,
            "plan_build_seconds": s.build_seconds,
        }
