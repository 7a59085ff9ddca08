"""Graph serving launcher: the async GNN engine under open-loop load.

    PYTHONPATH=src python -m repro_torch.launch.graph_serve \
        --mode async --rate 150 --requests 200 --device cuda

Port of ``src/repro/launch/graph_serve.py``: the continuously-batched
:class:`GraphServeEngine` behind a Poisson open-loop request generator
(arrivals do not wait for completions, so queueing delay is measured);
``--mode sync`` drains the same workload in synchronous waves.
``--device`` picks where the engine runs (default ``cuda``; it raises
when no GPU is present).
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models.gnn import GNNConfig, init_gnn
from repro_torch.serve.graph_engine import (
    AdmissionRejected,
    EngineOverloaded,
    GraphEngineConfig,
    GraphRequest,
    GraphServeEngine,
)
from repro_torch.simul.datasets import gcn_normalize, powerlaw_graph

#: Hot-graph pool sizes for the default workload — the sparse power-law
#: serving regime the capacity ladder targets.
DEFAULT_POOL_SIZES = (600, 900, 1200, 1500, 2000, 2500)

#: The default workload's model shape (the reference launcher's).
DEFAULT_MODEL = GNNConfig(name="gcn", kind="gcn", d_in=32, d_hidden=64, n_classes=8)


def default_pool(sizes=DEFAULT_POOL_SIZES):
    """Sparse power-law hot-graph pool with GCN-normalized adjacency."""
    return [
        gcn_normalize(powerlaw_graph(n, 3 * n, seed=i))
        for i, n in enumerate(sizes)
    ]


def make_requests(
    rng: np.random.Generator,
    pool,
    n_requests: int,
    d_in: int,
    model: str = "gcn",
    deadline_s: Optional[float] = None,
) -> list[GraphRequest]:
    """A request stream drawn uniformly from the hot-graph pool."""
    reqs = []
    for rid in range(n_requests):
        adj = pool[int(rng.integers(len(pool)))]
        x = rng.standard_normal((adj.shape[0], d_in)).astype(np.float32)
        reqs.append(
            GraphRequest(
                rid=rid, adj=adj, x=x, model=model, deadline_s=deadline_s
            )
        )
    return reqs


def poisson_arrivals(
    rng: np.random.Generator, n: int, rate_hz: float
) -> np.ndarray:
    """Cumulative arrival offsets (seconds) of a Poisson process."""
    if rate_hz <= 0:
        raise ValueError("arrival rate must be positive")
    return np.cumsum(rng.exponential(1.0 / rate_hz, size=n))


class SyncWaveServer:
    """One thread draining the intake queue in synchronous waves
    (``engine.run()``): the baseline serving shape."""

    def __init__(self, engine: GraphServeEngine):
        self.engine = engine
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="graph-serve-sync-waves", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: Optional[float] = None) -> None:
        """Stop after draining everything queued."""
        self._running = False
        self.engine.scheduler.queue.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _loop(self) -> None:
        eng = self.engine
        while True:
            if eng.scheduler.queue.depth():
                try:
                    eng.run()
                except Exception:
                    continue  # failure isolation already requeued/ejected
            elif self._running:
                eng.scheduler.queue.wait_for_work(timeout=0.01)
            else:
                return


def run_open_loop(
    engine: GraphServeEngine,
    requests: list[GraphRequest],
    arrivals: np.ndarray,
    mode: str = "async",
    result_timeout_s: float = 120.0,
) -> dict:
    """Drive ``requests`` at their Poisson ``arrivals`` offsets and block
    until every admitted request reaches a terminal state.  Returns
    latency percentiles over completed requests, throughput from first
    arrival to last completion, and shed/reject counts."""
    if mode not in ("async", "sync"):
        raise ValueError(f"mode must be 'async' or 'sync', got {mode!r}")
    server = None
    if mode == "async":
        engine.start()
    else:
        server = SyncWaveServer(engine)
        server.start()
    submitted: list[GraphRequest] = []
    n_rejected = n_overloaded = 0
    t0 = time.perf_counter()
    try:
        for req, t_arr in zip(requests, arrivals):
            now = time.perf_counter() - t0
            if t_arr > now:
                time.sleep(t_arr - now)
            try:
                engine.submit(req, block=False)
                submitted.append(req)
            except AdmissionRejected:
                n_rejected += 1
            except EngineOverloaded:
                n_overloaded += 1
        deadline = time.monotonic() + result_timeout_s
        for r in submitted:
            if not r.event.wait(max(0.0, deadline - time.monotonic())):
                raise TimeoutError(
                    f"request {r.rid} unfinished after {result_timeout_s}s"
                )
        elapsed = time.perf_counter() - t0
    finally:
        if mode == "async":
            engine.stop(timeout=30.0)
        else:
            server.stop(timeout=30.0)
    done = [r for r in submitted if r.done]
    shed = [r for r in submitted if not r.done]
    lats = np.array([r.latency_s for r in done], np.float64)
    return {
        "mode": mode,
        "offered": len(requests),
        "completed": len(done),
        "shed": len(shed),
        "rejected": n_rejected,
        "overloaded": n_overloaded,
        "elapsed_s": elapsed,
        "graphs_per_s": len(done) / elapsed if elapsed > 0 else 0.0,
        "p50_ms": float(np.percentile(lats, 50) * 1e3) if lats.size else None,
        "p99_ms": float(np.percentile(lats, 99) * 1e3) if lats.size else None,
        "mean_ms": float(lats.mean() * 1e3) if lats.size else None,
        "outputs": {r.rid: r.out for r in done},
    }


def build_default_engine(
    model: GNNConfig = DEFAULT_MODEL, device="cuda", seed: int = 0, executor=None, **cfg_kw
) -> GraphServeEngine:
    """An engine serving ``model`` (registered as ``"gcn"``) with random
    weights from ``seed``, in the default workload's engine config;
    ``executor`` (a ``core.exec.PlanExecutor``) places the composites over
    a ``shard_*_threshold`` given in ``cfg_kw``."""
    params = init_gnn(torch.Generator().manual_seed(seed), model, device=device)
    kw = dict(
        max_batch_graphs=16, max_batch_nodes=8192,
        node_buckets=(2048, 4096, 8192),
    )
    kw.update(cfg_kw)
    return GraphServeEngine(
        {"gcn": (params, model)}, GraphEngineConfig(**kw), device=device, executor=executor
    )


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Async graph serving under Poisson open-loop load."
    )
    ap.add_argument("--mode", choices=["async", "sync"], default="async")
    ap.add_argument("--rate", type=float, default=100.0,
                    help="offered load, requests/second")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request latency budget (0 = none)")
    ap.add_argument("--d-in", type=int, default=DEFAULT_MODEL.d_in)
    ap.add_argument("--max-wave-delay-ms", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on (default cuda)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    pool = default_pool()
    model = GNNConfig(name="gcn", kind="gcn", d_in=args.d_in,
                      d_hidden=DEFAULT_MODEL.d_hidden,
                      n_classes=DEFAULT_MODEL.n_classes)
    engine = build_default_engine(
        model, device=args.device, seed=args.seed,
        max_wave_delay_ms=args.max_wave_delay_ms,
    )
    deadline = args.deadline_ms / 1e3 if args.deadline_ms > 0 else None
    requests = make_requests(
        rng, pool, args.requests, args.d_in, deadline_s=deadline
    )
    arrivals = poisson_arrivals(rng, args.requests, args.rate)

    # warm up off the clock (kernel build, library handles): a serving
    # process is long-lived, so steady-state latency is the regime
    warm = GraphServeEngine(engine.models, engine.cfg, device=args.device)
    for r in make_requests(rng, pool, 24, args.d_in):
        warm.submit(r)
    warm.run()

    stats = run_open_loop(engine, requests, arrivals, mode=args.mode)
    m = engine.metrics()
    print(
        f"{args.mode} on {m['device']}: {stats['completed']}/{stats['offered']} "
        f"completed at {stats['graphs_per_s']:.1f} graphs/s "
        f"(offered {args.rate:.1f}/s)"
    )
    print(
        f"latency p50 {stats['p50_ms']:.1f}ms  p99 {stats['p99_ms']:.1f}ms  "
        f"mean {stats['mean_ms']:.1f}ms"
    )
    print(
        f"waves {m['waves']}  fill {m['wave_fill']:.2f}  "
        f"launches {m['launches']}  shed {m['shed']}  "
        f"rejected {stats['rejected']}  overloaded {stats['overloaded']}"
    )
    return stats


if __name__ == "__main__":
    main()
