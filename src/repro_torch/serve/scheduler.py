"""Continuous-batching scheduler for the graph serving engine.

A copy of ``src/repro/serve/scheduler.py`` (pure Python) for the port.

``GraphServeEngine.run()`` drains its queue in synchronous waves: snapshot
the queue, pack a batch, serve it, repeat.  That shape is fine for a
closed-loop benchmark but hides exactly the cost an open-loop workload
sees — a request arriving one tick after a snapshot waits out the whole
wave before it is even *considered*, and the host sits idle assembling
composites while the device sits idle waiting for them.  This module owns
everything between ``submit()`` and the forward launch:

* **IntakeQueue** — the single thread-safe owner of queued requests.  It
  is deliberately the only place in the serving layer that mutates queue
  state (scvlint SCV007 rejects direct ``self.queue`` mutation anywhere
  else in ``serve/``), because every mutation path must pass through the
  same admission accounting.  The queue is bounded
  (``GraphEngineConfig.intake_capacity``): a full queue blocks or rejects
  the producer — backpressure instead of unbounded memory growth.

* **Wave formation with mid-flight coalescing** — a wave is a set of
  compatible requests (same model, same resolved ``TunedConfig`` group,
  within the graph/node budgets — the same compatibility rule the sync
  path always used).  Unlike the sync snapshot, a *forming* wave keeps
  absorbing compatible arrivals until it reaches
  ``target_wave_size`` graphs or ``max_wave_delay_ms`` has elapsed since
  its first member arrived.  The absorb window overlaps the previous
  wave's device time: the scheduler dispatches wave *n* (CUDA kernel
  launches return before the device finishes), assembles and dispatches
  wave *n+1* host-side, and only then materializes wave *n*'s outputs.

* **Deadline-aware admission control** — requests may carry a relative
  ``deadline_s`` budget.  The scheduler maintains a per-model service-time
  EMA (seconds per wave); ``submit()`` estimates completion from the
  current queue depth and rejects requests that cannot meet their deadline
  (``AdmissionRejected``), and wave formation sheds queued requests whose
  deadline has already become unmeetable (counted separately — a shed
  request was admitted under an estimate that later degraded).

* **Serialized control messages** — ``update(graph_id, delta)`` on a
  running engine is enqueued as a control message and applied by the
  scheduler loop *between* waves, so a delta can never race a wave that
  is concurrently reading the tracked adjacency or revalidating the plan
  cache.  ``update()`` blocks until the scheduler acknowledges, so the
  caller's happens-before is preserved: every request submitted after
  ``update()`` returns serves the post-delta graph.

The synchronous path survives as the degenerate case: ``engine.run()``
calls :meth:`Scheduler.drain`, which forms waves with a zero absorb
window — byte-identical behavior (and failure-isolation semantics) to
the old loop, so every existing parity test keeps passing.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import TYPE_CHECKING, Callable, Optional

import numpy as np

if TYPE_CHECKING:  # import cycle: graph_engine imports this module
    from repro_torch.serve.graph_engine import GraphRequest, GraphServeEngine


class AdmissionRejected(RuntimeError):
    """Request rejected at submit: its deadline cannot be met at the
    current queue depth (estimated from the per-model service-time EMA)."""


class EngineOverloaded(RuntimeError):
    """Request rejected at submit: the bounded intake queue is full and
    the caller asked not to block (backpressure)."""


@dataclasses.dataclass
class _Control:
    """A serialized control message (currently: tracked-graph delta
    update).  ``apply`` runs in the scheduler loop between waves; the
    submitting thread blocks on ``done`` and reads ``result``/``error``."""

    apply: Callable[[], object]
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: object = None
    error: Optional[BaseException] = None


# ---------------------------------------------------------------------------
# intake queue
# ---------------------------------------------------------------------------
class IntakeQueue:
    """Bounded, thread-safe request intake — the single owner of queued
    serving state.

    Producers call :meth:`put` (blocking, timed, or failing fast when the
    queue is full); the single consumer (the scheduler loop, or the sync
    drain) reads a :meth:`snapshot` and commits the requests it took with
    :meth:`commit`.  Requeueing after a failed wave goes through
    :meth:`requeue`, which is exempt from the capacity bound — a failed
    wave's requests were already admitted once and must not be dropped by
    backpressure on their way back in.
    """

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("intake capacity must be positive")
        self.capacity = capacity
        self._items: list["GraphRequest"] = []
        self._controls: list[_Control] = []
        self._cond = threading.Condition()

    # -- producer side -----------------------------------------------------
    def put(
        self,
        req: "GraphRequest",
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> bool:
        """Enqueue; returns False (without enqueueing) if the queue stayed
        full for the whole wait — the caller turns that into
        ``EngineOverloaded``."""
        with self._cond:
            if len(self._items) >= self.capacity:
                if not block:
                    return False
                ok = self._cond.wait_for(
                    lambda: len(self._items) < self.capacity, timeout=timeout
                )
                if not ok:
                    return False
            self._items.append(req)
            self._cond.notify_all()
            return True

    def put_control(self, ctrl: _Control) -> None:
        """Control messages bypass the capacity bound: an update must not
        deadlock behind the very backlog it may be needed to unblock."""
        with self._cond:
            self._controls.append(ctrl)
            self._cond.notify_all()

    # -- consumer side -----------------------------------------------------
    def requeue(self, reqs: list["GraphRequest"]) -> None:
        """Push requests back at the *front* (failure isolation / interrupt
        restore); exempt from the capacity bound."""
        with self._cond:
            self._items[:0] = reqs
            self._cond.notify_all()

    def snapshot(self) -> tuple[list["GraphRequest"], int]:
        """Current items plus the length to pass back to :meth:`commit`."""
        with self._cond:
            return list(self._items), len(self._items)

    def commit(self, n_snapshot: int, remaining: list["GraphRequest"]) -> None:
        """Replace the first ``n_snapshot`` items with ``remaining`` (the
        ones the consumer did not take); items that arrived after the
        snapshot are preserved in order.  Single-consumer discipline makes
        this safe: only the scheduler removes items."""
        with self._cond:
            self._items[:n_snapshot] = remaining
            self._cond.notify_all()

    def pop_controls(self) -> list[_Control]:
        with self._cond:
            out, self._controls = self._controls, []
            return out

    def wait_for_work(self, timeout: Optional[float]) -> bool:
        with self._cond:
            return self._cond.wait_for(
                lambda: self._items or self._controls, timeout=timeout
            )

    # -- introspection -----------------------------------------------------
    def depth(self) -> int:
        with self._cond:
            return len(self._items)

    def has_controls(self) -> bool:
        with self._cond:
            return bool(self._controls)

    def __len__(self) -> int:
        return self.depth()

    def items(self) -> list["GraphRequest"]:
        with self._cond:
            return list(self._items)

    def notify_all(self) -> None:
        with self._cond:
            self._cond.notify_all()


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------
class Scheduler:
    """Owns wave formation, admission, and the async serving loop.

    One instance per engine.  All device work and all tracked-graph /
    plan-cache mutation happens on a single thread (the caller's thread in
    sync :meth:`drain` mode, the loop thread in async mode) — concurrency
    lives entirely in the intake queue and per-request completion events.
    """

    def __init__(self, engine: "GraphServeEngine"):
        self.engine = engine
        cfg = engine.cfg
        self.queue = IntakeQueue(cfg.intake_capacity)
        self.target_wave = min(
            cfg.target_wave_size or cfg.max_batch_graphs, cfg.max_batch_graphs
        )
        self.max_wave_delay_s = cfg.max_wave_delay_ms / 1e3
        self._ema_alpha = cfg.service_ema_alpha
        self._ema: dict[str, float] = {}  # model -> seconds per wave
        self._lat = deque(maxlen=cfg.latency_window)  # completed latencies
        self._stats_lock = threading.Lock()
        self.n_waves = 0
        self.n_shed = 0
        self._fill_sum = 0.0  # sum of per-wave fill ratios
        # async loop state
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._inflight = False  # a dispatched wave awaits materialization
        self.interrupt: Optional[BaseException] = None  # stashed KI from loop

    # -- admission ---------------------------------------------------------
    def service_estimate(self, model: str) -> Optional[float]:
        """EMA of wave service seconds for ``model`` (None before the
        first completed wave)."""
        with self._stats_lock:
            return self._ema.get(model)

    def _observe_service(self, model: str, seconds: float) -> None:
        with self._stats_lock:
            prev = self._ema.get(model)
            self._ema[model] = (
                seconds if prev is None
                else (1 - self._ema_alpha) * prev + self._ema_alpha * seconds
            )

    def service_emas(self) -> dict[str, float]:
        """Copy of the per-model wave service-time EMAs (seconds)."""
        with self._stats_lock:
            return dict(self._ema)

    def record_latency(self, seconds: float) -> None:
        with self._stats_lock:
            self._lat.append(seconds)

    def latency_percentiles(self) -> dict:
        with self._stats_lock:
            lat = np.asarray(self._lat, np.float64)
        if lat.size == 0:
            return {"count": 0, "p50_s": None, "p99_s": None, "mean_s": None}
        return {
            "count": int(lat.size),
            "p50_s": float(np.percentile(lat, 50)),
            "p99_s": float(np.percentile(lat, 99)),
            "mean_s": float(lat.mean()),
        }

    def admit(self, req: "GraphRequest", now: float) -> None:
        """Deadline feasibility check at submit time.

        Estimated completion = now + (waves ahead of this request,
        including the one it would join and any in-flight wave) x the
        model's service EMA.  Optimistic before the first observation
        (no EMA -> admit); an estimate that later degrades is handled by
        shedding at wave-formation time instead.
        """
        if req.deadline_s is None:
            return
        ema = self.service_estimate(req.model)
        if ema is None:
            return
        depth = self.queue.depth()
        waves_ahead = -(-(depth + 1) // self.engine.cfg.max_batch_graphs)
        if self._inflight:
            waves_ahead += 1
        est_done = now + waves_ahead * ema
        if est_done > now + req.deadline_s:
            raise AdmissionRejected(
                f"deadline {req.deadline_s * 1e3:.1f}ms infeasible: "
                f"{depth} queued ({waves_ahead} wave(s) ahead) at "
                f"~{ema * 1e3:.1f}ms/wave for model {req.model!r}"
            )

    # -- wave formation ----------------------------------------------------
    def _shed_expired(
        self, items: list["GraphRequest"], now: float
    ) -> list["GraphRequest"]:
        """Drop queued requests whose deadline can no longer be met (the
        queue-depth estimate at admission has degraded).  Shed requests
        complete with an error and land in ``engine.shed``."""
        keep = []
        for r in items:
            if r.deadline_s is None or r.isolate:
                keep.append(r)
                continue
            ema = self.service_estimate(r.model) or 0.0
            t_deadline = r.t_submit + r.deadline_s
            if now + ema > t_deadline:
                self.engine._shed_request(
                    r,
                    f"deadline shed: {(now - r.t_submit) * 1e3:.1f}ms queued "
                    f"of a {r.deadline_s * 1e3:.1f}ms budget "
                    f"(~{ema * 1e3:.1f}ms/wave)",
                )
                with self._stats_lock:
                    self.n_shed += 1
            else:
                keep.append(r)
        return keep

    def _pick_wave(
        self, items: list["GraphRequest"]
    ) -> tuple[list["GraphRequest"], list["GraphRequest"]]:
        """Greedy in-arrival-order pack over ``items`` — the sync path's
        historical rule, verbatim: same model kind, same resolved plan
        config (under autotune), bounded graph and node counts; an
        isolated head is served alone; the head is always admitted."""
        eng = self.engine
        head = items[0]
        if head.isolate:
            return [head], items[1:]
        head_cfg = eng._resolve_config(eng._resolve_adj(head))
        T = head_cfg.tile
        batch: list[GraphRequest] = []
        nodes = 0
        remaining = []
        for r in items:
            fits = (
                not r.isolate
                and r.model == head.model
                and len(batch) < eng.cfg.max_batch_graphs
            )
            if fits and eng.tuner is not None:
                fits = eng._resolve_config(eng._resolve_adj(r)) == head_cfg
            if fits:
                aligned = -(-eng._resolve_adj(r).shape[0] // T) * T
                fits = not batch or nodes + aligned <= eng.cfg.max_batch_nodes
            if fits:
                batch.append(r)
                nodes += aligned
            else:
                remaining.append(r)
        return batch, remaining

    def form_wave(self, absorb: bool) -> list["GraphRequest"]:
        """Take the next wave off the intake queue.

        With ``absorb=False`` (sync drain) this is exactly the historical
        snapshot pack.  With ``absorb=True`` a wave smaller than
        ``target_wave_size`` keeps the queue position open and absorbs
        compatible arrivals until ``max_wave_delay_ms`` has elapsed since
        formation started — continuous batching instead of snapshotting.
        """
        t_start = time.monotonic()
        items, n = self.queue.snapshot()
        if not items:
            return []
        items = self._shed_expired(items, t_start)
        if not items:
            self.queue.commit(n, [])
            return []
        wave, remaining = self._pick_wave(items)
        self.queue.commit(n, remaining)
        if not absorb or wave[0].isolate:
            self._record_fill(wave)
            return wave
        # mid-flight absorb: keep topping the wave up with compatible
        # arrivals until it is full or the delay budget is spent
        while len(wave) < self.target_wave:
            elapsed = time.monotonic() - t_start
            budget = self.max_wave_delay_s - elapsed
            if budget <= 0:
                break
            if not self.queue.wait_for_work(timeout=budget):
                break
            if self.queue.has_controls():
                break  # controls are serialized with waves: apply first
            items, n = self.queue.snapshot()
            if not items:
                continue
            grown, remaining = self._pick_wave(wave + items)
            if len(grown) <= len(wave):
                break  # head-compatible arrivals exhausted
            # _pick_wave keeps arrival order, so the existing wave is a
            # prefix of the grown wave; commit removes only the new picks
            # (identity, not ==: requests hold numpy leaves)
            taken = {id(r) for r in wave}
            self.queue.commit(n, [r for r in remaining if id(r) not in taken])
            wave = grown
        self._record_fill(wave)
        return wave

    def _record_fill(self, wave: list["GraphRequest"]) -> None:
        with self._stats_lock:
            self.n_waves += 1
            self._fill_sum += len(wave) / self.target_wave

    @property
    def wave_fill(self) -> float:
        """Mean wave fill ratio (graphs per wave / target_wave_size)."""
        with self._stats_lock:
            return self._fill_sum / self.n_waves if self.n_waves else 0.0

    # -- failure handling (shared by sync drain and async loop) ------------
    def _fail_wave(self, batch: list["GraphRequest"], e: Exception) -> None:
        """Failure isolation: survivors requeue isolated (served alone
        next wave, so one bad member cannot keep failing a whole wave);
        a request that exhausts ``max_retries`` is ejected to
        ``engine.failed`` with the error recorded."""
        eng = self.engine
        survivors = []
        for r in batch:
            r.retries += 1
            if r.retries > eng.cfg.max_retries:
                eng._eject_failed(r, f"{type(e).__name__}: {e}")
            else:
                r.isolate = True
                survivors.append(r)
        self.queue.requeue(survivors)

    # -- synchronous drain (engine.run()) ----------------------------------
    def drain(self) -> list["GraphRequest"]:
        """The degenerate single-consumer path behind ``engine.run()``:
        form waves with no absorb window and serve until the queue is
        empty.  Exception semantics are the historical ones — failures
        isolate/eject and re-raise, interrupts restore the wave untouched
        and consume no retries.  Once the queue is empty the engine
        captures the padding buckets its waves ran eagerly (after every
        request completed: within ``run()``'s time, outside any latency)."""
        eng = self.engine
        t0 = time.perf_counter()
        done = eng.last_completed = []
        try:
            while self.queue.depth():
                wave = self.form_wave(absorb=False)
                if not wave:
                    continue  # everything shed
                try:
                    bg, out = eng._dispatch_wave(wave)
                    done.extend(eng._finish_wave(wave, bg, out))
                except BaseException as e:
                    if not isinstance(e, Exception):
                        # interrupts are not request failures: restore the
                        # wave untouched, consume no retries
                        self.queue.requeue(wave)
                        raise
                    self._fail_wave(wave, e)
                    raise
            eng._capture_idle()
            return done
        finally:
            eng.serve_seconds += time.perf_counter() - t0

    # -- async loop --------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("scheduler loop already running")
        self.interrupt = None
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="graph-serve-scheduler", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: Optional[float] = None, drain: bool = True) -> None:
        """Stop the loop.  With ``drain=True`` (default) the loop first
        serves everything already queued; pending work survives either way
        (the intake queue is engine state, not loop state).  Re-raises an
        interrupt (e.g. KeyboardInterrupt) the loop stashed."""
        self._drain_on_stop = drain
        self._running = False
        self.queue.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if self.interrupt is not None:
            err, self.interrupt = self.interrupt, None
            raise err

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _apply_controls(self) -> None:
        for ctrl in self.queue.pop_controls():
            try:
                ctrl.result = ctrl.apply()
            except BaseException as e:
                ctrl.error = e
            finally:
                ctrl.done.set()

    def _loop(self) -> None:
        """The continuous-batching pipeline.

        Invariant: at most one dispatched-but-unmaterialized wave
        (``inflight``).  Each iteration applies pending controls, forms
        the next wave (its absorb window overlapping the in-flight wave's
        device time), dispatches it, and only then materializes the
        previous wave's outputs — host-side assembly of wave *n+1* runs
        while the device executes wave *n*.
        """
        eng = self.engine
        inflight: Optional[tuple] = None  # (wave, bg, out, t_wave_start)
        self._drain_on_stop = True
        while True:
            self._apply_controls()
            if not self._running:
                if not self._drain_on_stop:
                    break
                if not self.queue.depth() and inflight is None:
                    break
            t_wave = time.perf_counter()
            busy = self.queue.depth() > 0
            if busy:
                # raised *before* formation commits the queue take, so
                # wait_idle() never observes the window where a wave is
                # neither queued nor marked in flight
                self._inflight = True
            # no absorb window while draining to a stop — nothing new is
            # worth waiting for, just flush
            wave = self.form_wave(absorb=self._running) if busy else []
            dispatched = None
            if wave:
                try:
                    bg, out = eng._dispatch_wave(wave)
                    dispatched = (wave, bg, out, t_wave)
                except BaseException as e:
                    if not isinstance(e, Exception):
                        # interrupt: restore the wave untouched, stop the
                        # loop, surface the exception from stop()
                        self.queue.requeue(wave)
                        self.interrupt = e
                        self._running = False
                        self._drain_on_stop = False
                        dispatched = None
                    else:
                        self._fail_wave(wave, e)
            if inflight is not None:
                self._retire(inflight)
                inflight = None
            inflight = dispatched
            self._inflight = inflight is not None
            if inflight is None and not self.queue.depth():
                if not self._running:
                    continue  # loop once more to hit the exit check
                # idle: capture one padding bucket served eagerly so far,
                # then look at the queue again
                if not eng._capture_idle(limit=1):
                    self.queue.wait_for_work(timeout=0.05)

    def _retire(self, inflight: tuple) -> None:
        """Materialize a dispatched wave's outputs (blocks on the device),
        complete its requests, and fold the wave's wall time into the
        service EMA.  Materialization errors are request failures too —
        a fault of an asynchronously launched CUDA kernel surfaces here."""
        wave, bg, out, t_wave = inflight
        eng = self.engine
        try:
            eng._finish_wave(wave, bg, out)
        except BaseException as e:
            if not isinstance(e, Exception):
                self.queue.requeue(wave)
                self.interrupt = e
                self._running = False
                self._drain_on_stop = False
                return
            self._fail_wave(wave, e)
            return
        finally:
            dt = time.perf_counter() - t_wave
            eng.serve_seconds += dt
        self._observe_service(wave[0].model, time.perf_counter() - t_wave)

    # -- introspection -----------------------------------------------------
    def queue_depth_by_group(self) -> dict[str, int]:
        """Queued requests per (model, padding-bucket) group — the
        coalescing granularity.  Buckets use the engine's fallback tile
        (per-request autotune resolution would make metrics() O(nnz))."""
        from repro_torch.serve.graph_engine import _bucket_nodes

        eng = self.engine
        T = eng._fallback_config.tile
        out: dict[str, int] = {}
        for r in self.queue.items():
            aligned = -(-eng._resolve_adj(r).shape[0] // T) * T
            b = _bucket_nodes(aligned, eng.cfg.node_buckets, T)
            key = f"{r.model}:n{b}"
            out[key] = out.get(key, 0) + 1
        return out
