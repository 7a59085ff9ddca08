"""Two-stage autotuner: simulator-pruned search, measured calibration.

Port of ``src/repro/tune/autotuner.py``.  Stage 1 is the reference's: it
scores every candidate ``(T, C, dense-threshold-ratio, ladder)``
analytically — :func:`repro_torch.tune.cost.predict_cost`
(``run_scv_bucketed`` cycles + slot-priced traffic + per-launch overhead)
plus two kernel-body terms the plan-level model cannot see (chunk-step
overhead/padding and the MXU/VPU crossover of the dense-tile split) — and
gives the reference's candidates, in its order, with its scores.  One
simulator run per distinct tile is shared across every ladder at that
tile, so the sweep is O(tiles) simulator passes, not O(candidates).

Stage 2 is the port's own.  It builds real plans for the top-``k``
surviving ``(T, ladder)`` pairs — the hand-picked default always rides
along as a control — on the tuner's ``device`` and times
``core.aggregate.aggregate_scv_plan`` over them: on a card, the
hand-written SCV kernel chain the engine serves, each call between two
CUDA events; on the CPU, the plain version under the host clock.  (The
reference times its jnp oracle here.)  A kernel that fails to build or
launch fails the tune; nothing falls back to the plain version.  The
measured winner becomes the :class:`TunedConfig`, cached in a
:class:`TuneStore` keyed by quantized histogram signature x machine
fingerprint, which names the torch device (see ``signature.py``).  With
``calibrate=False`` the stage-1 winner is returned directly — the cheap
mode the serve engine uses at admission time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.aggregate import aggregate_scv_plan
from repro_torch.core.formats import COOMatrix
from repro_torch.core.scv import (
    MXU_VPU_RATIO,
    bucket_caps_for,
    coo_to_scv_tiles,
    plan_from_tiles_bucketed,
    tile_nnz_histogram,
)
from repro_torch.device import resolve_device
from repro_torch.simul.dataflows import run_scv_bucketed
from repro_torch.simul.machine import MachineConfig
from repro_torch.tune.config import TunedConfig
from repro_torch.tune.cost import CLOCK_HZ, CostEstimate, predict_cost
from repro_torch.tune.signature import cache_key, histogram_signature, machine_fingerprint
from repro_torch.tune.store import TuneStore

#: Fixed per-chunk-step cost of the vectorized kernel body, in
#: entry-equivalents (grid bookkeeping + scatter/gather setup per step).
CHUNK_STEP_ENTRIES = 64

#: Candidate tiles, the reference's: powers of two around the TPU's lane
#: width.  Stage 2 measures each on the port's device.
TILE_CANDIDATES = (32, 64, 128)
CHUNK_CANDIDATES = (64, 128, 256)
RATIO_CANDIDATES = (MXU_VPU_RATIO / 2, MXU_VPU_RATIO, MXU_VPU_RATIO * 2)


@dataclasses.dataclass(frozen=True)
class ScoredCandidate:
    config: TunedConfig
    estimate: CostEstimate
    score_s: float  # estimate.seconds + chunk + dense terms
    measured_s: Optional[float] = None

    def to_json(self) -> dict:
        return {
            "config": self.config.to_json(),
            "predicted_s": self.score_s,
            "measured_s": self.measured_s,
            "estimate": self.estimate.to_json(),
        }


@dataclasses.dataclass
class TuneResult:
    key: str
    config: TunedConfig
    cached: bool
    candidates: list = dataclasses.field(default_factory=list)
    calibrated: list = dataclasses.field(default_factory=list)
    rank_correlation: Optional[float] = None
    search_seconds: float = 0.0


def spearman(xs, ys) -> float:
    """Spearman rank correlation (average ranks on ties)."""
    if len(xs) < 2:
        return 1.0
    rx = _ranks(xs)
    ry = _ranks(ys)
    sx, sy = np.std(rx), np.std(ry)
    if sx == 0 or sy == 0:
        return 0.0
    return float(np.corrcoef(rx, ry)[0, 1])


def _ranks(xs) -> np.ndarray:
    xs = np.asarray(xs, dtype=np.float64)
    order = np.argsort(xs, kind="stable")
    ranks = np.empty(len(xs), dtype=np.float64)
    ranks[order] = np.arange(len(xs), dtype=np.float64)
    for v in np.unique(xs):
        mask = xs == v
        ranks[mask] = ranks[mask].mean()
    return ranks


def candidate_ladders(counts: np.ndarray, tile: int) -> tuple[tuple[int, ...], ...]:
    """Contiguous sub-ladders of the derived full ladder for ``tile``.

    ``bucket_caps_for`` gives the max-depth ladder; shallower contiguous
    slices trade dummy/padding slots against launch count.  Chain-splitting at ``caps[-1]`` makes
    every slice valid regardless of the heaviest tile.
    """
    full = bucket_caps_for(counts, tile)
    out = []
    for i in range(len(full)):
        for j in range(i + 1, len(full) + 1):
            out.append(full[i:j])
    return tuple(dict.fromkeys(out))


class Autotuner:
    """Search and cache.  Thread a shared :class:`TuneStore` through
    several tuners (or processes) to share the on-disk cache.  ``device``
    (default ``"cuda"``; raises without a card) is where stage 2 measures
    and what the cache key names."""

    def __init__(
        self,
        machine: Optional[MachineConfig] = None,
        store: Optional[TuneStore] = None,
        *,
        tiles: tuple[int, ...] = TILE_CANDIDATES,
        chunks: tuple[int, ...] = CHUNK_CANDIDATES,
        ratios: tuple[float, ...] = RATIO_CANDIDATES,
        top_k: int = 3,
        calibrate: bool = True,
        calib_reps: int = 2,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.machine = machine if machine is not None else MachineConfig()
        self.store = store if store is not None else TuneStore()
        self.tiles = tuple(tiles)
        self.chunks = tuple(chunks)
        self.ratios = tuple(ratios)
        self.top_k = int(top_k)
        self.calibrate = bool(calibrate)
        self.calib_reps = int(calib_reps)
        self.searches = 0
        self.cache_hits = 0
        self.last_result: Optional[TuneResult] = None

    # -- public entry ------------------------------------------------------
    def tune(self, adj: COOMatrix, n_features: int = 64) -> TunedConfig:
        """Resolve the config for ``adj``: cache hit, or two-stage search."""
        if adj.nnz == 0:
            return TunedConfig.default()
        counts_ref = tile_nnz_histogram(adj, TunedConfig.default().tile)
        key = cache_key(
            histogram_signature(counts_ref),
            machine_fingerprint(self.machine, self.device),
        )
        hit = self.store.get(key)
        if hit is not None:
            self.cache_hits += 1
            self.last_result = TuneResult(key=key, config=hit, cached=True)
            return hit
        t0 = time.perf_counter()
        self.searches += 1
        scored = self._stage1(adj, n_features)
        result = TuneResult(key=key, config=scored[0].config, cached=False)
        result.candidates = scored
        if self.calibrate:
            calibrated = self._stage2(adj, scored, n_features)
            result.calibrated = calibrated
            winner = min(calibrated, key=lambda c: c.measured_s)
            result.rank_correlation = spearman(
                [c.score_s for c in calibrated],
                [c.measured_s for c in calibrated],
            )
            result.config = dataclasses.replace(winner.config, source="calibrated")
        else:
            result.config = dataclasses.replace(scored[0].config, source="simulated")
        result.search_seconds = time.perf_counter() - t0
        self.store.put(
            key,
            result.config,
            meta={
                "n_candidates": len(scored),
                "n_calibrated": len(result.calibrated),
                "rank_correlation": result.rank_correlation,
                "search_seconds": result.search_seconds,
            },
        )
        self.last_result = result
        return result.config

    # -- stage 1: analytic prune ------------------------------------------
    def _stage1(self, adj: COOMatrix, n_features: int) -> list[ScoredCandidate]:
        scored = []
        default = TunedConfig.default()
        for tile in self.tiles:
            counts = tile_nnz_histogram(adj, tile)
            base = run_scv_bucketed(
                adj, n_features, self.machine, tile,
                caps=bucket_caps_for(counts, tile),
            )
            ladders = candidate_ladders(counts, tile)
            if tile == default.tile and default.bucket_caps not in ladders:
                ladders = ladders + (default.bucket_caps,)
            for caps in ladders:
                chunk = self._best_chunk(counts, tile, caps, n_features)
                ratio = self._best_ratio(counts, tile, n_features)
                cfg = TunedConfig(
                    tile=tile,
                    chunk=chunk,
                    dense_threshold_ratio=ratio,
                    bucket_caps=caps,
                )
                est = predict_cost(
                    adj, cfg, n_features, machine=self.machine, compute=base
                )
                score = (
                    est.seconds
                    + self._chunk_term(counts, tile, caps, chunk, n_features)
                    + self._dense_term(counts, tile, ratio, n_features)
                )
                scored.append(ScoredCandidate(cfg, est, score))
        scored.sort(key=lambda c: c.score_s)
        return scored

    def _entry_seconds(self, n_features: int) -> float:
        """One VPU entry-update in seconds: ceil(F / N_PE) cycles."""
        return -(-n_features // self.machine.n_pe) / CLOCK_HZ

    def _chunk_term(self, counts, tile, caps, chunk, n_features) -> float:
        """Chunk-step overhead + intra-chunk padding of the kernel body.

        A tile at cap ``c`` runs ``ceil(c / C)`` steps; each step costs a
        fixed ``CHUNK_STEP_ENTRIES`` bookkeeping charge and processes a
        full ``C``-wide chunk, so work is ``steps * (C +
        CHUNK_STEP_ENTRIES)`` entry-equivalents per tile.
        """
        per_cap = _segment_tile_counts(counts, caps)
        entries = 0.0
        for cap, n_tiles in per_cap.items():
            steps = -(-cap // chunk)
            entries += n_tiles * steps * (min(chunk, cap) + CHUNK_STEP_ENTRIES)
        return entries * self._entry_seconds(n_features) / self.machine.n_vpe

    def _best_chunk(self, counts, tile, caps, n_features) -> int:
        return min(
            self.chunks,
            key=lambda c: self._chunk_term(counts, tile, caps, c, n_features),
        )

    def _dense_term(self, counts, tile, ratio, n_features) -> float:
        """Signed cost delta of densifying tiles above ``T^2 * ratio``:
        a densified tile trades its nnz VPU entry-updates for a dense
        ``T^2 * MXU_VPU_RATIO`` entry-equivalent MXU matmul."""
        counts_arr = np.asarray(counts, dtype=np.int64)
        thresh = int(tile * tile * ratio)
        dense = counts_arr[counts_arr > thresh]
        if dense.size == 0:
            return 0.0
        mxu_equiv = tile * tile * MXU_VPU_RATIO
        delta_entries = float((mxu_equiv - dense).sum())
        return delta_entries * self._entry_seconds(n_features) / self.machine.n_vpe

    def _best_ratio(self, counts, tile, n_features) -> float:
        return min(
            self.ratios,
            key=lambda r: self._dense_term(counts, tile, r, n_features),
        )

    # -- stage 2: measured calibration ------------------------------------
    def _stage2(
        self, adj: COOMatrix, scored: list[ScoredCandidate], n_features: int
    ) -> list[ScoredCandidate]:
        default = TunedConfig.default()
        survivors: list[ScoredCandidate] = []
        seen: set = set()
        for cand in scored:
            k = (cand.config.tile, cand.config.bucket_caps)
            if k not in seen:
                seen.add(k)
                survivors.append(cand)
            if len(survivors) >= self.top_k:
                break
        if (default.tile, default.bucket_caps) not in seen:
            # the control: the hand-picked default is always measured too
            ctl = next(
                (
                    c for c in scored
                    if (c.config.tile, c.config.bucket_caps)
                    == (default.tile, default.bucket_caps)
                ),
                ScoredCandidate(
                    default,
                    predict_cost(adj, default, n_features, machine=self.machine),
                    float("inf"),
                ),
            )
            survivors.append(ctl)

        rng = np.random.default_rng(0)
        z = torch.from_numpy(
            rng.integers(-3, 4, size=(adj.shape[1], n_features)).astype(np.float32)
        ).to(self.device)
        out = []
        with torch.no_grad():
            for cand in survivors:
                caps = cand.config.bucket_caps or (cand.config.cap,)
                tiles = coo_to_scv_tiles(adj, cand.config.tile, cap=caps[-1])
                plan = plan_from_tiles_bucketed(tiles, caps=caps, device=self.device)
                aggregate_scv_plan(plan, z)  # build the kernel + warm
                best = min(
                    self._call_seconds(lambda: aggregate_scv_plan(plan, z))
                    for _ in range(self.calib_reps)
                )
                out.append(dataclasses.replace(cand, measured_s=best))
        return out

    def _call_seconds(self, fn) -> float:
        """Seconds of one ``fn()`` on the tuner's device: between two CUDA
        events on a card (the kernel chain's device time), the host clock
        on the CPU."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0


def _segment_tile_counts(counts, caps) -> dict[int, int]:
    """Launched tiles per cap after chain-splitting ``counts`` at the top
    cap (no coverage dummies — callers add those where they matter)."""
    caps_arr = np.asarray(sorted(int(c) for c in caps), dtype=np.int64)
    counts_arr = np.asarray(counts, dtype=np.int64)
    counts_arr = counts_arr[counts_arr > 0]
    top = int(caps_arr[-1])
    out = {int(c): 0 for c in caps_arr}
    if counts_arr.size:
        out[top] += int((counts_arr // top).sum())
        rem = counts_arr % top
        rem = rem[rem > 0]
        if rem.size:
            idx = np.searchsorted(caps_arr, rem)
            for i, n in zip(*np.unique(idx, return_counts=True)):
                out[int(caps_arr[i])] += int(n)
    return out
