#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero, printing no result, without one.
Phases, each of which fails the run on error:

1. Build the SCV SpMM kernel from ``src/repro_torch/kernels/scv_spmm/csrc``
   with nvcc, and print the build time and ptxas's resource report.
2. Hold the kernel against its plain PyTorch version on the card, on the
   composite the engine assembles for the first wave of a warm-up burst
   and on the ogbn-arxiv-scale plan, at F = 128 and
   F = 40, in both chain modes (``init="coverage"`` and ``"zeros"``):
   bit-exact on integer-valued values and Z; within 1e-5 of the plain
   output's largest magnitude with the GCN-normalised values and normal Z
   (the two sum in different orders).
3. Time the kernel (whole chains and each segment launch, with each
   segment's runs, work units, units in split runs and heaviest unit), the
   plain version and ``torch.sparse.mm`` on the same matrix in CSR, beside
   the least time the card's memory rate allows for the same bytes.  Run
   the arxiv chain twice on the same inputs and require the same bits, and
   time it with the run index rebuilt at other ``UNIT_WORK`` limits
   (measured only; the constant does not change).
4. Serve requests from the default hot-graph pool through
   ``GraphServeEngine(device="cuda")`` at gcn-paper widths (128/128/40):
   a burst through ``run()`` and an open-loop Poisson drive through the
   async scheduler.  Each output is checked against a plain forward on the
   card (within 1e-4 of its largest magnitude), and the kernel's launch
   count over each drive must equal the engine's ``metrics()["launches"]``.
5. Run the 2-layer gcn-paper forward over the ogbn-arxiv-scale graph
   (169,343 nodes, 1,166,243 edges, power-law, GCN-normalised), time it,
   and check it against the plain forward as in phase 4.
6. Dense-block graphs: the reference kernel benchmark's own graph
   (``powerlaw_edges``, 2,048 nodes, 1,000,000 edges) and a mixed one
   (8,192 nodes, 4,000,000 edges), GCN-normalised and planned with
   ``bucket_caps="auto"`` at T = 64 (and the first at T = 128), plus the
   single-cap plans the kernel benchmark runs the scalar body on.  Hold
   the vector body (dense-tile branch included) and the scalar body
   against their plain versions on them, as in phase 2.
7. Time those chains: kernel, plain version, ``torch.sparse.mm``, the
   bound, and the same chain with the dense branch off
   (``dense_threshold=cap``); per segment, dense against gather; and the
   T = 64 chains over a sweep of ``dense_threshold`` (measured only; the
   default does not change).
8. The gcn-paper forward and 20 SGD steps of training on the 8,192-node
   graph, through the kernels and the autograd Function: step 0's
   gradients are held against plain autograd through the plain version
   (within 1e-4 of each gradient's largest magnitude), and so are the
   arxiv-scale graph's; the loss must fall.
9. The scalar body through the public op (``body="scalar"``).

Each of phases 4, 5, 8 and 9 sets the kernels' launch counts to 0 just
before it and reads them just after.  The line before the last is a JSON
object with each kernel's numbers; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 rate outside the tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/scv_spmm/csrc/scv_spmm.cu"
REPLACES = "src/repro/kernels/scv_spmm/scv_spmm.py:197"
REPLACES_DENSE = "src/repro/kernels/scv_spmm/scv_spmm.py:169"
REPLACES_SCALAR = "src/repro/kernels/scv_spmm/scv_spmm.py:57"
ARXIV_SEED = 0
SERVE_REQUESTS = 128
# dense-block graphs (nodes, edges): the reference kernel benchmark's own
# (benchmarks/kernel_bench.py:48-49), and a mixed regime where about half
# of the tiles and of the entries take the dense branch
REF_DENSE = (2048, 1_000_000)
MIXED_DENSE = (8192, 4_000_000)
UNIT_WORK_SWEEP = (512, 1024, 2048, 4096, 8192)  # arxiv chain, measured only
DENSE_THRESHOLD_SWEEP = (64, 128, 192, 256, 384, 512, 768)  # T = 64, measured only
TRAIN_STEPS = 20
TRAIN_LR = 2.0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def device_ms(fn, reps: int) -> float:
    """Device time of one ``fn()`` call: CUDA events around ``reps`` calls,
    after a warm-up.  A long sleep kernel goes first so the host has queued
    every call before the device reaches the start event: the reading is
    the device's time, not the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def segment_entries(seg) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The real entries of one segment on the host, as global (rows, cols,
    vals): slots past a tile's nnz, coverage dummies and the tile-count
    padding hold none."""
    nnz = seg.nnz_in_tile.cpu().numpy()
    live = np.arange(seg.cap) < nnz[:, None]
    T = seg.tile
    rows = seg.tile_row.cpu().numpy().astype(np.int64)[:, None] * T + seg.rows.cpu().numpy()
    cols = seg.tile_col.cpu().numpy().astype(np.int64)[:, None] * T + seg.cols.cpu().numpy()
    return rows[live], cols[live], seg.vals.cpu().numpy()[live]


def plan_entries(plan) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The real entries of every segment of ``plan`` (see segment_entries)."""
    parts = [segment_entries(s) for s in getattr(plan, "segments", (plan,))]
    return tuple(np.concatenate(p) for p in zip(*parts))


def segment_bytes(seg, n_feat: int, accumulate: bool) -> int:
    """Least bytes one segment launch must move: 12 B for each real entry
    (row, col, value) and for each non-empty tile's header, each Z row an
    entry names read once, and each strip the launch defines written once
    (and read once more in accumulate mode).  A seeding launch defines the
    strips of every block-row it lists, coverage dummies included; an
    accumulating one only those its entries touch."""
    _, cols, _ = segment_entries(seg)
    nnz = seg.nnz_in_tile.cpu().numpy()
    tile_row = seg.tile_row.cpu().numpy()
    strips = np.unique(tile_row[nnz > 0] if accumulate else tile_row).size
    return (12 * cols.size + 12 * int((nnz > 0).sum())
            + 4 * n_feat * np.unique(cols).size
            + 4 * n_feat * strips * seg.tile * (2 if accumulate else 1))


def chain_bounds(plan, entries, n_feat: int) -> tuple[float, str]:
    """Least time of one whole chain (ms) and what bounds it.  Bytes: 12 B
    for each real entry and for each non-empty tile's header, each Z row an
    entry names read once, and the (padded) output written once, over the
    memory rate.  Operations: 2 flops per real entry and feature over the
    fp32 rate.  Slots past a tile's nnz and zero-nnz padding tiles, which
    the kernel never reads, count nothing."""
    _, cols, _ = entries
    live_tiles = sum(int((s.nnz_in_tile > 0).sum())
                     for s in getattr(plan, "segments", (plan,)))
    nbytes = (12 * cols.size + 12 * live_tiles + 4 * n_feat * np.unique(cols).size
              + 4 * n_feat * plan.padded_shape[0])
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * cols.size * n_feat / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def with_integer_vals(plan, gen, dev):
    """``plan`` with integer values in -4..4 in every slot (sums exact in
    f32, so any order gives the same bits)."""
    def ints(s):
        return dataclasses.replace(s, vals=torch.randint(
            -4, 5, tuple(s.vals.shape), generator=gen).float().to(dev))
    if hasattr(plan, "segments"):
        return dataclasses.replace(plan, segments=tuple(ints(s) for s in plan.segments))
    return ints(plan)


def rel_err(got, want) -> tuple[float, float]:
    """Largest absolute difference, and the plain output's largest magnitude."""
    return (got - want).abs().max().item(), want.abs().max().item()


def latency_line(reqs) -> str:
    """Median and p90 request latency: with 128 requests, p90 is the
    highest percentile that has at least ten samples beyond it."""
    lat = np.array([r.latency_s for r in reqs]) * 1e3
    return (f"latency p50 {np.percentile(lat, 50):.2f} ms p90 "
            f"{np.percentile(lat, 90):.2f} ms over {lat.size} requests")


def csr_of(entries, shape, dev) -> torch.Tensor:
    """A plan's entries as a torch CSR matrix on the card (library
    yardstick)."""
    rows, cols, vals = entries
    idx = torch.from_numpy(np.stack([rows, cols]))
    coo = torch.sparse_coo_tensor(idx, torch.from_numpy(vals), shape)
    return coo.coalesce().to_sparse_csr().to(dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.configs import gcn_paper
    from repro_torch.core import scv
    from repro_torch.kernels.scv_spmm import ref
    from repro_torch.kernels.scv_spmm import scv_spmm as kmod
    from repro_torch.kernels.scv_spmm.build import load_library
    from repro_torch.kernels.scv_spmm.ops import scv_spmm_plan
    from repro_torch.launch.graph_serve import (
        build_default_engine, default_pool, make_requests, poisson_arrivals,
        run_open_loop,
    )
    from repro_torch.core.scv import coo_to_scv_tiles, dense_tile_threshold, plan_from_tiles
    from repro_torch.models.gnn import build_graph, gnn_forward, gnn_loss, init_gnn
    from repro_torch.serve.graph_engine import plan_launches
    from repro_torch.simul.datasets import TABLE_I, gcn_normalize, powerlaw_edges, powerlaw_graph
    from repro_torch.tune.config import TunedConfig

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    unit_work = scv.UNIT_WORK
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    # fp32 everywhere: no TF32 in the combinations
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. build ----------------------------------------------------------
    lib = load_library()
    print(f"[build] {lib.path.name} built in {lib.build_seconds:.2f} s")
    for line in lib.build_log.splitlines():
        if "ptxas" in line:
            print(f"[build] {line.strip()}")

    # -- inputs: one serving composite and the arxiv-scale graph -----------
    cfg = gcn_paper.full
    layout = TunedConfig()
    pool = default_pool()
    engine_kw = dict(model=cfg, device=dev, seed=0)
    # a warm-up burst; its first wave, as the engine's scheduler forms it,
    # gives the composite the engine itself assembles for that wave
    warm = build_default_engine(**engine_kw)
    for r in make_requests(np.random.default_rng(1), pool, 32, cfg.d_in):
        warm.submit(r)
    first = warm.scheduler.form_wave(absorb=False)
    comp = warm._batch_plan(first).graph
    warm.scheduler.queue.requeue(first)
    warm.run()
    torch.cuda.synchronize()
    comp_entries = plan_entries(comp.plan)
    print(f"[inputs] serving composite (the warm-up burst's first wave): "
          f"{len(first)} graphs, {comp.n_nodes} nodes, "
          f"nnz {comp_entries[0].size}, caps {comp.plan.caps}, "
          f"tiles {[s.n_tiles for s in comp.plan.segments]}")

    spec = TABLE_I["arxiv"]
    t0 = time.perf_counter()
    arxiv_adj = gcn_normalize(powerlaw_graph(spec.nodes, spec.edges, seed=ARXIV_SEED))
    t1 = time.perf_counter()
    arxiv = build_graph(arxiv_adj, config=layout, with_edges=False, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"[inputs] arxiv-scale graph: {spec.nodes} nodes, nnz {arxiv_adj.nnz} "
          f"(generated in {t1 - t0:.2f} s, planned and copied in {t2 - t1:.2f} s), "
          f"tiles {[s.n_tiles for s in arxiv.plan.segments]}, "
          f"runs {[s.runs.n_runs for s in arxiv.plan.segments]}")
    shapes = {"serving composite": (comp, comp_entries),
              "arxiv": (arxiv, plan_entries(arxiv.plan))}

    # -- 2. kernel == plain version -----------------------------------------
    gen = torch.Generator().manual_seed(0)
    max_abs_err = 0.0
    for name, (g, _) in shapes.items():
        n_cols = g.plan.shape[1]
        int_plan = with_integer_vals(g.plan, gen, dev)
        for f in (cfg.d_hidden, cfg.n_classes):
            z_int = torch.randint(-4, 5, (n_cols, f), generator=gen).float().to(dev)
            z = torch.randn((n_cols, f), generator=gen).to(dev)
            for init in ("coverage", "zeros"):
                k_int = scv_spmm_plan(int_plan, z_int, init=init)
                p_int = ref.scv_spmm_reference_plan(int_plan, z_int)
                check(torch.equal(k_int, p_int),
                      f"{name} F={f} init={init}: integer inputs not bit-exact "
                      f"(max err {(k_int - p_int).abs().max().item()})")
                k = scv_spmm_plan(g.plan, z, init=init)
                p = ref.scv_spmm_reference_plan(g.plan, z)
                err = (k - p).abs().max().item()
                scale = p.abs().max().item()
                check(err <= 1e-5 * scale,
                      f"{name} F={f} init={init}: max err {err} > 1e-5 * {scale}")
                max_abs_err = max(max_abs_err, err)
                print(f"[compare] {name} F={f} init={init}: integer bit-exact, "
                      f"normalised max abs err {err:.3e} (max |plain| {scale:.3e})")
    torch.cuda.synchronize()

    # -- 3. timing ------------------------------------------------------------
    rows = {}
    for name, (g, entries) in shapes.items():
        csr = csr_of(entries, (g.plan.padded_shape[0], g.plan.shape[1]), dev)
        big = name == "arxiv"
        for f in (cfg.d_hidden, cfg.n_classes):
            z = torch.randn((g.plan.shape[1], f), generator=gen).to(dev)
            ms = device_ms(lambda: scv_spmm_plan(g.plan, z), 10 if big else 50)
            plain_ms = device_ms(lambda: ref.scv_spmm_reference_plan(g.plan, z),
                                 3 if big else 20)
            lib_ms = device_ms(lambda: torch.sparse.mm(csr, z), 10 if big else 50)
            bound_ms, bound_by = chain_bounds(g.plan, entries, f)
            launches = plan_launches(g.plan)
            rows[(name, f)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                   bound_ms=bound_ms, bound_by=bound_by)
            print(f"[time] {name} F={f}: chain of {launches} launches {ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
                  f"torch.sparse.mm (CSR) {lib_ms:.4f} ms")
            out = torch.empty((g.plan.padded_shape[0], f), device=dev)
            seeding = True
            for j, s in enumerate(g.plan.segments):
                if s.n_tiles == 0:
                    continue
                acc = not seeding
                seg_ms = device_ms(lambda s=s, acc=acc: kmod.scv_spmm_runs(
                    s.tile_row, s.tile_col, s.nnz_in_tile, s.rows, s.cols, s.vals,
                    z, out, s.runs, tile=s.tile, accumulate=acc), 10 if big else 50)
                seg_bound = 1e3 * segment_bytes(s, f, acc) / HBM_BYTES_PER_S
                # one block walks one work unit: the heaviest unit sets the floor
                ptr = s.runs.ptr.cpu().numpy()
                run_nnz = np.add.reduceat(s.nnz_in_tile.cpu().numpy(), ptr[:-1])
                print(f"[time]   segment {j} cap {s.cap}: {s.n_tiles} tiles, "
                      f"{s.runs.n_runs} runs, nnz {int(run_nnz.sum())}, "
                      f"longest run {int(np.diff(ptr).max())} tiles / "
                      f"{int(run_nnz.max())} nnz, {s.runs.n_units} units "
                      f"({s.runs.n_split_units} in split runs, heaviest "
                      f"{s.runs.max_unit_work} work), accumulate={acc}: "
                      f"{seg_ms:.4f} ms, bound {seg_bound:.4f} ms")
                seeding = False
        del csr
    torch.cuda.synchronize()

    # the arxiv chain twice on the same real-valued inputs: the same bits
    # (split runs sum their partials in unit order, not with float atomics)
    z = torch.randn((arxiv.plan.shape[1], cfg.d_hidden), generator=gen).to(dev)
    first_out, second_out = scv_spmm_plan(arxiv.plan, z), scv_spmm_plan(arxiv.plan, z)
    torch.cuda.synchronize()
    check(torch.equal(first_out, second_out), "arxiv chain: two launches differ")
    print(f"[determinism] arxiv F={cfg.d_hidden} chain twice: identical bits "
          f"({sum(s.runs.n_split_units for s in arxiv.plan.segments)} units in split runs)")
    # the same chain with the run index rebuilt at other unit limits
    sweep = []
    for limit in UNIT_WORK_SWEEP:
        scv.UNIT_WORK = limit
        plan = dataclasses.replace(arxiv.plan, segments=tuple(
            dataclasses.replace(s, runs=scv.RunIndex.of(
                s.tile_row.cpu().numpy(), s.nnz_in_tile.cpu().numpy(), dev))
            for s in arxiv.plan.segments))
        ms = device_ms(lambda: scv_spmm_plan(plan, z), 10)
        err, scale = rel_err(scv_spmm_plan(plan, z), first_out)
        check(err <= 1e-5 * scale, f"arxiv chain at UNIT_WORK {limit}: max err {err}")
        sweep.append(f"{limit}: {ms:.4f} ms ({sum(s.runs.n_units for s in plan.segments)} "
                     f"units, {sum(s.runs.n_split_units for s in plan.segments)} split)")
    scv.UNIT_WORK = unit_work
    del plan
    print(f"[units] arxiv F={cfg.d_hidden} chain by UNIT_WORK (now {unit_work}): "
          + "; ".join(sweep))

    # -- 4. serving --------------------------------------------------------------
    def plain_forward(params, g, x):
        """GCN forward with the plain aggregation, on the card."""
        h = x
        for i in range(cfg.n_layers):
            h = ref.scv_spmm_reference_plan(g.plan, h @ params[f"layer{i}"]["w"])
            h = h[: g.n_nodes]
            if i + 1 < cfg.n_layers:
                h = torch.relu(h)
        return h

    graphs = {id(a): build_graph(a, config=layout, device=dev) for a in pool}

    def check_outputs(engine, reqs, label):
        params = engine.models["gcn"][0]
        worst = 0.0
        for r in reqs:
            check(r.done and r.out is not None, f"{label}: request {r.rid} not served")
            want = plain_forward(params, graphs[id(r.adj)],
                                 torch.from_numpy(r.x).to(dev)).cpu().numpy()
            check(r.out.shape == want.shape and np.isfinite(r.out).all(),
                  f"{label}: request {r.rid} output shape/finiteness")
            err = float(np.abs(r.out - want).max() / max(1.0, np.abs(want).max()))
            worst = max(worst, err)
        check(worst <= 1e-4, f"{label}: output off the plain forward by {worst}")
        return worst

    engine = build_default_engine(**engine_kw)
    reqs = make_requests(np.random.default_rng(2), pool, SERVE_REQUESTS, cfg.d_in)
    for r in reqs:
        engine.submit(r)
    kmod.reset_counts()
    t0 = time.perf_counter()
    engine.run()
    wall = time.perf_counter() - t0
    serve_launches = kmod.launches
    m = engine.metrics()
    check(serve_launches > 0, "the serving drive launched no kernel")
    check(serve_launches == m["launches"],
          f"kernel launches {serve_launches} != engine launches {m['launches']}")
    worst = check_outputs(engine, reqs, "burst")
    print(f"[serve] burst of {SERVE_REQUESTS} through run(): {m['waves']} waves, "
          f"{SERVE_REQUESTS / wall:.1f} graphs/s, {latency_line(reqs)}, "
          f"plan builds {m['plan_build_seconds']:.3f} s of {wall:.3f} s, "
          f"kernel launches {serve_launches} "
          f"= engine launches {m['launches']}, worst rel err {worst:.2e}")

    rate = 400.0
    engine2 = build_default_engine(**engine_kw)
    rng2 = np.random.default_rng(3)
    reqs2 = make_requests(rng2, pool, SERVE_REQUESTS, cfg.d_in)
    arrivals = poisson_arrivals(rng2, SERVE_REQUESTS, rate)
    kmod.reset_counts()
    stats = run_open_loop(engine2, reqs2, arrivals, mode="async")
    async_launches = kmod.launches
    m2 = engine2.metrics()
    check(stats["completed"] == SERVE_REQUESTS, f"async drive completed {stats['completed']}")
    check(async_launches == m2["launches"] > 0,
          f"kernel launches {async_launches} != engine launches {m2['launches']}")
    worst2 = check_outputs(engine2, reqs2, "open loop")
    print(f"[serve] open loop at {rate:.0f}/s offered through the async scheduler: "
          f"{stats['graphs_per_s']:.1f} graphs/s, {latency_line(reqs2)}, "
          f"{m2['waves']} waves, fill {m2['wave_fill']:.2f}, "
          f"plan builds {m2['plan_build_seconds']:.3f} s of {stats['elapsed_s']:.3f} s, "
          f"kernel launches {async_launches} = engine launches {m2['launches']}, "
          f"worst rel err {worst2:.2e}")

    # -- 5. arxiv-scale forward -----------------------------------------------
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
    x = torch.from_numpy(
        np.random.default_rng(4).standard_normal((spec.nodes, cfg.d_in), np.float32)
    ).to(dev)
    with torch.inference_mode():
        out = gnn_forward(params, cfg, arxiv, x)
        torch.cuda.synchronize()
        reps = 5
        kmod.reset_counts()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = gnn_forward(params, cfg, arxiv, x)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3 / reps
        fwd_launches = kmod.launches
        want = plain_forward(params, arxiv, x)
    check(fwd_launches == reps * plan_launches(arxiv.plan) * cfg.n_layers,
          f"arxiv forward launched {fwd_launches} kernels")
    check(tuple(out.shape) == (spec.nodes, cfg.n_classes) and bool(torch.isfinite(out).all()),
          "arxiv forward output shape/finiteness")
    # two layers: the second combination carries the first aggregation's
    # rounding differences, so the forward gets the serving check's bound
    err = (out - want).abs().max().item()
    scale = want.abs().max().item()
    check(err <= 1e-4 * max(1.0, scale),
          f"arxiv forward off the plain forward: {err} vs {scale}")
    print(f"[arxiv] 2-layer gcn-paper forward: {fwd_ms:.3f} ms per forward "
          f"(host clock, {reps} forwards), {fwd_launches // reps} kernel launches each, "
          f"max abs err vs plain forward {err:.3e} (max |plain| {scale:.3e})")

    # -- 6. dense-block graphs: kernel == plain version ----------------------
    def dense_counts(plan) -> list[int]:
        """Tiles per segment that take the dense branch (a host read, off
        every timed and counted path)."""
        return [int((s.nnz_in_tile > dense_tile_threshold(s.tile)).sum().item())
                for s in getattr(plan, "segments", (plan,))]

    dense_adj, vector_plans = {}, {}
    for n, m in (REF_DENSE, MIXED_DENSE):
        t0 = time.perf_counter()
        adj = gcn_normalize(powerlaw_edges(n, m, seed=0))
        t1 = time.perf_counter()
        g = build_graph(adj, bucket_caps="auto", with_edges=False, device=dev)
        torch.cuda.synchronize()
        name = f"{n}/{m}"
        dense_adj[name] = (adj, g)
        vector_plans[f"{name} T=64"] = g.plan
        print(f"[dense] {name}: nnz {adj.nnz} (generated in {t1 - t0:.2f} s, planned "
              f"and copied in {time.perf_counter() - t1:.2f} s), ladder {g.plan.caps}, "
              f"tiles {[s.n_tiles for s in g.plan.segments]}, dense tiles "
              f"{dense_counts(g.plan)} (threshold {dense_tile_threshold(64)})")
    ref_name = f"{REF_DENSE[0]}/{REF_DENSE[1]}"
    ref_adj, ref_g = dense_adj[ref_name]
    g128 = build_graph(ref_adj, tile=128, bucket_caps="auto", with_edges=False, device=dev)
    vector_plans[f"{ref_name} T=128"] = g128.plan
    print(f"[dense] {ref_name} at T=128: ladder {g128.plan.caps}, tiles "
          f"{[s.n_tiles for s in g128.plan.segments]}, dense tiles {dense_counts(g128.plan)} "
          f"(threshold {dense_tile_threshold(128)})")
    # the scalar body's plans, as benchmarks/kernel_bench.py:114-116 builds them
    scalar_plans = {
        f"{ref_name} T={t} cap {caps[-1]}": plan_from_tiles(
            coo_to_scv_tiles(ref_adj, t, cap=caps[-1]), with_perm=False, device=dev)
        for t, caps in ((64, ref_g.plan.caps), (128, g128.plan.caps))
    }
    torch.cuda.synchronize()

    err_dense = err_scalar = 0.0
    for body, plans in (("vector", vector_plans), ("scalar", scalar_plans)):
        for name, plan in plans.items():
            int_plan = with_integer_vals(plan, gen, dev)
            for f in (cfg.d_hidden, cfg.n_classes):
                z_int = torch.randint(-4, 5, (plan.shape[1], f), generator=gen).float().to(dev)
                z = torch.randn((plan.shape[1], f), generator=gen).to(dev)
                k_int = scv_spmm_plan(int_plan, z_int, body=body)
                p_int = ref.scv_spmm_reference_plan(int_plan, z_int, body=body)
                check(torch.equal(k_int, p_int),
                      f"{body} {name} F={f}: integer inputs not bit-exact "
                      f"(max err {(k_int - p_int).abs().max().item()})")
                err, scale = rel_err(scv_spmm_plan(plan, z, body=body),
                                     ref.scv_spmm_reference_plan(plan, z, body=body))
                # the dense branch sums D @ Z in another order than the gather
                check(err <= 1e-5 * scale, f"{body} {name} F={f}: max err {err} > 1e-5 * {scale}")
                if body == "vector":
                    err_dense = max(err_dense, err)
                else:
                    err_scalar = max(err_scalar, err)
                print(f"[compare] {body} body {name} F={f}: integer bit-exact, normalised "
                      f"max abs err {err:.3e} (max |plain| {scale:.3e})")
    torch.cuda.synchronize()

    # -- 7. dense-block timing ------------------------------------------------
    dense_rows = {}
    for name, plan in vector_plans.items():
        entries = plan_entries(plan)
        csr = csr_of(entries, (plan.padded_shape[0], plan.shape[1]), dev)
        gather_thr = plan.caps[-1]  # no tile holds more: the branch never runs
        for f in (cfg.d_hidden, cfg.n_classes):
            z = torch.randn((plan.shape[1], f), generator=gen).to(dev)
            ms = device_ms(lambda: scv_spmm_plan(plan, z), 20)
            gather_ms = device_ms(lambda: scv_spmm_plan(plan, z, dense_threshold=gather_thr), 5)
            plain_ms = device_ms(lambda: ref.scv_spmm_reference_plan(plan, z, body="vector"), 5)
            lib_ms = device_ms(lambda: torch.sparse.mm(csr, z), 20)
            bound_ms, bound_by = chain_bounds(plan, entries, f)
            dense_rows[(name, f)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                         bound_ms=bound_ms, bound_by=bound_by)
            print(f"[time] dense-block {name} F={f}: chain of {plan_launches(plan)} launches "
                  f"{ms:.4f} ms, dense branch off {gather_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}), plain {plain_ms:.4f} ms, torch.sparse.mm (CSR) {lib_ms:.4f} ms")
            out = torch.zeros((plan.padded_shape[0], f), device=dev)
            for j, s in enumerate(plan.segments):
                n_dense = int((s.nnz_in_tile > dense_tile_threshold(s.tile)).sum().item())
                if n_dense == 0:
                    continue
                seg = (s.tile_row, s.tile_col, s.nnz_in_tile, s.rows, s.cols, s.vals, z, out,
                       s.runs)
                seg_ms = {thr: device_ms(lambda thr=thr: kmod.scv_spmm_runs(
                    *seg, tile=s.tile, accumulate=True, dense_threshold=thr), 5)
                    for thr in (None, s.cap)}
                print(f"[time]   segment {j} cap {s.cap}: {s.n_tiles} tiles ({n_dense} dense), "
                      f"{s.runs.n_runs} runs, {s.runs.n_units} units ({s.runs.n_split_units} "
                      f"in split runs, heaviest {s.runs.max_unit_work} work), nnz "
                      f"{int(s.nnz_in_tile.sum().item())}: dense branch {seg_ms[None]:.4f} ms, "
                      f"gather {seg_ms[s.cap]:.4f} ms")
        del csr
        if plan.tile == 64:
            # where the dense branch starts to pay on this card: measured only
            z = torch.randn((plan.shape[1], cfg.d_hidden), generator=gen).to(dev)
            nnz = np.concatenate([s.nnz_in_tile.cpu().numpy() for s in plan.segments])
            sweep = [f"{thr}: {device_ms(lambda: scv_spmm_plan(plan, z, dense_threshold=thr), 5):.4f}"
                     f" ms ({int((nnz > thr).sum())} dense)" for thr in DENSE_THRESHOLD_SWEEP]
            print(f"[sweep] dense-block {name} F={cfg.d_hidden} chain by dense_threshold "
                  f"(default {dense_tile_threshold(64)}): " + "; ".join(sweep))
    scalar_rows = {}
    for name, plan in scalar_plans.items():
        entries = plan_entries(plan)
        csr = csr_of(entries, (plan.padded_shape[0], plan.shape[1]), dev)
        for f in (cfg.d_hidden, cfg.n_classes):
            z = torch.randn((plan.shape[1], f), generator=gen).to(dev)
            ms = device_ms(lambda: scv_spmm_plan(plan, z, body="scalar"), 5)
            vec_ms = device_ms(lambda: scv_spmm_plan(plan, z), 20)
            plain_ms = device_ms(lambda: ref.scv_spmm_reference_plan(plan, z, body="scalar"), 5)
            lib_ms = device_ms(lambda: torch.sparse.mm(csr, z), 20)
            bound_ms, bound_by = chain_bounds(plan, entries, f)
            scalar_rows[(name, f)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                          bound_ms=bound_ms, bound_by=bound_by)
            print(f"[time] scalar body {name} F={f}: {ms:.4f} ms, vector body on the same "
                  f"plan {vec_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), plain "
                  f"{plain_ms:.4f} ms, torch.sparse.mm (CSR) {lib_ms:.4f} ms")
        del csr
    torch.cuda.synchronize()

    # -- 8. dense-block forward and training ----------------------------------
    mixed_name = f"{MIXED_DENSE[0]}/{MIXED_DENSE[1]}"
    _, mixed = dense_adj[mixed_name]
    n_mixed = mixed.n_nodes
    rng8 = np.random.default_rng(6)
    x8 = torch.from_numpy(rng8.standard_normal((n_mixed, cfg.d_in), np.float32)).to(dev)
    # labels a model of this shape can learn: the centred argmax of a
    # teacher's plain forward (random labels on so smoothing a graph stay
    # at log(classes) however the weights move)
    teacher = init_gnn(torch.Generator().manual_seed(1), cfg, device=dev)
    with torch.no_grad():
        t_logits = plain_forward(teacher, mixed, x8)
    labels8 = (t_logits - t_logits.mean(0, keepdim=True)).argmax(1)
    mask8 = torch.ones(n_mixed, device=dev)

    def plain_loss(params, g, x, labels):
        logp = torch.log_softmax(plain_forward(params, g, x), dim=-1)
        return -logp.gather(1, labels[:, None]).mean()  # mask all ones

    def grad_check(g, x, labels, label):
        """Step 0: the kernels' gradients against plain autograd through
        the plain version; returns params, their flat list, loss, grads."""
        params = init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
        names = [f"{layer}.{k}" for layer, ps in params.items() for k in ps]
        flat = [p.requires_grad_(True) for ps in params.values() for p in ps.values()]
        loss = gnn_loss(params, cfg, g, x, labels, torch.ones(g.n_nodes, device=dev))
        grads = torch.autograd.grad(loss, flat)
        want = torch.autograd.grad(plain_loss(params, g, x, labels), flat)
        errs = {}
        for name, a, b in zip(names, grads, want):
            err, scale = rel_err(a, b)
            # the backward's index_add_ sums with atomics, in no fixed order
            check(err <= 1e-4 * scale, f"{label} grad {name}: max err {err} > 1e-4 * {scale}")
            errs[name] = err / scale
        print(f"[train] {label} step-0 gradients vs plain autograd, max err / max |grad|: "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        return params, flat, loss, grads

    params8 = init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
    kmod.reset_counts()
    with torch.inference_mode():
        out8 = gnn_forward(params8, cfg, mixed, x8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            out8 = gnn_forward(params8, cfg, mixed, x8)
        torch.cuda.synchronize()
        fwd8_ms = (time.perf_counter() - t0) * 1e3 / 3
    params, flat, loss, grads = grad_check(mixed, x8, labels8, mixed_name)
    losses = [loss.item()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        with torch.no_grad():
            for p, d in zip(flat, grads):
                p -= TRAIN_LR * d
        loss = gnn_loss(params, cfg, mixed, x8, labels8, mask8)
        grads = torch.autograd.grad(loss, flat)
        losses.append(loss.item())
    step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    train_launches, train_dense = kmod.launches, kmod.dense_launches
    forwards = 4 + 1 + TRAIN_STEPS  # timed forwards, step 0, the SGD steps
    n_dense_segs = sum(1 for c in dense_counts(mixed.plan) if c)
    check(train_launches == forwards * cfg.n_layers * plan_launches(mixed.plan),
          f"dense-block drive launched {train_launches} kernels")
    check(train_dense == forwards * cfg.n_layers * n_dense_segs > 0,
          f"dense-block drive: {train_dense} launches took the dense branch")
    check(tuple(out8.shape) == (n_mixed, cfg.n_classes) and bool(torch.isfinite(out8).all()),
          "dense-block forward output shape/finiteness")
    with torch.no_grad():
        err, scale = rel_err(out8, plain_forward(params8, mixed, x8))
    check(err <= 1e-4 * max(1.0, scale), f"dense-block forward off the plain forward: {err}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.1,
          f"training loss did not fall: {losses}")
    print(f"[dense] 2-layer gcn-paper forward on {mixed_name}: {fwd8_ms:.3f} ms per forward "
          f"(host clock, 3 forwards), max abs err vs plain forward {err:.3e} "
          f"(max |plain| {scale:.3e})")
    print(f"[train] {mixed_name}: {TRAIN_STEPS} SGD steps at lr {TRAIN_LR}, {step_ms:.3f} ms "
          f"per step (host clock: forward, backward, update), loss "
          + " ".join(f"{v:.4f}" for v in losses[:: max(1, TRAIN_STEPS // 5)])
          + f" -> {losses[-1]:.4f}; {train_launches} kernel launches over {forwards} "
          f"forwards, {train_dense} of them with dense tiles")

    arxiv_labels = torch.from_numpy(
        np.random.default_rng(7).integers(0, cfg.n_classes, spec.nodes)).to(dev)
    grad_check(arxiv, x, arxiv_labels, "arxiv")
    torch.cuda.synchronize()

    # -- 9. the scalar body through the public op ------------------------------
    sc_name, sc_plan = next(iter(scalar_plans.items()))
    z = torch.randn((sc_plan.shape[1], cfg.d_hidden), generator=gen).to(dev)
    kmod.reset_counts()
    out_sc = scv_spmm_plan(sc_plan, z, body="scalar")
    torch.cuda.synchronize()
    scalar_launches = kmod.scalar_launches
    check(scalar_launches == plan_launches(sc_plan) and kmod.launches == 0,
          f"scalar drive launched {scalar_launches} scalar, {kmod.launches} vector kernels")
    err, scale = rel_err(out_sc, ref.scv_spmm_reference_plan(sc_plan, z, body="scalar"))
    check(err <= 1e-5 * scale, f"scalar drive off the plain version: {err}")
    print(f"[scalar] {sc_name} F={cfg.d_hidden} through scv_spmm_plan(body='scalar'): "
          f"{scalar_launches} launch, max abs err {err:.3e}")

    main_row = rows[("serving composite", cfg.d_hidden)]
    dense_row = dense_rows[(f"{mixed_name} T=64", cfg.d_hidden)]
    scalar_row = scalar_rows[(sc_name, cfg.d_hidden)]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": "scv_spmm_runs", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES, "launches": serve_launches, "max_abs_err": max_abs_err,
         **main_row},
        {"name": "scv_spmm_runs dense-tile branch", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES_DENSE, "launches": train_dense, "max_abs_err": err_dense,
         **dense_row},
        {"name": "scv_spmm_runs_scalar", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES_SCALAR, "launches": scalar_launches,
         "max_abs_err": err_scalar, **scalar_row},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
