#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero, printing no result, without one.
Phases, each of which fails the run on error:

1. Build the SCV SpMM kernel from ``src/repro_torch/kernels/scv_spmm/csrc``
   with nvcc, and print the build time, ptxas's resource report and the
   vector body's blocks an SM holds (with and without the dense branch).
2. Hold the kernel against its plain PyTorch version on the card, on the
   composite the engine assembles for the first wave of a warm-up burst
   and on the ogbn-arxiv-scale plan, at F = 128 and
   F = 40, in both chain modes (``init="coverage"`` and ``"zeros"``):
   bit-exact on integer-valued values and Z; within 1e-5 of the plain
   output's largest magnitude with the GCN-normalised values and normal Z
   (the two sum in different orders).
3. Time the kernel (whole chains, one launch each, beside the earlier
   design's times for them, and each segment launched alone, with each segment's runs,
   work units, units in split runs and heaviest unit), the plain version
   and ``torch.sparse.mm`` on the same matrix in CSR, beside the least
   time the card's memory rate allows for the same bytes.  Run the arxiv
   chain twice on the same inputs and require the same bits, and time it
   with the run index rebuilt at other ``UNIT_WORK`` limits (measured
   only; the constant does not change).  Split one launch's time (the
   arxiv cap-32 segment alone, and the arxiv chain) into a grid of padding
   units, its heaviest run, its heaviest unit and the other runs.
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
   single-cap plans the kernel benchmark runs the scalar body on (each
   with its runs, work units, units in split runs and heaviest unit).
   Hold the vector body (dense-tile branch included) and the scalar body
   against their plain versions on them, as in phase 2, and require two
   scalar-body launches on the same inputs to give the same bits.
7. Time those chains: kernel, plain version, ``torch.sparse.mm``, the
   bound, the earlier design's time, and the same chain with the dense branch off
   (``dense_threshold=cap``); per segment, dense against gather; the
   chains over a sweep of ``dense_threshold`` (measured only; the default
   does not change); and the scalar body beside the vector body
   on its plans, also under the thread rule it does not keep (the widest
   block within 48 KB; measured only, and the same bits).
8. The gcn-paper forward and 20 SGD steps of training on the 8,192-node
   graph, through the kernels and the autograd Function, whose backward
   runs dZ = Âᵀ g through the same kernels over the transposed plan (built
   at the first backward): step 0's gradients, computed twice, must give
   the same bits, and are held against plain autograd through the plain
   version (within 1e-4 of each gradient's largest magnitude), and so are
   the arxiv-scale graph's; the loss must fall; every forward and backward
   launch is counted.  The backward's dZ chain alone is timed on both
   graphs against its bound, the earlier design's time, ``torch.sparse.mm`` on the
   transpose and the plain backward it replaced (``index_add_``), and held
   against that (1e-5).
9. The scalar body through the public op (``body="scalar"``).
10. Streaming deltas on the arxiv-scale plan, on the card (T = 64, the
    engine's ladder (8, 32, 128)): 16 deltas of 64 edges (value updates,
    inserts + removes, net shrinks, a tile pushed across a ladder
    boundary, a tile made dense, a tile birth and a death) patched by
    ``stream.apply_delta``.  After each: the patched graph equals the
    rebuild from ``apply_coo`` leaf for leaf and run index for run index,
    ``validate_plan`` is green, the kernel chain on it is bit-exact with the
    chain on the rebuilt plan on integer values and within 1e-5 of the
    plain version on normalised values, and the dense-branch launch count
    is the one the tiles call for.  The dense delta is also applied to the
    same graph on the ladder (8, 32, 128, 512), where its tile takes the
    dense branch.  Times: patch against rebuild, the copies inside the
    patch, and the chain on the patched plan against the rebuilt one.
11. Tracked-graph serving: the arxiv-scale graph as one tracked member of
    ``GraphServeEngine(debug_validate=True)`` at gcn-paper widths, with 0,
    1 and 4 value-update deltas of 64 edges between waves, 3 waves each,
    through ``run()`` and under the async loop.  Every output within 1e-4
    of a plain forward on the rebuilt post-delta graph, every update a
    plan-cache revalidation, the kernel's launch count equal to the
    engine's; queries/s and updates/s per rate, and a wave's time split
    into update, composite assembly, copy to the card and forward.
12. The sharding executor (``core.exec.PlanExecutor``) over a pool of four
    slots on the card (and, with two cards or more, over the cards too).
    The arxiv-scale plan placed as ``tiles`` 4x1, ``features`` 1x2 (F =
    128), ``2d`` 2x2 and what ``PlanExecutor.decide`` picks, at F = 128
    and 40: ``validate_plan`` green, the sharded aggregation bit-exact with
    the unsharded kernel chain on integer values and within 1e-5 of the
    plain version on normalised ones, kernel launches equal to
    ``plan_launches``; prepare, each grid cell's chain, the merge and the
    whole call timed.  The gcn-paper forward over the graph placed
    ``tiles`` 4x1 against the plain forward (1e-4) and one ``gnn_loss``
    step's gradients against the unsharded kernel path (1e-4).  A serving
    burst from the hot-graph pool through an engine with the executor,
    waves over 4,096 entries placed: outputs within 1e-4 of a plain
    forward, launches equal to the engine's, and the burst repeated from
    placed composites in the cache.  Last, the plan placed ``features``
    1x8 on eight slots at F = 3 (five slabs empty, launching nothing),
    bit-exact with the unsharded chain on integers.
13. The two-stage autotuner (``tune.Autotuner(device="cuda")``, top 2, 2
    calibration reps) on three regimes: the reference autotune
    benchmark's two at F = 32 (``powerlaw_graph(1 << 17, 1_000_000)``,
    ``powerlaw_edges(2048, 1_000_000)``) and the arxiv-scale graph at F =
    128.  Stage 1 must pick the reference's winner; stage 2 must time the
    default control (T = 64, (8, 32, 128)) and keep the measured best.
    The winner's chain, the default's and stage 1's best at T = 32 are
    held against the plain version (bit-exact on integers, 1e-5 on
    normalised values) and timed beside ``torch.sparse.mm`` and the bound;
    a fresh tuner on the same store resolves all three with no search.
    Then the arxiv-scale forward with the tuned layout (against the plain
    forward, 1e-4, timed beside phase 5's), and phase 4's burst twice
    through ``GraphServeEngine(autotune=True)``: every output against a
    plain forward, launches equal to the engine's, no wave mixing two
    resolved configs.

14. The rest of ``core/`` and the captured forward.  (a) ``core.aggregate``
    over every format against the SCV chain on the same values, bit for
    bit on integer values and within 1e-5 on normalised ones: COO
    (segsum), CSR, CSC (scatter), ``SCVMatrix``, ``SCVTiles`` and the
    bucketed plan on the arxiv-scale graph at F = 128, each timed on
    arrays already on the card beside the chain; BCSR (block 64) and dense
    on 8,192/4M; the hybrid on both dense-block graphs, its split printed.
    Every SCV format must launch the kernel.  (b) The forward captured in
    a CUDA graph (``models.gnn.CapturedForward``) against the eager one,
    bit for bit on integer plan values and features: the arxiv-scale GCN
    (20 forwards each way on the host clock, the replay alone with
    ``device_ms``), GCN, SAGE, GIN and GAT on two composites of one
    padding bucket (first call, replay after the other's copy-in, replay
    again); phase 4's burst twice through an engine that captures, which
    must capture at most once per padding bucket, only once its queue is
    empty, and nothing on the repeat, which it must replay whole, and
    phase 4's open loop through such an engine, each with its kernel
    launches equal to the engine's, in ten pairs of turns with the same
    drives through the engine with its forward eager (measured only).  (c)
    ``core.tracecheck.trace_check`` over the four kinds on the card must
    be ok.

15. The decoder LMs (``models/layers.py``, ``models/transformer.py``,
    ``serve/engine.py``), which reach no SCV kernel: the reference's LM
    substrate calls no ``pl.pallas_call``, so its products are cuBLAS
    calls and the rest PyTorch ops.  (a) Each LM arch's reduced config in
    float32 (TF32 off), the same weights on the card and on the CPU,
    through prefill and 3 decode steps (``internvl2-76b`` with its stub
    frontend embeddings): logits and every cache leaf within 1e-4 of the
    largest magnitude.  (b) ``gemma3-4b`` at full width, its depth cut to
    10 layers (its 4 leading global layers and one 5-local + 1-global
    group), float32, B = 2: a 2,048-token prefill (blockwise attention;
    the local layers' 1,024-slot rings wrap) and one decode step, against
    the forward over all 2,049 tokens: |Δ log-softmax| < 5e-3 and the same
    argmax with a plain cache; < 0.15 with the config's int8 cache, and
    the same argmax wherever the forward's top-1 leads by more than 0.3.
    (c) ``olmoe-1b-7b`` at full width and depth, 6.82B params drawn from
    a seeded generator on the card, served in bf16 (the weights cast
    once): ``ServeEngine(max_batch=4)`` serves 8 requests of 512 prompt
    tokens and one of 2,048 (blockwise prefill), 32 new tokens each; every
    request gets them and every logit is finite.  Then layer 0's MoE input
    from the first batch's prefill (B = 4, S = 512) in float32, capacity
    factor E/K = 8 (no slot drops): ``moe_sorted`` equals ``moe_dense``
    within 1e-4 of the largest magnitude, and each aux loss its own
    formula's (the two differ by definition).  Prefill ms per batch and
    decode ms per step (CUDA events), tokens/s (host clock), weight bytes
    and peak memory are printed with the card's name and power limit.
16. The SSM, hybrid and encoder-decoder families (``models/ssm.py``,
    ``models/hybrid.py``, ``models/encdec.py``), which reach no SCV
    kernel either, and the launcher's decode step captured in a CUDA
    graph (``serve/engine.py::CapturedDecode``, built by
    ``launch/serve.py::serve_fns``).  (a) ``mamba2-780m``, ``zamba2-2.7b``
    and ``whisper-small`` reduced, float32, the same weights on the card
    and on the CPU: hidden states (the encoder and the teacher-forced
    decoder), the chunked prefill (the decoder cache), 3 decode steps and
    every state leaf within 1e-4 of the largest magnitude.  (b) At full
    width and depth in float32: ``mamba2-780m`` and ``zamba2-2.7b``, B =
    2, 600 tokens (three SSD chunks, the last one padded): the last
    position's log-softmax from the chunked ``hidden_states`` against 600
    recurrent steps through the launcher's captured decode, within 1e-3;
    ``whisper-small``: 32 greedy steps from ``encode`` over 4 x 1,500
    frames against ``decode_train`` on the tokens fed, within 1e-3 and the
    same picks wherever ``decode_train`` leads by more than 2e-3.  (c) In
    bf16 at full width and depth: ``zamba2-2.7b`` and ``mamba2-780m``
    served through ``ServeEngine`` with the launcher's functions (8
    requests of 512 prompt tokens, prefilled one token at a time through
    the decode step, 32 new tokens, B = 4), once with an eager decode and
    once captured; ``olmoe-1b-7b`` (phase 15's weights and first batch)
    the same way; ``whisper-small`` 32 greedy steps eager and captured.
    Captured and eager give the same tokens and logits equal bit for bit;
    prefill ms per batch, decode ms per step (CUDA events), tokens/s (host
    clock), captures, state bytes copied in and peak memory are printed
    beside each step's bound (weights, and the state, read once at the
    card's memory rate).

17. The training stack (``optim/adam.py``, ``data/pipeline.py``,
    ``train/checkpoint.py``, ``train/fault.py``, ``launch/train.py``,
    ``ArchSpec.make_train_step`` with remat), which reaches no SCV kernel.
    (a) One train step of each of the ten archs' reduced configs, the same
    weights and batch on the card and on the CPU, float32 (TF32 off;
    ``qwen1.5-32b`` with ``microbatch=2``, ``mamba2-780m`` with bf16 params
    and a float32 master): the loss, every gradient leaf and every new
    param and Adam leaf within 1e-4 of the largest magnitude (1e-2 in
    bf16).  (b) ``mamba2-780m`` at full width and depth (780,382,464
    params) in float32 through ``launch/train.py``'s functions, B = 4, S =
    512: a warm-up step and 8 more; the loss must fall; ms per step (CUDA
    events), tokens/s (host clock), the Adam update alone and peak memory
    beside their bounds.  (c) ``launch/train.py``'s ``main`` on the card:
    8 steps against 4, a checkpoint, ``--resume`` and 4 more, final
    losses within 1e-5 relative (whether the bits agree is printed).

18. The sharding rules and meshes (``train/sharding.py``,
    ``launch/mesh.py``), tensor parallelism (``train/tp.py``), the int8
    gradient compression (``optim/compress.py``) and the dry run
    (``launch/dryrun.py``), which reach no SCV kernel.  (a)
    ``launch/train.py``'s ``main`` on ``mamba2-780m`` at full width, 16 of
    its 48 layers, B = 16, S = 128, 2 steps, ``--mesh prod`` laid out data-only
    (16x1 over the card: 16 data groups of one sequence, each computing
    whole): bit for bit against ``--mesh none`` with 16 microbatches,
    plain ``--mesh none``'s gap, step ms and memory printed; the ``[mesh]``
    line gives each position's bytes of params and Adam state, from the
    shard shapes and as held; and the reduced ``olmoe-1b-7b`` in 16 groups
    on the 16x16 mesh (each aux with the whole batch's expert shares), one
    step, card against CPU.  (b) ``compressed_psum`` over four slots of
    the card on gradient and error trees of Mamba2-780M's full shapes from
    a seeded generator: the mean and every member's residual equal the
    same call on the CPU bit for bit on a seeded sample of leaves; one call
    timed (CUDA events) beside its byte bound; 30 steps of error feedback
    keep the accumulated compressed mean within one quantization step of
    the true mean.  (d) tensor parallelism in compute: ``mamba2-780m`` at
    full width and depth computed in float32, phase 17(b)'s B = 4, S =
    512, 2 steps with ``--mesh prod`` (16x16 over the card: one data group
    whose products split over 16 "model" positions): a second run's first
    step gives equal bits, the (1, 16) mesh's first step too, ``--mesh none`` within
    ``TP_TOL`` (losses) and ``TP_TOL_GNORM`` (``grad_norm``), at LR 1e-6;
    whisper-small at full width, 6 of its 12 layers a side, B = 2, S =
    256, whose 12 heads on 16 positions run ``seq_sharded``, within the
    same of ``--mesh none``; the reduced configs of the five families on a (2, 2) mesh,
    card against CPU.  (c) ``dryrun_cell`` on the 16x16 mesh for every
    shape of one arch of each family (``olmoe-1b-7b``, ``mamba2-780m``,
    ``zamba2-2.7b``, ``whisper-small``), counted on ``meta`` in worker
    processes while (a), (b) and (d) run (``flops_per_device`` is position
    (0, 0)'s share); each cell it finds ``fits_one_card`` runs again with
    the card as its device, which runs its step there: the counted
    argument bytes must not exceed the measured ``max_memory_allocated``,
    and at least one cell must run.  ``python -m repro_torch.launch.dryrun
    --all`` counts every cell.

Each of phases 4, 5, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17 and 18 sets the
kernels' launch counts to 0 just before it drives its path and reads them
just after (phases 15 to 18 require none).  The line before the last is a JSON
object with each kernel's numbers; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
def train_card_vs_cpu(archs, dev) -> dict:
    """17(a): one ``make_train_step`` step of each arch's reduced config
    from the same weights (the port's seeded init, copied to the card) and
    the same ``data/pipeline.py`` batch, on the card and on the CPU: the
    loss, every gradient leaf of ``spec.loss_fn``, and every leaf of the
    new params and of Adam's ``m``, ``v`` (and ``master``) within
    ``TRAIN_TOL`` of the largest magnitude (params: of max(1, it)).
    ``TRAIN_MICRO_ARCH`` steps with ``microbatch=2``; ``TRAIN_MASTER_ARCH``
    with bf16 params and a float32 master (``TRAIN_TOL_BF16``)."""
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.optim.adam import AdamConfig, init_adam
    from repro_torch.tree import leaves, tree_map, unflatten

    cpu = torch.device("cpu")
    worst = {}
    for name, spec in archs.items():
        cfg = spec.cfg(reduced=True)
        micro = 2 if name == TRAIN_MICRO_ARCH else 1
        master = name == TRAIN_MASTER_ARCH
        params, _ = spec.init(torch.Generator().manual_seed(0), reduced=True, device=cpu)
        if master:
            params = tree_map(lambda t: t.to(torch.bfloat16), params)
        batch = make_batch_fn(spec, cfg, TRAIN_SMALL_BATCH, TRAIN_SMALL_SEQ, cpu)(0)
        step = spec.make_train_step(AdamConfig(**TRAIN_SMALL_ADAM), reduced=True,
                                    microbatch=micro)
        loss_fn = spec.loss_fn(reduced=True)

        def run(p, d):
            b = {k: v.to(d) for k, v in batch.items()}
            flat = [t.detach().requires_grad_(True) for t in leaves(p)]
            loss = loss_fn(unflatten(p, flat), b)
            out = {"loss": loss.detach()}
            out.update((f"grad {i}", g) for i, g in enumerate(torch.autograd.grad(loss, flat)))
            p2, st2, metrics = step(p, init_adam(p, master_weights=master), b)
            out["step loss"] = metrics["loss"]
            trees = [("params", p2), ("m", st2["m"]), ("v", st2["v"])]
            if master:
                trees.append(("master", st2["master"]))
            for what, tree in trees:
                out.update((f"{what} {i}", t) for i, t in enumerate(leaves(tree)))
            return out

        want = run(params, cpu)
        got = run(tree_map(lambda t: t.to(dev), params), dev)
        tol = TRAIN_TOL_BF16 if master else TRAIN_TOL
        err = 0.0
        for what, w in want.items():
            g = got[what].float().cpu()
            w = w.float()
            e, scale = rel_err(g, w)
            scale = max(1.0, scale) if what.startswith(("params", "master")) else scale
            check(e <= tol * max(scale, 1e-30), f"{name} {what}: card off the CPU by {e} "
                  f"(max |CPU| {scale})")
            err = max(err, e / max(scale, 1e-30))
        worst[name] = err
        mode = ("microbatch 2" if micro > 1 else "bf16 params, float32 master" if master
                else "float32")
        print(f"[train] 17(a) {name} reduced ({spec.kind}, {mode}): "
              f"loss {float(want['loss']):.4f}; "
              f"loss, {sum(k.startswith('grad') for k in want)} gradient leaves and the new "
              f"params and Adam leaves, card against CPU, max err / max |CPU| {err:.2e}")
    return worst


def train_full(spec, dev, card: str) -> dict:
    """17(b): ``TRAIN_ARCH`` at full width and depth in float32 through
    ``launch/train.py``'s own functions (``init_train_state``,
    ``make_batch_fn``) and ``make_train_step``: one warm-up step, then
    ``TRAIN_FULL_STEPS`` timed ones; the loss must fall.  Prints ms per step
    (CUDA events), tokens/s (host clock), the Adam update alone, peak
    memory and TF32, beside the bounds from the reference's parameter
    count."""
    from repro_torch.launch.train import init_train_state, make_batch_fn
    from repro_torch.optim.adam import AdamConfig, adam_update
    from repro_torch.tree import leaves

    cfg = spec.cfg()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt_state = init_train_state(spec, False, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(t.numel() for t in leaves(params))
    check(n == TRAIN_ARCH_PARAMS, f"{spec.name}: {n} params, the reference has "
          f"{TRAIN_ARCH_PARAMS}")
    state_gb = sum(t.numel() * t.element_size() for t in leaves((params, opt_state))) / 1e9
    adam_cfg = AdamConfig(lr=TRAIN_FULL_LR, total_steps=TRAIN_FULL_STEPS + 1, warmup_steps=1)
    step_fn = spec.make_train_step(adam_cfg)
    batch_fn = make_batch_fn(spec, cfg, TRAIN_BATCH, TRAIN_SEQ, dev)
    losses, step_ms = [], []
    wall = 0.0
    for i in range(1 + TRAIN_FULL_STEPS):
        batch = batch_fn(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        end.record()
        losses.append(float(metrics["loss"]))
        if i:  # the first step is the warm-up
            wall += time.perf_counter() - t0
            step_ms.append(start.elapsed_time(end))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)), f"{spec.name}: loss not finite: {losses}")
    check(losses[-1] < losses[0], f"{spec.name}: loss did not fall: {losses}")
    adam_ms = device_ms(lambda: adam_update(adam_cfg, params, opt_state["m"], opt_state), 3)
    # one more step under torch.profiler: where the device's time goes
    from torch.profiler import ProfilerActivity, profile

    batch = batch_fn(1 + TRAIN_FULL_STEPS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kern) / 1e3
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 8 * n * tokens  # 6NT for the step, 2NT for remat's second forward
    bound_step_ms = 1e3 * flops / FP32_FLOPS_PER_S
    adam_bytes = 7 * 4 * n  # read p, g, m, v; write p, m, v (float32)
    bound_adam_ms = 1e3 * adam_bytes / HBM_BYTES_PER_S
    med = float(np.median(step_ms))
    print(f"[train] 17(b) {spec.name} full width and depth ({cfg.n_layers} layers, d "
          f"{cfg.d_model}), float32, {n:,} params drawn in {init_s:.1f} s; params, m and v "
          f"{state_gb:.2f} GB (+ gradients {4 * n / 1e9:.2f} GB); TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN {torch.backends.cudnn.allow_tf32}; "
          f"{card}")
    print(f"[train] 17(b) B={TRAIN_BATCH} S={TRAIN_SEQ}, lr {TRAIN_FULL_LR}: loss "
          + " ".join(f"{v:.4f}" for v in losses)
          + f"; ms per step (CUDA events) median {med:.1f} (min {min(step_ms):.1f}, max "
          f"{max(step_ms):.1f}), bound {bound_step_ms:.1f} ms ({flops / 1e12:.2f} TFLOP at "
          f"{FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s fp32: 6NT + 2NT for remat), "
          f"{TRAIN_FULL_STEPS * tokens / wall:.0f} tokens/s (host clock over "
          f"{TRAIN_FULL_STEPS} steps); Adam update alone {adam_ms:.2f} ms, bound "
          f"{bound_adam_ms:.2f} ms ({adam_bytes / 1e9:.1f} GB at 3.35 TB/s); peak memory "
          f"{peak_gb:.2f} GB")
    print(f"[train] 17(b) one step under torch.profiler: {prof_ms:.1f} ms (host clock), "
          f"{len(kern)} kernels, device busy {busy:.1f} ms ({100 * busy / prof_ms:.0f}%); most "
          "device time: " + "; ".join(f"{n[:60]} {t:.1f} ms" for n, t in top) + f" [{card}]")
    del params, opt_state, metrics
    torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=med, bound_step_ms=bound_step_ms, adam_ms=adam_ms,
                bound_adam_ms=bound_adam_ms, peak_gb=peak_gb, tokens_per_s=TRAIN_FULL_STEPS
                * tokens / wall, busy_ms=busy, kernels=len(kern))


def train_restart(dev) -> dict:
    """17(c): ``RESTART_ARGS`` through ``launch/train.py``'s ``main`` on the
    card: 8 steps against 4 steps, a checkpoint, ``--resume`` and 4 more
    (checkpoints in a temporary directory inside the checkout); the final
    losses within 1e-5 relative, and whether their bits agree."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch import train as train_mod

    args = RESTART_ARGS + ["--device", str(dev)]
    with contextlib.redirect_stdout(io.StringIO()) as log, \
            tempfile.TemporaryDirectory(dir=REPO, prefix=".ckpt_") as d:
        full = train_mod.main(args + ["--steps", "8"])
        train_mod.main(args + ["--steps", "4", "--ckpt-dir", d, "--ckpt-every", "4"])
        resumed = train_mod.main(args + ["--steps", "8", "--ckpt-dir", d, "--ckpt-every",
                                         "100", "--resume"])
    check("resumed from step 4" in log.getvalue(), "the restart did not resume from step 4")
    rel = abs(resumed[-1] - full[-1]) / abs(full[-1])
    check(len(resumed) == 4 and rel <= 1e-5, f"restart: final loss {resumed[-1]} against "
          f"{full[-1]} (relative {rel:.2e})")
    print(f"[train] 17(c) {RESTART_ARGS[1]} reduced on the card: 8 steps final loss "
          f"{full[-1]!r}, 4 + checkpoint + resume + 4: {resumed[-1]!r} (relative {rel:.2e}; "
          f"bits {'equal' if resumed[-1] == full[-1] else 'differ'}); losses after the resume "
          + " ".join(f"{v:.6f}" for v in resumed) + " against "
          + " ".join(f"{v:.6f}" for v in full[4:]))
    return dict(full=full, resumed=resumed, rel=rel)


def train_drive(dev, card: str) -> dict:
    """Phase 17: the training stack (no SCV kernel on the path)."""
    from repro_torch.configs import ARCHS
    kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")

    t0 = time.perf_counter()
    kmod.reset_counts()
    worst = train_card_vs_cpu(ARCHS, dev)
    full = train_full(ARCHS[TRAIN_ARCH], dev, card)
    restart = train_restart(dev)
    launches = (kmod.launches, kmod.scalar_launches)
    check(launches == (0, 0), f"phase 17 launched SCV kernels: {launches}")
    seconds = time.perf_counter() - t0
    print(f"[train] phase 17: {seconds:.1f} s; SCV kernel launches: 0 (optim/, train/, data/ "
          f"and launch/train.py reach no pl.pallas_call)")
    return dict(worst=worst, full=full, restart=restart, seconds=seconds)


def timed_main(args, microbatch=None, mesh=None, float32=False, layers=None) -> tuple:
    """``launch/train.py``'s ``main(args)`` with stdout captured: ``(losses,
    grad norms, log, ms of each step between CUDA events recorded around it
    on an idle stream, max_memory_allocated)``.  The step function is
    wrapped for the timing; with ``microbatch`` it is made with that many
    microbatches; ``mesh(devices)`` stands for ``--mesh prod``'s
    ``make_production_mesh``; with ``float32`` the arch computes
    in float32 (its config's ``dtype``); ``layers`` cuts its depth
    (``n_layers``)."""
    import contextlib
    import io

    from repro_torch.configs import ARCHS
    from repro_torch.configs.common import ArchSpec
    from repro_torch.launch import train as train_mod

    name = args[args.index("--arch") + 1]
    spec = ARCHS[name]
    cut = ({"dtype": torch.float32} if float32 else {}) | ({"n_layers": layers} if layers else {})
    if cut:
        ARCHS[name] = dataclasses.replace(spec, config=dataclasses.replace(spec.config, **cut))
    make_mesh = train_mod.make_production_mesh
    if mesh is not None:
        train_mod.make_production_mesh = lambda multi_pod=False, devices=None: mesh(devices)

    ms, gnorms = [], []
    make = ArchSpec.make_train_step

    def timed(self, *a, **kw):
        if microbatch is not None:
            kw["microbatch"] = microbatch
        step = make(self, *a, **kw)

        def run(*xs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            out = step(*xs)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
            gnorms.append(float(out[2]["grad_norm"]))
            return out

        return run

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ArchSpec.make_train_step = timed
    try:
        with contextlib.redirect_stdout(io.StringIO()) as log:
            losses = train_mod.main(args)
    finally:
        ArchSpec.make_train_step = make
        train_mod.make_production_mesh = make_mesh
        ARCHS[name] = spec
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    return losses, gnorms, log.getvalue(), ms, peak


def mesh_line(log: str, n_positions: int) -> str:
    """The run's ``[mesh]`` line, checked: every one of the
    ``n_positions`` positions holds (``held_bytes``) the bytes its shard
    shapes count."""
    lines = [ln for ln in log.splitlines() if ln.startswith("[mesh]")]
    check(len(lines) == 1, f"18: mesh lines {lines}")
    shapes = lines[0].split("positions holds ")[1].split(" (shard shapes)")[0]
    check(f"each of the {n_positions} positions" in lines[0]
          and f"held_bytes: {n_positions} position(s) {shapes}" in lines[0],
          f"18: held bytes differ from the shard shapes: {lines[0]}")
    return lines[0]


def data_only(n):
    """A data-only mesh of ``n`` positions (a "model" axis of 1) over a
    pool, for ``timed_main``'s ``mesh``."""
    from repro_torch.launch.mesh import make_mesh

    return lambda devices: make_mesh(n, model_parallel=1, devices=devices)


def one_row(devices):
    """The (1, 16) mesh: one data row of 16 "model" positions."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(16, model_parallel=16, devices=devices)


def mesh_card_vs_cpu(arch, make, batch_size, what, dev) -> tuple:
    """``arch`` reduced, one step on the mesh ``make(pool)`` lays over the
    card and on the same mesh over the CPU, from the same weights and
    batch: the loss, ``grad_norm`` and every leaf of the new params, ``m``
    and ``v`` within ``TRAIN_TOL`` of the largest magnitude (params: of
    max(1, it)).  Returns ``(the CPU's metrics, the largest error over
    that scale, the number of leaves held)``."""
    import contextlib
    import io

    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import device_pool
    from repro_torch.launch.train import make_batch_fn, place_on_mesh
    from repro_torch.optim.adam import AdamConfig, init_adam
    from repro_torch.train import sharding as shd
    from repro_torch.tree import leaves, tree_map

    cpu = torch.device("cpu")
    spec = ARCHS[arch]
    params, axes = spec.init(torch.Generator().manual_seed(0), reduced=True, device=cpu)
    batch = make_batch_fn(spec, spec.cfg(reduced=True), batch_size, TRAIN_SMALL_SEQ, cpu)(0)
    step = spec.make_train_step(AdamConfig(**TRAIN_SMALL_ADAM), reduced=True)

    def run(d):
        p = tree_map(lambda t: t.to(d), params)
        mesh = make(device_pool(d))
        with contextlib.redirect_stdout(io.StringIO()):
            p, st = place_on_mesh(mesh, p, init_adam(p), axes)
        p, st, m = step(p, st, {k: v.to(d) for k, v in batch.items()})
        out = {"loss": m["loss"].reshape(1), "grad_norm": m["grad_norm"].reshape(1)}
        for what, tree in (("params", p), ("m", st["m"]), ("v", st["v"])):
            out.update((f"{what} {i}", shd.gather(x, cpu)) for i, x in enumerate(leaves(tree)))
        return out

    want, got = run(cpu), run(dev)
    worst = 0.0
    for leaf, w in want.items():
        e, scale = rel_err(got[leaf].cpu(), w)
        scale = max(1.0, scale) if leaf.startswith("params") else max(scale, 1e-30)
        check(e <= TRAIN_TOL * scale, f"{what} {arch} {leaf}: card off the CPU by {e} "
              f"(max |CPU| {scale})")
        worst = max(worst, e / scale)
    return want, worst, len(want) - 2


def mesh_moe(dev, card: str) -> float:
    """18(a)'s MoE case: ``MESH_MOE_ARCH`` reduced on the 16x16 mesh,
    ``MESH_MOE_BATCH`` sequences (16 data groups of one), one step, card
    against CPU (:func:`mesh_card_vs_cpu`).  Every group's aux loss takes
    the whole batch's expert shares, in remat's recompute too, which on
    the card runs on autograd's device thread; a group's own shares move
    ``m`` by 0.4-0.9% of it.  Returns the largest error over the scale."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train import sharding as shd

    check(shd.batch_groups(make_production_mesh(devices=(torch.device("cpu"),)),
                           MESH_MOE_BATCH)[1] == 16, "18(a) MoE: not 16 groups")
    want, worst, n = mesh_card_vs_cpu(MESH_MOE_ARCH, lambda pool: make_production_mesh(
        devices=pool), MESH_MOE_BATCH, "18(a) MoE", dev)
    print(f"[mesh] 18(a) {MESH_MOE_ARCH} reduced, 16 groups (batch {MESH_MOE_BATCH}, seq "
          f"{TRAIN_SMALL_SEQ}), one step on the 16x16 mesh over the card against the CPU: "
          f"loss {float(want['loss'])}, grad_norm {float(want['grad_norm'])}; loss, grad_norm "
          f"and {n} param/m/v leaves within {worst:.2e} of the largest magnitude "
          f"(limit {TRAIN_TOL}) [{card}]")
    return worst


def mesh_train(dev, card: str) -> dict:
    """18(a): ``MESH_GROUPS_ARGS`` (``TRAIN_ARCH`` at full width, its depth
    cut to ``MESH_GROUPS_LAYERS``, 16 data groups of one sequence, 2 steps) through ``launch/train.py``'s
    ``main`` on ``dev`` with ``--mesh prod`` laid out data-only (16x1: a
    "model" axis of 1, so each group computes whole), held bit for bit
    (losses and ``grad_norm`` of both steps) against ``--mesh none`` made
    with 16 microbatches: the same one-sequence passes summed in the same
    float32 order; plain ``--mesh none`` gives the step ms and memory to
    compare and the gap of one pass over 16 sequences, printed.  Each
    run's step ms (CUDA events),
    ``max_memory_allocated`` and the ``[mesh]`` line (each position's
    bytes from the shard shapes and as held, each device's sum) are
    printed.  Then :func:`mesh_moe`.  Over several cards the 16-group run
    is made once more over all of them, held bit for bit to the same
    witness.  (The 16x16 mesh, whose groups split their products over
    "model", is 18(d).)"""
    cell_args = list(MESH_GROUPS_ARGS) + ["--device", str(dev)]
    runs = {}
    for run, micro in (("prod", None), ("none", None), ("16 microbatches", 16)):
        t0 = time.perf_counter()
        losses, gnorms, log, ms, peak = timed_main(
            cell_args + ["--mesh", "prod" if run == "prod" else "none"], micro,
            mesh=data_only(16) if run == "prod" else None, layers=MESH_GROUPS_LAYERS)
        runs[run] = dict(losses=losses, gnorms=gnorms, ms=ms, peak=peak,
                         seconds=time.perf_counter() - t0)
        if run == "prod":
            line = mesh_line(log, 16)
    prod, none, w = runs["prod"], runs["none"], runs["16 microbatches"]
    check(all(np.isfinite(none["losses"])) and len(prod["losses"]) == len(none["losses"]) == 2,
          f"18(a): {runs}")
    check(prod["losses"] == w["losses"] and prod["gnorms"] == w["gnorms"],
          f"18(a): --mesh prod (16x1) losses {prod['losses']}, grad_norm {prod['gnorms']} "
          f"against {w['losses']}, {w['gnorms']}")
    rel = [abs(a - b) / abs(b) for a, b in zip(prod["losses"], none["losses"])]
    print(line + f" [{card}]")
    print(f"[mesh] 18(a) 16 groups: launch/train.py main {' '.join(cell_args)} --mesh prod "
          f"(16x1, data only; {MESH_GROUPS_LAYERS} layers): losses {prod['losses']}, grad_norm {prod['gnorms']}, bit for bit "
          f"against --mesh none with 16 microbatches (its step ms "
          f"{[round(x, 1) for x in w['ms']]}, max_memory_allocated {w['peak'] / 1e9:.2f} GB); "
          f"relative gaps to plain --mesh none, one pass over 16 sequences, {rel[0]:.3e}, "
          f"{rel[1]:.3e} (printed, not held); step ms --mesh prod "
          f"{[round(x, 1) for x in prod['ms']]} against --mesh none "
          f"{[round(x, 1) for x in none['ms']]} (CUDA events); "
          f"max_memory_allocated {prod['peak'] / 1e9:.2f} GB against {none['peak'] / 1e9:.2f} GB; "
          f"{prod['seconds']:.1f} s and {none['seconds']:.1f} s a run (init included) [{card}]")
    out = {"16 groups": runs, "moe": mesh_moe(dev, card)}
    n = torch.cuda.device_count()
    if n > 1:
        cards = list(MESH_GROUPS_ARGS) + ["--device", "cuda"]
        losses, gnorms, log, ms, peak = timed_main(cards + ["--mesh", "prod"],
                                                   mesh=data_only(16), layers=MESH_GROUPS_LAYERS)
        line = mesh_line(log, 16)
        check(f"over {n} distinct device(s)" in line and losses == w["losses"]
              and gnorms == w["gnorms"],
              f"18(a) over {n} cards: {line}, losses {losses}, grad_norm {gnorms} against "
              f"{w['losses']}, {w['gnorms']}")
        print(line + f" [{card}]")
        print(f"[mesh] 18(a) 16 groups over {n} cards: losses {losses} and grad_norm {gnorms} "
              f"bit for bit against --mesh none with 16 microbatches; step ms "
              f"{[round(x, 1) for x in ms]} [{card}]")
        out["cards"] = dict(losses=losses, ms=ms, peak=peak)
    else:
        print("[mesh] 18(a) over several cards: not run (one card in this machine)")
    return out


def tp_gap(got, want) -> float:
    """The largest relative gap between two runs' losses or grad norms."""
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def tp_drive(dev, card: str) -> dict:
    """18(d): tensor parallelism in compute.  ``TP_ARGS`` (``TRAIN_ARCH``
    at full width and depth, computed in float32, phase 17(b)'s B x S, 2
    steps at LR 1e-6) through ``launch/train.py``'s ``main`` with ``--mesh prod``:
    16x16 over the card, one data group whose products split over the 16
    "model" positions (mamba heads 3 a position, ``w_in``'s packed
    columns cut across their blocks; the vocabulary 3,152 rows a
    position).  Held: a second run's first step and the same step on a
    (1, 16) mesh give equal bits; ``--mesh none``'s losses within ``TP_TOL`` and
    grad norms within ``TP_TOL_GNORM`` relative.  Then
    ``TP_WHISPER_ARGS`` (whisper-small, full width, ``TP_WHISPER_LAYERS``
    of its 12 layers a side, float32): its
    12 heads do not divide 16, so attention runs ``seq_sharded`` (16
    divides the 256-token sequences); ``--mesh none`` within the same.
    Then the reduced configs of the five families on a (2, 2) mesh, one
    step, card against CPU (:func:`mesh_card_vs_cpu`).  Step ms (CUDA
    events) and ``max_memory_allocated`` of each run are printed."""
    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    out = {}
    for name, args, runs, layers in (
            (TRAIN_ARCH, TP_ARGS, ("prod", "prod again", "1x16", "none"), None),
            ("whisper-small", TP_WHISPER_ARGS, ("prod", "none"), TP_WHISPER_LAYERS)):
        got = {}
        for run in runs:
            t1 = time.perf_counter()
            again = ["--steps", "1"] if run in ("prod again", "1x16") else []  # step 1
            losses, gnorms, log, ms, peak = timed_main(
                list(args) + again + ["--device", str(dev), "--mesh",
                                      "none" if run == "none" else "prod"],
                mesh=one_row if run == "1x16" else None, float32=True, layers=layers)
            got[run] = dict(losses=losses, gnorms=gnorms, ms=ms, peak=peak,
                            seconds=time.perf_counter() - t1)
            if run == "prod":
                line = mesh_line(log, 256)
        prod, none = got["prod"], got["none"]
        check(all(np.isfinite(prod["losses"] + prod["gnorms"])) and len(prod["losses"]) == 2,
              f"18(d) {name}: {got}")
        for other in [r for r in runs if r not in ("prod", "none")]:
            n = len(got[other]["losses"])
            check(got[other]["losses"] == prod["losses"][:n]
                  and got[other]["gnorms"] == prod["gnorms"][:n],
                  f"18(d) {name}: {other} {got[other]['losses']} {got[other]['gnorms']} against "
                  f"prod {prod['losses']} {prod['gnorms']}")
        gaps = tp_gap(prod["losses"], none["losses"]), tp_gap(prod["gnorms"], none["gnorms"])
        check(gaps[0] <= TP_TOL and gaps[1] <= TP_TOL_GNORM,
              f"18(d) {name}: --mesh prod off --mesh none by {gaps} (limits {TP_TOL}, "
              f"{TP_TOL_GNORM})")
        print(line + f" [{card}]")
        same = [r for r in runs if r not in ("prod", "none")]
        print(f"[tp] 18(d) {name}: launch/train.py main {' '.join(args)} --mesh prod, float32: "
              f"losses {prod['losses']}, grad_norm {prod['gnorms']}; equal bits in "
              f"{', '.join(same) or 'no second run'}; --mesh none {none['losses']}, "
              f"{none['gnorms']}: relative gaps {gaps[0]:.3e} (losses, limit {TP_TOL}), "
              f"{gaps[1]:.3e} (grad_norm, limit {TP_TOL_GNORM}); step ms " + "; ".join(
                  f"{r} {[round(x, 1) for x in got[r]['ms']]}" for r in runs)
              + " (CUDA events); max_memory_allocated " + "; ".join(
                  f"{r} {got[r]['peak'] / 1e9:.2f} GB" for r in runs)
              + "; s a run (init included) " + "; ".join(
                  f"{r} {got[r]['seconds']:.1f}" for r in runs) + f" [{card}]")
        out[name] = got
    small = {}
    for arch in TP_FAMILIES:
        want, worst, n = mesh_card_vs_cpu(
            arch, lambda pool: make_mesh(4, model_parallel=2, devices=pool), TRAIN_SMALL_BATCH,
            "18(d)", dev)
        small[arch] = worst
        print(f"[tp] 18(d) {arch} reduced on a (2, 2) mesh (two groups, products split two "
              f"ways), one step, card against CPU: loss {float(want['loss'])}, grad_norm "
              f"{float(want['grad_norm'])}; loss, grad_norm and {n} param/m/v leaves within "
              f"{worst:.2e} of the largest magnitude (limit {TRAIN_TOL}) [{card}]")
    out["small"] = small
    out["seconds"] = time.perf_counter() - t0
    print(f"[tp] 18(d): {out['seconds']:.1f} s [{card}]")
    return out


def psum_drive(spec, dev, card: str) -> dict:
    """18(b): ``compressed_psum`` over a pool of ``PSUM_SLOTS`` slots of
    ``dev``, on gradient trees of ``spec``'s shapes (``TRAIN_ARCH`` at full
    size) drawn from a seeded generator there, with error trees: the mean and every
    residual equal the same call on the CPU bit for bit on a seeded sample
    of leaves; one call timed (CUDA events) beside its byte bound; then
    ``PSUM_STEPS`` steps of error feedback from zero residuals, after which
    the accumulated compressed mean is within one quantization step (the
    last call's shared scale) of the accumulated true mean, leaf by leaf."""
    from repro_torch.core.exec import pool_device
    from repro_torch.models.transformer import leaf_paths
    from repro_torch.optim.compress import compressed_psum, ef_state

    pool = tuple(pool_device(dev) for _ in range(PSUM_SLOTS))
    shapes = dict(leaf_paths(spec.init(None, device="meta")[0]))
    n = sum(t.numel() for t in shapes.values())
    gen = torch.Generator(device=pool[0]).manual_seed(0)

    def draw(scale=1.0):
        return [{k: scale * torch.randn(tuple(t.shape), generator=gen, device=d)
                 for k, t in shapes.items()} for d in pool]

    grads, errors = draw(), draw(0.01)
    mean, new_err = compressed_psum(grads, errors, "pod")
    rng = np.random.default_rng(0)
    small = sorted(k for k, t in shapes.items() if t.numel() <= PSUM_CPU_MAX)
    sample = sorted(rng.choice(small, size=PSUM_CPU_LEAVES, replace=False).tolist())
    cpu_mean, cpu_err = compressed_psum([{k: g[k].cpu() for k in sample} for g in grads],
                                        [{k: e[k].cpu() for k in sample} for e in errors], "pod")
    for k in sample:
        check(torch.equal(mean[k].cpu(), cpu_mean[k]), f"18(b): mean {k} card != CPU")
        for i in range(PSUM_SLOTS):
            check(torch.equal(new_err[i][k].cpu(), cpu_err[i][k]),
                  f"18(b): member {i} residual {k} card != CPU")
    del mean, new_err
    ms = device_ms(lambda: compressed_psum(grads, errors, "pod"), 3)
    # each member's g and e read once, its residual written once, the mean once
    nbytes = (2 * 4 * PSUM_SLOTS + 4 * PSUM_SLOTS + 4) * n
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    errors = [ef_state(g) for g in grads]
    total_true = {k: torch.zeros(tuple(t.shape), device=pool[0]) for k, t in shapes.items()}
    total_comp = {k: torch.zeros(tuple(t.shape), device=pool[0]) for k, t in shapes.items()}
    t0 = time.perf_counter()
    for step in range(PSUM_STEPS):
        grads = draw()
        if step == PSUM_STEPS - 1:  # the last call's shared scale, leaf by leaf
            scale = {k: max(float((g[k] + e[k]).abs().max()) for g, e in zip(grads, errors))
                     / 127.0 for k in shapes}
        mean, errors = compressed_psum(grads, errors, "pod")
        for k in shapes:
            total_true[k] += sum(g[k] for g in grads) / PSUM_SLOTS
            total_comp[k] += mean[k]
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    worst = max(float((total_true[k] - total_comp[k]).abs().max()) / scale[k] for k in shapes)
    check(worst <= 1.0, f"18(b): accumulated mean off the true mean by {worst:.3f} "
          "quantization steps")
    print(f"[psum] 18(b) compressed_psum over {PSUM_SLOTS} slots of the card, {spec.name} "
          f"gradient trees ({len(shapes)} leaves, {n:,} entries a member, "
          f"{4 * n * PSUM_SLOTS / 1e9:.2f} GB of gradients + as much in errors): mean and "
          f"residuals equal the CPU's bit for bit on leaves {sample}; one call "
          f"{ms:.2f} ms (CUDA events), bound {bound_ms:.2f} ms ({nbytes / 1e9:.2f} GB: g and e "
          f"read, residuals and the mean written, at 3.35 TB/s; {ms / bound_ms:.1f}x); "
          f"{PSUM_STEPS} error-feedback steps in {loop_s:.1f} s: accumulated mean within "
          f"{worst:.3f} of one quantization step of the true mean (the last call's scale, "
          f"{min(scale.values()):.3e}-{max(scale.values()):.3e}) [{card}]")
    del grads, errors, total_true, total_comp, mean
    torch.cuda.empty_cache()
    return dict(ms=ms, bound_ms=bound_ms, worst=worst)


def dryrun_cells() -> list:
    """18(c)'s cells: one arch of each family, each of its shapes (one of
    each shape kind, both decode shapes where it lists two), the dearest
    first."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.common import SHAPES

    order = {"train": 0, "prefill": 1, "decode": 2}
    cells = [(a, s) for a in DRYRUN_ARCHS for s in ARCHS[a].shapes]
    return sorted(cells, key=lambda c: order[SHAPES[c[1]].kind])


def dryrun_drive(counted: dict, dev, card: str) -> dict:
    """18(c): the counts of ``dryrun_cell`` on the 16x16 mesh (made in
    worker processes while 18(a) and 18(b) ran); each cell it finds
    ``fits_one_card`` is run again with ``device=dev``, which runs the step
    on the card: the counted argument bytes must not exceed the measured
    ``max_memory_allocated`` less what earlier phases still held, and the
    count must be the same."""
    from repro_torch.launch.dryrun import dryrun_cell

    on_card = {}
    for (a, s), r in counted.items():
        check(r["status"] == "ok" and r["flops_total"] > 0 and r["memory"]["argument_bytes"] > 0,
              f"18(c) {a} x {s}: {r}")
        w = r["whole_cell"]
        print(f"[dryrun] 18(c) {a} x {s} on {r['mesh']}: {r['flops_total']:.4e} FLOP a step, "
              f"{r['flops_per_device']:.4e} on position (0, 0) "
              f"(counted on meta in {r['count_s']:.1f} s), {r['memory']['argument_bytes']:,} B of "
              f"arguments a position; one card would hold {w['argument_bytes'] / 1e9:.2f} GB of "
              f"arguments, peak {w['peak_bytes'] / 1e9:.2f} GB: "
              f"{'fits' if r['fits_one_card'] else 'does not fit'} one card")
        if r["fits_one_card"]:
            got = dryrun_cell(a, s, verbose=False, device=str(dev))
            run = got["card"]
            check(run is not None and run["finite"], f"18(c) {a} x {s}: no finite card run")
            check(got["flops_total"] == r["flops_total"], f"18(c) {a} x {s}: counts differ")
            peak = run["max_memory_allocated"] - run["allocated_before"]
            check(w["argument_bytes"] <= peak, f"18(c) {a} x {s}: {w['argument_bytes']} B "
                  f"counted > {peak} B measured")
            on_card[(a, s)] = dict(ms=run["ms"], ms_first=run["ms_first"], peak=peak,
                                   counted=w["argument_bytes"], meta_peak=w["peak_bytes"],
                                   flops=r["flops_total"])
            print(f"[dryrun] 18(c) {a} x {s} on the card: step {run['ms']:.2f} ms (first "
                  f"{run['ms_first']:.2f}; CUDA events), max_memory_allocated "
                  f"{run['max_memory_allocated'] / 1e9:.2f} GB, less the "
                  f"{run['allocated_before'] / 1e9:.2f} GB held before: {peak / 1e9:.2f} GB "
                  f"against {w['argument_bytes'] / 1e9:.2f} GB of arguments "
                  f"counted (measured/counted {peak / w['argument_bytes']:.3f}) and "
                  f"{w['peak_bytes'] / 1e9:.2f} GB peak counted on meta "
                  f"({peak / w['peak_bytes']:.3f}) [{card}]")
    check(len(on_card) >= 1, "18(c): no cell ran on the card")
    return on_card


def mesh_drive(dev, card: str) -> dict:
    """Phase 18: the sharding rules and meshes, the int8 compression and the
    dry run (no SCV kernel on the path)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.configs import ARCHS
    from repro_torch.launch.dryrun import dryrun_cell
    kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")

    t0 = time.perf_counter()
    kmod.reset_counts()
    with ProcessPoolExecutor(DRYRUN_WORKERS,
                             mp_context=multiprocessing.get_context("spawn")) as workers:
        futures = {c: workers.submit(dryrun_cell, *c, False, False, "cpu")
                   for c in dryrun_cells()}
        mesh = mesh_train(dev, card)
        psum = psum_drive(ARCHS[TRAIN_ARCH], dev, card)
        tp = tp_drive(dev, card)
        t_wait = time.perf_counter()
        counted = {c: f.result() for c, f in futures.items()}
        waited = time.perf_counter() - t_wait
    on_card = dryrun_drive(counted, dev, card)
    launches = (kmod.launches, kmod.scalar_launches)
    check(launches == (0, 0), f"phase 18 launched SCV kernels: {launches}")
    seconds = time.perf_counter() - t0
    print(f"[mesh] phase 18: {seconds:.1f} s ({len(counted)} cells counted by "
          f"{DRYRUN_WORKERS} workers, {waited:.1f} s waited for them after 18(d)); SCV kernel "
          "launches: 0 (train/sharding.py, train/tp.py, launch/mesh.py, optim/compress.py, "
          "launch/hlocost.py and launch/dryrun.py reach no pl.pallas_call)")
    return dict(mesh=mesh, psum=psum, tp=tp, on_card=on_card, seconds=seconds)


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 rate outside the tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/scv_spmm/csrc/scv_spmm.cu"
REPLACES = "src/repro/kernels/scv_spmm/scv_spmm.py:197"
REPLACES_DENSE = "src/repro/kernels/scv_spmm/scv_spmm.py:169"
REPLACES_CHAIN = "src/repro/kernels/scv_spmm/scv_spmm.py:274"
REPLACES_SCALAR = "src/repro/kernels/scv_spmm/scv_spmm.py:57"
ARXIV_SEED = 0
SERVE_REQUESTS = 128
# dense-block graphs (nodes, edges): the reference kernel benchmark's own
# (benchmarks/kernel_bench.py:48-49), and a mixed regime where about half
# of the tiles and of the entries take the dense branch
REF_DENSE = (2048, 1_000_000)
MIXED_DENSE = (8192, 4_000_000)
UNIT_WORK_SWEEP = (512, 1024, 2048, 4096, 8192)  # arxiv chain, measured only
DENSE_THRESHOLD_SWEEP = (64, 128, 192, 256, 384, 512, 768)  # T = 64, measured only; x4 at T = 128
# chain ms of the same kernels in an earlier run (PERF.md section 6's kernel
# table; H100 80GB HBM3, 700 W), printed beside this run's: a drift of the
# card or the host shows against them
BEFORE_MS = {
    ("serving composite", 128): 0.0314, ("arxiv", 128): 0.2595, ("arxiv", 40): 0.1668,
    ("2048/1000000 T=64", 128): 0.1070, ("8192/4000000 T=64", 128): 0.6386,
    ("2048/1000000 T=128", 128): 0.1674,
    ("dZ", "8192/4000000"): 0.6407, ("dZ", "arxiv"): 0.2683,
}
TRAIN_STEPS = 20
TRAIN_LR = 2.0
STEP_MS_BEFORE = 15.762  # 8,192/4M step with the index_add_ backward (PERF.md, H100, 700 W)
DELTA_EDGES = 64  # edges a streaming delta touches
DELTA_STREAM = ("value update", "value update", "inserts + removes", "value update",
                "net shrink", "ladder crossing", "value update", "inserts + removes",
                "birth + death", "value update", "dense tile", "net shrink",
                "value update", "inserts + removes", "value update", "birth + death")
DENSE_LADDER = (8, 32, 128, 512)  # the engine's ladder and a rung above T^2/16
TRACKED_RATES = (0, 1, 4)  # value-update deltas between tracked waves
TRACKED_WAVES = 3
SHARD_SLOTS = 4  # devices in phase 12's executor pool
SHARD_DECISIONS = (("tiles", 4, 1), ("features", 1, 2), ("2d", 2, 2))  # and what decide picks
SHARD_NNZ_THRESHOLD = 4096  # phase 12's serving: a wave holding more entries is placed
SHARD_REQUESTS = 64
NARROW_FEATURES, NARROW_PARTS = 3, 8  # phase 12: feature slabs narrower than a column
TUNE_FEATURES = 32  # phase 13: the reference autotune benchmark's width
TUNE_TOP_K, TUNE_CALIB_REPS = 2, 2  # phase 13: the reference autotune benchmark's search
TUNE_REPS = 20  # phase 13: device_ms reps of each chain's longer re-time
CAPTURE_REPS = 20  # phase 14: forwards on the host clock, eager and captured
SERVE_PAIRS = 10  # phase 14: serving pairs, captured and eager engines in turns
SERVE_RATE = 400.0  # requests/s offered in phase 4's and phase 14's open loops
SERVE_NODE_BUCKETS = (2048, 4096, 8192)  # launch/graph_serve.py's engine
LM_PROMPT, LM_DECODE_STEPS = 20, 3  # phase 15(a): reduced configs, card against CPU
LM_GEMMA_LAYERS = 10  # phase 15(b): gemma3-4b's 4 leading globals + one 5-local/1-global group
LM_GEMMA_BATCH, LM_GEMMA_PROMPT = 2, 2048  # blockwise prefill; the 1,024-slot rings wrap
LM_SERVE_REQUESTS, LM_SERVE_PROMPT, LM_LONG_PROMPT = 8, 512, 2048  # phase 15(c), olmoe-1b-7b
LM_MAX_NEW, LM_MAX_BATCH = 32, 4
SSM_ARCHS = ("mamba2-780m", "zamba2-2.7b", "whisper-small")  # phase 16(a)
SSM_BATCH, SSM_PROMPT = 2, 600  # 16(b): three SSD chunks of 256, the last one padded
SSM_TOL = 1e-3  # 16(b): |d log-softmax|, chunked against recurrent, float32
WHISPER_BATCH, WHISPER_FRAMES, WHISPER_TOKENS = 4, 1500, 32  # Whisper's 30-second window
WHISPER_START = 50_258  # the first token the decoder is fed (start of transcript)
SSM_SERVE_ARCHS, SSM_SERVE_REQUESTS = ("zamba2-2.7b", "mamba2-780m"), 8  # 16(c)
PROFILE_STEPS = 5  # 16(c): decode steps timed on the host clock and under torch.profiler
# phase 17: the training stack.  (a) card against CPU on the reduced configs
# (one step at an LR of 5e-6: Adam's first step is about g / (|g| + eps), so
# an entry whose gradient is near zero on both devices may step anywhere in
# [-1, 1] on either; at this LR such a step stays far inside the tolerance)
TRAIN_SMALL_BATCH, TRAIN_SMALL_SEQ = 4, 16
TRAIN_SMALL_ADAM = dict(lr=1e-5, warmup_steps=2, total_steps=10)
TRAIN_MICRO_ARCH, TRAIN_MASTER_ARCH = "qwen1.5-32b", "mamba2-780m"
TRAIN_TOL, TRAIN_TOL_BF16 = 1e-4, 1e-2  # of the largest magnitude; bf16: one rounding
# (b) mamba2-780m at full width and depth, float32, through launch/train.py
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_FULL_STEPS, TRAIN_FULL_LR = (
    "mamba2-780m", 4, 512, 8, 3e-4)
TRAIN_ARCH_PARAMS = 780_382_464  # the reference's count for mamba2-780m
# (c) restart: the reference's tests/test_system.py case, on the card
RESTART_ARGS = ["--arch", "qwen1.5-32b", "--reduced", "--batch", "2", "--seq", "16",
                "--lr", "1e-3", "--total-steps", "8"]
# phase 18: (a) 16 data groups of one sequence on a data-only 16x1 mesh,
# held bit for bit against --mesh none with 16 microbatches
MESH_GROUPS_ARGS = ["--arch", TRAIN_ARCH, "--steps", "2", "--batch", "16", "--seq", "128"]
MESH_GROUPS_LAYERS = 16  # of 48: the script's time budget
# (d) tensor parallelism: --mesh prod (16x16, one group over 16 "model"
# positions) on phase 17(b)'s cell, computed in float32; whisper-small's
# 12 heads on 16 positions run seq_sharded (16 divides its 256 tokens)
# (a small LR, as 17(a)'s: Adam's first step moves an entry by about the
# LR whatever its gradient's size, so at phase 17(b)'s LR the entries whose
# gradients lie within rounding of zero step apart and the second step's
# gradients differ far more than the first's)
TP_ARGS = ["--arch", TRAIN_ARCH, "--steps", "2", "--batch", str(TRAIN_BATCH), "--seq",
           str(TRAIN_SEQ), "--lr", "1e-6"]
TP_WHISPER_ARGS = ["--arch", "whisper-small", "--steps", "2", "--batch", "2", "--seq", "256",
                   "--lr", "1e-6"]
TP_WHISPER_LAYERS = 6  # of 12 a side: the script's time budget
# the relative gaps to --mesh none allowed in the losses and in grad_norm:
# the split products and combines round otherwise in float32.  The loss
# limit was stated before the first run on the card; the grad_norm limit
# after it: at 48 layers the whole model's own gradients, summed over the
# batch at once or over two halves, land 2e-5 to 7.6e-4 apart leaf by leaf
# on the card (PERF.md §6)
TP_TOL, TP_TOL_GNORM = 1e-4, 5e-3
TP_FAMILIES = ("mamba2-780m", "zamba2-2.7b", "gemma3-4b", "whisper-small", "olmoe-1b-7b")
# an MoE arch (sorted dispatch, aux loss) reduced, 16 groups, card against CPU
MESH_MOE_ARCH, MESH_MOE_BATCH = "olmoe-1b-7b", 16
# (b) compressed_psum over four slots of the card; leaves held against the
# CPU: a seeded sample of those up to 100M entries (the CPU call takes seconds)
PSUM_SLOTS, PSUM_STEPS, PSUM_CPU_LEAVES, PSUM_CPU_MAX = 4, 30, 3, 100_000_000
# (c) the dry run: one arch of each family (the cheapest to count of its
# family), counted in worker processes meanwhile
DRYRUN_ARCHS = ("olmoe-1b-7b", "mamba2-780m", "zamba2-2.7b", "whisper-small")
DRYRUN_WORKERS = 6


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


def warm_up_composite(engine_kw: dict, pool, d_in: int) -> tuple:
    """A new engine with a warm-up burst of 32 requests queued, and the
    burst's first wave as the engine's scheduler forms it: (engine, wave,
    the composite graph the engine itself assembles for that wave)."""
    from repro_torch.launch.graph_serve import build_default_engine, make_requests

    warm = build_default_engine(**engine_kw)
    for r in make_requests(np.random.default_rng(1), pool, 32, d_in):
        warm.submit(r)
    first = warm.scheduler.form_wave(absorb=False)
    return warm, first, warm._batch_plan(first).graph


def arxiv_adjacency():
    """The ogbn-arxiv-scale graph: power-law, GCN-normalised, from
    ``ARXIV_SEED``."""
    from repro_torch.simul.datasets import TABLE_I, gcn_normalize, powerlaw_graph

    spec = TABLE_I["arxiv"]
    return gcn_normalize(powerlaw_graph(spec.nodes, spec.edges, seed=ARXIV_SEED))


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


def threads_within_default_smem(kmod):
    """The thread rule the scalar body was measured against (measured
    only): the widest width whose block fits the 48 KB it gets without
    opting in, else the module's rule."""
    rule = kmod.threads_for

    def within(n_feat, tile, body="vector", dense=False):
        full = min(kmod.MAX_THREADS, -(-n_feat // 32) * 32)
        for threads in range(full, 0, -32):
            if kmod.smem_bytes(tile, threads, body, dense) <= kmod.SMEM_BYTES:
                return threads
        return rule(n_feat, tile, body, dense)
    return within


def before(key) -> str:
    """The earlier design's time for ``key`` (:data:`BEFORE_MS`), for a print."""
    ms = BEFORE_MS.get(key)
    return "before: not measured" if ms is None else f"before: {ms:.4f} ms"


def sub_index(pr, units_kept):
    """The plan-level index ``pr`` cut to the units ``units_kept`` (their
    runs renumbered in order; a run left with one unit no longer split),
    for timing a part of a launch (measured only).  ``None`` keeps no unit:
    a grid of ``pr.n_units`` padding units, each returning at once (the
    launch's fixed cost)."""
    from repro_torch.core.scv import PlanRuns

    dev = pr.units.device
    if units_kept is None:
        units = np.zeros((pr.n_units, 4), np.int32)
        units[:, 2:] = -1
        return dataclasses.replace(pr, units=torch.from_numpy(units).to(dev),
                                   n_split_units=0)
    units = pr.units.cpu().numpy()[units_kept].copy()
    work = pr.unit_work[units_kept]
    runs, run_of = np.unique(units[:, 2], return_inverse=True)
    units[:, 2] = run_of
    counts = np.bincount(run_of)
    split = counts[run_of] > 1
    units[:, 3] = -1
    units[split, 3] = np.arange(int(split.sum()))
    rows = pr.rows[runs]
    return PlanRuns(
        pieces=pr.pieces, units=torch.from_numpy(units).to(dev),
        unit_ptr=torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int32)).to(dev),
        order=torch.from_numpy(np.argsort(-work, kind="stable").astype(np.int32)).to(dev),
        run_row=torch.from_numpy(rows.copy()).to(dev), rows=rows, unit_work=work,
        n_segments=pr.n_segments, n_live=pr.n_live, max_nnz=pr.max_nnz,
        n_split_units=int(split.sum()))


def launch_floor(label, segments, n_feat, gen, dev) -> dict:
    """Where one vector launch over ``segments`` goes (measured only): the
    whole launch against (a) a grid of as many padding units (the fixed
    cost of a launch), (b) its heaviest run alone (that run's units side by
    side and their merge), (c) its heaviest unit alone (the walk, written
    straight out, no merge) and (d) every other run (the rest of the card
    without the hub).  Accumulate mode, as a later segment's launch ran."""
    from repro_torch.core.scv import plan_runs
    kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")

    pr = plan_runs(tuple(s.runs for s in segments))
    z = torch.randn((segments[0].shape[1], n_feat), generator=gen).to(dev)
    out = torch.zeros((segments[0].padded_shape[0], n_feat), device=dev)
    vals = tuple(s.vals for s in segments)
    ptr = pr.unit_ptr.cpu().numpy()
    run_work = np.add.reduceat(pr.unit_work, ptr[:-1]) if pr.n_units else np.zeros(0)
    hub = int(np.argmax(run_work))
    hub_units = np.arange(ptr[hub], ptr[hub + 1])
    heaviest = int(np.argmax(pr.unit_work))
    parts = {"whole": pr, "empty grid": sub_index(pr, None),
             "heaviest run": sub_index(pr, hub_units),
             "heaviest unit": sub_index(pr, np.array([heaviest])),
             "other runs": sub_index(pr, np.setdiff1d(np.arange(pr.n_units), hub_units))}
    ms = {k: device_ms(lambda r=r: kmod.scv_spmm_chain(segments, vals, z, out, accumulate=True,
                                                       runs=r), 20)
          for k, r in parts.items()}
    print(f"[floor] {label} F={n_feat}: one launch of {pr.n_units} units ({pr.n_runs} runs, "
          f"{pr.n_split_units} in split runs): whole {ms['whole']:.4f} ms; empty grid "
          f"{ms['empty grid']:.4f} ms; heaviest run alone ({hub_units.size} units, "
          f"{int(run_work[hub])} work) {ms['heaviest run']:.4f} ms; heaviest unit alone "
          f"({int(pr.unit_work[heaviest])} work) {ms['heaviest unit']:.4f} ms; every other run "
          f"{ms['other runs']:.4f} ms")
    return ms


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


def plain_gcn_forward(params, cfg, g, x):
    """GCN forward with the plain aggregation (``ref.py``), on ``x``'s device."""
    from repro_torch.kernels.scv_spmm import ref

    h = x
    for i in range(cfg.n_layers):
        h = ref.scv_spmm_reference_plan(g.plan, h @ params[f"layer{i}"]["w"])
        h = h[: g.n_nodes]
        if i + 1 < cfg.n_layers:
            h = torch.relu(h)
    return h


class DeltaMaker:
    """Seeded edge deltas on the current adjacency of a graph (host)."""

    def __init__(self, seed: int, tile: int):
        self.rng = np.random.default_rng(seed)
        self.tile = tile

    def _keys(self, adj):
        return np.sort(adj.rows.astype(np.int64) * adj.shape[1] + adj.cols)

    def _absent(self, adj, k, rows=None, cols=None):
        """``k`` distinct coordinates not in ``adj``, drawn from ``rows`` x
        ``cols`` (default: the whole matrix)."""
        n = adj.shape[0]
        keys = self._keys(adj)
        out = np.zeros(0, np.int64)
        while out.size < k:
            r = self.rng.integers(*(rows or (0, n)), 4 * k)
            c = self.rng.integers(*(cols or (0, n)), 4 * k)
            cand = np.unique(r * adj.shape[1] + c)
            idx = np.minimum(np.searchsorted(keys, cand), keys.size - 1)
            cand = cand[keys[idx] != cand]
            out = np.union1d(out, cand)
        out = self.rng.permutation(out)[:k]
        return out // adj.shape[1], out % adj.shape[1]

    def _vals(self, k):
        return self.rng.uniform(0.01, 0.5, k).astype(np.float32)

    def _delta(self, ins_r, ins_c, ins_v, rem_idx, adj):
        from repro_torch.stream import DeltaBatch

        return DeltaBatch(np.asarray(ins_r, np.int32), np.asarray(ins_c, np.int32),
                          np.asarray(ins_v, np.float32), adj.rows[rem_idx].copy(),
                          adj.cols[rem_idx].copy())

    def _tile_counts(self, adj):
        T = self.tile
        nbc = -(-adj.shape[1] // T)
        key = (adj.rows // T).astype(np.int64) * nbc + adj.cols // T
        uk, counts = np.unique(key, return_counts=True)
        return key, uk, counts, nbc

    def make(self, kind: str, adj):
        k = DELTA_EDGES
        T = self.tile
        if kind == "value update":
            idx = self.rng.choice(adj.nnz, k, replace=False)
            return self._delta(adj.rows[idx], adj.cols[idx], self._vals(k), idx, adj)
        if kind in ("inserts + removes", "net shrink"):
            n_ins = k if kind == "inserts + removes" else k // 4
            r, c = self._absent(adj, n_ins)
            idx = self.rng.choice(adj.nnz, k, replace=False)
            return self._delta(r, c, self._vals(n_ins), idx, adj)
        key, uk, counts, nbc = self._tile_counts(adj)
        if kind in ("ladder crossing", "dense tile"):
            if kind == "ladder crossing":  # a tile of the cap-8 bucket past 32 entries
                t = uk[self.rng.choice(np.flatnonzero((counts >= 4) & (counts <= 8)))]
                n_ins = k
            else:  # the heaviest tile past T^2/16 entries
                t = uk[np.argmax(counts)]
                n_ins = max(k, T * T // 16 + 8 - int(counts.max()))
            br, bc = int(t // nbc) * T, int(t % nbc) * T
            r, c = self._absent(adj, n_ins, (br, min(br + T, adj.shape[0])),
                                (bc, min(bc + T, adj.shape[1])))
            return self._delta(r, c, self._vals(n_ins), np.zeros(0, np.int64), adj)
        if kind == "birth + death":
            dead = uk[self.rng.choice(np.flatnonzero(counts <= 3))]
            idx = np.flatnonzero(key == dead)
            nbr = -(-adj.shape[0] // T)
            while True:  # a tile that holds no entry
                t = int(self.rng.integers(nbr * nbc))
                j = np.searchsorted(uk, t)
                if j == uk.size or uk[j] != t:
                    break
            br, bc = t // nbc * T, t % nbc * T
            n_ins = k - idx.size
            r, c = self._absent(adj, n_ins, (br, min(br + T, adj.shape[0])),
                                (bc, min(bc + T, adj.shape[1])))
            return self._delta(r, c, self._vals(n_ins), idx, adj)
        raise ValueError(f"unknown delta kind {kind!r}")


def graphs_equal(a, b) -> list[str]:
    """Where two graphs differ: plan leaves (values and dtypes), run index
    fields, edge arrays.  Empty when equal."""
    from repro_torch.core.validate import run_index_diff

    bad = []
    sa, sb = getattr(a.plan, "segments", (a.plan,)), getattr(b.plan, "segments", (b.plan,))
    if len(sa) != len(sb):
        return ["segment count"]
    for j, (x, y) in enumerate(zip(sa, sb)):
        for f in ("tile_row", "tile_col", "rows", "cols", "vals", "nnz_in_tile", "perm"):
            u, v = getattr(x, f), getattr(y, f)
            if u.dtype != v.dtype or u.shape != v.shape or not torch.equal(u, v):
                bad.append(f"segment {j} {f}")
        bad += [f"segment {j} runs.{f}" for f in run_index_diff(x.runs, y.runs)]
    for f in ("rows", "cols", "vals"):
        u, v = getattr(a, f), getattr(b, f)
        if (u is None) != (v is None) or (u is not None and not torch.equal(u, v)):
            bad.append(f"edges {f}")
    return bad


def perm_ints(seg):
    """``seg`` with integer values -4..4 drawn from each slot's source id (0
    in padding): a patched plan and its rebuild, or a plan and its spans,
    get the same values."""
    v = torch.where(seg.perm >= 0, (seg.perm % 9 - 4).float(), torch.zeros((), device=seg.device))
    return dataclasses.replace(seg, vals=v)


def perm_int_plan(plan):
    """``plan`` with :func:`perm_ints` values in every segment."""
    return dataclasses.replace(plan, segments=tuple(perm_ints(s) for s in plan.segments))


def expected_dense(plan) -> int:
    """Launches of one chain in which a tile takes the dense branch, from
    the tiles' own nnz (not from any run index): the vector body takes a
    chain's segments in one launch (one per ``MAX_SEGMENTS``)."""
    from repro_torch.core.scv import dense_tile_threshold
    from repro_torch.kernels.scv_spmm.ops import chain_groups

    segs = plan.segments
    return sum(1 for g in chain_groups(len(segs))
               if any(segs[i].n_tiles and int(segs[i].nnz_in_tile.max())
                      > dense_tile_threshold(segs[i].tile) for i in g))


def stream_drive(adj, layout, dev, n_feat: int, gen) -> dict:
    """Phase 10: the delta stream on a graph held on ``dev``; returns the
    numbers of the run.  Raises on any disagreement."""
    from repro_torch.core.validate import validate_plan
    from repro_torch.kernels.scv_spmm import ref
    kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")
    from repro_torch.kernels.scv_spmm.ops import scv_spmm_plan
    from repro_torch.models.gnn import build_graph
    from repro_torch.serve.graph_engine import plan_launches
    from repro_torch.stream import apply_coo, apply_delta
    from repro_torch.stream import delta as dmod

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def build(a, caps=None):
        kw = dict(config=layout) if caps is None else dict(tile=layout.tile, bucket_caps=caps)
        g = build_graph(a, device=dev, **kw)
        sync()
        return g

    def hold(g, rebuilt, final, label, z_int, z):
        """The checks after one delta; returns (max err, max |plain|, kernel
        launches, dense launches) of the chain on the patched plan."""
        bad = graphs_equal(g, rebuilt)
        check(not bad, f"{label}: patched != rebuilt at {bad[:4]}")
        rep = validate_plan(g, coo=final)
        check(rep.ok, f"{label}: validate_plan\n{rep.summary()}")
        p_int, r_int = perm_int_plan(g.plan), perm_int_plan(rebuilt.plan)
        kmod.reset_counts()
        k_int = scv_spmm_plan(p_int, z_int)
        sync()
        n_launch, n_dense = kmod.launches, kmod.dense_launches
        check(torch.equal(k_int, scv_spmm_plan(r_int, z_int)),
              f"{label}: chain on patched != chain on rebuilt (integer values)")
        check(torch.equal(k_int, ref.scv_spmm_reference_plan(p_int, z_int)),
              f"{label}: chain != plain version (integer values)")
        check(n_launch == plan_launches(g.plan) and n_dense == expected_dense(rebuilt.plan),
              f"{label}: {n_launch} launches, {n_dense} dense; want "
              f"{plan_launches(g.plan)}, {expected_dense(rebuilt.plan)}")
        err, scale = rel_err(scv_spmm_plan(g.plan, z), ref.scv_spmm_reference_plan(g.plan, z))
        check(err <= 1e-5 * scale, f"{label}: max err {err} > 1e-5 * {scale}")
        return err, scale, n_launch, n_dense

    maker = DeltaMaker(seed=10, tile=layout.tile)
    n = adj.shape[1]
    z_int = torch.randint(-4, 5, (n, n_feat), generator=gen).float().to(dev)
    z = torch.randn((n, n_feat), generator=gen).to(dev)
    t0 = time.perf_counter()
    g = build(adj)
    print(f"[stream] arxiv-scale graph on {dev.type}: built in {time.perf_counter() - t0:.3f} s, "
          f"ladder {g.plan.caps}, tiles {[s.n_tiles for s in g.plan.segments]}")
    cur = adj
    rows, launches, dense_launches, worst = [], 0, 0, 0.0
    for i, kind in enumerate(DELTA_STREAM):
        d = maker.make(kind, cur)
        t0 = time.perf_counter()
        final = apply_coo(cur, d)
        t_coo = time.perf_counter() - t0
        if kind == "dense tile":
            g512 = build(cur, DENSE_LADDER)
            z512 = torch.randint(-4, 5, (n, n_feat), generator=gen).float().to(dev)
            kmod.reset_counts()
            scv_spmm_plan(perm_int_plan(g512.plan), z512)
            sync()
            dense_before = kmod.dense_launches
        dmod.copies.reset()
        sync()
        t0 = time.perf_counter()
        patched = apply_delta(g, d)
        sync()
        t_patch = time.perf_counter() - t0
        cp = dataclasses.replace(dmod.copies)
        t0 = time.perf_counter()
        rebuilt = build(final)
        t_rebuild = time.perf_counter() - t0
        label = f"delta {i} ({kind})"
        err, scale, n_launch, n_dense = hold(patched, rebuilt, final, label, z_int, z)
        launches += n_launch
        dense_launches += n_dense
        worst = max(worst, err / scale)
        ms_p = device_ms(lambda: scv_spmm_plan(patched.plan, z), 5)
        ms_r = device_ms(lambda: scv_spmm_plan(rebuilt.plan, z), 5)
        moved = [j for j, (a, b) in enumerate(zip(g.plan.segments, patched.plan.segments))
                 if a is not b]
        rows.append(dict(kind=kind, patch_s=t_patch, rebuild_s=t_rebuild, coo_s=t_coo,
                         d2h_mb=cp.d2h_bytes / 1e6, d2h_s=cp.d2h_s, h2d_mb=cp.h2d_bytes / 1e6,
                         h2d_s=cp.h2d_s, chain_ms=ms_p, rebuilt_chain_ms=ms_r))
        print(f"[stream] {label}: {d.n_insert} inserts, {d.n_remove} removes; "
              f"apply_delta {1e3 * t_patch:.1f} ms (copies: {cp.d2h_bytes / 1e6:.1f} MB to the "
              f"host in {1e3 * cp.d2h_s:.1f} ms, {cp.h2d_bytes / 1e6:.1f} MB to the card in "
              f"{1e3 * cp.h2d_s:.1f} ms), rebuild {1e3 * t_rebuild:.1f} ms "
              f"(x{t_rebuild / t_patch:.1f}), apply_coo {1e3 * t_coo:.1f} ms; segments patched "
              f"{moved}, tiles {[s.n_tiles for s in patched.plan.segments]}; chain F={n_feat} "
              f"patched {ms_p:.4f} ms, rebuilt {ms_r:.4f} ms; {n_launch} launches, "
              f"{n_dense} dense; max err {err:.2e} (max |plain| {scale:.2e})")
        if kind == "dense tile":
            p512 = apply_delta(g512, d)
            r512 = build(final, DENSE_LADDER)
            _, _, n512, d512 = hold(p512, r512, final, f"{label} on ladder {DENSE_LADDER}",
                                    z512, z)
            check(dense_before == 0 and d512 == 1,
                  f"{label}: dense launches {dense_before} before, {d512} after")
            print(f"[stream] {label} on ladder {DENSE_LADDER}: heaviest tile "
                  f"{max(int(s.nnz_in_tile.max()) for s in p512.plan.segments if s.n_tiles)} "
                  f"entries; chain launches {n512}, dense {dense_before} before the delta, "
                  f"{d512} after; patched == rebuilt, validate green")
            del g512, p512, r512
        g, cur = patched, final
    patch = np.array([r["patch_s"] for r in rows])
    rebuild = np.array([r["rebuild_s"] for r in rows])
    ratio = np.array([r["chain_ms"] / r["rebuilt_chain_ms"] for r in rows])
    print(f"[stream] {len(rows)} deltas: apply_delta median {1e3 * np.median(patch):.1f} ms "
          f"(max {1e3 * patch.max():.1f}), rebuild median {1e3 * np.median(rebuild):.1f} ms, "
          f"rebuild / patch median x{np.median(rebuild / patch):.1f}; chain patched / rebuilt "
          f"{ratio.min():.3f}..{ratio.max():.3f}; {launches} kernel launches, "
          f"{dense_launches} dense; worst rel err {worst:.2e}")
    return dict(rows=rows, launches=launches, dense_launches=dense_launches, worst=worst)


def tracked_serving(adj, cfg, layout, dev) -> dict:
    """Phase 11: ``adj`` served as one tracked member of a debug-validating
    engine on ``dev``, with value-update deltas between waves; returns the
    numbers of the run.  Raises on any disagreement."""
    kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")
    from repro_torch.launch.graph_serve import build_default_engine
    from repro_torch.models.gnn import build_graph
    from repro_torch.serve.graph_engine import GraphRequest

    T = layout.tile
    bucket = -(-adj.shape[0] // T) * T
    engine = build_default_engine(model=cfg, device=dev, seed=0, max_batch_graphs=1,
                                  max_batch_nodes=bucket, node_buckets=(bucket,),
                                  cache_bytes=8 << 30, debug_validate=True)
    params = engine.models["gcn"][0]
    x = np.random.default_rng(11).standard_normal((adj.shape[0], cfg.d_in)).astype(np.float32)
    maker = DeltaMaker(seed=12, tile=T)
    served = []  # (request, the adjacency its wave served)
    kmod.reset_counts()
    engine.submit(GraphRequest(rid=0, adj=adj, x=x, model="gcn", graph_id="g"))
    engine.run()
    served.append((engine.completed[-1], adj))
    rid, n_updates, results = 1, 0, []
    for mode in ("run", "async"):
        if mode == "async":
            engine.start()
        for rate in TRACKED_RATES:
            before = {k: getattr(engine, k) for k in ("update_seconds", "assemble_seconds",
                                                      "copy_seconds")}
            t0 = time.perf_counter()
            for _ in range(TRACKED_WAVES):
                for _ in range(rate):
                    engine.update("g", maker.make("value update", engine.tracked_adj("g")))
                    n_updates += 1
                req = engine.submit(GraphRequest(rid=rid, x=x, model="gcn", graph_id="g"))
                if mode == "run":
                    engine.run()
                else:
                    req.result(timeout=600)
                served.append((req, engine.tracked_adj("g")))
                rid += 1
            wall = time.perf_counter() - t0
            split = {k: (getattr(engine, k) - v) / TRACKED_WAVES for k, v in before.items()}
            forward = wall / TRACKED_WAVES - sum(split.values())
            results.append(dict(mode=mode, rate=rate, queries_per_s=TRACKED_WAVES / wall,
                                updates_per_s=rate * TRACKED_WAVES / wall,
                                wave_s=wall / TRACKED_WAVES, forward_s=forward, **split))
            print(f"[tracked] {mode} {rate} updates a wave: {TRACKED_WAVES / wall:.2f} "
                  f"queries/s, {rate * TRACKED_WAVES / wall:.2f} updates/s; a wave "
                  f"{1e3 * wall / TRACKED_WAVES:.1f} ms = update "
                  f"{1e3 * split['update_seconds']:.1f} + assembly (validate_plan included) "
                  f"{1e3 * split['assemble_seconds']:.1f} + copy to the card "
                  f"{1e3 * split['copy_seconds']:.1f} + forward and the rest {1e3 * forward:.1f} ms")
        if mode == "async":
            engine.stop(timeout=600)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = kmod.launches
    m = engine.metrics()
    check(launches == m["launches"] > 0,
          f"tracked serving: kernel launches {launches} != engine launches {m['launches']}")
    check(m["graph_updates"] == m["plan_cache_revalidated"] == n_updates,
          f"tracked serving: {m['graph_updates']} updates, {m['plan_cache_revalidated']} "
          f"revalidated, {n_updates} applied")
    worst, plain = 0.0, {}
    for req, a in served:
        check(req.done and req.out is not None, f"tracked request {req.rid} not served")
        if id(a) not in plain:
            with torch.inference_mode():
                plain[id(a)] = plain_gcn_forward(
                    params, cfg, build_graph(a, config=layout, with_edges=False, device=dev),
                    torch.from_numpy(x).to(dev)).cpu().numpy()
        want = plain[id(a)]
        check(req.out.shape == want.shape and np.isfinite(req.out).all(),
              f"tracked request {req.rid} output shape/finiteness")
        err = float(np.abs(req.out - want).max() / max(1.0, np.abs(want).max()))
        check(err <= 1e-4, f"tracked request {req.rid}: off the plain forward by {err}")
        worst = max(worst, err)
    print(f"[tracked] {len(served)} waves, {n_updates} updates = {m['plan_cache_revalidated']} "
          f"revalidated ({m['plan_cache_anchored']} anchored), kernel launches {launches} = "
          f"engine launches {m['launches']}, worst rel err vs plain forward on the rebuilt "
          f"graph {worst:.2e}")
    return dict(results=results, launches=launches, updates=n_updates, worst=worst)


def sync_all(dev) -> None:
    """Wait for every card (a placed plan's spans may run on several)."""
    if dev.type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def shard_pools(dev) -> list:
    """Phase 12's executor pools: ``SHARD_SLOTS`` slots on ``dev``'s card,
    and with two cards or more also the cards themselves (repeated up to
    ``SHARD_SLOTS``)."""
    pools = [(f"{SHARD_SLOTS} slots on one card", (dev,) * SHARD_SLOTS)]
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n >= 2:
        pools.append((f"{n} cards", tuple(torch.device(f"cuda:{i % n}")
                                          for i in range(SHARD_SLOTS))))
    return pools


def sharded_ints(sp):
    """A placed plan with :func:`perm_ints` values in every span."""
    return dataclasses.replace(sp, segments=tuple(
        tuple(perm_ints(s) for s in spans) for spans in sp.segments))


def shard_placements(g, ex, n_feat: int, gen, dev, placed: dict) -> list:
    """Phase 12, placement: ``g``'s plan on ``ex``'s pool under each
    decision at width ``n_feat``, held against the unsharded kernel chain
    (integer values, bit for bit) and the plain version (normalised
    values, 1e-5 of its largest magnitude), with the kernel's launches
    against ``plan_launches`` and the times of prepare, each grid cell's
    chain, the merge and the whole call.  ``placed`` keeps placements by
    decision across widths.  Returns one dict per decision."""
    from repro_torch.core.exec import (
        ShardingDecision, aggregate_sharded, merge_partials, placement_bytes)
    from repro_torch.core.partition import shard_plan, split_equal_nnz
    from repro_torch.core.validate import validate_plan
    from repro_torch.kernels.scv_spmm import ref
    kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")
    from repro_torch.kernels.scv_spmm.ops import scv_spmm_plan
    from repro_torch.serve.graph_engine import plan_launches
    from repro_torch.tune.cost import plan_launched_slots

    plan = g.plan
    n_rows, n_cols = plan.shape
    nnz = sum(int(s.nnz_in_tile.sum()) for s in plan.segments)
    z_int = torch.randint(-4, 5, (n_cols, n_feat), generator=gen).float().to(dev)
    z = torch.randn((n_cols, n_feat), generator=gen).to(dev)
    want_int = scv_spmm_plan(perm_int_plan(plan), z_int)[:n_rows]
    plain = ref.scv_spmm_reference_plan(plan, z)[:n_rows]
    chain_ms = device_ms(lambda: scv_spmm_plan(plan, z), 10)
    picked = ex.decide(plan, n_feat)
    decisions = [ShardingDecision(*d) for d in SHARD_DECISIONS
                 if d[0] != "features" or n_feat >= 128]
    if picked.kind != "replicated" and picked not in decisions:
        decisions.append(picked)
    print(f"[shard] F={n_feat}: unsharded chain {chain_ms:.4f} ms; PlanExecutor.decide over "
          f"{ex.n_devices} devices picks {picked.signature}")
    rows = []
    for d in decisions:
        tp, fp = d.tile_parts, d.feature_parts
        if d not in placed:
            sync_all(dev)
            t0 = time.perf_counter()
            part = split_equal_nnz(plan, tp)
            t1 = time.perf_counter()
            shard_plan(plan, part)
            sync_all(dev)
            t2 = time.perf_counter()
            sp = ex.prepare(plan, decision=d)
            sync_all(dev)
            t3 = time.perf_counter()
            rep = validate_plan(sp)
            check(rep.ok, f"placement {d.signature}: validate_plan\n{rep.summary()}")
            placed[d] = (sp, dict(split_ms=1e3 * (t1 - t0), gather_ms=1e3 * (t2 - t1),
                                  prepare_ms=1e3 * (t3 - t2)))
        sp, prep = placed[d]
        label = f"{d.signature} F={n_feat}"
        sp_int = sharded_ints(sp)
        sync_all(dev)
        kmod.reset_counts()
        got_int = aggregate_sharded(sp_int, z_int)
        sync_all(dev)
        n_launch = kmod.launches
        check(n_launch == plan_launches(sp_int) > 0,
              f"{label}: {n_launch} kernel launches, plan_launches {plan_launches(sp_int)}")
        check(torch.equal(got_int, want_int),
              f"{label}: not bit-exact with the unsharded chain on integers (max err "
              f"{(got_int - want_int).abs().max().item()})")
        err, scale = rel_err(aggregate_sharded(sp, z), plain)
        check(err <= 1e-5 * scale, f"{label}: max err {err} > 1e-5 * {scale}")
        whole_ms = device_ms(lambda: aggregate_sharded(sp, z), 10)
        width = -(-n_feat // fp)
        cell_ms, cell_lines, merge_ms = [], [], 0.0
        for q in range(fp):
            f0, f1 = q * width, min(n_feat, (q + 1) * width)
            parts = []
            for p in range(tp):
                span = sp.span(p, q)
                if span is None:
                    continue
                slab = z[:, f0:f1].to(sp.devices[p][q]).contiguous()
                cell_ms.append(device_ms(lambda: scv_spmm_plan(span, slab, init="zeros"), 10))
                # each launch of the cell's chain alone (each from its own zeros)
                segs = getattr(span, "segments", (span,))
                seg_ms = [device_ms(lambda s=s: scv_spmm_plan(s, slab, init="zeros"), 10)
                          for s in segs]
                cell_lines.append(
                    f"cell ({p}, {q}) {cell_ms[-1]:.4f} ms; alone: " + ", ".join(
                        f"cap {s.cap} {t:.4f} ms ({s.runs.n_units} units, heaviest "
                        f"{s.runs.max_unit_work} work)" for s, t in zip(segs, seg_ms)))
                parts.append(scv_spmm_plan(span, slab, init="zeros"))
            merge_ms += device_ms(lambda: merge_partials(
                parts, sp.device, (plan.padded_shape[0], f1 - f0)), 10)
        pb = placement_bytes(nnz, n_feat, tp, fp, n_rows=n_rows,
                             n_slots=plan_launched_slots(plan))
        row = dict(decision=d.signature, n_feat=n_feat, launches=n_launch, whole_ms=whole_ms,
                   chain_ms=chain_ms, cell_ms=cell_ms, merge_ms=merge_ms,
                   imbalance=sp.imbalance, placement_total=pb["total"], err=err, **prep)
        rows.append(row)
        print(f"[shard] {label}: {n_launch} launches = plan_launches, integer bit-exact with "
              f"the unsharded chain, max err {err:.2e} (max |plain| {scale:.2e}); "
              f"imbalance {sp.imbalance:.4f}, placement_bytes total {pb['total'] / 1e6:.2f} MB "
              f"per device (z_gather {pb['z_gather'] / 1e6:.2f}, collective "
              f"{pb['collective'] / 1e6:.2f}); prepare {prep['prepare_ms']:.1f} ms (split "
              f"alone {prep['split_ms']:.1f}, gather alone {prep['gather_ms']:.1f}); whole call "
              f"{whole_ms:.4f} ms vs unsharded chain {chain_ms:.4f} ms; cell chains "
              + ", ".join(f"{t:.4f}" for t in cell_ms)
              + f" ms (sum {sum(cell_ms):.4f}); merge {merge_ms:.4f} ms")
        for line in cell_lines:
            print(f"[shard]   {label} {line}")
    return rows


def shard_model(g, cfg, ex, dev) -> dict:
    """Phase 12, model: the gcn-paper forward over ``g`` placed ``tiles``
    4x1, against the plain forward (1e-4), then one ``gnn_loss`` step whose
    gradients are held against the unsharded kernel path (1e-4 of each
    gradient's largest magnitude)."""
    from repro_torch.core.exec import ShardingDecision
    kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")
    from repro_torch.models.gnn import gnn_forward, gnn_loss, init_gnn
    from repro_torch.serve.graph_engine import plan_launches

    placed = ex.prepare_graph(g, decision=ShardingDecision("tiles", 4, 1))
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (g.n_nodes, cfg.d_in), np.float32)).to(dev)
    reps = 3
    with torch.inference_mode():
        gnn_forward(params, cfg, placed, x)
        sync_all(dev)
        kmod.reset_counts()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = gnn_forward(params, cfg, placed, x)
        sync_all(dev)
        sharded_ms = 1e3 * (time.perf_counter() - t0) / reps
        n_launch = kmod.launches
        t0 = time.perf_counter()
        for _ in range(reps):
            gnn_forward(params, cfg, g, x)
        sync_all(dev)
        unsharded_ms = 1e3 * (time.perf_counter() - t0) / reps
        want = plain_gcn_forward(params, cfg, g, x)
    check(n_launch == reps * cfg.n_layers * plan_launches(placed.plan),
          f"sharded forward launched {n_launch} kernels")
    check(tuple(out.shape) == (g.n_nodes, cfg.n_classes) and bool(torch.isfinite(out).all()),
          "sharded forward output shape/finiteness")
    err, scale = rel_err(out, want)
    check(err <= 1e-4 * max(1.0, scale), f"sharded forward off the plain forward: {err}")
    labels = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.n_classes, g.n_nodes)).to(dev)
    mask = torch.ones(g.n_nodes, device=dev)
    names = [f"{layer}.{k}" for layer, ps in params.items() for k in ps]
    flat = [p.requires_grad_(True) for ps in params.values() for p in ps.values()]
    grads = torch.autograd.grad(gnn_loss(params, cfg, placed, x, labels, mask), flat)
    want_grads = torch.autograd.grad(gnn_loss(params, cfg, g, x, labels, mask), flat)
    worst = 0.0
    for name, a, b in zip(names, grads, want_grads):
        gerr, gscale = rel_err(a, b)
        check(gerr <= 1e-4 * gscale, f"sharded grad {name}: max err {gerr} > 1e-4 * {gscale}")
        worst = max(worst, gerr / gscale)
    print(f"[shard] 2-layer gcn-paper forward placed tiles:t4f1: {sharded_ms:.3f} ms per forward "
          f"(host clock, {reps} forwards; unsharded {unsharded_ms:.3f} ms), {n_launch // reps} "
          f"kernel launches each, max abs err vs plain forward {err:.3e} (max |plain| "
          f"{scale:.3e}); one gnn_loss step's gradients vs the unsharded kernel path, worst "
          f"max err / max |grad| {worst:.2e}")
    return dict(sharded_ms=sharded_ms, unsharded_ms=unsharded_ms, launches=n_launch, err=err,
                grad_err=worst)


def shard_serving(cfg, layout, dev, pool_devices) -> dict:
    """Phase 12, serving: a burst from the default hot-graph pool through an
    engine whose executor holds ``pool_devices``, with waves over
    ``SHARD_NNZ_THRESHOLD`` entries placed; every output against a plain
    forward (1e-4), kernel launches against the engine's count, and the
    same burst again served from placed composites in the cache."""
    from repro_torch.core.exec import PlanExecutor
    kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")
    from repro_torch.launch.graph_serve import build_default_engine, default_pool, make_requests
    from repro_torch.models.gnn import build_graph
    from repro_torch.serve.graph_engine import GraphRequest

    pool = default_pool()
    graphs = {id(a): build_graph(a, config=layout, device=dev) for a in pool}
    engine = build_default_engine(model=cfg, device=dev, seed=0,
                                  executor=PlanExecutor(devices=pool_devices),
                                  shard_nnz_threshold=SHARD_NNZ_THRESHOLD)
    params = engine.models["gcn"][0]
    reqs = make_requests(np.random.default_rng(13), pool, SHARD_REQUESTS, cfg.d_in)
    bursts, worst = [], 0.0
    for again in (False, True):
        if again:
            reqs = [GraphRequest(rid=SHARD_REQUESTS + r.rid, adj=r.adj, x=r.x, model="gcn")
                    for r in reqs]
        before = engine.metrics()
        for r in reqs:
            engine.submit(r)
        sync_all(dev)
        kmod.reset_counts()
        t0 = time.perf_counter()
        engine.run()
        sync_all(dev)
        wall = time.perf_counter() - t0
        launches = kmod.launches
        m = engine.metrics()
        check(launches == m["launches"] - before["launches"] > 0,
              f"sharded serving: kernel launches {launches} != engine launches "
              f"{m['launches'] - before['launches']}")
        sharded = m["sharded_batches"] - before["sharded_batches"]
        check(sharded > 0, "sharded serving: no wave went through the executor")
        if again:
            check(m["plan_cache_misses"] == before["plan_cache_misses"],
                  "sharded serving: the repeated burst missed the composite cache")
        for r in reqs:
            check(r.done and r.out is not None, f"sharded serving: request {r.rid} not served")
            want = plain_gcn_forward(params, cfg, graphs[id(r.adj)],
                                     torch.from_numpy(r.x).to(dev)).cpu().numpy()
            check(r.out.shape == want.shape and np.isfinite(r.out).all(),
                  f"sharded serving: request {r.rid} output shape/finiteness")
            worst = max(worst, float(np.abs(r.out - want).max() / max(1.0, np.abs(want).max())))
        check(worst <= 1e-4, f"sharded serving: output off the plain forward by {worst}")
        waves = m["batches"] - before["batches"]
        bursts.append(dict(wall_s=wall, waves=waves, sharded=sharded, launches=launches))
        print(f"[shard] serving burst of {len(reqs)}{' again' if again else ''}: {waves} waves, "
              f"{sharded} placed (threshold {SHARD_NNZ_THRESHOLD} entries), "
              f"{len(reqs) / wall:.1f} graphs/s, kernel launches {launches} = engine launches, "
              f"composite cache hits {m['plan_cache_hits'] - before['plan_cache_hits']}, "
              f"misses {m['plan_cache_misses'] - before['plan_cache_misses']}, worst rel err "
              f"{worst:.2e}")
    return dict(bursts=bursts, worst=worst)


def shard_narrow(g, dev, gen) -> dict:
    """Phase 12, slabs narrower than a column: ``g``'s plan placed
    ``features`` 1x``NARROW_PARTS`` on that many slots of ``dev``'s card at
    F = ``NARROW_FEATURES`` (the last slabs empty), held against the
    unsharded kernel chain (integer values, bit for bit) and the plain
    version (1e-5); an empty slab launches nothing."""
    from repro_torch.core.exec import PlanExecutor, ShardingDecision, aggregate_sharded
    from repro_torch.kernels.scv_spmm import ref
    kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")
    from repro_torch.kernels.scv_spmm.ops import scv_spmm_plan
    from repro_torch.serve.graph_engine import plan_launches

    plan, f, fp = g.plan, NARROW_FEATURES, NARROW_PARTS
    n_rows, n_cols = plan.shape
    d = ShardingDecision("features", 1, fp)
    sp = PlanExecutor(devices=(dev,) * fp).prepare(plan, decision=d)
    sp_int = sharded_ints(sp)
    z_int = torch.randint(-4, 5, (n_cols, f), generator=gen).float().to(dev)
    want_int = scv_spmm_plan(perm_int_plan(plan), z_int)[:n_rows]
    sync_all(dev)
    kmod.reset_counts()
    got_int = aggregate_sharded(sp_int, z_int)
    sync_all(dev)
    n_launch = kmod.launches
    filled = -(-f // -(-f // fp))  # slabs holding a column
    check(n_launch == plan_launches(sp) // fp * filled > 0,
          f"{d.signature} F={f}: {n_launch} kernel launches for {filled} filled slabs")
    check(tuple(got_int.shape) == (n_rows, f) and torch.equal(got_int, want_int),
          f"{d.signature} F={f}: not bit-exact with the unsharded chain on integers")
    z = torch.randn((n_cols, f), generator=gen).to(dev)
    err, scale = rel_err(aggregate_sharded(sp, z), ref.scv_spmm_reference_plan(plan, z)[:n_rows])
    check(err <= 1e-5 * scale, f"{d.signature} F={f}: max err {err} > 1e-5 * {scale}")
    whole_ms = device_ms(lambda: aggregate_sharded(sp, z), 10)
    chain_ms = device_ms(lambda: scv_spmm_plan(plan, z), 10)
    print(f"[shard] {d.signature} F={f} on {fp} slots: {filled} slabs of one column, "
          f"{fp - filled} empty; {n_launch} launches, integer bit-exact with the unsharded chain, "
          f"max err {err:.2e} (max |plain| {scale:.2e}); whole call {whole_ms:.4f} ms vs "
          f"unsharded chain {chain_ms:.4f} ms")
    return dict(launches=n_launch, whole_ms=whole_ms, chain_ms=chain_ms, err=err)


def shard_drive(g, cfg, layout, dev, gen) -> dict:
    """Phase 12: the sharding executor on each pool of :func:`shard_pools`:
    placement of ``g``'s plan at F = 128 and 40, the model, serving.
    Returns the numbers of the run."""
    from repro_torch.core.exec import PlanExecutor

    t0 = time.perf_counter()
    runs = []
    for name, devices in shard_pools(dev):
        ex = PlanExecutor(devices=devices)
        print(f"[shard] {torch.cuda.device_count() if dev.type == 'cuda' else 0} card(s); "
              f"pool '{name}': {[str(d) for d in ex.devices]}; spans share a card: "
              f"{len(set(ex.devices)) < len(ex.devices)}")
        placed = {}
        rows = [r for f in (cfg.d_hidden, cfg.n_classes)
                for r in shard_placements(g, ex, f, gen, dev, placed)]
        del placed
        model = shard_model(g, cfg, ex, dev)
        serving = shard_serving(cfg, layout, dev, devices)
        runs.append(dict(pool=name, placements=rows, model=model, serving=serving))
    narrow = shard_narrow(g, dev, gen)
    print(f"[shard] phase 12: {time.perf_counter() - t0:.1f} s")
    return dict(runs=runs, narrow=narrow, launches=narrow["launches"] + sum(
        r["launches"] for run in runs for r in run["placements"]) + sum(
        run["model"]["launches"] + sum(b["launches"] for b in run["serving"]["bursts"])
        for run in runs))


def tune_regimes(arxiv_adj, cfg) -> list:
    """Phase 13's regimes: (name, adjacency, F, stage 1's winner (T,
    ladder) as the reference's tuner picks it, whether the values are
    integers)."""
    from repro_torch.simul.datasets import powerlaw_edges, powerlaw_graph

    return [
        ("sparse 131,072/1M", powerlaw_graph(1 << 17, 1_000_000, seed=0), TUNE_FEATURES,
         (64, (8,)), True),
        ("dense 2,048/1M", powerlaw_edges(2048, 1_000_000, seed=0), TUNE_FEATURES,
         (128, (128,)), True),
        ("arxiv", arxiv_adj, cfg.d_in, (64, (8,)), False),
    ]


def timed_stages(tuner, seconds: dict):
    """Record the host seconds of ``tuner``'s two stages in ``seconds``."""
    for stage in ("_stage1", "_stage2"):
        call = getattr(tuner, stage)

        def timed(*args, call=call, stage=stage):
            t0 = time.perf_counter()
            try:
                return call(*args)
            finally:
                seconds[stage] = time.perf_counter() - t0
        setattr(tuner, stage, timed)


def tune_chains(name, adj, n_feat, ints, plans, gen, dev) -> dict:
    """Phase 13: each of ``plans`` (label -> plan of ``adj``) held against
    the plain version (bit-exact on integer values and Z; within 1e-5 of
    the largest magnitude on normalised values), then timed beside
    ``torch.sparse.mm`` and the bound on the same matrix."""
    from repro_torch.kernels.scv_spmm import ref
    from repro_torch.kernels.scv_spmm.ops import scv_spmm_plan
    from repro_torch.serve.graph_engine import plan_launches

    n_cols = adj.shape[1]
    z_int = torch.randint(-4, 5, (n_cols, n_feat), generator=gen).float().to(dev)
    z = torch.randn((n_cols, n_feat), generator=gen).to(dev)
    out = {}
    for label, plan in plans.items():
        int_plan = plan if ints else with_integer_vals(plan, gen, dev)
        k_int = scv_spmm_plan(int_plan, z_int)
        p_int = ref.scv_spmm_reference_plan(int_plan, z_int)
        check(torch.equal(k_int, p_int),
              f"{name} {label} T={plan.tile}: integer inputs not bit-exact "
              f"(max err {(k_int - p_int).abs().max().item()})")
        err = 0.0
        if not ints:
            err, scale = rel_err(scv_spmm_plan(plan, z), ref.scv_spmm_reference_plan(plan, z))
            check(err <= 1e-5 * scale, f"{name} {label}: max err {err} > 1e-5 * {scale}")
        del k_int, p_int
        entries = plan_entries(plan)
        zz = z_int if ints else z
        csr = csr_of(entries, (plan.padded_shape[0], n_cols), dev)
        ms = device_ms(lambda: scv_spmm_plan(plan, zz), TUNE_REPS)
        lib_ms = device_ms(lambda: torch.sparse.mm(csr, zz), TUNE_REPS)
        bound_ms, bound_by = chain_bounds(plan, entries, n_feat)
        del csr
        out[label] = dict(ms=ms, library_ms=lib_ms, bound_ms=bound_ms, err=err)
        print(f"[tune]   {name} {label} chain T={plan.tile} caps {plan.caps}: "
              f"{plan_launches(plan)} launches {ms:.4f} ms, torch.sparse.mm (CSR) "
              f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); integer bit-exact"
              + ("" if ints else f", normalised max abs err {err:.3e}"))
    return out


def tune_drive(arxiv_adj, arxiv, cfg, x, fwd_ms, pool, serve_gps, check_outputs, dev,
               gen) -> dict:
    """Phase 13: the two-stage autotuner on the card, a full-graph forward
    and a serving burst with the tuned layouts; returns the numbers of the
    run.  Raises on any disagreement."""
    import shutil
    import tempfile

    from repro_torch.core.scv import DEFAULT_LADDER, DEFAULT_TILE
    kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")
    from repro_torch.launch.graph_serve import build_default_engine, make_requests
    from repro_torch.models.gnn import build_graph, gnn_forward, init_gnn
    from repro_torch.serve.graph_engine import plan_launches
    from repro_torch.tune import Autotuner, TunedConfig, TuneStore

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    store_path = os.path.join(tmp, "tune.json")
    try:
        regimes = tune_regimes(arxiv_adj, cfg)
        default = (DEFAULT_TILE, DEFAULT_LADDER)
        tuner = Autotuner(device=dev, store=TuneStore(store_path), top_k=TUNE_TOP_K,
                          calib_reps=TUNE_CALIB_REPS)
        kmod.reset_counts()
        rows, tuned = [], {}
        for name, adj, n_feat, want, ints in regimes:
            stages = {}
            timed_stages(tuner, stages)
            launches_before = kmod.launches
            tcfg = tuner.tune(adj, n_features=n_feat)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            res = tuner.last_result
            top = res.candidates[0].config
            check((top.tile, top.bucket_caps) == want,
                  f"{name}: stage 1 picked T={top.tile} {top.bucket_caps}, the reference {want}")
            cal = res.calibrated
            keys = [(c.config.tile, c.config.bucket_caps) for c in cal]
            check(default in keys, f"{name}: the default control was not measured")
            best = min(cal, key=lambda c: c.measured_s)
            check((tcfg.tile, tcfg.bucket_caps) == (best.config.tile, best.config.bucket_caps)
                  and tcfg.source == "calibrated",
                  f"{name}: the winner {tcfg} is not the measured best {best.config}")
            check(kmod.launches - launches_before >= (1 + TUNE_CALIB_REPS) * len(cal),
                  f"{name}: stage 2 launched {kmod.launches - launches_before} kernels")
            print(f"[tune] {name} F={n_feat}: stage 1 {len(res.candidates)} candidates in "
                  f"{stages['_stage1']:.2f} s, winner T={top.tile} caps {top.bucket_caps} "
                  f"score {res.candidates[0].score_s:.4f} s (the reference's); stage 2 "
                  f"{len(cal)} calibrated in {stages['_stage2']:.2f} s, "
                  f"{kmod.launches - launches_before} launches")
            for c in cal:
                print(f"[tune]   candidate T={c.config.tile} caps {c.config.bucket_caps}: "
                      f"score {c.score_s:.4f} s, measured {1e3 * c.measured_s:.4f} ms"
                      + (" (default control)" if (c.config.tile, c.config.bucket_caps)
                         == default else "")
                      + (" <- winner" if c is best else ""))
            print(f"[tune]   Spearman(predicted, measured) {res.rank_correlation:.3f}; "
                  f"tuned T={tcfg.tile} caps {tcfg.bucket_caps}")
            # the winner's chain, the default's and stage 1's best at T = 32
            t32 = next(c.config for c in res.candidates if c.config.tile == 32)
            plans = {}
            for label, layout in (("tuned", tcfg), ("default", TunedConfig()),
                                  ("best T=32", t32)):
                if label == "default" and name == "arxiv":
                    plans[label] = arxiv.plan  # phase 2's plan, built with the default
                else:
                    plans[label] = build_graph(adj, config=layout, with_edges=False,
                                               device=dev).plan
            chains = tune_chains(name, adj, n_feat, ints, plans, gen, dev)
            ratio = chains["tuned"]["ms"] / chains["default"]["ms"]
            print(f"[tune]   {name}: tuned/default chain {ratio:.3f} over {TUNE_REPS} reps"
                  + (" (the tuned chain is slower in the longer re-time)" if ratio > 1 else ""))
            rows.append(dict(regime=name, n_feat=n_feat, tuned=tcfg.to_json(),
                             stage1_s=stages["_stage1"], stage2_s=stages["_stage2"],
                             spearman=res.rank_correlation, chains=chains,
                             tuned_over_default=ratio,
                             calibrated=[(c.config.tile, c.config.bucket_caps, c.score_s,
                                          c.measured_s) for c in cal]))
            tuned[name] = tcfg
            if name == "arxiv":
                aplan = plans["tuned"]
            del plans
        # a fresh tuner on the same store: every regime from the cache
        again = Autotuner(device=dev, store=TuneStore(store_path))
        for name, adj, n_feat, _, _ in regimes:
            check(again.tune(adj, n_features=n_feat) == tuned[name],
                  f"{name}: the store resolved another config")
        check(again.searches == 0 and again.cache_hits == len(regimes),
              f"re-tune: {again.searches} searches, {again.cache_hits} cache hits")
        print(f"[tune] re-tune from the store: {again.searches} searches, "
              f"{again.cache_hits} cache hits")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (b) the full-graph forward with the tuned layout (phase 5's weights)
    acfg = tuned["arxiv"]
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
    g = dataclasses.replace(arxiv, plan=aplan)
    with torch.inference_mode():
        out = gnn_forward(params, cfg, g, x)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        reps = 5
        before = kmod.launches
        t0 = time.perf_counter()
        for _ in range(reps):
            out = gnn_forward(params, cfg, g, x)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        tuned_fwd_ms = (time.perf_counter() - t0) * 1e3 / reps
        fwd_launches = kmod.launches - before
        want = plain_gcn_forward(params, cfg, g, x)
    check(fwd_launches == reps * plan_launches(aplan) * cfg.n_layers,
          f"tuned arxiv forward launched {fwd_launches} kernels")
    check(tuple(out.shape) == (arxiv_adj.shape[0], cfg.n_classes)
          and bool(torch.isfinite(out).all()), "tuned arxiv forward output shape/finiteness")
    err, scale = rel_err(out, want)
    check(err <= 1e-4 * max(1.0, scale), f"tuned arxiv forward off the plain forward: {err}")
    print(f"[tune] arxiv 2-layer gcn-paper forward, tuned T={acfg.tile} caps "
          f"{acfg.bucket_caps}: {tuned_fwd_ms:.3f} ms per forward (host clock, {reps} "
          f"forwards; phase 5's default layout {fwd_ms:.3f} ms), {fwd_launches // reps} "
          f"launches each, max abs err vs plain forward {err:.3e}")
    del out, want, g

    # (c) serving with the tuner: phase 4's burst, then the same burst again
    engine = build_default_engine(model=cfg, device=dev, seed=0, autotune=True)
    waves = []
    dispatch = engine._dispatch_wave

    def record(wave):
        waves.append({engine._resolve_config(engine._resolve_adj(r)) for r in wave})
        return dispatch(wave)
    engine._dispatch_wave = record
    bursts = []
    for burst in range(2):
        reqs = make_requests(np.random.default_rng(2), pool, SERVE_REQUESTS, cfg.d_in)
        for r in reqs:
            engine.submit(r)
        before, launches_before = engine.metrics(), kmod.launches
        t0 = time.perf_counter()
        engine.run()
        wall = time.perf_counter() - t0
        launches = kmod.launches - launches_before
        m = engine.metrics()
        check(launches == m["launches"] - before["launches"] > 0,
              f"tuned serving burst {burst}: kernel launches {launches} != engine "
              f"launches {m['launches'] - before['launches']}")
        worst = check_outputs(engine, reqs, f"tuned serving burst {burst}")
        bursts.append(dict(graphs_per_s=SERVE_REQUESTS / wall, launches=launches,
                           waves=m["waves"] - before["waves"], worst=worst,
                           searches=m["autotune_searches"] - before["autotune_searches"],
                           cache_hits=m["autotune_cache_hits"] - before["autotune_cache_hits"]))
        print(f"[tune] serving burst {burst} of {SERVE_REQUESTS} with autotune=True: "
              f"{SERVE_REQUESTS / wall:.1f} graphs/s (phase 4's burst {serve_gps:.1f}), "
              f"{bursts[-1]['waves']} waves, {bursts[-1]['searches']} searches, "
              f"{bursts[-1]['cache_hits']} cache hits, plan builds "
              f"{m['plan_build_seconds'] - before['plan_build_seconds']:.3f} s of "
              f"{wall:.3f} s, kernel launches {launches} = engine launches, worst rel err "
              f"{worst:.2e}")
    check(all(len(w) == 1 for w in waves), "a wave mixed two resolved configs")
    per_config = {}
    for w in waves:
        c = next(iter(w))
        per_config[(c.tile, c.bucket_caps)] = per_config.get((c.tile, c.bucket_caps), 0) + 1
    m = engine.metrics()
    resolved = sorted({(c["tile"], tuple(c["bucket_caps"]))
                       for c in m["resolved_configs"].values()})
    print(f"[tune] serving: {len(m['resolved_configs'])} regimes resolved to {resolved}; "
          f"waves per config {per_config}; no wave mixes two configs")
    launches = kmod.launches
    print(f"[tune] phase 13: {time.perf_counter() - t_phase:.1f} s, {launches} kernel launches "
          f"({kmod.dense_launches} with a dense tile)")
    return dict(regimes=rows, forward_ms=tuned_fwd_ms, bursts=bursts, launches=launches,
                dense_launches=kmod.dense_launches)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def same_bucket_composites(pool, layout, with_edges: bool):
    """Two composites of pool graphs (host) that fall in one padding
    bucket (one capture key): the first two member sets found, three
    graphs a set, then two, in a fixed order."""
    import itertools

    from repro_torch.models.gnn import build_graph, forward_key
    from repro_torch.serve.graph_engine import _bucket_nodes, assemble_batched_graph

    T = layout.tile
    members = [build_graph(a, config=layout, with_edges=with_edges, device="cpu") for a in pool]
    seen = {}
    for k in (3, 2):
        for combo in itertools.combinations(range(len(pool)), k):
            gs = [members[i] for i in combo]
            bucket = _bucket_nodes(sum(-(-g.n_nodes // T) * T for g in gs),
                                   SERVE_NODE_BUCKETS, T)
            bg = assemble_batched_graph(gs, T, bucket, with_edges=with_edges)
            key = forward_key(bg.graph)
            if key in seen:
                return seen[key], bg
            seen[key] = bg
    raise RuntimeError("no two member sets of the pool share a padding bucket")


def backends_drive(arxiv_adj, arxiv, dense_adj, f: int, dev, card: str) -> dict:
    """Phase 14 (a): ``core.aggregate`` over every format against the SCV
    chain on the same values: bit for bit on integers, within 1e-5 of the
    largest magnitude on normalised values.  COO, CSR, CSC, ``SCVMatrix``,
    ``SCVTiles`` and the bucketed plan at arxiv scale, timed on
    device-resident arrays beside the chain; BCSR, dense and the hybrid on
    the dense-block graphs.  Every SCV format must launch the kernel.
    ``card`` (name and power limit) stands in every timing line."""
    from repro_torch.core.aggregate import (
        aggregate, aggregate_bcsr, aggregate_coo_scatter, aggregate_coo_segsum,
        aggregate_dense, aggregate_hybrid, bcsr_device_arrays, csr_device_arrays,
    )
    from repro_torch.core.formats import COOMatrix, coo_to_bcsr, coo_to_csc, coo_to_csr
    from repro_torch.core.scv import (
        coo_to_scv, coo_to_scv_tiles, plan_from_tiles, scv_to_tiles, split_hybrid,
    )
    kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")
    from repro_torch.kernels.scv_spmm.ops import scv_spmm_plan

    t_phase = time.perf_counter()
    rng = np.random.default_rng(14)
    gen = torch.Generator().manual_seed(14)

    def kinds(adj, plan):
        """(label, COO, plan, Z) with integer values in -4..4 (the plan's
        through its perm, so both hold the same values), then the
        normalised ones with normal Z."""
        ints = rng.integers(-4, 5, adj.nnz).astype(np.float32)
        int_adj = COOMatrix(adj.rows, adj.cols, ints, adj.shape)
        int_plan = plan.reweighted(torch.from_numpy(ints).to(dev))
        z_int = torch.randint(-4, 5, (adj.shape[1], f), generator=gen).float().to(dev)
        z = torch.randn((adj.shape[1], f), generator=gen).to(dev)
        return (("integer", int_adj, int_plan, z_int), ("normalised", adj, plan, z))

    def held(name, label, got, want):
        if label == "integer":
            check(torch.equal(got, want), f"{name} ({label}): not bit-exact with the SCV "
                  f"chain (max err {(got - want).abs().max().item()})")
            return 0.0
        err, scale = rel_err(got, want)
        check(err <= 1e-5 * scale, f"{name} ({label}): max err {err} > 1e-5 * {scale}")
        return err / scale

    def through_aggregate(name, fmt, label, z, want, scv: bool):
        kmod.reset_counts()
        got = aggregate(fmt, z)
        sync(dev)
        check((kmod.launches > 0) == scv, f"{name}: {kmod.launches} kernel launches")
        return held(name, label, got, want)

    out = dict(arxiv={}, dense={}, hybrid={})
    n = arxiv_adj.shape[0]
    for label, adj, plan, z in kinds(arxiv_adj, arxiv.plan):
        want = scv_spmm_plan(plan, z)[:n]
        csr, csc = coo_to_csr(adj), coo_to_csc(adj)
        scv_matrix, tiles = coo_to_scv(adj, plan.tile), coo_to_scv_tiles(adj, plan.tile)
        formats = (("COO (segsum)", adj, False), ("CSR", csr, False), ("CSC (scatter)", csc, False),
                   ("SCVMatrix", scv_matrix, True), ("SCVTiles", tiles, True),
                   ("bucketed plan", plan, True))
        errs = {name: through_aggregate(name, fmt, label, z, want, scv)
                for name, fmt, scv in formats}
        print(f"[backends] arxiv F={f} {label}: every format through aggregate() "
              + ("bit-exact with the SCV chain" if label == "integer" else
                 "within 1e-5: " + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))
              + "; the SCV formats launched the kernel")
        if label != "normalised":
            continue
        # the same work on arrays already on the card, timed
        coo_d = [torch.from_numpy(a).to(dev) for a in (adj.rows, adj.cols, adj.vals)]
        csr_d = csr_device_arrays(csr, dev)
        csc_d = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            csc.row_id, np.repeat(np.arange(n, dtype=np.int32), np.diff(csc.col_ptr)), csc.vals)]
        m_plan = plan_from_tiles(scv_to_tiles(scv_matrix), with_perm=False, device=dev)
        t_plan = plan_from_tiles(tiles, with_perm=False, device=dev)
        timed = {
            "COO (segsum)": lambda: aggregate_coo_segsum(*coo_d, z, n),
            "CSR": lambda: aggregate_coo_segsum(csr_d["rows"], csr_d["cols"], csr_d["vals"], z, n),
            "CSC (scatter)": lambda: aggregate_coo_scatter(*csc_d, z, n),
            "SCVMatrix": lambda: scv_spmm_plan(m_plan, z),
            "SCVTiles": lambda: scv_spmm_plan(t_plan, z),
            "bucketed plan": lambda: scv_spmm_plan(plan, z),
        }
        ms = {k: device_ms(fn, 10) for k, fn in timed.items()}
        chain = ms["bucketed plan"]
        out["arxiv"] = dict(ms=ms, chain_ms=chain, single_cap=(m_plan.cap, t_plan.cap))
        print(f"[backends] arxiv F={f}, arrays on the card, device_ms (x the SCV chain "
              f"{chain:.4f} ms): " + ", ".join(f"{k} {v:.4f} ({v / chain:.2f}x)"
                                               for k, v in ms.items())
              + f"; SCVMatrix/SCVTiles single-cap plans at cap {m_plan.cap}/{t_plan.cap} "
              f"({card})")
        del coo_d, csr_d, csc_d, m_plan, t_plan

    for name, (adj, g) in dense_adj.items():
        nd = adj.shape[0]
        bcsr_here = nd == MIXED_DENSE[0]
        for label, kadj, plan, z in kinds(adj, g.plan):
            want = scv_spmm_plan(plan, z)[:nd]
            tiles = coo_to_scv_tiles(kadj, plan.tile)
            sparse, dense = split_hybrid(tiles)
            kmod.reset_counts()
            got = aggregate_hybrid(tiles, z)
            sync(dev)
            check(kmod.launches > 0, f"hybrid {name}: the sparse part launched no kernel")
            err = held(f"hybrid {name}", label, got, want)
            out["hybrid"][name] = dict(sparse_tiles=sparse.n_tiles, dense_tiles=dense.n_tiles,
                                       nnz_sparse=sparse.nnz, nnz=tiles.nnz)
            print(f"[backends] hybrid {name} {label}: split {sparse.n_tiles} sparse tiles "
                  f"({sparse.nnz} entries) + {dense.n_tiles} dense {plan.tile}x{plan.tile} "
                  f"blocks of {tiles.n_tiles} tiles ({tiles.nnz} entries); "
                  + ("bit-exact" if label == "integer" else f"rel err {err:.1e}"))
            if not bcsr_here:
                continue
            bcsr = coo_to_bcsr(kadj, plan.tile)
            dense_m = torch.from_numpy(kadj.to_dense()).to(dev)
            e_b = through_aggregate("BCSR", bcsr, label, z, want, False)
            e_d = through_aggregate("dense", dense_m, label, z, want, False)
            print(f"[backends] {name} {label}: BCSR ({bcsr.n_blocks} blocks of {plan.tile}) "
                  f"and dense through aggregate() "
                  + ("bit-exact with the SCV chain" if label == "integer"
                     else f"within 1e-5 ({e_b:.1e}, {e_d:.1e})"))
            if label == "normalised":
                arr = bcsr_device_arrays(bcsr, dev)
                ms = dict(BCSR=device_ms(lambda: aggregate_bcsr(bcsr, z, arrays=arr), 10),
                          dense=device_ms(lambda: aggregate_dense(dense_m, z), 10),
                          chain=device_ms(lambda: scv_spmm_plan(plan, z), 10))
                out["dense"][name] = dict(ms=ms, n_blocks=bcsr.n_blocks)
                print(f"[backends] {name} F={f}, arrays on the card, device_ms: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
                      + f" (BCSR/chain {ms['BCSR'] / ms['chain']:.2f}x, dense/chain "
                      f"{ms['dense'] / ms['chain']:.2f}x; {card})")
                del arr
            del bcsr, dense_m
    out["seconds"] = time.perf_counter() - t_phase
    return out


def capture_drive(arxiv, cfg, pool, layout, check_outputs, dev, card: str) -> dict:
    """Phase 14 (b) and (c): the forward captured in a CUDA graph against
    the eager one, bit for bit on integer plan values and features: the
    arxiv-scale GCN (timed both ways, 20 forwards on the host clock, the
    replay alone with device_ms), the four kinds on two serving composites
    of one padding bucket; phase 4's burst twice and its open loop, through
    engines that capture and engines with the forward eager, in
    ``SERVE_PAIRS`` pairs of turns; then ``trace_check`` over the four kinds
    on the card.
    ``card`` (name and power limit) stands in every timing line."""
    from repro_torch.core.tracecheck import trace_check
    kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")
    from repro_torch.launch.graph_serve import (
        build_default_engine, make_requests, poisson_arrivals, run_open_loop,
    )
    from repro_torch.models.gnn import (
        CapturedForward, GNNConfig, forward_key, gnn_forward, init_gnn,
    )
    from repro_torch.serve.graph_engine import plan_launches

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(15)
    out = {}

    # the arxiv-scale forward, eager against captured
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
    g_int = dataclasses.replace(arxiv, plan=perm_int_plan(arxiv.plan))
    x_int = torch.randint(-4, 5, (arxiv.n_nodes, cfg.d_in), generator=gen).float().to(dev)
    per_forward = plan_launches(arxiv.plan) * cfg.n_layers
    fwd = CapturedForward()
    kmod.reset_counts()
    t0 = time.perf_counter()
    first = fwd(params, cfg, g_int, x_int)  # eager, then captured
    sync(dev)
    t_capture = time.perf_counter() - t0
    with torch.inference_mode():
        eager = gnn_forward(params, cfg, g_int, x_int)
        replayed = fwd(params, cfg, g_int, x_int)
        sync(dev)
        check(torch.equal(first, eager) and torch.equal(replayed, eager),
              "arxiv: the captured forward is not bit-exact with the eager one on integers")
        check(kmod.launches == 3 * per_forward,
              f"arxiv: {kmod.launches} launches over 3 forwards of {per_forward}")
        x = torch.randn((arxiv.n_nodes, cfg.d_in), generator=gen).to(dev)
        eager_n, captured_n = gnn_forward(params, cfg, arxiv, x), fwd(params, cfg, arxiv, x)
        sync(dev)
        err, scale = rel_err(captured_n, eager_n)
        check(err <= 1e-5 * max(1.0, scale), f"arxiv normalised: captured off eager by {err}")
        same_bits = bool(torch.equal(captured_n, eager_n))
        times = {}
        for label, fn in (("eager", lambda: gnn_forward(params, cfg, arxiv, x)),
                          ("captured", lambda: fwd(params, cfg, arxiv, x))):
            fn()
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(CAPTURE_REPS):
                fn()
            sync(dev)
            times[label] = (time.perf_counter() - t0) * 1e3 / CAPTURE_REPS
        entry = next(iter(fwd._entries.values()))  # None off the card (no capture)
        replay_ms = device_ms(entry.graph.replay, CAPTURE_REPS) if entry else float("nan")
        eager_dev_ms = device_ms(lambda: gnn_forward(params, cfg, arxiv, x), CAPTURE_REPS)
        w0, w1 = params["layer0"]["w"], params["layer1"]["w"]
        h1 = torch.relu(eager_n.new_empty((arxiv.n_nodes, cfg.d_hidden)).normal_())
        comb_ms = device_ms(lambda: (x @ w0, h1 @ w1), CAPTURE_REPS)
    pads = [(s.runs.n_units, s.n_tiles) for s in entry.g.plan.segments] if entry else []
    out["arxiv"] = dict(eager_ms=times["eager"], captured_ms=times["captured"],
                        replay_device_ms=replay_ms, eager_device_ms=eager_dev_ms,
                        combination_ms=comb_ms, capture_s=t_capture, same_bits=same_bits,
                        padded_units=pads)
    print(f"[capture] arxiv 2-layer gcn-paper forward: eager {times['eager']:.3f} ms, "
          f"captured {times['captured']:.3f} ms per forward (host clock, {CAPTURE_REPS} "
          f"forwards); the replay alone {replay_ms:.4f} ms, the eager forward alone "
          f"{eager_dev_ms:.4f} ms (device_ms); both combinations h @ W {comb_ms:.4f} ms; "
          f"first call (eager + capture) {1e3 * t_capture:.1f} ms; integer inputs bit-exact, "
          f"normalised {'bit-exact' if same_bits else f'max err {err:.2e}'}; padded grid "
          f"(units, tiles) per segment {pads}; {kmod.launches} launches ({card})")
    del fwd, entry, first, eager, replayed, g_int, x_int

    # the four kinds on two composites of one padding bucket
    kinds = {}
    for kind in ("gcn", "sage", "gin", "gat"):
        kcfg = GNNConfig(name=kind, kind=kind, d_in=cfg.d_in, d_hidden=cfg.d_hidden,
                         n_classes=cfg.n_classes, n_layers=cfg.n_layers)
        kparams = init_gnn(torch.Generator().manual_seed(0), kcfg, device=dev)
        if kind == "gat":
            # uniform attention: the softmax sums (index_add_, atomics in no
            # fixed order) add ones, exact in any order
            bit_params = {layer: {k: torch.zeros_like(v) if k.startswith("a_") else v
                                  for k, v in ps.items()} for layer, ps in kparams.items()}
        else:
            bit_params = kparams
        pair = same_bucket_composites(pool, layout, with_edges=kind == "gat")
        graphs = [bg.graph.to(dev) for bg in pair]
        graphs = [dataclasses.replace(g, plan=with_integer_vals(g.plan, gen, dev)) for g in graphs]
        xs = [torch.randint(-4, 5, (g.n_nodes, kcfg.d_in), generator=gen).float().to(dev)
              for g in graphs]
        check(forward_key(bit_params, kcfg, graphs[0], xs[0])
              == forward_key(bit_params, kcfg, graphs[1], xs[1]), f"{kind}: two keys")
        kfwd = CapturedForward()
        with torch.inference_mode():
            for i in (0, 1, 0):
                kmod.reset_counts()
                got = kfwd(bit_params, kcfg, graphs[i], xs[i])
                sync(dev)
                launched = kmod.launches
                want = gnn_forward(bit_params, kcfg, graphs[i], xs[i])
                check(launched == plan_launches(graphs[i].plan) * kcfg.n_layers,
                      f"{kind}: {launched} launches in one forward")
                check(torch.equal(got, want), f"{kind} composite {i}: captured != eager")
            err = 0.0
            if kind == "gat":  # seed-0 attention: within the atomics' rounding
                got = kfwd(kparams, kcfg, graphs[1], xs[1])
                err, scale = rel_err(got, gnn_forward(kparams, kcfg, graphs[1], xs[1]))
                check(err <= 1e-5 * max(1.0, scale), f"gat attention: captured off by {err}")
        check((kfwd.captures, kfwd.replays) == (1, 2 + (kind == "gat")),
              f"{kind}: {kfwd.captures} captures, {kfwd.replays} replays")
        kinds[kind] = dict(params=kparams, cfg=kcfg, graphs=graphs, xs=xs)
        print(f"[capture] {kind} on two composites of one bucket ({graphs[0].n_nodes} nodes, "
              f"tiles {[s.n_tiles for s in graphs[0].plan.segments]} and "
              f"{[s.n_tiles for s in graphs[1].plan.segments]}): first call, replay after "
              f"the other's copy-in, replay again: bit-exact with eager on integers"
              + (f"; seed-0 attention within {err:.1e}" if kind == "gat" else ""))

    # phase 4's burst twice, and its open loop, each through a fresh engine
    # that captures, in SERVE_PAIRS pairs of turns with the same engine with
    # its forward eager (captured first in even pairs, eager first in odd
    # ones); outputs checked in the first pair, launches in every run
    class EagerForward(CapturedForward):
        def __call__(self, params, cfg, g, x):
            return gnn_forward(params, cfg, g, x)

    def engine_for(mode, buckets):
        engine = build_default_engine(model=cfg, device=dev, seed=0)
        if mode == "eager":
            engine.forward = EagerForward()
        dispatch = engine._dispatch_wave

        def record(wave):
            bg, o = dispatch(wave)
            buckets.append(forward_key(bg.graph))
            return bg, o
        engine._dispatch_wave = record
        return engine

    def delta(m, before, launches):
        return dict(waves=m["waves"] - before["waves"],
                    **{k: m[f"forward_{k}"] - before[f"forward_{k}"]
                       for k in ("captures", "replays", "deferred", "graphs", "copy_bytes",
                                 "capture_seconds")},
                    launches=launches)

    def serve_twice(mode: str, checked: bool) -> list:
        buckets = []
        engine = engine_for(mode, buckets)
        bursts = []
        for burst in range(2):
            reqs = make_requests(np.random.default_rng(2), pool, SERVE_REQUESTS, cfg.d_in)
            for r in reqs:
                engine.submit(r)
            before, launches_before = engine.metrics(), kmod.launches
            t0 = time.perf_counter()
            engine.run()
            wall = time.perf_counter() - t0
            m = engine.metrics()
            launches = kmod.launches - launches_before
            check(launches == m["launches"] - before["launches"] > 0,
                  f"{mode} burst {burst}: kernel launches {launches} != engine launches "
                  f"{m['launches'] - before['launches']}")
            check(all(r.done for r in reqs), f"{mode} burst {burst}: a request not served")
            worst = check_outputs(engine, reqs, f"{mode} burst {burst}") if checked else None
            bursts.append(dict(graphs_per_s=SERVE_REQUESTS / wall, wall=wall, worst=worst,
                               p50_ms=float(np.median([r.latency_s for r in reqs])) * 1e3,
                               **delta(m, before, launches)))
        if mode == "captured":
            distinct = len(set(buckets))
            b0, b1 = bursts
            card_graphs = dev.type == "cuda"  # on the CPU a key holds no graph
            check(b0["captures"] <= distinct
                  and b0["graphs"] == (b0["captures"] if card_graphs else 0)
                  and b0["deferred"] == (b0["waves"] - b0["captures"] if card_graphs else 0)
                  and b1["captures"] == b1["graphs"] == b1["deferred"] == 0
                  and b1["replays"] == b1["waves"],
                  f"captures {[b['captures'] for b in bursts]}, graphs "
                  f"{[b['graphs'] for b in bursts]}, replays {[b['replays'] for b in bursts]} "
                  f"for {distinct} padding buckets")
            out["buckets"] = distinct
        return bursts

    def open_loop(mode: str, checked: bool) -> dict:
        buckets = []
        engine = engine_for(mode, buckets)
        rng = np.random.default_rng(3)
        reqs = make_requests(rng, pool, SERVE_REQUESTS, cfg.d_in)
        arrivals = poisson_arrivals(rng, SERVE_REQUESTS, SERVE_RATE)
        launches_before = kmod.launches
        stats = run_open_loop(engine, reqs, arrivals, mode="async")
        launches = kmod.launches - launches_before
        m = engine.metrics()
        check(stats["completed"] == SERVE_REQUESTS, f"{mode} open loop: {stats['completed']} served")
        check(launches == m["launches"] > 0,
              f"{mode} open loop: kernel launches {launches} != engine launches {m['launches']}")
        if mode == "captured":
            check(m["forward_graphs"] <= m["forward_captures"] <= len(set(buckets)),
                  f"open loop: {m['forward_graphs']} graphs, {m['forward_captures']} keys for "
                  f"{len(set(buckets))} padding buckets")
        worst = check_outputs(engine, reqs, f"{mode} open loop") if checked else None
        return dict(graphs_per_s=stats["graphs_per_s"], p50_ms=stats["p50_ms"],
                    p99_ms=stats["p99_ms"], worst=worst,
                    **delta(m, {k: 0 for k in m}, launches))

    def line(label, mode, r):
        return (f"[capture] {label}, {mode} engine: {r['graphs_per_s']:.1f} graphs/s, p50 "
                f"{r['p50_ms']:.2f} ms, {r['waves']} waves, {r['captures']} keys, {r['graphs']} "
                f"graphs captured, {r['replays']} replays, {r['deferred']} waves eager before "
                f"their capture, {r['copy_bytes']} bytes copied in, captures "
                f"{r['capture_seconds']:.3f} s, kernel launches {r['launches']} = engine "
                f"launches" + ("" if r["worst"] is None else f", worst rel err {r['worst']:.2e}")
                + f" ({card})")

    runs = {"captured": [], "eager": []}
    for pair in range(SERVE_PAIRS):
        for mode in (("captured", "eager") if pair % 2 == 0 else ("eager", "captured")):
            bursts = serve_twice(mode, checked=pair == 0)
            ol = open_loop(mode, checked=pair == 0)
            runs[mode].append(dict(first=bursts[0], repeated=bursts[1], open_loop=ol))
            if pair == 0:
                for label, r in (("burst", bursts[0]), ("repeated burst", bursts[1]),
                                 (f"open loop at {SERVE_RATE:.0f}/s", ol)):
                    print(line(label, mode, r))
    out["bursts"] = [runs["captured"][0]["first"], runs["captured"][0]["repeated"]]
    b0, b1 = out["bursts"]
    print(f"[capture] the captured engine's bursts: {out['buckets']} padding buckets, {b0['graphs']} "
          f"graphs captured after the first burst's last wave ({b0['capture_seconds']:.3f} s of "
          f"its {b0['wall']:.3f} s), none in the repeat, which replayed all {b1['replays']} waves")
    gps = {mode: {k: [r[k]["graphs_per_s"] for r in rs] for k in ("first", "repeated", "open_loop")}
           for mode, rs in runs.items()}
    p50 = {mode: [r["open_loop"]["p50_ms"] for r in rs] for mode, rs in runs.items()}

    def listed(v):
        return ", ".join(f"{x:.1f}" for x in v)
    for k, label in (("first", "first burst"), ("repeated", "repeated burst"),
                     ("open_loop", f"open loop at {SERVE_RATE:.0f}/s")):
        c, e = gps["captured"][k], gps["eager"][k]
        print(f"[capture] {label}, {SERVE_PAIRS} pairs in turns, graphs/s: captured median "
              f"{np.median(c):.1f} [{listed(c)}], eager median {np.median(e):.1f} [{listed(e)}], "
              f"captured faster in {sum(a > b for a, b in zip(c, e))} of {SERVE_PAIRS} pairs ({card})")
    print(f"[capture] open loop at {SERVE_RATE:.0f}/s, p50 latency ms: captured median "
          f"{np.median(p50['captured']):.2f} [{listed(p50['captured'])}], eager median "
          f"{np.median(p50['eager']):.2f} [{listed(p50['eager'])}] ({card})")
    out["turns"] = gps
    out["open_loop_p50_ms"] = p50

    # (c) trace_check over the four kinds' serving examples, on the card
    report = trace_check(
        {k: (v["params"], v["cfg"]) for k, v in kinds.items()},
        {k: [(v["graphs"][0], v["xs"][0]), (v["graphs"][1], v["xs"][1]),
             (v["graphs"][0], v["xs"][1])] for k, v in kinds.items()},
    )
    check(report.ok, f"trace_check: {report.summary()}")
    print(f"[capture] trace_check over gcn, sage, gin, gat on the card: "
          f"{report.summary().splitlines()[0]}; ok")
    sync(dev)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def lm_card_vs_cpu(archs, dev) -> dict:
    """15(a): each LM arch's reduced config in float32, the same weights
    and tokens through prefill and decode on the card and on the CPU:
    logits and every cache leaf within 1e-4 of the largest magnitude."""
    from repro_torch.models import transformer as TT

    worst = {}
    for name, spec in archs.items():
        cfg = spec.cfg(reduced=True)
        params, _ = spec.init(torch.Generator().manual_seed(0), reduced=True, device="cpu")
        gen = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab, (2, LM_PROMPT + LM_DECODE_STEPS), generator=gen,
                             dtype=torch.int32)
        extra = (torch.randn((2, cfg.n_frontend_tokens, cfg.d_model), generator=gen)
                 if cfg.n_frontend_tokens else None)
        n_front = cfg.n_frontend_tokens
        max_len = n_front + LM_PROMPT + LM_DECODE_STEPS + 2

        def run(p, d):
            e = None if extra is None else extra.to(d)
            logits, cache = TT.prefill(p, cfg, toks[:, :LM_PROMPT].to(d), extra_embed=e,
                                       max_len=max_len)
            outs = [logits]
            for s in range(LM_DECODE_STEPS):
                pos = torch.full((2, 1), n_front + LM_PROMPT + s, dtype=torch.int32, device=d)
                tok = toks[:, LM_PROMPT + s : LM_PROMPT + s + 1].to(d)
                logits, cache = TT.decode_step(p, cfg, tok, cache, pos)
                outs.append(logits)
            return outs, dict(TT.leaf_paths(cache))

        want, want_cache = run(params, torch.device("cpu"))
        got, got_cache = run(TT.params_from_jax(params, dev), dev)
        err = 0.0
        pairs = [(f"logits {i}", g, w) for i, (g, w) in enumerate(zip(got, want))]
        pairs += [(k, got_cache[k], w) for k, w in want_cache.items()]
        check(set(got_cache) == set(want_cache), f"{name}: cache leaves differ")
        for what, g, w in pairs:
            g = g.cpu()
            if not w.dtype.is_floating_point:
                check(torch.equal(g, w), f"{name} {what}: card and CPU differ")
                continue
            e, scale = rel_err(g, w)
            check(e <= 1e-4 * max(scale, 1e-30), f"{name} {what}: card off the CPU by {e} "
                  f"(max |CPU| {scale})")
            err = max(err, e / max(scale, 1e-30))
        worst[name] = err
        print(f"[lm] 15(a) {name} reduced, float32: prefill {LM_PROMPT} + {LM_DECODE_STEPS} "
              f"decode steps, card against CPU: {len(pairs)} leaves, max err / max |CPU| "
              f"{err:.2e}")
    return worst


def lm_decode_consistency(full_cfg, dev, card: str) -> dict:
    """15(b): gemma3-4b at full width, depth cut to LM_GEMMA_LAYERS, float32:
    a blockwise prefill whose local rings wrap, then one decode step, held
    against the forward over every token by the reference's tolerances:
    |d log-softmax| < 5e-3 with the same argmax for the plain cache; < 0.15
    for the int8 cache, with the same argmax on every row whose forward
    leads its runner-up by more than twice that bound (a random-weight
    model over 262,144 tokens is nearly flat: a closer pair may swap
    within the bound, as it does in the reference's own int8 arithmetic)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TT

    out = {}
    gen = torch.Generator(device=dev).manual_seed(2)
    base = dataclasses.replace(full_cfg, n_layers=LM_GEMMA_LAYERS, dtype=torch.float32)
    t0 = time.perf_counter()
    params, _ = TT.init_lm(gen, base, device=dev)
    n_params = sum(t.numel() for _, t in TT.leaf_paths(params))
    S = LM_GEMMA_PROMPT + 1
    toks = torch.randint(0, base.vocab, (LM_GEMMA_BATCH, S), generator=gen, device=dev,
                         dtype=torch.int32)
    with torch.inference_mode():
        x, _, _ = TT.hidden_states(params, base, toks)
        direct = L.unembed_logits(params["embed"], x[:, -1:], base.final_softcap,
                                  true_vocab=base.vocab)
        ld = torch.log_softmax(direct, dim=-1)
        top2 = ld.topk(2, dim=-1).values[:, 0]
        margin = (top2[:, 0] - top2[:, 1]).tolist()  # the forward's top-1 lead, per row
        for kv_quant, tol in ((False, 5e-3), (True, 0.15)):
            cfg = dataclasses.replace(base, kv_quant=kv_quant)
            _, cache = TT.prefill(params, cfg, toks[:, :-1], max_len=S)
            pos = torch.full((LM_GEMMA_BATCH, 1), S - 1, dtype=torch.int32, device=dev)
            logits, _ = TT.decode_step(params, cfg, toks[:, -1:], cache, pos)
            lp = torch.log_softmax(logits, dim=-1)
            err = torch.where(torch.isfinite(lp), lp - ld, 0.0).abs().max().item()
            same = (logits.argmax(-1) == direct.argmax(-1))[:, 0].tolist()
            check(err < tol, f"gemma3-4b kv_quant={kv_quant}: |d log-softmax| {err} >= {tol}")
            decisive = [m > 2 * tol for m in margin]
            check(all(ok for ok, d in zip(same, decisive) if d),
                  f"gemma3-4b kv_quant={kv_quant}: decode argmax differs from the forward's "
                  f"on a row it leads by more than {2 * tol} (margins {margin}, same {same})")
            out[kv_quant] = (err, same, decisive)
    torch.cuda.synchronize()
    print(f"[lm] 15(b) gemma3-4b full width ({base.d_model} d, vocab {base.vocab}), "
          f"{LM_GEMMA_LAYERS} of {full_cfg.n_layers} layers ({base.first_dense} global + "
          f"{base.n_rep} x {base.layer_pattern}), {n_params} params in float32, B = "
          f"{LM_GEMMA_BATCH}: prefill {LM_GEMMA_PROMPT} (blockwise, local rings of "
          f"{base.window} wrap) + 1 decode step against the forward over {S} tokens: "
          f"|d log-softmax| {out[False][0]:.3e} (< 5e-3), argmax equal {out[False][1]} "
          f"(rows held: {out[False][2]}); int8 cache {out[True][0]:.3e} (< 0.15), argmax "
          f"equal {out[True][1]} (rows held: {out[True][2]}); the forward's top-1 leads by "
          f"{', '.join(f'{m:.4f}' for m in margin)}; {time.perf_counter() - t0:.1f} s [{card}]")
    del params, x
    return out


class _MoEInputs:
    """Records each ``moe_sorted`` call's input during one prefill."""

    def __init__(self, layers_mod):
        self.mod, self.seen = layers_mod, []

    def __enter__(self):
        self.orig = self.mod.moe_sorted

        def recording(p, x, mcfg):
            self.seen.append((p, x))
            return self.orig(p, x, mcfg)

        self.mod.moe_sorted = recording
        return self

    def __exit__(self, *exc):
        self.mod.moe_sorted = self.orig


def lm_serve(full_cfg, dev, card: str) -> dict:
    """15(c): olmoe-1b-7b at full width and depth, bf16, weights from a
    seeded generator on the card, served by ``ServeEngine``; then the
    SCV-sorted dispatch against the dense one on a layer's MoE input from
    that serving's first prefill, in float32 with no slot dropped."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TT
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    cfg = full_cfg
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    params, _ = TT.init_lm(torch.Generator(device=dev).manual_seed(3), cfg, device=dev)
    n_params = sum(t.numel() for _, t in TT.leaf_paths(params))
    served = TT.serving_params(params, cfg)
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size() for _, t in TT.leaf_paths(served))
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    timings = {"prefill": [], "decode": []}
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def timed(kind, fn):
        def call(*args):
            nonlocal finite
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            logits, state = fn(*args)
            end.record()
            finite = finite & torch.isfinite(logits).all()
            tokens = args[1] if kind == "prefill" else args[2]
            timings[kind].append((tuple(tokens.shape), start, end))
            return logits, state
        return call

    engine = ServeEngine(
        served,
        timed("prefill", lambda p, t: TT.prefill(p, cfg, t, max_len=t.shape[1] + LM_MAX_NEW)),
        timed("decode", lambda p, s, t, pos: TT.decode_step(p, cfg, t, s, pos)),
        EngineConfig(max_batch=LM_MAX_BATCH), device=dev)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, LM_SERVE_PROMPT) for _ in range(LM_SERVE_REQUESTS)]
    prompts.append(rng.integers(0, cfg.vocab, LM_LONG_PROMPT))
    for rid, pr in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=pr.astype(np.int32), max_new=LM_MAX_NEW))
    first_batch = torch.from_numpy(np.stack(prompts[:LM_MAX_BATCH]).astype(np.int32)).to(dev)
    with torch.inference_mode():  # warm-up (library set-up), outside the timings
        _, cache = TT.prefill(served, cfg, first_batch[:, :16], max_len=17)
        TT.decode_step(served, cfg, first_batch[:, :1], cache,
                       torch.full((LM_MAX_BATCH, 1), 16, dtype=torch.int32, device=dev))
    del cache
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.inference_mode():
        done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() - base
    n_tokens = sum(len(r.out) for r in done)
    check(len(done) == len(prompts) and all(len(r.out) == LM_MAX_NEW for r in done),
          f"olmoe serving: {[len(r.out) for r in done]} tokens per request")
    check(all(0 <= t < cfg.vocab for r in done for t in r.out), "olmoe serving: token off vocab")
    check(bool(finite.item()), "olmoe serving: non-finite logits")
    prefill_ms = [(shape, s.elapsed_time(e)) for shape, s, e in timings["prefill"]]
    decode = {}
    for shape, s, e in timings["decode"]:
        decode.setdefault(shape[0], []).append(s.elapsed_time(e))
    decode_ms = {b: float(np.median(v)) for b, v in decode.items()}
    # decode reads every weight once (the sorted dispatch runs all experts)
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[lm] 15(c) olmoe-1b-7b full width and depth ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k}, vocab {cfg.vocab}): "
          f"{n_params} params drawn on the card, served in {cfg.dtype} "
          f"({weight_bytes} weight bytes; init and cast {init_s:.1f} s) [{card}]")
    print(f"[lm] 15(c) served {len(done)} requests ({LM_SERVE_REQUESTS} x {LM_SERVE_PROMPT} + "
          f"1 x {LM_LONG_PROMPT} prompt tokens, max_new {LM_MAX_NEW}, max_batch "
          f"{LM_MAX_BATCH}): {n_tokens} tokens in {wall:.3f} s, {n_tokens / wall:.1f} tokens/s "
          f"(host clock); peak memory {peak} bytes (max_memory_allocated over what earlier "
          f"phases hold) [{card}]")
    print("[lm] 15(c) prefill ms per batch (CUDA events): " + ", ".join(
        f"{b} x {n} {ms:.3f}" for (b, n), ms in prefill_ms)
        + "; decode ms per step (median): " + ", ".join(
        f"B={b} {ms:.3f} over {len(decode[b])} steps" for b, ms in decode_ms.items())
        + f"; weight-read bound {bound_ms:.3f} ms a step [{card}]")

    # the SCV-sorted dispatch at full width: layer 0's MoE input of the
    # first batch's prefill, float32, capacity E/K so no slot drops
    with torch.inference_mode(), _MoEInputs(L) as rec:
        TT.prefill(served, cfg, first_batch, max_len=LM_SERVE_PROMPT)
    p0, x0 = rec.seen[0]
    pf = {k: v.float() for k, v in p0.items()}
    xf = x0.float()
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    mcfg = dataclasses.replace(cfg.moe, capacity_factor=E / K)
    cap = int(mcfg.capacity_factor * xf.shape[1] * K / E) + 1
    check(cap >= xf.shape[1], f"capacity {cap} would drop slots")
    with torch.inference_mode():
        y_s, aux_s = L.moe_sorted(pf, xf, mcfg)
        y_d, aux_d = L.moe_dense(pf, xf, mcfg)
        err, scale = rel_err(y_s, y_d)
        check(err <= 1e-4 * scale, f"moe_sorted off moe_dense at full width: {err} (max {scale})")
        # the two aux losses differ by the reference's own definitions: the
        # sorted one counts routed slots, the dense one sums gate mass
        probs, gate, eidx = L._route(pf, xf, mcfg)
        me = probs.mean(dim=(0, 1))
        counts = torch.bincount(eidx.reshape(-1), minlength=E).float() / eidx.numel()
        mass = torch.zeros((E,), device=dev).index_add_(0, eidx.reshape(-1), gate.reshape(-1))
        want_s = (E * (me * counts).sum()).item()
        want_d = (E * (me * mass / (xf.shape[0] * xf.shape[1])).sum()).item()
        check(abs(aux_s.item() - want_s) <= 1e-4 * abs(want_s), f"sorted aux {aux_s} != {want_s}")
        check(abs(aux_d.item() - want_d) <= 1e-4 * abs(want_d), f"dense aux {aux_d} != {want_d}")
        sorted_ms = device_ms(lambda: L.moe_sorted(pf, xf, mcfg), 5)
        dense_ms = device_ms(lambda: L.moe_dense(pf, xf, mcfg), 5)
        serve_sorted_ms = device_ms(lambda: L.moe_sorted(p0, x0, cfg.moe), 5)
        serve_dense_ms = device_ms(lambda: L.moe_dense(p0, x0, cfg.moe), 5)
    print(f"[lm] 15(c) moe_sorted against moe_dense, layer 0 of the first prefill (B = "
          f"{xf.shape[0]}, S = {xf.shape[1]}), float32, capacity factor {E / K:g} (cap {cap}, "
          f"nothing dropped): max abs err {err:.3e} (max |dense| {scale:.3e}); aux sorted "
          f"{aux_s.item():.6f}, dense {aux_d.item():.6f}, each its own formula's; float32 ms "
          f"sorted {sorted_ms:.3f}, dense {dense_ms:.3f}; as served ({cfg.dtype}, capacity "
          f"factor {cfg.moe.capacity_factor:g}) sorted {serve_sorted_ms:.3f}, dense "
          f"{serve_dense_ms:.3f} (device_ms) [{card}]")
    del served, pf, xf, y_s, y_d
    return dict(wall=wall, tokens=n_tokens, peak=peak, weight_bytes=weight_bytes,
                prefill_ms=prefill_ms, decode_ms=decode_ms, moe_err=err / scale)


def lm_drive(dev, card: str) -> dict:
    """Phase 15: the decoder-LM path (no SCV kernel on it)."""
    from repro_torch.configs import ARCHS
    kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")

    t0 = time.perf_counter()
    worst = lm_card_vs_cpu({k: v for k, v in ARCHS.items() if v.kind == "lm"}, dev)
    consistency = lm_decode_consistency(ARCHS["gemma3-4b"].cfg(), dev, card)
    kmod.reset_counts()
    serving = lm_serve(ARCHS["olmoe-1b-7b"].cfg(), dev, card)
    launches = (kmod.launches, kmod.scalar_launches)
    check(launches == (0, 0), f"the LM path launched SCV kernels: {launches}")
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    print(f"[lm] phase 15: {seconds:.1f} s; SCV kernel launches on the LM path: 0 (the LM "
          f"substrate reaches no pl.pallas_call)")
    return dict(worst=worst, consistency=consistency, serving=serving, seconds=seconds)


def tree_bytes(tree) -> int:
    from repro_torch.models.transformer import leaf_paths

    return sum(t.numel() * t.element_size() for _, t in leaf_paths(tree))


def ssm_card_vs_cpu(archs, dev) -> dict:
    """16(a): the SSM, hybrid and encoder-decoder archs' reduced configs in
    float32, the same weights and inputs on the card and on the CPU: hidden
    states (the encoder's output and the teacher-forced decoder for
    whisper-small), the chunked prefill (the decoder cache for
    whisper-small), 3 decode steps and every state leaf, within 1e-4 of
    the largest magnitude."""
    from repro_torch.configs.common import SHAPES
    from repro_torch.models import encdec as ED
    from repro_torch.models import hybrid as HY
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as TT

    worst = {}
    for name in SSM_ARCHS:
        spec = archs[name]
        cfg = spec.cfg(reduced=True)
        params, _ = spec.init(torch.Generator().manual_seed(0), reduced=True, device="cpu")
        gen = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab, (2, LM_PROMPT), generator=gen, dtype=torch.int32)
        frames = torch.randn((2, LM_PROMPT, cfg.d_model), generator=gen)
        prefill = spec.make_prefill_step(SHAPES["prefill_32k"], reduced=True)
        decode = spec.make_decode_step(SHAPES["decode_32k"], reduced=True)

        def run(p, d):
            out = {}
            if spec.kind == "encdec":
                enc = ED.encode(p, cfg, frames.to(d))
                out["encode"] = enc
                out["decode_train"] = ED.decode_train(p, cfg, toks[:, :LM_DECODE_STEPS].to(d), enc)
                state = prefill(p, {"frames": frames.to(d)})
            else:
                hidden = SSM.mamba2_lm_hidden if spec.kind == "mamba_lm" else HY.hidden_states
                out["hidden"] = hidden(p, cfg, toks.to(d))[0]
                out["prefill"] = prefill(p, {"tokens": toks.to(d)})
                state = (SSM.init_mamba2_lm_state(cfg, 2, device=d) if spec.kind == "mamba_lm"
                         else HY.init_state(cfg, 2, LM_PROMPT, device=d))
            for s in range(LM_DECODE_STEPS):
                batch = {"token": toks[:, s : s + 1].to(d),
                         "pos": torch.full((2, 1), s, dtype=torch.int32, device=d)}
                out[f"decode {s}"], state = decode(p, state, batch)
            out.update((f"state {k}", v) for k, v in TT.leaf_paths(state))
            return out

        with torch.inference_mode():
            want = run(params, torch.device("cpu"))
            got = run(TT.params_from_jax(params, dev), dev)
        check(set(got) == set(want), f"{name}: outputs differ in kind")
        err = 0.0
        for what, w in want.items():
            g = got[what].cpu()
            if not w.dtype.is_floating_point:
                check(torch.equal(g, w), f"{name} {what}: card and CPU differ")
                continue
            e, scale = rel_err(g, w)
            check(e <= 1e-4 * max(scale, 1e-30), f"{name} {what}: card off the CPU by {e} "
                  f"(max |CPU| {scale})")
            err = max(err, e / max(scale, 1e-30))
        worst[name] = err
        print(f"[ssm] 16(a) {name} reduced ({spec.kind}), float32: {', '.join(want)}; card "
              f"against CPU, max err / max |CPU| {err:.2e}")
    return worst


def ssm_consistency(archs, dev, card) -> dict:
    """16(b): mamba2-780m and zamba2-2.7b at full width and depth in
    float32, B = SSM_BATCH: the last position's log-softmax from the
    chunked ``hidden_states`` over SSM_PROMPT tokens (three SSD chunks, the
    last one padded) against the one after SSM_PROMPT recurrent steps
    through the launcher's captured decode (the SSD duality), within
    SSM_TOL."""
    from repro_torch.launch.serve import serve_fns
    from repro_torch.models import hybrid as HY
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as TT

    out = {}
    for seed, name in enumerate(("mamba2-780m", "zamba2-2.7b"), start=4):
        spec = archs[name]
        cfg = dataclasses.replace(spec.cfg(), dtype=torch.float32)
        gen = torch.Generator(device=dev).manual_seed(seed)
        t0 = time.perf_counter()
        params, _ = spec.init(gen, device=dev)
        n_params = sum(t.numel() for _, t in TT.leaf_paths(params))
        toks = torch.randint(0, cfg.vocab, (SSM_BATCH, SSM_PROMPT), generator=gen, device=dev,
                             dtype=torch.int32)
        hidden = SSM.mamba2_lm_hidden if spec.kind == "mamba_lm" else HY.hidden_states
        prefill_fn, decode_fn = serve_fns(spec, cfg, SSM_PROMPT + LM_MAX_NEW, dev)
        with torch.inference_mode():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            x, _ = hidden(params, cfg, toks)
            direct = L.unembed_logits(params["embed"], x[:, -1:], true_vocab=cfg.vocab)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            logits, state = prefill_fn(params, toks)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            ld = torch.log_softmax(direct, dim=-1)
            lp = torch.log_softmax(logits, dim=-1)
            err = torch.where(torch.isfinite(lp), lp - ld, 0.0).abs().max().item()
            same = (logits.argmax(-1) == direct.argmax(-1))[:, 0].tolist()
        check(err < SSM_TOL, f"{name}: chunked against recurrent |d log-softmax| {err} >= "
              f"{SSM_TOL}")
        check((decode_fn.captures, decode_fn.graphs, decode_fn.replays)
              == (1, int(dev.type == "cuda"), SSM_PROMPT - 1),
              f"{name}: {decode_fn.captures} captures, {decode_fn.graphs} graphs, "
              f"{decode_fn.replays} replays over {SSM_PROMPT} recurrent steps")
        out[name] = dict(err=err, same=same)
        chunk = (cfg.block_cfg if spec.kind == "mamba_lm" else cfg.mamba_cfg).chunk
        print(f"[ssm] 16(b) {name} full width and depth ({n_params} params, float32), B = "
              f"{SSM_BATCH}, {SSM_PROMPT} tokens ({-(-SSM_PROMPT // chunk)} SSD chunks of "
              f"{chunk}, the last padded): chunked hidden_states {1e3 * (t2 - t1):.1f} "
              f"ms against {SSM_PROMPT} recurrent steps through the launcher's captured decode "
              f"{1e3 * (t3 - t2):.1f} ms (1 capture, {decode_fn.replays} replays, "
              f"{decode_fn.copy_bytes} state bytes copied in): last position |d log-softmax| "
              f"{err:.3e} (< {SSM_TOL}), argmax equal {same}; {time.perf_counter() - t0:.1f} s "
              f"[{card}]")
        del params, x, state, prefill_fn, decode_fn
        torch.cuda.empty_cache()
    return out


def whisper_consistency(spec, dev, card) -> dict:
    """16(b): whisper-small at full width and depth in float32: a greedy
    decode of WHISPER_TOKENS tokens from ``encode`` over WHISPER_BATCH x
    WHISPER_FRAMES frames, against ``decode_train`` on the tokens it fed:
    |d log-softmax| < SSM_TOL at every step, and the same argmax wherever
    ``decode_train``'s top-1 leads its runner-up by more than twice that."""
    from repro_torch.models import encdec as ED
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(spec.cfg(), dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(6)
    t0 = time.perf_counter()
    params, _ = spec.init(gen, device=dev)
    frames = torch.randn((WHISPER_BATCH, WHISPER_FRAMES, cfg.d_model), generator=gen, device=dev)
    B = WHISPER_BATCH
    with torch.inference_mode():
        enc = ED.encode(params, cfg, frames)
        cache = ED.init_dec_cache(params, cfg, enc, max_len=WHISPER_TOKENS)
        tok = torch.full((B, 1), WHISPER_START, dtype=torch.int32, device=dev)
        fed, steps = [], []
        for t in range(WHISPER_TOKENS):
            fed.append(tok)
            pos = torch.full((B, 1), t, dtype=torch.int32, device=dev)
            logits, cache = ED.decode_step(params, cfg, tok, cache, pos)
            steps.append(logits)
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        fed = torch.cat(fed, dim=1)
        lp = torch.log_softmax(torch.cat(steps, dim=1), dim=-1)
        x = ED.decode_train(params, cfg, fed, enc)
        ld = torch.log_softmax(L.unembed_logits(params["embed"], x, true_vocab=cfg.vocab), dim=-1)
        err = torch.where(torch.isfinite(lp), lp - ld, 0.0).abs().max().item()
        top2 = ld.topk(2, dim=-1).values
        decisive = (top2[..., 0] - top2[..., 1]) > 2 * SSM_TOL
        same = lp.argmax(-1) == ld.argmax(-1)
        held = int(decisive.sum())
        agree = bool((same | ~decisive).all())
    check(err < SSM_TOL, f"whisper-small: decode against decode_train |d log-softmax| {err}")
    check(agree, "whisper-small: a greedy pick differs from decode_train's on a decisive step")
    print(f"[ssm] 16(b) whisper-small full width and depth (float32), B = {B} x "
          f"{WHISPER_FRAMES} frames: greedy decode of {WHISPER_TOKENS} tokens from encode "
          f"against decode_train on the same tokens: |d log-softmax| {err:.3e} (< {SSM_TOL}); "
          f"argmax equal on {int(same.sum())} of {same.numel()} steps ({held} decisive, all "
          f"equal); {time.perf_counter() - t0:.1f} s [{card}]")
    del params, enc, cache, x
    torch.cuda.empty_cache()
    return dict(err=err, same=int(same.sum()))


def serve_modes(spec, cfg, served, prompts, max_len, dev) -> dict:
    """``ServeEngine`` over the launcher's functions, once with an eager
    decode and once with the captured one, on the same prompts: tokens,
    logits, prefill ms per batch and decode ms per step (CUDA events
    around each engine call), wall seconds (host clock), peak memory and
    the capture's counts."""
    from repro_torch.launch.serve import serve_fns
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    runs = {}
    for mode in ("eager", "captured"):
        prefill_fn, decode_fn = serve_fns(spec, cfg, max_len, dev, capture=mode == "captured")
        timings = {"prefill": [], "decode": []}
        seen = []

        def timed(kind, fn):
            def call(*args):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                logits, state = fn(*args)
                end.record()
                timings[kind].append((start, end))
                seen.append(logits)
                return logits, state
            return call

        engine = ServeEngine(served, timed("prefill", prefill_fn), timed("decode", decode_fn),
                             EngineConfig(max_batch=LM_MAX_BATCH), device=dev)
        for rid, pr in enumerate(prompts):
            engine.submit(Request(rid=rid, prompt=pr.astype(np.int32), max_new=LM_MAX_NEW))
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(len(done) == len(prompts) and all(len(r.out) == LM_MAX_NEW for r in done),
              f"{cfg.name} {mode}: {[len(r.out) for r in done]} tokens per request")
        check(all(0 <= t < cfg.vocab for r in done for t in r.out),
              f"{cfg.name} {mode}: token off vocab")
        runs[mode] = dict(
            tokens=[r.out for r in done], logits=seen, wall=wall,
            n_tokens=sum(len(r.out) for r in done),
            peak=torch.cuda.max_memory_allocated() - base,
            prefill_ms=[s.elapsed_time(e) for s, e in timings["prefill"]],
            decode_ms=float(np.median([s.elapsed_time(e) for s, e in timings["decode"]])),
            n_decode=len(timings["decode"]),
            captures=getattr(decode_fn, "captures", 0), graphs=getattr(decode_fn, "graphs", 0),
            replays=getattr(decode_fn, "replays", 0), copy_bytes=getattr(decode_fn, "copy_bytes", 0))
        del engine, prefill_fn, decode_fn
        torch.cuda.empty_cache()
    eager, cap = runs["eager"], runs["captured"]
    check(eager["tokens"] == cap["tokens"], f"{cfg.name}: captured decode picks other tokens "
          f"than eager")
    # every logit finite (the -1e30 past the true vocab is the reference's mask)
    check(all(bool(torch.isfinite(t).all()) for m in runs.values() for t in m["logits"]),
          f"{cfg.name}: non-finite logits")
    # the replay runs the eager step's kernels in its order: the same bits
    check(len(eager["logits"]) == len(cap["logits"]) and all(
        torch.equal(a, b) for a, b in zip(eager["logits"], cap["logits"])),
        f"{cfg.name}: captured logits differ from eager")
    return runs


def decode_profile(name, step, params, state, dev, card) -> dict:
    """One decode step of ``step`` at batch LM_MAX_BATCH on ``state``
    (written in place: its values only feed the timing), eager and through
    ``CapturedDecode``: the host's enqueue ms a step (host clock over
    PROFILE_STEPS eager steps, no sync inside), and under
    ``torch.profiler`` the kernels a step, the device-busy ms a step (the
    kernels' summed time) and the span from the first kernel's start to
    the last one's end, a step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import CapturedDecode

    tok = torch.zeros((LM_MAX_BATCH, 1), dtype=torch.int32, device=dev)
    pos = torch.full((LM_MAX_BATCH, 1), 16, dtype=torch.int32, device=dev)
    captured = CapturedDecode(step)
    out = {}
    with torch.inference_mode():
        _, own = captured(params, state, tok, pos)
        step(params, state, tok, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step(params, state, tok, pos)
        out["host_ms"] = 1e3 * (time.perf_counter() - t0) / PROFILE_STEPS
        torch.cuda.synchronize()
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        for mode, fn in (("eager", lambda: step(params, state, tok, pos)),
                         ("replay", lambda: captured(params, own, tok, pos))):
            with profile(activities=activities) as prof:
                for _ in range(PROFILE_STEPS):
                    fn()
                torch.cuda.synchronize()
            kern = [e for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
            busy = sum(e.device_time_total for e in kern) / 1e3
            span = (max(e.time_range.end for e in kern) - min(e.time_range.start for e in kern)
                    ) / 1e3 if kern else 0.0
            out[mode] = (len(kern) / PROFILE_STEPS, busy / PROFILE_STEPS, span / PROFILE_STEPS)
    (ek, eb, es), (rk, rb, rs) = out["eager"], out["replay"]
    print(f"[ssm] 16(c) {name} one decode step under torch.profiler ({PROFILE_STEPS} steps): "
          f"eager host enqueue {out['host_ms']:.3f} ms a step, {ek:.0f} kernels, device busy "
          f"{eb:.3f} ms over a span of {es:.3f}; replayed {rk:.0f} kernels, device busy "
          f"{rb:.3f} ms over a span of {rs:.3f} ({100 * rb / max(rs, 1e-9):.0f}% busy) [{card}]")
    del captured, own
    return out


def print_serving(spec, cfg, runs, n_params, weight_bytes, bound, init_s, card):
    eager, cap = runs["eager"], runs["captured"]
    name = spec.name
    print(f"[ssm] 16(c) {name} full width and depth ({spec.kind}): {n_params} params drawn on "
          f"the card, served in {cfg.dtype} ({weight_bytes} weight bytes; init and cast "
          f"{init_s:.1f} s); {len(eager['tokens'])} requests x {LM_SERVE_PROMPT} prompt "
          f"tokens, {LM_MAX_NEW} new, B = {LM_MAX_BATCH} [{card}]")
    for mode, m in (("eager", eager), ("captured", cap)):
        print(f"[ssm] 16(c) {name} {mode}: prefill ms per batch (CUDA events) "
              f"{', '.join(f'{ms:.3f}' for ms in m['prefill_ms'])}; decode ms per step "
              f"{m['decode_ms']:.3f} (median of {m['n_decode']}); {m['n_tokens']} tokens in "
              f"{m['wall']:.3f} s, {m['n_tokens'] / m['wall']:.1f} tokens/s (host clock); "
              f"captures {m['captures']}, graphs {m['graphs']}, replays {m['replays']}, state "
              f"bytes copied in {m['copy_bytes']}; peak memory {m['peak']} bytes over the "
              f"weights (max_memory_allocated) [{card}]")
    print(f"[ssm] 16(c) {name}: captured and eager give the same tokens and logits equal bit "
          f"for bit ({len(cap['logits'])} calls); decode bound {bound['ms']:.3f} ms a step "
          f"({bound['what']}, at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); captured decode "
          f"{cap['decode_ms'] / bound['ms']:.2f}x the bound, eager {eager['decode_ms'] / bound['ms']:.2f}x "
          f"[{card}]")


def ssm_serve(spec, seed, dev, card) -> dict:
    """16(c) for a recurrent arch at full width and depth in bf16: served
    through ``ServeEngine`` with the launcher's functions, eager and
    captured, on the same SSM_SERVE_REQUESTS prompts."""
    from repro_torch.launch.serve import serve_fns
    from repro_torch.models import hybrid as HY
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as TT

    cfg = spec.cfg()
    t0 = time.perf_counter()
    params, _ = spec.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    n_params = sum(t.numel() for _, t in TT.leaf_paths(params))
    served = SSM.serving_params(params, cfg)
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = tree_bytes(served)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, LM_SERVE_PROMPT) for _ in range(SSM_SERVE_REQUESTS)]
    max_len = LM_SERVE_PROMPT + LM_MAX_NEW
    runs = serve_modes(spec, cfg, served, prompts, max_len, dev)
    # a step reads every weight once (the shared block once a call when it
    # does not stay in L2), reads the whole state and writes the recurrent
    # part of it
    if spec.kind == "hybrid":
        state = HY.init_state(cfg, LM_MAX_BATCH, max_len, device="meta")
        reread = (cfg.n_shared_calls - 1) * tree_bytes(served["shared"])
        written = tree_bytes(state["ssm"])
    else:
        state = SSM.init_mamba2_lm_state(cfg, LM_MAX_BATCH, device="meta")
        reread, written = 0, tree_bytes(state)
    read = tree_bytes(state)
    ms = (weight_bytes + reread + read + written) / HBM_BYTES_PER_S * 1e3
    what = (f"weights {weight_bytes} + shared block re-read {reread} + state read {read} + "
            f"written {written} bytes")
    print_serving(spec, cfg, runs, n_params, weight_bytes, dict(ms=ms, what=what),
                  init_s, card)
    _, step = serve_fns(spec, cfg, max_len, dev, capture=False)
    state = (HY.init_state(cfg, LM_MAX_BATCH, max_len, device=dev) if spec.kind == "hybrid"
             else SSM.init_mamba2_lm_state(cfg, LM_MAX_BATCH, device=dev))
    decode_profile(spec.name, step, served, state, dev, card)
    del served, state
    torch.cuda.empty_cache()
    return dict(eager_ms=runs["eager"]["decode_ms"], captured_ms=runs["captured"]["decode_ms"],
                bound_ms=ms)


def lm_capture(spec, dev, card) -> dict:
    """16(c) for olmoe-1b-7b (phase 15's weights and first batch): the
    launcher's captured decode against its eager one."""
    from repro_torch.launch.serve import serve_fns
    from repro_torch.models import transformer as TT

    cfg = spec.cfg()
    t0 = time.perf_counter()
    params, _ = TT.init_lm(torch.Generator(device=dev).manual_seed(3), cfg, device=dev)
    n_params = sum(t.numel() for _, t in TT.leaf_paths(params))
    served = TT.serving_params(params, cfg)
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = tree_bytes(served)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, LM_SERVE_PROMPT) for _ in range(LM_MAX_BATCH)]
    max_len = LM_SERVE_PROMPT + LM_MAX_NEW
    runs = serve_modes(spec, cfg, served, prompts, max_len, dev)
    cache = TT.init_cache(cfg, LM_MAX_BATCH, max_len, device="meta")
    ms = (weight_bytes + tree_bytes(cache)) / HBM_BYTES_PER_S * 1e3
    what = f"weights {weight_bytes} + cache read {tree_bytes(cache)} bytes"
    print_serving(spec, cfg, runs, n_params, weight_bytes, dict(ms=ms, what=what),
                  init_s, card)
    prefill_fn, step = serve_fns(spec, cfg, max_len, dev, capture=False)
    with torch.inference_mode():
        _, state = prefill_fn(served, torch.zeros((LM_MAX_BATCH, 16), dtype=torch.int32,
                                                  device=dev))
    decode_profile(spec.name, step, served, state, dev, card)
    del served, state
    torch.cuda.empty_cache()
    return dict(eager_ms=runs["eager"]["decode_ms"], captured_ms=runs["captured"]["decode_ms"],
                bound_ms=ms)


def whisper_serve(spec, dev, card) -> dict:
    """16(c) for whisper-small in bf16: WHISPER_TOKENS greedy decode steps
    from one encode over WHISPER_BATCH x WHISPER_FRAMES frames, eager and
    through ``CapturedDecode``: the same tokens, ms per step."""
    from repro_torch.models import encdec as ED
    from repro_torch.serve.engine import CapturedDecode

    cfg = spec.cfg()
    gen = torch.Generator(device=dev).manual_seed(8)
    params, _ = spec.init(gen, device=dev)
    served = ED.serving_params(params, cfg)
    del params
    frames = torch.randn((WHISPER_BATCH, WHISPER_FRAMES, cfg.d_model), generator=gen, device=dev)

    def step(p, s, t, pos):
        return ED.decode_step(p, cfg, t, s, pos)

    out = {}
    with torch.inference_mode():
        enc = ED.encode(served, cfg, frames)
        for mode in ("eager", "captured"):
            fn = CapturedDecode(step) if mode == "captured" else step
            cache = ED.init_dec_cache(served, cfg, enc, max_len=WHISPER_TOKENS)
            tok = torch.full((WHISPER_BATCH, 1), WHISPER_START, dtype=torch.int32, device=dev)
            picked, ms = [], []
            for t in range(WHISPER_TOKENS):
                pos = torch.full((WHISPER_BATCH, 1), t, dtype=torch.int32, device=dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                logits, cache = fn(served, cache, tok, pos)
                end.record()
                tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
                picked.append(tok)
                ms.append((start, end))
            torch.cuda.synchronize()
            out[mode] = dict(tokens=torch.cat(picked, dim=1).cpu(),
                             ms=float(np.median([s.elapsed_time(e) for s, e in ms[1:]])))
        xkv = tree_bytes({"xk": cache["xk"], "xv": cache["xv"]})
    decode_profile(spec.name, step, served, cache, dev, card)
    check(torch.equal(out["eager"]["tokens"], out["captured"]["tokens"]),
          "whisper-small: captured decode picks other tokens than eager")
    dec = tree_bytes({k: served[k] for k in ("dec", "ln_dec", "embed")})
    ms = (dec + xkv) / HBM_BYTES_PER_S * 1e3
    print(f"[ssm] 16(c) whisper-small ({cfg.dtype}), B = {WHISPER_BATCH} x {WHISPER_FRAMES} "
          f"frames, {WHISPER_TOKENS} greedy steps: decode ms per step eager "
          f"{out['eager']['ms']:.3f}, captured {out['captured']['ms']:.3f} (median, CUDA events), "
          f"the same tokens; bound {ms:.3f} ms a step (decoder and unembed weights {dec} + "
          f"cross K/V {xkv} bytes) [{card}]")
    del served, enc, cache
    torch.cuda.empty_cache()
    return dict(eager_ms=out["eager"]["ms"], captured_ms=out["captured"]["ms"], bound_ms=ms)


def ssm_drive(dev, card: str) -> dict:
    """Phase 16: the SSM, hybrid and encoder-decoder families, and the
    launcher's captured decode (no SCV kernel on the path)."""
    from repro_torch.configs import ARCHS
    kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")

    t0 = time.perf_counter()
    kmod.reset_counts()
    worst = ssm_card_vs_cpu(ARCHS, dev)
    consistency = ssm_consistency(ARCHS, dev, card)
    whisper = whisper_consistency(ARCHS["whisper-small"], dev, card)
    serving = {name: ssm_serve(ARCHS[name], seed, dev, card)
               for seed, name in enumerate(SSM_SERVE_ARCHS, start=9)}
    serving["olmoe-1b-7b"] = lm_capture(ARCHS["olmoe-1b-7b"], dev, card)
    serving["whisper-small"] = whisper_serve(ARCHS["whisper-small"], dev, card)
    launches = (kmod.launches, kmod.scalar_launches)
    check(launches == (0, 0), f"phase 16 launched SCV kernels: {launches}")
    seconds = time.perf_counter() - t0
    print(f"[ssm] phase 16: {seconds:.1f} s; SCV kernel launches: 0 (ssm.py, hybrid.py and "
          f"encdec.py reach no pl.pallas_call)")
    return dict(worst=worst, consistency=consistency, whisper=whisper, serving=serving,
                seconds=seconds)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.configs import gcn_paper
    from repro_torch.core import scv
    from repro_torch.kernels.scv_spmm import ref
    kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")
    from repro_torch.kernels.scv_spmm.build import load_library
    from repro_torch.kernels.scv_spmm.ops import cached_backward, chain_launches, scv_spmm_plan
    from repro_torch.launch.graph_serve import (
        build_default_engine, default_pool, make_requests, poisson_arrivals,
        run_open_loop,
    )
    from repro_torch.core.scv import coo_to_scv_tiles, dense_tile_threshold, plan_from_tiles
    from repro_torch.models.gnn import build_graph, gnn_forward, gnn_loss, init_gnn
    from repro_torch.serve.graph_engine import plan_launches
    from repro_torch.simul.datasets import TABLE_I, gcn_normalize, powerlaw_edges
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
    print("[build] vector-body blocks an SM holds (T, F, dense branch): " + ", ".join(
        f"({t}, {f}, {'on' if d else 'off'}) {kmod.blocks_per_sm(t, f, d)}"
        for t, f, d in ((64, 128, False), (64, 128, True), (64, 40, True), (128, 128, False),
                        (128, 128, True))))

    # -- inputs: one serving composite and the arxiv-scale graph -----------
    cfg = gcn_paper.full
    layout = TunedConfig()
    pool = default_pool()
    engine_kw = dict(model=cfg, device=dev, seed=0)
    warm, first, comp = warm_up_composite(engine_kw, pool, cfg.d_in)
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
    arxiv_adj = arxiv_adjacency()
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
    rows, first_rows = {}, {}
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
            print(f"[time] {name} F={f}: chain of {len(g.plan.segments)} segments in "
                  f"{launches} launch {ms:.4f} ms ({before((name, f))}), "
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
                extra = ""
                if seeding:  # the first-segment launch: its own plain and library times
                    seg_plain = device_ms(lambda s=s: ref.scv_spmm_reference(
                        s.tile_row, s.tile_col, s.rows, s.cols, s.vals, z, tile=s.tile,
                        n_rows=out.shape[0], nnz_in_tile=s.nnz_in_tile), 3 if big else 20)
                    seg_csr = csr_of(segment_entries(s), (out.shape[0], g.plan.shape[1]), dev)
                    seg_lib = device_ms(lambda: torch.sparse.mm(seg_csr, z), 10 if big else 50)
                    extra = f", plain {seg_plain:.4f} ms, torch.sparse.mm (CSR) {seg_lib:.4f} ms"
                    first_rows[(name, f)] = dict(ms=seg_ms, plain_ms=seg_plain,
                                                 library_ms=seg_lib, bound_ms=seg_bound,
                                                 bound_by="bytes")
                    del seg_csr
                print(f"[time]   segment {j} cap {s.cap}: {s.n_tiles} tiles, "
                      f"{s.runs.n_runs} runs, nnz {int(run_nnz.sum())}, "
                      f"longest run {int(np.diff(ptr).max())} tiles / "
                      f"{int(run_nnz.max())} nnz, {s.runs.n_units} units "
                      f"({s.runs.n_split_units} in split runs, heaviest "
                      f"{s.runs.max_unit_work} work), accumulate={acc}: "
                      f"{seg_ms:.4f} ms, bound {seg_bound:.4f} ms{extra}")
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
    # where the time of a launch goes: the cap-32 segment alone (a later
    # segment's launch of the earlier design), and the chain in one launch
    cap32 = next(s for s in arxiv.plan.segments if s.cap == 32)
    launch_floor("arxiv cap-32 segment", (cap32,), cfg.d_hidden, gen, dev)
    launch_floor("arxiv chain", arxiv.plan.segments, cfg.d_hidden, gen, dev)

    # -- 4. serving --------------------------------------------------------------
    def plain_forward(params, g, x):
        """GCN forward with the plain aggregation, on the card."""
        return plain_gcn_forward(params, cfg, g, x)

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
    serve_gps = SERVE_REQUESTS / wall
    serve_launches, serve_chain = kmod.launches, kmod.chain_launches
    m = engine.metrics()
    check(serve_launches > 0, "the serving drive launched no kernel")
    check(serve_launches == m["launches"],
          f"kernel launches {serve_launches} != engine launches {m['launches']}")
    worst = check_outputs(engine, reqs, "burst")
    print(f"[serve] burst of {SERVE_REQUESTS} through run(): {m['waves']} waves, "
          f"{SERVE_REQUESTS / wall:.1f} graphs/s, {latency_line(reqs)}, "
          f"plan builds {m['plan_build_seconds']:.3f} s of {wall:.3f} s, "
          f"{m['forward_captures']} forward keys, {m['forward_graphs']} captured after the "
          f"last wave in {m['forward_capture_seconds']:.3f} s, "
          f"kernel launches {serve_launches} ({serve_chain} over more than one segment) "
          f"= engine launches {m['launches']}, worst rel err {worst:.2e}")

    rate = SERVE_RATE
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
          f"{m2['forward_captures']} forward keys, {m2['forward_graphs']} captured while idle "
          f"in {m2['forward_capture_seconds']:.3f} s, {m2['forward_replays']} replays, "
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
    for name, plan in scalar_plans.items():
        ri = plan.runs
        print(f"[scalar] {name}: {plan.n_tiles} tiles, {ri.n_runs} runs, {ri.n_units} work "
              f"units ({ri.n_split_units} in split runs), heaviest unit {ri.max_unit_work} work")

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
    # two scalar-body launches on the same real-valued inputs: the same bits
    # (split runs summed in unit order), every split run's counter back at 0
    for name, plan in scalar_plans.items():
        z = torch.randn((plan.shape[1], cfg.d_hidden), generator=gen).to(dev)
        first_sc = scv_spmm_plan(plan, z, body="scalar")
        second_sc = scv_spmm_plan(plan, z, body="scalar")
        torch.cuda.synchronize()
        check(torch.equal(first_sc, second_sc), f"scalar body {name}: two launches differ")
        check(not any(bool(c.any()) for c in plan.runs._counters.values()),
              f"scalar body {name}: a split run's counter was left set")
        print(f"[determinism] scalar body {name} F={cfg.d_hidden} twice: identical bits "
              f"({plan.runs.n_split_units} units in split runs), counters back at 0")
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
                                         bound_ms=bound_ms, bound_by=bound_by,
                                         gather_ms=gather_ms)
            print(f"[time] dense-block {name} F={f}: chain of {len(plan.segments)} segments in "
                  f"{plan_launches(plan)} launch {ms:.4f} ms ({before((name, f))}), dense branch "
                  f"off {gather_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), plain "
                  f"{plain_ms:.4f} ms, torch.sparse.mm (CSR) {lib_ms:.4f} ms")
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
        # where the dense branch starts to pay on this card: measured only
        z = torch.randn((plan.shape[1], cfg.d_hidden), generator=gen).to(dev)
        nnz = np.concatenate([s.nnz_in_tile.cpu().numpy() for s in plan.segments])
        scale = (plan.tile // 64) ** 2
        sweep = [f"{thr}: {device_ms(lambda: scv_spmm_plan(plan, z, dense_threshold=thr), 5):.4f}"
                 f" ms ({int((nnz > thr).sum())} dense)"
                 for thr in (scale * t for t in DENSE_THRESHOLD_SWEEP)]
        print(f"[sweep] dense-block {name} F={cfg.d_hidden} chain by dense_threshold "
              f"(default {dense_tile_threshold(plan.tile)}; branch off "
              f"{dense_rows[(name, cfg.d_hidden)]['gather_ms']:.4f} ms): " + "; ".join(sweep))
    scalar_rows = {}
    kept_rule = kmod.threads_for
    for name, plan in scalar_plans.items():
        entries = plan_entries(plan)
        csr = csr_of(entries, (plan.padded_shape[0], plan.shape[1]), dev)
        for f in (cfg.d_hidden, cfg.n_classes):
            z = torch.randn((plan.shape[1], f), generator=gen).to(dev)
            ms = device_ms(lambda: scv_spmm_plan(plan, z, body="scalar"), 20)
            # the thread rule the scalar body does not keep: measured only
            kmod.threads_for = threads_within_default_smem(kmod)
            try:
                other = kmod.threads_for(f, plan.tile, "scalar")
                other_out = scv_spmm_plan(plan, z, body="scalar")
                other_ms = device_ms(lambda: scv_spmm_plan(plan, z, body="scalar"), 20)
            finally:
                kmod.threads_for = kept_rule
            check(torch.equal(other_out, scv_spmm_plan(plan, z, body="scalar")),
                  f"scalar body {name} F={f}: the thread rules give other bits")
            vec_ms = device_ms(lambda: scv_spmm_plan(plan, z), 20)
            plain_ms = device_ms(lambda: ref.scv_spmm_reference_plan(plan, z, body="scalar"), 5)
            lib_ms = device_ms(lambda: torch.sparse.mm(csr, z), 20)
            bound_ms, bound_by = chain_bounds(plan, entries, f)
            scalar_rows[(name, f)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                          bound_ms=bound_ms, bound_by=bound_by)
            print(f"[time] scalar body {name} F={f}: {ms:.4f} ms "
                  f"({kept_rule(f, plan.tile, 'scalar')} threads; within 48 KB, {other} "
                  f"threads: {other_ms:.4f} ms), vector body on the same plan {vec_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
                  f"torch.sparse.mm (CSR) {lib_ms:.4f} ms")
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
        """Step 0, twice on the same inputs: the kernels' gradients (the
        backward's dZ is the kernel chain over the transposed plan) must
        give the same bits both times, and agree with plain autograd
        through the plain version; returns params, their flat list, loss,
        grads."""
        params = init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
        names = [f"{layer}.{k}" for layer, ps in params.items() for k in ps]
        flat = [p.requires_grad_(True) for ps in params.values() for p in ps.values()]
        ones = torch.ones(g.n_nodes, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = gnn_loss(params, cfg, g, x, labels, ones)
        grads = torch.autograd.grad(loss, flat)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        again = torch.autograd.grad(gnn_loss(params, cfg, g, x, labels, ones), flat)
        check(all(torch.equal(a, b) for a, b in zip(grads, again)),
              f"{label}: two backwards on the same inputs differ")
        want = torch.autograd.grad(plain_loss(params, g, x, labels), flat)
        errs = {}
        for name, a, b in zip(names, grads, want):
            err, scale = rel_err(a, b)
            check(err <= 1e-4 * scale, f"{label} grad {name}: max err {err} > 1e-4 * {scale}")
            errs[name] = err / scale
        print(f"[train] {label} step-0 gradients vs plain autograd, max err / max |grad|: "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; two backwards equal bit for bit; the first step (transposed plan built) "
              f"{first_s:.2f} s")
        return params, flat, loss, grads

    def backward_chain(g, n_feat, label) -> None:
        """The backward's dZ chain alone (the transposed plan, the forward's
        values gathered into it) at F = ``n_feat``, against its bound and
        the plain backward it replaced (``index_add_`` over the live
        entries, found by ``nonzero()``; measured only)."""
        bw = cached_backward(g.plan)
        check(bw is not None, f"{label}: the backward built no transposed plan")
        segs = getattr(g.plan, "segments", (g.plan,))
        plan_t = bw.plan_t.reweighted(torch.cat([s.vals.reshape(-1) for s in segs]))
        z = torch.randn((g.plan.shape[1], n_feat), generator=gen).to(dev)
        cot = torch.randn((g.plan.padded_shape[0], n_feat), generator=gen).to(dev)

        def plain_dz():
            dz = torch.zeros_like(z)
            for seg in segs:
                slot = torch.arange(seg.cap, device=dev)
                t, sl = (slot[None, :] < seg.nnz_in_tile[:, None]).nonzero(as_tuple=True)
                grow = seg.tile_row.long()[t] * seg.tile + seg.rows[t, sl].long()
                gcol = seg.tile_col.long()[t] * seg.tile + seg.cols[t, sl].long()
                dz.index_add_(0, gcol, cot[grow] * seg.vals[t, sl][:, None])
            return dz

        got = scv_spmm_plan(plan_t, cot)[: z.shape[0]]
        err, scale = rel_err(got, plain_dz())
        check(err <= 1e-5 * scale, f"{label}: backward chain off the plain dZ by {err}")
        ms = device_ms(lambda: scv_spmm_plan(plan_t, cot), 10)
        plain_ms = device_ms(plain_dz, 5)
        entries_t = plan_entries(plan_t)
        bound_ms, bound_by = chain_bounds(plan_t, entries_t, n_feat)
        csr_t = csr_of(entries_t, (plan_t.padded_shape[0], plan_t.shape[1]), dev)
        lib_ms = device_ms(lambda: torch.sparse.mm(csr_t, cot[: plan_t.shape[1]]), 10)
        del csr_t
        print(f"[train] {label} backward dZ chain F={n_feat} over the transposed plan "
              f"(tiles {[s.n_tiles for s in getattr(plan_t, 'segments', (plan_t,))]}, "
              f"dense tiles {dense_counts(plan_t)}): {ms:.4f} ms ({before(('dZ', label))}), "
              f"bound {bound_ms:.4f} ms ({bound_by}), torch.sparse.mm (CSR of the "
              f"transpose) {lib_ms:.4f} ms, plain backward (index_add_) {plain_ms:.4f} ms; max "
              f"err vs plain {err:.3e} (max |plain| {scale:.3e})")

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
    plan_t8 = cached_backward(mixed.plan).plan_t
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
    forwards = 4 + 2 + TRAIN_STEPS  # timed forwards, step 0 twice, the SGD steps
    backwards = 2 + TRAIN_STEPS  # each layer's dZ: one chain over the transposed plan
    # one launch a chain: dense when a segment of it holds a dense tile
    n_dense_segs = expected_dense(mixed.plan)
    n_dense_segs_t = expected_dense(plan_t8)
    check(train_launches == cfg.n_layers * (forwards * plan_launches(mixed.plan)
                                            + backwards * plan_launches(plan_t8)),
          f"dense-block drive launched {train_launches} kernels")
    check(train_dense == cfg.n_layers * (forwards * n_dense_segs
                                         + backwards * n_dense_segs_t) > 0,
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
          f"per step (host clock: forward, backward, update; {STEP_MS_BEFORE} ms with the "
          f"index_add_ backward), loss "
          + " ".join(f"{v:.4f}" for v in losses[:: max(1, TRAIN_STEPS // 5)])
          + f" -> {losses[-1]:.4f}; {train_launches} kernel launches over {forwards} "
          f"forwards and {backwards} backwards, {train_dense} of them with dense tiles")
    backward_chain(mixed, cfg.d_hidden, mixed_name)

    arxiv_labels = torch.from_numpy(
        np.random.default_rng(7).integers(0, cfg.n_classes, spec.nodes)).to(dev)
    grad_check(arxiv, x, arxiv_labels, "arxiv")
    backward_chain(arxiv, cfg.d_hidden, "arxiv")
    torch.cuda.synchronize()

    # -- 9. the scalar body through the public op ------------------------------
    sc_name, sc_plan = next(iter(scalar_plans.items()))
    z = torch.randn((sc_plan.shape[1], cfg.d_hidden), generator=gen).to(dev)
    kmod.reset_counts()
    out_sc = scv_spmm_plan(sc_plan, z, body="scalar")
    torch.cuda.synchronize()
    scalar_launches = kmod.scalar_launches
    check(scalar_launches == chain_launches(sc_plan, "scalar") and kmod.launches == 0,
          f"scalar drive launched {scalar_launches} scalar, {kmod.launches} vector kernels")
    err, scale = rel_err(out_sc, ref.scv_spmm_reference_plan(sc_plan, z, body="scalar"))
    check(err <= 1e-5 * scale, f"scalar drive off the plain version: {err}")
    print(f"[scalar] {sc_name} F={cfg.d_hidden} through scv_spmm_plan(body='scalar'): "
          f"{scalar_launches} launch, max abs err {err:.3e}")

    # -- 10. streaming deltas on the arxiv-scale plan --------------------------
    stream = stream_drive(arxiv_adj, layout, dev, cfg.d_hidden, gen)
    torch.cuda.synchronize()

    # -- 11. tracked-graph serving ---------------------------------------------
    tracked = tracked_serving(arxiv_adj, cfg, layout, dev)
    torch.cuda.synchronize()

    # -- 12. the sharding executor ------------------------------------------------
    shard = shard_drive(arxiv, cfg, layout, dev, gen)
    sync_all(dev)

    # -- 13. the autotuner on the card ---------------------------------------------
    tune = tune_drive(arxiv_adj, arxiv, cfg, x, fwd_ms, pool, serve_gps, check_outputs, dev,
                      gen)
    torch.cuda.synchronize()
    print(f"[paths] kernel launches: stream drive {stream['launches']} "
          f"({stream['dense_launches']} dense), tracked serving {tracked['launches']}, "
          f"sharding executor {shard['launches']}, tuner, tuned forward and tuned "
          f"serving {tune['launches']}")

    # -- 14. aggregation backends and the captured forward ----------------------
    t14 = time.perf_counter()
    backends = backends_drive(arxiv_adj, arxiv, dense_adj, cfg.d_hidden, dev, smi)
    captured = capture_drive(arxiv, cfg, pool, layout, check_outputs, dev, smi)
    print(f"[capture] phase 14: {time.perf_counter() - t14:.1f} s (backends "
          f"{backends['seconds']:.1f} s, captured forward {captured['seconds']:.1f} s)")

    # -- 15. the decoder-LM path ------------------------------------------------
    lm_drive(dev, smi)

    # -- 16. the SSM, hybrid and encoder-decoder families; captured decode ---------
    ssm_drive(dev, smi)

    # -- 17. the training stack -----------------------------------------------------
    train_drive(dev, smi)

    # -- 18. sharding rules, meshes, compression, the dry run -------------------------
    mesh_drive(dev, smi)

    def timed(row):
        return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}

    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        # row 1: the sparse branch, timed as the first segment's launch alone
        {"name": "scv_spmm_runs", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES, "launches": serve_launches, "max_abs_err": max_abs_err,
         **timed(first_rows[("serving composite", cfg.d_hidden)])},
        # row 2: the accumulate mode, now a bucketed plan's chain in one launch
        {"name": "scv_spmm_chain (all segments in one launch)", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": REPLACES_CHAIN, "launches": serve_chain,
         "max_abs_err": max_abs_err, **timed(rows[("serving composite", cfg.d_hidden)])},
        {"name": "scv_spmm_runs dense-tile branch (3xTF32 mma)", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": REPLACES_DENSE, "launches": train_dense,
         "max_abs_err": err_dense, **timed(dense_rows[(f"{mixed_name} T=64", cfg.d_hidden)])},
        {"name": "scv_spmm_runs_scalar", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES_SCALAR, "launches": scalar_launches,
         "max_abs_err": err_scalar, **timed(scalar_rows[(sc_name, cfg.d_hidden)])},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
