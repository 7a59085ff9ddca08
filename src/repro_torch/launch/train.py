"""End-to-end training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch <id> [--reduced] \
        --steps 200 --batch 8 --seq 128 --ckpt-dir <dir> [--resume] \
        [--mesh none|prod|prod-multipod] --device cuda

Port of ``src/repro/launch/train.py``: the same flags, prints and return
value (the list of losses).  The loop wires together the substrate: the
seeded data pipeline, the step of ``ArchSpec.make_train_step`` (autograd
with the reference's remat points, then Adam), atomic checkpoints,
deterministic resume and straggler logging.  Weights come from seed 0
through the port's own init.  The step runs eagerly (the reference jits
it).  ``--device`` picks where it runs (default ``cuda``; it raises when no
GPU is present).  ``--mesh prod`` (16x16) and ``prod-multipod`` (2x16x16)
lay the production mesh over the pool of ``--device`` (every card for
``cuda``), place the params and the Adam state by ``train/sharding.py``'s
rules (each mesh position holds its own shards, on its device), print each
position's bytes, and run the loop under the mesh: the step runs SPMD over
it (``configs/common.py::spmd_step``): each data group splits its
products over the 16 "model" positions (``train/tp.py``; the ``[mesh]``
line says how for the arch) and the gradients are reduce-scattered from
the devices that summed them.  The losses are ``--mesh none``'s within
float32 rounding; on a mesh whose "model" axis is 1, a batch that splits
into one data group gives them bit for bit.  Checkpoints hold the whole
leaves; ``--resume`` places what it restores by the same shardings.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import time

import torch

from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import (
    TokenPipelineConfig, audio_batch, to_device, token_batch, vlm_batch,
)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import device_pool, make_production_mesh
from repro_torch.optim.adam import AdamConfig, init_adam
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import sharding as shd
from repro_torch.train import tp
from repro_torch.train.fault import DataSkipper, StragglerDetector
from repro_torch.tree import leaves


def make_batch_fn(spec, cfg, batch, seq, device="cuda"):
    """``batch_id -> batch`` on ``device``: token batches, with stub image
    embeddings for a VLM and audio frames for the encoder-decoder, drawn on
    the host by ``data/pipeline.py``."""
    dev = resolve_device(device)
    vocab = getattr(cfg, "vocab")
    pcfg = TokenPipelineConfig(vocab=vocab, seq_len=seq, global_batch=batch)
    if spec.kind == "encdec":
        return lambda i: to_device(audio_batch(pcfg, i, n_frames=seq, d_model=cfg.d_model), dev)
    nfront = getattr(cfg, "n_frontend_tokens", 0)
    if nfront:
        return lambda i: to_device(vlm_batch(pcfg, i, n_img=nfront, d_model=cfg.d_model), dev)
    return lambda i: to_device(token_batch(pcfg, i), dev)


def init_train_state(spec, reduced, device="cuda"):
    """``(params, opt_state)``: weights from seed 0 on ``device`` and a fresh
    Adam state."""
    params, _ = spec.init(torch.Generator().manual_seed(0), reduced=reduced,
                          device=resolve_device(device))
    return params, init_adam(params)


def place_on_mesh(mesh, params, opt_state, axes, split=None):
    """Params and Adam state placed by their shardings (the moments by the
    params'; the step replicated), and the ``[mesh]`` line: what one mesh
    position holds, from the shard shapes and as its tensors' storage
    (``held_bytes``), what each distinct device holds in all, and
    ``split``, how the "model" axis splits the step's products
    (``tp.describe``)."""
    pshard = shd.make_param_sharding(mesh, params, axes)
    oshard = {"m": pshard, "v": pshard, "step": shd.NamedSharding(mesh, shd.P())}
    params, opt_state = shd.device_put(params, pshard), shd.device_put(opt_state, oshard)
    p_bytes, o_bytes = shd.shard_bytes(params, pshard), shd.shard_bytes(opt_state, oshard)
    held = collections.Counter()
    per_device = collections.Counter()
    for pos in shd.positions(mesh):
        hp, ho = shd.held_bytes(params, pos), shd.held_bytes(opt_state, pos)
        held[(hp, ho)] += 1
        per_device[mesh.devices[pos]] += hp + ho
    dims = "x".join(str(n) for n in mesh.shape.values())
    devs = mesh.distinct_devices
    print(f"[mesh] {dims} {mesh.axis_names} over {len(devs)} distinct device(s) "
          f"({', '.join(map(str, devs))}): each of the {mesh.size} positions holds "
          f"{p_bytes} B of params and {o_bytes} B of Adam state (shard shapes); held_bytes: "
          + "; ".join(f"{n} position(s) {hp} B of params and {ho} B of Adam state"
                      for (hp, ho), n in sorted(held.items()))
          + "; " + "; ".join(f"{d} holds {per_device[d]} B in all" for d in devs)
          + (f"; {split}" if split else ""))
    return params, opt_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--total-steps", type=int, default=0,
                    help="LR-schedule horizon (default: --steps); lets a "
                         "resumed run keep the original schedule")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default="none", choices=["none", "prod", "prod-multipod"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = ARCHS[args.arch]
    cfg = spec.cfg(args.reduced)
    total = args.total_steps or args.steps
    adam_cfg = AdamConfig(lr=args.lr, total_steps=total,
                          warmup_steps=max(1, total // 20))

    mesh = None
    if args.mesh != "none":
        mesh = make_production_mesh(multi_pod=args.mesh == "prod-multipod",
                                    devices=device_pool(args.device))
    params, opt_state = init_train_state(spec, args.reduced, args.device)
    if mesh is not None:
        axes = spec.init(None, reduced=args.reduced, device="meta")[1]
        params, opt_state = place_on_mesh(mesh, params, opt_state, axes, split=tp.describe(
            spec, args.reduced, mesh.shape["model"]))
    step_fn = spec.make_train_step(adam_cfg, reduced=args.reduced)
    batch_fn = make_batch_fn(spec, cfg, args.batch, args.seq, args.device)

    start_step = 0
    skipper = DataSkipper(seed=0)
    if args.resume and args.ckpt_dir:
        hit = ckpt.restore_latest(args.ckpt_dir, {"params": params, "opt": opt_state})
        if hit is not None:
            start_step, tree, extra = hit
            if mesh is not None:  # restored whole: placed as before
                tree = shd.device_put(tree, shd.sharding_tree({"params": params,
                                                               "opt": opt_state}))
            params, opt_state = tree["params"], tree["opt"]
            skipper.skip_to(start_step)
            print(f"resumed from step {start_step}")

    straggler = StragglerDetector()
    losses = []
    with shd.use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        for step in range(start_step, args.steps):
            batch = batch_fn(skipper.next_batch_id())
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            losses.append(loss)
            if straggler.observe(0, dt):
                print(f"[fault] step {step}: local worker flagged as straggler ({dt:.2f}s)")
            if step % args.log_every == 0 or step == args.steps - 1:
                print(
                    f"step {step:5d} loss {loss:.4f} gnorm "
                    f"{float(metrics['grad_norm']):.3f} lr {float(metrics['lr']):.2e} {dt:.2f}s"
                )
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                ckpt.save(
                    args.ckpt_dir, step + 1, {"params": params, "opt": opt_state},
                    extra={"arch": args.arch, "loss": loss},
                )
                ckpt.prune(args.ckpt_dir, keep=3)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
