"""LM serving launcher: batched inference of a decoder LM.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch <id> \
        --requests 8 --prompt-len 12 --max-new 8 --device cuda

Port of ``src/repro/launch/serve.py`` for ``kind="lm"``: the arch's
reduced config, weights drawn from seed 0, served by :class:`ServeEngine`
over ``prefill``/``decode_step``.  ``--device`` picks where it runs
(default ``cuda``; it raises when no GPU is present).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.device import resolve_device
from repro_torch.models.transformer import decode_step, prefill
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = ARCHS[args.arch]
    cfg = spec.cfg(reduced=True)
    params, _ = spec.init(torch.Generator().manual_seed(0), reduced=True, device=dev)
    max_len = args.prompt_len + args.max_new + 4

    engine = ServeEngine(
        params,
        lambda p, t: prefill(p, cfg, t, max_len=max_len),
        lambda p, s, t, pos: decode_step(p, cfg, t, s, pos),
        EngineConfig(max_batch=args.max_batch, max_len=max_len),
        device=dev,
    )
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        engine.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32),
            max_new=args.max_new,
        ))
    t0 = time.perf_counter()
    with torch.inference_mode():
        done = engine.run()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s, {cfg.name} on {dev})")
    for r in done[:3]:
        print(f"  rid={r.rid} out={r.out}")
    return done


if __name__ == "__main__":
    main()
