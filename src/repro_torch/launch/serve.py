"""LM serving launcher: batched inference of a decoder LM, an SSM LM or a
hybrid.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch <id> \
        --requests 8 --prompt-len 12 --max-new 8 --device cuda

Port of ``src/repro/launch/serve.py`` for ``kind`` ``lm``, ``mamba_lm``
and ``hybrid`` (``encdec`` is refused, as there): the arch's reduced
config, weights drawn from seed 0, served by :class:`ServeEngine` over
the functions :func:`serve_fns` builds.  The decoder LM prefills its
prompt in one pass; the recurrent kinds feed it through the decode step
one token at a time, as the reference does.  Where the reference jits
the decode step, the port captures it in a CUDA graph
(:class:`CapturedDecode`, one capture per batch size): the capture owns
the decode state and writes it in place.  ``--device`` picks where it
runs (default ``cuda``; it raises when no GPU is present); on the CPU the
decode step runs eagerly.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.device import resolve_device
from repro_torch.serve.engine import CapturedDecode, EngineConfig, Request, ServeEngine


def serve_fns(spec, cfg, max_len, device="cuda", capture=True):
    """``(prefill_fn, decode_fn)`` for :class:`ServeEngine` serving
    ``spec``'s family with ``cfg`` and caches of ``max_len`` positions on
    ``device``.  ``capture=False`` leaves the decode step eager (to hold
    the captured one against it)."""
    dev = resolve_device(device)
    if spec.kind == "lm":
        from repro_torch.models.transformer import decode_step, prefill

        def step(p, s, t, pos):
            return decode_step(p, cfg, t, s, pos)

        decode_fn = CapturedDecode(step) if capture else step
        return (lambda p, t: prefill(p, cfg, t, max_len=max_len)), decode_fn
    if spec.kind == "mamba_lm":
        from repro_torch.models.ssm import init_mamba2_lm_state, mamba2_lm_decode

        def step(p, s, t, pos):
            return mamba2_lm_decode(p, cfg, t, s)

        def init_state(batch):
            return init_mamba2_lm_state(cfg, batch, device=dev)

    elif spec.kind == "hybrid":
        from repro_torch.models import hybrid

        def step(p, s, t, pos):
            return hybrid.decode_step(p, cfg, t, s, pos)

        def init_state(batch):
            return hybrid.init_state(cfg, batch, max_len, device=dev)

    else:
        raise SystemExit(f"serve driver supports decoder LMs; {spec.kind} has its own path")
    decode_fn = CapturedDecode(step) if capture else step

    def prefill_fn(p, t):
        # recurrent prefill: the prompt one token at a time through the
        # decode step (a replay each when it is captured)
        B, S = t.shape
        st = init_state(B)
        positions = torch.arange(S, dtype=torch.int32, device=t.device)[None].expand(B, S)
        logits = None
        for i in range(S):
            logits, st = decode_fn(p, st, t[:, i : i + 1], positions[:, i : i + 1])
        return logits, st

    return prefill_fn, decode_fn


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

    spec = ARCHS[args.arch]
    cfg = spec.cfg(reduced=True)
    dev = resolve_device(args.device)
    params, _ = spec.init(torch.Generator().manual_seed(0), reduced=True, device=dev)
    max_len = args.prompt_len + args.max_new + 4
    prefill_fn, decode_fn = serve_fns(spec, cfg, max_len, dev)

    engine = ServeEngine(params, prefill_fn, decode_fn,
                         EngineConfig(max_batch=args.max_batch, max_len=max_len), device=dev)
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
          f"({total_tokens / dt:.1f} tok/s, {cfg.name} on {dev}; decode captures "
          f"{decode_fn.captures}, graphs {decode_fn.graphs})")
    for r in done[:3]:
        print(f"  rid={r.rid} out={r.out}")
    return done


if __name__ == "__main__":
    main()
