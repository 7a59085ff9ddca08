"""Batched LM serving engine: prefill + decode over a request queue.

Port of ``src/repro/serve/engine.py``: requests arrive with prompts, are
batched up to ``max_batch``, left-padded to the batch's longest prompt and
prefilled together, then decoded token by token with one shared position
per step, greedily (``argmax`` of the last logits), each request keeping
its own ``max_new`` tokens.  The chosen tokens stay on the device between
steps and come back to the host once per batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # int32[prompt_len]
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 4
    max_len: int = 128
    greedy: bool = True


class ServeEngine:
    """Drives (prefill_fn, decode_fn) over batches of requests on
    ``device`` (default the card; raises without one).

    prefill_fn(params, tokens[B,S]) -> (logits[B,1,V], state)
    decode_fn(params, state, token[B,1], pos[B,1]) -> (logits, state)
    """

    def __init__(self, params, prefill_fn, decode_fn, cfg: EngineConfig, device="cuda"):
        self.params = params
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.cfg = cfg
        self.device = resolve_device(device)
        self.queue: list[Request] = []
        self.completed: list[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _pick(self, logits) -> torch.Tensor:
        if self.cfg.greedy:
            return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        raise NotImplementedError

    def run(self) -> list[Request]:
        while self.queue:
            batch = self.queue[: self.cfg.max_batch]
            self.queue = self.queue[self.cfg.max_batch :]
            plen = max(len(r.prompt) for r in batch)
            B = len(batch)
            toks = np.zeros((B, plen), np.int32)
            for i, r in enumerate(batch):
                toks[i, plen - len(r.prompt) :] = r.prompt  # left-pad
            logits, state = self.prefill_fn(self.params, torch.from_numpy(toks).to(self.device))
            nxt = self._pick(logits)
            picked = [nxt]
            max_new = max(r.max_new for r in batch)
            for step in range(1, max_new):
                pos = torch.full((B, 1), plen + step - 1, dtype=torch.int32, device=self.device)
                logits, state = self.decode_fn(self.params, state, nxt[:, None], pos)
                nxt = self._pick(logits)
                picked.append(nxt)
            out = torch.stack(picked, dim=1).cpu().numpy()
            for i, r in enumerate(batch):
                # the prefill's token always, then up to max_new in all
                r.out.extend(int(t) for t in out[i, : max(1, r.max_new)])
                r.done = True
                self.completed.append(r)
        return self.completed
