"""Batched LM serving engine: prefill + decode over a request queue.

Port of ``src/repro/serve/engine.py``: requests arrive with prompts, are
batched up to ``max_batch``, left-padded to the batch's longest prompt and
prefilled together, then decoded token by token with one shared position
per step, greedily (``argmax`` of the last logits), each request keeping
its own ``max_new`` tokens.  The chosen tokens stay on the device between
steps and come back to the host once per batch.

:class:`CapturedDecode` is the port's counterpart of the reference
launcher's ``jax.jit(decode_step)``: a decode step captured in a CUDA
graph once per batch shape, which owns the state it writes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import capture_graph, resolve_device
from repro_torch.models.transformer import leaf_paths


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


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


class _DecodeGraph:
    """One key's CUDA graph: the params it is bound to, the state it owns,
    the static token and position, and the static logits."""

    def __init__(self, step, params, state, token, pos, side: torch.cuda.Stream):
        self.params = params
        self.state = _map(torch.empty_like, state)
        self.token = torch.empty_like(token)
        self.pos = torch.empty_like(pos)
        # one eager step on the side stream first, on a scratch copy of the
        # state (the owned one is untouched), makes cuBLAS's lazy state
        # there; then the capture, on the same stream, over the static
        # inputs (which need no values for it)
        cur = torch.cuda.current_stream(token.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            step(params, _map(torch.clone, state), token, pos)
        self.graph = torch.cuda.CUDAGraph()
        self.logits, out = capture_graph(
            self.graph, side, lambda: step(params, self.state, self.token, self.pos))
        if out is not self.state:
            raise RuntimeError("a captured decode step must write its state in place "
                               "and return it")
        cur.wait_stream(side)

    def replay(self, token, pos):
        self.token.copy_(token)
        self.pos.copy_(pos)
        self.graph.replay()
        return self.logits.clone(), self.state


class CapturedDecode:
    """``step(params, state, token, pos) -> (logits, state)``, a decode
    step that writes ``state`` in place and returns it, captured in a CUDA
    graph once per key: the shape, dtype and device of the token, the
    position and every state leaf (so one capture per batch size for a
    launcher's ``max_len``).  The counterpart of the reference launcher's
    ``jax.jit(decode_step)``.

    The capture owns its state.  A call copies ``token`` and ``pos`` into
    the static ones and, unless ``state`` is the owned tree (as it is from
    a batch's second step on: the call returns it), copies ``state``'s
    leaves into the owned ones; then it replays and returns a clone of the
    static logits with the owned state.  So a new batch's prefill state
    goes into the owned buffers, and later steps copy only the token and
    position.  The capture is bound to the params tree of its first call;
    a call with another raises.  A step that cannot be captured raises: no
    call falls back to eager.  On the CPU a key holds nothing and the call
    runs ``step`` eagerly, counted all the same.

    Counts: ``captures`` the keys minted (a key's first call), ``replays``
    the later calls, ``graphs`` the CUDA graphs captured, ``copy_bytes``
    the state bytes copied in.
    """

    def __init__(self, step):
        self.step = step
        self._entries: dict = {}  # key -> _DecodeGraph, or None on the CPU
        self._streams: dict = {}
        self.captures = 0
        self.replays = 0
        self.graphs = 0
        self.copy_bytes = 0

    def _side_stream(self, dev: torch.device) -> torch.cuda.Stream:
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        return self._streams[dev]

    def __call__(self, params, state, token, pos):
        key = tuple((path, tuple(t.shape), t.dtype, t.device)
                    for path, t in leaf_paths({"state": state, "token": token, "pos": pos}))
        with torch.inference_mode():
            if key in self._entries:
                self.replays += 1
            else:
                self.captures += 1
                entry = None
                if token.device.type == "cuda":
                    entry = _DecodeGraph(self.step, params, state, token, pos,
                                         self._side_stream(token.device))
                    self.graphs += 1
                self._entries[key] = entry
            entry = self._entries[key]
            if entry is None:
                return self.step(params, state, token, pos)
            if params is not entry.params:
                raise ValueError("a captured decode step is bound to the params it was "
                                 "captured with")
            if state is not entry.state:  # a new batch's state goes into the owned buffers
                for (_, dst), (_, src) in zip(leaf_paths(entry.state), leaf_paths(state)):
                    dst.copy_(src)
                    self.copy_bytes += src.numel() * src.element_size()
            return entry.replay(token, pos)
