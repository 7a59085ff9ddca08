"""AdamW with float32 moment state, global-norm clipping and a cosine LR.

Port of ``src/repro/optim/adam.py``.  The state mirrors the param tree
(dicts of tensors, ``repro_torch.tree``), every scalar of the update (the
step, the LR, the clip scale, the bias corrections) stays a float32 or
int32 tensor on the params' device, so an update reads nothing back to the
host.  The update is functional: it returns new trees and leaves its
inputs as they were.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _device(tree) -> torch.device:
    first = leaves(tree)
    return first[0].device if first else torch.device("cpu")


def init_adam(params, master_weights: bool = False):
    """Zero float32 moments (and the step, int32) on the params' device.
    With ``master_weights`` a float32 master copy lives in the state and
    ``params`` may be bf16: the forward and backward move half the bytes,
    and Adam updates the master and emits its bf16 rounding."""
    st = {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=_device(params)),
    }
    if master_weights:
        st["master"] = tree_map(lambda p: p.to(torch.float32, copy=True), params)
    return st


def schedule(cfg: AdamConfig, step):
    """Linear warm-up, then a cosine decay to ``min_lr_frac``: the LR at
    ``step`` (an int or an int tensor) as a float32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in float32."""
    total = None
    for x in leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def adam_update(cfg: AdamConfig, params, grads, state, gnorm=None):
    """Returns ``(new_params, new_state, metrics)``.  If the state carries
    a ``master`` tree, updates apply to the float32 master and the params
    are its rounding to their dtype.  ``gnorm``, the gradients' global
    norm, defaults to ``global_norm(grads)``; a caller updating one shard
    of every leaf passes the norm of the whole gradients."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)
    masters = state.get("master", params)

    def upd(p, w, g, m, v):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if w.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * w.to(torch.float32)
        w_new = w.to(torch.float32) - lr * delta
        return w_new.to(p.dtype), m, v, w_new

    out = [upd(*xs) for xs in zip(*(leaves(t) for t in
                                   (params, masters, grads, state["m"], state["v"])))]
    new_state = {
        "m": unflatten(params, [o[1] for o in out]),
        "v": unflatten(params, [o[2] for o in out]),
        "step": step,
    }
    if "master" in state:
        new_state["master"] = unflatten(params, [o[3] for o in out])
    return unflatten(params, [o[0] for o in out]), new_state, {"grad_norm": gnorm, "lr": lr}
