"""Zamba2-style hybrid: Mamba2 backbone + a *shared* attention block
(arXiv:2411.15242).

Port of ``src/repro/models/hybrid.py``.  Every ``share_every`` mamba
blocks, one transformer block runs whose weights are shared across all
its invocations; its input is the concatenation of the current hidden
state with the original embedding (Zamba's residual trick), projected
back to d_model.  The forward loops over the groups where the reference
scans; a decode state is written in place and returned (the mamba
states and the shared block's ring caches alike).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.ssm import Mamba2Config, init_mamba2, init_mamba2_state, mamba2_forward
from repro_torch.models.transformer import _stacked_init, _take, _unstack


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    name: str
    n_mamba: int  # mamba2 blocks (zamba2-2.7b: 54)
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_state: int = 64
    headdim: int = 64
    share_every: int = 6  # shared attn block cadence
    window: int = 4096  # attention window for 500k decode feasibility
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def mamba_cfg(self) -> Mamba2Config:
        return Mamba2Config(
            d_model=self.d_model, d_state=self.d_state, headdim=self.headdim
        )

    @property
    def n_shared_calls(self) -> int:
        return self.n_mamba // self.share_every

    def attn_cfg(self):
        return L.AttnConfig(
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim,
            d_model=self.d_model,
            window=self.window,
        )


def _init_mamba_block(key, cfg: HybridConfig):
    return {
        "ln": L.init_rmsnorm(key, cfg.d_model),
        "mamba": init_mamba2(key, cfg.mamba_cfg),
    }


def init_hybrid(generator: Optional[torch.Generator], cfg: HybridConfig, device="cuda"):
    """Returns (params, specs), every leaf float32 on ``device``, drawn
    from ``generator`` in turn; ``device="meta"`` gives shapes alone.  The
    mamba leaves are ``[n_shared_calls, share_every, ...]``."""
    key = L.ParamInit(generator, resolve_device(device))
    params, specs = L.split_tree(
        {
            "embed": L.init_embed(key, cfg.vocab, cfg.d_model),
            "ln_final": L.init_rmsnorm(key, cfg.d_model),
            "shared": {
                "proj_in": L.make_param(
                    key, (2 * cfg.d_model, cfg.d_model), ("embed", "embed2")
                ),
                "ln": L.init_rmsnorm(key, 2 * cfg.d_model),
                "attn": L.init_attention(key, cfg.attn_cfg()),
                "ln_mlp": L.init_rmsnorm(key, cfg.d_model),
                "mlp": L.init_mlp(key, cfg.d_model, cfg.d_ff),
            },
        }
    )
    bp, bs = _stacked_init(lambda k: _init_mamba_block(k, cfg), key, cfg.n_mamba)
    # group mamba blocks by share_every so the shared-attn cadence loops
    grp = cfg.share_every

    def regroup(t):
        return {k: regroup(v) for k, v in t.items()} if isinstance(t, dict) else t.reshape(
            (cfg.n_shared_calls, grp) + tuple(t.shape[1:]))

    def restack(s):
        return {k: restack(v) for k, v in s.items()} if isinstance(s, dict) else ("layers",) + s

    params["mamba"] = regroup(bp)
    # bs already has a leading "layers"; the reshape adds a second stack dim
    specs["mamba"] = restack(bs)
    return params, specs


def _shared_block(sp, x, x0, cfg: HybridConfig, positions, cache=None):
    h = torch.cat([x, x0], dim=-1)
    h = L.rmsnorm(sp["ln"], h)
    h = torch.einsum("bsm,md->bsd", h, sp["proj_in"].to(x.dtype))
    a, new_cache = L.attention(sp["attn"], h, cfg.attn_cfg(), positions, cache)
    x = x + a
    h = L.rmsnorm(sp["ln_mlp"], x)
    x = x + L.mlp(sp["mlp"], h)
    return x, new_cache


def hidden_states(params, cfg: HybridConfig, tokens, positions=None, state=None):
    """state: None (train/prefill) or the tree from :func:`init_state`
    (decode), written in place and returned."""
    x = L.embed(params["embed"], tokens).to(cfg.dtype)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    x0 = x
    mcfg = cfg.mamba_cfg
    sp = params["shared"]

    def group(x, gp, sp, gstate=None):
        """Shared attention first, then ``share_every`` mamba blocks."""
        x, _ = _shared_block(sp, x, x0, cfg, positions,
                             gstate["attn"] if gstate is not None else None)
        for i, lp in enumerate(_unstack(gp, cfg.share_every)):
            st = _take(gstate["ssm"], i) if gstate is not None else None
            y, _ = mamba2_forward(lp["mamba"], L.rmsnorm(lp["ln"], x), mcfg, state=st)
            x = x + y
        return x

    for g, gp in enumerate(_unstack(params["mamba"], cfg.n_shared_calls)):
        if state is None:  # each group recomputed in the backward
            x = L.remat(group, x, gp, sp)
        else:
            x = group(x, gp, sp, _take(state, g))
    x = L.rmsnorm(params["ln_final"], x)
    return x, state


def init_state(cfg: HybridConfig, batch, max_attn_len, device="cuda"):
    """Decode state: per group, one shared-attn ring cache + per-mamba ssm
    state.  Attention cache is windowed (cfg.window) — with a 500k context
    the whole state is O(window + d_state), not O(S)."""
    dev = resolve_device(device)
    size = min(cfg.window, max_attn_len)
    H, D = cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_shared_calls
    return {
        "attn": {
            "k": torch.zeros((g, batch, size, H, D), dtype=cfg.dtype, device=dev),
            "v": torch.zeros((g, batch, size, H, D), dtype=cfg.dtype, device=dev),
            "pos": torch.full((g, size), L.PAD_POS, dtype=torch.int32, device=dev),
            "len": torch.zeros((g,), dtype=torch.int32, device=dev),
        },
        "ssm": init_mamba2_state(cfg.mamba_cfg, batch, cfg.dtype, dev,
                                 lead=(g, cfg.share_every)),
    }


def train_loss(params, cfg: HybridConfig, batch):
    """Next-token cross-entropy."""
    x, _ = hidden_states(params, cfg, batch["tokens"][:, :-1])
    return L.chunked_softmax_xent(params["embed"], x, batch["tokens"][:, 1:],
                                  true_vocab=cfg.vocab)


def decode_step(params, cfg: HybridConfig, token, state, pos):
    """One token at positions ``pos`` [B,1]; ``state`` is written in place
    and returned."""
    x, state = hidden_states(params, cfg, token, positions=pos, state=state)
    logits = L.unembed_logits(params["embed"], x, true_vocab=cfg.vocab)
    return logits, state


def state_specs(cfg: HybridConfig):
    return {
        "attn": {
            "k": ("layers", "batch", "seq", "kv_heads", "head_dim"),
            "v": ("layers", "batch", "seq", "kv_heads", "head_dim"),
            "pos": ("layers", "seq"),
            "len": ("layers",),
        },
        "ssm": {
            "ssm": ("layers", "sublayers", "batch", "mamba_heads", "head_dim", "state"),
            "conv": ("layers", "sublayers", "batch", "conv", "inner"),
        },
    }
