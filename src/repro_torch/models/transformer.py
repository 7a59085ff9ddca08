"""Generic decoder-only LM covering the decoder architectures of the zoo.

Port of ``src/repro/models/transformer.py``.  One config class and one code
path handle dense (gemma2/gemma3/starcoder2/qwen), MoE (olmoe), MLA + MoE
(deepseek-v2-lite) and the VLM backbone (internvl2, whose vision frontend
is a stub supplying precomputed patch embeddings).  Layers come in
*pattern groups* (gemma2's (local, global) pair, gemma3's 5 x local +
global); each pattern position's params stack along a leading "layers"
axis, as in the reference, and the forward loops over the ``n_rep``
groups where the reference scans.

Caches are updated in place: :func:`prefill` returns a fresh cache tree,
and :func:`decode_step` writes into the one it is given and returns it, so
a cache passed to it is consumed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.train import tp as TP


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    norm: str = "rmsnorm"
    act: str = "silu"
    gated: bool = True
    qkv_bias: bool = False
    mlp_bias: bool = False
    rope_base: float = 10_000.0
    rope_base_local: float = 0.0  # 0 -> same as rope_base (gemma3: 10k local/1M global)
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    embed_scale: bool = False
    post_norms: bool = False  # gemma2: extra norms after attn/mlp outputs
    layer_pattern: tuple = ("g",)  # cycled; "l" = local window, "g" = global
    window: int = 0
    query_scale: float = 0.0
    moe: Optional[L.MoEConfig] = None
    moe_dispatch: str = "sorted"  # "sorted" (SCV-style) | "dense"
    first_dense: int = 0  # deepseek: leading dense-FFN layers
    first_dense_ff: int = 0
    mla: Optional[L.MLAConfig] = None
    n_frontend_tokens: int = 0  # vlm: image tokens prepended (stub embeds)
    kv_quant: bool = False  # int8 KV cache
    dtype: torch.dtype = torch.bfloat16

    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_rep(self) -> int:
        body = self.n_layers - self.first_dense
        assert body % self.pattern_len == 0, (self.n_layers, self.layer_pattern)
        return body // self.pattern_len

    def attn_cfg(self, kind: str) -> L.AttnConfig:
        local = kind == "l"
        base = (
            self.rope_base_local
            if (local and self.rope_base_local)
            else self.rope_base
        )
        return L.AttnConfig(
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim,
            d_model=self.d_model,
            rope_base=base,
            qkv_bias=self.qkv_bias,
            logit_softcap=self.attn_softcap,
            window=self.window if local else 0,
            query_scale=self.query_scale,
        )

    def param_count(self) -> int:
        """Total parameters, from shapes alone (an init on ``meta``)."""
        params, _ = init_lm(None, self, device="meta")
        return sum(int(np.prod(t.shape)) for _, t in leaf_paths(params))

    def active_param_count(self) -> int:
        """Active params per token (MoE discounts inactive experts), by the
        reference's own path test."""
        params, _ = init_lm(None, self, device="meta")
        total = 0
        for keys, t in leaf_paths(params):
            n = int(np.prod(t.shape))
            if self.moe and ("/wi" in keys or "/wg" in keys or "/wo" in keys) and "moe" in keys:
                n = n * self.moe.top_k // self.moe.n_experts
            total += n
        return total


def leaf_paths(tree, prefix=""):
    """(``"a/b/c"`` path, leaf) of a nested dict, depth first."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from leaf_paths(v, path)
        else:
            yield path, v


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_norm(key, cfg, d=None):
    d = d or cfg.d_model
    return L.init_rmsnorm(key, d) if cfg.norm == "rmsnorm" else L.init_layernorm(key, d)


def _apply_norm(cfg, p, x):
    if cfg.norm == "rmsnorm":
        return L.rmsnorm(p, x)
    return L.layernorm(p, x)


def _init_block(key, cfg: LMConfig, kind: str, dense_ff: int = 0):
    """One layer's params: norms + attention (or MLA) + FFN (or MoE)."""
    p = {"ln_attn": _init_norm(key, cfg), "ln_mlp": _init_norm(key, cfg)}
    if cfg.post_norms:
        p["ln_attn_post"] = _init_norm(key, cfg)
        p["ln_mlp_post"] = _init_norm(key, cfg)
    if cfg.mla is not None:
        p["attn"] = L.init_mla(key, cfg.mla)
    else:
        p["attn"] = L.init_attention(key, cfg.attn_cfg(kind))
    if dense_ff:
        p["mlp"] = L.init_mlp(key, cfg.d_model, dense_ff, cfg.gated)
    elif cfg.moe is not None:
        p["moe"] = L.init_moe(key, cfg.moe)
    else:
        p["mlp"] = L.init_mlp(key, cfg.d_model, cfg.d_ff, cfg.gated)
    return p


def _stacked_init(init_fn, key: L.ParamInit, n):
    """``init_fn``'s tree with every leaf stacked ``n`` deep; each layer
    draws its own weights (the reference's vmap over split keys)."""
    params, specs = L.split_tree(init_fn(key.stacked(n)))

    def prefix(s):
        return {k: prefix(v) for k, v in s.items()} if isinstance(s, dict) else ("layers",) + s

    return params, prefix(specs)


def init_lm(generator: Optional[torch.Generator], cfg: LMConfig, device="cuda"):
    """Returns (params, specs), every leaf float32 on ``device``.

    Draws come from ``generator`` in turn, on the generator's device; the
    reference reuses keys across pattern positions (``ks[1 + i % 3]``),
    the port does not, so its weights are its own (parity runs through
    :func:`params_from_jax`).  ``device="meta"`` gives shapes alone.
    """
    dev = resolve_device(device)
    key = L.ParamInit(generator, dev)
    tree = {
        "embed": L.init_embed(key, cfg.vocab, cfg.d_model),
        "ln_final": _init_norm(key, cfg),
    }
    params, specs = L.split_tree(tree)
    blocks_p, blocks_s = {}, {}
    for i, kind in enumerate(cfg.layer_pattern):
        bp, bs = _stacked_init(lambda k, kind=kind: _init_block(k, cfg, kind), key, cfg.n_rep)
        blocks_p[f"pos{i}"] = bp
        blocks_s[f"pos{i}"] = bs
    params["blocks"] = blocks_p
    specs["blocks"] = blocks_s
    for j in range(cfg.first_dense):
        hp, hs = L.split_tree(
            _init_block(key, cfg, "g", dense_ff=cfg.first_dense_ff or cfg.d_ff)
        )
        params[f"head{j}"] = hp
        specs[f"head{j}"] = hs
    return params, specs


def params_from_jax(params, device="cuda") -> dict:
    """The reference's param tree (nested dicts of arrays, as numpy or
    anything ``np.asarray`` takes) as the port's tensors, leaf for leaf.
    It carries every family's tree as it is (the SSM, hybrid and
    encoder-decoder ones too, the hybrid's ``[n_shared_calls,
    share_every, ...]`` mamba leaves among them): no leaf is renamed or
    reshaped."""
    dev = resolve_device(device)
    if isinstance(params, dict):
        return {k: params_from_jax(v, dev) for k, v in params.items()}
    return torch.from_numpy(np.array(params)).to(dev)


def serving_params(params, cfg: LMConfig) -> dict:
    """``params`` with every weight the forward casts at each use cast to
    ``cfg.dtype`` once: the same bits as casting at each use, at half the
    bytes for bf16.  Norm scales stay float32, as the forward reads them;
    so does the embedding table when ``embed_scale`` scales its rows in
    float32 before the cast."""

    def keep(path):
        if any(part.startswith("ln_") for part in path.split("/")):
            return True
        return path == "embed/table" and cfg.embed_scale

    return L.cast_params(params, cfg.dtype, keep)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _block_apply(p, x, cfg: LMConfig, kind, positions, cache=None, dense_ff=False):
    acfg = cfg.attn_cfg(kind)
    h = _apply_norm(cfg, p["ln_attn"], x)
    if cfg.mla is not None:
        a, new_cache = L.mla_attention(p["attn"], h, cfg.mla, positions, cache)
    else:
        a, new_cache = L.attention(p["attn"], h, acfg, positions, cache)
    if cfg.post_norms:
        a = _apply_norm(cfg, p["ln_attn_post"], a)
    x = x + a
    h = _apply_norm(cfg, p["ln_mlp"], x)
    aux = 0.0
    if "moe" in p and not dense_ff:
        fn = L.moe_sorted if cfg.moe_dispatch == "sorted" else L.moe_dense
        m, aux = fn(p["moe"], h, cfg.moe)
    else:
        m = L.mlp(p["mlp"], h, cfg.act)
    if cfg.post_norms:
        m = _apply_norm(cfg, p["ln_mlp_post"], m)
    x = x + m
    return x, new_cache, aux


def _take(tree, r):
    """Layer ``r`` of a stacked tree: views, so in-place writes to a cache
    leaf land in the stacked tensor."""
    return {k: _take(v, r) if isinstance(v, dict) else v[r] for k, v in tree.items()}


def _unstack(tree, n) -> list:
    """The ``n`` layers of a stacked param tree, as trees of views
    (``torch.unbind``).  A backward through them stacks each leaf's
    gradient once; through :func:`_take` each layer would add a zero-filled
    gradient of the whole stacked leaf."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, TP.Split):
        return tree.unbind()
    return list(torch.unbind(tree))


def hidden_states(
    params,
    cfg: LMConfig,
    tokens,
    positions=None,
    extra_embed=None,
    caches=None,
):
    """Run embedding + all blocks.  Returns (hidden, caches, aux_sum).

    extra_embed: [B, n_front, d_model] stub frontend embeddings (vlm),
    prepended before the token embeddings.
    caches: tree from init_cache() (written in place and returned), or None.
    """
    x = L.embed(params["embed"], tokens, scale=cfg.embed_scale).to(cfg.dtype)
    if extra_embed is not None:
        x = torch.cat([extra_embed.to(cfg.dtype), x], dim=1)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    # leading special (dense) layers — deepseek's first_dense; without a
    # cache each is recomputed in the backward (L.remat), as the reference
    # checkpoints it
    for j in range(cfg.first_dense):
        if caches is None:
            x, aux = L.remat(
                lambda x, p: _block_apply(p, x, cfg, "g", positions, None, True)[::2],
                x, params[f"head{j}"],
            )
        else:
            x, _, aux = _block_apply(params[f"head{j}"], x, cfg, "g", positions,
                                     caches[f"head{j}"], True)
        aux_total = aux_total + aux

    def group(x, gp):
        """One repetition of the layer pattern, without caches."""
        aux = 0.0
        for i, kind in enumerate(cfg.layer_pattern):
            x, _, a = _block_apply(gp[f"pos{i}"], x, cfg, kind, positions)
            aux = aux + a
        return x, aux

    blocks = _unstack(params["blocks"], cfg.n_rep)
    for r in range(cfg.n_rep):
        if caches is None:
            x, aux = L.remat(group, x, blocks[r])
            aux_total = aux_total + aux
            continue
        for i, kind in enumerate(cfg.layer_pattern):
            c = _take(caches["blocks"][f"pos{i}"], r)
            x, _, aux = _block_apply(blocks[r][f"pos{i}"], x, cfg, kind, positions, c)
            aux_total = aux_total + aux

    x = _apply_norm(cfg, params["ln_final"], x)
    return x, caches, aux_total


# ---------------------------------------------------------------------------
# task heads
# ---------------------------------------------------------------------------


def train_loss(params, cfg: LMConfig, batch, aux_weight=0.01):
    """Next-token CE (+ MoE aux).  batch: {"tokens": [B,S] int,
    "extra_embed": optional [B,n,d_model]}."""
    tokens = batch["tokens"]
    extra = batch.get("extra_embed")
    x, _, aux = hidden_states(params, cfg, tokens[:, :-1], extra_embed=extra)
    if extra is not None:
        x = x[:, extra.shape[1] :]  # loss only on text positions
    loss = L.chunked_softmax_xent(
        params["embed"], x, tokens[:, 1:], softcap=cfg.final_softcap,
        true_vocab=cfg.vocab,
    )
    return loss + aux_weight * aux


def init_cache(cfg: LMConfig, batch, max_len, dtype=None, device="cuda"):
    """KV caches.  Local (windowed) layers use a ring buffer of size
    min(window, max_len) — the sliding-window truncation."""
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    K, D = cfg.n_kv_heads, cfg.head_dim

    def one(kind, lead=()):
        def z(shape, dt):
            return torch.zeros(lead + shape, dtype=dt, device=dev)

        if cfg.mla is not None:
            R = cfg.mla.kv_lora_rank
            c = {
                "ckv": z((batch, max_len, R), torch.int8 if cfg.kv_quant else dtype),
                "krope": z((batch, max_len, cfg.mla.qk_rope_dim), dtype),
                "len": z((), torch.int32),
            }
            if cfg.kv_quant:
                c["ckv_scale"] = z((batch, max_len), torch.float32)
            return c
        size = min(cfg.window, max_len) if (kind == "l" and cfg.window) else max_len
        kv_dtype = torch.int8 if cfg.kv_quant else dtype
        c = {
            "k": z((batch, size, K, D), kv_dtype),
            "v": z((batch, size, K, D), kv_dtype),
            "pos": torch.full(lead + (size,), L.PAD_POS, dtype=torch.int32, device=dev),
            "len": z((), torch.int32),
        }
        if cfg.kv_quant:
            c["k_scale"] = z((batch, size, K), torch.float32)
            c["v_scale"] = z((batch, size, K), torch.float32)
        return c

    caches = {
        "blocks": {
            f"pos{i}": one(kind, (cfg.n_rep,))
            for i, kind in enumerate(cfg.layer_pattern)
        }
    }
    for j in range(cfg.first_dense):
        caches[f"head{j}"] = one("g")
    return caches


def prefill(params, cfg: LMConfig, tokens, extra_embed=None, max_len=None):
    """Prefill: runs hidden_states writing into fresh caches sized
    max_len (>= prompt length + decode budget)."""
    B = tokens.shape[0]
    S = tokens.shape[1] + (extra_embed.shape[1] if extra_embed is not None else 0)
    max_len = max_len or S
    caches = init_cache(cfg, B, max_len, device=tokens.device)
    x, caches, _ = hidden_states(
        params, cfg, tokens, extra_embed=extra_embed, caches=caches
    )
    logits = L.unembed_logits(params["embed"], x[:, -1:], cfg.final_softcap, true_vocab=cfg.vocab)
    return logits, caches


def decode_step(params, cfg: LMConfig, token, caches, pos):
    """One decode step.  token: [B,1] int; pos: [B,1] absolute position.
    ``caches`` is written in place and returned."""
    x, caches, _ = hidden_states(
        params, cfg, token, positions=pos, caches=caches
    )
    logits = L.unembed_logits(params["embed"], x, cfg.final_softcap, true_vocab=cfg.vocab)
    return logits, caches


def cache_specs(cfg: LMConfig):
    """Logical-axes tree mirroring init_cache() for sharding resolution."""

    def one():
        if cfg.mla is not None:
            c = {
                "ckv": ("layers", "batch", "seq", "mla_rank"),
                "krope": ("layers", "batch", "seq", "head_dim"),
                "len": ("layers",),
            }
            if cfg.kv_quant:
                c["ckv_scale"] = ("layers", "batch", "seq")
            return c
        c = {
            "k": ("layers", "batch", "seq", "kv_heads", "head_dim"),
            "v": ("layers", "batch", "seq", "kv_heads", "head_dim"),
            "pos": ("layers", "seq"),
            "len": ("layers",),
        }
        if cfg.kv_quant:
            c["k_scale"] = ("layers", "batch", "seq", "kv_heads")
            c["v_scale"] = ("layers", "batch", "seq", "kv_heads")
        return c

    specs = {"blocks": {f"pos{i}": one() for i in range(cfg.pattern_len)}}
    for j in range(cfg.first_dense):
        specs[f"head{j}"] = {k: ax[1:] for k, ax in one().items()}
    return specs
