"""Neural-net building blocks of the decoder-LM family.

Port of ``src/repro/models/layers.py``: plain functions on nested dicts of
tensors.  ``init_*`` returns a tree of ``(tensor, logical axes)`` pairs
that :func:`split_tree` splits into ``(params, specs)``; the axes tree is
the reference's, which ``train/sharding.py`` resolves on a mesh.  Attention covers GQA, RoPE
(per-layer base, partial dims), QKV bias, logit softcapping, sliding
windows and MLA; sequences of 2,048 and more take a blockwise
(online-softmax) path, as in the reference.

Where the reference calls ``repro.train.sharding.constrain``, the port
splits the product over the "model" positions of a data group when the
SPMD train step has installed one (``train/tp.py``): attention by heads or
by query sequence (``seq_sharded``), MLA by heads, the MLP by columns, the
sorted MoE by experts, and the embedding, the logits and the loss by
vocabulary rows.  The residual stream and the norms stay whole on the
group's first position.  Without a group every function computes whole,
as before.  Two choices differ from the reference by
design: a KV cache passed to :func:`attention` or :func:`mla_attention` is
written in place and returned (the reference threads a new one), and the
slot arithmetic stays on the device, so no layer reads the cache length
back to the host.

:func:`remat` stands where the reference wraps a function in
``jax.checkpoint``: when a gradient is being recorded, the function's
activations are recomputed in the backward instead of kept.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.train import tp as TP

#: Key positions at or past this are invalid (padded / unwritten slots).
INVALID_POS = 2**29
#: Position given to padded key slots of the blockwise paths.
PAD_POS = 2**30
#: The sequence length from which attention runs blockwise.
BLOCKWISE_FROM = 2048

# ---------------------------------------------------------------------------
# param helpers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamInit:
    """Where and how parameters are drawn: the port's stand-in for the
    reference's PRNG key.  Draws come from ``generator`` in sequence, on
    the generator's device (then moved to ``device``); on ``"meta"`` they
    take no memory and no draw.  ``lead`` prepends stacking dims (the
    ``[n_rep, ...]`` leaves) without changing a weight's scale."""

    generator: Optional[torch.Generator]
    device: torch.device
    lead: tuple = ()

    def stacked(self, n: int) -> "ParamInit":
        return dataclasses.replace(self, lead=(n,) + self.lead)

    def normal(self, shape) -> torch.Tensor:
        full = self.lead + tuple(shape)
        if self.device.type == "meta":
            return torch.empty(full, dtype=torch.float32, device="meta")
        gdev = self.generator.device if self.generator is not None else self.device
        t = torch.randn(full, generator=self.generator, dtype=torch.float32, device=gdev)
        return t.to(self.device)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(self.lead + tuple(shape), value, dtype=torch.float32,
                          device=self.device)


def _records_grad(tree) -> bool:
    if isinstance(tree, (torch.Tensor, TP.Split)):
        return tree.requires_grad
    if isinstance(tree, dict):
        return any(_records_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_records_grad(v) for v in tree)
    return False


def remat(fn, *args):
    """``fn(*args)``; its activations are recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant: the counterpart of
    ``jax.checkpoint``) when grad mode is on and a tensor in ``args``
    (nested dicts included) requires a gradient.  Serving, the captured
    decode and ``no_grad`` calls run ``fn`` plainly."""
    if torch.is_grad_enabled() and _records_grad(args):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False,
            context_fn=lambda: (contextlib.nullcontext(), _recompute()))
    return fn(*args)


#: How many :func:`remat` recomputes are running (the dry run reads it).
RECOMPUTING = 0


@contextlib.contextmanager
def _recompute():
    global RECOMPUTING
    RECOMPUTING += 1
    try:
        yield
    finally:
        RECOMPUTING -= 1


def make_param(key: ParamInit, shape, axes):
    """Returns (tensor drawn with std 1/sqrt(shape[0]), logical-axes tuple)."""
    assert len(axes) == len(shape), (axes, shape)
    return key.normal(shape).div_(math.sqrt(max(1, shape[0]))), axes


def cast_params(params, dtype, keep) -> dict:
    """``params`` with every leaf cast to ``dtype``, except those whose
    ``"a/b/c"`` path ``keep(path)`` holds (left as they are)."""

    def walk(tree, prefix):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else str(k)
            out[k] = walk(v, path) if isinstance(v, dict) else (
                v if keep(path) else v.to(dtype))
        return out

    return walk(params, "")


def split_tree(tree):
    """Split {name: (tensor, axes)} nested dict -> (params, specs)."""
    if isinstance(tree, tuple) and len(tree) == 2 and not isinstance(tree[0], dict):
        return tree[0], tree[1]
    params, specs = {}, {}
    for k, v in tree.items():
        params[k], specs[k] = split_tree(v)
    return params, specs


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_rmsnorm(key: ParamInit, d):
    return {"scale": (key.full((d,), 1.0), ("embed",))}


def rmsnorm(p, x, eps=1e-6, zero_centered=True):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    nx = xf * torch.rsqrt(var + eps)
    scale = p["scale"] + 1.0 if zero_centered else p["scale"]
    return (nx * scale).to(x.dtype)


def init_layernorm(key: ParamInit, d):
    return {
        "scale": (key.full((d,), 1.0), ("embed",)),
        "bias": (key.full((d,), 0.0), ("embed",)),
    }


def layernorm(p, x, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope(x, positions, base=10000.0, dims: Optional[int] = None):
    """x: [..., S, H, D]; positions: [..., S]. Rotates the first `dims`."""
    d = x.shape[-1] if dims is None else dims
    half = d // 2
    freq = base ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq  # [..., S, half]
    sin = torch.sin(ang)[..., None, :]  # broadcast over heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half : 2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if d < x.shape[-1]:
        rot = torch.cat([rot, x[..., d:].to(rot.dtype)], dim=-1)
    return rot.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_model: int
    rope_base: float = 10000.0
    qkv_bias: bool = False
    logit_softcap: float = 0.0  # 0 = off (gemma2: 50.0)
    window: int = 0  # 0 = global; >0 = sliding-window local
    query_scale: float = 0.0  # 0 -> 1/sqrt(head_dim)
    causal: bool = True  # False: bidirectional (whisper encoder)


def init_attention(key: ParamInit, cfg: AttnConfig):
    H, K, D, M = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    p = {
        "wq": make_param(key, (M, H, D), ("embed", "heads", "head_dim")),
        "wk": make_param(key, (M, K, D), ("embed", "kv_heads", "head_dim")),
        "wv": make_param(key, (M, K, D), ("embed", "kv_heads", "head_dim")),
        "wo": make_param(key, (H, D, M), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = (key.full((H, D), 0.0), ("heads", "head_dim"))
        p["bk"] = (key.full((K, D), 0.0), ("kv_heads", "head_dim"))
        p["bv"] = (key.full((K, D), 0.0), ("kv_heads", "head_dim"))
    return p


def _softcap(x, cap):
    return torch.tanh(x / cap) * cap if cap else x


def _mask_bias(q_pos, k_pos, window, dtype, causal=True):
    """[..., Sq, Sk] additive mask: validity + causal + sliding window.
    k positions >= 2**29 denote invalid (padded / unwritten cache) slots."""
    kp = k_pos[..., None, :]
    qp = q_pos[..., :, None]
    ok = kp < INVALID_POS
    if causal:
        ok = ok & (kp <= qp)
    if window:
        ok = ok & (kp > (qp - window))
    return torch.where(ok, 0.0, -1e30).to(dtype)


def attention_scores(q, k, v, q_pos, k_pos, cfg: AttnConfig):
    """Reference (materialized-scores) attention.  q: [B,Sq,H,D],
    k/v: [B,Sk,K,D]."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = cfg.query_scale or (1.0 / math.sqrt(D))
    qg = q.reshape(B, Sq, K, G, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    logits = _softcap(logits, cfg.logit_softcap)
    logits = logits + _mask_bias(q_pos, k_pos, cfg.window, torch.float32, cfg.causal)[
        :, None, None
    ]
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, Sq, H, D)


def _pad_blocks(kv_block, pos, *arrays):
    """Pads dim 1 of each array (zeros) and ``pos`` (with PAD_POS) to a
    multiple of ``kv_block``; returns the block count and the padded."""
    Sk = pos.shape[1]
    nb = -(-Sk // kv_block)
    pad = nb * kv_block - Sk
    if pad:
        arrays = [
            torch.cat([a, a.new_zeros((a.shape[0], pad) + tuple(a.shape[2:]))], dim=1)
            for a in arrays
        ]
        pos = torch.cat([pos, pos.new_full((pos.shape[0], pad), PAD_POS)], dim=1)
    return nb, pos, arrays


def attention_blockwise(q, k, v, q_pos, k_pos, cfg: AttnConfig, kv_block=1024):
    """Flash-style online softmax over KV blocks: O(Sq*D + Sq*kv_block)
    live memory.  KV is expanded to H heads first, as in the reference."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = cfg.query_scale or (1.0 / math.sqrt(D))
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    nb, k_pos, (k, v) = _pad_blocks(kv_block, k_pos, k, v)
    m = torch.full((B, H, Sq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)

    def step(m, l, acc, kcur, vcur, pcur):
        s = torch.einsum("bqhd,bshd->bhqs", q, kcur).float() * scale
        s = _softcap(s, cfg.logit_softcap)
        s = s + _mask_bias(q_pos, pcur, cfg.window, torch.float32, cfg.causal)[:, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqs,bshd->bhqd", p, vcur.float())
        return m_new, l, acc

    for j in range(nb):
        blk = slice(j * kv_block, (j + 1) * kv_block)
        m, l, acc = remat(step, m, l, acc, k[:, blk], v[:, blk], k_pos[:, blk])
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _quantize(t):
    """int8 per-(position, head) quantisation: scale = max|t|/127 + 1e-8
    over the last dim; round half to even, as ``jnp.round``."""
    scale = t.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-8
    q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0].float()


def _dequantize(tq, scale, dtype):
    return (tq.float() * scale[..., None]).to(dtype)


def attention(p, x, cfg: AttnConfig, positions, cache=None, blockwise=None):
    """Full attention block (no norms).  x: [B,S,M].

    cache: None for train/prefill-without-cache, or a dict with
    {"k": [B,size,K,D], "v": ..., "pos": [size], "len": 0-d} (plus
    "k_scale"/"v_scale" when int8); it is updated in place and returned
    as the second result (None without a cache).
    """
    B, S, M = x.shape
    use_block = blockwise if blockwise is not None else S >= BLOCKWISE_FROM
    fn = attention_blockwise if use_block else attention_scores
    if TP.active() is not None:
        if cache is None and TP.attn_split(cfg.n_heads, (B, S, cfg.n_heads, cfg.head_dim)):
            return attention_split(p, x, x, cfg, positions, positions, fn, cfg.rope_base), None
        p = TP.whole_tree(p)
    q, k, v = (_project(x, p[f"w{n}"], p[f"b{n}"] if cfg.qkv_bias else None) for n in "qkv")
    q = rope(q, positions, cfg.rope_base)
    k = rope(k, positions, cfg.rope_base)

    if cache is None:
        out = fn(q, k, v, positions, positions, cfg)
        return torch.einsum("bshd,hdm->bsm", out, p["wo"].to(x.dtype)), None

    # Ring-buffer cache: size may be < max context (sliding-window
    # truncation for local layers).  cache["pos"] holds each slot's
    # absolute position; unwritten slots stay at 2**30 (invalid).
    quant = "k_scale" in cache
    size = cache["k"].shape[1]
    cur = cache["len"]

    def write(slots, kk, vv):
        if quant:
            (kq, ks), (vq, vs) = _quantize(kk), _quantize(vv)
            cache["k_scale"].index_copy_(1, slots, ks)
            cache["v_scale"].index_copy_(1, slots, vs)
            kk, vv = kq, vq
        cache["k"].index_copy_(1, slots, kk.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slots, vv.to(cache["v"].dtype))

    def read():
        if quant:
            return (_dequantize(cache["k"], cache["k_scale"], x.dtype),
                    _dequantize(cache["v"], cache["v_scale"], x.dtype))
        return cache["k"].to(x.dtype), cache["v"].to(x.dtype)

    if S == 1:
        # decode: write the new key into slot cur % size, attend over the ring
        slot = (cur % size).reshape(1).long()
        write(slot, k, v)
        cache["pos"].index_copy_(0, slot, cur.reshape(1))
        k_at, v_at = read()
        k_pos = cache["pos"][None].expand(B, size)
        out = attention_scores(q, k_at, v_at, positions, k_pos, cfg)
    else:
        # prefill chunk: queries need *all* in-chunk keys (the ring may be
        # narrower than the chunk), so attend over cache ∪ chunk …
        k_old, v_old = read()
        k_attn = torch.cat([k_old, k], dim=1)
        v_attn = torch.cat([v_old, v], dim=1)
        k_pos = torch.cat([cache["pos"][None].expand(B, size), positions], dim=1)
        out = fn(q, k_attn, v_attn, positions, k_pos, cfg)
        # … then persist only the tail into the ring
        n = min(S, size)
        offs = cur + (S - n) + torch.arange(n, dtype=torch.int32, device=x.device)
        slots = (offs % size).long()
        write(slots, k[:, S - n :], v[:, S - n :])
        cache["pos"].index_copy_(0, slots, offs)
    cache["len"].add_(S)
    return torch.einsum("bshd,hdm->bsm", out, p["wo"].to(x.dtype)), cache


def _project(x, w, b=None):
    y = torch.einsum("bsm,mhd->bshd", x, w.to(x.dtype))
    return y if b is None else y + b.to(x.dtype)


def _kv_for_heads(k, v, h0, Hm, G):
    """The kv heads that query heads ``[h0, h0 + Hm)`` read (``G`` query
    heads a kv head) and their count: a slice when the query heads cover
    whole kv groups, else one kv head a query head."""
    if Hm % G == 0:
        sl = slice(h0 // G, (h0 + Hm) // G)
        return k[:, :, sl], v[:, :, sl], Hm // G
    idx = torch.arange(h0, h0 + Hm, device=k.device) // G
    return k[:, :, idx], v[:, :, idx], Hm


def attention_split(p, xq, xkv, cfg: AttnConfig, q_pos, k_pos, fn, rope_base=None):
    """Attention without a cache, split over the active group's positions
    as the reference constrains q, k and v (``attn_axes``): by query heads
    when the heads divide the "model" axis (k and v by kv heads where those
    divide too, else computed whole and each position reads its heads'),
    else by sequence (``seq_sharded``: each position projects its slice,
    k and v are gathered, its queries attend to all keys).  Self-attention
    (``rope_base`` set, ``xkv is xq``) or cross-attention.  Row-split
    output projections are summed in position order."""
    g = TP.active()
    B, S, _ = xq.shape
    Sk = xkv.shape[1]
    H, K, D, M = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, g.M

    def rot(t, pos):
        return t if rope_base is None else rope(t, pos, rope_base)

    def leaf(tree, name, cut=None):
        """``tree[name]`` (``None`` for a bias the config has not), whole or
        as position ``cut = (dim, m)``'s block."""
        if name[0] == "b" and not cfg.qkv_bias:
            return None
        return TP.whole(tree[name]) if cut is None else TP.block(tree[name], cut[0], cut[1], M)

    if TP.attn_split(H, (B, S, H, D)) == 2:  # heads
        Hm = H // M
        kv_split = TP.model_dim((B, Sk, K, D), ("batch", None, "heads", None)) == 2
        if not kv_split:
            k_all = rot(_project(xkv, leaf(p, "wk"), leaf(p, "bk")), k_pos)
            v_all = _project(xkv, leaf(p, "wv"), leaf(p, "bv"))
        partial = []
        for m in range(M):
            with g.at(m) as dev:
                xm, qp, kp = xq.to(dev), q_pos.to(dev), k_pos.to(dev)
                q = rot(_project(xm, leaf(p, "wq", (1, m)), leaf(p, "bq", (0, m))), qp)
                if kv_split:
                    xk = xkv.to(dev)
                    k = rot(_project(xk, leaf(p, "wk", (1, m)), leaf(p, "bk", (0, m))), kp)
                    v = _project(xk, leaf(p, "wv", (1, m)), leaf(p, "bv", (0, m)))
                    Km = K // M
                else:
                    k, v, Km = _kv_for_heads(k_all.to(dev), v_all.to(dev), m * Hm, Hm, H // K)
                out = fn(q, k, v, qp, kp, dataclasses.replace(cfg, n_heads=Hm, n_kv_heads=Km))
                wo = leaf(p, "wo", (0, m))
                partial.append(torch.einsum("bshd,hdm->bsm", out, wo.to(out.dtype)))
        return TP.psum(partial)

    # seq_sharded: the heads do not divide the "model" axis
    w = {name: leaf(p, name) for name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")}

    def proj(x, name, bname, dev):
        return _project(x, w[name].to(dev), None if w[bname] is None else w[bname].to(dev))

    qs = []
    for m, (lo, hi) in enumerate(TP.shares(S, M)):
        with g.at(m) as dev:
            qs.append(rot(proj(xq[:, lo:hi].to(dev), "wq", "bq", dev), q_pos[:, lo:hi].to(dev)))
    if TP.model_dim((B, Sk, K, D), ("batch", "seq_sharded", None, None)) == 1:
        ks, vs = [], []
        for m, (lo, hi) in enumerate(TP.shares(Sk, M)):
            with g.at(m) as dev:
                xk = xkv[:, lo:hi].to(dev)
                ks.append(rot(proj(xk, "wk", "bk", dev), k_pos[:, lo:hi].to(dev)))
                vs.append(proj(xk, "wv", "bv", dev))
        k, v = TP.gather(ks, 1), TP.gather(vs, 1)
    else:
        k = rot(proj(xkv, "wk", "bk", g.home), k_pos)
        v = proj(xkv, "wv", "bv", g.home)
    ys = []
    for m, (lo, hi) in enumerate(TP.shares(S, M)):
        with g.at(m) as dev:
            out = fn(qs[m], k.to(dev), v.to(dev), q_pos[:, lo:hi].to(dev), k_pos.to(dev), cfg)
            ys.append(torch.einsum("bshd,hdm->bsm", out, w["wo"].to(device=dev, dtype=out.dtype)))
    return TP.gather(ys, 1)


# ---------------------------------------------------------------------------
# MLA (deepseek-v2): compressed KV cache attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_base: float = 10000.0


def init_mla(key: ParamInit, cfg: MLAConfig):
    H = cfg.n_heads
    M = cfg.d_model
    R = cfg.kv_lora_rank
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq": make_param(key, (M, H, qd), ("embed", "heads", "head_dim")),
        "wdkv": make_param(key, (M, R + cfg.qk_rope_dim), ("embed", "mla_rank")),
        "wuk": make_param(key, (R, H, cfg.qk_nope_dim), ("mla_rank", "heads", "head_dim")),
        "wuv": make_param(key, (R, H, cfg.v_head_dim), ("mla_rank", "heads", "head_dim")),
        "wo": make_param(key, (H, cfg.v_head_dim, M), ("heads", "head_dim", "embed")),
    }


def mla_attention(p, x, cfg: MLAConfig, positions, cache=None):
    """Multi-head latent attention; the cache stores only the compressed
    c_kv (rank R) plus the shared rope key — MLA's memory win.  A cache is
    written in place (at ``len``, its start clamped so the chunk fits, as
    ``jax.lax.dynamic_update_slice`` clamps) and returned."""
    B, S, M = x.shape
    H, R = cfg.n_heads, cfg.kv_lora_rank
    if TP.active() is not None:
        qd = cfg.qk_nope_dim + cfg.qk_rope_dim
        if cache is None and TP.attn_split(H, (B, S, H, qd)):
            return mla_split(p, x, cfg, positions), None
        p = TP.whole_tree(p)
    q = torch.einsum("bsm,mhd->bshd", x, p["wq"].to(x.dtype))
    q_nope, q_rope = q[..., : cfg.qk_nope_dim], q[..., cfg.qk_nope_dim :]
    q_rope = rope(q_rope, positions, cfg.rope_base)
    ckv = torch.einsum("bsm,mr->bsr", x, p["wdkv"].to(x.dtype))
    c, k_rope = ckv[..., :R], ckv[..., R:]
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_base)[:, :, 0]

    quant = cache is not None and "ckv_scale" in cache
    cscale = None
    if cache is not None:
        cur = cache["len"]
        Smax = cache["ckv"].shape[1]
        start = torch.clamp(cur, 0, Smax - S)
        idx = (start + torch.arange(S, dtype=torch.int32, device=x.device)).long()
        if quant:
            # int8 latent cache: per-position scale; the absorbed decode
            # folds the scale into the logits/weights so the dequantized
            # cache is never materialized
            s_new = c.abs().amax(dim=-1) / 127.0 + 1e-8
            cq = torch.clamp(torch.round(c / s_new[..., None]), -127, 127).to(torch.int8)
            cache["ckv"].index_copy_(1, idx, cq)
            cache["ckv_scale"].index_copy_(1, idx, s_new.float())
            cscale = cache["ckv_scale"]
        else:
            cache["ckv"].index_copy_(1, idx, c.to(cache["ckv"].dtype))
        cache["krope"].index_copy_(1, idx, k_rope.to(cache["krope"].dtype))
        c, k_rope = cache["ckv"], cache["krope"]
        ar = torch.arange(Smax, dtype=torch.int32, device=x.device)
        k_pos = torch.where(ar < cur + S, ar, PAD_POS)[None].expand(B, Smax)
        cache["len"].add_(S)
    else:
        k_pos = positions
    if not quant:
        c = c.to(x.dtype)
    elif S != 1:
        # prefill/train with a quantized cache: dequantize for the
        # blockwise/materialized paths (decode keeps the folded form)
        c = c.to(x.dtype) * cscale[..., None].to(x.dtype)
        quant = False
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)

    if cache is not None and S == 1:
        # ABSORBED decode (deepseek-v2 §2.1.3): fold W_uk into the query
        # and W_uv into the output so per-position K/V are never
        # materialized — attention runs directly against the rank-R cache.
        q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope, p["wuk"].to(x.dtype))
        c_mat = c.to(x.dtype)
        logits = torch.einsum("bqhr,bsr->bhqs", q_abs, c_mat).float()
        if quant:
            logits = logits * cscale[:, None, None, :]
        logits = (
            logits
            + torch.einsum("bqhd,bsd->bhqs", q_rope, k_rope.to(x.dtype)).float()
        ) * scale
        logits = logits + _mask_bias(positions, k_pos, 0, torch.float32)[:, None]
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        if quant:  # fold the per-position scale into the weights
            w = w * cscale[:, None, None, :].to(x.dtype)
        ctx = torch.einsum("bhqs,bsr->bqhr", w, c_mat)
        out = torch.einsum("bqhr,rhd->bqhd", ctx, p["wuv"].to(x.dtype))
    else:
        out = _mla_core(p, q_nope, q_rope, c, k_rope, positions, k_pos, cfg, scale, x.dtype,
                        S >= BLOCKWISE_FROM)
    y = torch.einsum("bqhd,hdm->bqm", out, p["wo"].to(x.dtype))
    return y, cache


def _mla_core(p, q_nope, q_rope, c, k_rope, q_pos, k_pos, cfg, scale, dtype, blockwise):
    """MLA over expanded keys and values (train and prefill): blockwise, or
    with the scores materialised.  ``p`` holds ``wuk`` and ``wuv`` for the
    query heads given."""
    if blockwise:
        return _mla_blockwise(p, q_nope, q_rope, c, k_rope, q_pos, k_pos, cfg, scale, dtype)
    k_nope = torch.einsum("bsr,rhd->bshd", c, p["wuk"].to(dtype))
    vv = torch.einsum("bsr,rhd->bshd", c, p["wuv"].to(dtype))
    logits = (
        torch.einsum("bqhd,bshd->bhqs", q_nope, k_nope)
        + torch.einsum("bqhd,bsd->bhqs", q_rope, k_rope.to(dtype))
    ).float() * scale
    logits = logits + _mask_bias(q_pos, k_pos, 0, torch.float32)[:, None]
    w = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqs,bshd->bqhd", w, vv)


def mla_split(p, x, cfg: MLAConfig, positions):
    """MLA without a cache, split over the active group's positions as the
    reference constrains ``q_nope`` and ``q_rope`` (``attn_axes``): by
    heads (each position's query, key and value heads from its blocks of
    ``wq``, ``wuk`` and ``wuv``, its rows of ``wo``; partial outputs summed
    in position order), else by query sequence.  The latent ``c`` and the
    rope key (``wdkv``, held whole) are computed once."""
    g = TP.active()
    B, S, _ = x.shape
    H, R, M = cfg.n_heads, cfg.kv_lora_rank, g.M
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    ckv = torch.einsum("bsm,mr->bsr", x, TP.whole(p["wdkv"]).to(x.dtype))
    c, k_rope = ckv[..., :R].to(x.dtype), ckv[..., R:]
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_base)[:, :, 0]
    scale = 1.0 / math.sqrt(qd)
    blockwise = S >= BLOCKWISE_FROM

    def query(xm, wq, pos):
        q = torch.einsum("bsm,mhd->bshd", xm, wq.to(x.dtype))
        return q[..., : cfg.qk_nope_dim], rope(q[..., cfg.qk_nope_dim :], pos, cfg.rope_base)

    if TP.attn_split(H, (B, S, H, qd)) == 2:  # heads
        partial = []
        for m in range(M):
            with g.at(m) as dev:
                pm = {k: TP.block(p[k], 1, m, M) for k in ("wq", "wuk", "wuv")}
                pos = positions.to(dev)
                qn, qr = query(x.to(dev), pm["wq"], pos)
                out = _mla_core(pm, qn, qr, c.to(dev), k_rope.to(dev), pos, pos, cfg, scale,
                                x.dtype, blockwise)
                wo = TP.block(p["wo"], 0, m, M)
                partial.append(torch.einsum("bqhd,hdm->bqm", out, wo.to(x.dtype)))
        return TP.psum(partial)
    w = TP.whole_tree(p)
    ys = []
    for m, (lo, hi) in enumerate(TP.shares(S, M)):
        with g.at(m) as dev:
            pos = positions[:, lo:hi].to(dev)
            qn, qr = query(x[:, lo:hi].to(dev), w["wq"].to(dev), pos)
            pm = {k: w[k].to(dev) for k in ("wuk", "wuv")}
            out = _mla_core(pm, qn, qr, c.to(dev), k_rope.to(dev), pos, positions.to(dev), cfg,
                            scale, x.dtype, blockwise)
            ys.append(torch.einsum("bqhd,hdm->bqm", out, w["wo"].to(device=dev, dtype=x.dtype)))
    return TP.gather(ys, 1)


def _mla_blockwise(p, q_nope, q_rope, c, k_rope, q_pos, k_pos, cfg, scale, dtype,
                   kv_block=1024):
    """Memory-efficient MLA prefill/train over compressed-cache blocks;
    per-position K/V are expanded one block at a time from the rank-R
    latents and consumed at once."""
    B, Sq, H, Dn = q_nope.shape
    Dv = cfg.v_head_dim
    nb, k_pos, (c, k_rope) = _pad_blocks(kv_block, k_pos, c, k_rope)
    wuk = p["wuk"].to(dtype)
    wuv = p["wuv"].to(dtype)
    m = torch.full((B, H, Sq), -1e30, dtype=torch.float32, device=c.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=c.device)
    acc = torch.zeros((B, H, Sq, Dv), dtype=torch.float32, device=c.device)

    def step(m, l, acc, ccur, rcur, pcur):
        kn = torch.einsum("bsr,rhd->bshd", ccur, wuk)
        vv = torch.einsum("bsr,rhd->bshd", ccur, wuv)
        s = (
            torch.einsum("bqhd,bshd->bhqs", q_nope, kn)
            + torch.einsum("bqhd,bsd->bhqs", q_rope, rcur.to(dtype))
        ).float() * scale
        s = s + _mask_bias(q_pos, pcur, 0, torch.float32)[:, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        pexp = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + pexp.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqs,bshd->bhqd", pexp, vv.float())
        return m_new, l, acc

    for j in range(nb):
        blk = slice(j * kv_block, (j + 1) * kv_block)
        m, l, acc = remat(step, m, l, acc, c[:, blk], k_rope[:, blk], k_pos[:, blk])
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(key: ParamInit, d_model, d_ff, gated=True, act="silu"):
    p = {
        "wi": make_param(key, (d_model, d_ff), ("embed", "mlp")),
        "wo": make_param(key, (d_ff, d_model), ("mlp", "embed")),
    }
    if gated:
        p["wg"] = make_param(key, (d_model, d_ff), ("embed", "mlp"))
    return p


# jax.nn.gelu approximates with tanh by default, so both names map to it
_ACT = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


def mlp(p, x, act="silu"):
    """The MLP; under a group whose "model" axis divides its hidden width,
    each position computes its columns of ``wi``/``wg`` and its rows of
    ``wo``, and the partial outputs are summed in position order."""
    g = TP.active()
    if g is not None:
        B, S, _ = x.shape
        if TP.model_dim((B, S, p["wi"].shape[-1]), ("batch", None, "mlp")) == 2:
            partial = []
            for m in range(g.M):
                with g.at(m) as dev:
                    pm = {k: TP.block(w, 0 if k == "wo" else 1, m, g.M) for k, w in p.items()}
                    partial.append(_mlp(pm, x.to(dev), act))
            return TP.psum(partial)
        p = TP.whole_tree(p)
    return _mlp(p, x, act)


def _mlp(p, x, act):
    h = torch.einsum("bsm,mf->bsf", x, p["wi"].to(x.dtype))
    if "wg" in p:
        g = torch.einsum("bsm,mf->bsf", x, p["wg"].to(x.dtype))
        h = _ACT[act](g) * h
    else:
        h = _ACT[act](h)
    return torch.einsum("bsf,fm->bsm", h, p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# MoE with SCV-inspired sorted dispatch
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int  # per-expert hidden
    n_shared: int = 0  # always-on shared experts (deepseek-v2)
    capacity_factor: float = 1.25
    act: str = "silu"


def init_moe(key: ParamInit, cfg: MoEConfig):
    E, M, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": make_param(key, (M, E), ("embed", "expert")),
        "wi": make_param(key, (E, M, F_), ("expert", "embed", "mlp")),
        "wg": make_param(key, (E, M, F_), ("expert", "embed", "mlp")),
        "wo": make_param(key, (E, F_, M), ("expert", "mlp", "embed")),
    }
    if cfg.n_shared:
        p["shared"] = init_mlp(key, M, F_ * cfg.n_shared, gated=True)
    return p


#: ``(record, table)`` while :func:`expert_shares` is active.  A module
#: variable, not a thread-local: for CUDA tensors the backward, and remat's
#: recompute in it, runs on autograd's device thread, which must see it too.
_SHARES: tuple | None = None


@contextlib.contextmanager
def expert_shares(record: list | None = None, table: dict | None = None):
    """Where :func:`moe_sorted`'s aux loss takes its expert shares (each
    expert's fraction of the routed slots) from.  With ``record``, each
    call appends ``(key, counts, n_slots)`` of its own batch; with
    ``table`` (key -> shares), each call takes its shares from the table.
    The SPMD train step records every data group's counts in a forward
    without gradients and gives each group the shares of the whole batch,
    so that the mean of the groups' aux losses is the whole batch's, as in
    the reference.  A layer's key is its router's storage address: the
    same in the recording forward, in the one that records gradients and
    in remat's recompute, which all read one gathered copy of the params.
    The backward must run inside the context, as ``value_and_grad`` runs
    it."""
    global _SHARES
    prev, _SHARES = _SHARES, (record, table)
    try:
        yield
    finally:
        _SHARES = prev


def _expert_shares(router, counts, n_slots):
    record, table = _SHARES or (None, None)
    key = (router.parts[0] if isinstance(router, TP.Split) else router).data_ptr()
    if record is not None:
        record.append((key, counts, n_slots))
    if table is not None:
        return table[key]
    return counts / n_slots


def _route(p, x, cfg: MoEConfig):
    """Router probabilities (fp32) and the renormalised top-k gates.  Under
    a group that splits the experts, each position computes its experts'
    logits and they are gathered: routing stays global."""
    router = p["router"]
    g = TP.active()
    if g is not None and isinstance(router, TP.Split) and router.dim == 1:
        parts = []
        for m in range(g.M):
            with g.at(m) as dev:
                parts.append(torch.einsum("bsm,me->bse", x.to(dev), router.parts[m].to(x.dtype)))
        logits = TP.gather(parts, 2)
    else:
        logits = torch.einsum("bsm,me->bse", x, TP.whole(router).to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    gate, eidx = torch.topk(probs, cfg.top_k, dim=-1)  # [B,S,K], descending
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, eidx


def moe_sorted(p, x, cfg: MoEConfig):
    """Token-grouped (sorted) dispatch — the SCV trick applied to MoE.

    The token->expert assignment matrix is ultra-sparse (top-k of E).  As
    in SCV, the entries are sorted so each expert ("column vector")
    consumes one contiguous block, which turns the expert FFN into dense
    blocked matmuls.  Sorting is per batch row.  Both sorts are stable, as
    ``jnp.argsort`` is: which slots overflow an expert's capacity depends
    on the order within its group.

    Returns (y, aux) with aux = load-balancing loss (Switch-style).
    """
    B, S, M = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = S * K
    cap = int(cfg.capacity_factor * N / E) + 1
    dev = x.device

    probs, gate, eidx = _route(p, x, cfg)
    flat_e = eidx.reshape(B, N)  # expert of each (token, k) slot
    flat_t = torch.arange(S, device=dev)[:, None].expand(S, K).reshape(N)
    order = torch.argsort(flat_e, dim=1, stable=True)  # SCV sort: group by expert
    e_sorted = torch.gather(flat_e, 1, order)
    # rank of each slot within its expert group
    start = torch.searchsorted(
        e_sorted, torch.arange(E, device=dev).expand(B, E).contiguous(), right=False
    )
    rank = torch.arange(N, device=dev)[None] - torch.gather(start, 1, e_sorted)
    keep = rank < cap
    overflow = E * cap
    dst = torch.where(keep, e_sorted * cap + rank, overflow)

    # one gather (token-of-slot composed with the sort order) feeds the
    # scatter into [B, E*cap+1, M] expert buffers; only the overflow slot
    # takes more than one write, and it is discarded
    src_tok = torch.gather(flat_t[None].expand(B, N), 1, order)
    tok_sorted = torch.gather(x, 1, src_tok[..., None].expand(B, N, M))
    buf = x.new_zeros((B, overflow + 1, M))
    buf.scatter_(1, dst[..., None].expand(B, N, M), tok_sorted)
    ebuf = buf[:, :overflow].reshape(B, E, cap, M)

    grp = TP.active()
    if grp is not None and TP.model_dim((B, E, cap, M), ("batch", "expert", None, None)) == 1:
        outs = []  # expert parallel: each position runs its experts' slots
        for m, (lo, hi) in enumerate(TP.shares(E, grp.M)):
            with grp.at(m) as dev:
                pm = {k: TP.block(p[k], 0, m, grp.M) for k in ("wi", "wg", "wo")}
                outs.append(_experts(pm, ebuf[:, lo:hi].to(dev), cfg, x.dtype))
        out = TP.gather(outs, 1)
    else:
        out = _experts(TP.whole_tree({k: p[k] for k in ("wi", "wg", "wo")}), ebuf, cfg, x.dtype)
    out = torch.cat([out.reshape(B, overflow, M), x.new_zeros((B, 1, M))], dim=1)

    # un-sort with one gather: slot of (token, k) = dst[inv]
    inv = torch.argsort(order, dim=1, stable=True)
    slot_of_tok = torch.gather(dst, 1, inv)
    val = torch.gather(out, 1, slot_of_tok[..., None].expand(B, N, M))
    y = torch.einsum("bskm,bsk->bsm", val.reshape(B, S, K, M), gate.to(x.dtype))

    if cfg.n_shared:
        y = y + mlp(p["shared"], x, cfg.act)

    # Switch aux loss: E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))
    counts = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, eidx.reshape(-1), torch.ones(eidx.numel(), dtype=torch.float32, device=dev)
    )
    ce = _expert_shares(p["router"], counts, B * N)
    aux = E * torch.sum(me * ce)
    return y, aux


def _experts(p, ebuf, cfg: MoEConfig, dtype):
    """The gated expert FFNs over their slot buffers ``[B, E, cap, M]``."""
    h = torch.einsum("becm,emf->becf", ebuf, p["wi"].to(dtype))
    g = torch.einsum("becm,emf->becf", ebuf, p["wg"].to(dtype))
    h = _ACT[cfg.act](g) * h
    return torch.einsum("becf,efm->becm", h, p["wo"].to(dtype))


def moe_dense(p, x, cfg: MoEConfig):
    """Dense one-hot dispatch (every expert sees every token, masked):
    FLOP-heavy; the reference for the sorted dispatch.  Under a group it
    computes whole."""
    if TP.active() is not None:
        p = TP.whole_tree(p)
    E = cfg.n_experts
    probs, gate, eidx = _route(p, x, cfg)
    mask = torch.zeros(x.shape[:2] + (E,), dtype=torch.float32, device=x.device)
    mask.scatter_add_(2, eidx, gate)
    h = torch.einsum("bsm,emf->bsef", x, p["wi"].to(x.dtype))
    g = torch.einsum("bsm,emf->bsef", x, p["wg"].to(x.dtype))
    h = _ACT[cfg.act](g) * h
    out = torch.einsum("bsef,efm->bsem", h, p["wo"].to(x.dtype))
    y = torch.einsum("bsem,bse->bsm", out, mask.to(x.dtype))
    if cfg.n_shared:
        y = y + mlp(p["shared"], x, cfg.act)
    me = probs.mean(dim=(0, 1))
    ce = mask.mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)
    return y, aux


# ---------------------------------------------------------------------------
# embeddings / unembed
# ---------------------------------------------------------------------------


def init_embed(key: ParamInit, vocab, d_model, pad_to=256):
    """Embedding table padded to a multiple of ``pad_to`` rows; the true
    vocab is enforced by masking in :func:`unembed_logits`."""
    vpad = -(-vocab // pad_to) * pad_to
    return {"table": make_param(key, (vpad, d_model), ("vocab", "embed"))}


def _vocab_split(t, lead) -> bool:
    """Whether the active group splits activations over the vocabulary
    ``("batch", None, "vocab")`` of table ``t``; ``lead`` is ``(B, S)``."""
    return TP.model_dim(tuple(lead) + (t.shape[0],), ("batch", None, "vocab")) == 2


def embed(p, tokens, scale=False):
    """Rows of the table; under a group that splits the vocabulary, each
    position looks up the tokens among its rows (zeros for the rest) and
    the rows are summed in position order."""
    t = p["table"]
    g = TP.active()
    if g is not None and _vocab_split(t, tokens.shape[:2]):
        rows = []
        for m, (lo, hi) in enumerate(TP.shares(t.shape[0], g.M)):
            with g.at(m) as dev:
                local = tokens.to(dev).long() - lo
                ok = (local >= 0) & (local < hi - lo)
                r = TP.block(t, 0, m, g.M)[local.clamp(0, hi - lo - 1)]
                rows.append(torch.where(ok[..., None], r, torch.zeros((), dtype=r.dtype,
                                                                     device=dev)))
        x = TP.psum(rows)
    else:
        x = TP.whole(t)[tokens]
    if scale:
        x = x * math.sqrt(t.shape[1])
    return x


def _masked_logits(table, x, softcap, true_vocab, start):
    """``x`` against vocabulary rows ``[start, start + n)`` of the table
    (``table`` holds those n rows): float32, softcapped, the padded rows
    past ``true_vocab`` at -1e30."""
    logits = torch.einsum("bsm,vm->bsv", x, table.to(x.dtype))
    logits = _softcap(logits.float(), softcap)
    if true_vocab is not None and true_vocab < start + table.shape[0]:
        logits[..., max(0, true_vocab - start):] = -1e30
    return logits


def _logit_parts(p, x, softcap, true_vocab) -> list:
    """Each position's ``(first row, logits)`` over its vocabulary rows."""
    g = TP.active()
    out = []
    for m, (lo, hi) in enumerate(TP.shares(p["table"].shape[0], g.M)):
        with g.at(m) as dev:
            out.append((lo, _masked_logits(TP.block(p["table"], 0, m, g.M), x.to(dev),
                                           softcap, true_vocab, lo)))
    return out


def unembed_logits(p, x, softcap=0.0, true_vocab=None):
    if TP.active() is not None and _vocab_split(p["table"], x.shape[:2]):
        return TP.gather([lg for _, lg in _logit_parts(p, x, softcap, true_vocab)], 2)
    return _masked_logits(TP.whole(p["table"]), x, softcap, true_vocab, 0)


def _split_xent_sum(p_embed, x, labels, mask, softcap, true_vocab):
    """The masked sum of ``logsumexp - gold`` over vocabulary-split logits:
    the max and the sum of exponentials are combined over the positions in
    position order, and so is the gold logit (from the position holding
    the label's row; the rest add zero)."""
    g = TP.active()
    parts = _logit_parts(p_embed, x, softcap, true_vocab)
    mx = None
    for _, lg in parts:
        cur = lg.detach().amax(dim=-1).to(g.home)
        mx = cur if mx is None else torch.maximum(mx, cur)
    TP.note("all-reduce", mx)
    sums, golds = [], []
    for m, (lo, lg) in enumerate(parts):
        with g.at(m) as dev:
            sums.append(torch.exp(lg - mx.to(dev)[..., None]).sum(dim=-1))
            local = labels.to(dev).long() - lo
            ok = (local >= 0) & (local < lg.shape[-1])
            gold = torch.gather(lg, -1, local.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
            golds.append(torch.where(ok, gold, torch.zeros((), dtype=gold.dtype, device=dev)))
    logz = mx + torch.log(TP.psum(sums))
    return ((logz - TP.psum(golds)) * mask).sum()


def chunked_softmax_xent(p_embed, x, labels, softcap=0.0, chunk=512, mask=None, true_vocab=None):
    """Cross-entropy without materializing [B,S,V] at once: a loop over
    sequence chunks, the last one zero-padded, each chunk's logits
    recomputed in the backward (:func:`remat`)."""
    B, S, M = x.shape
    nchunk = -(-S // chunk)
    pad = nchunk * chunk - S
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    if pad:
        x = torch.cat([x, x.new_zeros((B, pad, M))], dim=1)
        labels = torch.cat([labels, labels.new_zeros((B, pad))], dim=1)
        mask = torch.cat([mask, mask.new_zeros((B, pad))], dim=1)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)

    def step(p_embed, xc, lc, mc):
        if TP.active() is not None and _vocab_split(p_embed["table"], xc.shape[:2]):
            return _split_xent_sum(p_embed, xc, lc, mc, softcap, true_vocab)
        logits = unembed_logits(p_embed, xc, softcap, true_vocab=true_vocab)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
        return ((logz - gold) * mc).sum()

    for i in range(nchunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        tot = tot + remat(step, p_embed, x[:, sl], labels[:, sl], mask[:, sl])
        cnt = cnt + mask[:, sl].sum()
    return tot / torch.clamp(cnt, min=1.0)
