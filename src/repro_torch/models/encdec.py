"""Whisper-style encoder-decoder backbone (arXiv:2212.04356).

Port of ``src/repro/models/encdec.py``.  As in the reference, the
conv/audio frontend is a STUB: the caller feeds precomputed frame
embeddings [B, S_enc, d_model].  The transformer backbone (bidirectional
encoder, causal decoder with cross-attention) is real.  The forward loops
over the layers where the reference scans, and a decoder cache passed to
:func:`decode_step` is written in place and returned.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import _stacked_init, _take, _unstack
from repro_torch.train import tp as TP


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_layers: int  # per side (whisper-small: 12 + 12)
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    max_positions: int = 32768 + 8
    act: str = "gelu"
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    def attn_cfg(self, causal):
        return L.AttnConfig(
            n_heads=self.n_heads,
            n_kv_heads=self.n_heads,
            head_dim=self.head_dim,
            d_model=self.d_model,
            causal=causal,
        )


def _init_cross(key, cfg: EncDecConfig):
    H, D, M = cfg.n_heads, cfg.head_dim, cfg.d_model
    return {
        "wq": L.make_param(key, (M, H, D), ("embed", "heads", "head_dim")),
        "wk": L.make_param(key, (M, H, D), ("embed", "heads", "head_dim")),
        "wv": L.make_param(key, (M, H, D), ("embed", "heads", "head_dim")),
        "wo": L.make_param(key, (H, D, M), ("heads", "head_dim", "embed")),
    }


def _init_enc_layer(key, cfg):
    return {
        "ln1": L.init_layernorm(key, cfg.d_model),
        "attn": L.init_attention(key, cfg.attn_cfg(False)),
        "ln2": L.init_layernorm(key, cfg.d_model),
        "mlp": L.init_mlp(key, cfg.d_model, cfg.d_ff, gated=False),
    }


def _init_dec_layer(key, cfg):
    return {
        "ln1": L.init_layernorm(key, cfg.d_model),
        "attn": L.init_attention(key, cfg.attn_cfg(True)),
        "ln_x": L.init_layernorm(key, cfg.d_model),
        "xattn": _init_cross(key, cfg),
        "ln2": L.init_layernorm(key, cfg.d_model),
        "mlp": L.init_mlp(key, cfg.d_model, cfg.d_ff, gated=False),
    }


def init_encdec(generator: Optional[torch.Generator], cfg: EncDecConfig, device="cuda"):
    """Returns (params, specs), every leaf float32 on ``device``, drawn
    from ``generator`` in turn; ``device="meta"`` gives shapes alone."""
    key = L.ParamInit(generator, resolve_device(device))
    params, specs = L.split_tree(
        {
            "embed": L.init_embed(key, cfg.vocab, cfg.d_model),
            "pos_dec": L.make_param(
                key, (cfg.max_positions, cfg.d_model), ("seq", "embed")
            ),
            "ln_enc": L.init_layernorm(key, cfg.d_model),
            "ln_dec": L.init_layernorm(key, cfg.d_model),
        }
    )
    for name, fn in [("enc", _init_enc_layer), ("dec", _init_dec_layer)]:
        p, s = _stacked_init(lambda k: fn(k, cfg), key, cfg.n_layers)
        params[name] = p
        specs[name] = s
    return params, specs


def serving_params(params, cfg: EncDecConfig) -> dict:
    """``params`` with every weight the forward casts at each use cast to
    ``cfg.dtype`` once (the same bits).  Norm scales and biases stay
    float32, as the forward reads them; so do the token embedding table
    and ``pos_dec``, whose rows the forward adds in float32 before the
    cast (casting the table first would change the sum's bits)."""
    return L.cast_params(params, cfg.dtype, lambda path: path in ("embed/table", "pos_dec")
                         or path.rsplit("/", 1)[-1] in ("scale", "bias"))


def _sinusoid(S, d, dtype, device=None):
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None]
    ang = pos / (10_000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def cross_attention(p, x, kv, cfg: EncDecConfig, precomputed=None):
    """x: [B,Sq,M] queries (decoder); kv: [B,Sk,M] encoder output (or None
    when precomputed k/v are given — the decode-time fast path)."""
    B, Sq, M = x.shape
    if TP.active() is not None and precomputed is None:
        Sk = kv.shape[1]
        pos_q = torch.arange(Sq, dtype=torch.int32, device=x.device)[None].expand(B, Sq)
        pos_k = torch.arange(Sk, dtype=torch.int32, device=x.device)[None].expand(B, Sk)
        fn = L.attention_blockwise if Sk >= L.BLOCKWISE_FROM else L.attention_scores
        if TP.attn_split(cfg.n_heads, (B, Sq, cfg.n_heads, cfg.head_dim)):
            return L.attention_split(p, x, kv, cfg.attn_cfg(False), pos_q, pos_k, fn), None
        p = TP.whole_tree(p)
    q = torch.einsum("bsm,mhd->bshd", x, p["wq"].to(x.dtype))
    if precomputed is None:
        k = torch.einsum("bsm,mhd->bshd", kv, p["wk"].to(x.dtype))
        v = torch.einsum("bsm,mhd->bshd", kv, p["wv"].to(x.dtype))
    else:
        k, v = precomputed
    Sk = k.shape[1]
    pos_q = torch.arange(Sq, dtype=torch.int32, device=x.device)[None].expand(B, Sq)
    pos_k = torch.arange(Sk, dtype=torch.int32, device=x.device)[None].expand(B, Sk)
    acfg = cfg.attn_cfg(False)
    fn = L.attention_blockwise if Sk >= L.BLOCKWISE_FROM else L.attention_scores
    out = fn(q, k, v, pos_q, pos_k, acfg)
    y = torch.einsum("bshd,hdm->bsm", out, p["wo"].to(x.dtype))
    return y, (k, v)


def encode(params, cfg: EncDecConfig, frames):
    """frames: [B, S_enc, d_model] stub frontend embeddings."""
    x = (frames + _sinusoid(frames.shape[1], cfg.d_model, frames.dtype, frames.device)[None]
         ).to(cfg.dtype)
    B, S, _ = x.shape
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    acfg = cfg.attn_cfg(False)

    def body(x, lp):
        a, _ = L.attention(lp["attn"], L.layernorm(lp["ln1"], x), acfg, pos)
        x = x + a
        return x + L.mlp(lp["mlp"], L.layernorm(lp["ln2"], x), cfg.act)

    for lp in _unstack(params["enc"], cfg.n_layers):
        x = L.remat(body, x, lp)
    return L.layernorm(params["ln_enc"], x)


def decode_train(params, cfg: EncDecConfig, tokens, enc_out):
    """Teacher-forced decoder pass.  tokens: [B, S_dec]."""
    B, S = tokens.shape
    x = (L.embed(params["embed"], tokens) + params["pos_dec"][:S][None]).to(cfg.dtype)
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    acfg = cfg.attn_cfg(True)

    def body(x, lp, enc_out):
        a, _ = L.attention(lp["attn"], L.layernorm(lp["ln1"], x), acfg, pos)
        x = x + a
        a, _ = cross_attention(lp["xattn"], L.layernorm(lp["ln_x"], x), enc_out, cfg)
        x = x + a
        return x + L.mlp(lp["mlp"], L.layernorm(lp["ln2"], x), cfg.act)

    for lp in _unstack(params["dec"], cfg.n_layers):
        x = L.remat(body, x, lp, enc_out)
    return L.layernorm(params["ln_dec"], x)


def train_loss(params, cfg: EncDecConfig, batch):
    """Next-token cross-entropy of the decoder."""
    enc_out = encode(params, cfg, batch["frames"])
    x = decode_train(params, cfg, batch["tokens"][:, :-1], enc_out)
    return L.chunked_softmax_xent(params["embed"], x, batch["tokens"][:, 1:],
                                  true_vocab=cfg.vocab)


def init_dec_cache(params, cfg: EncDecConfig, enc_out, max_len):
    """Self-attn ring caches + precomputed cross K/V per layer, on
    ``enc_out``'s device."""
    B = enc_out.shape[0]
    H, D = cfg.n_heads, cfg.head_dim
    dev = enc_out.device
    xa = params["dec"]["xattn"]
    xk = torch.einsum("bsm,lmhd->lbshd", enc_out, xa["wk"].to(enc_out.dtype))
    xv = torch.einsum("bsm,lmhd->lbshd", enc_out, xa["wv"].to(enc_out.dtype))
    return {
        "k": torch.zeros((cfg.n_layers, B, max_len, H, D), dtype=cfg.dtype, device=dev),
        "v": torch.zeros((cfg.n_layers, B, max_len, H, D), dtype=cfg.dtype, device=dev),
        "pos": torch.full((cfg.n_layers, max_len), L.PAD_POS, dtype=torch.int32, device=dev),
        "len": torch.zeros((cfg.n_layers,), dtype=torch.int32, device=dev),
        "xk": xk,
        "xv": xv,
    }


def decode_step(params, cfg: EncDecConfig, token, cache, pos):
    """One decoder token.  token: [B,1]; pos: [B,1] (the first row's
    position embeds every row, as in the reference).  ``cache`` is written
    in place and returned."""
    x = (L.embed(params["embed"], token) + params["pos_dec"][pos[0].long()][None]).to(cfg.dtype)
    acfg = cfg.attn_cfg(True)
    for i in range(cfg.n_layers):
        lp = _take(params["dec"], i)
        c = {k: cache[k][i] for k in ("k", "v", "pos", "len")}
        a, _ = L.attention(lp["attn"], L.layernorm(lp["ln1"], x), acfg, pos, cache=c)
        x = x + a
        a, _ = cross_attention(lp["xattn"], L.layernorm(lp["ln_x"], x), None, cfg,
                               precomputed=(cache["xk"][i], cache["xv"][i]))
        x = x + a
        x = x + L.mlp(lp["mlp"], L.layernorm(lp["ln2"], x), cfg.act)
    x = L.layernorm(params["ln_dec"], x)
    logits = L.unembed_logits(params["embed"], x, true_vocab=cfg.vocab)
    return logits, cache


def cache_specs(cfg: EncDecConfig):
    return {
        "k": ("layers", "batch", "seq", "heads", "head_dim"),
        "v": ("layers", "batch", "seq", "heads", "head_dim"),
        "pos": ("layers", "seq"),
        "len": ("layers",),
        "xk": ("layers", "batch", "seq", "heads", "head_dim"),
        "xv": ("layers", "batch", "seq", "heads", "head_dim"),
    }
