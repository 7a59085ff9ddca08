"""Mamba2 — state-space duality (SSD) blocks (arXiv:2405.21060).

Port of ``src/repro/models/ssm.py``.  Training/prefill uses the chunked
SSD algorithm (intra-chunk quadratic + inter-chunk state recurrence, a
loop over chunks where the reference scans); decode is the O(1)
recurrent update.  Where the reference constrains the heads
(``constrain(..., "mamba_heads")``), a data group of the SPMD train step
splits a block over its "model" positions by heads (``train/tp.py``,
:func:`mamba2_split`); without a group a block computes whole.

A decode state passed to :func:`mamba2_forward` (or to
:func:`mamba2_lm_decode`) is written in place and returned, as the
decoder LM's caches are: the reference threads a new one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import _stacked_init, _take, _unstack
from repro_torch.train import tp as TP


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def init_mamba2(key: L.ParamInit, cfg: Mamba2Config):
    Din, H, G, N = cfg.d_inner, cfg.n_heads, cfg.n_groups, cfg.d_state
    d_in_proj = 2 * Din + 2 * G * N + H
    return {
        "w_in": L.make_param(key, (cfg.d_model, d_in_proj), ("embed", "inner")),
        "conv_w": L.make_param(key, (cfg.conv_width, cfg.conv_dim), ("conv", "inner")),
        "conv_b": (key.full((cfg.conv_dim,), 0.0), ("inner",)),
        "a_log": (key.full((H,), 0.0), ("mamba_heads",)),
        "dt_bias": (key.full((H,), 0.0), ("mamba_heads",)),
        "d_skip": (key.full((H,), 1.0), ("mamba_heads",)),
        "norm": L.init_rmsnorm(key, Din),
        "w_out": L.make_param(key, (Din, cfg.d_model), ("inner", "embed")),
    }


#: Leaves the forward reads in float32 whatever the compute dtype.
FLOAT32_LEAVES = ("a_log", "dt_bias", "d_skip")


def _segsum(x):
    """log-decay matrix: L[..., i, j] = sum_{k=j+1..i} x[..., k] (i >= j)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    Lm = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, Lm, -torch.inf)


def ssd_chunked(x, dt, a_log, b, c, chunk):
    """SSD over chunks.  Shapes:
      x: [B,S,H,P]; dt: [B,S,H]; a_log: [H]; b,c: [B,S,G,N].
    Returns y: [B,S,H,P] and final state [B,H,P,N].  With one group (the
    zoo's configs) B and C enter the products once, broadcast over the
    heads by the products themselves, where the reference broadcasts them
    to every head first: the same sums.
    """
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    Q = chunk
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    rep = H // G  # heads per B/C group
    # fold dt into x; decay per step
    xd = x * dt[..., None]
    adt = -torch.exp(a_log)[None, None, :] * dt  # [B,S',H] (negative)

    def to_chunks(t):  # [B, nc*Q, ...] -> [nc, B, Q, ...]
        return t.reshape((B, nc, Q) + tuple(t.shape[2:])).transpose(0, 1)

    xc, ac, bc, cc = to_chunks(xd), to_chunks(adt), to_chunks(b), to_chunks(c)
    acum = torch.cumsum(ac, dim=2)  # [nc,B,Q,H]

    # intra-chunk (diagonal) term
    Lmat = torch.exp(_segsum(ac.permute(0, 1, 3, 2)))  # [nc,B,H,Q,Q]
    if G == 1:
        b1, c1 = bc[:, :, :, 0], cc[:, :, :, 0]  # [nc,B,Q,N]
        scores = torch.einsum("nbqs,nbks->nbqk", c1, b1)[:, :, None]  # [nc,B,1,Q,Q]
    else:
        bh = torch.repeat_interleave(bc, rep, dim=3)
        ch = torch.repeat_interleave(cc, rep, dim=3)
        scores = torch.einsum("nbqhs,nbkhs->nbhqk", ch, bh)  # q,k within chunk
    y_diag = torch.einsum("nbhqk,nbkhp->nbqhp", scores * Lmat, xc)

    # end-of-chunk states
    decay_states = torch.exp(acum[:, :, -1:, :] - acum)  # [nc,B,Q,H]
    xs = xc * decay_states[..., None]
    if G == 1:
        states = torch.einsum("nbqhp,nbqs->nbhps", xs, b1)
    else:
        states = torch.einsum("nbqhs,nbqhp->nbhps", bh, xs)
    chunk_decay = torch.exp(acum[:, :, -1, :])  # [nc,B,H]

    # the recurrence over chunks: each chunk sees the state *entering* it
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    h_in = []
    for n in range(nc):
        h_in.append(h)
        h = h * chunk_decay[n].float()[..., None, None] + states[n].float()
    h_in = torch.stack(h_in)  # [nc,B,H,P,N]

    # contribution of entering state to each position
    state_decay = torch.exp(acum)  # [nc,B,Q,H]
    if G == 1:
        y_off = torch.einsum("nbqs,nbhps->nbqhp", c1, h_in.to(c1.dtype))
    else:
        y_off = torch.einsum("nbqhs,nbhps->nbqhp", ch, h_in.to(ch.dtype))
    y_off = y_off * state_decay[..., None]
    y = (y_diag + y_off).transpose(0, 1).reshape(B, nc * Q, H, P)
    return y[:, :S], h


def _heads(t, H):
    """[B, G, N] per-group rows as [B, H, N]: broadcast with one group,
    each group repeated over its heads otherwise."""
    G = t.shape[1]
    return t.expand(t.shape[0], H, t.shape[2]) if G == 1 else torch.repeat_interleave(
        t, H // G, dim=1)


def mamba2_forward(p, u, cfg: Mamba2Config, state=None):
    """u: [B,S,M].  state=None for train/prefill; for decode pass
    {"ssm": [B,H,P,N], "conv": [B,W-1,conv_dim]} and S must be 1: it is
    written in place and returned.  Returns (y, new_state_or_None)."""
    B, S, M = u.shape
    Din, H, G, N, P = cfg.d_inner, cfg.n_heads, cfg.n_groups, cfg.d_state, cfg.headdim
    if TP.active() is not None and state is None:
        if TP.model_dim((B, S, H, P), ("batch", None, "mamba_heads", None)) == 2:
            return mamba2_split(p, u, cfg), None
        p = TP.whole_tree(p)
    zxbcdt = torch.einsum("bsm,md->bsd", u, p["w_in"].to(u.dtype))
    z, xbc, dt_raw = torch.split(zxbcdt, [Din, cfg.conv_dim, H], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # [B,S,H]

    w = p["conv_w"].to(u.dtype)  # [W, conv_dim]
    if state is None:
        pad = u.new_zeros((B, cfg.conv_width - 1, cfg.conv_dim))
        xbc_pad = torch.cat([pad, xbc], dim=1)
    else:
        xbc_pad = torch.cat([state["conv"].to(u.dtype), xbc], dim=1)
        state["conv"].copy_(xbc_pad[:, -(cfg.conv_width - 1):])
    xbc = _conv(xbc_pad, w, p["conv_b"].to(u.dtype), S)

    x, b, c = torch.split(xbc, [Din, G * N, G * N], dim=-1)
    x = x.reshape(B, S, H, P)
    b = b.reshape(B, S, G, N)
    c = c.reshape(B, S, G, N)

    if state is None:
        y, _ = ssd_chunked(x.float(), dt, p["a_log"], b.float(), c.float(), cfg.chunk)
    else:
        # recurrent step (S == 1): h = h*exp(a*dt) + dt * B x^T ; y = C h
        adt = torch.exp(-torch.exp(p["a_log"])[None, :] * dt[:, 0])  # [B,H]
        bh = _heads(b[:, 0], H).float()
        ch = _heads(c[:, 0], H).float()
        xdt = (x[:, 0] * dt[:, 0, :, None]).float()  # [B,H,P]
        h = state["ssm"] * adt[..., None, None] + xdt[..., :, None] * bh[:, :, None, :]
        state["ssm"].copy_(h)
        y = torch.einsum("bhn,bhpn->bhp", ch, h)[:, None]
    y = y + x.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(B, S, Din).to(u.dtype)
    y = L.rmsnorm(p["norm"], y * F.silu(z))
    out = torch.einsum("bsd,dm->bsm", y, p["w_out"].to(u.dtype))
    return out, state


def _conv(xbc_pad, w, bias, S):
    """Causal depthwise conv as W shifted scaled adds (no W-x window copy),
    then the bias and SiLU; ``xbc_pad`` holds ``W - 1`` steps before the
    ``S`` it outputs."""
    acc = xbc_pad[:, 0:S] * w[0]
    for j in range(1, w.shape[0]):
        acc = acc + xbc_pad[:, j : j + S] * w[j]
    return F.silu(acc + bias)


def mamba2_split(p, u, cfg: Mamba2Config):
    """A Mamba2 block without a state, split over the active group's
    positions by heads, as the reference constrains ``x`` and the chunks
    (``"mamba_heads"``).  ``w_in``'s columns are packed ``[z | x | B | C |
    dt]`` and stored cut evenly over "model", across those blocks; each
    position cuts its compute layout from the stored parts (its heads' z,
    x and dt columns, its x channels of ``conv_w``/``conv_b``), in position
    order.  B and C (one group: every head reads them) are projected and
    convolved once.  The gated RMSNorm over ``d_inner`` sums the positions'
    squares in position order; the row-split ``w_out`` products are summed
    so too."""
    g = TP.active()
    B, S, _ = u.shape
    Din, H, G, N, P, W = cfg.d_inner, cfg.n_heads, cfg.n_groups, cfg.d_state, cfg.headdim, \
        cfg.conv_width
    M, dt = g.M, u.dtype
    Hm = H // M
    Dm, GN = Hm * P, G * N
    bc_cols = [(2 * Din, 2 * Din + 2 * GN)]
    w_bc = TP.take(p["w_in"], -1, bc_cols, g.home)
    bc = torch.einsum("bsm,md->bsd", u, w_bc.to(dt))
    conv_bc = [(Din, Din + 2 * GN)]
    pad = u.new_zeros((B, W - 1, 2 * GN))
    bc = _conv(torch.cat([pad, bc], dim=1), TP.take(p["conv_w"], -1, conv_bc, g.home).to(dt),
               TP.take(p["conv_b"], -1, conv_bc, g.home).to(dt), S)
    b = bc[..., :GN].reshape(B, S, G, N).float()
    c = bc[..., GN:].reshape(B, S, G, N).float()
    gated, squares = [], []
    for m in range(M):
        with g.at(m) as dev:
            z0, x0, d0 = m * Dm, Din + m * Dm, 2 * Din + 2 * GN + m * Hm
            w = TP.take(p["w_in"], -1, [(z0, z0 + Dm), (x0, x0 + Dm), (d0, d0 + Hm)], dev)
            z, x, dt_raw = torch.split(torch.einsum("bsm,md->bsd", u.to(dev), w.to(dt)),
                                       [Dm, Dm, Hm], dim=-1)
            dtm = F.softplus(dt_raw.float() + TP.block(p["dt_bias"], 0, m, M))
            ch = [(m * Dm, (m + 1) * Dm)]
            x = _conv(torch.cat([u.new_zeros((B, W - 1, Dm), device=dev), x], dim=1),
                      TP.take(p["conv_w"], -1, ch, dev).to(dt),
                      TP.take(p["conv_b"], -1, ch, dev).to(dt), S).reshape(B, S, Hm, P)
            y, _ = ssd_chunked(x.float(), dtm, TP.block(p["a_log"], 0, m, M), b.to(dev),
                               c.to(dev), cfg.chunk)
            y = y + x.float() * TP.block(p["d_skip"], 0, m, M)[None, None, :, None]
            gz = y.reshape(B, S, Dm).to(dt) * F.silu(z)
            gated.append(gz)
            squares.append(gz.float().square().sum(-1, keepdim=True))
    rms = torch.rsqrt(TP.psum(squares) / Din + 1e-6)
    partial = []
    for m in range(M):
        with g.at(m) as dev:
            scale = TP.block(p["norm"]["scale"], 0, m, M) + 1.0
            yn = (gated[m].float() * rms.to(dev) * scale).to(dt)
            partial.append(torch.einsum("bsd,dm->bsm", yn, TP.block(p["w_out"], 0, m, M).to(dt)))
    return TP.psum(partial)


def init_mamba2_state(cfg: Mamba2Config, batch, dtype=torch.float32, device="cuda", lead=()):
    """Zero decode state, with ``lead`` stacking dims in front."""
    dev = resolve_device(device)
    return {
        "ssm": torch.zeros(lead + (batch, cfg.n_heads, cfg.headdim, cfg.d_state),
                           dtype=torch.float32, device=dev),
        "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, cfg.conv_dim), dtype=dtype,
                            device=dev),
    }


def serving_params(params, cfg) -> dict:
    """``params`` with every weight the forward casts at each use cast to
    ``cfg.dtype`` once: the same bits, at half the bytes for bf16.  Norm
    scales and :data:`FLOAT32_LEAVES` stay float32, as the forward reads
    them.  Serves the pure-Mamba2 LM and the hybrid."""
    return L.cast_params(params, cfg.dtype, lambda path: path.rsplit("/", 1)[-1] in (
        "scale",) + FLOAT32_LEAVES)


# ---------------------------------------------------------------------------
# Pure-Mamba2 LM (mamba2-780m)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mamba2LMConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    d_state: int = 128
    headdim: int = 64
    dtype: torch.dtype = torch.bfloat16

    @property
    def block_cfg(self) -> Mamba2Config:
        return Mamba2Config(
            d_model=self.d_model, d_state=self.d_state, headdim=self.headdim
        )


def init_mamba2_lm(generator: Optional[torch.Generator], cfg: Mamba2LMConfig, device="cuda"):
    """Returns (params, specs), every leaf float32 on ``device``, drawn
    from ``generator`` in turn; ``device="meta"`` gives shapes alone."""
    key = L.ParamInit(generator, resolve_device(device))
    params, specs = L.split_tree(
        {
            "embed": L.init_embed(key, cfg.vocab, cfg.d_model),
            "ln_final": L.init_rmsnorm(key, cfg.d_model),
        }
    )
    bp, bs = _stacked_init(
        lambda k: {"ln": L.init_rmsnorm(k, cfg.d_model), "mamba": init_mamba2(k, cfg.block_cfg)},
        key,
        cfg.n_layers,
    )
    params["blocks"] = bp
    specs["blocks"] = bs
    return params, specs


def mamba2_lm_hidden(params, cfg: Mamba2LMConfig, tokens, state=None):
    """Embedding + every block.  ``state`` (decode) is written in place and
    returned; None runs the chunked form."""
    x = L.embed(params["embed"], tokens).to(cfg.dtype)
    mcfg = cfg.block_cfg

    def block(x, lp, st=None):
        y, _ = mamba2_forward(lp["mamba"], L.rmsnorm(lp["ln"], x), mcfg, state=st)
        return x + y

    for i, lp in enumerate(_unstack(params["blocks"], cfg.n_layers)):
        if state is None:  # each block recomputed in the backward
            x = L.remat(block, x, lp)
        else:
            x = block(x, lp, _take(state, i))
    return L.rmsnorm(params["ln_final"], x), state


def mamba2_lm_loss(params, cfg: Mamba2LMConfig, batch):
    """Next-token cross-entropy."""
    x, _ = mamba2_lm_hidden(params, cfg, batch["tokens"][:, :-1])
    return L.chunked_softmax_xent(params["embed"], x, batch["tokens"][:, 1:],
                                  true_vocab=cfg.vocab)


def init_mamba2_lm_state(cfg: Mamba2LMConfig, batch, device="cuda"):
    return init_mamba2_state(cfg.block_cfg, batch, cfg.dtype, device, lead=(cfg.n_layers,))


def mamba2_lm_state_specs(cfg: Mamba2LMConfig):
    return {
        "ssm": ("layers", "batch", "mamba_heads", "head_dim", "state"),
        "conv": ("layers", "batch", "conv", "inner"),
    }


def mamba2_lm_decode(params, cfg: Mamba2LMConfig, token, state, pos=None):
    """One token.  ``state`` is written in place and returned."""
    x, state = mamba2_lm_hidden(params, cfg, token, state=state)
    return L.unembed_logits(params["embed"], x, true_vocab=cfg.vocab), state
