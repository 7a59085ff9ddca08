"""The port's Zamba2-style hybrid (``repro_torch.models.hybrid``) and the
zamba2-2.7b arch against the reference's, with the reference's weights
carried over by ``params_from_jax`` (the ``[n_shared_calls, share_every,
...]`` mamba leaves as they are): the shared block, the reduced arch's
hidden states, loss, prefill step, decode steps past the shared block's
16-slot ring and every state leaf after them, the param tree, its counts,
the state's shapes and specs, and the configs; prefill against recurrent
decode at the reference's own tolerance.  Float32; tolerance: max |Δ| <=
1e-5 x max(1, max |reference|), positions and lengths equal, counts and
configs exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import hybrid as JH
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.models import hybrid as TH
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from test_torch_ssm import DTYPES, _dtypes, _shapes, carried, check_tree, close

ARCH = "zamba2-2.7b"
B, PROMPT, STEPS = 2, 20, 3  # the decode outgrows the reduced window (16): the ring wraps


def _weights():
    cfg = T_ARCHS[ARCH].cfg(reduced=True)
    shapes, _ = T_ARCHS[ARCH].init(None, reduced=True, device="meta")
    return carried(shapes, cfg.d_model)


def _tokens(seed, n):
    return np.random.default_rng(seed).integers(0, 512, (B, n)).astype(np.int32)


def test_shared_block():
    jcfg, tcfg = J_ARCHS[ARCH].cfg(reduced=True), T_ARCHS[ARCH].cfg(reduced=True)
    jp, tp = _weights()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 9, tcfg.d_model)).astype(np.float32)
    x0 = rng.standard_normal((B, 9, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (B, 9))
    want, _ = JH._shared_block(jp["shared"], jnp.asarray(x), jnp.asarray(x0), jcfg,
                               jnp.asarray(pos))
    got, none = TH._shared_block(tp["shared"], torch.from_numpy(x), torch.from_numpy(x0), tcfg,
                                 torch.from_numpy(pos.copy()))
    assert none is None
    close(got, want)


def test_reduced_forward_prefill_decode_and_state():
    from repro.configs.common import SHAPES as J_SHAPES
    from repro_torch.configs.common import SHAPES

    jspec, tspec = J_ARCHS[ARCH], T_ARCHS[ARCH]
    jcfg, tcfg = jspec.cfg(reduced=True), tspec.cfg(reduced=True)
    jp, tp = _weights()
    toks = _tokens(2, PROMPT + STEPS)

    want, _ = jax.jit(lambda p, t: JH.hidden_states(p, jcfg, t))(jp, jnp.asarray(toks))
    got, _ = TH.hidden_states(tp, tcfg, torch.from_numpy(toks))
    close(got, want)

    close(tspec.make_prefill_step(SHAPES["prefill_32k"], reduced=True)(
        tp, {"tokens": torch.from_numpy(toks[:, :PROMPT])}),
        jspec.make_prefill_step(J_SHAPES["prefill_32k"], reduced=True)(
            jp, {"tokens": jnp.asarray(toks[:, :PROMPT])}))

    max_len = PROMPT + STEPS + 2
    jst = JH.init_state(jcfg, B, max_len)
    tst = TH.init_state(tcfg, B, max_len, device="cpu")
    check_tree(tst, jst)
    jstep = jax.jit(jspec.make_decode_step(J_SHAPES["decode_32k"], reduced=True))
    tstep = tspec.make_decode_step(SHAPES["decode_32k"], reduced=True)
    for s in range(PROMPT + STEPS):
        pos = np.full((B, 1), s, np.int32)
        jb = {"token": jnp.asarray(toks[:, s : s + 1]), "pos": jnp.asarray(pos)}
        want, jst = jstep(jp, jst, jb)
        got, out = tstep(tp, tst, {"token": torch.from_numpy(toks[:, s : s + 1]),
                                   "pos": torch.from_numpy(pos)})
        assert out is tst
        if s >= PROMPT:
            close(got, want)
            check_tree(tst, jst)


def test_loss_value():
    jp, tp = _weights()
    toks = _tokens(3, PROMPT + 1)
    want = jax.jit(J_ARCHS[ARCH].loss_fn(reduced=True))(jp, {"tokens": jnp.asarray(toks)})
    close(T_ARCHS[ARCH].loss_fn(reduced=True)(tp, {"tokens": torch.from_numpy(toks)}), want)


@pytest.mark.parametrize("reduced", [True, False])
def test_param_tree_counts_and_state(reduced):
    jspec, tspec = J_ARCHS[ARCH], T_ARCHS[ARCH]
    box = {}

    def init():
        params, box["specs"] = jspec.init(jax.random.PRNGKey(0), reduced)
        return params

    jshapes = jax.eval_shape(init)
    tparams, tspecs = tspec.init(None, reduced, device="meta")
    assert _shapes(tparams) == jax.tree.map(lambda s: tuple(s.shape), jshapes)
    assert tspecs == box["specs"]
    assert all(t.dtype == torch.float32 for _, t in TT.leaf_paths(tparams))
    assert tspec.param_count(reduced) == jspec.param_count(reduced)
    assert tspec.active_param_count(reduced) == jspec.active_param_count(reduced)
    tcfg, jcfg = tspec.cfg(reduced), jspec.cfg(reduced)
    assert TH.state_specs(tcfg) == JH.state_specs(jcfg)
    st = TH.init_state(tcfg, 2, 64, device="meta")
    jst = jax.eval_shape(lambda: JH.init_state(jcfg, 2, 64))
    assert _shapes(st) == jax.tree.map(lambda s: tuple(s.shape), jst)
    assert _dtypes(st) == jax.tree.map(lambda s: s.dtype.name, jst)


def test_full_size_count():
    """zamba2-2.7b at full width and depth: 2,353,860,000 parameters, of
    which the shared block is 117,972,480, called 9 times a token."""
    spec = T_ARCHS[ARCH]
    assert spec.param_count() == J_ARCHS[ARCH].param_count() == 2_353_860_000
    assert spec.active_param_count() == 2_353_860_000
    shapes, _ = spec.init(None, device="meta")
    assert sum(t.numel() for _, t in TT.leaf_paths(shapes["shared"])) == 117_972_480
    cfg = spec.cfg()
    assert (cfg.n_mamba, cfg.d_model, cfg.n_heads, cfg.share_every, cfg.n_shared_calls,
            cfg.d_ff, cfg.vocab, cfg.window) == (54, 2560, 32, 6, 9, 10_240, 32_000, 4096)


def test_config_field_for_field():
    jspec, tspec = J_ARCHS[ARCH], T_ARCHS[ARCH]
    for f in dataclasses.fields(jspec):
        if f.name not in ("config", "reduced"):
            assert getattr(tspec, f.name) == getattr(jspec, f.name), f.name
    for c in ("config", "reduced"):
        jc, tc = getattr(jspec, c), getattr(tspec, c)
        assert dataclasses.asdict(tc) == {**dataclasses.asdict(jc), "dtype": DTYPES[jc.dtype]}
        assert dataclasses.asdict(tc.mamba_cfg) == dataclasses.asdict(jc.mamba_cfg)
        assert dataclasses.asdict(tc.attn_cfg()) == dataclasses.asdict(jc.attn_cfg())


def test_decode_consistency():
    """The port's mirror of the reference's
    ``test_reduced_decode_consistency`` for zamba2-2.7b: recurrent decode
    of every token (positions from the caller) against the forward
    (positions from ``arange``), within the reference's 5e-3."""
    spec = T_ARCHS[ARCH]
    cfg = spec.cfg(reduced=True)
    params, _ = spec.init(torch.Generator().manual_seed(0), reduced=True, device="cpu")
    S = 10
    toks = torch.from_numpy(_tokens(1, S))
    st = TH.init_state(cfg, B, S + 4, device="cpu")
    for t in range(S):
        logits, st = TH.decode_step(params, cfg, toks[:, t : t + 1], st,
                                    torch.full((B, 1), t, dtype=torch.int32))
    x, _ = TH.hidden_states(params, cfg, toks)
    direct = TL.unembed_logits(params["embed"], x[:, -1:], true_vocab=cfg.vocab)
    lp, ld = torch.log_softmax(logits, -1), torch.log_softmax(direct, -1)
    err = torch.where(torch.isfinite(lp), lp - ld, 0.0).abs().max().item()
    assert err < 5e-3, err


def test_serving_params_cast_once():
    """The hybrid's ``serving_params`` (``ssm.serving_params``) keeps norm
    scales and the mamba blocks' float32 leaves, casts the rest once:
    the same bits as casting at each use."""
    spec = T_ARCHS[ARCH]
    cfg = dataclasses.replace(spec.cfg(reduced=True), dtype=torch.bfloat16)
    params, _ = spec.init(torch.Generator().manual_seed(3), reduced=True, device="cpu")
    served = TS.serving_params(params, cfg)
    kept = {p for p, t in TT.leaf_paths(served) if t.dtype == torch.float32}
    assert kept == {p for p, _ in TT.leaf_paths(params)
                    if p.rsplit("/", 1)[-1] in ("scale", "a_log", "dt_bias", "d_skip")}
    toks = torch.from_numpy(_tokens(0, 9))
    assert torch.equal(TH.hidden_states(params, cfg, toks)[0],
                       TH.hidden_states(served, cfg, toks)[0])
    st1, st2 = (TH.init_state(cfg, B, 12, device="cpu") for _ in range(2))
    for t in range(3):
        pos = torch.full((B, 1), t, dtype=torch.int32)
        a, _ = TH.decode_step(params, cfg, toks[:, t : t + 1], st1, pos)
        b, _ = TH.decode_step(served, cfg, toks[:, t : t + 1], st2, pos)
        assert torch.equal(a, b)
