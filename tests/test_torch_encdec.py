"""The port's Whisper-style encoder-decoder (``repro_torch.models.encdec``)
and the whisper-small arch against the reference's, with the reference's
weights carried over by ``params_from_jax``: the sinusoid, cross-attention
(materialized and, from 2,048 keys, blockwise), the reduced arch's
encoder, teacher-forced decoder, loss, prefill step (the decoder cache
with its cross K/V), decode steps and every cache leaf, the param tree,
its counts and the configs; greedy decode against ``decode_train``.
Float32; tolerance: max |Δ| <= 1e-5 x max(1, max |reference|), positions
and lengths equal, counts and configs exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import encdec as JE
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from test_torch_ssm import DTYPES, _shapes, carried, check_tree, close

ARCH = "whisper-small"
B, FRAMES, STEPS = 2, 12, 3


def _weights():
    cfg = T_ARCHS[ARCH].cfg(reduced=True)
    shapes, _ = T_ARCHS[ARCH].init(None, reduced=True, device="meta")
    return carried(shapes, cfg.d_model)


def _inputs(seed, n_tok):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, FRAMES, 64)).astype(np.float32)
    toks = rng.integers(0, 512, (B, n_tok)).astype(np.int32)
    return frames, toks


def test_sinusoid():
    close(TE._sinusoid(37, 64, torch.float32), JE._sinusoid(37, 64, jnp.float32))


@pytest.mark.parametrize("sk", [16, 2048])  # materialized; blockwise from 2,048 keys
def test_cross_attention(sk):
    jcfg = dataclasses.replace(J_ARCHS[ARCH].cfg(reduced=True), d_model=16, n_heads=2)
    tcfg = dataclasses.replace(T_ARCHS[ARCH].cfg(reduced=True), d_model=16, n_heads=2)
    shapes, _ = TL.split_tree(TE._init_cross(TL.ParamInit(None, torch.device("meta")), tcfg))
    jp, tp = carried(shapes, 16)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 3, 16)).astype(np.float32)
    kv = rng.standard_normal((B, sk, 16)).astype(np.float32)
    want, (jk, jv) = JE.cross_attention(jp, jnp.asarray(x), jnp.asarray(kv), jcfg)
    got, (tk, tv) = TE.cross_attention(tp, torch.from_numpy(x), torch.from_numpy(kv), tcfg)
    close(got, want)
    close(tk, jk)
    got2, _ = TE.cross_attention(tp, torch.from_numpy(x), None, tcfg, precomputed=(tk, tv))
    assert torch.equal(got2, got)


def test_reduced_encode_decode_and_cache():
    from repro.configs.common import SHAPES as J_SHAPES
    from repro_torch.configs.common import SHAPES

    jspec, tspec = J_ARCHS[ARCH], T_ARCHS[ARCH]
    jcfg, tcfg = jspec.cfg(reduced=True), tspec.cfg(reduced=True)
    jp, tp = _weights()
    frames, toks = _inputs(2, STEPS + 7)

    jenc = jax.jit(lambda p, f: JE.encode(p, jcfg, f))(jp, jnp.asarray(frames))
    tenc = TE.encode(tp, tcfg, torch.from_numpy(frames))
    close(tenc, jenc)
    want = jax.jit(lambda p, t, e: JE.decode_train(p, jcfg, t, e))(jp, jnp.asarray(toks), jenc)
    close(TE.decode_train(tp, tcfg, torch.from_numpy(toks), tenc), want)

    # the prefill step: encode, then a decoder cache of 8 slots (the
    # reference's), which the 10 decode steps below fill and wrap
    jc = jspec.make_prefill_step(J_SHAPES["prefill_32k"], reduced=True)(
        jp, {"frames": jnp.asarray(frames)})
    tc = tspec.make_prefill_step(SHAPES["prefill_32k"], reduced=True)(
        tp, {"frames": torch.from_numpy(frames)})
    check_tree(tc, jc)
    jstep = jax.jit(jspec.make_decode_step(J_SHAPES["decode_32k"], reduced=True))
    tstep = tspec.make_decode_step(SHAPES["decode_32k"], reduced=True)
    for s in range(toks.shape[1]):
        pos = np.full((B, 1), s, np.int32)
        want, jc = jstep(jp, jc, {"token": jnp.asarray(toks[:, s : s + 1]),
                                  "pos": jnp.asarray(pos)})
        got, out = tstep(tp, tc, {"token": torch.from_numpy(toks[:, s : s + 1]),
                                  "pos": torch.from_numpy(pos)})
        assert out is tc  # written in place
        close(got, want)
        check_tree(tc, jc)


def test_loss_value():
    jp, tp = _weights()
    frames, toks = _inputs(3, 9)
    want = jax.jit(J_ARCHS[ARCH].loss_fn(reduced=True))(
        jp, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)})
    close(T_ARCHS[ARCH].loss_fn(reduced=True)(
        tp, {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks)}), want)


@pytest.mark.parametrize("reduced", [True, False])
def test_param_tree_counts_and_specs(reduced):
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
    assert TE.cache_specs(tspec.cfg(reduced)) == JE.cache_specs(jspec.cfg(reduced))


def test_full_size_count():
    """whisper-small at full width and depth: 263,359,488 parameters (its
    32,776 decoder positions included)."""
    spec = T_ARCHS[ARCH]
    assert spec.param_count() == J_ARCHS[ARCH].param_count() == 263_359_488
    cfg = spec.cfg()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab) == (
        12, 768, 12, 3072, 51_865)


def test_config_field_for_field():
    jspec, tspec = J_ARCHS[ARCH], T_ARCHS[ARCH]
    for f in dataclasses.fields(jspec):
        if f.name not in ("config", "reduced"):
            assert getattr(tspec, f.name) == getattr(jspec, f.name), f.name
    for c in ("config", "reduced"):
        jc, tc = getattr(jspec, c), getattr(tspec, c)
        assert dataclasses.asdict(tc) == {**dataclasses.asdict(jc), "dtype": DTYPES[jc.dtype]}
        for causal in (True, False):
            assert dataclasses.asdict(tc.attn_cfg(causal)) == dataclasses.asdict(
                jc.attn_cfg(causal))


def test_greedy_decode_matches_decode_train():
    """Greedy decode from ``encode`` (the first row's position embeds every
    row) against ``decode_train`` over the tokens it fed: log-softmax
    within 1e-5 of the largest magnitude and the same picks."""
    spec = T_ARCHS[ARCH]
    cfg = spec.cfg(reduced=True)
    params, _ = spec.init(torch.Generator().manual_seed(0), reduced=True, device="cpu")
    frames, _ = _inputs(6, 1)
    enc = TE.encode(params, cfg, torch.from_numpy(frames))
    n = 6
    cache = TE.init_dec_cache(params, cfg, enc, max_len=n)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    fed, steps = [], []
    for t in range(n):
        fed.append(tok)
        logits, cache = TE.decode_step(params, cfg, tok, cache,
                                       torch.full((B, 1), t, dtype=torch.int32))
        steps.append(logits)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    lp = torch.log_softmax(torch.cat(steps, 1), -1)
    x = TE.decode_train(params, cfg, torch.cat(fed, 1), enc)
    ld = torch.log_softmax(TL.unembed_logits(params["embed"], x, true_vocab=cfg.vocab), -1)
    fin = torch.isfinite(ld)
    assert (lp[fin] - ld[fin]).abs().max().item() <= 1e-5 * ld[fin].abs().max().item()
    assert torch.equal(lp.argmax(-1), ld.argmax(-1))


def test_serving_params_cast_once():
    """``encdec.serving_params`` keeps the norms, the token table and
    ``pos_dec`` in float32 (the forward adds their rows before the cast),
    casts the rest once: the same bits as casting at each use."""
    spec = T_ARCHS[ARCH]
    cfg = dataclasses.replace(spec.cfg(reduced=True), dtype=torch.bfloat16)
    params, _ = spec.init(torch.Generator().manual_seed(3), reduced=True, device="cpu")
    served = TE.serving_params(params, cfg)
    kept = {p for p, t in TT.leaf_paths(served) if t.dtype == torch.float32}
    assert kept == {p for p, _ in TT.leaf_paths(params)
                    if p in ("embed/table", "pos_dec") or p.rsplit("/", 1)[-1] in ("scale", "bias")}
    frames, toks = _inputs(7, 4)
    f = torch.from_numpy(frames)
    e1, e2 = TE.encode(params, cfg, f), TE.encode(served, cfg, f)
    assert torch.equal(e1, e2)
    t = torch.from_numpy(toks)
    assert torch.equal(TE.decode_train(params, cfg, t, e1), TE.decode_train(served, cfg, t, e2))
    c1, c2 = TE.init_dec_cache(params, cfg, e1, 4), TE.init_dec_cache(served, cfg, e2, 4)
    for s in range(3):
        pos = torch.full((B, 1), s, dtype=torch.int32)
        a, _ = TE.decode_step(params, cfg, t[:, s : s + 1], c1, pos)
        b, _ = TE.decode_step(served, cfg, t[:, s : s + 1], c2, pos)
        assert torch.equal(a, b)
