"""The port's LM building blocks (``repro_torch.models.layers``) against the
reference's (``repro.models.layers``, jitted), one test per function, on
the same seeded numpy inputs and weights: drawn over the port's init
shapes, whose logical axes must equal the reference's, and copied into
the port by ``transformer.params_from_jax``.  Float32 throughout;
tolerance: max |Δ| <= 1e-5 x max(1, max |reference|) (sums in another
order), int8 cache leaves equal, positions and lengths equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL
from repro_torch.models.transformer import params_from_jax

TOL = 1e-5


def close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in "iu" or got.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want)
        return
    err = float(np.abs(got.astype(np.float64) - want).max()) if want.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def carry(init_name, jargs, targs, seed=0):
    """Seeded numpy weights over the port's ``init_name(*targs)`` shapes,
    whose specs must be the reference's ``init_name(*jargs)``'s ->
    (reference params, port params on CPU)."""
    tparams, tspecs = TL.split_tree(
        getattr(TL, init_name)(TL.ParamInit(None, torch.device("meta")), *targs))
    box = {}

    def shapes():  # abstract: the reference's specs without drawing
        params, box["specs"] = JL.split_tree(
            getattr(JL, init_name)(jax.random.PRNGKey(0), *jargs))
        return params

    jax.eval_shape(shapes)
    assert tspecs == box["specs"]
    rng = np.random.default_rng(seed)

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                (rng.standard_normal(tuple(v.shape)) / np.sqrt(v.shape[0])).astype(np.float32)
                for k, v in tree.items()}

    host = draw(tparams)
    return jax.tree.map(jnp.asarray, host), params_from_jax(host, device="cpu")


def t(a):
    return torch.from_numpy(np.array(a))


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def positions(B, S, start=0):
    return np.broadcast_to(np.arange(start, start + S, dtype=np.int32)[None], (B, S)).copy()


def both(cfg):
    """The reference's config and the port's, field for field."""
    return cfg, getattr(TL, type(cfg).__name__)(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("zero_centered", [True, False])
def test_norms(rng, zero_centered):
    x = randn(rng, 2, 5, 16)
    p = {"scale": randn(rng, 16), "bias": randn(rng, 16)}
    rms = jax.jit(JL.rmsnorm, static_argnames="zero_centered")
    close(TL.rmsnorm({"scale": t(p["scale"])}, t(x), zero_centered=zero_centered),
          rms({"scale": p["scale"]}, jnp.asarray(x), zero_centered=zero_centered))
    close(TL.layernorm({k: t(v) for k, v in p.items()}, t(x)),
          jax.jit(JL.layernorm)(p, jnp.asarray(x)))


@pytest.mark.parametrize("dims", [None, 6])
def test_rope(rng, dims):
    x = randn(rng, 2, 7, 3, 10)
    pos = positions(2, 7, start=5)
    want = jax.jit(JL.rope, static_argnums=(2, 3))(jnp.asarray(x), jnp.asarray(pos), 500.0, dims)
    close(TL.rope(t(x), t(pos), 500.0, dims), want)


ATTN = [
    dict(),
    dict(logit_softcap=50.0),
    dict(window=4),
    dict(logit_softcap=30.0, window=3, query_scale=0.2),
]


def _qkv(rng, B, Sq, Sk, H, K, D):
    return randn(rng, B, Sq, H, D), randn(rng, B, Sk, K, D), randn(rng, B, Sk, K, D)


@pytest.mark.parametrize("extra", ATTN)
def test_attention_scores(rng, extra):
    cfg, tcfg = both(JL.AttnConfig(n_heads=6, n_kv_heads=2, head_dim=8, d_model=16, **extra))
    q, k, v = _qkv(rng, 2, 9, 9, 6, 2, 8)
    pos = positions(2, 9)
    kpos = pos.copy()
    kpos[:, 1] = 2**30  # an invalid slot
    want = jax.jit(JL.attention_scores, static_argnums=5)(
        *map(jnp.asarray, (q, k, v, pos, kpos)), cfg)
    close(TL.attention_scores(*map(t, (q, k, v, pos, kpos)), tcfg), want)


@pytest.mark.parametrize("extra", ATTN)
def test_attention_blockwise_padded(rng, extra):
    """kv_block 4 over 11 keys: the last block is padded to 2**30."""
    cfg, tcfg = both(JL.AttnConfig(n_heads=4, n_kv_heads=2, head_dim=8, d_model=16, **extra))
    q, k, v = _qkv(rng, 2, 11, 11, 4, 2, 8)
    pos = positions(2, 11)
    want = jax.jit(JL.attention_blockwise, static_argnums=(5, 6))(
        *map(jnp.asarray, (q, k, v, pos, pos)), cfg, 4)
    close(TL.attention_blockwise(*map(t, (q, k, v, pos, pos)), tcfg, kv_block=4), want)
    close(TL.attention_scores(*map(t, (q, k, v, pos, pos)), tcfg), want)


def _attn_cache(B, size, K, D, quant):
    c = {
        "k": np.zeros((B, size, K, D), np.int8 if quant else np.float32),
        "v": np.zeros((B, size, K, D), np.int8 if quant else np.float32),
        "pos": np.full((size,), 2**30, np.int32),
        "len": np.zeros((), np.int32),
    }
    if quant:
        c["k_scale"] = np.zeros((B, size, K), np.float32)
        c["v_scale"] = np.zeros((B, size, K), np.float32)
    return c


def _check_cache(tc, jc):
    assert set(tc) == set(jc)
    for key in jc:
        close(tc[key], jc[key])


J_ATTENTION = jax.jit(JL.attention, static_argnums=2, static_argnames="blockwise")
J_MLA = jax.jit(JL.mla_attention, static_argnums=2)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 5])
def test_attention_ring_cache_prefill_then_decode(rng, quant, window):
    """A 9-token prefill into a ring of 6 slots (narrower than the prompt),
    then 4 decode steps that wrap it; the cache is written in place."""
    cfg, tcfg = both(JL.AttnConfig(n_heads=4, n_kv_heads=2, head_dim=8, d_model=16,
                                   qkv_bias=True, window=window, logit_softcap=20.0))
    jp, tp = carry("init_attention", (cfg,), (tcfg,))
    B, S0 = 2, 9
    jc = {k: jnp.asarray(v) for k, v in _attn_cache(B, 6, 2, 8, quant).items()}
    tc = {k: t(v) for k, v in _attn_cache(B, 6, 2, 8, quant).items()}
    x = randn(rng, B, S0, 16)
    want, jc = J_ATTENTION(jp, jnp.asarray(x), cfg, jnp.asarray(positions(B, S0)), jc)
    got, tc2 = TL.attention(tp, t(x), tcfg, t(positions(B, S0)), tc)
    assert tc2 is tc
    close(got, want)
    _check_cache(tc, jc)
    for step in range(4):
        x1 = randn(rng, B, 1, 16)
        pos = positions(B, 1, start=S0 + step)
        want, jc = J_ATTENTION(jp, jnp.asarray(x1), cfg, jnp.asarray(pos), jc)
        got, _ = TL.attention(tp, t(x1), tcfg, t(pos), tc)
        close(got, want)
        _check_cache(tc, jc)


@pytest.mark.parametrize("blockwise", [False, True])
def test_attention_without_cache(rng, blockwise):
    """Without a cache; ``blockwise=True`` takes the online-softmax path."""
    cfg, tcfg = both(JL.AttnConfig(n_heads=4, n_kv_heads=1, head_dim=8, d_model=16))
    jp, tp = carry("init_attention", (cfg,), (tcfg,), seed=1)
    x = randn(rng, 2, 7, 16)
    pos = positions(2, 7)
    want, _ = J_ATTENTION(jp, jnp.asarray(x), cfg, jnp.asarray(pos), blockwise=blockwise)
    got, cache = TL.attention(tp, t(x), tcfg, t(pos), blockwise=blockwise)
    assert cache is None
    close(got, want)


def _mla():
    return both(JL.MLAConfig(d_model=32, n_heads=4, kv_lora_rank=12, qk_nope_dim=8,
                             qk_rope_dim=4, v_head_dim=6))


def _mla_cache(B, Smax, cfg, quant, length=0):
    c = {
        "ckv": np.zeros((B, Smax, cfg.kv_lora_rank), np.int8 if quant else np.float32),
        "krope": np.zeros((B, Smax, cfg.qk_rope_dim), np.float32),
        "len": np.asarray(length, np.int32),
    }
    if quant:
        c["ckv_scale"] = np.zeros((B, Smax), np.float32)
    return c


@pytest.mark.parametrize("quant", [False, True])
def test_mla_prefill_then_absorbed_decode(rng, quant):
    cfg, tcfg = _mla()
    jp, tp = carry("init_mla", (cfg,), (tcfg,), seed=2)
    B, S0, Smax = 2, 6, 10
    jc = {k: jnp.asarray(v) for k, v in _mla_cache(B, Smax, cfg, quant).items()}
    tc = {k: t(v) for k, v in _mla_cache(B, Smax, cfg, quant).items()}
    x = randn(rng, B, S0, 32)
    want, jc = J_MLA(jp, jnp.asarray(x), cfg, jnp.asarray(positions(B, S0)), jc)
    got, _ = TL.mla_attention(tp, t(x), tcfg, t(positions(B, S0)), tc)
    close(got, want)
    _check_cache(tc, jc)
    for step in range(3):
        x1 = randn(rng, B, 1, 32)
        pos = positions(B, 1, start=S0 + step)
        want, jc = J_MLA(jp, jnp.asarray(x1), cfg, jnp.asarray(pos), jc)
        got, _ = TL.mla_attention(tp, t(x1), tcfg, t(pos), tc)
        close(got, want)
        _check_cache(tc, jc)
    # no cache: the materialized path
    want, _ = J_MLA(jp, jnp.asarray(x), cfg, jnp.asarray(positions(B, S0)))
    got, cache = TL.mla_attention(tp, t(x), tcfg, t(positions(B, S0)))
    assert cache is None
    close(got, want)


def test_mla_write_clamps_at_the_end(rng):
    """A chunk written past ``Smax - S`` lands at ``Smax - S``, as
    ``dynamic_update_slice`` clamps its start; never past ``Smax``."""
    cfg, tcfg = _mla()
    jp, tp = carry("init_mla", (cfg,), (tcfg,), seed=3)
    B, Smax = 1, 8
    jc = {k: jnp.asarray(v) for k, v in _mla_cache(B, Smax, cfg, False, length=6).items()}
    tc = {k: t(v) for k, v in _mla_cache(B, Smax, cfg, False, length=6).items()}
    x = randn(rng, B, 4, 32)
    want, jc = J_MLA(jp, jnp.asarray(x), cfg, jnp.asarray(positions(B, 4, 6)), jc)
    got, _ = TL.mla_attention(tp, t(x), tcfg, t(positions(B, 4, 6)), tc)
    close(got, want)
    _check_cache(tc, jc)


def test_mla_blockwise(rng):
    cfg, tcfg = _mla()
    jp, tp = carry("init_mla", (cfg,), (tcfg,), seed=4)
    B, Sq, Sk = 2, 5, 11
    q_nope, q_rope = randn(rng, B, Sq, 4, 8), randn(rng, B, Sq, 4, 4)
    c, k_rope = randn(rng, B, Sk, 12), randn(rng, B, Sk, 4)
    q_pos = positions(B, Sq, start=6)
    k_pos = positions(B, Sk)
    scale = 1.0 / np.sqrt(12)
    args = (q_nope, q_rope, c, k_rope, q_pos, k_pos)
    want = jax.jit(JL._mla_blockwise, static_argnums=(7, 8, 9, 10))(
        jp, *map(jnp.asarray, args), cfg, scale, jnp.float32, 4)
    got = TL._mla_blockwise(tp, *map(t, args), tcfg, scale, torch.float32, kv_block=4)
    close(got, want)


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_tanh"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp(rng, act, gated):
    jp, tp = carry("init_mlp", (16, 24, gated), (16, 24, gated), seed=5)
    x = randn(rng, 2, 5, 16) * 2
    close(TL.mlp(tp, t(x), act), jax.jit(JL.mlp, static_argnums=2)(jp, jnp.asarray(x), act))


@pytest.mark.parametrize("capacity_factor", [0.5, 1.0, 4.0])
@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_sorted(rng, capacity_factor, n_shared):
    """At 0.5 each expert keeps about half its slots: which ones overflow
    depends on the order within its group, so an unstable sort shows."""
    cfg, tcfg = both(JL.MoEConfig(n_experts=8, top_k=2, d_model=16, d_ff=12,
                                  n_shared=n_shared, capacity_factor=capacity_factor))
    jp, tp = carry("init_moe", (cfg,), (tcfg,), seed=6)
    x = randn(rng, 3, 40, 16)
    want_y, want_aux = jax.jit(JL.moe_sorted, static_argnums=2)(jp, jnp.asarray(x), cfg)
    got_y, got_aux = TL.moe_sorted(tp, t(x), tcfg)
    close(got_y, want_y)
    close(got_aux, want_aux)


@pytest.mark.parametrize("n_shared", [0, 2])
def test_moe_dense_and_sorted_without_drops(rng, n_shared):
    cfg, tcfg = both(JL.MoEConfig(n_experts=6, top_k=3, d_model=16, d_ff=10,
                                  n_shared=n_shared, capacity_factor=2.0))
    # cap = 2 * S * K / E + 1 >= S: nothing drops
    jp, tp = carry("init_moe", (cfg,), (tcfg,), seed=7)
    x = randn(rng, 2, 9, 16)
    want_y, want_aux = jax.jit(JL.moe_dense, static_argnums=2)(jp, jnp.asarray(x), cfg)
    got_y, got_aux = TL.moe_dense(tp, t(x), tcfg)
    close(got_y, want_y)
    close(got_aux, want_aux)
    # with no drops the sorted dispatch computes the dense one's output; the
    # two aux losses differ by definition (slot counts against gate mass)
    sorted_y, sorted_aux = TL.moe_sorted(tp, t(x), tcfg)
    close(sorted_y, want_y)
    close(sorted_aux, jax.jit(JL.moe_sorted, static_argnums=2)(jp, jnp.asarray(x), cfg)[1])


@pytest.mark.parametrize("scale", [False, True])
def test_embed(rng, scale):
    jp, tp = carry("init_embed", (300, 16), (300, 16), seed=8)
    assert tp["table"].shape == (512, 16)
    toks = rng.integers(0, 300, (2, 7)).astype(np.int32)
    want = jax.jit(JL.embed, static_argnames="scale")(jp, jnp.asarray(toks), scale=scale)
    close(TL.embed(tp, t(toks), scale=scale), want)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_unembed_logits_padded_vocab(rng, softcap):
    jp, tp = carry("init_embed", (300, 16), (300, 16), seed=9)
    x = randn(rng, 2, 3, 16) * 4
    want = jax.jit(JL.unembed_logits, static_argnums=(2, 3))(jp, jnp.asarray(x), softcap, 300)
    got = TL.unembed_logits(tp, t(x), softcap, true_vocab=300)
    close(got, want)
    assert (got[..., 300:] == -1e30).all()


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_softmax_xent_padded_chunk(rng, masked):
    """S = 13 in chunks of 5: the last chunk is zero-padded, masked out."""
    jp, tp = carry("init_embed", (300, 16), (300, 16), seed=10)
    x = randn(rng, 2, 13, 16)
    labels = rng.integers(0, 300, (2, 13)).astype(np.int32)
    mask = (rng.random((2, 13)) < 0.8).astype(np.float32) if masked else None
    xent = jax.jit(JL.chunked_softmax_xent, static_argnames=("softcap", "chunk", "true_vocab"))
    want = xent(jp, jnp.asarray(x), jnp.asarray(labels), softcap=30.0, chunk=5,
                mask=None if mask is None else jnp.asarray(mask), true_vocab=300)
    got = TL.chunked_softmax_xent(tp, t(x), t(labels), softcap=30.0, chunk=5,
                                  mask=None if mask is None else t(mask), true_vocab=300)
    close(got, want)
