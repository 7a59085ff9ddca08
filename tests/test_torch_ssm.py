"""The port's Mamba2 (``repro_torch.models.ssm``) and the mamba2-780m arch
against the reference's: ``_segsum``, ``ssd_chunked`` across several
chunks (the last one padded), ``mamba2_forward`` chunked and one
recurrent step with one and two B/C groups, and the reduced arch's hidden
states, loss, prefill step, decode steps and every state leaf, with the
reference's weights carried over by ``params_from_jax``; the param tree,
its counts and the configs; prefill against recurrent decode at the
reference's own tolerance.  Float32; tolerance: max |Δ| <= 1e-5 x max(1,
max |reference|) (the same sums in another order), counts and configs
exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import ssm as JS
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT

ARCH = "mamba2-780m"
TOL = 1e-5
B, PROMPT, STEPS = 2, 20, 3
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def close(got, want, tol=TOL):
    got = got.detach().cpu().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want)
        return
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def check_tree(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            check_tree(got[k], want[k])
        else:
            close(got[k], want[k])


def numpy_weights(tree, rng, d_model):
    """Seeded numpy weights over ``tree``'s shapes, every leaf drawn (norm
    scales, decay rates, skips and biases too), so every leaf moves the
    output."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = numpy_weights(v, rng, d_model)
        else:
            w = rng.standard_normal(tuple(v.shape)).astype(np.float32)
            small = k in ("scale", "bias", "a_log", "dt_bias", "d_skip", "conv_b")
            out[k] = w * np.float32(0.1 if small else d_model ** -0.5)
    return out


def carried(shapes, d_model, seed=0):
    """The same numpy weights as the reference's arrays and the port's
    tensors."""
    host = numpy_weights(shapes, np.random.default_rng(seed), d_model)
    return jax.tree.map(jnp.asarray, host), TT.params_from_jax(host, device="cpu")


def ssd_inputs(G, S, seed=0):
    rng = np.random.default_rng(seed)
    H, P, N = 4, 3, 5
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    a_log = (0.5 * rng.standard_normal(H)).astype(np.float32)
    b = rng.standard_normal((B, S, G, N)).astype(np.float32)
    c = rng.standard_normal((B, S, G, N)).astype(np.float32)
    return x, dt, a_log, b, c


def test_segsum():
    x = np.random.default_rng(0).standard_normal((2, 3, 7)).astype(np.float32)
    want = np.asarray(JS._segsum(jnp.asarray(x)))
    got = TS._segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= TOL * max(1.0, np.abs(want[fin]).max())


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("S", [10, 8, 3])  # three chunks, the last padded; two whole; one
def test_ssd_chunked(G, S):
    args = ssd_inputs(G, S)
    y_want, h_want = JS.ssd_chunked(*map(jnp.asarray, args), chunk=4)
    y_got, h_got = TS.ssd_chunked(*map(torch.from_numpy, args), chunk=4)
    close(y_got, y_want)
    close(h_got, h_want)


@pytest.mark.parametrize("G", [1, 2])
def test_mamba2_forward_chunked_and_recurrent(G):
    jcfg = JS.Mamba2Config(d_model=16, d_state=8, headdim=8, n_groups=G, chunk=4)
    tcfg = TS.Mamba2Config(d_model=16, d_state=8, headdim=8, n_groups=G, chunk=4)
    shapes, specs = TL.split_tree(TS.init_mamba2(TL.ParamInit(None, torch.device("meta")), tcfg))
    jp, tp = carried(shapes, 16)
    rng = np.random.default_rng(1)
    u = rng.standard_normal((B, 10, 16)).astype(np.float32)
    want, _ = JS.mamba2_forward(jp, jnp.asarray(u), jcfg)
    got, none = TS.mamba2_forward(tp, torch.from_numpy(u), tcfg)
    assert none is None
    close(got, want)

    st = {"ssm": rng.standard_normal((B, tcfg.n_heads, 8, 8)).astype(np.float32),
          "conv": rng.standard_normal((B, 3, tcfg.conv_dim)).astype(np.float32)}
    want, jst = JS.mamba2_forward(jp, jnp.asarray(u[:, :1]), jcfg,
                                  state=jax.tree.map(jnp.asarray, st))
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    got, out = TS.mamba2_forward(tp, torch.from_numpy(u[:, :1]), tcfg, state=tst)
    assert out is tst  # written in place
    close(got, want)
    check_tree(tst, jst)


def _weights(arch):
    cfg = T_ARCHS[arch].cfg(reduced=True)
    shapes, _ = T_ARCHS[arch].init(None, reduced=True, device="meta")
    return carried(shapes, cfg.d_model)


def test_reduced_forward_prefill_decode_and_state():
    from repro.configs.common import SHAPES as J_SHAPES
    from repro_torch.configs.common import SHAPES

    jspec, tspec = J_ARCHS[ARCH], T_ARCHS[ARCH]
    jcfg, tcfg = jspec.cfg(reduced=True), tspec.cfg(reduced=True)
    jp, tp = _weights(ARCH)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (B, PROMPT + STEPS)).astype(np.int32)

    want, _ = jax.jit(lambda p, t: JS.mamba2_lm_hidden(p, jcfg, t))(jp, jnp.asarray(toks))
    got, _ = TS.mamba2_lm_hidden(tp, tcfg, torch.from_numpy(toks))
    close(got, want)

    batch = {"tokens": toks[:, :PROMPT]}
    close(tspec.make_prefill_step(SHAPES["prefill_32k"], reduced=True)(
        tp, {"tokens": torch.from_numpy(batch["tokens"])}),
        jspec.make_prefill_step(J_SHAPES["prefill_32k"], reduced=True)(
            jp, {"tokens": jnp.asarray(batch["tokens"])}))

    jst = JS.init_mamba2_lm_state(jcfg, B)
    tst = TS.init_mamba2_lm_state(tcfg, B, device="cpu")
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
        if s >= PROMPT:  # the last STEPS steps, logits and every state leaf
            close(got, want)
            check_tree(tst, jst)


def test_loss_value():
    jp, tp = _weights(ARCH)
    toks = np.random.default_rng(3).integers(0, 512, (B, PROMPT + 1)).astype(np.int32)
    want = jax.jit(J_ARCHS[ARCH].loss_fn(reduced=True))(jp, {"tokens": jnp.asarray(toks)})
    close(T_ARCHS[ARCH].loss_fn(reduced=True)(tp, {"tokens": torch.from_numpy(toks)}), want)


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}


def _dtypes(tree):
    return {k: _dtypes(v) if isinstance(v, dict) else str(v.dtype).removeprefix("torch.")
            for k, v in tree.items()}


@pytest.mark.parametrize("reduced", [True, False])
def test_param_tree_counts_and_state_specs(reduced):
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
    assert TS.mamba2_lm_state_specs(tcfg) == JS.mamba2_lm_state_specs(jcfg)
    st = TS.init_mamba2_lm_state(tcfg, 2, device="meta")
    jst = jax.eval_shape(lambda: JS.init_mamba2_lm_state(jcfg, 2))
    assert _shapes(st) == jax.tree.map(lambda s: tuple(s.shape), jst)
    assert _dtypes(st) == jax.tree.map(lambda s: s.dtype.name, jst)


def test_full_size_count():
    """mamba2-780m at full width and depth: 780,382,464 parameters."""
    spec = T_ARCHS[ARCH]
    assert spec.param_count() == J_ARCHS[ARCH].param_count() == 780_382_464
    assert spec.active_param_count() == 780_382_464
    cfg = spec.cfg()
    assert (cfg.n_layers, cfg.d_model, cfg.d_state, cfg.headdim, cfg.vocab) == (
        48, 1536, 128, 64, 50_280)


def test_config_field_for_field():
    jspec, tspec = J_ARCHS[ARCH], T_ARCHS[ARCH]
    for f in dataclasses.fields(jspec):
        if f.name not in ("config", "reduced"):
            assert getattr(tspec, f.name) == getattr(jspec, f.name), f.name
    for c in ("config", "reduced"):
        jc, tc = getattr(jspec, c), getattr(tspec, c)
        want = {**dataclasses.asdict(jc), "dtype": DTYPES[jc.dtype]}
        assert dataclasses.asdict(tc) == want
        assert dataclasses.asdict(tc.block_cfg) == dataclasses.asdict(jc.block_cfg)


def test_decode_consistency():
    """The port's mirror of the reference's
    ``test_reduced_decode_consistency`` for mamba2-780m: the last
    position's log-softmax after recurrent decode of every token equals
    the chunked forward's within the reference's 5e-3 (the port's own
    seeded weights)."""
    spec = T_ARCHS[ARCH]
    cfg = spec.cfg(reduced=True)
    params, _ = spec.init(torch.Generator().manual_seed(0), reduced=True, device="cpu")
    S = 10
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (B, S))).int()
    st = TS.init_mamba2_lm_state(cfg, B, device="cpu")
    for t in range(S):
        logits, st = TS.mamba2_lm_decode(params, cfg, toks[:, t : t + 1], st)
    x, _ = TS.mamba2_lm_hidden(params, cfg, toks)
    direct = TL.unembed_logits(params["embed"], x[:, -1:], true_vocab=cfg.vocab)
    lp, ld = torch.log_softmax(logits, -1), torch.log_softmax(direct, -1)
    err = torch.where(torch.isfinite(lp), lp - ld, 0.0).abs().max().item()
    assert err < 5e-3, err


def test_serving_params_cast_once():
    """``serving_params`` casts the matmul and conv weights once and keeps
    norm scales, ``a_log``, ``dt_bias`` and ``d_skip`` in float32: the
    same bits as casting at each use."""
    spec = T_ARCHS[ARCH]
    cfg = dataclasses.replace(spec.cfg(reduced=True), dtype=torch.bfloat16)
    params, _ = spec.init(torch.Generator().manual_seed(3), reduced=True, device="cpu")
    served = TS.serving_params(params, cfg)
    for path, leaf in TT.leaf_paths(served):
        keep = path.rsplit("/", 1)[-1] in ("scale", "a_log", "dt_bias", "d_skip")
        assert leaf.dtype == (torch.float32 if keep else torch.bfloat16), path
    toks = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator().manual_seed(0))
    assert torch.equal(TS.mamba2_lm_hidden(params, cfg, toks)[0],
                       TS.mamba2_lm_hidden(served, cfg, toks)[0])
    st1 = TS.init_mamba2_lm_state(cfg, 2, device="cpu")
    st2 = TS.init_mamba2_lm_state(cfg, 2, device="cpu")
    for t in range(3):
        a, _ = TS.mamba2_lm_decode(params, cfg, toks[:, t : t + 1], st1)
        b, _ = TS.mamba2_lm_decode(served, cfg, toks[:, t : t + 1], st2)
        assert torch.equal(a, b)
    assert all(torch.equal(st1[k], st2[k]) for k in st1)
