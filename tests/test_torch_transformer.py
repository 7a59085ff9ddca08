"""The port's decoder LM (``repro_torch.models.transformer``) and its arch
registry against the reference's, over the seven LM archs' reduced
configs (plus int8-cache variants of an MHA and an MLA arch), with the
reference's weights carried over by ``params_from_jax``: hidden states,
prefill, three decode steps and every cache leaf after each, the training
loss's value, the param tree, its counts and the configs.  Float32;
tolerance: max |Δ| <= 1e-4 x max(1, max |reference|) (a whole network's
sums in another order), int8 cache leaves equal, positions and lengths
equal, counts and configs exact."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import transformer as JT
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import get as t_get
from repro_torch.models import transformer as TT

LM_ARCHS = sorted(a for a, s in J_ARCHS.items() if s.kind == "lm")
CASES = [(a, False) for a in LM_ARCHS] + [("qwen1.5-32b", True), ("deepseek-v2-lite", True)]
TOL = 1e-4
B, PROMPT, STEPS = 2, 20, 3  # the prompt outgrows the reduced local windows (16)


def close(got, want, tol=TOL):
    got = got.detach().cpu().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want)
        return
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def configs(arch, kv_quant):
    jcfg = dataclasses.replace(J_ARCHS[arch].cfg(reduced=True), kv_quant=kv_quant)
    tcfg = dataclasses.replace(T_ARCHS[arch].cfg(reduced=True), kv_quant=kv_quant)
    return jcfg, tcfg


def numpy_weights(tree, rng, d_model):
    """Seeded numpy weights over ``tree``'s shapes: norm scales and biases
    drawn too, so every leaf moves the output."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = numpy_weights(v, rng, d_model)
        else:
            w = rng.standard_normal(tuple(v.shape)).astype(np.float32)
            out[k] = w * np.float32(0.1 if k in ("scale", "bias") or k.startswith("b")
                                    else d_model ** -0.5)
    return out


@functools.lru_cache(maxsize=None)
def weights(arch):
    """The same seeded numpy weights as the reference's arrays and, through
    ``params_from_jax``, the port's tensors (the tree's shapes are the
    reference's: ``test_param_tree_and_counts``)."""
    cfg = T_ARCHS[arch].cfg(reduced=True)
    shapes, _ = T_ARCHS[arch].init(None, reduced=True, device="meta")
    host = numpy_weights(shapes, np.random.default_rng(0), cfg.d_model)
    return jax.tree.map(jnp.asarray, host), TT.params_from_jax(host, device="cpu")


def inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, PROMPT + STEPS)).astype(np.int32)
    extra = (rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
             if cfg.n_frontend_tokens else None)
    return toks, extra


def check_tree(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            check_tree(got[k], want[k])
        else:
            close(got[k], want[k])


@pytest.mark.parametrize("arch,kv_quant", CASES)
def test_forward_prefill_decode_and_caches(arch, kv_quant):
    jcfg, tcfg = configs(arch, kv_quant)
    jp, tp = weights(arch)
    toks, extra = inputs(jcfg)
    jx = None if extra is None else jnp.asarray(extra)
    tx = None if extra is None else torch.from_numpy(extra)
    n_front = jcfg.n_frontend_tokens

    want, _, want_aux = jax.jit(lambda p, t, e: JT.hidden_states(p, jcfg, t, extra_embed=e))(
        jp, jnp.asarray(toks), jx)
    got, _, got_aux = TT.hidden_states(tp, tcfg, torch.from_numpy(toks), extra_embed=tx)
    close(got, want)
    close(got_aux, want_aux)

    max_len = n_front + PROMPT + STEPS + 2
    want_l, jc = jax.jit(lambda p, t, e: JT.prefill(p, jcfg, t, extra_embed=e, max_len=max_len))(
        jp, jnp.asarray(toks[:, :PROMPT]), jx)
    got_l, tc = TT.prefill(tp, tcfg, torch.from_numpy(toks[:, :PROMPT]), extra_embed=tx,
                           max_len=max_len)
    close(got_l, want_l)
    check_tree(tc, jc)
    decode = jax.jit(lambda p, t, c, pos: JT.decode_step(p, jcfg, t, c, pos))
    for s in range(STEPS):
        pos = np.full((B, 1), n_front + PROMPT + s, np.int32)
        tok = toks[:, PROMPT + s : PROMPT + s + 1]
        want_l, jc = decode(jp, jnp.asarray(tok), jc, jnp.asarray(pos))
        got_l, tc2 = TT.decode_step(tp, tcfg, torch.from_numpy(tok), tc, torch.from_numpy(pos))
        assert tc2 is tc  # written in place
        close(got_l, want_l)
        check_tree(tc, jc)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_loss_value(arch):
    jcfg, tcfg = configs(arch, False)
    jp, tp = weights(arch)
    toks, extra = inputs(jcfg, seed=2)
    jbatch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.from_numpy(toks)}
    if extra is not None:
        jbatch["extra_embed"] = jnp.asarray(extra)
        tbatch["extra_embed"] = torch.from_numpy(extra)
    want = jax.jit(J_ARCHS[arch].loss_fn(reduced=True))(jp, jbatch)
    close(T_ARCHS[arch].loss_fn(reduced=True)(tp, tbatch), want)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "internvl2-76b"])
def test_arch_spec_steps(arch):
    """``make_prefill_step`` (cache sized to the reduced shape's 64) and
    ``make_decode_step`` against the reference's on the same weights."""
    from repro.configs.common import SHAPES as J_SHAPES
    from repro_torch.configs.common import SHAPES

    jcfg, tcfg = configs(arch, False)
    jp, tp = weights(arch)
    toks, extra = inputs(jcfg, seed=3)
    jbatch, tbatch = {"tokens": jnp.asarray(toks[:, :PROMPT])}, {
        "tokens": torch.from_numpy(toks[:, :PROMPT])}
    if extra is not None:
        jbatch["extra_embed"], tbatch["extra_embed"] = jnp.asarray(extra), torch.from_numpy(extra)
    want_l, jc = J_ARCHS[arch].make_prefill_step(J_SHAPES["prefill_32k"], reduced=True)(jp, jbatch)
    got_l, tc = T_ARCHS[arch].make_prefill_step(SHAPES["prefill_32k"], reduced=True)(tp, tbatch)
    close(got_l, want_l)
    check_tree(tc, jc)
    pos = np.full((B, 1), jcfg.n_frontend_tokens + PROMPT, np.int32)
    tok = toks[:, PROMPT : PROMPT + 1]
    want_l, jc = J_ARCHS[arch].make_decode_step(J_SHAPES["decode_32k"], reduced=True)(
        jp, jc, {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)})
    got_l, tc = T_ARCHS[arch].make_decode_step(SHAPES["decode_32k"], reduced=True)(
        tp, tc, {"token": torch.from_numpy(tok), "pos": torch.from_numpy(pos)})
    close(got_l, want_l)
    check_tree(tc, jc)


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_tree_and_counts(arch, reduced):
    jspec, tspec = J_ARCHS[arch], T_ARCHS[arch]
    box = {}

    def init():  # shapes alone; the logical axes come out beside them
        params, box["specs"] = jspec.init(jax.random.PRNGKey(0), reduced)
        return params

    jshapes = jax.eval_shape(init)
    jspecs = box["specs"]
    tparams, tspecs = tspec.init(None, reduced, device="meta")
    assert _shapes(tparams) == jax.tree.map(lambda s: tuple(s.shape), jshapes)
    assert tspecs == jspecs
    assert all(t.dtype == torch.float32 for _, t in TT.leaf_paths(tparams))
    assert tspec.param_count(reduced) == jspec.param_count(reduced)
    assert tspec.active_param_count(reduced) == jspec.active_param_count(reduced)
    tcfg, jcfg = tspec.cfg(reduced), jspec.cfg(reduced)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert TT.cache_specs(tcfg) == JT.cache_specs(jcfg)


def test_olmoe_full_size():
    """OLMoE-1B-7B at full width and depth: 6,816,335,872 parameters
    (1,179,191,296 active a token) by the registry's count, 16 layers of 64
    experts, top-8."""
    spec = T_ARCHS["olmoe-1b-7b"]
    assert spec.param_count() == J_ARCHS["olmoe-1b-7b"].param_count() == 6_816_335_872
    assert spec.active_param_count() == 1_179_191_296
    cfg = spec.cfg()
    assert (cfg.n_layers, cfg.d_model, cfg.moe.n_experts, cfg.moe.top_k) == (16, 2048, 64, 8)
    assert spec.uses_paper_technique


DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _fields(cfg, map_dtype):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        elif f.name == "dtype" and map_dtype:
            v = DTYPES[v]
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch", LM_ARCHS + ["gcn-paper"])
def test_config_field_for_field(arch):
    from repro.configs import get as j_get

    jspec, tspec = j_get(arch), t_get(arch)
    for f in dataclasses.fields(jspec):
        if f.name not in ("config", "reduced"):
            assert getattr(tspec, f.name) == getattr(jspec, f.name), f.name
    if jspec.kind == "gnn":
        # the port's GNNConfig has no ``backend`` (its kernel is the one path)
        for c in ("config", "reduced"):
            want = {k: v for k, v in dataclasses.asdict(getattr(jspec, c)).items()
                    if k != "backend"}
            assert dataclasses.asdict(getattr(tspec, c)) == want
        return
    for c in ("config", "reduced"):
        assert _fields(getattr(tspec, c), False) == _fields(getattr(jspec, c), True)


def test_registry():
    """The port's ``ARCHS`` holds the reference's ten architectures, each
    of the reference's kind; an unknown name raises."""
    assert sorted(T_ARCHS) == sorted(J_ARCHS)
    assert {a: s.kind for a, s in T_ARCHS.items()} == {a: s.kind for a, s in J_ARCHS.items()}
    with pytest.raises(KeyError):
        t_get("mamba2-781m")


def test_unported_kinds_and_training_raise():
    """Every kind inits on ``meta`` (the SSM, hybrid and encoder-decoder
    ones since they were ported) and makes a train step (since the
    training stack was ported); an unknown kind is refused, its train step
    too; the production mesh runs on a one-device pool and is refused over
    several distinct devices places every shard on its position's device,
    with its shard shape."""
    from repro_torch.configs.common import ArchSpec
    from repro_torch.launch import train as train_mod

    for name, spec in T_ARCHS.items():
        params, _ = spec.init(None, reduced=True, device="meta")
        assert all(t.device.type == "meta" for _, t in TT.leaf_paths(params)), name
        assert callable(spec.make_train_step()), name
    bad = dataclasses.replace(T_ARCHS["olmoe-1b-7b"], kind="gnn")
    with pytest.raises(ValueError):
        bad.init(None, reduced=True, device="meta")
    with pytest.raises(ValueError):
        bad.make_train_step()
    assert isinstance(bad, ArchSpec)
    args = ["--arch", "olmoe-1b-7b", "--reduced", "--steps", "1", "--batch", "2", "--seq",
            "8", "--mesh", "prod", "--device", "cpu"]
    assert len(train_mod.main(args)) == 1
    import unittest.mock

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.tree import leaves

    spec = T_ARCHS["olmoe-1b-7b"]
    params, opt = train_mod.init_train_state(spec, True, "cpu")
    axes = spec.init(None, reduced=True, device="meta")[1]
    with unittest.mock.patch.object(train_mod, "device_pool",
                                    lambda d: (torch.device("cpu"), torch.device("meta"))):
        mesh = make_production_mesh(devices=train_mod.device_pool("cpu"))
        placed = train_mod.place_on_mesh(mesh, params, opt, axes)
    assert len(mesh.distinct_devices) == 2
    for x in leaves(placed):
        for pos in np.ndindex(mesh.devices.shape):
            assert x.shards[pos].device == mesh.devices[pos]
            assert tuple(x.shards[pos].shape) == x.sharding.shard_shape(x.shape)


def test_init_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_lm(torch.Generator(), T_ARCHS["olmoe-1b-7b"].cfg(reduced=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T_ARCHS["olmoe-1b-7b"].init(torch.Generator(), reduced=True)


def test_seeded_init_and_serving_params():
    """The port's own init is seeded, every layer drawn apart (the
    reference reuses keys across pattern positions); serving params cast
    the matmul weights once and keep norm scales in float32."""
    cfg = T_ARCHS["gemma3-4b"].cfg(reduced=True)
    a, _ = TT.init_lm(torch.Generator().manual_seed(3), cfg, device="cpu")
    b, _ = TT.init_lm(torch.Generator().manual_seed(3), cfg, device="cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(TT.leaf_paths(a), TT.leaf_paths(b)))
    assert not torch.equal(a["blocks"]["pos0"]["attn"]["wq"], a["blocks"]["pos3"]["attn"]["wq"])
    g2, _ = TT.init_lm(torch.Generator().manual_seed(3), T_ARCHS["gemma2-27b"].cfg(reduced=True),
                       device="cpu")
    wq = g2["blocks"]["pos0"]["attn"]["wq"]  # [n_rep = 2, ...]
    assert not torch.equal(wq[0], wq[1])
    bf = dataclasses.replace(cfg, dtype=torch.bfloat16)
    served = TT.serving_params(a, bf)
    for path, leaf in TT.leaf_paths(served):
        norm = any(p.startswith("ln_") for p in path.split("/"))
        keep = norm or (path == "embed/table" and bf.embed_scale)
        assert leaf.dtype == (torch.float32 if keep else torch.bfloat16), path
    toks = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator().manual_seed(0))
    x1, _, _ = TT.hidden_states(a, bf, toks)
    x2, _, _ = TT.hidden_states(served, bf, toks)
    assert torch.equal(x1, x2)  # the same bits as casting at each use
