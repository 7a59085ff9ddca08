"""The port's AdamW (``repro_torch.optim.adam``) against the reference's
``repro.optim.adam``: the cases of ``tests/test_substrate.py`` on the
port, and one update leaf for leaf on the same seeded numpy inputs, in
float32 and in the bf16 master-weights mode, with ``schedule`` and
``global_norm`` beside it.  Tolerance: max |Δ| <= 1e-5 x max(1, max
|reference|) per leaf in float32; in the master-weights mode the bf16
params are the rounding of the port's own master exactly, and within one
bf16 step of the reference's (two masters within 1e-5 may round to
neighbouring bf16 values)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adam as jadam
from repro_torch.optim.adam import AdamConfig, adam_update, global_norm, init_adam, schedule
from repro_torch.tree import leaves

TOL = 1e-5


def close(got, want, tol=TOL):
    got = got.detach().double().cpu().numpy()
    want = np.asarray(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max()) if want.size else 1.0), err


def test_adam_converges_quadratic():
    cfg = AdamConfig(lr=0.1, warmup_steps=1, total_steps=200, weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = init_adam(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}  # d/dp p^2
        params, state, _ = adam_update(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.05


def test_schedule_shape():
    cfg = AdamConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert float(schedule(cfg, 0)) < 0.15
    assert float(schedule(cfg, 10)) == pytest.approx(1.0, abs=1e-3)
    assert float(schedule(cfg, 100)) == pytest.approx(0.1, abs=1e-3)


def test_clipping_applied():
    cfg = AdamConfig(lr=0.1, clip_norm=1.0, warmup_steps=1, total_steps=10)
    params = {"w": torch.zeros(3)}
    state = init_adam(params)
    _, _, metrics = adam_update(cfg, params, {"w": torch.tensor([100.0, 0, 0])}, state)
    assert float(metrics["grad_norm"]) == pytest.approx(100.0)


def test_master_weights_adam_matches_f32_updates():
    """bf16 params + f32 master track plain f32 Adam closely."""
    cfg = AdamConfig(lr=0.05, warmup_steps=1, total_steps=50, weight_decay=0.0, clip_norm=100.0)
    w0 = torch.tensor([1.0, -2.0, 0.5])
    p_f32 = {"w": w0}
    s_f32 = init_adam(p_f32)
    p_bf16 = {"w": w0.to(torch.bfloat16)}
    s_mw = init_adam(p_bf16, master_weights=True)
    for _ in range(50):
        p_f32, s_f32, _ = adam_update(cfg, p_f32, {"w": 2 * p_f32["w"].float()}, s_f32)
        p_bf16, s_mw, _ = adam_update(cfg, p_bf16, {"w": 2 * p_bf16["w"].float()}, s_mw)
    assert p_bf16["w"].dtype == torch.bfloat16
    err = float((s_mw["master"]["w"] - p_f32["w"]).abs().max())
    assert err < 5e-2, err


def _inputs(seed=0):
    """A param tree of matrices, vectors and a stacked leaf (weight decay
    applies to ndim >= 2 only), its gradients, and moments from a few
    earlier steps."""
    rng = np.random.default_rng(seed)
    shapes = {"blocks": {"w": (3, 4, 5), "ln": (3, 5)}, "embed": {"table": (7, 5)}, "b": (5,)}

    def draw(t, scale=1.0):
        if isinstance(t, dict):
            return {k: draw(v, scale) for k, v in t.items()}
        return (scale * rng.standard_normal(t)).astype(np.float32)

    params, grads = draw(shapes), draw(shapes, 3.0)
    m, v = draw(shapes, 0.1), jax.tree.map(np.abs, draw(shapes, 0.1))
    return params, grads, m, v


def _to_torch(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.asarray(tree))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("clip", [1.0, 100.0])  # clipped, not clipped
@pytest.mark.parametrize("step0", [0, 7, 150])  # warm-up, warm, cosine decay
def test_update_matches_reference_leaf_for_leaf(clip, step0):
    """One ``adam_update`` on equal float32 inputs: new params, ``m``,
    ``v``, ``step``, the gradient norm and the LR."""
    params, grads, m, v = _inputs()
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=200, clip_norm=clip)
    jst = {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
           "step": jnp.asarray(step0, jnp.int32)}
    tst = {"m": _to_torch(m), "v": _to_torch(v), "step": torch.tensor(step0, dtype=torch.int32)}
    jp, js, jm = jadam.adam_update(jadam.AdamConfig(**cfg), jax.tree.map(jnp.asarray, params),
                                   jax.tree.map(jnp.asarray, grads), jst)
    tp, ts, tm = adam_update(AdamConfig(**cfg), _to_torch(params), _to_torch(grads), tst)
    for k in ("grad_norm", "lr"):
        close(tm[k], jm[k])
    assert int(ts["step"]) == int(js["step"]) == step0 + 1
    assert ts["step"].dtype == torch.int32
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for g, w in zip(leaves(got), jax.tree.leaves(want)):
            close(g, w)


def test_master_weights_update_matches_reference():
    """bf16 params with a float32 master: the master, ``m`` and ``v`` leaf
    for leaf, the new bf16 params the rounding of the new master."""
    params, grads, m, v = _inputs(1)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=20)
    jp16 = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params)
    tp16 = _to_torch(params, torch.bfloat16)
    js = jadam.init_adam(jp16, master_weights=True)
    ts = init_adam(tp16, master_weights=True)
    for g, w in zip(leaves(ts["master"]), jax.tree.leaves(js["master"])):
        assert g.dtype == torch.float32
        close(g, w, tol=0.0)
    jg16 = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), grads)
    jp2, js2, _ = jadam.adam_update(jadam.AdamConfig(**cfg), jp16, jg16, js)
    tp2, ts2, _ = adam_update(AdamConfig(**cfg), tp16, _to_torch(grads, torch.bfloat16), ts)
    for name in ("master", "m", "v"):
        for g, w in zip(leaves(ts2[name]), jax.tree.leaves(js2[name])):
            close(g, w)
    for g, w in zip(leaves(tp2), leaves(ts2["master"])):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))
    for g, w in zip(leaves(tp2), jax.tree.leaves(jp2)):
        g, w = g.float().numpy(), np.asarray(w).astype(np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert np.all(np.abs(g - w) <= ulp)


def test_schedule_and_global_norm_match_reference():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for step in (0, 1, 5, 10, 11, 55, 99, 100, 250):
        close(schedule(AdamConfig(**cfg), torch.tensor(step, dtype=torch.int32)),
              jadam.schedule(jadam.AdamConfig(**cfg), jnp.asarray(step, jnp.int32)))
    params, *_ = _inputs(2)
    close(global_norm(_to_torch(params)), jadam.global_norm(jax.tree.map(jnp.asarray, params)))


def test_config_fields_match_reference():
    assert dataclasses.asdict(AdamConfig()) == dataclasses.asdict(jadam.AdamConfig())


def test_update_stays_on_device_and_leaves_inputs():
    """The update is functional (its inputs keep their values) and its
    scalars are tensors: nothing is read back to the host."""
    params, grads, *_ = _inputs()
    tp = _to_torch(params)
    before = [t.clone() for t in leaves(tp)]
    st = init_adam(tp)
    new_p, new_st, metrics = adam_update(AdamConfig(), tp, _to_torch(grads), st)
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(tp)))
    assert int(st["step"]) == 0 and int(new_st["step"]) == 1
    assert all(isinstance(x, torch.Tensor) for x in metrics.values())
