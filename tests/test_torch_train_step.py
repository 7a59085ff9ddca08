"""The port's training step (``ArchSpec.make_train_step``, remat,
``make_abstract``/``abstract_opt_state``/``bf16_params``) against the
reference's, on the reduced configs of all ten archs, on the CPU.

The same seeded numpy weights go to the reference's arrays and, through
``params_from_jax``, to the port's tensors; batches come from
``data/pipeline.py`` (equal bit for bit in both packages).  Float32;
tolerance: max |Δ| <= 1e-5 x max(1, max |reference|) per leaf, for the
loss, every gradient leaf and every leaf of the updated params and Adam
state.  The reference's loss and gradients run eagerly, its Adam update
under ``jax.jit``.  Full-size shapes and counts go through the ``meta``
device only: no test here builds a full-width model."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import common as JC
from repro.optim import adam as jadam
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import common as TC
from repro_torch.data import pipeline as tpipe
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.optim import adam as tadam
from repro_torch.tree import leaves, tree_map, unflatten

TOL = 1e-5
B, SEQ = 2, 12
ARCH_NAMES = sorted(J_ARCHS)


def close(got, want, tol=TOL, what=""):
    got = got.detach().double().cpu().numpy()
    want = np.asarray(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not got.size:
        return
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def numpy_weights(tree, rng, d_model):
    """Seeded numpy weights over ``tree``'s shapes, every leaf drawn, small
    where the reference keeps a scale, bias, decay or skip."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = numpy_weights(v, rng, d_model)
        else:
            w = rng.standard_normal(tuple(v.shape)).astype(np.float32)
            small = k in ("scale", "bias", "a_log", "dt_bias", "d_skip", "conv_b") \
                or k.startswith("b")
            out[k] = w * np.float32(0.1 if small else d_model ** -0.5)
    return out


@functools.lru_cache(maxsize=None)
def _host_weights(arch):
    cfg = T_ARCHS[arch].cfg(reduced=True)
    shapes, _ = T_ARCHS[arch].init(None, reduced=True, device="meta")
    return numpy_weights(shapes, np.random.default_rng(0), cfg.d_model)


def weights(arch):
    """Fresh copies: the reference's arrays and the port's tensors."""
    host = _host_weights(arch)
    return jax.tree.map(jnp.asarray, host), TT.params_from_jax(host, device="cpu")


def host_batch(arch, batch=B, seq=SEQ, batch_id=3):
    spec = T_ARCHS[arch]
    cfg = spec.cfg(reduced=True)
    pcfg = tpipe.TokenPipelineConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    if spec.kind == "encdec":
        return tpipe.audio_batch(pcfg, batch_id, n_frames=seq, d_model=cfg.d_model)
    if getattr(cfg, "n_frontend_tokens", 0):
        return tpipe.vlm_batch(pcfg, batch_id, n_img=cfg.n_frontend_tokens, d_model=cfg.d_model)
    return tpipe.token_batch(pcfg, batch_id)


def batches(arch, **kw):
    host = host_batch(arch, **kw)
    return {k: jnp.asarray(v) for k, v in host.items()}, tpipe.to_device(host, "cpu")


def port_grads(arch, params, batch):
    flat = [t.detach().requires_grad_(True) for t in leaves(params)]
    loss = T_ARCHS[arch].loss_fn(reduced=True)(unflatten(params, flat), batch)
    return loss, torch.autograd.grad(loss, flat)


def _adam_cfg():
    """An LR of 5e-6 at step 1.  Adam's first step is about g / (|g| + eps)
    per entry: an entry whose gradient is near zero in both packages (|m|
    ~1e-10 against a largest 1e-3, deepseek-v2-lite) may step anywhere in
    [-1, 1] on either, so at this LR such a step stays inside the
    tolerance.  ``adam_update`` on equal inputs is held leaf for leaf at
    LR 1e-3 in ``tests/test_torch_adam.py``."""
    return dict(lr=1e-5, warmup_steps=2, total_steps=10, weight_decay=0.1, clip_norm=1.0)


@functools.lru_cache(maxsize=None)
def reference_step(arch):
    """The reference's loss, gradients (eager) and one Adam update (jitted,
    as its launcher runs it) from :func:`weights` on :func:`batches`, run
    once per arch: its ``make_train_step`` with one microbatch is this
    ``jax.value_and_grad`` and this ``adam_update``."""
    jp, _ = weights(arch)
    jb, _ = batches(arch)
    loss, grads = jax.value_and_grad(J_ARCHS[arch].loss_fn(reduced=True))(jp, jb)
    update = jax.jit(jadam.adam_update, static_argnums=0)  # eager: ~10 s a tree
    new_p, new_st, metrics = update(jadam.AdamConfig(**_adam_cfg()), jp, grads,
                                    jadam.init_adam(jp))
    return loss, grads, new_p, new_st, metrics


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_grads_match_jax_grad(arch):
    """``spec.loss_fn``'s value and every gradient leaf against
    ``jax.value_and_grad`` of the reference's."""
    _, tp = weights(arch)
    _, tb = batches(arch)
    want_loss, want, *_ = reference_step(arch)
    loss, got = port_grads(arch, tp, tb)
    close(loss, want_loss, what="loss")
    want_leaves = jax.tree.leaves(want)
    assert len(got) == len(want_leaves)
    for i, (g, w) in enumerate(zip(got, want_leaves)):
        close(g, w, what=f"grad leaf {i}")


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-780m", "zamba2-2.7b", "whisper-small"])
def test_remat_on_and_off_give_the_same_gradients(arch, monkeypatch):
    """``layers.remat`` recomputes the same ops in the backward: the
    gradients equal those without it, bit for bit on the CPU."""
    _, tp = weights(arch)
    _, tb = batches(arch)
    on = port_grads(arch, tp, tb)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *args, **kw: fn(*args))  # remat off: keep activations
    off = port_grads(arch, tp, tb)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(on[1], off[1]))


def test_remat_checkpoints_only_when_recording_gradients(monkeypatch):
    """Serving and ``no_grad`` calls run the function plainly; a gradient
    being recorded goes through ``torch.utils.checkpoint``."""
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    w = torch.ones(3, requires_grad=True)
    x = torch.ones(3)
    assert torch.equal(TL.remat(lambda x, p: x * p["w"], x, {"w": w.detach()}), x)
    with torch.no_grad():
        TL.remat(lambda x, p: x * p["w"], x, {"w": w})
    assert calls == []
    TL.remat(lambda x, p: x * p["w"], x, {"w": w}).sum().backward()
    assert len(calls) == 1 and calls[0]["use_reentrant"] is False
    assert torch.equal(w.grad, x)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_step_matches_reference(arch):
    """One ``make_train_step`` step from the same weights and batch against
    the reference's step (:func:`reference_step`): the loss, the gradient
    norm and LR, and every leaf of the new params and of Adam's ``m``,
    ``v`` and ``step``."""
    _, tp = weights(arch)
    _, tb = batches(arch)
    want_loss, _, jp2, js2, jm = reference_step(arch)
    jm = dict(jm, loss=want_loss)
    tstep = T_ARCHS[arch].make_train_step(tadam.AdamConfig(**_adam_cfg()), reduced=True)
    tp2, ts2, tm = tstep(tp, tadam.init_adam(tp), tb)
    for k in ("loss", "grad_norm", "lr"):
        close(tm[k], jm[k], what=k)
    assert int(ts2["step"]) == int(js2["step"]) == 1
    for name, got, want in (("params", tp2, jp2), ("m", ts2["m"], js2["m"]),
                            ("v", ts2["v"], js2["v"])):
        for i, (g, w) in enumerate(zip(leaves(got), jax.tree.leaves(want))):
            close(g, w, what=f"{name} leaf {i}")


def test_train_step_microbatch_accumulates_like_the_reference():
    """``microbatch=2``: two slices, ``g / k`` and ``l / k`` summed in
    float32 in the reference's order (its ``lax.scan``)."""
    arch = "qwen1.5-32b"
    jp, tp = weights(arch)
    jb, tb = batches(arch, batch=4)
    cfg = _adam_cfg()
    jstep = J_ARCHS[arch].make_train_step(jadam.AdamConfig(**cfg), reduced=True, microbatch=2)
    tstep = T_ARCHS[arch].make_train_step(tadam.AdamConfig(**cfg), reduced=True, microbatch=2,
                                          gather_params_once=True)
    jp2, js2, jm = jstep(jp, jadam.init_adam(jp), jb)
    tp2, ts2, tm = tstep(tp, tadam.init_adam(tp), tb)
    close(tm["loss"], jm["loss"], what="loss")
    close(tm["grad_norm"], jm["grad_norm"], what="grad_norm")
    for i, (g, w) in enumerate(zip(leaves(ts2["m"]), jax.tree.leaves(js2["m"]))):
        close(g, w, what=f"m leaf {i}")
    for i, (g, w) in enumerate(zip(leaves(tp2), jax.tree.leaves(jp2))):
        close(g, w, what=f"params leaf {i}")


def test_train_step_master_weights_keeps_bf16_params():
    """bf16 params with a float32 master in the Adam state: the step
    updates the master and emits its bf16 rounding, as the reference's."""
    arch = "mamba2-780m"
    _, tp = weights(arch)
    _, tb = batches(arch)
    p16 = tree_map(lambda t: t.to(torch.bfloat16), tp)
    st = tadam.init_adam(p16, master_weights=True)
    p2, st2, m = T_ARCHS[arch].make_train_step(tadam.AdamConfig(**_adam_cfg()), reduced=True)(
        p16, st, tb)
    assert np.isfinite(float(m["loss"]))
    for p, w in zip(leaves(p2), leaves(st2["master"])):
        assert p.dtype == torch.bfloat16 and w.dtype == torch.float32
        assert torch.equal(p, w.to(torch.bfloat16))


@pytest.mark.parametrize("arch", ["mamba2-780m", "olmoe-1b-7b"])
def test_abstract_trees_on_meta_match_reference_shapes(arch):
    """``make_abstract``, ``abstract_opt_state`` and ``bf16_params`` at full
    width, on ``meta``: the reference's shapes and dtypes, leaf for leaf
    (the reference's through ``jax.eval_shape``; nothing is allocated)."""
    tshapes, _ = T_ARCHS[arch].init(None, reduced=False, device="meta")
    jshapes = jax.eval_shape(lambda: J_ARCHS[arch].init(jax.random.PRNGKey(0))[0])
    t_abs, j_abs = TC.make_abstract(tshapes), JC.make_abstract(jshapes)
    for mw in (False, True):
        t_opt = TC.abstract_opt_state(t_abs, master_weights=mw)
        j_opt = JC.abstract_opt_state(j_abs, master_weights=mw)
        assert sorted(t_opt) == sorted(j_opt)
        for t, j in zip(leaves(t_opt), jax.tree.leaves(j_opt)):
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(j.shape)
            assert str(t.dtype).split(".")[-1] == str(j.dtype)
    for t, j in zip(leaves(TC.bf16_params(t_abs)), jax.tree.leaves(JC.bf16_params(j_abs))):
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).split(".")[-1] == str(j.dtype)


def test_mamba2_780m_training_bytes_from_meta():
    """The full-width count the card phase prices its bounds from: the
    reference's 780,382,464 parameters, and float32 params, gradients, m
    and v of 4 x 3.12 GB, counted on ``meta``."""
    spec = T_ARCHS["mamba2-780m"]
    n = spec.param_count()
    assert n == J_ARCHS["mamba2-780m"].param_count() == 780_382_464
    opt = TC.abstract_opt_state(TC.make_abstract(spec.init(None, device="meta")[0]))
    state_bytes = sum(t.numel() * t.element_size() for t in leaves(opt))
    assert state_bytes == 2 * 4 * n + 4
