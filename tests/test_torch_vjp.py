"""Gradients of the port against ``jax.grad`` of the reference, on the CPU.

* The SCV SpMM's autograd Function (``ops._ScvChain``): ``d/dvals`` of
  every segment and ``d/dz`` of ``scv_spmm_plan`` and ``scv_spmm``, held
  against ``jax.grad`` through the reference's custom VJP (its Pallas
  forward in interpret mode), for a single-cap and a bucketed plan.
* ``gnn_loss`` for the four layer kinds, against ``jax.grad`` of the
  reference's ``gnn_loss`` run eagerly on one device (its jitted and
  sharded paths fail under the installed jax, ROADMAP §3), with the
  reference's weights carried over by ``params_from_jax``.
* The training loop of ``tests/test_system.py::
  test_gnn_training_scv_backend_improves``, on the port.
* The backward through the transposed plan: the four kinds against
  ``jax.grad`` with three-segment plans and dense tiles, bit for bit
  against the earlier plain backward (``index_add_``) on integers, the
  transposed plan's leaves against the reference's builders on Âᵀ, and its
  lifetime (reweighted plans, deltas, the ``transposed`` check).

Tolerances: gradients within 1e-5 of the largest magnitude of the
reference's gradient (at least 1): float32 sums in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import COOMatrix as JCOO
from repro.core.scv import SCVBucketedPlan as JBucketed
from repro.core.scv import coo_to_scv_tiles as j_tiles
from repro.core.scv import plan_from_tiles as j_plan
from repro.core.scv import plan_from_tiles_bucketed as j_bucketed
from repro.kernels.scv_spmm import ops as jops
from repro.models import gnn as jgnn
from repro_torch.core.aggregate import aggregate_scv_plan
from repro_torch.core.formats import COOMatrix
from repro_torch.core.scv import SCVBucketedPlan, coo_to_scv_tiles, plan_from_tiles
from repro_torch.core.scv import dense_tile_threshold, plan_from_tiles_bucketed, transposed_plan
from repro_torch.core.validate import validate_plan
from repro_torch.kernels.scv_spmm import ops
from repro_torch.models import gnn as tgnn
from repro_torch.stream.delta import DeltaBatch, apply_delta
from repro_torch.simul.datasets import gcn_normalize, powerlaw_graph

KINDS = ["gcn", "sage", "gin", "gat"]


def assert_grad_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * scale, (err, scale)


def _coo(rng, n=96, density=0.12, duplicates=True):
    dense = rng.random((n, n)) < density
    rows, cols = np.nonzero(dense)
    if duplicates:  # a few repeated coordinates, summed by every path
        dup = rng.choice(rows.size, size=rows.size // 8, replace=False)
        rows, cols = np.concatenate([rows, rows[dup]]), np.concatenate([cols, cols[dup]])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    rows, cols = rows.astype(np.int32), cols.astype(np.int32)
    return JCOO(rows, cols, vals, (n, n)), COOMatrix(rows, cols, vals, (n, n))


def _plans(jc, tc, layout, tile=16):
    if layout == "single":
        return j_plan(j_tiles(jc, tile, cap=64)), plan_from_tiles(coo_to_scv_tiles(tc, tile, cap=64))
    caps = (8, 32, 128)
    return (j_bucketed(j_tiles(jc, tile, cap=caps[-1]), caps),
            plan_from_tiles_bucketed(coo_to_scv_tiles(tc, tile, cap=caps[-1]), caps))


def _segments(p):
    return getattr(p, "segments", (p,))


def _with_vals(p, vals, bucketed_cls):
    segs = tuple(s.with_vals(v) for s, v in zip(_segments(p), vals))
    return bucketed_cls(segs) if hasattr(p, "segments") else segs[0]


@pytest.mark.parametrize("layout", ["single", "buckets"])
@pytest.mark.parametrize("init", ["coverage", "zeros"])
def test_plan_vjp_matches_jax_grad(rng, layout, init):
    jc, tc = _coo(rng)
    jp, tp = _plans(jc, tc, layout)
    n, f = jc.shape[0], 12
    z = rng.standard_normal((n, f)).astype(np.float32)
    w = rng.standard_normal((tp.padded_shape[0], f)).astype(np.float32)  # the cotangent

    def jloss(vals, zz):
        out = jops.scv_spmm_plan(_with_vals(jp, vals, JBucketed), zz, interpret=True,
                                 feature_block=8, init=init)
        return jnp.sum(out * w)

    jvals = tuple(s.vals for s in _segments(jp))
    want_dvals, want_dz = jax.grad(jloss, argnums=(0, 1))(jvals, jnp.asarray(z))

    tvals = [s.vals.clone().requires_grad_(True) for s in _segments(tp)]
    tz = torch.from_numpy(z).requires_grad_(True)
    out = ops.scv_spmm_plan(_with_vals(tp, tvals, SCVBucketedPlan), tz, init=init)
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    assert_grad_close(tz.grad.numpy(), want_dz)
    for tv, jv in zip(tvals, want_dvals):
        assert_grad_close(tv.grad.numpy(), jv)


def test_loose_scv_spmm_vjp_matches_jax_grad(rng):
    jc, tc = _coo(rng, n=64)
    jt = j_tiles(jc, 16, cap=32)
    z = rng.standard_normal((64, 8)).astype(np.float32)
    w = rng.standard_normal((64, 8)).astype(np.float32)
    ints = {k: getattr(jt, k) for k in ("tile_row", "tile_col", "rows", "cols", "nnz_in_tile")}

    def jloss(vals, zz):
        out = jops.scv_spmm(
            jnp.asarray(ints["tile_row"]), jnp.asarray(ints["tile_col"]),
            jnp.asarray(ints["rows"]), jnp.asarray(ints["cols"]), vals, zz, tile=16,
            n_rows=64, nnz_in_tile=jnp.asarray(ints["nnz_in_tile"]), interpret=True,
            feature_block=8)
        return jnp.sum(out * w)

    want_dv, want_dz = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(jt.vals), jnp.asarray(z))
    tv = torch.from_numpy(jt.vals.copy()).requires_grad_(True)
    tz = torch.from_numpy(z).requires_grad_(True)
    out = ops.scv_spmm(*(torch.from_numpy(ints[k]) for k in ("tile_row", "tile_col", "rows", "cols")),
                       tv, tz, tile=16, n_rows=64, nnz_in_tile=torch.from_numpy(ints["nnz_in_tile"]))
    (out * torch.from_numpy(w)).sum().backward()
    assert_grad_close(tz.grad.numpy(), want_dz)
    assert_grad_close(tv.grad.numpy(), want_dv)


def test_vjp_masks_padding_slots_and_bodies_agree(rng):
    """Slots past a tile's nnz get no gradient, and the gradient does not
    depend on the body or the dense branch that ran the forward."""
    _, tc = _coo(rng, n=64, density=0.3)
    tp = plan_from_tiles(coo_to_scv_tiles(tc, 16, cap=128))
    z = torch.from_numpy(rng.standard_normal((64, 4)).astype(np.float32))
    grads = []
    for kw in (dict(body="vector"), dict(body="vector", dense_threshold=-1), dict(body="scalar")):
        v = tp.vals.clone().requires_grad_(True)
        zz = z.clone().requires_grad_(True)
        ops.scv_spmm_plan(tp.with_vals(v), zz, **kw).square().sum().backward()
        grads.append((v.grad, zz.grad))
    slot = torch.arange(tp.cap)[None, :]
    assert bool((grads[0][0][slot >= tp.nnz_in_tile[:, None]] == 0).all())
    for dv, dz in grads[1:]:
        torch.testing.assert_close(dv, grads[0][0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dz, grads[0][1], rtol=1e-5, atol=1e-5)


def test_aggregate_passes_gradients(rng):
    _, tc = _coo(rng, n=80)
    tp = plan_from_tiles_bucketed(coo_to_scv_tiles(tc, 16, cap=128), (8, 32, 128))
    z = torch.from_numpy(rng.standard_normal((80, 6)).astype(np.float32)).requires_grad_(True)
    out = aggregate_scv_plan(tp, z)
    assert out.shape == (80, 6)
    out.sum().backward()
    dense = torch.zeros(80, 80)
    dense.index_put_((torch.from_numpy(tc.rows).long(), torch.from_numpy(tc.cols).long()),
                     torch.from_numpy(tc.vals), accumulate=True)
    torch.testing.assert_close(z.grad, dense.t() @ torch.ones(80, 6), rtol=1e-5, atol=1e-5)


def test_no_grad_and_inference_mode_forward(rng):
    _, tc = _coo(rng, n=48)
    tp = plan_from_tiles(coo_to_scv_tiles(tc, 16, cap=64))
    z = torch.from_numpy(rng.standard_normal((48, 4)).astype(np.float32)).requires_grad_(True)
    want = ops.scv_spmm_plan(tp, z).detach()
    with torch.no_grad():
        a = ops.scv_spmm_plan(tp, z)
    with torch.inference_mode():
        b = ops.scv_spmm_plan(tp, z)
    assert a.grad_fn is None and b.grad_fn is None
    torch.testing.assert_close(a, want, rtol=0, atol=0)
    torch.testing.assert_close(b, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# model gradients
# ---------------------------------------------------------------------------
def _graph_pair(n=200, seed=5):
    a = gcn_normalize(powerlaw_graph(n, 4 * n, seed=seed))
    return JCOO(a.rows, a.cols, a.vals, a.shape), a


def _models(kind, backend="jnp"):
    jcfg = jgnn.GNNConfig(name=kind, kind=kind, d_in=12, d_hidden=16, n_classes=5,
                          n_layers=2, backend=backend)
    tcfg = tgnn.GNNConfig(name=kind, kind=kind, d_in=12, d_hidden=16, n_classes=5, n_layers=2)
    jparams, _ = jgnn.init_gnn(jax.random.PRNGKey(1), jcfg)
    if kind == "gin":  # a nonzero eps exercises the (1 + eps) h term
        jparams = {k: {**v, "eps": jnp.asarray(0.25, jnp.float32)} for k, v in jparams.items()}
    return jcfg, tcfg, jparams


@pytest.mark.parametrize("kind,backend", [(k, "jnp") for k in KINDS] + [("gcn", "pallas_interpret")])
def test_gnn_loss_grads_match_jax(rng, kind, backend):
    """``pallas_interpret`` runs the reference's aggregation through its
    custom VJP; ``jnp`` through jax's own autodiff of the gather."""
    ja, ta = _graph_pair()
    jcfg, tcfg, jparams = _models(kind, backend)
    n = ta.shape[0]
    x = rng.standard_normal((n, 12)).astype(np.float32)
    labels = rng.integers(0, 5, n)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    kw = dict(tile=64, bucket_caps=(8, 32, 128))
    jg = jgnn.build_graph(ja, **kw)
    want_loss, want = jax.value_and_grad(lambda p: jgnn.gnn_loss(
        p, jcfg, jg, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mask)))(jparams)

    tparams = tgnn.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    for ps in tparams.values():
        for p in ps.values():
            p.requires_grad_(True)
    tg = tgnn.build_graph(ta, device="cpu", **kw)
    loss = tgnn.gnn_loss(tparams, tcfg, tg, torch.from_numpy(x), torch.from_numpy(labels),
                         torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert tparams.keys() == want.keys()
    for layer, ps in tparams.items():
        assert ps.keys() == want[layer].keys()
        for name, p in ps.items():
            assert p.grad is not None, f"{layer}.{name} got no gradient"
            assert_grad_close(p.grad.numpy(), want[layer][name])


def test_gat_attention_gets_gradient_through_reweighted_plan(rng):
    """dvals must reach the attention vectors through ``plan.reweighted``."""
    _, ta = _graph_pair(n=120, seed=7)
    cfg = tgnn.GNNConfig(name="gat", kind="gat", d_in=8, d_hidden=8, n_classes=3)
    params = tgnn.init_gnn(torch.Generator().manual_seed(0), cfg, device="cpu")
    for ps in params.values():
        for p in ps.values():
            p.requires_grad_(True)
    g = tgnn.build_graph(ta, bucket_caps=(8, 32, 128), device="cpu")
    x = torch.from_numpy(rng.standard_normal((120, 8)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 3, 120))
    tgnn.gnn_loss(params, cfg, g, x, labels, torch.ones(120)).backward()
    for layer in params.values():
        for name in ("a_src", "a_dst"):
            assert float(layer[name].grad.abs().max()) > 0.0


def test_gnn_loss_matches_reference_value_on_a_masked_batch(rng):
    ja, ta = _graph_pair(n=90, seed=8)
    jcfg, tcfg, jparams = _models("sage")
    x = rng.standard_normal((90, 12)).astype(np.float32)
    labels = rng.integers(0, 5, 90)
    mask = np.zeros(90, np.float32)  # an empty mask divides by 1, not by 0
    want = float(jgnn.gnn_loss(jparams, jcfg, jgnn.build_graph(ja, tile=32), jnp.asarray(x),
                               jnp.asarray(labels), jnp.asarray(mask)))
    tparams = tgnn.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    got = tgnn.gnn_loss(tparams, tcfg, tgnn.build_graph(ta, tile=32, device="cpu"),
                        torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(mask))
    assert want == 0.0 and got.item() == 0.0


def test_gnn_training_improves_on_the_port():
    """The loop of ``tests/test_system.py:78`` on the port's CPU path."""
    adj = gcn_normalize(powerlaw_graph(150, 600, seed=0))
    g = tgnn.build_graph(adj, tile=32, device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((150, 16)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 5, 150))
    mask = torch.ones(150)
    cfg = tgnn.GNNConfig(name="g", kind="gcn", d_in=16, d_hidden=32, n_classes=5)
    params = tgnn.init_gnn(torch.Generator().manual_seed(0), cfg, device="cpu")
    flat = [p.requires_grad_(True) for ps in params.values() for p in ps.values()]
    lr = 0.2
    with torch.no_grad():
        loss0 = float(tgnn.gnn_loss(params, cfg, g, x, labels, mask))
    for _ in range(40):
        loss = tgnn.gnn_loss(params, cfg, g, x, labels, mask)
        grads = torch.autograd.grad(loss, flat)
        with torch.no_grad():
            for p, gr in zip(flat, grads):
                p -= lr * gr
    with torch.no_grad():
        loss1 = float(tgnn.gnn_loss(params, cfg, g, x, labels, mask))
    assert loss1 < loss0 - 0.1, (loss0, loss1)


# ---------------------------------------------------------------------------
# the backward through the transposed plan
# ---------------------------------------------------------------------------
def _dense_block_graph(n=192, seed=3):
    """A graph whose T = 16 tiles are partly dense (nnz > T²/16 = 16 on the
    ladder (4, 16, 64)): three segments, the top one through the dense
    branch in both chains."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, n, 6 * n), rng.integers(0, 32, 900)])
    cols = np.concatenate([rng.integers(0, n, 6 * n), rng.integers(64, 96, 900)])
    a = gcn_normalize(COOMatrix(rows.astype(np.int32), cols.astype(np.int32),
                                np.ones(rows.size, np.float32), (n, n)))
    return JCOO(a.rows, a.cols, a.vals, a.shape), a


DENSE_KW = dict(tile=16, bucket_caps=(4, 16, 64))


@pytest.mark.parametrize("kind", KINDS)
def test_transposed_backward_grads_match_jax(rng, kind):
    """``gnn_loss``'s gradients through the transposed plan (bucketed, more
    than one segment, dense tiles in both directions) against ``jax.grad``
    of the reference, and the transposed plan kept for the next backward."""
    ja, ta = _dense_block_graph()
    jcfg, tcfg, jparams = _models(kind)
    n = ta.shape[0]
    x = rng.standard_normal((n, 12)).astype(np.float32)
    labels = rng.integers(0, 5, n)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    jg = jgnn.build_graph(ja, **DENSE_KW)
    want = jax.grad(lambda p: jgnn.gnn_loss(
        p, jcfg, jg, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mask)))(jparams)
    tparams = tgnn.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    flat = [p.requires_grad_(True) for ps in tparams.values() for p in ps.values()]
    tg = tgnn.build_graph(ta, device="cpu", **DENSE_KW)
    assert len([s for s in tg.plan.segments if s.n_tiles]) == 3
    assert tg.plan.segments[-1].runs.max_nnz > dense_tile_threshold(16)
    args = (torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(mask))
    grads = torch.autograd.grad(tgnn.gnn_loss(tparams, tcfg, tg, *args), flat)
    bw = ops.cached_backward(tg.plan)
    assert bw is not None
    t_live = [s for s in bw.plan_t.segments if s.n_tiles]
    assert len(t_live) == 3 and t_live[-1].runs.max_nnz > dense_tile_threshold(16)
    i = 0
    for layer, ps in tparams.items():
        for name in ps:
            assert_grad_close(grads[i].numpy(), want[layer][name])
            i += 1
    again = torch.autograd.grad(tgnn.gnn_loss(tparams, tcfg, tg, *args), flat)
    assert ops.cached_backward(tg.plan) is bw
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def _plain_backward(plan, z, g):
    """The chain's backward before the transposed plan: ``dz`` summed by
    ``index_add_`` over every segment's live entries, ``dvals`` by a
    gather and a row-sum."""
    dz, dvals = torch.zeros_like(z), []
    for seg in _segments(plan):
        slot = torch.arange(seg.vals.shape[1])
        t, s = (slot[None, :] < seg.nnz_in_tile[:, None]).nonzero(as_tuple=True)
        grow = seg.tile_row.long()[t] * seg.tile + seg.rows[t, s].long()
        gcol = seg.tile_col.long()[t] * seg.tile + seg.cols[t, s].long()
        dv = torch.zeros_like(seg.vals)
        dv[t, s] = (g[grow] * z[gcol]).sum(-1)
        dvals.append(dv)
        dz.index_add_(0, gcol, g[grow] * seg.vals[t, s][:, None])
    return dz, dvals


@pytest.mark.parametrize("layout", ["single", "buckets", "dense"])
def test_transposed_backward_bit_exact_on_integers(rng, layout):
    """On integer values, cotangents and features the transposed chain's
    ``dz`` and the live-index ``dvals`` equal the old plain backward's bit
    for bit (integer sums are exact in any order)."""
    if layout == "dense":
        _, tc = _dense_block_graph()
        tc = COOMatrix(tc.rows, tc.cols, rng.integers(-3, 4, tc.nnz).astype(np.float32), tc.shape)
        tp = plan_from_tiles_bucketed(coo_to_scv_tiles(tc, 16, cap=64), (4, 16, 64))
    else:
        _, tc = _coo(rng)
        tc = COOMatrix(tc.rows, tc.cols, rng.integers(-3, 4, tc.nnz).astype(np.float32), tc.shape)
        tp = _plans(_coo(rng)[0], tc, layout)[1]
    n = tc.shape[0]
    z = torch.from_numpy(rng.integers(-4, 5, (n, 8)).astype(np.float32))
    g = torch.from_numpy(rng.integers(-4, 5, (tp.padded_shape[0], 8)).astype(np.float32))
    vals = [s.vals.clone().requires_grad_(True) for s in _segments(tp)]
    zz = z.clone().requires_grad_(True)
    plan = _with_vals(tp, vals, SCVBucketedPlan)
    (ops.scv_spmm_plan(plan, zz) * g).sum().backward()
    want_dz, want_dv = _plain_backward(tp, z, g)
    assert torch.equal(zz.grad, want_dz)
    for v, w in zip(vals, want_dv):
        assert torch.equal(v.grad, w)


@pytest.mark.parametrize("layout", ["single", "buckets"])
def test_transposed_plan_equals_reference_builders_on_the_transpose(rng, layout):
    """The port's ``transposed_plan`` against a plan the reference's own
    builders make from Âᵀ's COO (duplicates included), leaf for leaf; its
    perm leaf points each slot at its forward entry, whose source COO
    entry is the reference's perm."""
    jc, tc = _coo(rng)
    _, tp = _plans(jc, tc, layout)
    at = JCOO(jc.cols, jc.rows, jc.vals, (jc.shape[1], jc.shape[0]))
    caps = tuple(s.cap for s in _segments(tp))
    jt = j_tiles(at, 16, cap=caps[-1])
    want = j_bucketed(jt, caps) if layout == "buckets" else j_plan(jt)
    got = transposed_plan(tp)
    assert type(got) is type(tp)
    fwd_perm = torch.cat([s.perm.reshape(-1) for s in _segments(tp)] + [torch.tensor([-1])])
    for gs, ws in zip(_segments(got), _segments(want)):
        for name in ("tile_row", "tile_col", "rows", "cols", "vals", "nnz_in_tile"):
            np.testing.assert_array_equal(getattr(gs, name).numpy(), np.asarray(getattr(ws, name)))
        assert (gs.tile, gs.cap, gs.shape, gs.order) == (ws.tile, ws.cap, tuple(ws.shape), ws.order)
        np.testing.assert_array_equal(fwd_perm[gs.perm.long()].numpy(), np.asarray(ws.perm))


def test_transposed_plan_follows_its_plan(rng):
    """Kept per run index: a reweighted plan (GAT) reuses it, a delta's
    patched plan gets its own, and leaves changed in place under it fail
    the ``transposed`` check as they fail ``run-index``."""
    n = 48
    _, coo = _coo(rng, n=n, density=0.1, duplicates=False)
    t = coo_to_scv_tiles(coo, 16, cap=64)
    plan = plan_from_tiles(t, with_perm=False)
    assert validate_plan(plan).ok and not validate_plan(plan).failed("transposed")
    z = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32)).requires_grad_(True)
    ops.scv_spmm_plan(plan, z).sum().backward()
    bw = ops.cached_backward(plan)
    assert bw is not None and ops.cached_backward(plan.with_vals(plan.vals * 2)) is bw
    rep = validate_plan(plan)
    assert rep.ok and [c.invariant for c in rep.checks].count("transposed") == 1

    have = set(zip(coo.rows.tolist(), coo.cols.tolist()))
    free = next((r, c) for r in range(n) for c in range(n) if (r, c) not in have)
    with_perm = plan_from_tiles(coo_to_scv_tiles(coo, 16, cap=64))
    ops.scv_spmm_plan(with_perm, z).sum().backward()
    patched = apply_delta(with_perm, DeltaBatch.of(inserts=[(*free, 2.0)]))
    assert ops.cached_backward(with_perm) is not None and ops.cached_backward(patched) is None
    zp = z.detach().clone().requires_grad_(True)
    ops.scv_spmm_plan(patched, zp).sum().backward()
    assert validate_plan(patched).ok
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (coo.rows, coo.cols), coo.vals)
    dense[free] += 2.0
    np.testing.assert_allclose(zp.grad.numpy(), dense.T @ np.ones((n, 4), np.float32),
                               rtol=1e-5, atol=1e-5)

    assert apply_delta(t, DeltaBatch.of(inserts=[(*free, 3.0)]), inplace=True) is t
    failed = {c.invariant for c in validate_plan(plan).failures}
    assert failed == {"run-index", "transposed"}
