"""The port's GNN models against the reference's eager jnp path: the four
layer kinds, single graphs and block-diagonal batches, with the
reference's weights carried over by ``params_from_jax``.  Tolerance
rtol = atol = 1e-5 (float32, sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gcn_paper as j_gcn_paper
from repro.core.formats import COOMatrix as JCOO
from repro.models import gnn as jgnn
from repro.serve import graph_engine as jeng
from repro_torch.configs import gcn_paper as t_gcn_paper
from repro_torch.models import gnn as tgnn
from repro_torch.serve import graph_engine as teng
from repro_torch.simul.datasets import gcn_normalize, powerlaw_graph

KINDS = ["gcn", "sage", "gin", "gat"]


def _pair(n, seed, per_node=4):
    a = gcn_normalize(powerlaw_graph(n, per_node * n, seed=seed))
    return JCOO(a.rows, a.cols, a.vals, a.shape), a


def _models(kind, d_in=12, d_hidden=16, n_classes=5, n_layers=2, seed=0):
    jcfg = jgnn.GNNConfig(name=kind, kind=kind, d_in=d_in, d_hidden=d_hidden,
                          n_classes=n_classes, n_layers=n_layers, backend="jnp")
    tcfg = tgnn.GNNConfig(name=kind, kind=kind, d_in=d_in, d_hidden=d_hidden,
                          n_classes=n_classes, n_layers=n_layers)
    jparams, _ = jgnn.init_gnn(jax.random.PRNGKey(seed), jcfg)
    if kind == "gin":  # a nonzero eps exercises the (1 + eps) h term
        jparams = {k: {**v, "eps": jnp.asarray(0.25, jnp.float32)} for k, v in jparams.items()}
    host = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tgnn.params_from_jax(host, device="cpu")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout", [dict(bucket_caps=(8, 32, 128)), dict(backend_cap=64)])
def test_forward_matches_reference(kind, layout, rng):
    ja, ta = _pair(300, seed=1)
    jcfg, tcfg, jparams, tparams = _models(kind)
    x = rng.standard_normal((300, 12)).astype(np.float32)
    want = np.asarray(jgnn.gnn_forward(
        jparams, jcfg, jgnn.build_graph(ja, tile=64, **layout), jnp.asarray(x)))
    got = tgnn.gnn_forward(
        tparams, tcfg, tgnn.build_graph(ta, tile=64, device="cpu", **layout), torch.from_numpy(x)
    ).numpy()
    assert got.shape == want.shape == (300, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_batched_forward_matches_reference(kind, rng):
    pairs = [_pair(n, seed=10 + i) for i, n in enumerate([90, 150, 60])]
    jcfg, tcfg, jparams, tparams = _models(kind, n_layers=3)
    xs = [rng.standard_normal((j.shape[0], 12)).astype(np.float32) for j, _ in pairs]
    kw = dict(tile=64, bucket_caps=(8, 32, 128))
    jb = jeng.assemble_batched_graph([jgnn.build_graph(j, **kw) for j, _ in pairs], 64, 512)
    tb = teng.assemble_batched_graph(
        [tgnn.build_graph(t, device="cpu", **kw) for _, t in pairs], 64, 512)
    # the reference's eager forward over its composite, split per request
    jout = np.asarray(jgnn.gnn_forward(jparams, jcfg, jb.graph, jgnn.batch_features(jb, xs)))
    want = [jout[s : s + c] for s, c in zip(jb.node_offsets, jb.node_counts)]
    got = tgnn.gnn_forward_batched(tparams, tcfg, tb, xs)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_batch_features_and_split_outputs(rng):
    pairs = [_pair(n, seed=20 + i) for i, n in enumerate([30, 70])]
    tb = teng.assemble_batched_graph(
        [tgnn.build_graph(t, bucket_caps=(8, 32), device="cpu") for _, t in pairs], 64, 256)
    xs = [rng.standard_normal((t.shape[0], 3)).astype(np.float32) for _, t in pairs]
    x = tgnn.batch_features(tb, xs)
    assert x.shape == (256, 3)
    assert float(x[30:64].abs().sum()) == 0.0  # tile-alignment padding rows
    outs = tgnn.split_outputs(tb, x)
    for o, xi in zip(outs, xs):
        np.testing.assert_array_equal(o, xi)
    with pytest.raises(ValueError, match="feature blocks"):
        tgnn.batch_features(tb, xs[:1])


def test_gat_needs_edges():
    _, ta = _pair(80, seed=3)
    _, tcfg, _, tparams = _models("gat")
    g = tgnn.build_graph(ta, with_edges=False, device="cpu")
    with pytest.raises(ValueError, match="COO edge arrays"):
        tgnn.gnn_forward(tparams, tcfg, g, torch.zeros(80, 12))


def test_init_gnn_is_seeded_and_shaped_like_reference():
    for kind in KINDS:
        jcfg, tcfg, jparams, _ = _models(kind, n_layers=3)
        a = tgnn.init_gnn(torch.Generator().manual_seed(3), tcfg, device="cpu")
        b = tgnn.init_gnn(torch.Generator().manual_seed(3), tcfg, device="cpu")
        assert a.keys() == jparams.keys()
        for layer in a:
            assert a[layer].keys() == jparams[layer].keys()
            for k in a[layer]:
                assert tuple(a[layer][k].shape) == tuple(jparams[layer][k].shape)
                assert torch.equal(a[layer][k], b[layer][k])


def test_gcn_paper_configs_match_reference():
    for tc, jc in [(t_gcn_paper.full, j_gcn_paper._full),
                   (t_gcn_paper.reduced, j_gcn_paper._reduced)]:
        assert (tc.name, tc.kind, tc.d_in, tc.d_hidden, tc.n_classes, tc.n_layers) == (
            jc.name, jc.kind, jc.d_in, jc.d_hidden, jc.n_classes, jc.n_layers)


def test_build_graph_argument_rules():
    _, ta = _pair(50, seed=4)
    from repro_torch.tune.config import TunedConfig

    with pytest.raises(ValueError, match="mutually exclusive"):
        tgnn.build_graph(ta, backend_cap=8, bucket_caps=(8, 32), device="cpu")
    with pytest.raises(ValueError, match="config carries"):
        tgnn.build_graph(ta, bucket_caps=(8,), config=TunedConfig(), device="cpu")
    with pytest.raises(ValueError, match="ascending"):
        tgnn.build_graph(ta, bucket_caps=(32, 8), device="cpu")
    g = tgnn.build_graph(ta, config=TunedConfig(bucket_caps=(), cap=16), device="cpu")
    assert g.plan.cap == 16


@pytest.mark.parametrize("pad_nodes,backend_cap", [(None, None), (512, 32)])
def test_build_batched_graph_matches_reference(pad_nodes, backend_cap, rng):
    """The public composite builder on three graphs: the reference's plan
    leaves and offsets, and its forward per request."""
    pairs = [_pair(n, seed=30 + i) for i, n in enumerate([90, 150, 60])]
    jb = jgnn.build_batched_graph([j for j, _ in pairs], tile=64, backend_cap=backend_cap,
                                  pad_nodes=pad_nodes)
    tb = tgnn.build_batched_graph([t for _, t in pairs], tile=64, backend_cap=backend_cap,
                                  pad_nodes=pad_nodes, device="cpu")
    np.testing.assert_array_equal(tb.node_offsets, jb.node_offsets)
    np.testing.assert_array_equal(tb.node_counts, jb.node_counts)
    assert (tb.n_real_nodes, tb.n_graphs, tb.graph.n_nodes) == (
        jb.n_real_nodes, jb.n_graphs, jb.graph.n_nodes)
    assert (tb.graph.plan.tile, tb.graph.plan.cap, tb.graph.plan.shape) == (
        jb.graph.plan.tile, jb.graph.plan.cap, jb.graph.plan.shape)
    for leaf in ("tile_row", "tile_col", "rows", "cols", "vals", "nnz_in_tile", "perm"):
        np.testing.assert_array_equal(getattr(tb.graph.plan, leaf).numpy(),
                                      np.asarray(getattr(jb.graph.plan, leaf)), err_msg=leaf)
    jcfg, tcfg, jparams, tparams = _models("gcn")
    xs = [rng.standard_normal((t.shape[0], 12)).astype(np.float32) for _, t in pairs]
    jout = np.asarray(jgnn.gnn_forward(jparams, jcfg, jb.graph, jgnn.batch_features(jb, xs)))
    got = tgnn.gnn_forward_batched(tparams, tcfg, tb, xs)
    for g, s, c in zip(got, jb.node_offsets, jb.node_counts):
        np.testing.assert_allclose(g, jout[s : s + c], rtol=1e-5, atol=1e-5)


def test_build_batched_graph_refusals():
    _, a = _pair(40, seed=5)
    with pytest.raises(ValueError, match="pad_nodes"):
        tgnn.build_batched_graph([a, a], pad_nodes=60, device="cpu")
    rect = a.__class__(a.rows, a.cols, a.vals, (40, 41))
    with pytest.raises(ValueError, match="square"):
        tgnn.build_batched_graph([rect], device="cpu")
