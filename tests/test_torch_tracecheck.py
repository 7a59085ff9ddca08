"""The port's trace-hazard analysis (``core/tracecheck.py``) against the
reference's (``tests/test_tracecheck.py``): the same injected hazards give
the same hazard kinds, a clean graph gives none, and the captured forward
keys a serving engine's waves once per padding bucket, as the reference's
``gnn_forward_jit`` traces once per bucket
(``tests/test_scv_plan.py::test_jit_retraces_once_per_padding_bucket``).
Also, on the CPU, the pieces a capture on the card stands on: the padded
run-index tables hold every run index of their shapes, and GAT's padding
edges (into the sink row) change no output."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tracecheck as jtc
from repro.core.formats import COOMatrix as JCOO
from repro.models import gnn as jgnn
from repro_torch.core import scv as tscv
from repro_torch.core import tracecheck as ttc
from repro_torch.core.exec import PlanExecutor, ShardingDecision
from repro_torch.models import gnn as tgnn
from repro_torch.serve.graph_engine import (
    GraphEngineConfig,
    GraphRequest,
    GraphServeEngine,
    assemble_batched_graph,
)
from repro_torch.simul.datasets import gcn_normalize, powerlaw_graph

KINDS = ("gcn", "sage", "gin", "gat")
CPU = torch.device("cpu")


def _coo(n, edges, seed):
    return gcn_normalize(powerlaw_graph(n, edges, seed=seed))


def _graphs(n, edges, seed, with_edges=False):
    """The same graph in both packages, as the reference's test builds it."""
    a = _coo(n, edges, seed)
    jg = jgnn.build_graph(JCOO(a.rows, a.cols, a.vals, a.shape), tile=16, backend_cap=None,
                          with_edges=with_edges, bucket_caps=(8, 32))
    tg = tgnn.build_graph(a, tile=16, with_edges=with_edges, bucket_caps=(8, 32),
                          device="cpu")
    return jg, tg


def _features(n, d, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _cfgs(kind):
    kw = dict(name=kind, kind=kind, d_in=8, d_hidden=16, n_classes=4, n_layers=2)
    return jgnn.GNNConfig(backend="jnp", **kw), tgnn.GNNConfig(**kw)


def _kinds(hazards):
    return sorted({h.kind for h in hazards})


# ---------------------------------------------------------------------------
# hazards: the same kinds as the reference
# ---------------------------------------------------------------------------
def test_float64_features_give_the_reference_kinds():
    jg, tg = _graphs(64, 300, seed=1)
    x64 = np.random.default_rng(0).standard_normal((64, 8))
    want = _kinds(jtc.check_leaf_dtypes((jg, x64), where="inj"))
    got = _kinds(ttc.check_leaf_dtypes((tg, torch.from_numpy(x64)), where="inj"))
    assert got == want == ["float64-leak"]


def test_index_leaf_of_another_width_is_flagged():
    _, tg = _graphs(64, 300, seed=1, with_edges=True)
    wide = dataclasses.replace(tg, rows=tg.rows.long())
    assert _kinds(ttc.check_leaf_dtypes(wide)) == ["index-dtype"]


@pytest.mark.parametrize("meta,kind", [([1, 2, 3], "unhashable-aux"),
                                       (np.arange(4), "array-aux")])
def test_bad_static_fields_give_the_reference_kinds(meta, kind):
    @jax.tree_util.register_pytree_node_class
    @dataclasses.dataclass
    class JBadAux:
        x: object
        meta: object

        def tree_flatten(self):
            return (self.x,), (self.meta,)

        @classmethod
        def tree_unflatten(cls, aux, children):
            return cls(children[0], aux[0])

    @dataclasses.dataclass
    class TBadAux:
        x: object
        meta: object

        def tree_flatten(self):
            return (self.x,), (self.meta,)

    want = _kinds(jtc.check_static_aux(JBadAux(jnp.ones(3), meta), where="inj"))
    got = _kinds(ttc.check_static_aux(TBadAux(torch.ones(3), meta), where="inj"))
    assert kind in want and got == want


def test_raising_forward_gives_the_reference_kinds():
    def broken(x):
        raise RuntimeError("boom")

    want = jtc.eval_shape_hazards(broken, jnp.ones(3), where="inj")
    got = ttc.eval_shape_hazards(broken, torch.ones(3), where="inj")
    assert [h.kind for h in got] == [h.kind for h in want] == ["trace-error"]
    assert "boom" in got[0].detail


def test_bad_outputs_are_flagged():
    want = _kinds(jtc.eval_shape_hazards(lambda x: (x.astype(jnp.float64), x.astype(jnp.int32)),
                                         jnp.ones(4, jnp.float32), where="inj"))
    got = _kinds(ttc.eval_shape_hazards(lambda x: (x.double(), x.int()), torch.ones(4),
                                        where="inj"))
    assert "bad-output-dtype" in want and set(want) <= set(got)
    assert "float64-leak" in got  # x64 is off in the reference: its f64 cast stays f32


@pytest.mark.parametrize("with_edges", [False, True])
def test_clean_graph_has_no_hazards(with_edges):
    jg, tg = _graphs(64, 300, seed=1, with_edges=with_edges)
    jx, tx = _features(64, 8)
    assert jtc.check_leaf_dtypes((jg, jx)) == [] and jtc.check_static_aux(jg) == []
    assert ttc.check_leaf_dtypes((tg, tx)) == [] and ttc.check_static_aux(tg) == []


# ---------------------------------------------------------------------------
# one key per padding bucket
# ---------------------------------------------------------------------------
def test_trace_check_one_capture_per_bucket_all_kinds():
    jmodels, tmodels, jexs, texs = {}, {}, {}, {}
    for kind in KINDS:
        jcfg, tcfg = _cfgs(kind)
        jparams, _ = jgnn.init_gnn(jax.random.PRNGKey(0), jcfg)
        jmodels[kind] = (jparams, jcfg)
        tmodels[kind] = (tgnn.params_from_jax(jparams, device="cpu"), tcfg)
        edges = kind == "gat"
        (j64, t64), (j96, t96) = _graphs(64, 300, 1, edges), _graphs(96, 500, 2, edges)
        feats = [_features(64, 8, 1), _features(96, 8, 2), _features(64, 8, 3)]
        jexs[kind] = [(j64, feats[0][0]), (j96, feats[1][0]), (j64, feats[2][0])]
        texs[kind] = [(t64, feats[0][1]), (t96, feats[1][1]), (t64, feats[2][1])]
    want = jtc.trace_check(jmodels, jexs)
    got = ttc.trace_check(tmodels, texs)
    assert got.ok, got.summary()
    assert _kinds(got.hazards) == _kinds(want.hazards)
    by_model = {}
    for (name, _sig), n in got.retraces:
        by_model.setdefault(name, []).append(n)
    assert by_model == {kind: [1, 1] for kind in KINDS}
    assert "trace bucket" in got.summary() and "no trace hazards" in got.summary()


def test_capture_counter_counts_captures_not_calls():
    _, tg = _graphs(64, 300, seed=1)
    _, tg96 = _graphs(96, 500, seed=2)
    _, tcfg = _cfgs("gcn")
    params = tgnn.init_gnn(torch.Generator().manual_seed(0), tcfg, device="cpu")
    counter = ttc.CaptureCounter()
    for seed in range(3):
        counter(params, tcfg, tg, _features(64, 8, seed)[1])
    assert (counter.traces, counter.replays) == (1, 2)
    counter(params, tcfg, tg96, _features(96, 8)[1])
    assert counter.traces == 2
    counter.clear_cache()  # the next call of a known key captures again
    counter(params, tcfg, tg, _features(64, 8)[1])
    assert counter.traces == 3


def test_engine_captures_once_per_padding_bucket():
    """Counterpart of the reference's retrace test, on a CPU engine: waves
    of one node bucket and one tile-count bucket mint one forward key."""
    _, cfg = _cfgs("gcn")
    cfg = dataclasses.replace(cfg, d_hidden=8)
    params = tgnn.init_gnn(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = GraphServeEngine({"gcn": (params, cfg)}, GraphEngineConfig(tile=64, cap=64),
                           device="cpu")
    rng = np.random.default_rng(0)

    def serve_wave(sizes, seed):
        for i, n in enumerate(sizes):
            a = _coo(n, 4 * n, seed + i)
            x = rng.standard_normal((n, 8)).astype(np.float32)
            eng.submit(GraphRequest(rid=seed * 100 + i, adj=a, x=x, model="gcn"))
        eng.run()

    serve_wave([60, 90], seed=5)
    base = eng.metrics()["forward_captures"]
    assert base == 1
    serve_wave([70, 80], seed=6)
    serve_wave([50, 95], seed=7)
    m = eng.metrics()
    assert m["forward_captures"] == base and m["forward_replays"] == 2
    serve_wave([400, 500], seed=8)
    assert eng.metrics()["forward_captures"] <= base + 1


@pytest.mark.parametrize("kind", ["gat", "sage"])
def test_one_bucket_composites_share_a_key(kind):
    _, cfg = _cfgs(kind)
    params = tgnn.init_gnn(torch.Generator().manual_seed(0), cfg, device="cpu")
    keys = []
    for sizes, seed in (([60, 90], 5), ([70, 80], 6)):
        members = [tgnn.build_graph(_coo(n, 4 * n, seed + i), tile=64, bucket_caps=(8, 32, 128),
                                    device="cpu") for i, n in enumerate(sizes)]
        bg = assemble_batched_graph(members, 64, 256, with_edges=kind == "gat")
        x = torch.zeros((bg.graph.n_nodes, cfg.d_in))
        keys.append(ttc.bucket_signature(params, cfg, bg.graph, x))
        assert keys[-1] == tgnn.forward_key(params, cfg, bg.graph, x)
    assert keys[0] == keys[1]


def test_placed_plan_is_refused():
    _, tg = _graphs(64, 300, seed=1)
    _, cfg = _cfgs("gcn")
    params = tgnn.init_gnn(torch.Generator().manual_seed(0), cfg, device="cpu")
    placed = PlanExecutor(devices=(CPU,) * 2).prepare_graph(
        tg, decision=ShardingDecision("tiles", 2, 1))
    with pytest.raises(ValueError, match="placed plan runs eagerly"):
        tgnn.CapturedForward()(params, cfg, placed, _features(64, 8)[1])


# ---------------------------------------------------------------------------
# what a capture on the card stands on
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("unit_work", [64, 256, 2048])
def test_padded_run_index_holds_every_composite_of_its_shapes(monkeypatch, unit_work):
    monkeypatch.setattr(tscv, "UNIT_WORK", unit_work)
    shapes = {}
    for seed in range(6):
        sizes = np.random.default_rng(seed).integers(20, 300, 4)
        members = [tgnn.build_graph(_coo(int(n), 5 * int(n), seed * 10 + i), tile=16,
                                    bucket_caps=(8, 32), device="cpu")
                   for i, n in enumerate(sizes)]
        bg = assemble_batched_graph(members, 16, 1024, with_edges=False)
        for s in bg.graph.plan.segments:
            if not s.n_tiles:
                continue
            key = (s.n_tiles, s.n_row_blocks, s.cap)
            pad = shapes.setdefault(key, tscv.RunIndex.padded(*key, CPU))
            r = s.runs
            pad.load(r)  # raises if the bounds do not hold
            n = r.n_units
            assert torch.equal(pad.units[:n], r.units)
            assert bool((pad.units[n:, 2] == -1).all())
            assert torch.equal(pad.unit_ptr[: r.n_runs + 1], r.unit_ptr)
            assert torch.equal(pad.order[:n], r.order)
            assert bool((pad.order[n:] >= n).all()) and pad.max_nnz == s.cap
            assert pad.n_units <= s.n_tiles and r.n_split_units <= pad.n_split_units


def test_gat_padding_edges_change_no_output():
    _, cfg = _cfgs("gat")
    params = tgnn.init_gnn(torch.Generator().manual_seed(0), cfg, device="cpu")
    _, g = _graphs(96, 500, seed=2, with_edges=True)
    x = _features(96, 8)[1]
    n_pad = tgnn.edge_capacity(g.plan) - g.rows.shape[0]
    assert n_pad > 0
    padded = dataclasses.replace(
        g,
        rows=torch.cat([g.rows, torch.full((n_pad,), g.n_nodes, dtype=g.rows.dtype)]),
        cols=torch.cat([g.cols, torch.zeros(n_pad, dtype=g.cols.dtype)]),
        vals=torch.cat([g.vals, torch.zeros(n_pad, dtype=g.vals.dtype)]),
    )
    assert torch.equal(tgnn.gnn_forward(params, cfg, padded, x),
                       tgnn.gnn_forward(params, cfg, g, x))
