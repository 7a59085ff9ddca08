"""The port's serving engine against the reference's: the same request
stream through both ``GraphServeEngine``s gives the same outputs (rtol =
atol = 1e-5) and the same count of kernel launches — tracked graphs and
their ``update()`` deltas included, between waves and under the async
loop — ``debug_validate`` accepts good composites and raises on a corrupt
member, and under ``autotune`` both resolve the same config per graph
regime and form the same waves, none mixing two configs.  Composites over a shard threshold are placed on a pool of CPU
devices (``core.exec.PlanExecutor``) and served like the reference's
single-device engine serves them (its own sharded path fails under the
installed jax, ROADMAP §3), with the kernel wrapper called exactly as
often as the engine counts."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import stream as jstream
from repro.core.formats import COOMatrix as JCOO
from repro.models import gnn as jgnn
from repro.serve import graph_engine as jeng
from repro_torch.core.exec import PlanExecutor
from repro_torch.kernels.scv_spmm import ops as tops
from repro_torch.launch import graph_serve as tlaunch
from repro_torch.models import gnn as tgnn
from repro_torch.serve import graph_engine as teng
from repro_torch.serve.plan_cache import PlanCache, plan_nbytes
from repro_torch.core.validate import PlanInvariantError
from repro_torch.simul.datasets import gcn_normalize, powerlaw_edges, powerlaw_graph
from repro_torch.stream import DeltaBatch, apply_coo

ENGINE_KW = dict(max_batch_graphs=4, max_batch_nodes=1024, node_buckets=(512, 1024))


def _pool(sizes=(90, 200, 140, 310, 60)):
    return [gcn_normalize(powerlaw_graph(n, 3 * n, seed=i)) for i, n in enumerate(sizes)]


def _engines(kind, d_in=8, executor=None, port_cfg=None, **cfg):
    """A reference and a port engine on ``cfg``; the port's also gets
    ``port_cfg`` and ``executor``."""
    jcfg = jgnn.GNNConfig(name=kind, kind=kind, d_in=d_in, d_hidden=16, n_classes=4,
                          backend="jnp")
    tcfg = tgnn.GNNConfig(name=kind, kind=kind, d_in=d_in, d_hidden=16, n_classes=4)
    jparams, _ = jgnn.init_gnn(jax.random.PRNGKey(0), jcfg)
    tparams = tgnn.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    kw = {**ENGINE_KW, **cfg}
    je = jeng.GraphServeEngine({kind: (jparams, jcfg)}, jeng.GraphEngineConfig(**kw))
    te = teng.GraphServeEngine({kind: (tparams, tcfg)},
                               teng.GraphEngineConfig(**kw, **(port_cfg or {})),
                               device="cpu", executor=executor)
    return je, te


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_engine_matches_reference_engine(kind, monkeypatch):
    pool = _pool()
    je, te = _engines(kind)
    calls = _count_launches(monkeypatch)
    rng = np.random.default_rng(5)
    for rid in range(14):
        a = pool[int(rng.integers(len(pool)))]
        x = rng.standard_normal((a.shape[0], 8)).astype(np.float32)
        je.submit(jeng.GraphRequest(rid=rid, adj=JCOO(a.rows, a.cols, a.vals, a.shape),
                                    x=x, model=kind))
        te.submit(teng.GraphRequest(rid=rid, adj=a, x=x, model=kind))
    jdone = {r.rid: r.out for r in je.run()}
    tdone = {r.rid: r.out for r in te.run()}
    assert sorted(tdone) == sorted(jdone) == list(range(14))
    for rid in jdone:
        assert tdone[rid].shape == jdone[rid].shape
        np.testing.assert_allclose(tdone[rid], jdone[rid], rtol=1e-5, atol=1e-5)
    jm, tm = je.metrics(), te.metrics()
    # the port counts its own launches: one a chain, where the reference
    # launches once a non-empty capacity segment
    assert len(calls) == tm["launches"] > 0 and tm["launches"] <= jm["launches"]
    assert (tm["waves"], tm["batches"], tm["completed"]) == (jm["waves"], jm["batches"], 14)
    assert tm["device"] == "cpu"


def test_queue_snapshot_matches_reference_engine():
    """``queue``: the queued requests, in order, as the reference's engine
    lists them on the same submissions; a snapshot (a new list each time)
    that ``run()`` empties."""
    pool = _pool()
    je, te = _engines("gcn")
    assert te.queue == [] and je.queue == []
    rng = np.random.default_rng(2)
    for rid in range(6):
        a = pool[rid % len(pool)]
        x = rng.standard_normal((a.shape[0], 8)).astype(np.float32)
        je.submit(jeng.GraphRequest(rid=rid, adj=JCOO(a.rows, a.cols, a.vals, a.shape),
                                    x=x, model="gcn"))
        te.submit(teng.GraphRequest(rid=rid, adj=a, x=x, model="gcn"))
    got = te.queue
    assert [r.rid for r in got] == [r.rid for r in je.queue] == list(range(6))
    got.clear()
    assert len(te.queue) == 6
    te.run()
    je.run()
    assert te.queue == [] and je.queue == []


def test_async_loop_serves_like_sync():
    pool = _pool()
    _, sync = _engines("gcn")
    _, loop = _engines("gcn")
    rng = np.random.default_rng(6)
    reqs = []
    for rid in range(10):
        a = pool[int(rng.integers(len(pool)))]
        x = rng.standard_normal((a.shape[0], 8)).astype(np.float32)
        reqs.append((a, x))
        sync.submit(teng.GraphRequest(rid=rid, adj=a, x=x, model="gcn"))
    want = {r.rid: r.out for r in sync.run()}
    loop.start()
    try:
        live = [loop.submit(teng.GraphRequest(rid=i, adj=a, x=x, model="gcn"))
                for i, (a, x) in enumerate(reqs)]
        got = {r.rid: r.result(timeout=60) for r in live}
    finally:
        loop.stop(timeout=30)
    assert not loop.running
    for rid, out in want.items():
        np.testing.assert_allclose(got[rid], out, rtol=1e-5, atol=1e-5)
    assert loop.metrics()["completed"] == 10


def test_composite_cache_hits_on_repeated_wave():
    pool = _pool()
    _, te = _engines("gcn")
    x = [np.ones((a.shape[0], 8), np.float32) for a in pool[:3]]
    for _ in range(2):
        for i, a in enumerate(pool[:3]):
            te.submit(teng.GraphRequest(rid=i, adj=a, x=x[i], model="gcn"))
        te.run()
    m = te.metrics()
    assert m["plan_cache_hits"] >= 1 and m["batches"] == 2
    assert m["plan_cache_bytes"] > 0


def test_submit_validates_requests():
    pool = _pool()
    _, te = _engines("gcn")
    a = pool[0]
    with pytest.raises(KeyError):
        te.submit(teng.GraphRequest(rid=0, adj=a, x=np.zeros((a.shape[0], 8), np.float32),
                                    model="nope"))
    with pytest.raises(ValueError, match="incompatible"):
        te.submit(teng.GraphRequest(rid=0, adj=a, x=np.zeros((a.shape[0], 3), np.float32),
                                    model="gcn"))
    bad = a.__class__(a.rows + a.shape[0], a.cols, a.vals, a.shape)
    with pytest.raises(ValueError, match="out of range"):
        te.submit(teng.GraphRequest(rid=0, adj=bad, x=np.zeros((a.shape[0], 8), np.float32),
                                    model="gcn"))


@pytest.mark.parametrize("field,value,slice_name", [
    # the sharding slice has come: only thresholds that are not positive
    ("shard_nodes_threshold", 0, "positive"),
    ("shard_nnz_threshold", -10, "positive"),
])
def test_config_refuses_later_slices(field, value, slice_name):
    with pytest.raises(ValueError, match=slice_name):
        teng.GraphEngineConfig(**{field: value})


@pytest.mark.parametrize("calibrate", [False, True])
def test_config_autotune_builds_an_engine_with_a_tuner(tmp_path, calibrate):
    """The tuner slice has come: ``autotune=True`` is accepted and gives the
    engine a tuner on its own device, on the store the config names."""
    store = str(tmp_path / "tune.json")
    _, te = _engines("gcn", port_cfg=dict(autotune=True, autotune_calibrate=calibrate,
                                          autotune_store=store))
    assert te.tuner is not None and te.tuner.device == te.device
    assert te.tuner.calibrate is calibrate
    assert str(te.tuner.store.path) == store
    m = te.metrics()
    assert m["autotune_enabled"] and m["autotune_searches"] == 0
    assert m["resolved_configs"] == {} and m["tracked_graph_configs"] == {}
    _, plain = _engines("gcn")
    assert plain.tuner is None and not plain.metrics()["autotune_enabled"]


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a GPU the default device raises instead of running on the
    CPU under a GPU's name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = _pool((50,))[0]
    cfg = tgnn.GNNConfig(name="gcn", kind="gcn", d_in=8, d_hidden=8, n_classes=2)
    params = tgnn.init_gnn(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.GraphServeEngine({"gcn": (params, cfg)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgnn.build_graph(a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgnn.init_gnn(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.build_default_engine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--requests", "2"])


def test_launcher_runs_on_cpu_when_asked(capsys):
    stats = tlaunch.main(["--device", "cpu", "--requests", "6", "--rate", "500",
                          "--d-in", "8"])
    assert stats["completed"] == 6
    assert "on cpu" in capsys.readouterr().out


def test_plan_nbytes_counts_tensors_and_arrays():
    t = torch.zeros(10, dtype=torch.int32)
    arr = np.zeros(3, np.float64)
    assert plan_nbytes({"a": t, "b": [t, arr], "c": None}) == 40 + 24
    g = tgnn.build_graph(_pool((80,))[0], bucket_caps=(8, 32), device="cpu")
    nb = plan_nbytes(g)
    leaves = sum(getattr(s, k).numel() * getattr(s, k).element_size()
                 for s in g.plan.segments
                 for k in ("tile_row", "tile_col", "rows", "cols", "vals", "nnz_in_tile", "perm"))
    assert nb > leaves
    cache = PlanCache(max_entries=4, max_bytes=nb)
    cache.put("g", g)
    assert cache.stats.bytes_in_use == nb


# ---------------------------------------------------------------------------
# tracked graphs: graph_id, update(), anchoring, debug validation
# ---------------------------------------------------------------------------
def _jcoo(a):
    return JCOO(a.rows, a.cols, a.vals, a.shape)


def _jdelta(d):
    return jstream.DeltaBatch(d.ins_rows, d.ins_cols, d.ins_vals, d.rem_rows, d.rem_cols)


def _mixed_delta(rng, adj, n_update, n_remove, n_insert):
    """Value updates, removes and inserts of fresh edges on ``adj``."""
    idx = rng.choice(adj.nnz, size=n_update + n_remove, replace=False)
    coords = [(int(adj.rows[i]), int(adj.cols[i])) for i in idx]
    have = set(zip(adj.rows.tolist(), adj.cols.tolist()))
    fresh = []
    while len(fresh) < n_insert:
        r, c = (int(v) for v in rng.integers(adj.shape[0], size=2))
        if (r, c) not in have and (r, c) not in fresh:
            fresh.append((r, c))
    inserts = [(r, c, float(rng.uniform(0.1, 1.0))) for r, c in coords[:n_update] + fresh]
    return DeltaBatch.of(inserts=inserts, removes=coords)


def _submit_both(je, te, rid, x, adj=None, graph_id=None, model="gcn"):
    je.submit(jeng.GraphRequest(rid=rid, adj=None if adj is None else _jcoo(adj), x=x,
                                model=model, graph_id=graph_id))
    te.submit(teng.GraphRequest(rid=rid, adj=adj, x=x, model=model, graph_id=graph_id))


def _run_both(je, te):
    jdone = {r.rid: r.out for r in je.run()}
    tdone = {r.rid: r.out for r in te.run()}
    assert sorted(jdone) == sorted(tdone)
    for rid in jdone:
        np.testing.assert_allclose(tdone[rid], jdone[rid], rtol=1e-5, atol=1e-5)
    return tdone


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_tracked_updates_between_waves_match_reference_engine(kind, monkeypatch):
    pool = _pool()
    je, te = _engines(kind, anchor_every=3)
    calls = _count_launches(monkeypatch)
    rng = np.random.default_rng(8)
    xs = [rng.standard_normal((a.shape[0], 8)).astype(np.float32) for a in pool]
    # two tracked graphs and an untracked one share the waves
    _submit_both(je, te, 0, xs[0], adj=pool[0], graph_id="a", model=kind)
    _submit_both(je, te, 1, xs[1], adj=pool[1], graph_id="b", model=kind)
    _submit_both(je, te, 2, xs[2], adj=pool[2], model=kind)
    _run_both(je, te)
    rid = 3
    for step in range(4):
        for gid, k in (("a", 0), ("b", 1)):
            cur = te.tracked_adj(gid)
            d = _mixed_delta(rng, cur, 3, 2 + step % 2, 2 + step)
            assert te.update(gid, d) == je.update(gid, _jdelta(d))
        for gid, k in (("a", 0), ("b", 1)):
            _submit_both(je, te, rid, xs[k], graph_id=gid, model=kind)
            rid += 1
        _submit_both(je, te, rid, xs[2], adj=pool[2], model=kind)
        rid += 1
        _run_both(je, te)
    for gid in ("a", "b"):
        t, j = te.tracked_adj(gid), je.tracked_adj(gid)
        for f in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    jm, tm = je.metrics(), te.metrics()
    for k in ("graph_updates", "plan_cache_revalidated", "plan_cache_anchored",
              "tracked_graphs", "batches"):
        assert tm[k] == jm[k], k
    assert len(calls) == tm["launches"] > 0 and tm["launches"] <= jm["launches"]
    assert tm["graph_updates"] == tm["plan_cache_revalidated"] == 8
    assert tm["plan_cache_anchored"] == 2  # each graph crossed anchor_every = 3 once


def test_tracked_output_is_the_rebuilt_post_delta_graph():
    adj = _pool((200,))[0]
    _, te = _engines("gcn")
    x = np.random.default_rng(9).standard_normal((200, 8)).astype(np.float32)
    te.submit(teng.GraphRequest(rid=0, adj=adj, x=x, model="gcn", graph_id="g"))
    before = te.run()[0].out
    d = _mixed_delta(np.random.default_rng(10), adj, 4, 3, 5)
    te.submit(teng.GraphRequest(rid=1, x=x, model="gcn", graph_id="g"))
    te.update("g", d)  # lands while rid 1 is queued: served at wave time
    after = te.run()[0].out
    params, mcfg = te.models["gcn"]
    g = tgnn.build_graph(apply_coo(adj, d), bucket_caps=te.cfg.bucket_caps, device="cpu")
    want = tgnn.gnn_forward(params, mcfg, g, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(after, want, rtol=1e-5, atol=1e-5)
    assert np.abs(after - before).max() > 0
    m = te.metrics()
    assert (m["graph_updates"], m["plan_cache_revalidated"], m["tracked_graphs"]) == (1, 1, 1)


def test_tracked_updates_under_async_loop_match_reference_engine():
    pool = _pool()
    je, te = _engines("gcn")
    rng = np.random.default_rng(11)
    xs = [rng.standard_normal((a.shape[0], 8)).astype(np.float32) for a in pool[:3]]
    deltas, cur = [], pool[0]
    for step in range(3):
        d = _mixed_delta(rng, cur, 3, 2, 3)
        deltas.append(d)
        cur = apply_coo(cur, d)
    # the reference serves the sequence synchronously
    je.submit(jeng.GraphRequest(rid=0, adj=_jcoo(pool[0]), x=xs[0], model="gcn", graph_id="g"))
    je.run()
    want = {}
    for step, d in enumerate(deltas):
        je.update("g", _jdelta(d))
        je.submit(jeng.GraphRequest(rid=10 + step, x=xs[0], model="gcn", graph_id="g"))
        want[10 + step] = je.run()[0].out
    te.start()
    try:
        te.submit(teng.GraphRequest(rid=0, adj=pool[0], x=xs[0], model="gcn",
                                    graph_id="g")).result(timeout=60)
        got = {}
        for step, d in enumerate(deltas):
            # co-traffic in flight while the update goes through the loop
            noise = [te.submit(teng.GraphRequest(rid=100 + 10 * step + i, adj=pool[1 + i],
                                                 x=xs[1 + i], model="gcn")) for i in range(2)]
            te.update("g", d)
            probe = te.submit(teng.GraphRequest(rid=10 + step, x=xs[0], model="gcn",
                                                graph_id="g"))
            got[probe.rid] = probe.result(timeout=60)
            for r in noise:
                r.result(timeout=60)
    finally:
        te.stop(timeout=30)
    for rid, out in want.items():
        np.testing.assert_allclose(got[rid], out, rtol=1e-5, atol=1e-5)
    m = te.metrics()
    # the member plan was cached by the first wave: every update patched it
    assert m["graph_updates"] == m["plan_cache_revalidated"] == 3
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(te.tracked_adj("g"), f), getattr(cur, f))


def test_anchor_rejoins_content_keys_and_counts():
    adj = _pool((150,))[0]
    x = np.ones((150, 8), np.float32)
    rng = np.random.default_rng(12)
    for every, anchored in ((2, 2), (0, 0)):
        _, te = _engines("gcn", anchor_every=every)
        te.submit(teng.GraphRequest(rid=0, adj=adj, x=x, model="gcn", graph_id="g"))
        te.run()
        for _ in range(4):
            key = te.update("g", _mixed_delta(rng, te.tracked_adj("g"), 2, 0, 0))
        m = te.metrics()
        assert m["plan_cache_anchored"] == anchored
        assert m["plan_cache_revalidated"] == m["graph_updates"] == 4
        content = te._member_content_key(te.tracked_adj("g"))
        assert (key == content) == bool(every)
        if every:
            # an untracked client sending the same graph hits the member entry
            misses = m["plan_cache_misses"]
            te.submit(teng.GraphRequest(rid=1, adj=te.tracked_adj("g"), x=x, model="gcn"))
            te.run()
            assert te.metrics()["plan_cache_misses"] == misses + 1  # the composite only


def test_tracked_graph_errors_and_noops():
    adj = _pool((60,))[0]
    _, te = _engines("gcn")
    x = np.zeros((60, 8), np.float32)
    with pytest.raises(KeyError, match="unknown graph_id"):
        te.update("nope", DeltaBatch.of(inserts=[(0, 1, 1.0)]))
    with pytest.raises(KeyError, match="unknown graph_id"):
        te.tracked_adj("nope")
    with pytest.raises(KeyError, match="unknown graph_id"):
        te.submit(teng.GraphRequest(rid=0, x=x, model="gcn", graph_id="g"))
    with pytest.raises(ValueError, match="needs adj"):
        te.submit(teng.GraphRequest(rid=0, x=x, model="gcn"))
    te.submit(teng.GraphRequest(rid=0, adj=adj, x=x, model="gcn", graph_id="g"))
    assert te.tracked_adj("g") is adj
    key = te._graphs["g"].key
    assert te.update("g", DeltaBatch.of()) == key
    with pytest.raises(ValueError, match="out of range"):
        te.update("g", DeltaBatch.of(inserts=[(99, 0, 1.0)]))
    with pytest.raises(ValueError, match="already-present"):
        te.update("g", DeltaBatch.of(inserts=[(int(adj.rows[0]), int(adj.cols[0]), 1.0)]))
    assert te.metrics()["graph_updates"] == 0
    # re-registering resets the lineage to the content key
    te.update("g", _mixed_delta(np.random.default_rng(1), adj, 1, 0, 0))
    assert te._graphs["g"].key != key
    te.submit(teng.GraphRequest(rid=1, adj=adj, x=x, model="gcn", graph_id="g"))
    assert te._graphs["g"].key == key
    assert len(te.run()) == 2


def test_debug_validate_accepts_good_composites():
    pool = _pool()
    _, te = _engines("gcn", debug_validate=True)
    _, plain = _engines("gcn")
    rng = np.random.default_rng(13)
    for eng in (te, plain):
        for rid, a in enumerate(pool):
            eng.submit(teng.GraphRequest(rid=rid, adj=a, x=np.ones((a.shape[0], 8), np.float32),
                                         model="gcn", graph_id=f"g{rid}"))
        eng.run()
    d = _mixed_delta(rng, pool[0], 3, 2, 4)
    for eng in (te, plain):
        eng.update("g0", d)
        eng.submit(teng.GraphRequest(rid=9, x=np.ones((pool[0].shape[0], 8), np.float32),
                                     model="gcn", graph_id="g0"))
    np.testing.assert_array_equal(te.run()[0].out, plain.run()[0].out)
    assert te.metrics()["failed"] == 0


def test_debug_validate_raises_on_corrupt_member(monkeypatch):
    real_build = teng.build_graph

    def corrupt_build(*a, **k):
        g = real_build(*a, **k)
        seg0 = g.plan.segments[0]
        nnz = seg0.nnz_in_tile.clone()
        nnz[0] = seg0.cap + 7  # cap invariant broken
        segs = (dataclasses.replace(seg0, nnz_in_tile=nnz),) + g.plan.segments[1:]
        return dataclasses.replace(g, plan=dataclasses.replace(g.plan, segments=segs))

    monkeypatch.setattr(teng, "build_graph", corrupt_build)
    adj = _pool((60,))[0]
    for debug in (True, False):
        _, te = _engines("gcn", debug_validate=debug, max_retries=0)
        te.submit(teng.GraphRequest(rid=0, adj=adj, x=np.zeros((60, 8), np.float32),
                                    model="gcn"))
        if debug:
            with pytest.raises(PlanInvariantError, match="cap"):
                te.run()
        else:
            # without the check only the launch wrapper's own test of the
            # run index stops it, with no invariant named
            with pytest.raises(ValueError, match="over the cap") as ei:
                te.run()
            assert not isinstance(ei.value, PlanInvariantError)
        assert te.metrics()["failed"] == 1


# ---------------------------------------------------------------------------
# plan cache: delta keys, revalidation, anchoring
# ---------------------------------------------------------------------------
class _Clock:
    now = 0.0

    def __call__(self):
        return self.now


def test_delta_key_matches_reference_and_chains():
    from repro.serve.plan_cache import delta_key as j_delta_key
    from repro_torch.serve.plan_cache import coo_content_key, delta_key

    k = coo_content_key(_pool((50,))[0], tile=64)
    d1, d2 = DeltaBatch.of(inserts=[(0, 1, 2.0)]), DeltaBatch.of(removes=[(0, 2)])
    assert delta_key(k, d1) == j_delta_key(k, _jdelta(d1))
    assert delta_key(k, d1) != delta_key(k, d2) and delta_key(k, d1) != k
    assert delta_key(delta_key(k, d1), d2) != delta_key(delta_key(k, d2), d1)


@pytest.mark.parametrize("case", ["live", "absent", "no patch", "expired"])
def test_revalidate_cases(case):
    from repro_torch.serve.plan_cache import delta_key

    clock = _Clock()
    c = PlanCache(max_entries=4, max_age_s=1.0, clock=clock)
    d = DeltaBatch.of(inserts=[(0, 1, 2.0)])
    if case != "absent":
        c.put("k", 10, nbytes=8)
    if case == "expired":
        clock.now = 5.0
    new_key = c.revalidate("k", d, patch=None if case == "no patch" else (lambda v: v + 1))
    assert new_key == delta_key("k", d)
    if case == "live":
        assert c.peek("k") is None and c.peek(new_key) == 11 and c.keys == [new_key]
        assert c.stats.revalidated == 1 and len(c) == 1
    else:  # degrades to a miss on the next lookup, never to a stale hit
        assert c.peek(new_key) is None and c.stats.revalidated == 0
        assert c.peek("k") == (10 if case == "no patch" else None)


def test_anchor_rehomes_live_entries_only():
    c = PlanCache(max_entries=4)
    c.put("lineage", 7, nbytes=8)
    hits = c.stats.hits
    assert c.anchor("lineage", "content") == "content"
    assert c.keys == ["content"] and c.peek("content") == 7
    assert c.stats.anchored == 1 and c.stats.bytes_in_use == 8 and c.stats.hits == hits
    assert c.anchor("gone", "other") == "other" and c.stats.anchored == 1
    assert c.anchor("content", "content") == "content" and c.stats.anchored == 1


# ---------------------------------------------------------------------------
# multi-device routing: composites over a threshold placed on a CPU pool
# ---------------------------------------------------------------------------
CPU4 = (torch.device("cpu"),) * 4


def _pool_executor():
    # floors low enough that the test's small composites split on 4 devices
    return PlanExecutor(devices=CPU4, min_nnz_per_part=64, min_features_per_part=2)


def _count_launches(monkeypatch):
    calls = []
    real = tops.scv_spmm_chain  # the vector body: one launch a chain

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tops, "scv_spmm_chain", counted)
    return calls


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_engine_routes_over_cpu_pool_like_reference_engine(kind, monkeypatch):
    pool = _pool()
    je, te = _engines(kind, executor=_pool_executor(),
                      port_cfg=dict(shard_nnz_threshold=100, debug_validate=True))
    calls = _count_launches(monkeypatch)
    rng = np.random.default_rng(5)
    stream = []
    for rid in range(14):
        a = pool[int(rng.integers(len(pool)))]
        stream.append((a, rng.standard_normal((a.shape[0], 8)).astype(np.float32)))
        _submit_both(je, te, rid, stream[-1][1], adj=a, model=kind)
    _run_both(je, te)
    tm = te.metrics()
    assert tm["sharded_batches"] == tm["batches"] == je.metrics()["batches"] > 0
    assert len(calls) == tm["launches"] > 0
    # the same requests again: every wave is a composite hit, placed already
    hits, misses = tm["plan_cache_hits"], tm["plan_cache_misses"]
    for rid, (a, x) in enumerate(stream):
        _submit_both(je, te, 100 + rid, x, adj=a, model=kind)
    _run_both(je, te)
    tm = te.metrics()
    assert tm["plan_cache_misses"] == misses
    assert tm["plan_cache_hits"] - hits == tm["batches"] // 2
    assert len(calls) == tm["launches"]


def test_threshold_routes_only_oversized_composites():
    _, te = _engines("gcn", executor=_pool_executor(), port_cfg=dict(shard_nodes_threshold=512))
    for rid, a in enumerate(_pool((60, 700, 300))):
        te.submit(teng.GraphRequest(rid=rid, adj=a, x=np.ones((a.shape[0], 8), np.float32),
                                    model="gcn"))
        te.run()  # one graph a wave: only the 700-node one pads past 512 (to 1024)
    assert te.metrics()["sharded_batches"] == 1 and te.metrics()["batches"] == 3


def test_tracked_member_is_placed_again_after_update(monkeypatch):
    """An update re-keys the member, so the next wave's composite is a miss:
    assembled from the patched member and placed again, never patched."""
    pool = _pool()
    je, te = _engines("gcn", executor=_pool_executor(),
                      port_cfg=dict(shard_nnz_threshold=100, debug_validate=True))
    calls = _count_launches(monkeypatch)
    rng = np.random.default_rng(8)
    xs = [rng.standard_normal((a.shape[0], 8)).astype(np.float32) for a in pool[:2]]
    _submit_both(je, te, 0, xs[0], adj=pool[0], graph_id="a")
    _submit_both(je, te, 1, xs[1], adj=pool[1])
    _run_both(je, te)
    for step in range(3):
        d = _mixed_delta(rng, te.tracked_adj("a"), 3, 2, 3)
        assert te.update("a", d) == je.update("a", _jdelta(d))
        misses = te.metrics()["plan_cache_misses"]
        _submit_both(je, te, 2 + 2 * step, xs[0], graph_id="a")
        _submit_both(je, te, 3 + 2 * step, xs[1], adj=pool[1])
        _run_both(je, te)
        assert te.metrics()["plan_cache_misses"] == misses + 1  # the composite only
    tm = te.metrics()
    assert tm["sharded_batches"] == tm["batches"] == 4
    assert tm["graph_updates"] == tm["plan_cache_revalidated"] == 3
    assert len(calls) == tm["launches"]


def test_sharding_needs_a_pool_beginning_at_the_engine_device():
    cfg = tgnn.GNNConfig(name="gcn", kind="gcn", d_in=8, d_hidden=8, n_classes=2)
    params = tgnn.init_gnn(torch.Generator().manual_seed(0), cfg, device="cpu")
    sharded = teng.GraphEngineConfig(shard_nnz_threshold=10)
    if not torch.cuda.is_available():  # the default pool is every CUDA card
        with pytest.raises(RuntimeError, match="none is available"):
            teng.GraphServeEngine({"gcn": (params, cfg)}, sharded, device="cpu")
    with pytest.raises(ValueError, match="output device"):
        teng.GraphServeEngine({"gcn": (params, cfg)}, sharded, device="cpu",
                              executor=PlanExecutor(devices=(torch.device("meta"),)))
    # an executor without a threshold keeps every wave on one device
    te = teng.GraphServeEngine({"gcn": (params, cfg)}, teng.GraphEngineConfig(), device="cpu",
                               executor=PlanExecutor(devices=CPU4))
    a = _pool((60,))[0]
    te.submit(teng.GraphRequest(rid=0, adj=a, x=np.ones((60, 8), np.float32), model="gcn"))
    te.run()
    assert te.metrics()["sharded_batches"] == 0 and te.metrics()["batches"] == 1


# ---------------------------------------------------------------------------
# autotuned layouts: per-regime configs, waves grouped by config
# ---------------------------------------------------------------------------
def _regime_pool():
    """Small sparse graphs (T = 128, ladder (8,) and T = 64, (16,) under
    the tuner) and two dense-block ones (T = 128, (128,))."""
    return _pool() + [gcn_normalize(powerlaw_edges(512, 60_000, seed=0)),
                      gcn_normalize(powerlaw_edges(256, 20_000, seed=1))]


def _record_waves(engine):
    waves = []
    dispatch = engine._dispatch_wave

    def record(wave):
        waves.append([r.rid for r in wave])
        return dispatch(wave)
    engine._dispatch_wave = record
    return waves


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_autotune_engine_matches_reference_engine(kind):
    pool = _regime_pool()
    je, te = _engines(kind, autotune=True)
    jwaves, twaves = _record_waves(je), _record_waves(te)
    rng = np.random.default_rng(13)
    adjs = {}
    for rid in range(16):
        a = pool[int(rng.integers(len(pool)))]
        adjs[rid] = a
        x = rng.standard_normal((a.shape[0], 8)).astype(np.float32)
        _submit_both(je, te, rid, x, adj=a, model=kind)
    _run_both(je, te)
    assert twaves == jwaves and len(twaves) > 1
    for wave in twaves:  # no wave mixes two resolved configs
        assert len({te._resolve_config(adjs[rid]) for rid in wave}) == 1
    jm, tm = je.metrics(), te.metrics()

    def by_signature(m):
        return {k.split("@")[0]: c for k, c in m["resolved_configs"].items()}
    assert by_signature(tm) == by_signature(jm)
    assert len({(c["tile"], tuple(c["bucket_caps"])) for c in tm["resolved_configs"].values()}) >= 3
    for k in ("autotune_enabled", "autotune_searches", "launches", "waves", "batches"):
        assert tm[k] == jm[k], k
    assert tm["autotune_searches"] == len(tm["resolved_configs"])
    assert all(k.endswith("-torch-cpu") for k in tm["resolved_configs"])


def test_autotune_waves_group_by_config_under_async_loop():
    pool = _regime_pool()
    _, sync = _engines("gcn", autotune=True)
    _, loop = _engines("gcn", autotune=True)
    waves = _record_waves(loop)
    rng = np.random.default_rng(14)
    reqs = [(pool[int(rng.integers(len(pool)))], rid) for rid in range(12)]
    xs = {rid: rng.standard_normal((a.shape[0], 8)).astype(np.float32) for a, rid in reqs}
    for a, rid in reqs:
        sync.submit(teng.GraphRequest(rid=rid, adj=a, x=xs[rid], model="gcn"))
    want = {r.rid: r.out for r in sync.run()}
    loop.start()
    try:
        live = [loop.submit(teng.GraphRequest(rid=rid, adj=a, x=xs[rid], model="gcn"))
                for a, rid in reqs]
        got = {r.rid: r.result(timeout=60) for r in live}
    finally:
        loop.stop(timeout=30)
    for rid, out in want.items():
        np.testing.assert_allclose(got[rid], out, rtol=1e-5, atol=1e-5)
    adjs = {rid: a for a, rid in reqs}
    for wave in waves:
        assert len({loop._resolve_config(adjs[rid]) for rid in wave}) == 1


def test_tracked_graph_keeps_its_resolved_config():
    """A tracked graph gets its regime's config at registration, keeps it
    across a value delta, and is resolved again at its anchor."""
    dense, sparse = _regime_pool()[5], _pool()[1]
    je, te = _engines("gcn", autotune=True, anchor_every=2)
    x = np.ones((dense.shape[0], 8), np.float32)
    _submit_both(je, te, 0, x, adj=dense, graph_id="d")
    _submit_both(je, te, 1, np.ones((sparse.shape[0], 8), np.float32), adj=sparse)
    _run_both(je, te)
    want = te._resolve_config(dense)
    assert want != te._resolve_config(sparse)
    assert te.metrics()["tracked_graph_configs"] == {"d": want.to_json()}
    assert je.metrics()["tracked_graph_configs"] == {"d": want.to_json()}
    rng = np.random.default_rng(15)
    for step in range(3):  # value updates: the regime stays
        d = _mixed_delta(rng, te.tracked_adj("d"), 6, 0, 0)
        assert te.update("d", d) == je.update("d", _jdelta(d))
        _submit_both(je, te, 10 + step, x, graph_id="d")
        _run_both(je, te)
        assert te.metrics()["tracked_graph_configs"]["d"] == want.to_json()
        assert te._graphs["d"].config == want
    m = te.metrics()
    assert m["plan_cache_anchored"] == je.metrics()["plan_cache_anchored"] == 1
    assert m["graph_updates"] == m["plan_cache_revalidated"] == 3

