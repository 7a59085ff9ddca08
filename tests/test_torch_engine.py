"""The port's serving engine against the reference's: the same request
stream through both ``GraphServeEngine``s gives the same outputs (rtol =
atol = 1e-5) and the same count of kernel launches, and the port's
engine refuses what later slices of the port bring."""
import jax
import numpy as np
import pytest
import torch

from repro.core.formats import COOMatrix as JCOO
from repro.models import gnn as jgnn
from repro.serve import graph_engine as jeng
from repro_torch.launch import graph_serve as tlaunch
from repro_torch.models import gnn as tgnn
from repro_torch.serve import graph_engine as teng
from repro_torch.serve.plan_cache import PlanCache, plan_nbytes
from repro_torch.simul.datasets import gcn_normalize, powerlaw_graph

ENGINE_KW = dict(max_batch_graphs=4, max_batch_nodes=1024, node_buckets=(512, 1024))


def _pool(sizes=(90, 200, 140, 310, 60)):
    return [gcn_normalize(powerlaw_graph(n, 3 * n, seed=i)) for i, n in enumerate(sizes)]


def _engines(kind, d_in=8):
    jcfg = jgnn.GNNConfig(name=kind, kind=kind, d_in=d_in, d_hidden=16, n_classes=4,
                          backend="jnp")
    tcfg = tgnn.GNNConfig(name=kind, kind=kind, d_in=d_in, d_hidden=16, n_classes=4)
    jparams, _ = jgnn.init_gnn(jax.random.PRNGKey(0), jcfg)
    tparams = tgnn.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    je = jeng.GraphServeEngine({kind: (jparams, jcfg)}, jeng.GraphEngineConfig(**ENGINE_KW))
    te = teng.GraphServeEngine({kind: (tparams, tcfg)}, teng.GraphEngineConfig(**ENGINE_KW),
                               device="cpu")
    return je, te


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_engine_matches_reference_engine(kind):
    pool = _pool()
    je, te = _engines(kind)
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
    assert tm["launches"] == jm["launches"] > 0
    assert (tm["waves"], tm["batches"], tm["completed"]) == (jm["waves"], jm["batches"], 14)
    assert tm["device"] == "cpu"


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
    ("autotune", True, "tuner"),
    ("shard_nodes_threshold", 1024, "sharding"),
    ("shard_nnz_threshold", 10, "sharding"),
    ("debug_validate", True, "checks"),
])
def test_config_refuses_later_slices(field, value, slice_name):
    with pytest.raises(ValueError, match=slice_name):
        teng.GraphEngineConfig(**{field: value})


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
