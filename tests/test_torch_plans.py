"""The port's host plan layer against the reference: for the same COO,
every tile array and every plan leaf equals the reference's exactly —
single-cap and bucketed plans, coverage dummies and perm included, and
the serving engine's block-diagonal composites.  The port-only run index
is checked on its own."""
import numpy as np
import pytest
import torch

from repro.core import scv as jscv
from repro.core.formats import COOMatrix as JCOO
from repro.core.formats import block_diag_coo as j_block_diag_coo
from repro.models import gnn as jgnn
from repro.serve import graph_engine as jeng
from repro.simul import datasets as jdata
from repro_torch.core import scv as tscv
from repro_torch.core.formats import COOMatrix as TCOO
from repro_torch.core.formats import block_diag_coo as t_block_diag_coo
from repro_torch.models import gnn as tgnn
from repro_torch.serve import graph_engine as teng
from repro_torch.simul import datasets as tdata

LEAVES = ("tile_row", "tile_col", "rows", "cols", "vals", "nnz_in_tile", "perm")


def _graphs(sizes, seed=0, per_node=3):
    """The same GCN-normalised power-law COOs in both packages' types."""
    out = []
    for i, n in enumerate(sizes):
        a = tdata.gcn_normalize(tdata.powerlaw_graph(n, per_node * n, seed=seed + i))
        out.append((JCOO(a.rows, a.cols, a.vals, a.shape), a))
    return out


def _segments(plan):
    return getattr(plan, "segments", (plan,))


def assert_plans_equal(jp, tp):
    jsegs, tsegs = _segments(jp), _segments(tp)
    assert len(jsegs) == len(tsegs)
    assert isinstance(tp, tscv.SCVBucketedPlan) == isinstance(jp, jscv.SCVBucketedPlan)
    for js, ts in zip(jsegs, tsegs):
        assert (js.tile, js.cap, js.shape, js.order) == (ts.tile, ts.cap, ts.shape, ts.order)
        for leaf in LEAVES:
            a, b = getattr(js, leaf), getattr(ts, leaf)
            if a is None or b is None:
                assert a is None and b is None, leaf
                continue
            a, b = np.asarray(a), b.numpy()
            assert a.dtype == b.dtype, (leaf, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=leaf)


def test_generators_match_reference():
    for n, m, seed in [(300, 900, 0), (1000, 4000, 7)]:
        ja = jdata.gcn_normalize(jdata.powerlaw_graph(n, m, seed=seed))
        ta = tdata.gcn_normalize(tdata.powerlaw_graph(n, m, seed=seed))
        for f in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(ja, f), getattr(ta, f))
    assert {k: tuple(vars(v).values()) for k, v in jdata.TABLE_I.items()} == {
        k: tuple(vars(v).values()) for k, v in tdata.TABLE_I.items()
    }


def test_layout_helpers_match_reference():
    (ja, ta), = _graphs([500])
    for tile in (16, 64):
        jh = jscv.tile_nnz_histogram(ja, tile)
        th = tscv.tile_nnz_histogram(ta, tile)
        np.testing.assert_array_equal(jh, th)
        assert jscv.bucket_caps_for(jh, tile) == tscv.bucket_caps_for(th, tile)
        assert jscv.dense_tile_threshold(tile) == tscv.dense_tile_threshold(tile)
    assert jscv.DEFAULT_LADDER == tscv.DEFAULT_LADDER
    assert (jscv.DEFAULT_TILE, jscv.DEFAULT_CAP) == (tscv.DEFAULT_TILE, tscv.DEFAULT_CAP)


def test_block_diag_coo_matches_reference():
    pairs = _graphs([40, 70, 25], seed=5)
    jc, jr, jcol = j_block_diag_coo([j for j, _ in pairs], pad_shape=(200, 200))
    tc, tr, tcol = t_block_diag_coo([t for _, t in pairs], pad_shape=(200, 200))
    assert jc.shape == tc.shape
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(jc, f), getattr(tc, f))
    np.testing.assert_array_equal(jr, tr)
    np.testing.assert_array_equal(jcol, tcol)


@pytest.mark.parametrize("tile,cap", [(16, None), (16, 8), (64, 64), (32, 4)])
@pytest.mark.parametrize("order", ["zmorton", "row_major"])
def test_single_cap_plan_leaves_equal(tile, cap, order):
    (ja, ta), = _graphs([300], seed=2)
    jt = jscv.coo_to_scv_tiles(ja, tile, cap=cap, order=order)
    tt = tscv.coo_to_scv_tiles(ta, tile, cap=cap, order=order)
    for f in ("tile_row", "tile_col", "rows", "cols", "vals", "nnz_in_tile", "perm"):
        np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f), err_msg=f)
    assert (jt.cap, jt.padded_shape) == (tt.cap, tt.padded_shape)
    assert_plans_equal(jscv.plan_from_tiles(jt), tscv.plan_from_tiles(tt))
    assert_plans_equal(
        jscv.plan_from_tiles(jt, ensure_coverage=False, with_perm=False),
        tscv.plan_from_tiles(tt, ensure_coverage=False, with_perm=False),
    )


@pytest.mark.parametrize("caps", [(8, 32, 128), "auto", (2, 8)])
@pytest.mark.parametrize("tile", [16, 64])
def test_bucketed_plan_leaves_equal(caps, tile):
    (ja, ta), = _graphs([400], seed=3, per_node=6)
    jg = jgnn.build_graph(ja, tile=tile, bucket_caps=caps)
    tg = tgnn.build_graph(ta, tile=tile, bucket_caps=caps, device="cpu")
    assert_plans_equal(jg.plan, tg.plan)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(np.asarray(getattr(jg, f)), getattr(tg, f).numpy())
    # coverage dummies live in the first segment only
    dummies = [int((s.nnz_in_tile == 0).sum()) for s in tg.plan.segments]
    assert all(d == 0 for d in dummies[1:]), dummies


@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("with_edges", [True, False])
def test_composite_plan_leaves_equal(bucketed, with_edges):
    pairs = _graphs([70, 130, 50, 90], seed=11)
    kw = dict(tile=64, bucket_caps=(8, 32, 128)) if bucketed else dict(tile=64, backend_cap=64)
    jm = [jgnn.build_graph(j, **kw) for j, _ in pairs]
    tm = [tgnn.build_graph(t, device="cpu", **kw) for _, t in pairs]
    jb = jeng.assemble_batched_graph(jm, 64, 1024, with_edges=with_edges)
    tb = teng.assemble_batched_graph(tm, 64, 1024, with_edges=with_edges)
    assert_plans_equal(jb.graph.plan, tb.graph.plan)
    assert jb.graph.n_nodes == tb.graph.n_nodes
    np.testing.assert_array_equal(jb.node_offsets, tb.node_offsets)
    np.testing.assert_array_equal(jb.node_counts, tb.node_counts)
    for f in ("rows", "cols", "vals"):
        a, b = getattr(jb.graph, f), getattr(tb.graph, f)
        if not with_edges:
            assert a is None and b is None
            continue
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # one launch over all the segments, where the reference launches once a non-empty one
    assert teng.plan_launches(tb.graph.plan) == min(1, jeng.plan_launches(jb.graph.plan))


def test_composite_rejects_device_members(monkeypatch):
    (_, ta), = _graphs([60])
    g = tgnn.build_graph(ta, device="cpu")
    monkeypatch.setattr(type(g.plan), "device", property(lambda self: torch.device("meta")))
    with pytest.raises(ValueError, match="host member plans"):
        teng.assemble_batched_graph([g], 64, 256)


# ---------------------------------------------------------------------------
# the port-only run index
# ---------------------------------------------------------------------------
def _runs_from_scratch(tile_row):
    tr = np.asarray(tile_row)
    starts = [i for i in range(len(tr)) if i == 0 or tr[i] != tr[i - 1]]
    return starts + [len(tr)], [int(tr[i]) for i in starts]


@pytest.mark.parametrize("composite", [False, True])
def test_run_index_marks_block_row_runs(composite):
    pairs = _graphs([70, 130, 50], seed=4)
    members = [tgnn.build_graph(t, bucket_caps=(8, 32, 128), device="cpu") for _, t in pairs]
    plan = (
        teng.assemble_batched_graph(members, 64, 512, with_edges=False).graph.plan
        if composite else members[1].plan
    )
    for seg in plan.segments:
        ptr, rows = _runs_from_scratch(seg.tile_row.numpy())
        assert seg.runs.ptr.dtype == torch.int32
        assert seg.runs.ptr.tolist() == ptr
        assert seg.runs.rows.tolist() == rows
        assert len(set(rows)) == len(rows)
    if composite:
        # the repeat-last-tile padding joins the last run: every run of the
        # first segment is one block-row, and all of them are covered
        s0 = plan.segments[0]
        assert sorted(s0.runs.rows.tolist()) == list(range(plan.n_row_blocks))


def test_run_index_refuses_split_block_row():
    with pytest.raises(ValueError, match="two separate runs"):
        tscv.RunIndex.of(np.array([0, 0, 1, 0], np.int32), np.ones(4, np.int32))
    ri = tscv.RunIndex.of(np.array([3, 3, 1, 1, 1, 2], np.int32), np.arange(6, dtype=np.int32))
    assert ri.ptr.tolist() == [0, 2, 5, 6] and ri.rows.tolist() == [3, 1, 2] and ri.max_nnz == 5
    empty = tscv.RunIndex.of(np.zeros(0, np.int32), np.zeros(0, np.int32))
    assert empty.n_runs == 0 and empty.ptr.tolist() == [0] and empty.max_nnz == 0


def test_plan_to_keeps_leaves_and_runs():
    (_, ta), = _graphs([120])
    p = tgnn.build_graph(ta, bucket_caps=(8, 32), device="cpu").plan
    q = p.to("cpu")
    for a, b in zip(p.segments, q.segments):
        for leaf in LEAVES:
            assert torch.equal(getattr(a, leaf), getattr(b, leaf))
        assert torch.equal(a.runs.ptr, b.runs.ptr)
        np.testing.assert_array_equal(a.runs.rows, b.runs.rows)
