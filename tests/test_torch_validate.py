"""The port's plan checks against the reference's: the same clean and
corrupted plans (the corruptions of ``tests/test_validate.py``) go through
``repro.core.validate.validate_plan`` and the port's, and give the same
verdict per invariant with the same offending tile / segment indices, for
tiles, single-cap plans, bucketed plans, graphs and serving composites,
and (with the span named too) for plans placed on a pool of CPU devices,
held against the reference's sharded checks on the same span leaves.
The port's own ``run-index`` invariant is held on its own: green on every
built plan, red on a plan whose run index predates a splice of its arrays.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import exec as jexec
from repro.core import scv as jscv
from repro.core import validate as jval
from repro.core.formats import COOMatrix as JCOO
from repro_torch.core import exec as texec
from repro_torch.core import scv as tscv
from repro_torch.core import validate as tval
from repro_torch.models import gnn as tgnn
from repro_torch.serve import graph_engine as teng
from repro_torch.simul.datasets import gcn_normalize, powerlaw_graph
from repro_torch.stream import DeltaBatch, apply_coo, apply_delta

LEAVES = ("tile_row", "tile_col", "rows", "cols", "vals", "nnz_in_tile", "perm")
CAPS = (4, 8, 32)


def _coo(n=96, edges=500, seed=0):
    return gcn_normalize(powerlaw_graph(n, edges, seed=seed))


def _jcoo(a):
    return JCOO(a.rows, a.cols, a.vals, a.shape)


def _plans(coo, bucketed):
    """The same plan in both packages: (reference, port)."""
    jt = jscv.coo_to_scv_tiles(_jcoo(coo), 16, cap=32)
    tt = tscv.coo_to_scv_tiles(coo, 16, cap=32)
    if bucketed:
        return jscv.plan_from_tiles_bucketed(jt, caps=CAPS), tscv.plan_from_tiles_bucketed(tt, caps=CAPS)
    return jscv.plan_from_tiles(jt), tscv.plan_from_tiles(tt)


def _host_leaves(seg):
    return {f: np.array(getattr(seg, f)) for f in LEAVES}


def _with_leaves(jp, tp, leaves, segment=None):
    """Both plans with one segment's leaves replaced by the same arrays
    (the port's segment keeps its original run index)."""
    def put(plan, conv):
        if segment is None:
            return dataclasses.replace(plan, **{k: conv(v) for k, v in leaves.items()})
        segs = list(plan.segments)
        segs[segment] = dataclasses.replace(
            segs[segment], **{k: conv(v) for k, v in leaves.items()})
        return dataclasses.replace(plan, segments=tuple(segs))
    return put(jp, lambda a: a.copy()), put(tp, lambda a: torch.from_numpy(a.copy()))


# -- corruptions of tests/test_validate.py, applied to host leaves ---------
def _swap_real(leaves):
    real = np.flatnonzero(leaves["nnz_in_tile"] > 0)
    i, j = int(real[0]), int(real[-1])
    for f in LEAVES:
        leaves[f][[i, j]] = leaves[f][[j, i]]


def _orphan_last_row(leaves):
    last = int(leaves["tile_row"].max())
    leaves["tile_row"][leaves["tile_row"] == last] = 0


def _second_run(leaves):
    rows = leaves["tile_row"]
    first = int(np.flatnonzero(rows == 0)[0])
    order = np.r_[np.delete(np.arange(len(rows)), first), first]
    for f in LEAVES:
        leaves[f] = leaves[f][order]


def _over_cap(leaves):
    leaves["nnz_in_tile"][0] = leaves["rows"].shape[1] + 5


def _dirty_padding(leaves):
    t = int(np.flatnonzero(leaves["nnz_in_tile"] < leaves["rows"].shape[1])[0])
    leaves["vals"][t, -1] = 7.5


def _duplicate_perm(leaves):
    t = int(np.flatnonzero(leaves["nnz_in_tile"] >= 2)[0])
    leaves["perm"][t, 1] = leaves["perm"][t, 0]


def _local_out_of_bounds(leaves):
    t = int(np.flatnonzero(leaves["nnz_in_tile"] > 0)[0])
    leaves["rows"][t, 0] = 16


def _value_drift(leaves):
    t = int(np.flatnonzero(leaves["nnz_in_tile"] > 0)[0])
    leaves["vals"][t, 0] += 1.0


CORRUPTIONS = {
    "order": _swap_real,
    "coverage": _orphan_last_row,
    "coverage-contiguity": _second_run,
    "cap": _over_cap,
    "packing": _dirty_padding,
    "perm": _duplicate_perm,
    "bounds": _local_out_of_bounds,
    "reassembly": _value_drift,
}


def _verdicts(report, invariants=None):
    """(invariant, segment, ok, offending) of each check, in order."""
    return [(c.invariant, c.segment, c.ok, c.offending) for c in report.checks
            if invariants is None or c.invariant in invariants]


def assert_same_verdicts(jrep, trep):
    """The port's report holds the reference's checks, verdicts and
    offenders (its run-index checks are extra)."""
    ref_inv = {c.invariant for c in jrep.checks}
    assert _verdicts(trep, ref_inv) == _verdicts(jrep)
    assert {c.invariant for c in trep.checks} - ref_inv <= {"run-index"}
    assert trep.kind == jrep.kind


# ---------------------------------------------------------------------------
# green baselines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bucketed", [False, True], ids=["plan", "bucketed"])
def test_clean_plans_match_reference(bucketed):
    coo = _coo()
    jp, tp = _plans(coo, bucketed)
    jrep, trep = jval.validate_plan(jp, coo=_jcoo(coo)), tval.validate_plan(tp, coo=coo)
    assert jrep.ok and trep.ok, trep.summary()
    assert_same_verdicts(jrep, trep)
    n_seg = len(getattr(tp, "segments", (tp,)))
    assert len(trep.failed("run-index")) == 0
    assert sum(c.invariant == "run-index" for c in trep.checks) == n_seg


def test_clean_tiles_match_reference():
    coo = _coo()
    jrep = jval.validate_plan(jscv.coo_to_scv_tiles(_jcoo(coo), 16, cap=32), coo=_jcoo(coo))
    trep = tval.validate_plan(tscv.coo_to_scv_tiles(coo, 16, cap=32), coo=coo)
    assert jrep.ok and trep.ok
    assert_same_verdicts(jrep, trep)
    assert not trep.failed("run-index") and trep.kind == "tiles"


def test_report_summary_and_raise():
    _, tp = _plans(_coo(), False)
    rep = tval.validate_plan(tp)
    assert "passed" in rep.summary()
    assert rep.raise_if_failed() is rep


# ---------------------------------------------------------------------------
# corruptions: the same verdicts and offenders as the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("invariant", sorted(CORRUPTIONS))
def test_corrupted_plan_matches_reference(invariant):
    coo = _coo()
    jp, tp = _plans(coo, False)
    leaves = _host_leaves(tp)
    CORRUPTIONS[invariant](leaves)
    jbad, tbad = _with_leaves(jp, tp, leaves)
    with_coo = dict(coo=coo) if invariant == "reassembly" else {}
    jrep = jval.validate_plan(jbad, **({"coo": _jcoo(coo)} if with_coo else {}))
    trep = tval.validate_plan(tbad, **with_coo)
    assert trep.failed(invariant), trep.summary()
    assert_same_verdicts(jrep, trep)
    with pytest.raises(tval.PlanInvariantError) as ei:
        trep.raise_if_failed()
    assert ei.value.report is trep


@pytest.mark.parametrize("invariant", ["order", "cap", "packing", "perm", "bounds"])
def test_corrupted_bucketed_segment_matches_reference(invariant):
    coo = _coo()
    jp, tp = _plans(coo, True)
    j = max(i for i, s in enumerate(tp.segments) if int((s.nnz_in_tile >= 2).sum()) >= 2)
    leaves = _host_leaves(tp.segments[j])
    CORRUPTIONS[invariant](leaves)
    jbad, tbad = _with_leaves(jp, tp, leaves, segment=j)
    jrep, trep = jval.validate_plan(jbad), tval.validate_plan(tbad)
    fails = trep.failed(invariant)
    assert fails, trep.summary()
    assert fails[0].segment in (j, None)  # perm is checked across segments
    assert_same_verdicts(jrep, trep)


def test_corrupted_ladder_names_segment_and_tile():
    coo = _coo()
    jp, tp = _plans(coo, True)
    j = next(i for i, s in enumerate(tp.segments) if i > 0 and bool((s.nnz_in_tile > 0).any()))
    nnz = tp.segments[j].nnz_in_tile.numpy().copy()
    t = int(np.flatnonzero(nnz > 0)[0])
    nnz[t] = 1  # belongs in bucket 0, claims segment j
    jbad, tbad = _with_leaves(jp, tp, {"nnz_in_tile": nnz}, segment=j)
    jrep, trep = jval.validate_plan(jbad), tval.validate_plan(tbad)
    fails = trep.failed("ladder")
    assert fails and fails[0].segment == j and t in fails[0].offending
    assert_same_verdicts(jrep, trep)
    # the changed nnz also leaves segment j's run index behind
    assert [c.segment for c in trep.failed("run-index")] == [j]


def test_graph_and_composite_kinds_match_reference():
    from repro.models import gnn as jgnn
    from repro.serve import graph_engine as jeng

    adjs = [_coo(n, 4 * n, seed=i) for i, n in enumerate((70, 130))]
    jg = [jgnn.build_graph(_jcoo(a), tile=16, bucket_caps=CAPS) for a in adjs]
    tg = [tgnn.build_graph(a, tile=16, bucket_caps=CAPS, device="cpu") for a in adjs]
    jrep, trep = jval.validate_plan(jg[0]), tval.validate_plan(tg[0])
    assert trep.kind == "graph" and trep.ok
    assert_same_verdicts(jrep, trep)
    jbg = jeng.assemble_batched_graph(jg, 16, 256)
    tbg = teng.assemble_batched_graph(tg, 16, 256, device="cpu")
    jrep, trep = jval.validate_plan(jbg), tval.validate_plan(tbg)
    assert trep.kind == "batched-graph" and trep.ok, trep.summary()
    assert_same_verdicts(jrep, trep)


# ---------------------------------------------------------------------------
# run-index: the port's own invariant
# ---------------------------------------------------------------------------
def _value_update(adj, idx, val):
    coords = [(int(adj.rows[i]), int(adj.cols[i])) for i in idx]
    return DeltaBatch.of(inserts=[(r, c, val) for r, c in coords], removes=coords)


def _grow_delta(adj, tile):
    """Inserts into the tile of entry 0: its nnz grows, its layout stands."""
    have = set(zip(adj.rows.tolist(), adj.cols.tolist()))
    r0, c0 = int(adj.rows[0]) // tile * tile, int(adj.cols[0]) // tile * tile
    free = [(r, c) for r in range(r0, r0 + tile) for c in range(c0, c0 + tile)
            if (r, c) not in have and r < adj.shape[0] and c < adj.shape[1]]
    return DeltaBatch.of(inserts=[(r, c, 1.5) for r, c in free[:2]])


def test_run_index_fails_on_plan_built_before_inplace_splice():
    # every block-row visited (a diagonal), so the plan's leaves are the
    # tiles' own arrays: an in-place patch of the tiles changes the plan's
    # nnz under its old run index.  (Built without perm: the perm leaf is
    # the plan's own copy, and the reference's perm checks would see it.)
    base = _coo(200, 700, seed=3)
    n = base.shape[0]
    coo = apply_coo(base, DeltaBatch.of(inserts=[
        (i, i, 1.0) for i in range(n) if not ((base.rows == i) & (base.cols == i)).any()]))
    tiles = tscv.coo_to_scv_tiles(coo, 16, cap=256)
    plan = tscv.plan_from_tiles(tiles, with_perm=False)
    assert tval.validate_plan(plan).ok
    assert np.shares_memory(plan.nnz_in_tile.numpy(), tiles.nnz_in_tile)
    d = _grow_delta(coo, 16)
    assert apply_delta(tiles, d, inplace=True) is tiles  # layout stands
    rep = tval.validate_plan(plan)
    fails = rep.failed("run-index")
    assert fails and "unit_work" in fails[0].detail, rep.summary()
    # the reference's invariants cannot see it: every one of them passes
    assert all(c.ok for c in rep.checks if c.invariant != "run-index")
    # a plan built from the patched tiles is green again
    assert tval.validate_plan(tscv.plan_from_tiles(tiles), coo=apply_coo(coo, d)).ok


@pytest.mark.parametrize("kind", ["value update", "tile birth", "net shrink"])
def test_run_index_names_segment_whose_index_predates_splice(kind):
    coo = _coo(300, 1500, seed=4)
    tp = tgnn.build_graph(coo, tile=16, bucket_caps=CAPS, device="cpu").plan
    if kind == "value update":
        d = _value_update(coo, [0, 5, 9], 4.0)
    elif kind == "tile birth":
        have = set(zip(coo.rows.tolist(), coo.cols.tolist()))
        d = DeltaBatch.of(inserts=[next((r, c, 2.0) for r in range(299, 0, -1)
                                        for c in range(0, 299) if (r, c) not in have)])
    else:
        d = DeltaBatch.of(removes=[(int(coo.rows[i]), int(coo.cols[i])) for i in (0, 1, 2)])
    patched = apply_delta(tp, d)
    assert tval.validate_plan(patched, coo=apply_coo(coo, d)).ok
    changed = [j for j, (a, b) in enumerate(zip(tp.segments, patched.segments)) if a is not b]
    assert changed
    # the patched arrays under each segment's run index from before
    stale = dataclasses.replace(patched, segments=tuple(
        dataclasses.replace(s, runs=old.runs)
        for s, old in zip(patched.segments, tp.segments)))
    rep = tval.validate_plan(stale)
    bad = sorted(c.segment for c in rep.failed("run-index"))
    want = [j for j in changed
            if tval.run_index_diff(tp.segments[j].runs, patched.segments[j].runs)]
    assert bad == want, rep.summary()
    # a value update keeps every tile's nnz: the old index is still right
    assert bool(want) == (kind != "value update")


def test_run_index_diff_names_fields():
    _, tp = _plans(_coo(), False)
    runs = tp.runs
    assert tval.run_index_diff(runs, runs.to("cpu")) == ()
    other = dataclasses.replace(runs, max_nnz=runs.max_nnz + 1,
                                order=runs.order.flip(0))
    assert set(tval.run_index_diff(runs, other)) == {"max_nnz", "order"}


def test_sharded_plans_wait_for_the_sharding_slice():
    """The sharding slice has come: an unknown object is refused with a
    message that names ``ShardedPlan`` among the kinds accepted."""
    with pytest.raises(TypeError, match="ShardedPlan / Graph"):
        tval.validate_plan(object())


# ---------------------------------------------------------------------------
# placed plans: the reference's sharded chain on the same leaves
# ---------------------------------------------------------------------------
CPU4 = (torch.device("cpu"),) * 4
SPAN_CORRUPTIONS = ["order", "coverage", "coverage-contiguity", "cap", "packing", "perm",
                    "bounds", "reassembly"]


def _placed(coo, decision=("tiles", 4, 1)):
    _, tp = _plans(coo, True)
    return texec.PlanExecutor(devices=CPU4).prepare(tp, decision=texec.ShardingDecision(*decision))


def _as_reference(sp, stacked):
    """The reference's ``ShardedPlan`` over ``stacked`` host leaves: its
    checks read the leaves and the decision, not the mesh."""
    segs = tuple(
        jscv.SCVPlan(**{k: None if v is None else jnp.asarray(v) for k, v in seg.items()},
                     tile=sp.tile, cap=cap, shape=sp.shape, order=sp.order)
        for seg, cap in zip(stacked, sp.caps))
    return jexec.ShardedPlan(segments=segs, mesh=None,
                             decision=jexec.ShardingDecision(*dataclasses.astuple(sp.decision)))


def _with_stacked(sp, stacked):
    """``sp`` holding ``stacked`` leaves; each span keeps its run index."""
    return dataclasses.replace(sp, segments=tuple(
        tuple(dataclasses.replace(s, **{k: None if v is None else torch.from_numpy(v[p].copy())
                                        for k, v in seg.items()})
              for p, s in enumerate(spans))
        for spans, seg in zip(sp.segments, stacked)))


def _sharded_verdicts(report, invariants=None):
    return [(c.invariant, c.segment, c.part, c.ok, c.offending) for c in report.checks
            if invariants is None or c.invariant in invariants]


def assert_same_sharded_verdicts(jrep, trep):
    ref_inv = {c.invariant for c in jrep.checks}
    assert _sharded_verdicts(trep, ref_inv) == _sharded_verdicts(jrep)
    assert {c.invariant for c in trep.checks} - ref_inv <= {"run-index"}
    assert trep.kind == jrep.kind == "sharded"


@pytest.mark.parametrize("decision", [("tiles", 4, 1), ("2d", 2, 2), ("features", 1, 4)])
def test_clean_placement_matches_reference(decision):
    coo = _coo()
    sp = _placed(coo, decision)
    trep = tval.validate_plan(sp, coo=coo)
    jrep = jval.validate_plan(_as_reference(sp, sp.stacked()), coo=_jcoo(coo))
    assert trep.ok and jrep.ok, trep.summary()
    assert_same_sharded_verdicts(jrep, trep)
    n_spans = sum(len(spans) for spans in sp.segments)
    assert sum(c.invariant == "run-index" for c in trep.checks) == n_spans


@pytest.mark.parametrize("invariant", SPAN_CORRUPTIONS)
def test_corrupted_span_matches_reference(invariant):
    """A corruption of one span's leaves gets the reference's verdicts,
    named by segment and span."""
    coo = _coo()
    sp = _placed(coo)
    stacked = list(sp.stacked())
    j = max(range(len(stacked)), key=lambda i: int((stacked[i]["nnz_in_tile"][0] > 0).sum()))
    leaves = {k: v[0].copy() for k, v in stacked[j].items()}  # span 0: it starts at row 0
    CORRUPTIONS[invariant](leaves)
    stacked[j] = {k: v.copy() for k, v in stacked[j].items()}
    for k, v in leaves.items():
        stacked[j][k][0] = v
    kw = dict(coo=coo) if invariant == "reassembly" else {}
    trep = tval.validate_plan(_with_stacked(sp, stacked), **kw)
    jrep = jval.validate_plan(_as_reference(sp, stacked),
                              **({"coo": _jcoo(coo)} if kw else {}))
    assert not trep.ok, trep.summary()
    assert_same_sharded_verdicts(jrep, trep)


def test_placed_graph_and_composite_kinds():
    adjs = [_coo(n, 4 * n, seed=i) for i, n in enumerate((70, 130))]
    tg = [tgnn.build_graph(a, tile=16, bucket_caps=CAPS, device="cpu") for a in adjs]
    ex = texec.PlanExecutor(devices=CPU4)
    placed = ex.prepare_graph(tg[1], decision=texec.ShardingDecision("2d", 2, 2))
    trep = tval.validate_plan(placed, coo=adjs[1])
    assert trep.kind == "graph" and trep.ok, trep.summary()
    assert {c.invariant for c in trep.checks} >= {"shard-coverage", "run-index", "reassembly"}
    bg = teng.assemble_batched_graph(tg, 16, 256, device="cpu")
    bg = dataclasses.replace(bg, graph=ex.prepare_graph(
        bg.graph, decision=texec.ShardingDecision("tiles", 4, 1)))
    trep = tval.validate_plan(bg)
    assert trep.kind == "batched-graph" and trep.ok, trep.summary()
