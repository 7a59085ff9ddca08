"""The port's delta plan maintenance (``repro_torch.stream``) against the
reference's ``repro.stream`` and against its own rebuilds.

* The reference's ``tests/test_stream.py`` cases, run on the port:
  admission, hole-filling id order, ``apply_delta(build(adj), d) ==
  build(apply_coo(adj, d))`` for every layer (tile birth and death, chain
  growth, chain tails in a lower bucket), source and scan paths agreeing,
  in-place patching, identity of untouched segments, error cases.
* The same delta applied to the reference's plan and to the port's gives
  the same leaves, array for array, dtype included.
* ``patched == rebuilt`` holds for the port's ``RunIndex`` too, and
  aggregation on a patched plan is bit-exact with the rebuilt plan (and
  the reference's) on integer-valued inputs; a patched ``Graph`` serves
  GAT as the reference does.
* No rebuild inside the delta package: an AST walk of
  ``src/repro_torch/stream/`` and a run with the builders made to raise.
* A placed plan (``core.exec.ShardedPlan``) is refused as the reference
  refuses it; patching before placement places like the rebuild.
"""
import ast
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scv as jscv
from repro.core.aggregate import aggregate_scv_plan as j_aggregate
from repro.core.formats import COOMatrix as JCOO
from repro.models import gnn as jgnn
from repro import stream as jstream
from repro_torch.core import scv as tscv
from repro_torch.core.aggregate import aggregate_scv_plan
from repro_torch.core.formats import COOMatrix
from repro_torch.core.scv import coo_to_scv_tiles, plan_from_tiles, plan_from_tiles_bucketed
from repro_torch.core.validate import run_index_diff, validate_plan
from repro_torch.models import gnn as tgnn
from repro_torch.models.gnn import build_graph
from repro_torch.stream import DeltaBatch, apply_coo, apply_delta, check_delta
from repro_torch.stream import delta as tdelta

TILE = 16
CAPS = (4, 16, 64)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REBUILDERS = ("coo_to_scv_tiles", "plan_from_tiles", "plan_from_tiles_bucketed", "build_graph")


def _random_coo(rng, n, density, integer=False):
    total = n * n
    k = max(1, int(total * density))
    flat = rng.choice(total, size=k, replace=False)
    if integer:
        vals = rng.integers(1, 5, k).astype(np.float32)
    else:
        vals = rng.standard_normal(k).astype(np.float32)
        vals[vals == 0] = 1.0
    return COOMatrix(rows=(flat // n).astype(np.int32), cols=(flat % n).astype(np.int32),
                     vals=vals, shape=(n, n))


def _random_delta(rng, coo, n_ins, n_rem, integer=False):
    """Random inserts at absent coordinates + removes of stored edges."""
    n = coo.shape[1]
    have = set(zip(coo.rows.tolist(), coo.cols.tolist()))
    rem_idx = rng.choice(coo.nnz, size=min(n_rem, coo.nnz), replace=False)
    removes = [(int(coo.rows[i]), int(coo.cols[i])) for i in rem_idx]
    inserts = []
    tries = 0
    while len(inserts) < n_ins and tries < 10_000:
        r, c = int(rng.integers(n)), int(rng.integers(n))
        if (r, c) not in have and all((r, c) != e[:2] for e in inserts):
            v = float(rng.integers(1, 5)) if integer else float(rng.standard_normal() + 2.0)
            inserts.append((r, c, v))
        tries += 1
    return DeltaBatch.of(inserts=inserts, removes=removes)


def _jcoo(a):
    return JCOO(a.rows, a.cols, a.vals, a.shape)


def _jdelta(d):
    return jstream.DeltaBatch(d.ins_rows, d.ins_cols, d.ins_vals, d.rem_rows, d.rem_cols)


def _value(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _eq_fields(a, b):
    """Field-for-field equality of two port objects: arrays and tensors
    with their dtypes, run indexes by ``run_index_diff``, nested plans."""
    assert type(a) is type(b)
    for f in dataclasses.fields(a):
        if f.name.startswith("_"):
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if va is None or vb is None:
            assert va is vb, f.name
        elif isinstance(va, tscv.RunIndex):
            assert run_index_diff(va, vb) == (), f.name
        elif isinstance(va, (np.ndarray, torch.Tensor)):
            assert type(va) is type(vb), f.name
            va, vb = _value(va), _value(vb)
            assert va.dtype == vb.dtype and np.array_equal(va, vb), f.name
        elif isinstance(va, tuple) and va and dataclasses.is_dataclass(va[0]):
            assert len(va) == len(vb), f.name
            for sa, sb in zip(va, vb):
                _eq_fields(sa, sb)
        else:
            assert va == vb, f.name


def _assert_matches_reference(tobj, jobj):
    """Port and reference objects of one layer hold equal leaves."""
    tsegs = getattr(tobj, "segments", (tobj,))
    jsegs = getattr(jobj, "segments", (jobj,))
    assert len(tsegs) == len(jsegs)
    for ts, js in zip(tsegs, jsegs):
        assert (ts.tile, ts.cap, tuple(ts.shape), ts.order) == (js.tile, js.cap, tuple(js.shape), js.order)
        for f in ("tile_row", "tile_col", "rows", "cols", "vals", "nnz_in_tile", "perm"):
            a, b = _value(getattr(ts, f)), np.asarray(getattr(js, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), (ts.cap, f)


# ---------------------------------------------------------------------------
# DeltaBatch / check_delta admission
# ---------------------------------------------------------------------------
def test_delta_batch_of_len_and_signature_match_reference():
    d = DeltaBatch.of(inserts=[(0, 1, 2.0)], removes=[(3, 4), (5, 6)])
    assert (d.n_insert, d.n_remove, len(d)) == (1, 2, 3)
    assert len(DeltaBatch.of()) == 0
    jd = jstream.DeltaBatch.of(inserts=[(0, 1, 2.0)], removes=[(3, 4), (5, 6)])
    assert d.signature() == jd.signature()
    a = DeltaBatch.of(inserts=[(1, 2, 3.0)])
    assert a.signature() != DeltaBatch.of(removes=[(1, 2)]).signature()
    assert a.signature() != DeltaBatch.of(inserts=[(1, 2, 3.0)], removes=[(9, 9)]).signature()


@pytest.mark.parametrize("delta,kw,match", [
    (DeltaBatch.of(inserts=[(99, 0, 1.0)]), dict(shape=(8, 8)), "out of range"),
    (DeltaBatch.of(removes=[(-1, 0)]), dict(shape=(8, 8)), "non-negative"),
    (DeltaBatch.of(inserts=[(0, 0, np.nan)]), dict(shape=(8, 8)), "finite"),
    (DeltaBatch.of(inserts=[(0, 0, np.inf)]), dict(shape=(8, 8)), "finite"),
    (DeltaBatch.of(inserts=[(0, 1, 1.0), (0, 1, 2.0)]), {}, "duplicate insert"),
    (DeltaBatch.of(removes=[(0, 1), (0, 1)]), {}, "duplicate remove"),
    (DeltaBatch(np.array([0], np.int32), np.array([0, 1], np.int32),
                np.array([1.0], np.float32), np.zeros(0, np.int32), np.zeros(0, np.int32)),
     {}, "disagree on length"),
], ids=["range", "negative", "nan", "inf", "dup-insert", "dup-remove", "length"])
def test_check_delta_rejects_like_reference(delta, kw, match):
    with pytest.raises(ValueError, match=match):
        check_delta(delta, **kw)
    with pytest.raises(ValueError, match=match):
        jstream.check_delta(_jdelta(delta), **kw)


def test_check_delta_presence_against_coo(rng):
    coo = _random_coo(rng, 16, 0.1)
    r0, c0 = int(coo.rows[0]), int(coo.cols[0])
    have = set(zip(coo.rows.tolist(), coo.cols.tolist()))
    absent = next((r, c) for r in range(16) for c in range(16) if (r, c) not in have)
    with pytest.raises(ValueError, match="absent edge"):
        check_delta(DeltaBatch.of(removes=[absent]), coo=coo)
    with pytest.raises(ValueError, match="already-present"):
        check_delta(DeltaBatch.of(inserts=[(r0, c0, 1.0)]), coo=coo)
    # the value-update idiom is admitted: remove + insert the same coord
    check_delta(DeltaBatch.of(inserts=[(r0, c0, 9.0)], removes=[(r0, c0)]), coo=coo)


# ---------------------------------------------------------------------------
# apply_coo: the canonical (hole-filling) final ordering
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_ins,n_rem", [(1, 1), (2, 1), (0, 2), (6, 9), (9, 3)])
def test_apply_coo_matches_reference(rng, n_ins, n_rem):
    coo = _random_coo(rng, 20, 0.15)
    d = _random_delta(rng, coo, n_ins, n_rem)
    got = apply_coo(coo, d)
    want = jstream.apply_coo(_jcoo(coo), _jdelta(d))
    for f in ("rows", "cols", "vals"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_apply_coo_shrink_moves_only_tail(rng):
    coo = _random_coo(rng, 20, 0.2)
    d = DeltaBatch.of(removes=[(int(coo.rows[0]), int(coo.cols[0])),
                               (int(coo.rows[3]), int(coo.cols[3]))])
    out = apply_coo(coo, d)
    L = coo.nnz - 2
    assert out.nnz == L
    keep = np.setdiff1d(np.arange(L), [0, 3])
    assert np.array_equal(out.rows[keep], coo.rows[keep])
    # holes 0 and 3 hold the moved tail survivors, ascending
    assert (int(out.rows[0]), int(out.cols[0])) == (int(coo.rows[L]), int(coo.cols[L]))
    assert (int(out.rows[3]), int(out.cols[3])) == (int(coo.rows[L + 1]), int(coo.cols[L + 1]))


# ---------------------------------------------------------------------------
# parity: rebuild, reference, run index
# ---------------------------------------------------------------------------
def _layers(coo):
    """(name, port object, reference object) of each plan layer of coo."""
    tt = coo_to_scv_tiles(coo, TILE, cap=CAPS[-1])
    jt = jscv.coo_to_scv_tiles(_jcoo(coo), TILE, cap=CAPS[-1])
    return [
        ("tiles", tt, jt),
        ("plan", plan_from_tiles(tt), jscv.plan_from_tiles(jt)),
        ("bucketed", plan_from_tiles_bucketed(tt, caps=CAPS),
         jscv.plan_from_tiles_bucketed(jt, caps=CAPS)),
    ]


@pytest.mark.parametrize("n_ins,n_rem", [(0, 5), (5, 0), (7, 7), (3, 9), (9, 3)])
def test_parity_all_layers(rng, n_ins, n_rem):
    coo = _random_coo(rng, 257, 0.004)
    d = _random_delta(rng, coo, n_ins, n_rem)
    final = apply_coo(coo, d)
    jfinal = jstream.apply_coo(_jcoo(coo), _jdelta(d))
    for (name, t0, j0), (_, t_ref, j_ref) in zip(_layers(coo), _layers(final)):
        patched = apply_delta(t0, d)
        _eq_fields(patched, t_ref)  # == the port's own rebuild, RunIndex included
        jpatched = jstream.apply_delta(j0, _jdelta(d))
        _assert_matches_reference(patched, jpatched)  # == the reference's patch
        _assert_matches_reference(t_ref, jscv.coo_to_scv_tiles(jfinal, TILE, cap=CAPS[-1])
                                  if name == "tiles" else j_ref)


def test_parity_random_sweep(rng):
    for trial in range(12):
        coo = _random_coo(rng, 129, 0.01 + 0.01 * (trial % 3))
        d = _random_delta(rng, coo, int(rng.integers(0, 10)), int(rng.integers(0, 10)))
        if len(d) == 0:
            continue
        final = apply_coo(coo, d)
        for (_, t0, _), (_, t_ref, _) in zip(_layers(coo), _layers(final)):
            _eq_fields(apply_delta(t0, d), t_ref)


@pytest.mark.parametrize("caps", [None, CAPS], ids=["single-cap", "bucketed"])
def test_parity_graph_layer(rng, caps):
    coo = _random_coo(rng, 130, 0.02)
    d = _random_delta(rng, coo, 6, 6)
    final = apply_coo(coo, d)
    g1 = apply_delta(build_graph(coo, tile=TILE, bucket_caps=caps, device="cpu"), d)
    g_ref = build_graph(final, tile=TILE, bucket_caps=caps, device="cpu")
    _eq_fields(g1.plan, g_ref.plan)
    for f in ("rows", "cols", "vals"):
        a, b = getattr(g1, f), getattr(g_ref, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    jg = jstream.apply_delta(jgnn.build_graph(_jcoo(coo), tile=TILE, bucket_caps=caps), _jdelta(d))
    _assert_matches_reference(g1.plan, jg.plan)
    for f in ("rows", "cols", "vals"):
        assert np.array_equal(getattr(g1, f).numpy(), np.asarray(getattr(jg, f))), f


def test_parity_tile_birth_and_death():
    coo = COOMatrix(rows=np.array([0, 1, 40], np.int32), cols=np.array([0, 1, 40], np.int32),
                    vals=np.ones(3, np.float32), shape=(64, 64))
    d = DeltaBatch.of(inserts=[(60, 60, 2.0)], removes=[(40, 40)])
    final = apply_coo(coo, d)
    _eq_fields(apply_delta(coo_to_scv_tiles(coo, TILE, cap=4), d),
               coo_to_scv_tiles(final, TILE, cap=4))
    for caps in ((4,), (2, 4)):
        p0 = plan_from_tiles_bucketed(coo_to_scv_tiles(coo, TILE, cap=caps[-1]), caps=caps)
        patched = apply_delta(p0, d)
        _eq_fields(patched, plan_from_tiles_bucketed(coo_to_scv_tiles(final, TILE, cap=caps[-1]),
                                                     caps=caps))
        assert validate_plan(patched, coo=final).ok


def test_parity_chain_growth(rng):
    coo = _random_coo(rng, 32, 0.05)
    tile0 = (int(coo.rows[0]) // TILE * TILE, int(coo.cols[0]) // TILE * TILE)
    have = set(zip(coo.rows.tolist(), coo.cols.tolist()))
    ins = [(r, c, 1.5) for r in range(tile0[0], tile0[0] + TILE)
           for c in range(tile0[1], tile0[1] + TILE) if (r, c) not in have][:9]
    d = DeltaBatch.of(inserts=ins)
    final = apply_coo(coo, d)
    _eq_fields(apply_delta(coo_to_scv_tiles(coo, TILE, cap=4), d),
               coo_to_scv_tiles(final, TILE, cap=4))
    _eq_fields(apply_delta(plan_from_tiles(coo_to_scv_tiles(coo, TILE, cap=4)), d),
               plan_from_tiles(coo_to_scv_tiles(final, TILE, cap=4)))


def test_parity_chain_tail_in_lower_bucket(rng):
    # a heavy tile whose chain-split tail lands in a lower bucket than its
    # full chunks (282 nnz at caps (8, 32, 128): 128 + 128 + a 26-tail)
    caps = (8, 32, 128)
    coo = _random_coo(rng, 60, 282 / (60 * 60))
    assert coo.nnz > 2 * caps[-1]
    d = DeltaBatch.of(inserts=[(int(coo.rows[0]), int(coo.cols[0]), 9.0)],
                      removes=[(int(coo.rows[0]), int(coo.cols[0]))])
    final = apply_coo(coo, d)
    b1 = apply_delta(plan_from_tiles_bucketed(coo_to_scv_tiles(coo, 64, cap=caps[-1]), caps=caps), d)
    _eq_fields(b1, plan_from_tiles_bucketed(coo_to_scv_tiles(final, 64, cap=caps[-1]), caps=caps))
    jb = jstream.apply_delta(jscv.plan_from_tiles_bucketed(
        jscv.coo_to_scv_tiles(_jcoo(coo), 64, cap=caps[-1]), caps=caps), _jdelta(d))
    _assert_matches_reference(b1, jb)


def test_parity_ladder_crossing(rng):
    # inserts push one tile from the cap-4 bucket past 4 and 16: it leaves
    # its segment, and a segment the delta does not reach stays the object
    coo = _random_coo(rng, 128, 0.002)
    r0, c0 = int(coo.rows[0]) // TILE * TILE, int(coo.cols[0]) // TILE * TILE
    have = set(zip(coo.rows.tolist(), coo.cols.tolist()))
    ins = [(r, c, 2.0) for r in range(r0, r0 + TILE) for c in range(c0, c0 + TILE)
           if (r, c) not in have][:20]
    d = DeltaBatch.of(inserts=ins)
    final = apply_coo(coo, d)
    b0 = plan_from_tiles_bucketed(coo_to_scv_tiles(coo, TILE, cap=CAPS[-1]), caps=CAPS)
    b1 = apply_delta(b0, d)
    _eq_fields(b1, plan_from_tiles_bucketed(coo_to_scv_tiles(final, TILE, cap=CAPS[-1]), caps=CAPS))
    assert b1.segments[0] is not b0.segments[0] and b1.segments[2] is not b0.segments[2]
    assert b1.segments[1] is b0.segments[1]


def test_source_and_scan_paths_agree(rng):
    # net-shrinking delta: moved tail survivors located by coordinate
    # arithmetic (source=) and by the perm scan alike
    coo = _random_coo(rng, 257, 0.01)
    d = _random_delta(rng, coo, 0, 12)
    for _, t0, _ in _layers(coo):
        _eq_fields(apply_delta(t0, d, source=coo), apply_delta(t0, d))
    _eq_fields(apply_delta(coo_to_scv_tiles(coo, TILE, cap=CAPS[-1]), d, source=coo),
               coo_to_scv_tiles(apply_coo(coo, d), TILE, cap=CAPS[-1]))


# ---------------------------------------------------------------------------
# in-place patching and identity
# ---------------------------------------------------------------------------
def test_inplace_layout_equal_returns_same_object(rng):
    coo = _random_coo(rng, 64, 0.05)
    t = coo_to_scv_tiles(coo, TILE, cap=CAPS[-1])
    d = DeltaBatch.of(inserts=[(int(coo.rows[1]), int(coo.cols[1]), 9.5)],
                      removes=[(int(coo.rows[1]), int(coo.cols[1]))])
    assert apply_delta(t, d, inplace=True) is t
    _eq_fields(t, coo_to_scv_tiles(apply_coo(coo, d), TILE, cap=CAPS[-1]))


def test_inplace_layout_change_returns_fresh_object():
    coo = COOMatrix(rows=np.array([0, 1, 2], np.int32), cols=np.array([3, 4, 5], np.int32),
                    vals=np.ones(3, np.float32), shape=(64, 64))
    t = coo_to_scv_tiles(coo, TILE, cap=CAPS[-1])
    d = DeltaBatch.of(inserts=[(50, 50, 1.0)])
    out = apply_delta(t, d, inplace=True)
    assert out is not t  # tile birth: layout changed
    _eq_fields(out, coo_to_scv_tiles(apply_coo(coo, d), TILE, cap=CAPS[-1]))


def test_inplace_splice_leaves_earlier_plan_with_a_stale_run_index(rng):
    # a plan built from tiles before an in-place patch shares their arrays
    # (every block-row visited: no coverage dummies are appended), but its
    # run index describes the old nnz: it must not be served afterwards
    n = 48
    coo = _random_coo(rng, n, 0.02)
    diag = [(i, i, 1.0) for i in range(0, n, TILE)
            if not ((coo.rows == i) & (coo.cols == i)).any()]
    coo = apply_coo(coo, DeltaBatch.of(inserts=diag))
    t = coo_to_scv_tiles(coo, TILE, cap=CAPS[-1])
    plan = plan_from_tiles(t, with_perm=False)
    assert np.shares_memory(plan.vals.numpy(), t.vals)
    have = set(zip(coo.rows.tolist(), coo.cols.tolist()))
    r0, c0 = int(coo.rows[0]) // TILE * TILE, int(coo.cols[0]) // TILE * TILE
    free = next((r, c) for r in range(r0, r0 + TILE) for c in range(c0, c0 + TILE)
                if (r, c) not in have)
    assert apply_delta(t, DeltaBatch.of(inserts=[(*free, 3.0)]), inplace=True) is t
    rep = validate_plan(plan)
    assert [c.invariant for c in rep.failures] == ["run-index"], rep.summary()
    assert run_index_diff(plan.runs, plan_from_tiles(t, with_perm=False).runs)


def test_inplace_rejected_on_plans(rng):
    coo = _random_coo(rng, 64, 0.05)
    p = plan_from_tiles(coo_to_scv_tiles(coo, TILE, cap=CAPS[-1]))
    with pytest.raises(ValueError, match="inplace"):
        apply_delta(p, DeltaBatch.of(inserts=[(0, 0, 1.0)]), inplace=True)


def test_untouched_segments_kept_by_identity_with_their_run_index(rng):
    coo = _random_coo(rng, 257, 0.01)
    b = plan_from_tiles_bucketed(coo_to_scv_tiles(coo, TILE, cap=CAPS[-1]), caps=CAPS)
    counters = {j: s.runs.counters("cpu", 2) for j, s in enumerate(b.segments)}
    d = DeltaBatch.of(inserts=[(int(coo.rows[0]), int(coo.cols[0]), 3.0)],
                      removes=[(int(coo.rows[0]), int(coo.cols[0]))])
    b2 = apply_delta(b, d)
    shared = [j for j, (a, c) in enumerate(zip(b.segments, b2.segments)) if a is c]
    assert len(shared) >= len(b.segments) - 1  # at most one segment re-chunked
    for j in shared:
        assert b2.segments[j].runs is b.segments[j].runs
        assert b2.segments[j].runs.counters("cpu", 2) is counters[j]
    for j in set(range(len(b.segments))) - set(shared):
        # a value update keeps the layout: coordinates shared, index rebuilt
        assert b2.segments[j].tile_row is b.segments[j].tile_row
        assert b2.segments[j].runs is not b.segments[j].runs


def test_empty_delta_returns_same_object(rng):
    coo = _random_coo(rng, 64, 0.05)
    t = coo_to_scv_tiles(coo, TILE, cap=CAPS[-1])
    assert apply_delta(t, DeltaBatch.of()) is t


# ---------------------------------------------------------------------------
# error paths
# ---------------------------------------------------------------------------
def test_remove_absent_edge_raises(rng):
    coo = _random_coo(rng, 32, 0.05)
    have = set(zip(coo.rows.tolist(), coo.cols.tolist()))
    absent = next((r, c) for r in range(32) for c in range(32) if (r, c) not in have)
    for _, t0, _ in _layers(coo):
        with pytest.raises(ValueError, match="absent edge"):
            apply_delta(t0, DeltaBatch.of(removes=[absent]))


def test_insert_present_edge_raises(rng):
    coo = _random_coo(rng, 32, 0.05)
    d = DeltaBatch.of(inserts=[(int(coo.rows[0]), int(coo.cols[0]), 1.0)])
    for _, t0, _ in _layers(coo):
        with pytest.raises(ValueError, match="remove it in the same batch"):
            apply_delta(t0, d, check=False)  # the splice itself also rejects


def test_plan_without_perm_raises(rng):
    coo = _random_coo(rng, 32, 0.05)
    p = plan_from_tiles(coo_to_scv_tiles(coo, TILE, cap=CAPS[-1]), with_perm=False)
    with pytest.raises(ValueError, match="perm"):
        apply_delta(p, DeltaBatch.of(inserts=[(0, 0, 1.0)]))


def test_composite_is_not_patchable():
    from repro_torch.serve.graph_engine import assemble_batched_graph

    # the first member visits block-row 0 only: its coverage dummies sit
    # between its real tiles and the second member's in the composite
    first = COOMatrix(rows=np.array([0, 1, 2], np.int32), cols=np.array([5, 20, 33], np.int32),
                      vals=np.ones(3, np.float32), shape=(40, 40))
    second = COOMatrix(rows=np.array([0, 20], np.int32), cols=np.array([0, 20], np.int32),
                       vals=np.ones(2, np.float32), shape=(30, 30))
    gs = [build_graph(a, tile=TILE, bucket_caps=CAPS, device="cpu") for a in (first, second)]
    bg = assemble_batched_graph(gs, TILE, 128, device="cpu")
    with pytest.raises(ValueError, match="not patchable"):
        apply_delta(bg.graph.plan, DeltaBatch.of(removes=[(int(gs[0].rows[0]), int(gs[0].cols[0]))]))


def test_placed_plans_are_not_patchable(rng):
    """As in the reference, a placed plan and a Graph holding one are
    refused: the plan is patched before placement and placed again, which
    gives the placement of the rebuild."""
    from repro.core import dist as jdist
    from repro_torch.core.exec import PlanExecutor, ShardingDecision

    coo = _random_coo(rng, 96, 0.05)
    g = build_graph(coo, tile=TILE, bucket_caps=CAPS, device="cpu")
    ex = PlanExecutor(devices=(torch.device("cpu"),) * 2)
    decision = ShardingDecision("tiles", 2, 1)
    placed = ex.prepare_graph(g, decision=decision)
    edge = (int(coo.rows[0]), int(coo.cols[0]))
    d = DeltaBatch.of(removes=[edge])
    with pytest.raises(TypeError, match="cannot patch ShardedPlan"):
        apply_delta(placed.plan, d)
    with pytest.raises(TypeError, match="re-shard the patched plan"):
        apply_delta(placed, d)
    jg = jgnn.build_graph(_jcoo(coo), tile=TILE, bucket_caps=CAPS)
    jd = jstream.DeltaBatch.of(removes=[edge])
    jsp = jdist.distribute_plan(jg.plan, 1)
    with pytest.raises(TypeError, match="cannot patch ShardedPlan"):
        jstream.apply_delta(jsp, jd)
    with pytest.raises(TypeError, match="re-shard the patched plan"):
        jstream.apply_delta(dataclasses.replace(jg, plan=jsp), jd)
    patched = ex.prepare_graph(apply_delta(g, d), decision=decision)
    rebuilt = ex.prepare_graph(build_graph(apply_coo(coo, d), tile=TILE, bucket_caps=CAPS,
                                           device="cpu"), decision=decision)
    for a, b in zip(patched.plan.stacked(), rebuilt.plan.stacked()):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_unknown_object_raises():
    with pytest.raises(TypeError, match="cannot patch"):
        apply_delta(object(), DeltaBatch.of(inserts=[(0, 0, 1.0)]), check=False)


# ---------------------------------------------------------------------------
# aggregation and models on patched plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("caps", [None, CAPS], ids=["single-cap", "bucketed"])
def test_patched_aggregation_bit_exact_on_integers(rng, caps):
    coo = _random_coo(rng, 200, 0.01, integer=True)
    z = rng.integers(-4, 5, (200, 24)).astype(np.float32)
    g = build_graph(coo, tile=TILE, bucket_caps=caps, device="cpu")
    jg = jgnn.build_graph(_jcoo(coo), tile=TILE, bucket_caps=caps)
    for step in range(3):
        d = _random_delta(rng, coo, 4 + step, 6, integer=True)
        coo = apply_coo(coo, d)
        g = apply_delta(g, d)
        jg = jstream.apply_delta(jg, _jdelta(d))
        rebuilt = build_graph(coo, tile=TILE, bucket_caps=caps, device="cpu")
        got = aggregate_scv_plan(g.plan, torch.from_numpy(z))
        assert torch.equal(got, aggregate_scv_plan(rebuilt.plan, torch.from_numpy(z)))
        want = np.asarray(j_aggregate(jg.plan, jnp.asarray(z), backend="jnp"))
        np.testing.assert_array_equal(got.numpy(), want)


def test_patched_graph_serves_gat_like_reference(rng):
    import jax

    coo = _random_coo(rng, 150, 0.02)
    d = _random_delta(rng, coo, 5, 8)
    jcfg = jgnn.GNNConfig(name="gat", kind="gat", d_in=8, d_hidden=16, n_classes=4,
                          backend="jnp")
    tcfg = tgnn.GNNConfig(name="gat", kind="gat", d_in=8, d_hidden=16, n_classes=4)
    jparams, _ = jgnn.init_gnn(jax.random.PRNGKey(0), jcfg)
    tparams = tgnn.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    x = rng.standard_normal((150, 8)).astype(np.float32)
    g = apply_delta(build_graph(coo, tile=TILE, bucket_caps=CAPS, device="cpu"), d)
    jg = jgnn.build_graph(jstream.apply_coo(_jcoo(coo), _jdelta(d)), tile=TILE, bucket_caps=CAPS)
    got = tgnn.gnn_forward(tparams, tcfg, g, torch.from_numpy(x)).numpy()
    want = np.asarray(jgnn.gnn_forward(jparams, jcfg, jg, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_patched_plans_validate_green(rng):
    coo = _random_coo(rng, 129, 0.02)
    d = _random_delta(rng, coo, 5, 5)
    final = apply_coo(coo, d)
    tiles = coo_to_scv_tiles(coo, TILE, cap=CAPS[-1])
    validate_plan(apply_delta(plan_from_tiles(tiles), d), coo=final).raise_if_failed()
    validate_plan(apply_delta(plan_from_tiles_bucketed(tiles, caps=CAPS), d),
                  coo=final).raise_if_failed()


def _step(rng, coo):
    """A random mix of inserts, removes and value updates."""
    have = set(zip(coo.rows.tolist(), coo.cols.tolist()))
    n = coo.shape[0]
    inserts, removes = [], []
    for i in rng.choice(coo.nnz, size=min(int(rng.integers(0, 5)), coo.nnz), replace=False):
        r, c = int(coo.rows[i]), int(coo.cols[i])
        removes.append((r, c))
        if rng.random() < 0.5:
            inserts.append((r, c, float(rng.integers(1, 5))))
    for _ in range(int(rng.integers(0, 5))):
        r, c = int(rng.integers(n)), int(rng.integers(n))
        if (r, c) not in have and all((r, c) != e[:2] for e in inserts):
            inserts.append((r, c, float(rng.integers(1, 5))))
    return DeltaBatch.of(inserts=inserts, removes=removes)


def _sequence_roundtrip(seed, n, density, tile, caps):
    rng = np.random.default_rng(seed)
    coo = _random_coo(rng, n, density, integer=True)
    tiles = coo_to_scv_tiles(coo, tile, cap=caps[-1])
    plan, bplan = plan_from_tiles(tiles), plan_from_tiles_bucketed(tiles, caps=caps)
    for _ in range(4):
        d = _step(rng, coo)
        if len(d) == 0:
            continue
        coo = apply_coo(coo, d)
        plan, bplan = apply_delta(plan, d), apply_delta(bplan, d)
        ref_tiles = coo_to_scv_tiles(coo, tile, cap=caps[-1])
        _eq_fields(plan, plan_from_tiles(ref_tiles))
        _eq_fields(bplan, plan_from_tiles_bucketed(ref_tiles, caps=caps))
        validate_plan(bplan, coo=coo).raise_if_failed()


def test_delta_sequence_roundtrip():
    _sequence_roundtrip(7, 129, 0.02, 16, (8, 32))


def test_delta_sequence_hypothesis():
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=25, deadline=None)
    @hyp.given(
        seed=st.integers(min_value=0, max_value=2**31 - 1),
        n=st.integers(min_value=8, max_value=100),
        density=st.floats(min_value=0.005, max_value=0.2),
        tile=st.sampled_from([8, 16]),
        caps=st.sampled_from([(8, 32), (4, 16, 64), (64,)]),
    )
    def prop(seed, n, density, tile, caps):
        _sequence_roundtrip(seed, n, density, tile, caps)

    prop()


# ---------------------------------------------------------------------------
# no rebuild inside the delta package
# ---------------------------------------------------------------------------
def _stream_files():
    root = os.path.join(REPO, "src", "repro_torch", "stream")
    return sorted(os.path.join(root, f) for f in os.listdir(root) if f.endswith(".py"))


@pytest.mark.parametrize("path", _stream_files(), ids=os.path.basename)
def test_stream_package_calls_no_rebuild(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    calls = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            calls.add(f.id if isinstance(f, ast.Name) else getattr(f, "attr", None))
        elif isinstance(node, (ast.ImportFrom, ast.Import)):
            calls.update(a.name.split(".")[-1] for a in node.names)
    assert not calls & set(REBUILDERS), f"{path} reaches {sorted(calls & set(REBUILDERS))}"


def test_apply_delta_runs_with_builders_raising(rng, monkeypatch):
    coo = _random_coo(rng, 200, 0.01)
    d = _random_delta(rng, coo, 6, 9)
    objs = [t0 for _, t0, _ in _layers(coo)]
    objs += [build_graph(coo, tile=TILE, bucket_caps=c, device="cpu") for c in (None, CAPS)]
    want = [apply_delta(o, d) for o in objs]

    def refuse(*a, **k):
        raise AssertionError("apply_delta called a plan builder")

    import repro_torch.core.scv as scv_mod
    import repro_torch.models.gnn as gnn_mod

    for mod in (scv_mod, gnn_mod, tdelta):
        for name in REBUILDERS:
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, refuse)
    for o, w in zip(objs, want):
        got = apply_delta(o, d)
        _eq_fields(getattr(got, "plan", got), getattr(w, "plan", w))
