"""One launch a chain, and the dense branch's 3xTF32 product, on the CPU.

The CUDA vector body takes every capacity segment of a chain in one launch
over the chain's plan-level run index (``core/scv.py::PlanRuns``): each
block-row is one run across the segments, cut into work units whose
pieces are spans of one segment's tiles.  Its dense tiles go to the
tensor cores in the 3xTF32 split.  These tests hold, without a card:

* the plan-level index's invariants on a single-cap plan, a bucketed plan
  (8, 32, 128), the serving composite, the transposed plan, a placed
  plan's spans, the padded tables of a captured forward, and a plan
  after a delta, at the module's ``UNIT_WORK`` and at limits that cut
  runs across segments;
* the kernel's order of summation, emulated on the plain version
  (``ref.scv_spmm_chain_units_reference``: each unit's partial strip, then
  each run's seed and partials in unit order), against the plain chain and
  the reference's Pallas chain (interpret mode) and jnp oracle: bit for bit
  on integers, within 1e-5 otherwise;
* the 3xTF32 model (``ref.tf32x3_matmul``): exact on integers within
  ±2^11, within 1e-5 of the f32 product on normal inputs;
* the launch count (one a chain, one a group of ``MAX_SEGMENTS``
  segments) and the chain's check in ``validate_plan``.

The kernel itself runs in ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` on the card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scv as jscv
from repro.core.formats import COOMatrix as JCOO
from repro.kernels.scv_spmm import ops as jops
from repro.kernels.scv_spmm import ref as jref
from repro_torch.core import exec as texec
from repro_torch.core import scv
from repro_torch.core.formats import COOMatrix
from repro_torch.core.validate import validate_plan
from repro_torch.kernels.scv_spmm import ops, ref
from repro_torch.kernels.scv_spmm.scv_spmm import MAX_SEGMENTS
from repro_torch.models.gnn import build_graph
from repro_torch.serve.graph_engine import assemble_batched_graph, plan_launches
from repro_torch.simul.datasets import powerlaw_graph
from repro_torch.stream import DeltaBatch, apply_delta

KINDS = ("single", "bucketed", "composite", "transposed", "spans", "delta")
LIMITS = (None, 40, 8)  # None: the module's UNIT_WORK
CPU4 = (torch.device("cpu"),) * 4


def _int_coo(n, per_node, seed):
    """A power-law graph with integer weights 1-3 (every sum exact in f32),
    a hub block-row reaching a third of the columns, and a dense corner:
    the first 16 x 16 block holds every entry, over T²/16 at T = 16."""
    a = powerlaw_graph(n, per_node * n, seed=seed)
    rng = np.random.default_rng(seed)
    hub = rng.choice(n, n // 3, replace=False).astype(a.cols.dtype)
    corner = np.arange(256)
    rows = np.concatenate([a.rows, np.zeros(hub.size, a.rows.dtype),
                           (corner // 16).astype(a.rows.dtype)])
    cols = np.concatenate([a.cols, hub, (corner % 16).astype(a.cols.dtype)])
    vals = rng.integers(1, 4, rows.size).astype(np.float32)
    return COOMatrix(rows, cols, vals, a.shape)


def _jplan(a, caps):
    t = jscv.coo_to_scv_tiles(JCOO(a.rows, a.cols, a.vals, a.shape), 16, cap=max(caps))
    return jscv.plan_from_tiles_bucketed(t, caps)


def _chains(kind, limit, monkeypatch):
    """(chains, the plan they come from, its COO): each chain a tuple of
    segments one vector launch takes, built with ``limit``."""
    if limit is not None:
        monkeypatch.setattr(scv, "UNIT_WORK", limit)
    if kind == "single":
        a = _int_coo(400, 4, 1)
        p = scv.plan_from_tiles(scv.coo_to_scv_tiles(a, 16))
        return [(p,)], p, a
    if kind == "composite":
        members = [build_graph(_int_coo(n, 3, 3 + i), bucket_caps=(8, 32, 128), device="cpu")
                   for i, n in enumerate([300, 130, 500])]
        g = assemble_batched_graph(members, 64, 1024, with_edges=True).graph
        a = COOMatrix(g.rows.numpy(), g.cols.numpy(), g.vals.numpy(), g.plan.shape)
        return [g.plan.segments], g.plan, a
    a = _int_coo(400, 6, 2)
    p = build_graph(a, tile=16, bucket_caps=(8, 32, 128), device="cpu").plan
    if kind == "bucketed":
        return [p.segments], p, a
    if kind == "transposed":
        pt = scv.transposed_plan(p)
        at = COOMatrix(a.cols, a.rows, a.vals, (a.shape[1], a.shape[0]))
        return [pt.segments], pt, at
    if kind == "spans":
        decision = texec.ShardingDecision("tiles", 4)
        sp = texec.PlanExecutor(devices=CPU4).prepare(p, decision=decision)
        spans = [sp.span(q) for q in range(4)]
        return [getattr(s, "segments", (s,)) for s in spans if s is not None], sp, a
    # a delta: value updates and inserts patched into the plan
    pd = apply_delta(p, _delta(a, 9))
    return [pd.segments], pd, None


def _delta(a, seed):
    """Value updates of existing edges and inserts of new ones."""
    rng = np.random.default_rng(seed)
    old = rng.choice(a.rows.size, 20, replace=False)
    have = set(zip(a.rows.tolist(), a.cols.tolist()))
    new = {(int(r), int(c)) for r, c in zip(rng.integers(0, a.shape[0], 30),
                                            rng.integers(0, a.shape[1], 30))} - have
    new = [(r, c, 3.0) for r, c in sorted(new)]
    upd = sorted({(int(a.rows[i]), int(a.cols[i]), 2.0) for i in old})
    return DeltaBatch.of(inserts=upd + new, removes=[(r, c) for r, c, _ in upd])


def _live_spans(runs):
    """Each run of one segment's index: (block-row, first tile, end of its
    last tile holding an entry)."""
    out = []
    for r in range(runs.n_runs):
        b, e = int(runs.tile_ptr[r]), int(runs.tile_ptr[r + 1])
        live = np.flatnonzero(runs.tile_nnz[b:e])
        out.append((int(runs.rows[r]), b, b + (int(live[-1]) + 1 if live.size else 0)))
    return out


def _check_index(pr, segments, limit):
    """The plan-level index's invariants against its segments."""
    runs = [s.runs for s in segments]
    pieces, units = pr.pieces.numpy(), pr.units.numpy()
    unit_ptr, order = pr.unit_ptr.numpy(), pr.order.numpy()
    assert pr.n_segments == len(segments) and pr.max_nnz == max(r.max_nnz for r in runs)
    # one run per block-row any segment visits, in order
    want_rows = sorted({int(r) for ri in runs for r in ri.rows})
    assert pr.rows.tolist() == want_rows == pr.run_row.numpy().tolist()
    assert unit_ptr[0] == 0 and unit_ptr[-1] == pr.n_units and (np.diff(unit_ptr) >= 1).all()
    assert (np.diff(units[:, 2]) >= 0).all() and (units[:, 2] == np.repeat(
        np.arange(pr.n_runs), np.diff(unit_ptr))).all()
    # the pieces of a run, unit after unit, walk each segment's live span of
    # that block-row once, in segment then tile order
    spans = {}
    for k, ri in enumerate(runs):
        for row, b, e in _live_spans(ri):
            if e > b:
                spans.setdefault(row, []).append((k, b, e))
    limit = scv.UNIT_WORK if limit is None else limit
    for r, row in enumerate(pr.rows.tolist()):
        walked = []
        for u in range(unit_ptr[r], unit_ptr[r + 1]):
            b, e = units[u, :2]
            own = pieces[b:e, :3].tolist()
            tiles = [(k, t) for k, t0, t1 in own for t in range(t0, t1)]
            work = sum(1 + int(runs[k].tile_nnz[t]) for k, t in tiles)
            assert work == pr.unit_work[u]
            assert work <= limit or len(tiles) == 1
            assert all(t1 > t0 for _, t0, t1 in own)
            walked += tiles
        want = [(k, t) for k, b, e in spans.get(row, []) for t in range(b, e)]
        assert walked == want, row
        if not want:  # a run without entries: one unit of no piece
            assert unit_ptr[r + 1] - unit_ptr[r] == 1
    # the units of a split run hold consecutive scratch slots, in unit order
    split = np.repeat(np.diff(unit_ptr) > 1, np.diff(unit_ptr))
    assert (units[~split, 3] == -1).all()
    assert units[split, 3].tolist() == list(range(int(split.sum())))
    assert pr.n_split_units == split.sum()
    assert order.tolist() == np.argsort(-pr.unit_work, kind="stable").tolist()


@pytest.mark.parametrize("limit", LIMITS)
@pytest.mark.parametrize("kind", KINDS)
def test_plan_level_index_invariants(kind, limit, monkeypatch):
    chains, _, _ = _chains(kind, limit, monkeypatch)
    assert chains
    for segments in chains:
        pr = scv.plan_runs(tuple(s.runs for s in segments))
        _check_index(pr, segments, limit)
        assert scv.plan_runs(tuple(s.runs for s in segments)) is pr  # kept, not rebuilt
    if limit == 40 and kind in ("bucketed", "composite"):
        pr = scv.plan_runs(tuple(s.runs for s in chains[0]))
        pieces, units = pr.pieces.numpy(), pr.units.numpy()
        assert any(len(set(pieces[b:e, 0])) > 1 for b, e, _, _ in units), "a unit across segments"


def test_padded_tables_hold_every_plan_of_their_shapes(monkeypatch):
    """The captured forward's tables: sized from the segments' shapes, they
    take the index of each plan of those shapes (two composites of one
    bucket, at two limits), padding past it; ``clear`` empties them."""
    for limit in (None, 8):
        if limit is not None:
            monkeypatch.setattr(scv, "UNIT_WORK", limit)
        for sizes in ([300, 130, 500], [280, 160, 470]):
            members = [build_graph(_int_coo(n, 3, 3 + i), bucket_caps=(8, 32, 128), device="cpu")
                       for i, n in enumerate(sizes)]
            plan = assemble_batched_graph(members, 64, 1024, with_edges=False).graph.plan
            real = scv.plan_runs(tuple(s.runs for s in plan.segments))
            pad = scv.PlanRuns.padded([(s.n_tiles, s.cap) for s in plan.segments],
                                      plan.n_row_blocks, "cpu")
            pad.load(real)
            n, k = real.n_units, real.n_runs
            assert torch.equal(pad.units[:n], real.units) and (pad.units[n:, 2] == -1).all()
            assert torch.equal(pad.pieces[:real.n_pieces], real.pieces)
            assert torch.equal(pad.unit_ptr[:k + 1], real.unit_ptr)
            assert torch.equal(pad.run_row[:k], real.run_row)
            assert torch.equal(pad.order[:n], real.order) and (pad.order[n:] == n).all()
            assert pad.max_nnz == max(s.cap for s in plan.segments)
            pad.clear()
            assert (pad.units[:, 2] == -1).all()
    with pytest.raises(ValueError, match="does not fit"):
        scv.PlanRuns.padded([(4, 8)], 2, "cpu").load(real)


def test_delta_gives_a_new_plan_level_index(monkeypatch):
    """A patched segment gets a new run index, so the chain a new
    plan-level index: built from the patched schedule, never the stale one."""
    chains, p, a = _chains("bucketed", 40, monkeypatch)
    before = scv.plan_runs(tuple(s.runs for s in p.segments))
    pd = apply_delta(p, _delta(a, 4))
    after = scv.plan_runs(tuple(s.runs for s in pd.segments))
    assert after is not before
    _check_index(after, pd.segments, 40)
    fresh = [scv.RunIndex.of(s.tile_row.numpy(), s.nnz_in_tile.numpy()) for s in pd.segments]
    want = scv.PlanRuns.of(fresh)
    for name in ("pieces", "units", "unit_ptr", "order", "run_row"):
        assert torch.equal(getattr(after, name), getattr(want, name)), name
    assert validate_plan(pd).ok


def test_validate_flags_a_stale_plan_level_index(monkeypatch):
    chains, p, a = _chains("bucketed", 40, monkeypatch)
    runs = tuple(s.runs for s in p.segments)
    scv.plan_runs(runs)
    assert validate_plan(p, coo=a).ok
    # an index built at another limit, kept for this chain: stale
    scv.keep_plan_runs(runs, scv.PlanRuns.of(runs, limit=8))
    rep = validate_plan(p, coo=a)
    assert [c.invariant for c in rep.failures] == ["run-index"]
    assert "plan-level" in rep.failures[0].detail


def _chain_inputs(kind, limit, monkeypatch, integer, f):
    chains, plan, a = _chains(kind, limit, monkeypatch)
    rng = np.random.default_rng(hash((kind, f)) % 2**32)
    n_cols = chains[0][0].shape[1]
    z = (rng.integers(-4, 5, (n_cols, f)) if integer else rng.standard_normal((n_cols, f)))
    z = torch.from_numpy(z.astype(np.float32))
    if not integer:  # real values in every live slot
        chains = [[dataclasses.replace(s, vals=torch.from_numpy(
            rng.standard_normal(tuple(s.vals.shape)).astype(np.float32)) * (s.vals != 0))
            for s in segs] for segs in chains]
    return chains, plan, a, z


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("limit", LIMITS)
@pytest.mark.parametrize("kind", ["single", "bucketed", "composite", "transposed", "spans"])
def test_unit_sums_in_merge_order_equal_plain_chain(kind, limit, integer, monkeypatch):
    """The kernel's sums modelled unit by unit (seed, then partials in unit
    order; dense tiles in 3xTF32) equal the plain chain of each launch:
    bit for bit on integers, within 1e-5 otherwise; with ``init="zeros"``
    from a seeded output as well."""
    chains, _, _, z = _chain_inputs(kind, limit, monkeypatch, integer, 7)
    for segments in chains:
        T = segments[0].tile
        thr = scv.dense_tile_threshold(T)
        pr = scv.plan_runs(tuple(s.runs for s in segments))
        n_rows = segments[0].padded_shape[0]
        vals = [s.vals for s in segments]
        plain = ref.scv_spmm_reference_plan(scv.SCVBucketedPlan(tuple(segments)), z,
                                            body="vector", dense_threshold=thr)
        seed = torch.full((n_rows, 7), 2.0)
        for accumulate, want in ((False, plain), (True, plain + 2.0)):
            got = ref.scv_spmm_chain_units_reference(segments, vals, z, pr, seed,
                                                     accumulate=accumulate, dense_threshold=thr)
            visited = np.zeros(n_rows // T, bool)
            visited[pr.rows] = True
            rows = torch.from_numpy(np.repeat(visited, T))
            if integer:
                assert torch.equal(got[rows], want[rows])
            else:
                torch.testing.assert_close(got[rows], want[rows], rtol=1e-5, atol=1e-5)
            assert bool((got[~rows] == 2.0).all())  # rows no run visits keep out


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("init", ["coverage", "zeros"])
def test_unit_sums_equal_reference_chain(init, integer, monkeypatch):
    """On the plan both packages build from one COO: the modelled sums of
    the one launch against the reference's Pallas chain (interpret mode,
    one launch per segment) and its jnp oracle."""
    monkeypatch.setattr(scv, "UNIT_WORK", 40)
    a = _int_coo(200, 5, 6)
    if not integer:
        a = dataclasses.replace(a, vals=np.random.default_rng(0).standard_normal(
            a.vals.size).astype(np.float32))
    caps = (8, 32, 256)
    tp = scv.plan_from_tiles_bucketed(scv.coo_to_scv_tiles(a, 16, cap=256), caps)
    jp = _jplan(a, caps)
    rng = np.random.default_rng(1)
    z = (rng.integers(-4, 5, (200, 8)) if integer else rng.standard_normal((200, 8)))
    z = z.astype(np.float32)
    pr = scv.plan_runs(tuple(s.runs for s in tp.segments))
    got = ref.scv_spmm_chain_units_reference(
        tp.segments, [s.vals for s in tp.segments], torch.from_numpy(z),
        pr, torch.zeros((tp.padded_shape[0], 8)), accumulate=init == "zeros",
        dense_threshold=scv.dense_tile_threshold(16)).numpy()
    kernel = np.asarray(jops.scv_spmm_plan(jp, jnp.asarray(z), interpret=True, feature_block=8,
                                           init=init))
    oracle = np.asarray(jref.scv_spmm_reference_plan(jp, jnp.asarray(z)))
    port = ops.scv_spmm_plan(tp, torch.from_numpy(z), init=init).numpy()
    for want in (kernel, oracle, port):
        if integer:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_tf32_round_is_round_to_nearest_ties_away():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(5000), -rng.standard_normal(5000) * 1e6,
                        [0.0, -0.0, 1.0, -1.0, 1.0 + 2.0**-11, -(1.0 + 2.0**-11),
                         1.0 + 3 * 2.0**-11]]).astype(np.float32)
    got = ref.tf32_round(torch.from_numpy(x)).numpy()
    # TF32 keeps 10 of f32's 23 mantissa bits: round the magnitude to a
    # multiple of 2^13 units, halves away from zero
    bits = np.abs(x).view(np.uint32).astype(np.int64)
    want = (np.floor((bits + 2**12) / 2**13) * 2**13).astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(got, np.sign(x) * want)
    assert (got.view(np.uint32) & 0x1FFF == 0).all()
    assert got[-3] == 1.0 + 2.0**-10 and got[-2] == -(1.0 + 2.0**-10)  # ties away from zero


def test_tf32_split_is_exact_on_integers_within_2_to_11():
    x = torch.arange(-2**11, 2**11 + 1, dtype=torch.float32)
    big, small = ref.tf32_split(x)
    assert torch.equal(big, x) and not bool(small.any())
    big, small = ref.tf32_split(torch.tensor([2.0**11 + 1]))
    assert float(small) != 0.0  # 2049 needs 12 significant bits: TF32 keeps 11


@pytest.mark.parametrize("bound", [4, 2**11])
def test_tf32x3_exact_on_integers(bound):
    """Integer D and Z within ±bound: the product equals the exact one
    (the depth keeps every sum below 2^24, where f32 holds integers)."""
    rng = np.random.default_rng(bound)
    depth = 64 if bound == 4 else 2
    d = rng.integers(-bound, bound + 1, (3, 64, depth)).astype(np.float32)
    z = rng.integers(-bound, bound + 1, (3, depth, 40)).astype(np.float32)
    got = ref.tf32x3_matmul(torch.from_numpy(d), torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got, (d.astype(np.float64) @ z).astype(np.float32))


@pytest.mark.parametrize("tile", [16, 64, 128])
def test_tf32x3_within_1e5_of_f32(tile):
    """Normal D and Z: within 1e-5 of the f32 product's largest magnitude;
    a single TF32 pass is not."""
    rng = np.random.default_rng(tile)
    d = torch.from_numpy(rng.standard_normal((4, tile, tile)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((4, tile, 128)).astype(np.float32))
    exact = d.double() @ z.double()
    scale = exact.abs().max().item()
    assert (ref.tf32x3_matmul(d, z).double() - exact).abs().max().item() <= 1e-5 * scale
    assert ((d @ z).double() - exact).abs().max().item() <= 1e-5 * scale
    single = ref.tf32_round(d) @ ref.tf32_round(z)
    assert (single.double() - exact).abs().max().item() > 1e-5 * scale


def test_one_launch_a_chain(monkeypatch):
    """The chain launches the vector body once over all segments (the
    reference: once a non-empty segment), and once a group of
    ``MAX_SEGMENTS`` segments on a longer ladder, whose output still
    equals the reference's oracle."""
    calls = []
    real = ops.scv_spmm_chain

    def counted(segments, *args, **kw):
        calls.append(len(segments))
        return real(segments, *args, **kw)

    monkeypatch.setattr(ops, "scv_spmm_chain", counted)
    chains, p, _ = _chains("bucketed", None, monkeypatch)
    z = torch.ones((p.shape[1], 4))
    ops.scv_spmm_plan(p, z)
    assert calls == [3] and plan_launches(p) == 1
    a = _int_coo(300, 8, 7)
    caps = tuple(range(1, MAX_SEGMENTS + 5)) + (512,)
    long = scv.plan_from_tiles_bucketed(scv.coo_to_scv_tiles(a, 16, cap=512), caps)
    groups = [long.segments[i:i + MAX_SEGMENTS] for i in range(0, len(caps), MAX_SEGMENTS)]
    assert len(groups) == 2 and all(any(s.n_tiles for s in g) for g in groups)
    calls.clear()
    z = np.random.default_rng(2).integers(-4, 5, (300, 5)).astype(np.float32)
    got = ops.scv_spmm_plan(long, torch.from_numpy(z)).numpy()
    assert calls == [MAX_SEGMENTS, len(caps) - MAX_SEGMENTS] and plan_launches(long) == 2
    want = np.asarray(jref.scv_spmm_reference_plan(_jplan(a, caps), jnp.asarray(z)))
    np.testing.assert_array_equal(got, want)
    assert ops.chain_launches(long, body="scalar") == sum(1 for s in long.segments if s.n_tiles)
