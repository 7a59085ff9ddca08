"""The port's work-unit index (``core/scv.py::RunIndex``), on the CPU.

Both CUDA bodies launch one thread block per work unit: a span of one
block-row run's tiles holding at most ``UNIT_WORK`` tiles + entries.  The
units of a split run each sum a partial strip from zero, summed over a
fixed binary tree of the units, and the root adds the seed.  These tests hold the
index's invariants on single-cap, bucketed and serving-composite plans, at
the module's ``UNIT_WORK`` and at small limits that split many runs, and
emulate that order of summation on the plain version: on integer inputs it
equals the plain chain and the reference's jnp segment-sum bit for bit,
and, for the scalar body on single-cap plans (an unaligned cap too), the
reference's scalar kernel in interpret mode.  The kernel itself runs in ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scv as jscv
from repro.core.aggregate import aggregate_coo_segsum as j_segsum
from repro.core.formats import COOMatrix as JCOO
from repro.kernels.scv_spmm import ops as jops
from repro_torch.core import scv
from repro_torch.core.formats import COOMatrix
from repro_torch.kernels.scv_spmm import ref
from repro_torch.models.gnn import build_graph
from repro_torch.serve.graph_engine import assemble_batched_graph
from repro_torch.simul.datasets import powerlaw_edges, powerlaw_graph

KINDS = ("single", "bucketed", "composite")
LIMITS = (None, 40, 8)  # None: the module's UNIT_WORK


def _int_coo(n, per_node, seed):
    """A power-law graph with integer weights 1-3 (every sum exact in f32)
    and a hub: node 0's block-row reaches a third of the columns."""
    a = powerlaw_graph(n, per_node * n, seed=seed)
    rng = np.random.default_rng(seed)
    hub = rng.choice(n, n // 3, replace=False).astype(a.cols.dtype)
    rows = np.concatenate([a.rows, np.zeros(hub.size, a.rows.dtype)])
    cols = np.concatenate([a.cols, hub])
    vals = rng.integers(1, 4, rows.size).astype(np.float32)
    return COOMatrix(rows, cols, vals, a.shape)


def _plan(kind, limit, monkeypatch):
    """(plan, the COO it aggregates) for one kind, built with ``limit``."""
    if limit is not None:
        monkeypatch.setattr(scv, "UNIT_WORK", limit)
    if kind == "single":
        a = _int_coo(400, 4, 1)
        return scv.plan_from_tiles(scv.coo_to_scv_tiles(a, 16)), a
    if kind == "bucketed":
        a = _int_coo(400, 6, 2)
        return build_graph(a, tile=16, bucket_caps=(8, 32, 128), device="cpu").plan, a
    members = [build_graph(_int_coo(n, 3, 3 + i), bucket_caps=(8, 32, 128), device="cpu")
               for i, n in enumerate([300, 130, 500])]
    g = assemble_batched_graph(members, 64, 1024, with_edges=True).graph
    return g.plan, COOMatrix(g.rows.numpy(), g.cols.numpy(), g.vals.numpy(), g.plan.shape)


def _segments(plan):
    return [s for s in getattr(plan, "segments", (plan,)) if s.n_tiles]


def _limit(limit):
    return scv.UNIT_WORK if limit is None else limit


@pytest.mark.parametrize("limit", LIMITS)
@pytest.mark.parametrize("kind", KINDS)
def test_units_cover_live_tiles_in_run_order(kind, limit, monkeypatch):
    plan, _ = _plan(kind, limit, monkeypatch)
    for seg in _segments(plan):
        ri = seg.runs
        units, up, ptr = ri.units.numpy(), ri.unit_ptr.numpy(), ri.ptr.numpy()
        nnz = seg.nnz_in_tile.numpy()
        assert ri.units.dtype == ri.unit_ptr.dtype == ri.order.dtype == torch.int32
        assert up[0] == 0 and up[-1] == ri.n_units and (np.diff(up) >= 1).all()
        owner = np.full(seg.n_tiles, -1)
        for r in range(ri.n_runs):
            mine = units[up[r]:up[r + 1]]
            assert (mine[:, 2] == r).all()
            # consecutive spans from the run's first tile to its last live one
            assert mine[0, 0] == ptr[r] and (mine[1:, 0] == mine[:-1, 1]).all()
            live = np.flatnonzero(nnz[ptr[r]:ptr[r + 1]])
            assert mine[-1, 1] == (ptr[r] + live[-1] + 1 if live.size else ptr[r])
            for u, (b, e, _, _) in enumerate(mine, start=up[r]):
                assert (owner[b:e] == -1).all()
                owner[b:e] = u
        assert (owner[nnz > 0] >= 0).all(), "a tile with entries lies in no unit"
        # scratch slots: consecutive, in unit order, for the units of split runs only
        split = np.diff(up)[units[:, 2]] > 1
        assert (units[~split, 3] == -1).all()
        assert units[split, 3].tolist() == list(range(ri.n_split_units))
        # launch order: a permutation, heaviest unit first
        order = ri.order.numpy()
        assert sorted(order.tolist()) == list(range(ri.n_units))
        assert (np.diff(ri.unit_work[order]) <= 0).all()


@pytest.mark.parametrize("limit", LIMITS)
@pytest.mark.parametrize("kind", KINDS)
def test_unit_work_bounded(kind, limit, monkeypatch):
    plan, _ = _plan(kind, limit, monkeypatch)
    w = _limit(limit)
    split_any = False
    for seg in _segments(plan):
        ri = seg.runs
        units = ri.units.numpy()
        nnz = seg.nnz_in_tile.numpy().astype(np.int64)
        work = np.array([(e - b) + nnz[b:e].sum() for b, e, _, _ in units])
        np.testing.assert_array_equal(work, ri.unit_work)
        one_tile = units[:, 1] - units[:, 0] == 1
        assert (one_tile | (work <= w)).all(), f"a unit over {w} holds more than one tile"
        assert ri.max_unit_work == work.max()
        split_any |= ri.n_split_units > 0
    if limit is not None:
        assert split_any, "want split runs"


def test_trailing_zero_tiles_and_empty_runs():
    # run 0: [5, 0] -> its trailing zero tile in no unit; run 1 all zero ->
    # one empty unit; run 2: a tile heavier than the limit is one unit of
    # its own, and with its neighbour the run splits
    ri = scv.RunIndex.of(np.array([3, 3, 1, 1, 1, 4, 4, 4], np.int32),
                         np.array([5, 0, 0, 0, 0, 9000, 1, 0], np.int32))
    assert ri.units.tolist() == [[0, 1, 0, -1], [2, 2, 1, -1], [5, 6, 2, 0], [6, 7, 2, 1]]
    assert ri.unit_ptr.tolist() == [0, 1, 2, 4]
    assert ri.unit_work.tolist() == [6, 0, 9001, 2]
    assert ri.order.tolist() == [2, 0, 3, 1]
    assert (ri.n_units, ri.n_split_units, ri.n_tiles, ri.max_unit_work) == (4, 2, 8, 9001)
    # one heavy tile alone is one unit, and its run is not split
    ri = scv.RunIndex.of(np.array([0], np.int32), np.array([9000], np.int32))
    assert ri.units.tolist() == [[0, 1, 0, -1]] and ri.n_split_units == 0
    empty = scv.RunIndex.of(np.zeros(0, np.int32), np.zeros(0, np.int32))
    assert (empty.n_units, empty.n_split_units, empty.max_unit_work) == (0, 0, 0)
    assert empty.units.shape == (0, 4) and empty.unit_ptr.tolist() == [0]


@pytest.mark.parametrize("limit", [None, 8])
def test_composite_padding_lies_in_no_unit(limit, monkeypatch):
    plan, _ = _plan("composite", limit, monkeypatch)
    padded = 0
    for seg in _segments(plan):
        nnz = seg.nnz_in_tile.numpy()
        last = seg.runs.ptr.numpy()[-2]  # the last run takes the tile-count padding
        tail = nnz[last:]
        n_pad = tail.size - (np.flatnonzero(tail)[-1] + 1 if tail.any() else 0)
        padded += n_pad
        assert seg.runs.units.numpy()[:, 1].max() <= seg.n_tiles - n_pad
        # coverage dummies: runs with no entry keep one empty unit
        units, up = seg.runs.units.numpy(), seg.runs.unit_ptr.numpy()
        run_nnz = np.add.reduceat(nnz, seg.runs.ptr.numpy()[:-1])
        for r in np.flatnonzero(run_nnz == 0):
            assert up[r + 1] - up[r] == 1 and units[up[r], 0] == units[up[r], 1]
    assert padded > 0, "want tile-count padding in the composite"


@pytest.mark.parametrize("kind", KINDS)
def test_run_index_to_keeps_units(kind, monkeypatch):
    plan, _ = _plan(kind, 8, monkeypatch)
    moved = plan.to(torch.device("cpu"))
    for a, b in zip(_segments(plan), _segments(moved)):
        for name in ("ptr", "units", "unit_ptr", "order"):
            assert torch.equal(getattr(a.runs, name), getattr(b.runs, name)), name
        np.testing.assert_array_equal(a.runs.unit_work, b.runs.unit_work)
        assert (a.runs.n_split_units, a.runs.n_tiles) == (b.runs.n_split_units, b.runs.n_tiles)


def test_counters_zeroed_once_per_device_and_width(monkeypatch):
    plan, _ = _plan("bucketed", 8, monkeypatch)
    ri = _segments(plan)[0].runs
    c = ri.counters("cpu", 2)
    # one a merge-tree node, named by a unit, per feature block
    assert c.dtype == torch.int32 and c.shape == (2 * ri.n_units,) and not c.any()
    assert ri.counters(torch.device("cpu"), 2) is c  # not re-made (or re-zeroed) per launch
    assert ri.counters("cpu", 1).shape == (ri.n_units,)
    assert ri.to("cpu").counters("cpu", 2) is not c  # a moved index has its own


def _unit_chain(plan, z, body="vector"):
    """The CUDA bodies' order of summation, on the plain version: per
    segment and run, each unit's partial strip from zero, then the seed plus
    the partials summed over the merge tree (``ref.tree_sum``)."""
    n_rows = plan.padded_shape[0]
    out = torch.zeros((n_rows, z.shape[1]))
    for seg in _segments(plan):
        T = seg.tile
        units, up = seg.runs.units.numpy(), seg.runs.unit_ptr.numpy()
        for r, br in enumerate(seg.runs.rows):
            strip = slice(int(br) * T, (int(br) + 1) * T)
            parts = []
            for b, e, _, _ in units[up[r]:up[r + 1]]:
                sel = slice(int(b), int(e))
                args = (seg.tile_row[sel], seg.tile_col[sel], seg.rows[sel], seg.cols[sel],
                        seg.vals[sel], z)
                kw = dict(tile=T, n_rows=n_rows, nnz_in_tile=seg.nnz_in_tile[sel])
                part = (ref.scv_spmm_reference(*args, **kw) if body == "scalar" else
                        ref.scv_spmm_vector_reference(
                            *args, dense_threshold=scv.dense_tile_threshold(T), **kw))
                parts.append(part[strip])
            out[strip] = out[strip] + ref.tree_sum(parts)
    return out


@pytest.mark.parametrize("limit", LIMITS)
@pytest.mark.parametrize("kind", KINDS)
def test_unit_sums_equal_plain_chain_and_reference(kind, limit, monkeypatch):
    plan, a = _plan(kind, limit, monkeypatch)
    rng = np.random.default_rng(5)
    z = rng.integers(-4, 5, (plan.shape[1], 12)).astype(np.float32)
    got = _unit_chain(plan, torch.from_numpy(z))
    assert torch.equal(got, ref.scv_spmm_reference_plan(plan, torch.from_numpy(z), body="vector"))
    want = np.asarray(j_segsum(jnp.asarray(a.rows), jnp.asarray(a.cols), jnp.asarray(a.vals),
                               jnp.asarray(z), plan.padded_shape[0]))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("limit", [None, 40])
@pytest.mark.parametrize("cap", ["auto", 37])
@pytest.mark.parametrize("tile", [64, 128])
def test_scalar_unit_sums_equal_reference_scalar_body(tile, cap, limit, monkeypatch):
    """The scalar body's schedule: single-cap plans as the reference's
    kernel benchmark builds them (the bucket ladder's top cap), and with a
    cap that is no multiple of 4, whose tiles' entries start at unaligned
    slots.  Per-unit plain sums merged over the tree equal the reference's
    ``body="scalar"`` kernel (interpret mode) bit for bit on integers."""
    if limit is not None:
        monkeypatch.setattr(scv, "UNIT_WORK", limit)
    a = powerlaw_edges(256, 12_000, seed=tile)
    a = COOMatrix(a.rows, a.cols,
                  np.random.default_rng(tile).integers(1, 4, a.rows.size).astype(np.float32),
                  a.shape)
    if cap == "auto":
        cap = build_graph(a, tile=tile, bucket_caps="auto", device="cpu").plan.caps[-1]
    plan = scv.plan_from_tiles(scv.coo_to_scv_tiles(a, tile, cap=cap))
    jplan = jscv.plan_from_tiles(jscv.coo_to_scv_tiles(JCOO(a.rows, a.cols, a.vals, a.shape),
                                                       tile, cap=cap))
    split = plan.runs.n_split_units
    assert split > 0, "want split runs"
    z = np.random.default_rng(1).integers(-4, 5, (a.shape[1], 12)).astype(np.float32)
    got = _unit_chain(plan, torch.from_numpy(z), body="scalar")
    want = np.asarray(jops.scv_spmm_plan(jplan, jnp.asarray(z), interpret=True, feature_block=8,
                                         body="scalar"))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, ref.scv_spmm_reference_plan(plan, torch.from_numpy(z), body="scalar"))
