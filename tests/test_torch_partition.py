"""The port's Z-curve partitioning (``repro_torch.core.partition``) against
the reference's (``repro.core.partition``), on the same inputs:
``split_equal_nnz`` span for span (hand-made nnz sequences, zero-nnz and
empty ones included, and the reference tests' bucketed plan),
``shard_tiles`` and ``shard_plan`` leaf for leaf, and ``load_imbalance``.
All exact: the split is integer arithmetic and the gathers copy."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as jpart
from repro.core import scv as jscv
from repro.core.formats import COOMatrix as JCOO
from repro_torch.core import partition as tpart
from repro_torch.core import scv as tscv
from repro_torch.simul.datasets import gcn_normalize, powerlaw_graph

LEAVES = ("tile_row", "tile_col", "rows", "cols", "vals", "nnz_in_tile", "perm")
CAPS = (8, 32, 64)


@pytest.fixture(scope="module")
def plans():
    """The reference tests' graph (``powerlaw_graph(700, 5000, seed=0)``,
    T = 32, caps (8, 32, 64)) as tiles and plans in both packages."""
    a = gcn_normalize(powerlaw_graph(700, 5000, seed=0))
    jt = jscv.coo_to_scv_tiles(JCOO(a.rows, a.cols, a.vals, a.shape), 32, cap=CAPS[-1])
    tt = tscv.coo_to_scv_tiles(a, 32, cap=CAPS[-1])
    return dict(
        jtiles=jt, ttiles=tt,
        jplan=jscv.plan_from_tiles(jt), tplan=tscv.plan_from_tiles(tt),
        jbucketed=jscv.plan_from_tiles_bucketed(jt, caps=CAPS),
        tbucketed=tscv.plan_from_tiles_bucketed(tt, caps=CAPS),
    )


def assert_same_partition(got, want):
    np.testing.assert_array_equal(got.part_tiles, want.part_tiles)
    assert got.part_tiles.dtype == want.part_tiles.dtype
    np.testing.assert_array_equal(got.nnz_per_part, want.nnz_per_part)
    assert got.nnz_per_part.dtype == want.nnz_per_part.dtype
    assert got.n_parts == want.n_parts


NNZ_CASES = {
    "uniform": np.full(40, 3),
    "one-hub": np.r_[np.ones(30, int), 500, np.ones(30, int)],
    "hub-first": np.r_[900, np.ones(20, int)],
    "zeros-inside": np.r_[np.zeros(5, int), np.arange(1, 20), np.zeros(7, int)],
    "all-zero": np.zeros(9, int),
    "fewer-tiles-than-parts": np.array([4, 1, 7]),
    "empty": np.zeros(0, int),
    "one-tile": np.array([12]),
}


@pytest.mark.parametrize("n_parts", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("case", list(NNZ_CASES))
def test_split_equal_nnz_matches_reference(case, n_parts):
    nnz = NNZ_CASES[case].astype(np.int32)
    want = jpart.split_equal_nnz(types.SimpleNamespace(nnz_in_tile=nnz, n_tiles=nnz.size),
                                 n_parts)
    assert_same_partition(tpart.partition_of(nnz, n_parts), want)
    tiles = types.SimpleNamespace(nnz_in_tile=torch.from_numpy(nnz), n_tiles=nnz.size)
    assert_same_partition(tpart.split_equal_nnz(tiles, n_parts), want)


def test_split_equal_nnz_random_sequences_match_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        nnz = rng.zipf(2.0, int(rng.integers(0, 300))).clip(0, 4096).astype(np.int32)
        nnz[rng.random(nnz.size) < 0.2] = 0
        n_parts = int(rng.integers(1, 17))
        want = jpart.split_equal_nnz(
            types.SimpleNamespace(nnz_in_tile=nnz, n_tiles=nnz.size), n_parts)
        assert_same_partition(tpart.partition_of(nnz, n_parts), want)


@pytest.mark.parametrize("n_parts", [1, 3, 4, 8])
def test_split_equal_nnz_plans_match_reference(plans, n_parts):
    assert_same_partition(tpart.split_equal_nnz(plans["tplan"], n_parts),
                          jpart.split_equal_nnz(plans["jplan"], n_parts))
    got = tpart.split_equal_nnz(plans["tbucketed"], n_parts)
    want = jpart.split_equal_nnz(plans["jbucketed"], n_parts)
    assert isinstance(got, tuple) and len(got) == len(want) == len(CAPS)
    for g, w in zip(got, want):
        assert_same_partition(g, w)


@pytest.mark.parametrize("n_parts", [2, 8])
def test_shard_tiles_matches_reference(plans, n_parts):
    part = tpart.split_equal_nnz(plans["ttiles"], n_parts)
    got = tpart.shard_tiles(plans["ttiles"], part)
    want = jpart.shard_tiles(plans["jtiles"], jpart.split_equal_nnz(plans["jtiles"], n_parts))
    for k in LEAVES[:-1]:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        assert getattr(got, k).dtype == getattr(want, k).dtype
    assert got.perm is None and want.perm is None
    assert (got.tile, got.cap, got.shape, got.order) == (want.tile, want.cap, want.shape,
                                                         want.order)


@pytest.mark.parametrize("n_parts", [3, 8])
@pytest.mark.parametrize("layout", ["plan", "bucketed"])
def test_shard_plan_matches_reference(plans, layout, n_parts):
    """The gather on the plan's tensors equals the reference's on its
    arrays, padded slots included (coordinates 0, nnz 0, perm -1); the
    stacked result carries no run index."""
    tp, jp = plans["t" + layout], plans["j" + layout]
    got = tpart.shard_plan(tp, tpart.split_equal_nnz(tp, n_parts))
    want = jpart.shard_plan(jp, jpart.split_equal_nnz(jp, n_parts))
    gsegs, wsegs = getattr(got, "segments", (got,)), getattr(want, "segments", (want,))
    assert len(gsegs) == len(wsegs)
    for g, w in zip(gsegs, wsegs):
        assert g.runs is None
        for k in LEAVES:
            gv, wv = getattr(g, k).numpy(), np.asarray(getattr(w, k))
            np.testing.assert_array_equal(gv, wv)
            assert gv.dtype == wv.dtype, k
        assert (g.tile, g.cap, g.shape, g.order) == (w.tile, w.cap, w.shape, w.order)


def test_shard_plan_fills_a_segment_without_tiles():
    """A ladder rung holding no tile: every span slot is padding, as in the
    reference."""
    a = gcn_normalize(powerlaw_graph(120, 300, seed=3))
    caps = (8, 128, 4096)  # no tile reaches the top rung
    jp = jscv.plan_from_tiles_bucketed(
        jscv.coo_to_scv_tiles(JCOO(a.rows, a.cols, a.vals, a.shape), 32, cap=caps[-1]), caps=caps)
    tp = tscv.plan_from_tiles_bucketed(tscv.coo_to_scv_tiles(a, 32, cap=caps[-1]), caps=caps)
    assert tp.segments[-1].n_tiles == 0
    got = tpart.shard_plan(tp, tpart.split_equal_nnz(tp, 4)).segments[-1]
    want = jpart.shard_plan(jp, jpart.split_equal_nnz(jp, 4)).segments[-1]
    for k in LEAVES:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))


def test_shard_plan_needs_one_partition_per_segment(plans):
    part = tpart.split_equal_nnz(plans["tplan"], 2)
    with pytest.raises(ValueError, match="one Partition per segment"):
        tpart.shard_plan(plans["tbucketed"], part)


@pytest.mark.parametrize("n_parts", [2, 4, 8])
def test_load_imbalance_matches_reference(plans, n_parts):
    for layout in ("plan", "bucketed"):
        got = tpart.split_equal_nnz(plans["t" + layout], n_parts)
        want = jpart.split_equal_nnz(plans["j" + layout], n_parts)
        assert tpart.load_imbalance(got) == jpart.load_imbalance(want)
        assert (tpart.load_imbalance(got, per_segment=True)
                == jpart.load_imbalance(want, per_segment=True))
    for v in ([], [0, 0], [5], [1, 3, 8]):
        assert tpart.nnz_imbalance(np.array(v)) == jpart.nnz_imbalance(np.array(v))
        assert tpart.nnz_imbalance(np.array(v)) == jpart.nnz_imbalance(jnp.asarray(v))
