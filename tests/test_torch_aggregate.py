"""The port's aggregation backends against the reference's: for the same
seeded COO and Z, ``aggregate`` over every format of the reference's
dispatcher, ``aggregate_hybrid``, ``aggregate_scv_tiles`` over a passed
arrays dict and the device-array bundles, on the CPU (the reference on its
jnp path).  Bit-exact on integer values, within 1e-5 of the largest
magnitude on normal ones.  The host layouts the backends read
(``scv_to_tiles``, ``split_hybrid``, ``SCVTiles.to_coo`` and
``padding_fraction``) equal the reference's array for array."""
import importlib

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import formats as jfmt
from repro.core import scv as jscv
import repro_torch.core as tcore
from repro_torch.core import formats as tfmt
from repro_torch.core import scv as tscv
from repro_torch.core.exec import PlanExecutor, ShardingDecision
from repro_torch.simul import datasets as tdata

# the packages re-export the function ``aggregate`` over the module's name
jagg = importlib.import_module("repro.core.aggregate")
tagg = importlib.import_module("repro_torch.core.aggregate")
CPU = torch.device("cpu")
T = 16
FORMATS = ("ndarray", "tensor", "coo", "csr", "csc", "bcsr", "scv_matrix", "scv_tiles",
           "scv_tiles_arrays", "scv_plan", "bucketed_plan", "sharded_plan")
ORDERS = (tscv.ZMORTON, tscv.ROW_MAJOR)


def _coo(values, n=300, seed=0):
    """A seeded power-law COO: GCN-normalised values, or integers in -4..4."""
    a = tdata.gcn_normalize(tdata.powerlaw_graph(n, 5 * n, seed=seed))
    if values == "int":
        rng = np.random.default_rng(seed + 1)
        a = tfmt.COOMatrix(a.rows, a.cols, rng.integers(-4, 5, a.nnz).astype(np.float32),
                           a.shape)
    return a


def _dense_coo(values, seed=2):
    """A graph of which about a sixth of the T = 16 tiles are past the
    hybrid's density rule (T^2 / 16 = 16 entries)."""
    a = tdata.powerlaw_edges(256, 4000, seed=seed)
    vals = (np.random.default_rng(seed).integers(-4, 5, a.nnz) if values == "int"
            else np.random.default_rng(seed).standard_normal(a.nnz)).astype(np.float32)
    return tfmt.COOMatrix(a.rows, a.cols, vals, a.shape)


def _jcoo(a):
    return jfmt.COOMatrix(a.rows, a.cols, a.vals, a.shape)


def _z(values, n, f=24, seed=3):
    rng = np.random.default_rng(seed)
    z = rng.integers(-4, 5, (n, f)) if values == "int" else rng.standard_normal((n, f))
    return z.astype(np.float32)


def _check(got: torch.Tensor, want, values):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if values == "int":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def _formats(fmt, a):
    """The reference's and the port's object of format ``fmt`` for COO ``a``."""
    ja = _jcoo(a)
    if fmt in ("ndarray", "tensor"):
        d = a.to_dense()
        return d, (torch.from_numpy(d) if fmt == "tensor" else d)
    if fmt == "coo":
        return ja, a
    if fmt == "csr":
        return jfmt.coo_to_csr(ja), tfmt.coo_to_csr(a)
    if fmt == "csc":
        return jfmt.coo_to_csc(ja), tfmt.coo_to_csc(a)
    if fmt == "bcsr":
        return jfmt.coo_to_bcsr(ja, T), tfmt.coo_to_bcsr(a, T)
    if fmt == "scv_matrix":
        return jscv.coo_to_scv(ja, T), tscv.coo_to_scv(a, T)
    jt, tt = jscv.coo_to_scv_tiles(ja, T, cap=8), tscv.coo_to_scv_tiles(a, T, cap=8)
    if fmt in ("scv_tiles", "scv_tiles_arrays"):
        return jt, tt
    if fmt == "scv_plan":
        return jscv.plan_from_tiles(jt), tscv.plan_from_tiles(tt)
    jt, tt = jscv.coo_to_scv_tiles(ja, T, cap=32), tscv.coo_to_scv_tiles(a, T, cap=32)
    jp = jscv.plan_from_tiles_bucketed(jt, caps=(8, 32))
    tp = tscv.plan_from_tiles_bucketed(tt, caps=(8, 32))
    if fmt == "sharded_plan":
        # the reference's placed aggregation needs a mesh; both hold the
        # placed plan to the function the unsharded one computes
        ex = PlanExecutor(devices=(CPU,) * 4)
        tp = ex.prepare(tp, decision=ShardingDecision("tiles", 4, 1))
    return jp, tp


@pytest.mark.parametrize("values", ["int", "normal"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_aggregate_every_format_matches_reference(fmt, values):
    a = _coo(values)
    z = _z(values, a.shape[1])
    ja, ta = _formats(fmt, a)
    want = jagg.aggregate(ja, z)
    if fmt == "scv_tiles_arrays":
        arrays = tagg.scv_device_arrays(ta, device="cpu")
        got = tagg.aggregate_scv_tiles(ta, torch.from_numpy(z), arrays=arrays)
    else:
        got = tagg.aggregate(ta, torch.from_numpy(z))
    _check(got, want, values)


@pytest.mark.parametrize("values", ["int", "normal"])
@pytest.mark.parametrize("graph", ["sparse", "dense tiles"])
def test_aggregate_hybrid_matches_reference(graph, values):
    # at T = 32 no tile of the sparse graph passes T^2 / 16 = 64 entries
    a, tile = (_coo(values), 32) if graph == "sparse" else (_dense_coo(values), T)
    z = _z(values, a.shape[1])
    jt, tt = jscv.coo_to_scv_tiles(_jcoo(a), tile), tscv.coo_to_scv_tiles(a, tile)
    n_dense = tscv.split_hybrid(tt)[1].n_tiles
    assert (n_dense > 0) == (graph == "dense tiles")
    _check(tagg.aggregate_hybrid(tt, torch.from_numpy(z)),
           jagg.aggregate_hybrid(jt, z), values)


@pytest.mark.parametrize("bundle", ["csr", "scv", "scv without coverage"])
def test_device_arrays_match_reference(bundle):
    a = _coo("normal")
    if bundle == "csr":
        want = jagg.csr_device_arrays(jfmt.coo_to_csr(_jcoo(a)))
        got = tagg.csr_device_arrays(tfmt.coo_to_csr(a), device="cpu")
    else:
        cover = bundle == "scv"
        want = jagg.scv_device_arrays(jscv.coo_to_scv_tiles(_jcoo(a), T), ensure_coverage=cover)
        got = tagg.scv_device_arrays(tscv.coo_to_scv_tiles(a, T), ensure_coverage=cover,
                                     device="cpu")
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("cap", [None, 8])
@pytest.mark.parametrize("order", ORDERS)
def test_tile_layouts_match_reference(order, cap):
    """scv_to_tiles, SCVTiles.to_coo and padding_fraction, and the hybrid
    split (dense blocks in the reference's order), array for array."""
    a = _dense_coo("normal")
    jm, tm = jscv.coo_to_scv(_jcoo(a), T, order), tscv.coo_to_scv(a, T, order)
    jt, tt = jscv.scv_to_tiles(jm, cap=cap), tscv.scv_to_tiles(tm, cap=cap)
    for k in ("tile_row", "tile_col", "rows", "cols", "vals", "nnz_in_tile", "perm"):
        np.testing.assert_array_equal(getattr(tt, k), np.asarray(getattr(jt, k)), err_msg=k)
    assert (tt.tile, tt.cap, tt.shape, tt.order) == (jt.tile, jt.cap, jt.shape, jt.order)
    assert tt.padding_fraction == jt.padding_fraction
    jc, tc = jt.to_coo(), tt.to_coo()
    for k in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(tc, k), getattr(jc, k), err_msg=k)
    assert tc.shape == jc.shape
    (js, jd), (ts, td) = jscv.split_hybrid(jt), tscv.split_hybrid(tt)
    assert td.n_tiles > 0 and ts.n_tiles > 0
    for k in ("tile_row", "tile_col", "rows", "cols", "vals", "nnz_in_tile", "perm"):
        np.testing.assert_array_equal(getattr(ts, k), getattr(js, k), err_msg=k)
    for k in ("tile_row", "tile_col", "blocks"):
        np.testing.assert_array_equal(getattr(td, k), getattr(jd, k), err_msg=k)
    assert (td.tile, td.shape) == (jd.tile, jd.shape)


def test_unknown_format_raises_type_error():
    z = torch.zeros((4, 2))
    with pytest.raises(TypeError, match="unsupported adjacency format"):
        tagg.aggregate(tfmt.coo_to_csb(_coo("normal", n=64), 8, 8), z)


def test_core_exports_cover_the_reference():
    assert set(jcore.__all__) <= set(tcore.__all__)
    for name in jcore.__all__:
        assert hasattr(tcore, name), name
