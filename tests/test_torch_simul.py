"""The port's simulator (``repro_torch.simul``) and the formats it replays
against the reference's, on the same graphs: every converter's arrays,
``SCVMatrix`` field for field, every dataflow's ``ComputeResult`` and
``TrafficResult`` (its Z-row stream too), ``simulate``'s ``MemoryResult``
and ``launched_slots`` equal the reference's exactly; ``load`` and
``dataset_names`` give the reference's graphs.  Then the paper's
qualitative claims (§V), as the reference's ``tests/test_simulator.py``
holds them, on the port's simulator."""
import dataclasses

import numpy as np
import pytest

from repro.core import formats as jformats
from repro.core import scv as jscv
from repro.simul import dataflows as jflows
from repro.simul import datasets as jdata
from repro.simul import machine as jmachine
from repro.simul import sim as jsim
from repro_torch.core import formats as tformats
from repro_torch.core import scv as tscv
from repro_torch.simul import MachineConfig, dataset_names, geomean, load, simulate
from repro_torch.simul import dataflows as tflows
from repro_torch.simul import datasets as tdata
from repro_torch.simul.dataflows import run_scv_width
from repro_torch.simul.datasets import TABLE_I
from repro_torch.tune.cost import plan_launched_slots

GRAPHS = ("arxiv", "cobuy_photo", "powerlaw")


@pytest.fixture(scope="module")
def graphs():
    """The port's graphs by name (``load`` at 120k edges, and a small
    power-law graph), each beside the reference's COO of the same arrays."""
    out = {
        "arxiv": load("arxiv", max_edges=120_000).adj,
        "cobuy_photo": load("cobuy_photo", max_edges=120_000).adj,
        "powerlaw": tdata.gcn_normalize(tdata.powerlaw_graph(3000, 18_000, seed=3)),
    }
    return {k: (a, _jcoo(a)) for k, a in out.items()}


@pytest.fixture(scope="module")
def ultra(graphs):
    return graphs["arxiv"][0]


@pytest.fixture(scope="module")
def highly(graphs):
    return graphs["cobuy_photo"][0]


def _jcoo(a):
    return jformats.COOMatrix(a.rows, a.cols, a.vals, a.shape)


def _assert_fields_equal(got, want, skip=()):
    """Dataclass fields equal, arrays array for array (dtype too)."""
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        if f.name in skip:
            continue
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        elif dataclasses.is_dataclass(w):
            _assert_fields_equal(g, w)
        else:
            assert g == w, (f.name, g, w)


# ---------------------------------------------------------------------------
# formats
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("conv", ["csr", "csc"])
def test_csr_csc_round_trip_equal_reference(graphs, name, conv):
    a, j = graphs[name]
    to = getattr(tformats, f"coo_to_{conv}")(a)
    jto = getattr(jformats, f"coo_to_{conv}")(j)
    _assert_fields_equal(to, jto)
    assert to.nnz == jto.nnz
    back = getattr(tformats, f"{conv}_to_coo")(to)
    _assert_fields_equal(back, getattr(jformats, f"{conv}_to_coo")(jto))


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("block", [4, 16])
def test_bcsr_equals_reference(graphs, name, block):
    a, j = graphs[name]
    got, want = tformats.coo_to_bcsr(a, block), jformats.coo_to_bcsr(j, block)
    _assert_fields_equal(got, want)
    assert (got.n_blocks, got.stored_values) == (want.n_blocks, want.stored_values)


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("h,w,reorder", [(64, 1, False), (64, 4, False), (32, 16, True)])
def test_csb_equals_reference(graphs, name, h, w, reorder):
    a, j = graphs[name]
    order = None
    if reorder:  # a block permutation, as SCV-Z passes one
        n_blocks = jformats.coo_to_csb(j, h, w).n_blocks
        order = np.random.default_rng(0).permutation(n_blocks)
    got = tformats.coo_to_csb(a, h, w, block_order=order)
    want = jformats.coo_to_csb(j, h, w, block_order=order)
    _assert_fields_equal(got, want)
    assert (got.n_blocks, got.nnz) == (want.n_blocks, want.nnz)


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("order", [tscv.ROW_MAJOR, tscv.ZMORTON])
@pytest.mark.parametrize("height", [64, 512])
def test_scv_matrix_equals_reference(graphs, name, order, height):
    a, j = graphs[name]
    got, want = tscv.coo_to_scv(a, height, order=order), jscv.coo_to_scv(j, height, order=order)
    _assert_fields_equal(got, want)
    assert (got.n_vectors, got.nnz, got.index_bits_per_entry) == (
        want.n_vectors, want.nnz, want.index_bits_per_entry)
    _assert_fields_equal(got.to_coo(), want.to_coo())


def test_scv_refuses_unknown_order_and_height(graphs):
    a, _ = graphs["powerlaw"]
    with pytest.raises(ValueError, match="unknown order"):
        tscv.coo_to_scv(a, 64, order="hilbert")
    with pytest.raises(ValueError, match="positive"):
        tscv.coo_to_scv(a, 0)


# ---------------------------------------------------------------------------
# dataflows and simulate
# ---------------------------------------------------------------------------
def _assert_flow_equal(got, want):
    comp, traffic = got[:2]
    jcomp, jtraffic = want[:2]
    _assert_fields_equal(comp, jcomp)
    _assert_fields_equal(traffic, jtraffic)
    assert traffic.total_bytes == jtraffic.total_bytes
    assert got[2:] == want[2:]  # run_scv_bucketed's slots


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("fmt", sorted(jflows.RUNNERS))
@pytest.mark.parametrize("f", [16, 128])
def test_runner_equals_reference(graphs, name, fmt, f):
    a, j = graphs[name]
    _assert_flow_equal(tflows.RUNNERS[fmt](a, f, MachineConfig()),
                       jflows.RUNNERS[fmt](j, f, jmachine.MachineConfig()))


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("tile,caps", [(64, None), (64, (8, 32, 128)), (32, (8,)), (128, (16, 64))])
def test_run_scv_bucketed_equals_reference(graphs, name, tile, caps):
    a, j = graphs[name]
    _assert_flow_equal(tflows.run_scv_bucketed(a, 64, MachineConfig(), tile, caps=caps),
                       jflows.run_scv_bucketed(j, 64, jmachine.MachineConfig(), tile, caps=caps))


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("width", [1, 4, 16])
def test_run_scv_width_equals_reference(graphs, name, width):
    a, j = graphs[name]
    _assert_flow_equal(tflows.run_scv_width(a, 128, MachineConfig(), height=64, width=width),
                       jflows.run_scv_width(j, 128, jmachine.MachineConfig(), height=64,
                                            width=width))


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("fmt", sorted(jflows.RUNNERS))
def test_simulate_equals_reference(graphs, name, fmt):
    a, j = graphs[name]
    got, want = simulate(a, 64, fmt), jsim.simulate(j, 64, fmt)
    assert got.fmt == want.fmt
    _assert_fields_equal(got.compute, want.compute)
    _assert_fields_equal(got.memory, want.memory)
    assert (got.compute_cycles, got.idle_cycles, got.traffic_bytes, got.mat,
            got.total_cycles) == (want.compute_cycles, want.idle_cycles,
                                  want.traffic_bytes, want.mat, want.total_cycles)


def test_geomean_equals_reference():
    xs = np.random.default_rng(1).uniform(0.1, 10.0, 17).tolist() + [0.0, -1.0, float("inf")]
    assert geomean(xs) == jsim.geomean(xs)
    assert np.isnan(geomean([])) and np.isnan(jsim.geomean([]))


# ---------------------------------------------------------------------------
# launched_slots (the cases of the reference's tests/test_tune.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("counts,tile,caps,n_row_blocks", [
    (np.zeros(0, np.int64), 64, (8, 32), 0),
    (np.zeros(0, np.int64), 64, (8, 32), 4),
    (np.array([70]), 64, (8, 32), 0),  # 2 full 32-chunks + 6 in the 8-cap bucket
    (np.array([8]), 64, (8, 32), 0),  # exact fit lands in its own cap
    (np.array([1, 9, 33, 300, 4096, 0]), 64, (8, 32, 128), 7),
    (np.array([5, 17]), 32, (32, 8), 2),  # unsorted ladder
])
def test_launched_slots_equals_reference(counts, tile, caps, n_row_blocks):
    want = jscv.launched_slots(counts, tile, caps, n_row_blocks=n_row_blocks)
    assert tscv.launched_slots(counts, tile, caps, n_row_blocks=n_row_blocks) == want


def test_launched_slots_refuses_an_empty_ladder():
    with pytest.raises(ValueError):
        tscv.launched_slots(np.array([1]), 64, ())


def test_launched_slots_brackets_built_plan():
    a = tdata.powerlaw_graph(1 << 12, 40_000, seed=3)
    T = 64
    counts = tscv.tile_nnz_histogram(a, T)
    caps = tscv.bucket_caps_for(counts, T)
    plan = tscv.plan_from_tiles_bucketed(tscv.coo_to_scv_tiles(a, T, cap=caps[-1]), caps=caps)
    built = plan_launched_slots(plan)
    lo = tscv.launched_slots(counts, T, caps)
    hi = tscv.launched_slots(counts, T, caps, n_row_blocks=-(-a.shape[0] // T))
    assert lo <= built <= hi
    assert lo == jscv.launched_slots(counts, T, caps)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("category", [None, "ultra", "highly"])
def test_dataset_names_equal_reference(category):
    assert dataset_names(category) == jdata.dataset_names(category)


@pytest.mark.parametrize("name", ["citeseer", "pubmed", "cobuy_photo"])
@pytest.mark.parametrize("normalize", [True, False])
def test_load_gives_reference_graph(name, normalize):
    got = load(name, max_edges=20_000, normalize=normalize, seed=2)
    want = jdata.load(name, max_edges=20_000, normalize=normalize, seed=2)
    assert (got.feature_size, got.scale, got.spec.name) == (
        want.feature_size, want.scale, want.spec.name)
    _assert_fields_equal(got.adj, want.adj)


# ---------------------------------------------------------------------------
# the paper's qualitative claims (§V), on the port's simulator
# ---------------------------------------------------------------------------
def test_iso_mac_across_formats(ultra):
    """§V-A: comparisons are iso-MAC (BCSR is the deliberate dense
    exception)."""
    macs = {fmt: simulate(ultra, 64, fmt).compute.macs
            for fmt in ["csr", "csc", "scv", "scv_z", "mp"]}
    for fmt, m in macs.items():
        assert m == macs["csr"], (fmt, m)
    assert simulate(ultra, 64, "bcsr", block=16).compute.macs > macs["csr"]


def test_scv_compute_beats_csr_on_ultra_sparse(ultra):
    res = {fmt: simulate(ultra, 128, fmt) for fmt in ["csr", "csc", "scv_z"]}
    assert res["csr"].compute_cycles > res["scv_z"].compute_cycles
    assert res["csc"].compute_cycles >= res["scv_z"].compute_cycles


def test_idle_cycles_ordering(ultra):
    """Fig. 8: orders of magnitude more idle for CSR on ultra-sparse."""
    res = {fmt: simulate(ultra, 128, fmt) for fmt in ["csr", "scv_z"]}
    assert res["csr"].idle_cycles > 50 * max(res["scv_z"].idle_cycles, 1)


def test_traffic_reduction(ultra, highly):
    for a in (ultra, highly):
        res = {fmt: simulate(a, 128, fmt) for fmt in ["csr", "csc", "scv_z"]}
        assert res["csr"].traffic_bytes > res["scv_z"].traffic_bytes
        assert res["csc"].traffic_bytes > res["scv_z"].traffic_bytes


def test_overall_speedup_positive(ultra, highly):
    for a in (ultra, highly):
        res = {fmt: simulate(a, 128, fmt) for fmt in ["csr", "csc", "mp", "scv_z"]}
        for base in ["csr", "csc", "mp"]:
            assert res[base].total_cycles > res["scv_z"].total_cycles, base


def test_scv_z_no_worse_than_scv(ultra):
    rz, rr = simulate(ultra, 128, "scv_z"), simulate(ultra, 128, "scv")
    assert rz.memory.dram_bytes <= rr.memory.dram_bytes * 1.05


def test_width_sweep_width1_wins(ultra):
    """Fig. 13: widening tiles beyond one column hurts."""
    traffic = {w: run_scv_width(ultra, 128, MachineConfig(), height=64, width=w)[1].total_bytes
               for w in [1, 4, 16]}
    assert traffic[1] < traffic[4] < traffic[16]


def test_multipass_traffic_regular_but_compute_heavy(ultra):
    mp, scv = simulate(ultra, 128, "mp"), simulate(ultra, 128, "scv_z")
    assert mp.compute_cycles > scv.compute_cycles  # re-scan overhead
    assert mp.memory.mat <= scv.memory.mat * 1.5  # regular DRAM access


def test_dataset_registry_stats():
    assert len(TABLE_I) == 10
    g = load("citeseer", max_edges=50_000)
    spec = TABLE_I["citeseer"]
    assert abs(g.adj.shape[0] - spec.nodes) / spec.nodes < 0.05
    dens = g.adj.nnz / (g.adj.shape[0] ** 2)
    assert dens < 10 * (spec.edges / spec.nodes**2 + 1.0 / spec.nodes)
