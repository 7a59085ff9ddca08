"""The port's SCV SpMM entry points against the reference, on the CPU.

The port's launch wrapper takes its plain version for CPU tensors, so
these tests hold the chain logic (segment order, accumulate mode, init
modes, empty segments), the wrapper's input checks and the plain version
against the reference's Pallas kernel in interpret mode (as
``tests/test_acc_chain.py`` runs it) and its jnp oracle.  Integer-valued
inputs must match bit for bit; real-valued inputs within rtol = atol =
1e-5 (float32 sums taken in another order).  The CUDA kernel itself runs
in ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the card.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coo_from_dense as j_coo_from_dense
from repro.core import coo_to_scv_tiles as j_coo_to_scv_tiles
from repro.core.aggregate import aggregate_coo_segsum as j_segsum
from repro.core.scv import plan_from_tiles_bucketed as j_bucketed
from repro.kernels.scv_spmm import ops as jops
from repro.kernels.scv_spmm import ref as jref
from repro_torch.core.aggregate import aggregate_coo_segsum, aggregate_scv_plan
from repro_torch.core.formats import coo_from_dense
from repro_torch.core.scv import RunIndex, coo_to_scv_tiles, plan_from_tiles_bucketed
from repro_torch.kernels.scv_spmm import ops, ref
from repro_torch.serve.graph_engine import plan_launches

kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")


def _int_dense(rng, m, density):
    return ((rng.random((m, m)) < density) * rng.integers(1, 5, (m, m))).astype(np.float32)


def _plans(a, tile=16, caps=(8, 32, 128)):
    """The same bucketed plan in both packages."""
    jp = j_bucketed(j_coo_to_scv_tiles(j_coo_from_dense(a), tile, cap=max(caps)), caps)
    tp = plan_from_tiles_bucketed(coo_to_scv_tiles(coo_from_dense(a), tile, cap=max(caps)), caps)
    return jp, tp


def _z(rng, n, f, integer):
    if integer:
        return rng.integers(-4, 5, (n, f)).astype(np.float32)
    return rng.standard_normal((n, f)).astype(np.float32)


@pytest.mark.parametrize("init", ["coverage", "zeros"])
@pytest.mark.parametrize("integer", [True, False])
def test_chain_matches_reference_kernel_and_oracle(rng, init, integer):
    a = _int_dense(rng, 128, 0.08) if integer else (
        (rng.random((128, 128)) < 0.08) * rng.standard_normal((128, 128))
    ).astype(np.float32)
    jp, tp = _plans(a)
    assert len([s for s in tp.segments if s.n_tiles]) >= 2, "want a real chain"
    z = _z(rng, 128, 24, integer)
    got = ops.scv_spmm_plan(tp, torch.from_numpy(z), init=init).numpy()
    kernel = np.asarray(
        jops.scv_spmm_plan(jp, jnp.asarray(z), interpret=True, feature_block=8, init=init)
    )
    oracle = np.asarray(jref.scv_spmm_reference_plan(jp, jnp.asarray(z)))
    plain = ref.scv_spmm_reference_plan(tp, torch.from_numpy(z)).numpy()
    assert got.shape == kernel.shape == (128, 24)
    for want in (kernel, oracle, plain):
        if integer:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bad_init_raises(rng):
    _, tp = _plans(_int_dense(rng, 64, 0.1))
    with pytest.raises(ValueError, match="init must be"):
        ops.scv_spmm_plan(tp, torch.zeros(64, 4), init="sideways")


@pytest.mark.parametrize("init", ["coverage", "zeros"])
def test_chain_with_empty_later_segment(rng, init):
    # ~20 entries per 16x16 tile: nothing reaches the 4096 bucket
    a = _int_dense(rng, 128, 0.08)
    jp, tp = _plans(a, caps=(8, 64, 4096))
    assert tp.segments[-1].n_tiles == 0 and tp.segments[1].n_tiles > 0
    assert plan_launches(tp) == 1  # one launch over both non-empty segments
    z = _z(rng, 128, 8, True)
    got = ops.scv_spmm_plan(tp, torch.from_numpy(z), init=init).numpy()
    want = np.asarray(
        jops.scv_spmm_plan(jp, jnp.asarray(z), interpret=True, feature_block=8, init=init)
    )
    np.testing.assert_array_equal(got, want)


def test_empty_first_segment_starts_from_zeros(rng):
    # every tile holds more than 4 entries, and without coverage dummies
    # the first (cap 4) segment carries no tile at all
    a = _int_dense(rng, 64, 0.5)
    caps = (4, 256)
    jp = j_bucketed(j_coo_to_scv_tiles(j_coo_from_dense(a), 16, cap=256), caps,
                    ensure_coverage=False)
    tp = plan_from_tiles_bucketed(coo_to_scv_tiles(coo_from_dense(a), 16, cap=256), caps,
                                  ensure_coverage=False)
    assert tp.segments[0].n_tiles == 0 and plan_launches(tp) == 1
    z = _z(rng, 64, 8, True)
    got = ops.scv_spmm_plan(tp, torch.from_numpy(z)).numpy()
    want = np.asarray(
        jops.scv_spmm_plan(jp, jnp.asarray(z), interpret=True, feature_block=8)
    )
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, a @ z)


@pytest.mark.parametrize("with_nnz", [True, False])
def test_loose_array_scv_spmm_matches_reference(rng, with_nnz):
    a = _int_dense(rng, 96, 0.1)
    jt = j_coo_to_scv_tiles(j_coo_from_dense(a), 32, cap=16)
    tt = coo_to_scv_tiles(coo_from_dense(a), 32, cap=16)
    z = _z(rng, 96, 12, True)
    want = np.asarray(jops.scv_spmm(
        jnp.asarray(jt.tile_row), jnp.asarray(jt.tile_col), jnp.asarray(jt.rows),
        jnp.asarray(jt.cols), jnp.asarray(jt.vals), jnp.asarray(z), tile=32, n_rows=96,
        nnz_in_tile=jnp.asarray(jt.nnz_in_tile) if with_nnz else None,
        interpret=True, feature_block=8,
    ))
    t = {k: torch.from_numpy(getattr(tt, k)) for k in
         ("tile_row", "tile_col", "rows", "cols", "vals", "nnz_in_tile")}
    got = ops.scv_spmm(
        t["tile_row"], t["tile_col"], t["rows"], t["cols"], t["vals"], torch.from_numpy(z),
        tile=32, n_rows=96, nnz_in_tile=t["nnz_in_tile"] if with_nnz else None,
    ).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, a @ z)


def test_infer_nnz_matches_reference(rng):
    a = _int_dense(rng, 64, 0.2)
    tt = coo_to_scv_tiles(coo_from_dense(a), 16, cap=32)
    got = ops._infer_nnz(*(torch.from_numpy(getattr(tt, k)) for k in ("rows", "cols", "vals")))
    want = jops._infer_nnz(*(jnp.asarray(getattr(tt, k)) for k in ("rows", "cols", "vals")))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ensure_row_coverage_matches_reference(rng):
    a = _int_dense(rng, 64, 0.05)
    a[16:48] = 0  # two unvisited block-rows at tile 16
    tt = coo_to_scv_tiles(coo_from_dense(a), 16, cap=8)
    args = (tt.tile_row, tt.tile_col, tt.rows, tt.cols, tt.vals, tt.nnz_in_tile, 4)
    for x, y in zip(ops.ensure_row_coverage(*args), jops.ensure_row_coverage(*args)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="2-D"):
        ops.ensure_row_coverage(tt.tile_row, tt.tile_col, tt.rows.ravel(), tt.cols,
                                tt.vals, tt.nnz_in_tile, 4)


def test_aggregation_matches_independent_oracle(rng):
    a = ((rng.random((100, 100)) < 0.07) * rng.standard_normal((100, 100))).astype(np.float32)
    coo = coo_from_dense(a)
    _, tp = _plans(a, tile=32, caps=(8, 32))
    z = _z(rng, 100, 16, False)
    got = aggregate_scv_plan(tp, torch.from_numpy(z)).numpy()
    oracle = aggregate_coo_segsum(
        torch.from_numpy(coo.rows), torch.from_numpy(coo.cols), torch.from_numpy(coo.vals),
        torch.from_numpy(z), 100,
    ).numpy()
    jor = np.asarray(j_segsum(jnp.asarray(coo.rows), jnp.asarray(coo.cols),
                              jnp.asarray(coo.vals), jnp.asarray(z), 100))
    assert got.shape == (100, 16)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(oracle, jor, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the launch wrapper's contract
# ---------------------------------------------------------------------------
def _segment_args(rng):
    _, tp = _plans(_int_dense(rng, 64, 0.1))
    s = tp.segments[0]
    z = torch.from_numpy(_z(rng, 64, 8, True))
    out = torch.zeros(64, 8)
    return s, [s.tile_row, s.tile_col, s.nnz_in_tile, s.rows, s.cols, s.vals, z, out, s.runs]


@pytest.mark.parametrize("fault,match", [
    ("int64_index", "must be int32"),
    ("f64_vals", "must be float32"),
    ("strided_z", "contiguous"),
    ("ragged_out", "not a multiple of tile"),
    ("short_cols", r"must be \[n_tiles"),
    ("split_run", "two runs"),
    ("run_outside", "outside out"),
])
def test_wrapper_rejects_bad_inputs(rng, fault, match):
    s, args = _segment_args(rng)
    if fault == "int64_index":
        args[0] = args[0].long()
    elif fault == "f64_vals":
        args[5] = args[5].double()
    elif fault == "strided_z":
        args[6] = torch.zeros(8, 64).t()
    elif fault == "ragged_out":
        args[7] = torch.zeros(60, 8)
    elif fault == "short_cols":
        args[4] = args[4][:, :-1].contiguous()
    elif fault == "split_run":
        args[8] = dataclasses.replace(s.runs, rows=np.zeros(s.runs.n_runs, np.int32))
    elif fault == "run_outside":
        args[8] = dataclasses.replace(s.runs, rows=s.runs.rows + 100)
    with pytest.raises(ValueError, match=match):
        kmod.scv_spmm_runs(*args, tile=16, accumulate=False)


def test_cpu_path_counts_no_launch(rng):
    s, args = _segment_args(rng)
    before = kmod.launches
    kmod.scv_spmm_runs(*args, tile=16, accumulate=True)
    _, tp = _plans(_int_dense(rng, 64, 0.1))
    ops.scv_spmm_plan(tp, torch.ones(64, 4))
    assert kmod.launches == before


def test_accumulate_mode_keeps_unvisited_rows(rng):
    s, args = _segment_args(rng)
    out = torch.full((64, 8), 7.0)
    args[7] = out
    kmod.scv_spmm_runs(*args, tile=16, accumulate=True)
    part = ref.scv_spmm_reference(
        s.tile_row, s.tile_col, s.rows, s.cols, s.vals, args[6],
        tile=16, n_rows=64, nnz_in_tile=s.nnz_in_tile,
    )
    torch.testing.assert_close(out, part + 7.0, rtol=0, atol=0)


@pytest.mark.parametrize("n_feat,tile,threads", [
    (128, 64, 128), (40, 64, 64), (7, 64, 32), (300, 64, 128), (128, 128, 128),
    (128, 512, 96),
])
def test_threads_for(n_feat, tile, threads):
    # the vector body keeps the full width and opts in where it must
    assert kmod.threads_for(n_feat, tile) == threads
    assert kmod.smem_bytes(tile, threads) <= kmod.SMEM_OPT_IN_BYTES


# The vector body's blocks that an SM's 228 KB of shared memory holds (a
# block's share rounded up to 128 bytes, and 1 KB reserved a block), at F =
# 128 unless said: the strip, D with the dense branch on, 4 KB of staged
# entries and 5 KB of headers.  A ring of asynchronous stages in place of
# the synchronous staging must hold no fewer.
@pytest.mark.parametrize("tile,dense,n_feat,least", [
    (32, False, 128, 8), (64, False, 128, 5), (128, False, 128, 3),
    (32, True, 128, 7), (64, True, 128, 3), (128, True, 128, 1), (64, True, 40, 5),
])
def test_ring_keeps_blocks_per_sm(tile, dense, n_feat, least):
    threads = kmod.threads_for(n_feat, tile, "vector", dense)
    smem = kmod.smem_bytes(tile, threads, "vector", dense)
    assert (228 * 1024) // (-(-smem // 128) * 128 + 1024) >= least


def test_smem_mirror_matches_the_source():
    """``smem_bytes`` counts the C layout from the module's constants: they
    are the source's."""
    import re
    from pathlib import Path

    src = (Path(kmod.__file__).with_name("csrc") / "scv_spmm.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert [const(n) for n in ("kEntries", "kHeaders", "kMaxSegments", "kPieces", "kStripPad",
                               "kDensePad", "kStages", "kQuads")] == [
        kmod.UNIT_ENTRIES, kmod.UNIT_HEADERS, kmod.MAX_SEGMENTS, kmod.SCALAR_PIECES,
        kmod.STRIP_PAD, kmod.DENSE_PAD, kmod.SCALAR_STAGES, kmod.SCALAR_QUADS]


def test_threads_for_refuses_oversized_tile():
    with pytest.raises(ValueError, match="shared memory"):
        kmod.threads_for(128, 2048)


def test_run_index_device_copy():
    ri = RunIndex.of(np.array([0, 0, 2], np.int32), np.array([1, 0, 3]), "cpu")
    assert ri.ptr.tolist() == [0, 2, 3] and ri.ptr.device.type == "cpu" and ri.max_nnz == 3


def test_package_exports_the_reference_names():
    """The kernel package exports the reference package's ``__all__``:
    ``scv_spmm`` is the op (it hides the launch-wrapper submodule of that
    name, which stays reachable by its full module name)."""
    import sys

    import repro.kernels.scv_spmm as jpkg
    import repro_torch.kernels.scv_spmm as tpkg

    assert tpkg.__all__ == jpkg.__all__
    assert tpkg.scv_spmm is ops.scv_spmm
    assert tpkg.scv_spmm_reference is ref.scv_spmm_reference
    assert tpkg.ensure_row_coverage is ops.ensure_row_coverage
    assert kmod is sys.modules["repro_torch.kernels.scv_spmm.scv_spmm"]
    assert callable(kmod.scv_spmm_runs) and callable(kmod.reset_counts)
