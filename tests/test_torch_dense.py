"""Kernel table rows 3 and 4 on the CPU: the SCV SpMM's dense-tile branch
(``_dense``, ``src/repro/kernels/scv_spmm/scv_spmm.py:169``) and its scalar
body (``_kernel_scalar``, :57), through the port's plain versions.

A small dense-block graph at T = 16 (dense threshold T^2/16 = 16) has tiles
of 5 to 200 entries and explicit duplicate coordinates.  The port's
``scv_spmm_plan`` (whose launch wrapper takes the plain versions for CPU
tensors, and applies the dense rule itself) is held against the
reference's ``scv_spmm_plan(..., interpret=True)``, which runs the Pallas
kernel's dense branch and scalar body in interpret mode as
``tests/test_scv_kernel.py`` does.  Integer-valued inputs must match bit
for bit; real-valued ones within rtol = atol = 1e-5 (the dense branch sums
D @ Z in another order than the gather does).  The CUDA kernels run in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import COOMatrix as JCOO
from repro.core.scv import coo_to_scv_tiles as j_tiles
from repro.core.scv import plan_from_tiles as j_plan
from repro.core.scv import plan_from_tiles_bucketed as j_bucketed
from repro.kernels.scv_spmm import ops as jops
from repro_torch.core.formats import COOMatrix
from repro_torch.core.scv import (
    coo_to_scv_tiles, dense_tile_threshold, plan_from_tiles, plan_from_tiles_bucketed,
)
from repro_torch.kernels.scv_spmm import ops, ref
from repro_torch.kernels.scv_spmm import scv_spmm as kmod
from repro_torch.simul.datasets import powerlaw_edges

T = 16
N = 64
CAPS = (8, 32, 256)  # cap 8 never dense, 32 and 256 hold dense tiles at T = 16
# entries per 16 x 16 tile of the 4 x 4 grid: sparse tiles, tiles just over
# the threshold, and near-full ones (before the duplicates are added)
TILE_NNZ = [5, 12, 20, 40, 17, 200, 90, 16, 150, 30, 8, 60, 24, 120, 180, 3]


def dense_block_coo(rng, integer: bool):
    """COO arrays of the T = 16 dense-block graph, with ~10% of its entries
    repeated at the same coordinates (duplicates the kernel must sum)."""
    rows, cols = [], []
    for b, k in enumerate(TILE_NNZ):
        flat = rng.choice(T * T, size=k, replace=False)
        rows.append((b // 4) * T + flat // T)
        cols.append((b % 4) * T + flat % T)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    dup = rng.choice(rows.size, size=rows.size // 10, replace=False)
    rows = np.concatenate([rows, rows[dup]]).astype(np.int32)
    cols = np.concatenate([cols, cols[dup]]).astype(np.int32)
    vals = (rng.integers(1, 4, rows.size) if integer
            else rng.standard_normal(rows.size)).astype(np.float32)
    return rows, cols, vals


def plans(coo, layout):
    """The same plan in both packages: a single cap, or the bucket ladder."""
    rows, cols, vals = coo
    jc, tc = JCOO(rows, cols, vals, (N, N)), COOMatrix(rows, cols, vals, (N, N))
    if layout == "single":
        return j_plan(j_tiles(jc, T, cap=256)), plan_from_tiles(coo_to_scv_tiles(tc, T, cap=256))
    return (j_bucketed(j_tiles(jc, T, cap=CAPS[-1]), CAPS),
            plan_from_tiles_bucketed(coo_to_scv_tiles(tc, T, cap=CAPS[-1]), CAPS))


def features(rng, f, integer):
    if integer:
        return rng.integers(-4, 5, (N, f)).astype(np.float32)
    return rng.standard_normal((N, f)).astype(np.float32)


def assert_match(got, want, integer):
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_graph_has_dense_tiles_and_duplicates(rng):
    rows, cols, _ = dense_block_coo(rng, True)
    key = rows.astype(np.int64) * N + cols
    assert np.unique(key).size < key.size  # duplicates present
    _, tp = plans((rows, cols, np.ones_like(rows, np.float32)), "buckets")
    thr = dense_tile_threshold(T)
    assert thr == 16
    dense = [int((s.nnz_in_tile > thr).sum()) for s in tp.segments]
    sparse = [int(((s.nnz_in_tile > 0) & (s.nnz_in_tile <= thr)).sum()) for s in tp.segments]
    assert dense[0] == 0 and dense[1] > 0 and dense[2] > 0
    assert sum(sparse) > 0


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("layout", ["single", "buckets"])
@pytest.mark.parametrize("threshold", [None, -1, 5, 256])
def test_vector_body_matches_reference_dense_branch(rng, integer, layout, threshold):
    """None: the reference's T^2/16; -1: the branch off; 5: nearly every
    tile dense; 256 (>= every cap): the branch compiled out."""
    coo = dense_block_coo(rng, integer)
    jp, tp = plans(coo, layout)
    z = features(rng, 12, integer)
    want = np.asarray(jops.scv_spmm_plan(jp, jnp.asarray(z), interpret=True, feature_block=8,
                                         dense_threshold=threshold))
    got = ops.scv_spmm_plan(tp, torch.from_numpy(z), dense_threshold=threshold).numpy()
    plain = ref.scv_spmm_reference_plan(tp, torch.from_numpy(z), body="vector",
                                        dense_threshold=threshold).numpy()
    assert got.shape == want.shape == (N, 12)
    assert_match(got, want, integer)
    assert_match(plain, want, integer)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("layout", ["single", "buckets"])
def test_scalar_body_matches_reference_scalar_body(rng, integer, layout):
    coo = dense_block_coo(rng, integer)
    jp, tp = plans(coo, layout)
    z = features(rng, 12, integer)
    want = np.asarray(jops.scv_spmm_plan(jp, jnp.asarray(z), interpret=True, feature_block=8,
                                         body="scalar"))
    got = ops.scv_spmm_plan(tp, torch.from_numpy(z), body="scalar").numpy()
    assert_match(got, want, integer)
    # the scalar body and the vector body agree with each other too
    vec = ops.scv_spmm_plan(tp, torch.from_numpy(z)).numpy()
    assert_match(got, vec, integer)


@pytest.mark.parametrize("body", ["vector", "scalar"])
def test_loose_arrays_match_reference(rng, body):
    rows, cols, vals = dense_block_coo(rng, True)
    jt = j_tiles(JCOO(rows, cols, vals, (N, N)), T, cap=64)
    z = features(rng, 8, True)
    want = np.asarray(jops.scv_spmm(
        *(jnp.asarray(getattr(jt, k)) for k in ("tile_row", "tile_col", "rows", "cols", "vals")),
        jnp.asarray(z), tile=T, n_rows=N, nnz_in_tile=jnp.asarray(jt.nnz_in_tile),
        interpret=True, feature_block=8, body=body,
    ))
    got = ops.scv_spmm(
        *(torch.from_numpy(getattr(jt, k)) for k in ("tile_row", "tile_col", "rows", "cols", "vals")),
        torch.from_numpy(z), tile=T, n_rows=N, nnz_in_tile=torch.from_numpy(jt.nnz_in_tile),
        body=body,
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_dense_reference_sums_duplicates(rng):
    """Two tiles densified by hand: duplicates add, Z rows past z count 0."""
    rows = torch.tensor([[0, 0, 3, 1], [2, 2, 2, 0]], dtype=torch.int32)
    cols = torch.tensor([[1, 1, 2, 0], [3, 3, 3, 0]], dtype=torch.int32)
    vals = torch.tensor([[1.0, 2.0, 4.0, 9.0], [1.0, 1.0, 1.0, 0.0]])
    nnz = torch.tensor([3, 3], dtype=torch.int32)  # the 9.0 slot is padding
    z = torch.from_numpy(features(rng, 5, True))[:6]  # only 6 of the 8 column rows
    got = ref.scv_spmm_dense_reference(
        torch.tensor([0, 1], dtype=torch.int32), torch.tensor([0, 1], dtype=torch.int32),
        rows, cols, vals, z, tile=4, n_rows=8, nnz_in_tile=nnz)
    want = torch.zeros(8, 5)
    want[0] = 3.0 * z[1]
    want[3] = 4.0 * z[2]
    # tile 1 reads column block 1 (rows 4..7 of z); row 7 lies past z
    want[6] = 0.0
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    rows[1, :3] = 2
    cols[1, :3] = 1  # z row 5 exists
    got = ref.scv_spmm_dense_reference(
        torch.tensor([0, 1], dtype=torch.int32), torch.tensor([0, 1], dtype=torch.int32),
        rows, cols, vals, z, tile=4, n_rows=8, nnz_in_tile=nnz)
    want[6] = 3.0 * z[5]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("threshold,expect", [(-1, []), (0, [0, 1, 2]), (16, [1]), (40, [])])
def test_dense_rule(threshold, expect):
    nnz = torch.tensor([1, 40, 16, 0], dtype=torch.int32)
    assert ref.dense_tiles(nnz, threshold).nonzero().flatten().tolist() == expect


def test_bad_body_raises(rng):
    _, tp = plans(dense_block_coo(rng, True), "single")
    with pytest.raises(ValueError, match="unknown kernel body"):
        ops.scv_spmm_plan(tp, torch.zeros(N, 4), body="matrix")
    with pytest.raises(ValueError, match="unknown kernel body"):
        ref.scv_spmm_reference_plan(tp, torch.zeros(N, 4), body="matrix")


def test_cpu_path_counts_no_launch_of_any_body(rng):
    _, tp = plans(dense_block_coo(rng, True), "buckets")
    kmod.reset_counts()
    for body in ("vector", "scalar"):
        ops.scv_spmm_plan(tp, torch.ones(N, 4), body=body)
    assert (kmod.launches, kmod.dense_launches, kmod.scalar_launches) == (0, 0, 0)


def test_run_index_carries_max_nnz(rng):
    _, tp = plans(dense_block_coo(rng, True), "buckets")
    for s in tp.segments:
        want = int(s.nnz_in_tile.max()) if s.n_tiles else 0
        assert s.runs.max_nnz == want


def test_wrapper_refuses_tile_over_cap(rng):
    _, tp = plans(dense_block_coo(rng, True), "single")
    runs = dataclasses.replace(tp.runs, max_nnz=tp.cap + 1)
    out = torch.zeros(N, 4)
    with pytest.raises(ValueError, match="over the cap"):
        kmod.scv_spmm_runs(tp.tile_row, tp.tile_col, tp.nnz_in_tile, tp.rows, tp.cols,
                           tp.vals, torch.zeros(N, 4), out, runs, tile=T, accumulate=False)


@pytest.mark.parametrize("n_feat,tile,body,dense,threads,opt_in", [
    (128, 64, "vector", True, 128, True),  # strip + Z block 64 KB + 13 KB staged
    (40, 64, "vector", True, 64, False),
    (128, 128, "vector", True, 128, True),  # strip + Z block 128 KB: opt in
    (128, 128, "vector", False, 128, True),
    (128, 64, "vector", False, 128, False),  # strip 32 KB + 13 KB staged
    (128, 64, "scalar", False, 128, False),  # strip + 3 KB of staged entries
    (128, 128, "scalar", False, 64, False),
    (16, 32, "vector", True, 32, False),
])
def test_threads_for_counts_dense_and_staging_memory(n_feat, tile, body, dense, threads, opt_in):
    assert kmod.threads_for(n_feat, tile, body, dense) == threads
    smem = kmod.smem_bytes(tile, threads, body, dense)
    staged = 12 * kmod.SCALAR_STAGE if body == "scalar" else 16 * kmod.UNIT_ENTRIES
    assert smem >= tile * threads * 4 * (2 if dense else 1) + staged
    assert (smem > kmod.SMEM_BYTES) == opt_in
    assert smem <= kmod.SMEM_OPT_IN_BYTES


def test_powerlaw_edges_is_the_kernel_benchmarks_graph():
    import benchmarks.kernel_bench as kb

    want = kb.powerlaw_edges(300, 20_000, seed=3)
    got = powerlaw_edges(300, 20_000, seed=3)
    for k in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.shape == want.shape and got.rows.size == 20_000
