"""The SCV SpMM CUDA kernels against their plain versions, on the card:
the vector body (sparse branch, accumulate mode, dense-tile branch; runs
split into many work units, summed in a fixed order by the run's last
block), the scalar body (over work units too, with its entries staged by
asynchronous copies: split runs, accumulate mode, a cap and leaf storage
that are not 16-byte aligned, an all-zero run), the shared-memory opt-in
at T = 128, a refused launch, repeat launches giving the same bits,
gradients through a CUDA forward, plans placed on four slots of the
card by the sharding executor, the layouts the autotuner can pick (T =
32 and one-rung ladders) and its stage 2 timing the kernel chain, the
forward captured in a CUDA graph (against eager, bit for bit on
integers, and through the serving engine), every aggregation backend
against the SCV chain, the decoder LM (prefill and decode, caches
included) on the card against the same code on the CPU, and the
launcher's decode step captured in a CUDA graph against the eager one
(the SSM, the hybrid and a decoder LM, bit for bit), ``compressed_psum``
over four slots of the card against the CPU, and ``launch/train.py
--mesh prod`` (one data group and sixteen, run SPMD over every card, the
products split over the "model" positions) against ``--mesh none``.

Run on a machine with an H100 (the kernel is built for sm_90a):

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py

Without a CUDA device every test here skips: a CUDA kernel has no CPU or
interpret mode.  ``chip_smoke.py`` makes the same checks at full size.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.scv_spmm import ref
from repro_torch.kernels.scv_spmm.ops import cached_backward, chain_launches, scv_spmm_plan
from repro_torch.core import scv
from repro_torch.core.formats import COOMatrix
from repro_torch.core.scv import coo_to_scv_tiles, dense_tile_threshold, plan_from_tiles
from repro_torch.models.gnn import GNNConfig, build_graph, gnn_loss, init_gnn
from repro_torch.serve.graph_engine import assemble_batched_graph, plan_launches
from repro_torch.simul.datasets import gcn_normalize, powerlaw_edges, powerlaw_graph

kmod = importlib.import_module("repro_torch.kernels.scv_spmm.scv_spmm")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _composite(dev):
    adjs = [gcn_normalize(powerlaw_graph(n, 3 * n, seed=i))
            for i, n in enumerate([300, 900, 150, 600])]
    members = [build_graph(a, bucket_caps=(8, 32, 128), device="cpu") for a in adjs]
    return assemble_batched_graph(members, 64, 2048, with_edges=False, device=dev).graph.plan


@pytest.mark.parametrize("init", ["coverage", "zeros"])
@pytest.mark.parametrize("n_feat", [128, 40, 7])
def test_kernel_bit_exact_on_integers(dev, init, n_feat):
    plan = _composite(dev)
    gen = torch.Generator().manual_seed(n_feat)
    plan = dataclasses.replace(plan, segments=tuple(
        dataclasses.replace(s, vals=torch.randint(-4, 5, tuple(s.vals.shape),
                                                  generator=gen).float().to(dev))
        for s in plan.segments))
    z = torch.randint(-4, 5, (plan.shape[1], n_feat), generator=gen).float().to(dev)
    before = kmod.launches
    got = scv_spmm_plan(plan, z, init=init)
    torch.cuda.synchronize()
    assert kmod.launches - before == plan_launches(plan)
    assert torch.equal(got, ref.scv_spmm_reference_plan(plan, z))


def test_kernel_close_on_normalised_values(dev):
    plan = _composite(dev)
    z = torch.randn((plan.shape[1], 128), generator=torch.Generator().manual_seed(1)).to(dev)
    got = scv_spmm_plan(plan, z)
    want = ref.scv_spmm_reference_plan(plan, z)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_wrapper_refuses_mixed_devices(dev):
    plan = _composite(dev)
    s = plan.segments[0]
    z = torch.zeros((plan.shape[1], 8))  # on the host, plan on the card
    out = torch.empty((plan.padded_shape[0], 8), device=dev)
    with pytest.raises(ValueError, match="is on"):
        kmod.scv_spmm_runs(s.tile_row, s.tile_col, s.nnz_in_tile, s.rows, s.cols,
                           s.vals, z, out, s.runs, tile=s.tile, accumulate=False)


def test_accumulate_keeps_unvisited_rows(dev):
    plan = _composite(dev)
    s = plan.segments[-1]
    z = torch.ones((plan.shape[1], 16), device=dev)
    out = torch.full((plan.padded_shape[0], 16), 3.0, device=dev)
    kmod.scv_spmm_runs(s.tile_row, s.tile_col, s.nnz_in_tile, s.rows, s.cols, s.vals,
                       z, out, s.runs, tile=s.tile, accumulate=True)
    part = ref.scv_spmm_reference(s.tile_row, s.tile_col, s.rows, s.cols, s.vals, z,
                                  tile=s.tile, n_rows=out.shape[0], nnz_in_tile=s.nnz_in_tile)
    torch.testing.assert_close(out, part + 3.0, rtol=1e-6, atol=1e-6)
    visited = np.zeros(plan.n_row_blocks, bool)
    visited[s.runs.rows] = True
    assert visited.any()


def _dense_block(dev, tile, scalar=False):
    """A dense-block graph (integer weights 1-3, so every sum is exact):
    at T = 64 every tile holds ~900 entries, over the threshold of 256;
    at T = 128 ~3,700, over 1,024.  ``scalar``: the single-cap plan the
    reference's kernel benchmark runs its scalar body on."""
    adj = powerlaw_edges(512, 60_000, seed=1)
    if scalar:
        caps = build_graph(adj, tile=tile, bucket_caps="auto", device="cpu").plan.caps
        return plan_from_tiles(coo_to_scv_tiles(adj, tile, cap=caps[-1]), with_perm=False,
                               device=dev)
    return build_graph(adj, tile=tile, bucket_caps="auto", with_edges=False, device=dev).plan


@pytest.mark.parametrize("tile", [64, 128])  # 128: D alone is 64 KB, the kernel opts in
@pytest.mark.parametrize("n_feat", [128, 40])
def test_dense_branch_bit_exact_on_integers(dev, tile, n_feat):
    plan = _dense_block(dev, tile)
    thr = dense_tile_threshold(tile)
    assert any(int((s.nnz_in_tile > thr).sum()) for s in plan.segments)
    z = torch.randint(-4, 5, (plan.shape[1], n_feat),
                      generator=torch.Generator().manual_seed(tile)).float().to(dev)
    kmod.reset_counts()
    got = scv_spmm_plan(plan, z)
    torch.cuda.synchronize()
    assert kmod.dense_launches > 0 and kmod.launches == plan_launches(plan)
    assert torch.equal(got, ref.scv_spmm_reference_plan(plan, z, body="vector"))
    # the same chain with the branch off takes the gather path: same bits
    assert torch.equal(scv_spmm_plan(plan, z, dense_threshold=-1), got)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("n_feat", [128, 40])
def test_scalar_body_bit_exact_on_integers(dev, tile, n_feat):
    plan = _dense_block(dev, tile, scalar=True)
    z = torch.randint(-4, 5, (plan.shape[1], n_feat),
                      generator=torch.Generator().manual_seed(n_feat)).float().to(dev)
    kmod.reset_counts()
    got = scv_spmm_plan(plan, z, body="scalar")
    torch.cuda.synchronize()
    assert (kmod.scalar_launches, kmod.launches) == (1, 0)
    assert torch.equal(got, ref.scv_spmm_reference_plan(plan, z, body="scalar"))


def test_refused_launch_raises(dev, monkeypatch):
    plan = _dense_block(dev, 64)
    s = plan.segments[-1]
    z = torch.zeros((plan.shape[1], 16), device=dev)
    out = torch.zeros((plan.padded_shape[0], 16), device=dev)
    monkeypatch.setattr(kmod, "threads_for", lambda *a: 160)  # over the kernel's 128
    kmod.reset_counts()
    for body in ("vector", "scalar"):
        with pytest.raises(RuntimeError, match="launch failed"):
            kmod.scv_spmm_runs(s.tile_row, s.tile_col, s.nnz_in_tile, s.rows, s.cols, s.vals,
                               z, out, s.runs, tile=s.tile, accumulate=False, body=body)
    assert (kmod.launches, kmod.dense_launches, kmod.scalar_launches) == (0, 0, 0)


def test_cuda_forward_carries_gradients(dev):
    """A loss on a CUDA forward differentiates through every aggregation
    (the kernel's output has a grad_fn; the backward's dZ is one more chain
    of launches over the transposed plan, per layer), and each parameter's
    gradient matches plain autograd through the plain version on the card
    within 1e-4 of its largest magnitude (the two sum in other orders)."""
    adj = gcn_normalize(powerlaw_edges(512, 60_000, seed=2))
    g = build_graph(adj, bucket_caps="auto", with_edges=False, device=dev)
    cfg = GNNConfig(name="g", kind="gcn", d_in=32, d_hidden=64, n_classes=8)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((512, 32), np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 8, 512)).to(dev)
    mask = torch.ones(512, device=dev)
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
    flat = [p.requires_grad_(True) for ps in params.values() for p in ps.values()]
    kmod.reset_counts()
    gnn_loss(params, cfg, g, x, labels, mask).backward()
    plan_t = cached_backward(g.plan).plan_t
    assert kmod.launches == 2 * (plan_launches(g.plan) + plan_launches(plan_t))
    assert kmod.dense_launches > 0
    got = [p.grad.clone() for p in flat]
    assert params["layer0"]["w"].grad is not None

    h = x
    for i in range(cfg.n_layers):
        h = ref.scv_spmm_reference_plan(g.plan, h @ params[f"layer{i}"]["w"])[: g.n_nodes]
        if i + 1 < cfg.n_layers:
            h = torch.relu(h)
    logp = torch.log_softmax(h, -1)
    plain = torch.autograd.grad(-logp.gather(1, labels[:, None]).mean(), flat)
    for a, b in zip(got, plain):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def _ints(plan, seed):
    """``plan`` with integer values in -4..4 in every slot (exact sums)."""
    gen = torch.Generator().manual_seed(seed)
    return dataclasses.replace(plan, segments=tuple(
        dataclasses.replace(s, vals=torch.randint(-4, 5, tuple(s.vals.shape),
                                                  generator=gen).float().to(s.vals.device))
        for s in plan.segments))


def _hub(dev, tile):
    """A graph whose first block-row reaches every column block: its run
    holds n / T tiles, the rest of the graph is sparse."""
    rng = np.random.default_rng(tile)
    n = 4096
    r = np.concatenate([rng.integers(0, tile, 20_000), rng.integers(0, n, 8_000)])
    c = np.concatenate([rng.integers(0, n, 20_000), rng.integers(0, n, 8_000)])
    a = COOMatrix(r.astype(np.int32), c.astype(np.int32), np.ones(r.size, np.float32), (n, n))
    return build_graph(a, tile=tile, bucket_caps="auto", with_edges=False, device=dev).plan


def _split_units(plan) -> int:
    return sum(s.runs.n_split_units for s in plan.segments)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("n_feat", [128, 40])
def test_split_hub_run_bit_exact_on_integers(dev, monkeypatch, tile, n_feat):
    monkeypatch.setattr(scv, "UNIT_WORK", 96)
    plan = _ints(_hub(dev, tile), tile)
    hub_units = max(int(np.diff(s.runs.unit_ptr.cpu().numpy()).max()) for s in plan.segments
                    if s.n_tiles)
    assert hub_units >= 8, "want a run split into many units"
    z = torch.randint(-4, 5, (plan.shape[1], n_feat),
                      generator=torch.Generator().manual_seed(n_feat)).float().to(dev)
    kmod.reset_counts()
    for init in ("coverage", "zeros"):
        got = scv_spmm_plan(plan, z, init=init)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.scv_spmm_reference_plan(plan, z, body="vector"))
    assert kmod.launches == 2 * plan_launches(plan)


def test_accumulate_over_split_runs_keeps_unvisited_rows(dev, monkeypatch):
    monkeypatch.setattr(scv, "UNIT_WORK", 64)
    plan = _ints(_hub(dev, 64), 3)
    # a later segment: no coverage dummies, so it leaves block-rows unvisited
    s = max(plan.segments[1:], key=lambda s: s.runs.n_split_units)
    assert s.runs.n_split_units > 0
    z = torch.randint(-4, 5, (plan.shape[1], 40),
                      generator=torch.Generator().manual_seed(4)).float().to(dev)
    out = torch.full((plan.padded_shape[0], 40), 3.0, device=dev)
    kmod.scv_spmm_runs(s.tile_row, s.tile_col, s.nnz_in_tile, s.rows, s.cols, s.vals,
                       z, out, s.runs, tile=s.tile, accumulate=True)
    part = ref.scv_spmm_vector_reference(
        s.tile_row, s.tile_col, s.rows, s.cols, s.vals, z, tile=s.tile,
        n_rows=out.shape[0], nnz_in_tile=s.nnz_in_tile,
        dense_threshold=dense_tile_threshold(s.tile))
    assert torch.equal(out, part + 3.0)
    visited = np.zeros(plan.n_row_blocks, bool)
    visited[s.runs.rows] = True
    assert not visited.all()
    strips = out.view(plan.n_row_blocks, s.tile, 40)
    assert bool((strips[torch.from_numpy(~visited).to(dev)] == 3.0).all())


@pytest.mark.parametrize("tile", [64, 128])
def test_dense_tiles_inside_split_runs(dev, tile):
    plan = _ints(_dense_block(dev, tile), tile)
    thr = dense_tile_threshold(tile)
    split_dense = 0
    for s in plan.segments:
        units, up = s.runs.units.cpu().numpy(), s.runs.unit_ptr.cpu().numpy()
        nnz = s.nnz_in_tile.cpu().numpy()
        for b, e, run, _ in units:
            if up[run + 1] - up[run] > 1:
                split_dense += int((nnz[b:e] > thr).sum())
    assert split_dense > 0, "want dense tiles in split runs at the module's UNIT_WORK"
    z = torch.randint(-4, 5, (plan.shape[1], 128),
                      generator=torch.Generator().manual_seed(5)).float().to(dev)
    kmod.reset_counts()
    got = scv_spmm_plan(plan, z)
    torch.cuda.synchronize()
    assert kmod.dense_launches > 0
    assert torch.equal(got, ref.scv_spmm_reference_plan(plan, z, body="vector"))


@pytest.mark.parametrize("unit_work", [None, 16])
def test_padded_composite_bit_exact_on_integers(dev, monkeypatch, unit_work):
    if unit_work is not None:
        monkeypatch.setattr(scv, "UNIT_WORK", unit_work)
    plan = _ints(_composite(dev), 6)
    padded = 0
    for s in plan.segments:
        # the tile-count padding: the last run's trailing zero-nnz tiles
        last = int(s.runs.ptr[-2])
        tail = s.nnz_in_tile[last:].cpu().numpy()
        live_end = last + (np.flatnonzero(tail)[-1] + 1 if tail.any() else 0)
        padded += s.n_tiles - live_end
        assert int(s.runs.units[:, 1].max()) <= live_end  # the padding lies in no unit
    assert padded > 0
    z = torch.randint(-4, 5, (plan.shape[1], 128),
                      generator=torch.Generator().manual_seed(7)).float().to(dev)
    assert torch.equal(scv_spmm_plan(plan, z), ref.scv_spmm_reference_plan(plan, z))


def test_back_to_back_launches_give_identical_bits(dev, monkeypatch):
    """Real-valued inputs, where the order of summation shows in the bits:
    two chains over split runs agree bit for bit, and every split run's
    counter is back at 0 after each (the last block resets it)."""
    monkeypatch.setattr(scv, "UNIT_WORK", 64)
    plan = _hub(dev, 64)
    assert _split_units(plan) > 0
    z = torch.randn((plan.shape[1], 128), generator=torch.Generator().manual_seed(8)).to(dev)
    first = scv_spmm_plan(plan, z)
    second = scv_spmm_plan(plan, z)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    chain = scv.cached_plan_runs(tuple(s.runs for s in plan.segments))
    assert chain is not None and chain.n_split_units > 0 and chain._counters
    for c in chain._counters.values():  # the one launch's split runs
        assert not bool(c.any())
    want = ref.scv_spmm_reference_plan(plan, z)
    assert (first - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# ---------------------------------------------------------------------------
# one launch a chain; the dense branch on the tensor cores (3xTF32)
# ---------------------------------------------------------------------------
def _chain(plan):
    return scv.plan_runs(tuple(s.runs for s in plan.segments))


def _mixed(dev, tile, normalise=False, caps=None):
    """Eight block-rows, each with one dense tile on the diagonal (T²/4
    entries, over the threshold of T²/16) among sparse tiles (random
    entries, some landing on the dense tiles as duplicates); ladder (8, 32,
    T²/2), so the dense tiles lie in the last segment, or ``caps``.
    Integer weights 1-3, or GCN-normalised ones."""
    rng = np.random.default_rng(tile)
    n = 8 * tile
    rows, cols = [rng.integers(0, n, 2 * n)], [rng.integers(0, n, 2 * n)]
    for b in range(8):
        slot = rng.choice(tile * tile, tile * tile // 4, replace=False)
        rows.append(b * tile + slot // tile)
        cols.append(b * tile + slot % tile)
    r, c = np.concatenate(rows).astype(np.int32), np.concatenate(cols).astype(np.int32)
    adj = COOMatrix(r, c, rng.integers(1, 4, r.size).astype(np.float32), (n, n))
    if normalise:
        adj = gcn_normalize(adj)
    return build_graph(adj, tile=tile, bucket_caps=caps or (8, 32, tile * tile // 2),
                       with_edges=False, device=dev).plan


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("n_feat", [128, 40, 3])
@pytest.mark.parametrize("init", ["coverage", "zeros"])
def test_chain_in_one_launch_bit_exact_on_integers(dev, monkeypatch, tile, n_feat, init):
    """A dense-block graph whose dense tiles lie in a later segment, its
    runs cut across segments into many units: one launch, dense, equal to
    the plain chain and to the plain model of the kernel's sums bit for bit
    on integers."""
    monkeypatch.setattr(scv, "UNIT_WORK", 4 * tile)
    plan = _ints(_mixed(dev, tile), tile + n_feat)
    thr = dense_tile_threshold(tile)
    assert plan.segments[0].runs.max_nnz <= thr < plan.segments[-1].runs.max_nnz
    chain = _chain(plan)
    pieces = chain.pieces.cpu().numpy()
    units = chain.units.cpu().numpy()
    assert chain.n_split_units > 0
    assert any(len(set(pieces[b:e, 0])) > 1 for b, e, _, _ in units), "a unit across segments"
    z = torch.randint(-4, 5, (plan.shape[1], n_feat),
                      generator=torch.Generator().manual_seed(tile)).float().to(dev)
    kmod.reset_counts()
    got = scv_spmm_plan(plan, z, init=init)
    torch.cuda.synchronize()
    assert (kmod.launches, kmod.dense_launches) == (1, 1) == (plan_launches(plan),) * 2
    want = ref.scv_spmm_reference_plan(plan, z, body="vector")
    assert torch.equal(got, want)
    model = ref.scv_spmm_chain_units_reference(
        plan.segments, [s.vals for s in plan.segments], z, chain, torch.zeros_like(want),
        accumulate=init == "zeros", dense_threshold=thr)
    assert torch.equal(got, model)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("n_feat", [128, 40, 3])
def test_chain_close_on_normalised_values(dev, tile, n_feat):
    """Normalised values and normal Z: the 3xTF32 products and the sums of
    the one launch within 1e-5 of the plain chain's largest magnitude."""
    plan = _dense_block(dev, tile)
    z = torch.randn((plan.shape[1], n_feat), generator=torch.Generator().manual_seed(3)).to(dev)
    got = scv_spmm_plan(plan, z)
    want = ref.scv_spmm_reference_plan(plan, z, body="vector")
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("tile", [64, 128])
def test_chain_repeat_launches_same_bits(dev, monkeypatch, tile):
    """Real values, dense tiles in split runs: two launches of the chain
    give the same bits, and the split runs' counters are back at 0."""
    monkeypatch.setattr(scv, "UNIT_WORK", 2 * tile)
    plan = _mixed(dev, tile, normalise=True)
    z = torch.randn((plan.shape[1], 128), generator=torch.Generator().manual_seed(9)).to(dev)
    first, second = scv_spmm_plan(plan, z), scv_spmm_plan(plan, z)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    chain = _chain(plan)
    assert chain.n_split_units > 0
    assert all(not bool(c.any()) for c in chain._counters.values())


@pytest.mark.parametrize("tile", [64, 128])
def test_dense_tiles_in_any_entry_order(dev, tile):
    """Each tile's live entries shuffled out of the plans' (column, row)
    order, duplicates apart: D is then built by the staged path (equal keys
    found within a warp), still bit for bit with the plain chain on
    integers and the same bits twice."""
    plan = _ints(_mixed(dev, tile), 2 * tile)
    rng = np.random.default_rng(tile)

    def shuffled(s):
        rows, cols, vals = (a.cpu().numpy().copy() for a in (s.rows, s.cols, s.vals))
        for t, n in enumerate(s.nnz_in_tile.cpu().numpy()):
            p = rng.permutation(int(n))
            rows[t, :n], cols[t, :n], vals[t, :n] = rows[t, p], cols[t, p], vals[t, p]
        return dataclasses.replace(s, rows=torch.from_numpy(rows).to(dev),
                                   cols=torch.from_numpy(cols).to(dev),
                                   vals=torch.from_numpy(vals).to(dev))
    plan = dataclasses.replace(plan, segments=tuple(shuffled(s) for s in plan.segments))
    z = torch.randint(-4, 5, (plan.shape[1], 40),
                      generator=torch.Generator().manual_seed(tile)).float().to(dev)
    kmod.reset_counts()
    first, second = scv_spmm_plan(plan, z), scv_spmm_plan(plan, z)
    torch.cuda.synchronize()
    assert kmod.dense_launches == 2
    assert torch.equal(first, ref.scv_spmm_reference_plan(plan, z, body="vector"))
    assert torch.equal(first, second)
    zr = torch.randn((plan.shape[1], 40), generator=torch.Generator().manual_seed(1)).to(dev)
    a, b = scv_spmm_plan(plan, zr), scv_spmm_plan(plan, zr)
    assert torch.equal(a, b)


@pytest.mark.parametrize("tile", [64, 128])
def test_dense_tile_duplicate_runs(dev, tile):
    """Dense tiles whose entries repeat positions in runs of 1 to 70, runs
    crossing the 32-entry steps in which a warp reads them: each run summed
    once into D, bit for bit with the plain chain on integers, within 1e-5
    otherwise, the same bits twice."""
    rng = np.random.default_rng(3 * tile)
    n = 4 * tile
    pos = rng.choice(tile * tile, tile * tile // 8, replace=False)
    reps = rng.integers(1, 71, pos.size)
    rows, cols = [], []
    for b in range(4):
        rows.append(b * tile + np.repeat(pos // tile, reps))
        cols.append(b * tile + np.repeat(pos % tile, reps))
    r, c = np.concatenate(rows).astype(np.int32), np.concatenate(cols).astype(np.int32)
    cap = 1 << int(np.ceil(np.log2(reps.sum())))
    for integer in (True, False):
        vals = (rng.integers(-4, 5, r.size) if integer else rng.standard_normal(r.size))
        adj = COOMatrix(r, c, vals.astype(np.float32), (n, n))
        plan = build_graph(adj, tile=tile, bucket_caps=(8, cap), with_edges=False,
                           device=dev).plan
        assert plan.segments[-1].runs.max_nnz > dense_tile_threshold(tile)
        z = (torch.randint(-4, 5, (n, 40), generator=torch.Generator().manual_seed(tile)).float()
             if integer else torch.randn((n, 40), generator=torch.Generator().manual_seed(1)))
        z = z.to(dev)
        got, again = scv_spmm_plan(plan, z), scv_spmm_plan(plan, z)
        want = ref.scv_spmm_reference_plan(plan, z, body="vector")
        assert torch.equal(got, again)
        if integer:
            assert torch.equal(got, want)
        else:
            assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_captured_dense_chain_equals_eager(dev):
    """The captured forward over a dense-block graph (dense tiles in a later
    segment, the plan-level tables padded) equals eager bit for bit on
    integers, and counts one dense launch a layer at replay."""
    from repro_torch.models.gnn import CapturedForward, Graph, gnn_forward

    g = Graph(n_nodes=512, plan=_ints(_mixed(dev, 64), 11))
    cfg = GNNConfig(name="gcn", kind="gcn", d_in=16, d_hidden=32, n_classes=4)
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
    x = torch.randint(-2, 3, (512, cfg.d_in), generator=torch.Generator().manual_seed(2)).float()
    x = x.to(dev)
    fwd = CapturedForward()
    with torch.inference_mode():
        want = gnn_forward(params, cfg, g, x)
        for _ in range(2):
            kmod.reset_counts()
            got = fwd(params, cfg, g, x)
            torch.cuda.synchronize()
            assert (kmod.launches, kmod.dense_launches) == (cfg.n_layers, cfg.n_layers)
            assert torch.equal(got, want)
    assert (fwd.captures, fwd.replays) == (1, 1)


# ---------------------------------------------------------------------------
# the staging of the vector body's sparse walk: the cases any staging of a
# unit's headers and live entry slices (synchronous, or a ring of
# asynchronous stages) must get right
# ---------------------------------------------------------------------------
def _unit_entries(plan) -> int:
    """The most live entries one work unit of ``plan``'s chain holds (host)."""
    chain = _chain(plan)
    pieces = chain.pieces.cpu().numpy()
    nnz = [s.nnz_in_tile.cpu().numpy() for s in plan.segments]
    return max(sum(int(nnz[k][b:e].sum()) for k, b, e, _ in pieces[u0:u1])
               for u0, u1, _, _ in chain.units.cpu().numpy())


def _with_zero_tiles(plan, seed):
    """``plan`` with the entries of about 40% of its tiles dropped (nnz 0),
    run indexes rebuilt: zero-nnz tiles between live ones."""
    rng = np.random.default_rng(seed)
    segs = []
    for s in plan.segments:
        nnz = s.nnz_in_tile.cpu().numpy().copy()
        nnz[rng.random(nnz.size) < 0.4] = 0
        segs.append(dataclasses.replace(
            s, nnz_in_tile=torch.from_numpy(nnz).to(s.vals.device),
            runs=scv.RunIndex.of(s.tile_row.cpu().numpy(), nnz, s.vals.device)))
    return dataclasses.replace(plan, segments=tuple(segs))


def _ring_case(dev, monkeypatch, case):
    """A plan whose one vector launch makes the staging take ``case``."""
    adj = gcn_normalize(powerlaw_graph(8192, 60_000, seed=5))
    if case == "many stages":  # whole block-rows as units: many stagings of entries each
        monkeypatch.setattr(scv, "UNIT_WORK", 1 << 16)
        plan = build_graph(adj, bucket_caps=(8, 32, 128), with_edges=False, device=dev).plan
        assert _unit_entries(plan) > 4 * kmod.UNIT_ENTRIES
        return plan
    if case == "caps 5 and 37":  # slices start at slots of every 16-byte phase
        return build_graph(adj, bucket_caps=(5, 37), with_edges=False, device=dev).plan
    if case.startswith("misaligned"):  # rows, cols, vals 1, 2, 3 words past 16 bytes, or all 3
        words = (1, 2, 3) if case == "misaligned 1-3" else (3, 3, 3)
        plan = build_graph(adj, bucket_caps=(37,), with_edges=False, device=dev).plan
        return dataclasses.replace(plan, segments=tuple(dataclasses.replace(
            s, rows=_misaligned(s.rows, words[0]), cols=_misaligned(s.cols, words[1]),
            vals=_misaligned(s.vals, words[2])) for s in plan.segments))
    if case == "zero tiles":
        return _with_zero_tiles(build_graph(adj, bucket_caps=(8, 32, 128), with_edges=False,
                                            device=dev).plan, 6)
    if case == "split runs":
        monkeypatch.setattr(scv, "UNIT_WORK", 96)
        plan = _hub(dev, 64)
        assert _split_units(plan) > 0
        return plan
    assert case == "dense and sparse in one window"  # the dense build, one segment
    plan = _mixed(dev, 64, caps=(64 * 64 // 2,))
    s = plan.segments[0]
    nnz, rows = s.nnz_in_tile.cpu().numpy(), s.tile_row.cpu().numpy()
    dense = nnz > dense_tile_threshold(64)
    assert all(dense[rows == r].any() and ((nnz > 0) & ~dense)[rows == r].any()
               for r in np.unique(rows[dense]))
    return plan


RING_CASES = ["many stages", "caps 5 and 37", "misaligned 1-3", "misaligned 3-3-3",
              "zero tiles", "split runs", "dense and sparse in one window"]


@pytest.mark.parametrize("case", RING_CASES)
@pytest.mark.parametrize("n_feat", [128, 40])
def test_ring_bit_exact_on_integers(dev, monkeypatch, case, n_feat):
    """Each case the staging must get right, bit for bit with the plain
    chain on integers, eagerly and over the padded grid of a captured
    launch (the run index loaded into tables sized from the shapes)."""
    plan = _ints(_ring_case(dev, monkeypatch, case), n_feat)
    z = torch.randint(-4, 5, (plan.shape[1], n_feat),
                      generator=torch.Generator().manual_seed(n_feat)).float().to(dev)
    want = ref.scv_spmm_reference_plan(plan, z, body="vector")
    kmod.reset_counts()
    got = scv_spmm_plan(plan, z)
    torch.cuda.synchronize()
    assert kmod.launches == plan_launches(plan) == 1
    assert kmod.dense_launches == kmod.launch_counts("vector", dense_tile_threshold(64),
                                                     _chain(plan))[1]
    assert kmod.dense_launches or case != "dense and sparse in one window"
    assert torch.equal(got, want)
    segs = plan.segments
    padded = scv.PlanRuns.padded([(s.n_tiles, s.cap) for s in segs], plan.n_row_blocks, dev)
    padded.load(_chain(plan))
    assert padded.n_units > _chain(plan).n_units
    out = torch.zeros_like(want)
    kmod.scv_spmm_chain(segs, [s.vals for s in segs], z, out, accumulate=False, runs=padded)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("case", ["many stages", "misaligned 3-3-3", "split runs",
                                  "dense and sparse in one window"])
def test_ring_repeat_launches_same_bits(dev, monkeypatch, case):
    """Real values: two launches give the same bits, within 1e-5 of the
    plain chain's largest magnitude."""
    plan = _ring_case(dev, monkeypatch, case)
    z = torch.randn((plan.shape[1], 128), generator=torch.Generator().manual_seed(2)).to(dev)
    first, second = scv_spmm_plan(plan, z), scv_spmm_plan(plan, z)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    want = ref.scv_spmm_reference_plan(plan, z, body="vector")
    assert (first - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_ring_keeps_blocks_per_sm(dev):
    """The built kernel holds 4 blocks an SM at T = 64, F = 128 with the
    dense branch off, and no fewer than its shared memory allows elsewhere."""
    assert kmod.blocks_per_sm(64, 128, False) == 4
    for tile, n_feat, dense, least in ((64, 128, True, 3), (64, 40, True, 5),
                                       (128, 128, False, 3), (128, 128, True, 1)):
        assert kmod.blocks_per_sm(tile, n_feat, dense) >= least


# ---------------------------------------------------------------------------
# the scalar body over work units
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("n_feat", [128, 40])
def test_scalar_body_split_runs_bit_exact_on_integers(dev, monkeypatch, tile, n_feat):
    monkeypatch.setattr(scv, "UNIT_WORK", 96)
    plan = _ints(_hub(dev, tile), tile + 1)
    hub_units = max(int(np.diff(s.runs.unit_ptr.cpu().numpy()).max()) for s in plan.segments
                    if s.n_tiles)
    assert hub_units >= 8, "want a run split into many units"
    z = torch.randint(-4, 5, (plan.shape[1], n_feat),
                      generator=torch.Generator().manual_seed(n_feat)).float().to(dev)
    kmod.reset_counts()
    for init in ("coverage", "zeros"):
        got = scv_spmm_plan(plan, z, init=init, body="scalar")
        torch.cuda.synchronize()
        assert torch.equal(got, ref.scv_spmm_reference_plan(plan, z, body="scalar"))
    # the scalar body: one launch a segment with tiles
    assert (kmod.scalar_launches, kmod.launches) == (2 * chain_launches(plan, "scalar"), 0)


def test_scalar_accumulate_over_split_runs_keeps_unvisited_rows(dev, monkeypatch):
    monkeypatch.setattr(scv, "UNIT_WORK", 64)
    plan = _ints(_hub(dev, 64), 9)
    s = max(plan.segments[1:], key=lambda s: s.runs.n_split_units)
    assert s.runs.n_split_units > 0
    z = torch.randint(-4, 5, (plan.shape[1], 40),
                      generator=torch.Generator().manual_seed(10)).float().to(dev)
    out = torch.full((plan.padded_shape[0], 40), 3.0, device=dev)
    kmod.scv_spmm_runs(s.tile_row, s.tile_col, s.nnz_in_tile, s.rows, s.cols, s.vals,
                       z, out, s.runs, tile=s.tile, accumulate=True, body="scalar")
    part = ref.scv_spmm_reference(s.tile_row, s.tile_col, s.rows, s.cols, s.vals, z,
                                  tile=s.tile, n_rows=out.shape[0], nnz_in_tile=s.nnz_in_tile)
    assert torch.equal(out, part + 3.0)
    visited = np.zeros(plan.n_row_blocks, bool)
    visited[s.runs.rows] = True
    assert not visited.all()


def _misaligned(t: torch.Tensor, words: int) -> torch.Tensor:
    """A contiguous copy of ``t`` whose storage starts ``4 * words`` bytes
    past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    start = (words - flat.data_ptr() // 4) % 4 + 4
    out = flat[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4 * words
    return out


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n_feat", [128, 40])
def test_scalar_body_unaligned_cap_bit_exact_on_integers(dev, monkeypatch, aligned, n_feat):
    """Cap 37: a tile's entries start at slots of every 16-byte phase, so
    the staging copies an unaligned head and tail.  ``aligned=False``: the
    rows, cols and vals also start 4, 8 and 12 bytes past a 16-byte
    boundary, so no 16-byte copy serves all three.  At UNIT_WORK 2,048 a
    unit holds ~50 tiles, and its chunks end inside a tile."""
    adj = powerlaw_edges(512, 60_000, seed=3)
    plan = plan_from_tiles(coo_to_scv_tiles(adj, 64, cap=37), with_perm=False, device=dev)
    plan = dataclasses.replace(plan, vals=torch.randint(
        -4, 5, tuple(plan.vals.shape), generator=torch.Generator().manual_seed(11)).float().to(dev))
    if not aligned:
        plan = dataclasses.replace(plan, rows=_misaligned(plan.rows, 1),
                                   cols=_misaligned(plan.cols, 2),
                                   vals=_misaligned(plan.vals, 3))
    assert plan.runs.n_split_units > 0
    z = torch.randint(-4, 5, (plan.shape[1], n_feat),
                      generator=torch.Generator().manual_seed(12)).float().to(dev)
    kmod.reset_counts()
    got = scv_spmm_plan(plan, z, body="scalar")
    torch.cuda.synchronize()
    assert kmod.scalar_launches == 1
    assert torch.equal(got, ref.scv_spmm_reference_plan(plan, z, body="scalar"))


def test_scalar_body_all_zero_run(dev):
    """Block-rows no entry visits get coverage dummies: runs of one empty
    unit, whose strips the launch still writes (zeros)."""
    rng = np.random.default_rng(13)
    r = rng.integers(0, 128, 5_000)  # block-rows 0 and 1 of 8 at T = 64
    c = rng.integers(0, 512, 5_000)
    a = COOMatrix(r.astype(np.int32), c.astype(np.int32),
                  rng.integers(1, 4, 5_000).astype(np.float32), (512, 512))
    plan = plan_from_tiles(coo_to_scv_tiles(a, 64), with_perm=False, device=dev)
    units, up = plan.runs.units.cpu().numpy(), plan.runs.unit_ptr.cpu().numpy()
    empty = [r for r in range(plan.runs.n_runs)
             if up[r + 1] - up[r] == 1 and units[up[r], 0] == units[up[r], 1]]
    assert len(empty) == 6
    z = torch.randint(-4, 5, (512, 40), generator=torch.Generator().manual_seed(14)).float().to(dev)
    got = scv_spmm_plan(plan, z, body="scalar")
    assert torch.equal(got, ref.scv_spmm_reference_plan(plan, z, body="scalar"))
    assert not bool(got[128:].any())


def test_scalar_body_repeat_launches_give_identical_bits(dev, monkeypatch):
    """Real-valued inputs over split runs: two scalar-body chains agree bit
    for bit, and every split run's counter is back at 0 after each."""
    monkeypatch.setattr(scv, "UNIT_WORK", 64)
    plan = _hub(dev, 64)
    assert _split_units(plan) > 0
    z = torch.randn((plan.shape[1], 128), generator=torch.Generator().manual_seed(15)).to(dev)
    first = scv_spmm_plan(plan, z, body="scalar")
    second = scv_spmm_plan(plan, z, body="scalar")
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    for s in plan.segments:
        for c in s.runs._counters.values():
            assert not bool(c.any())
    want = ref.scv_spmm_reference_plan(plan, z, body="scalar")
    assert (first - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# ---------------------------------------------------------------------------
# plans patched on the card by stream.apply_delta
# ---------------------------------------------------------------------------
def _perm_ints(plan):
    """Integer values from each slot's source id: a patched plan and its
    rebuild get the same values."""
    return dataclasses.replace(plan, segments=tuple(
        dataclasses.replace(s, vals=torch.where(s.perm >= 0, (s.perm % 9 - 4).float(),
                                                torch.zeros((), device=s.device)))
        for s in plan.segments))


def _tile_inserts(adj, tile, k):
    """``k`` absent coordinates inside the tile of entry 0."""
    have = set(zip(adj.rows.tolist(), adj.cols.tolist()))
    r0, c0 = int(adj.rows[0]) // tile * tile, int(adj.cols[0]) // tile * tile
    free = [(r, c) for r in range(r0, min(r0 + tile, adj.shape[0]))
            for c in range(c0, min(c0 + tile, adj.shape[1])) if (r, c) not in have]
    return free[:k]


@pytest.mark.parametrize("kind", ["value update", "tile births", "net shrink"])
def test_plan_patched_on_card_equals_rebuild(dev, kind):
    from repro_torch.core.validate import run_index_diff, validate_plan
    from repro_torch.stream import DeltaBatch, apply_coo, apply_delta

    adj = gcn_normalize(powerlaw_graph(3000, 15000, seed=4))
    rng = np.random.default_rng(5)
    idx = rng.choice(adj.nnz, 40, replace=False)
    coords = [(int(adj.rows[i]), int(adj.cols[i])) for i in idx]
    if kind == "value update":
        d = DeltaBatch.of(inserts=[(r, c, 0.25) for r, c in coords], removes=coords)
    elif kind == "tile births":
        d = DeltaBatch.of(inserts=[(2999 - i, 7 * i, 0.5) for i in range(40)
                                   if not ((adj.rows == 2999 - i) & (adj.cols == 7 * i)).any()])
    else:
        d = DeltaBatch.of(inserts=[(r, c, 0.5) for r, c in _tile_inserts(adj, 64, 5)],
                          removes=coords)
    g = build_graph(adj, bucket_caps=(8, 32, 128), device=dev)
    patched = apply_delta(g, d)
    final = apply_coo(adj, d)
    rebuilt = build_graph(final, bucket_caps=(8, 32, 128), device=dev)
    for a, b in zip(patched.plan.segments, rebuilt.plan.segments):
        for f in ("tile_row", "tile_col", "rows", "cols", "vals", "nnz_in_tile", "perm"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.device.type == "cuda" and x.dtype == y.dtype and torch.equal(x, y), f
        assert run_index_diff(a.runs, b.runs) == ()
        assert a.runs.units.device.type == "cuda"
    assert validate_plan(patched, coo=final).ok
    z = torch.randint(-4, 5, (3000, 64), generator=torch.Generator().manual_seed(2)).float().to(dev)
    got = scv_spmm_plan(_perm_ints(patched.plan), z)
    assert torch.equal(got, scv_spmm_plan(_perm_ints(rebuilt.plan), z))
    assert torch.equal(got, ref.scv_spmm_reference_plan(_perm_ints(rebuilt.plan), z))


def test_patched_tile_takes_the_dense_branch(dev):
    from repro_torch.stream import DeltaBatch, apply_coo, apply_delta

    adj = gcn_normalize(powerlaw_graph(2000, 8000, seed=6))
    ladder = (8, 32, 128, 512)  # a rung above T^2/16 = 256
    g = build_graph(adj, bucket_caps=ladder, device=dev)
    z = torch.randint(-4, 5, (2000, 32), generator=torch.Generator().manual_seed(3)).float().to(dev)
    kmod.reset_counts()
    scv_spmm_plan(_perm_ints(g.plan), z)
    torch.cuda.synchronize()
    assert kmod.dense_launches == 0
    d = DeltaBatch.of(inserts=[(r, c, 1.0) for r, c in _tile_inserts(adj, 64, 300)])
    patched = apply_delta(g, d)
    rebuilt = build_graph(apply_coo(adj, d), bucket_caps=ladder, device=dev)
    assert patched.plan.segments[3].runs.max_nnz > dense_tile_threshold(64)
    kmod.reset_counts()
    got = scv_spmm_plan(_perm_ints(patched.plan), z)
    torch.cuda.synchronize()
    assert kmod.dense_launches == 1
    assert torch.equal(got, ref.scv_spmm_reference_plan(_perm_ints(rebuilt.plan), z))


@pytest.mark.parametrize("decision", [("tiles", 4, 1), ("features", 1, 2), ("2d", 2, 2)])
def test_sharded_on_one_card_bit_exact_on_integers(dev, decision):
    """A plan placed on four slots of one card: every span's chain runs the
    kernel, and the merged output equals the unsharded chain bit for bit."""
    from repro_torch.core.aggregate import aggregate_scv_plan
    from repro_torch.core.exec import PlanExecutor, ShardingDecision

    adj = gcn_normalize(powerlaw_graph(3000, 12000, seed=7))
    plan = _perm_ints(build_graph(adj, bucket_caps=(8, 32, 128), device=dev).plan)
    sp = PlanExecutor(devices=(dev,) * 4).prepare(plan, decision=ShardingDecision(*decision))
    z = torch.randint(-4, 5, (3000, 40), generator=torch.Generator().manual_seed(4)).float().to(dev)
    kmod.reset_counts()
    got = aggregate_scv_plan(sp, z)
    torch.cuda.synchronize()
    assert kmod.launches == plan_launches(sp) > 0
    assert torch.equal(got, scv_spmm_plan(plan, z)[:3000])


def test_sharded_forward_on_card_carries_gradients(dev):
    from repro_torch.core.exec import PlanExecutor, ShardingDecision

    adj = gcn_normalize(powerlaw_graph(2000, 8000, seed=8))
    g = build_graph(adj, bucket_caps=(8, 32, 128), device=dev)
    placed = PlanExecutor(devices=(dev,) * 4).prepare_graph(
        g, decision=ShardingDecision("tiles", 4, 1))
    cfg = GNNConfig(name="gcn", kind="gcn", d_in=16, d_hidden=32, n_classes=4)
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
    flat = [p.requires_grad_(True) for ps in params.values() for p in ps.values()]
    x = torch.randn((2000, 16), generator=torch.Generator().manual_seed(1)).to(dev)
    labels = torch.randint(0, 4, (2000,), generator=torch.Generator().manual_seed(2)).to(dev)
    mask = torch.ones(2000, device=dev)
    got = torch.autograd.grad(gnn_loss(params, cfg, placed, x, labels, mask), flat)
    want = torch.autograd.grad(gnn_loss(params, cfg, g, x, labels, mask), flat)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.parametrize("graph", ["sparse", "dense-block"])
@pytest.mark.parametrize("caps", [(8,), (8, 32), (8, 32, 128, 512)])
@pytest.mark.parametrize("n_feat", [128, 40])
def test_tile_32_bit_exact_on_integers(dev, graph, caps, n_feat):
    """T = 32, a tile the tuner can pick: one-rung ladders chain-split
    whole hub tiles into cap-8 pieces, and on the dense-block graph the
    ladder reaching 512 puts every tile past T²/16 = 64 on the dense
    branch."""
    if graph == "sparse":
        adj = gcn_normalize(powerlaw_graph(4000, 40_000, seed=9))
    else:
        adj = gcn_normalize(powerlaw_edges(1024, 150_000, seed=2))
    plan = _ints(build_graph(adj, tile=32, bucket_caps=caps, with_edges=False,
                             device=dev).plan, seed=len(caps))
    z = torch.randint(-4, 5, (adj.shape[0], n_feat),
                      generator=torch.Generator().manual_seed(n_feat)).float().to(dev)
    kmod.reset_counts()
    got = scv_spmm_plan(plan, z)
    torch.cuda.synchronize()
    assert kmod.launches == plan_launches(plan)
    assert (kmod.dense_launches > 0) == (graph == "dense-block" and caps[-1] > 64)
    assert torch.equal(got, ref.scv_spmm_reference_plan(plan, z))


def test_stage2_on_card_picks_the_measured_best(dev, tmp_path):
    """The tuner's stage 2 on the card times the kernel chain (every
    calibrated candidate launches it) and keeps the fastest."""
    from repro_torch.tune import Autotuner, TuneStore
    from repro_torch.tune.signature import device_tag

    adj = gcn_normalize(powerlaw_graph(1 << 13, 60_000, seed=0))
    tuner = Autotuner(device=dev, store=TuneStore(tmp_path / "tune.json"), top_k=2,
                      calib_reps=2)
    kmod.reset_counts()
    cfg = tuner.tune(adj, n_features=32)
    res = tuner.last_result
    assert kmod.launches >= 3 * len(res.calibrated)  # warm-up + 2 reps each
    assert cfg.source == "calibrated" and res.rank_correlation is not None
    assert (64, (8, 32, 128)) in [(c.config.tile, c.config.bucket_caps) for c in res.calibrated]
    best = min(res.calibrated, key=lambda c: c.measured_s)
    assert (cfg.tile, cfg.bucket_caps) == (best.config.tile, best.config.bucket_caps)
    assert res.key.endswith(device_tag(dev)) and device_tag(dev).startswith("torch-cuda-")



# ---------------------------------------------------------------------------
# the captured forward and the aggregation backends on the card
# ---------------------------------------------------------------------------
def _composite_graph(dev, sizes, seed, with_edges):
    """A serving composite (bucket 2,048 nodes) on the card with integer
    values in every slot, for edges too."""
    from repro_torch.models.gnn import Graph

    adjs = [gcn_normalize(powerlaw_graph(n, 3 * n, seed=seed + i)) for i, n in enumerate(sizes)]
    members = [build_graph(a, bucket_caps=(8, 32, 128), with_edges=with_edges, device="cpu")
               for a in adjs]
    g = assemble_batched_graph(members, 64, 2048, with_edges=with_edges, device=dev).graph
    gen = torch.Generator().manual_seed(seed)
    plan = _ints(g.plan, seed=seed)
    vals = None if g.vals is None else torch.randint(
        -4, 5, tuple(g.vals.shape), generator=gen).float().to(dev)
    return Graph(n_nodes=g.n_nodes, plan=plan, rows=g.rows, cols=g.cols, vals=vals)


@pytest.mark.parametrize("kind", ["gcn", "sage", "gin", "gat"])
def test_captured_forward_equals_eager_bit_for_bit(dev, kind):
    """Captured equals eager on integer plan values and features, for the
    first call of a key (eager, then captured) and for a replay after the
    copy-in of a second composite of the same bucket; launches rise at
    replay by what the eager forward launches."""
    from repro_torch.models.gnn import CapturedForward, forward_key, gnn_forward

    cfg = GNNConfig(name=kind, kind=kind, d_in=32, d_hidden=64, n_classes=8)
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
    if kind == "gat":
        # uniform attention: the softmax sums (index_add_, atomics in no
        # fixed order) add ones, exact in any order
        params = {layer: {k: torch.zeros_like(v) if k.startswith("a_") else v
                          for k, v in ps.items()} for layer, ps in params.items()}
    fwd = CapturedForward()
    gen = torch.Generator().manual_seed(1)
    graphs = [_composite_graph(dev, sizes, seed, kind == "gat")
              for sizes, seed in (([300, 900, 150, 600], 0), ([350, 850, 200, 550], 40))]
    xs = [torch.randint(-2, 3, (g.n_nodes, cfg.d_in), generator=gen).float().to(dev)
          for g in graphs]
    assert forward_key(params, cfg, graphs[0], xs[0]) == forward_key(params, cfg, graphs[1], xs[1])
    with torch.inference_mode():
        for i in (0, 1, 0):
            kmod.reset_counts()
            got = fwd(params, cfg, graphs[i], xs[i])
            torch.cuda.synchronize()
            launched = kmod.launches
            want = gnn_forward(params, cfg, graphs[i], xs[i])
            assert launched == plan_launches(graphs[i].plan) * cfg.n_layers
            assert torch.equal(got, want), i
    assert (fwd.captures, fwd.replays, fwd.graphs) == (1, 2, 1) and fwd.copy_bytes > 0
    if kind == "gat":  # seed-0 attention: the same within the atomics' rounding
        params = init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
        with torch.inference_mode():
            got = fwd(params, cfg, graphs[1], xs[1])
            want = gnn_forward(params, cfg, graphs[1], xs[1])
        assert float((got - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("defer", [False, True])
def test_replayed_dense_counts_follow_the_loaded_run_index(dev, defer):
    """T = 32 under the ladder (8, 32, 128): the cap passes T²/16 = 64, so
    a captured launch keeps room for the dense branch, yet a replay counts
    a dense launch only when a tile of the composite it loaded passes 64,
    as the eager wrapper does; captured equals eager bit for bit, captured
    at the first call or, deferred, by ``capture_pending``."""
    from repro_torch.models.gnn import CapturedForward, forward_key, gnn_forward

    rng = np.random.default_rng(5)

    def graph(fills):
        # one tile on the diagonal per block-row, ``fill`` entries each
        rows, cols = [], []
        for b, fill in enumerate(fills):
            slot = rng.choice(32 * 32, fill, replace=False)
            rows.append(32 * b + slot // 32)
            cols.append(32 * b + slot % 32)
        rows, cols = np.concatenate(rows), np.concatenate(cols)
        vals = rng.integers(-4, 5, len(rows)).astype(np.float32)
        adj = COOMatrix(rows.astype(np.int32), cols.astype(np.int32), vals, (128, 128))
        return build_graph(adj, tile=32, bucket_caps=(8, 32, 128), with_edges=False,
                           device=dev)

    graphs = [graph([48, 40, 56, 64]), graph([100, 40, 56, 64])]
    assert [s.n_tiles for s in graphs[0].plan.segments] == [4, 0, 4]
    cfg = GNNConfig(name="gcn", kind="gcn", d_in=16, d_hidden=32, n_classes=4)
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
    gen = torch.Generator().manual_seed(6)
    xs = [torch.randint(-2, 3, (128, cfg.d_in), generator=gen).float().to(dev)
          for _ in graphs]
    assert forward_key(params, cfg, graphs[0], xs[0]) == forward_key(params, cfg, graphs[1], xs[1])
    fwd = CapturedForward(defer=defer)
    with torch.inference_mode():
        for n, i in enumerate((0, 1, 0, 1)):
            kmod.reset_counts()
            got = fwd(params, cfg, graphs[i], xs[i])
            torch.cuda.synchronize()
            counts = (kmod.launches, kmod.dense_launches)
            assert torch.equal(got, gnn_forward(params, cfg, graphs[i], xs[i])), n
            assert counts == (plan_launches(graphs[i].plan) * cfg.n_layers,
                              cfg.n_layers * i), n
            if defer and n == 0:
                assert (fwd.graphs, len(fwd.capture_pending())) == (0, 1)
    assert (fwd.captures, fwd.graphs, fwd.replays) == (1, 1, 3)


def test_engine_captures_once_per_bucket_on_card(dev):
    """An engine on the card: a burst's buckets run eagerly and are captured
    once the queue is empty, a repeated burst replays them and captures
    nothing new, every output matches the eager forward, and the kernel's
    launches equal the engine's (the captures' eager runs included)."""
    from repro_torch.models.gnn import gnn_forward
    from repro_torch.serve.graph_engine import GraphEngineConfig, GraphRequest, GraphServeEngine

    cfg = GNNConfig(name="gcn", kind="gcn", d_in=16, d_hidden=32, n_classes=4)
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = GraphServeEngine({"gcn": (params, cfg)}, GraphEngineConfig(max_batch_graphs=4),
                           device=dev)
    rng = np.random.default_rng(0)
    adjs = [gcn_normalize(powerlaw_graph(int(n), 3 * int(n), seed=i))
            for i, n in enumerate(rng.integers(100, 900, 12))]
    xs = [rng.standard_normal((a.shape[0], cfg.d_in)).astype(np.float32) for a in adjs]

    def burst(base):
        reqs = [GraphRequest(rid=base + i, adj=a, x=x, model="gcn")
                for i, (a, x) in enumerate(zip(adjs, xs))]
        for r in reqs:
            eng.submit(r)
        kmod.reset_counts()
        before = eng.metrics()["launches"]
        eng.run()
        assert kmod.launches == eng.metrics()["launches"] - before > 0
        return reqs

    first = burst(0)
    m = eng.metrics()
    captures, waves = m["forward_captures"], m["waves"]
    assert m["forward_graphs"] == captures and m["forward_replays"] == 0
    assert m["forward_deferred"] == waves - captures
    again = burst(100)
    m = eng.metrics()
    assert (m["forward_captures"], m["forward_graphs"]) == (captures, captures)
    assert m["forward_replays"] == m["waves"] - waves >= len(adjs) // 4
    dev_params = eng.models["gcn"][0]
    for r in first + again:
        g = build_graph(r.adj, device=dev)
        with torch.inference_mode():
            want = gnn_forward(dev_params, cfg, g, torch.from_numpy(r.x).to(dev)).cpu().numpy()
        np.testing.assert_allclose(r.out, want, rtol=0, atol=1e-4 * max(1.0, np.abs(want).max()))


def test_backends_equal_the_scv_chain_on_integers(dev):
    """Every format ``aggregate`` takes, on the card, against the SCV chain
    on the bucketed plan of the same integer-valued graph; each SCV format
    launches the kernel."""
    from repro_torch.core.aggregate import aggregate, aggregate_hybrid
    from repro_torch.core.formats import coo_to_bcsr, coo_to_csc, coo_to_csr
    from repro_torch.core.scv import coo_to_scv, split_hybrid

    a = powerlaw_edges(1024, 60_000, seed=3)
    gen = np.random.default_rng(0)
    a = COOMatrix(a.rows, a.cols, gen.integers(-4, 5, a.nnz).astype(np.float32), a.shape)
    z = torch.from_numpy(gen.integers(-4, 5, (a.shape[1], 48)).astype(np.float32)).to(dev)
    plan = build_graph(a, bucket_caps=(8, 32, 128), with_edges=False, device=dev).plan
    want = scv_spmm_plan(plan, z)[: a.shape[0]]
    tiles = coo_to_scv_tiles(a, 64)
    assert split_hybrid(tiles)[1].n_tiles > 0
    formats = {"dense": torch.from_numpy(a.to_dense()), "coo": a, "csr": coo_to_csr(a),
               "csc": coo_to_csc(a), "bcsr": coo_to_bcsr(a, 64),
               "scv matrix": coo_to_scv(a, 64), "scv tiles": tiles, "bucketed plan": plan}
    for name, fmt in formats.items():
        kmod.reset_counts()
        got = aggregate(fmt, z)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
        assert (kmod.launches > 0) == name.startswith(("scv", "bucketed")), name
    kmod.reset_counts()
    assert torch.equal(aggregate_hybrid(tiles, z), want)
    assert kmod.launches == 1


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "gemma3-4b", "deepseek-v2-lite"])
def test_lm_on_card_equals_cpu(dev, arch):
    """A reduced LM config in float32 (TF32 off; its float32 caches)
    through prefill and three decode steps on the card and on the CPU with
    the same weights: logits and every cache leaf within 1e-4 of the
    largest magnitude, as ``chip_smoke.py`` phase 15(a).  (An int8 cache
    may round one value a quantum apart on the two devices, which moves
    the logits by about that much; phase 15(b) holds the int8 path on the
    card against the forward instead.)"""
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as TT

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS[arch].cfg(reduced=True)
    params, _ = TT.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    on_card = TT.params_from_jax(params, device=dev)  # the same leaves, copied over
    toks = torch.randint(0, cfg.vocab, (2, 23), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)

    def run(p, device):
        logits, cache = TT.prefill(p, cfg, toks[:, :20].to(device), max_len=26)
        outs = [logits]
        for s in range(3):
            pos = torch.full((2, 1), 20 + s, dtype=torch.int32, device=device)
            logits, cache = TT.decode_step(p, cfg, toks[:, 20 + s : 21 + s].to(device), cache, pos)
            outs.append(logits)
        return outs, dict(TT.leaf_paths(cache))

    want, want_cache = run(params, "cpu")
    got, got_cache = run(on_card, dev)
    for g, w in zip(got, want):
        assert (g.cpu() - w).abs().max().item() <= 1e-4 * w.abs().max().item()
    assert set(got_cache) == set(want_cache)
    for k, w in want_cache.items():
        g = got_cache[k].cpu()
        if w.dtype.is_floating_point:
            assert (g - w).abs().max().item() <= 1e-4 * max(1.0, w.abs().max().item()), k
        else:
            assert torch.equal(g, w), k


def test_no_garbage_collection_inside_a_capture(dev):
    """A dropped engine's captures and their forward refer to each other,
    so only the cyclic collector frees their CUDA graphs; freeing one while
    another capture is underway invalidates that capture.  The capture
    turns automatic collection off while it runs (the forward's second
    call is the captured one), and a capture made with such garbage
    present and the collector primed to run at every allocation gives
    eager's bits."""
    import gc

    from repro_torch.models.gnn import CapturedForward, gnn_forward

    cfg = GNNConfig(name="gcn", kind="gcn", d_in=32, d_hidden=64, n_classes=8)
    params = init_gnn(torch.Generator().manual_seed(0), cfg, device=dev)
    g = _composite_graph(dev, [300, 900, 150, 600], 0, False)
    x = torch.randint(-2, 3, (g.n_nodes, cfg.d_in),
                      generator=torch.Generator().manual_seed(1)).float().to(dev)
    collecting = []

    def forward(*args):
        collecting.append(gc.isenabled())
        return gnn_forward(*args)

    with torch.inference_mode():
        old = CapturedForward()
        old(params, cfg, g, x)
        assert old.captures == 1
        del old  # garbage until a collection
        thresholds = gc.get_threshold()
        gc.set_threshold(1, 1, 1)
        try:
            got = CapturedForward(forward=forward)(params, cfg, g, x)
        finally:
            gc.set_threshold(*thresholds)
        torch.cuda.synchronize()
        assert collecting == [True, False] and gc.isenabled()
        assert torch.equal(got, gnn_forward(params, cfg, g, x))


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b", "olmoe-1b-7b"])
def test_captured_decode_equals_eager_on_card(dev, arch):
    """The launcher's captured decode on the card, reduced config in bf16:
    one CUDA graph for the batch size; over the prefill (recurrent for the
    SSM and the hybrid, a replay a token) and 4 decode steps its logits
    and every state leaf equal the eager step's bit for bit, and the state
    it returns is the one it owns."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import serve_fns
    from repro_torch.models import transformer as TT

    spec = ARCHS[arch]
    cfg = dataclasses.replace(spec.cfg(reduced=True), dtype=torch.bfloat16)
    params, _ = spec.init(torch.Generator().manual_seed(0), reduced=True, device=dev)
    toks = torch.randint(0, cfg.vocab, (3, 14), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32).to(dev)
    runs = {}
    with torch.inference_mode():
        for capture in (False, True):
            prefill_fn, decode_fn = serve_fns(spec, cfg, 20, dev, capture=capture)
            logits, state = prefill_fn(params, toks[:, :10])
            outs = [logits]
            for s in range(4):
                pos = torch.full((3, 1), 10 + s, dtype=torch.int32, device=dev)
                logits, out = decode_fn(params, state, toks[:, 10 + s : 11 + s], pos)
                assert out is state or s == 0 and spec.kind == "lm"
                state = out
                outs.append(logits)
            runs[capture] = outs, dict(TT.leaf_paths(state))
        assert (decode_fn.captures, decode_fn.graphs) == (1, 1)
    (want, want_state), (got, got_state) = runs[False], runs[True]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert set(got_state) == set(want_state)
    assert all(torch.equal(got_state[k], w) for k, w in want_state.items())


def test_captured_decode_binds_params_and_state(dev):
    """A captured decode refuses another params tree, and a step that
    returns a new state rather than writing the one it was given."""
    from repro_torch.serve.engine import CapturedDecode

    params = {"w": torch.ones(4, device=dev)}
    state = {"h": torch.zeros((2, 4), device=dev)}
    tok = torch.zeros((2, 1), dtype=torch.int32, device=dev)

    def step(p, s, t, pos):
        s["h"].add_(p["w"] * pos)
        return s["h"].sum(-1, keepdim=True), s

    with torch.inference_mode():
        fn = CapturedDecode(step)
        _, own = fn(params, state, tok, tok + 1)
        logits, own2 = fn(params, own, tok, tok + 2)
        assert own2 is own and own is not state
        assert torch.equal(logits[:, 0], torch.full((2,), 12.0, device=dev))
        with pytest.raises(ValueError, match="bound to the params"):
            fn({"w": params["w"].clone()}, own, tok, tok)
        with pytest.raises(RuntimeError, match="in place"):
            CapturedDecode(lambda p, s, t, pos: (s["h"].sum(-1, keepdim=True),
                                                 {"h": s["h"] + 1}))(params, state, tok, tok)


@pytest.mark.parametrize("graph", ["sparse", "dense-block"])
def test_transposed_backward_on_card_bit_exact_and_repeatable(dev, graph):
    """On integer values, features and cotangents the card's backward (dZ
    through the kernels over the transposed plan, d/dvals by a gather)
    equals the same backward on the CPU bit for bit, two backwards give the
    same bits, and each launches the transposed plan's segments once."""
    if graph == "sparse":
        adj = gcn_normalize(powerlaw_graph(3000, 12_000, seed=4))
        kw = dict(bucket_caps=(8, 32, 128))
    else:
        adj = gcn_normalize(powerlaw_edges(1024, 150_000, seed=4))
        kw = dict(bucket_caps="auto")
    cpu_plan = _ints(build_graph(adj, with_edges=False, device="cpu", **kw).plan, 5)
    gen = torch.Generator().manual_seed(6)
    z = torch.randint(-4, 5, (cpu_plan.shape[1], 40), generator=gen).float()
    cot = torch.randint(-4, 5, (cpu_plan.padded_shape[0], 40), generator=gen).float()

    def grads(plan, device):
        vals = [s.vals.detach().clone().requires_grad_(True) for s in plan.segments]
        zz = z.to(device).clone().requires_grad_(True)
        p = dataclasses.replace(plan, segments=tuple(
            dataclasses.replace(s, vals=v) for s, v in zip(plan.segments, vals)))
        (scv_spmm_plan(p, zz) * cot.to(device)).sum().backward()
        return [zz.grad] + [v.grad for v in vals]

    card_plan = cpu_plan.to(dev)
    want = grads(cpu_plan, "cpu")
    first = grads(card_plan, dev)
    kmod.reset_counts()
    again = grads(card_plan, dev)
    torch.cuda.synchronize()
    plan_t = cached_backward(card_plan).plan_t
    assert kmod.launches == plan_launches(card_plan) + plan_launches(plan_t)
    for a, b, w in zip(first, again, want):  # an empty segment's values get no gradient
        assert (a is None and b is None and w is None) or (
            torch.equal(a, b) and torch.equal(a.cpu(), w))


@pytest.mark.parametrize("arch", ["mamba2-780m", "olmoe-1b-7b", "whisper-small"])
def test_train_step_on_card_equals_cpu(dev, arch):
    """One ``make_train_step`` step of a reduced config in float32 (TF32
    off) from the same weights and batch on the card and on the CPU: the
    loss and every leaf of the new params and of Adam's ``m`` and ``v``
    within 1e-4 of the largest magnitude (params: of max(1, it)), as
    ``chip_smoke.py`` phase 17(a)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.optim.adam import AdamConfig, init_adam
    from repro_torch.tree import leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = ARCHS[arch]
    cfg = spec.cfg(reduced=True)
    params, _ = spec.init(torch.Generator().manual_seed(0), reduced=True, device="cpu")
    batch = make_batch_fn(spec, cfg, 4, 16, "cpu")(0)
    step = spec.make_train_step(AdamConfig(lr=1e-5, warmup_steps=2, total_steps=10),
                                reduced=True)

    def run(p, device):
        p2, st, m = step(p, init_adam(p), {k: v.to(device) for k, v in batch.items()})
        return [m["loss"]], leaves(p2), leaves(st["m"]), leaves(st["v"])

    want = run(params, "cpu")
    got = run(tree_map(lambda t: t.to(dev), params), dev)
    for j, (gs, ws) in enumerate(zip(got, want)):
        for g, w in zip(gs, ws):
            scale = w.abs().max().item()
            scale = max(1.0, scale) if j == 1 else scale
            assert (g.cpu() - w).abs().max().item() <= 1e-4 * scale


def test_compressed_psum_on_card_equals_cpu(dev):
    """``compressed_psum`` over four slots of the card against the same
    call on the CPU, bit for bit (mean and every member's residual), and
    the members' int8 sum made on the first slot's card."""
    from repro_torch.optim.compress import compressed_psum

    gen = torch.Generator().manual_seed(0)
    shapes = [(513, 65), (1000,), (3, 7, 11)]
    grads = [{f"w{i}": torch.randn(s, generator=gen) for i, s in enumerate(shapes)}
             for _ in range(4)]
    errors = [{k: 0.01 * torch.randn(v.shape, generator=gen) for k, v in g.items()}
              for g in grads]
    want_mean, want_err = compressed_psum(grads, errors, "pod")
    on = lambda tree: {k: v.to(dev) for k, v in tree.items()}  # noqa: E731
    mean, err = compressed_psum([on(g) for g in grads], [on(e) for e in errors], "pod")
    for k in want_mean:
        assert mean[k].device.type == "cuda" and torch.equal(mean[k].cpu(), want_mean[k])
        for i in range(4):
            assert torch.equal(err[i][k].cpu(), want_err[i][k])


def test_production_mesh_on_card_equals_no_mesh(dev, capsys, monkeypatch):
    """``launch/train.py --mesh prod`` over every card on a reduced arch
    (``--batch 2`` is one data group; the params' shards sit on the cards
    of their positions).  Laid out data-only (256x1) it gives ``--mesh
    none``'s losses bit for bit; on 16x16 the group splits its products
    (here the vocabulary) over 16 "model" positions: the (1, 16) mesh's
    losses bit for bit, ``--mesh none``'s within 1e-4 relative (TF32 off;
    ``chip_smoke.py``'s ``TP_TOL``)."""
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    n = torch.cuda.device_count()
    args = ["--arch", "mamba2-780m", "--reduced", "--steps", "3", "--batch", "2", "--seq",
            "16", "--device", "cuda"]
    none = train_mod.main(args)
    prod = train_mod.main(args + ["--mesh", "prod"])
    cards = ", ".join(f"cuda:{i}" for i in range(n))
    assert f"[mesh] 16x16 ('data', 'model') over {n} distinct device(s) ({cards})" in \
        capsys.readouterr().out
    assert all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(prod, none))
    for model, want in ((16, prod), (1, none)):
        with monkeypatch.context() as mp:
            mp.setattr(train_mod, "make_production_mesh",
                       lambda multi_pod=False, devices=None, m=model: make_mesh(
                           256 if m == 1 else 16, model_parallel=m, devices=devices))
            assert train_mod.main(args + ["--mesh", "prod"]) == want


def test_production_mesh_moe_groups_on_card_equal_cpu(dev):
    """``olmoe-1b-7b`` reduced on the 16x16 mesh, batch 16: 16 data groups,
    each aux loss with the whole batch's expert shares, in remat's
    recompute too, which on the card runs on autograd's device thread.  One
    step on the card against the same on the CPU in float32 (TF32 off):
    the loss, ``grad_norm`` and every new param, ``m`` and ``v`` within
    1e-4 of the largest magnitude (params: of max(1, it)), as
    ``chip_smoke.py`` phase 18(a).  A group's own shares move ``m`` by
    0.4-0.9% of it."""
    import contextlib
    import io

    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import device_pool, make_production_mesh
    from repro_torch.launch.train import make_batch_fn, place_on_mesh
    from repro_torch.optim.adam import AdamConfig, init_adam
    from repro_torch.train import sharding as shd
    from repro_torch.tree import leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = torch.device("cpu")
    spec = ARCHS["olmoe-1b-7b"]
    params, axes = spec.init(torch.Generator().manual_seed(0), reduced=True, device=cpu)
    batch = make_batch_fn(spec, spec.cfg(reduced=True), 16, 16, cpu)(0)
    step = spec.make_train_step(AdamConfig(lr=1e-5, warmup_steps=2, total_steps=10),
                                reduced=True)

    def run(d):
        p = tree_map(lambda t: t.to(d), params)
        mesh = make_production_mesh(devices=device_pool(d))
        assert shd.batch_groups(mesh, 16)[1] == 16
        with contextlib.redirect_stdout(io.StringIO()):
            p, st = place_on_mesh(mesh, p, init_adam(p), axes)
        p, st, m = step(p, st, {k: v.to(d) for k, v in batch.items()})
        return ([m["loss"].reshape(1), m["grad_norm"].reshape(1)],
                [shd.gather(x, cpu) for x in leaves(p)],
                [shd.gather(x, cpu) for x in leaves((st["m"], st["v"]))])

    want = run(cpu)
    got = run(dev)
    for j, (gs, ws) in enumerate(zip(got, want)):
        for g, w in zip(gs, ws):
            scale = w.abs().max().item()
            scale = max(1.0, scale) if j == 1 else scale
            assert (g.cpu() - w).abs().max().item() <= 1e-4 * scale


def test_production_mesh_sixteen_groups_on_card(dev, capsys):
    """``--mesh prod --batch 16`` on the card: 16 data groups of one
    sequence, dealt over every card, against ``--mesh none`` at the same
    batch: the first loss within 1e-6 relative, the second within 1e-4;
    every position holds its shard-shape bytes."""
    from repro_torch.launch import train as train_mod

    args = ["--arch", "mamba2-780m", "--reduced", "--steps", "2", "--batch", "16", "--seq",
            "16", "--device", "cuda"]
    groups = train_mod.main(args + ["--mesh", "prod"])
    none = train_mod.main(args)
    assert abs(groups[0] - none[0]) <= 1e-6 * abs(none[0])
    assert abs(groups[1] - none[1]) <= 1e-4 * abs(none[1])
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[mesh]")][0]
    shape_bytes = line.split("positions holds ")[1].split(" (shard shapes)")[0]
    assert f"held_bytes: 256 position(s) {shape_bytes}" in line
