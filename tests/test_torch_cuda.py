"""The SCV SpMM CUDA kernels against their plain versions, on the card:
the vector body (sparse branch, accumulate mode, dense-tile branch; runs
split into many work units, summed in a fixed order by the run's last
block), the scalar body, the shared-memory opt-in at T = 128, a refused
launch, repeat launches giving the same bits, and gradients through a
CUDA forward.

Run on a machine with an H100 (the kernel is built for sm_90a):

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py

Without a CUDA device every test here skips: a CUDA kernel has no CPU or
interpret mode.  ``chip_smoke.py`` makes the same checks at full size.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.scv_spmm import ref
from repro_torch.kernels.scv_spmm import scv_spmm as kmod
from repro_torch.kernels.scv_spmm.ops import scv_spmm_plan
from repro_torch.core import scv
from repro_torch.core.formats import COOMatrix
from repro_torch.core.scv import coo_to_scv_tiles, dense_tile_threshold, plan_from_tiles
from repro_torch.models.gnn import GNNConfig, build_graph, gnn_loss, init_gnn
from repro_torch.serve.graph_engine import assemble_batched_graph, plan_launches
from repro_torch.simul.datasets import gcn_normalize, powerlaw_edges, powerlaw_graph


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
    (the kernel's output has a grad_fn), and each parameter's gradient
    matches plain autograd through the plain version on the card within
    1e-4 of its largest magnitude (the backward's index_add_ sums with
    atomics, in no fixed order)."""
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
    assert kmod.launches == 2 * plan_launches(g.plan) and kmod.dense_launches > 0
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
    for s in plan.segments:
        for c in s.runs._counters.values():
            assert not bool(c.any())
    want = ref.scv_spmm_reference_plan(plan, z)
    assert (first - want).abs().max().item() <= 1e-5 * want.abs().max().item()
