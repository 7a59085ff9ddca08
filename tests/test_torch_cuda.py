"""The SCV SpMM CUDA kernel against its plain version, on the card.

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
from repro_torch.models.gnn import build_graph
from repro_torch.serve.graph_engine import assemble_batched_graph, plan_launches
from repro_torch.simul.datasets import gcn_normalize, powerlaw_graph


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
