"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's ``src/repro/launch/dryrun.py``, on the CPU, every tree on
``meta`` (no full-size model is built):

* ``n_params`` and ``n_active_params`` of every arch equal the reference's
  ``param_count``/``active_param_count``;
* each mesh position's argument bytes (and a decode cell's output bytes)
  equal a sum over the reference's own shardings of its own trees
  (``make_param_sharding``, ``_batch_shardings``,
  ``_spec_tree_to_shardings`` on a ``jax.sharding.AbstractMesh`` of the
  production shape), for every (arch x shape) on both production meshes;
* one step's FLOPs counted on ``meta`` against the reference's
  ``hlocost.analyze`` over its reduced train step, jitted and compiled on
  the CPU, for one arch of each family, each gap stated below;
* ``flops_per_device``: position (0, 0)'s count, the whole step for a
  decode cell; for a train cell, counted at two depths and carried to the
  arch's (exact on the reduced configs);
* ``main`` writes the reference's keys, and reports a failing cell.
"""
import ast
import dataclasses
import functools
import importlib
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as JP

from repro.configs import ARCHS as J_ARCHS
from repro.configs import common as JC
from repro.launch import hlocost
from repro.train import sharding as jshd
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.launch import dryrun as TD
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train import sharding as shd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CELLS = [(a, s) for a in sorted(J_ARCHS) for s in J_ARCHS[a].shapes]

# Measured gaps, (port - reference) / reference, of one reduced train step
# (B = 2, S = 64).  The LM, MoE and encoder-decoder gaps are exactly one
# pass of the unembedding over the loss's one 512-token chunk: the port
# recomputes the checkpointed chunk in the backward, while XLA, once the
# one-trip loops are unrolled, merges that recompute with the forward
# (with two chunks the counts agree: test_two_loss_chunks_count_alike).
# The SSM and the hybrid count less: with one B/C group the port forms
# C·Bᵀ and the products with the state once per group, where the
# reference forms them for every head.
STATED_GAPS = {
    "gemma3-4b": 10.13,
    "olmoe-1b-7b": 13.24,
    "mamba2-780m": -25.63,
    "zamba2-2.7b": -26.17,
    "whisper-small": 16.33,
}
LOSS_CHUNK = 512


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module.  It sets ``XLA_FLAGS`` (512 host
    devices) when imported: the backend is started first, so the flag
    reaches nothing here, and the variable is put back for later tests."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    spec = J_ARCHS[arch]
    shapes = jax.eval_shape(lambda: spec.init(jax.random.PRNGKey(0))[0])
    return shapes, spec.init(jax.random.PRNGKey(0), reduced=True)[1]


def _amesh(multi_pod):
    m = make_production_mesh(multi_pod=multi_pod, devices=(CPU,))
    return AbstractMesh(tuple(m.shape.values()), tuple(m.shape))


def _jbytes(tree, shardings):
    sizes = jax.tree.map(lambda x, s: math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize,
                         tree, shardings)
    return sum(jax.tree.leaves(sizes))


def _reference_cell(jdryrun, arch, shape, multi_pod):
    """The reference dry run's trees and shardings for the cell (its own
    code, on an abstract mesh): ``(args, shardings, step)``."""
    spec, kind = J_ARCHS[arch], JC.SHAPES[shape].kind
    amesh = _amesh(multi_pod)
    params, axes = _jparams(arch)
    pshard = jshd.make_param_sharding(amesh, params, axes)
    batch = spec.input_specs(shape)
    bshard = jdryrun._batch_shardings(amesh, batch)
    if kind == "train":
        if spec.master_weights:
            params = JC.bf16_params(params)
        opt = JC.abstract_opt_state(params, spec.master_weights)
        oshard = {"m": pshard, "v": pshard, "step": NamedSharding(amesh, JP())}
        if spec.master_weights:
            oshard["master"] = pshard
        return (params, opt, batch), (pshard, oshard, bshard), None
    if kind == "prefill":
        return (params, batch), (pshard, bshard), None
    state, state_axes = spec.state_specs(shape)
    sshard = jdryrun._spec_tree_to_shardings(amesh, state, state_axes, jshd.ACT_RULES)
    return (params, state, batch), (pshard, sshard, bshard), spec.make_decode_step(
        JC.SHAPES[shape])


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_equal_the_reference_shard_shapes(jdryrun, arch, shape, multi_pod):
    args, shardings, _ = _reference_cell(jdryrun, arch, shape, multi_pod)
    want = sum(_jbytes(a, s) for a, s in zip(args, shardings))
    spec = T_ARCHS[arch]
    cell = TD.cell_trees(spec, shape)
    mesh = make_production_mesh(multi_pod=multi_pod, devices=(CPU,))
    tshard = TD.cell_shardings(mesh, cell)
    _, names = TD.cell_step(spec, shape)
    assert sum(shd.shard_bytes(cell[n], tshard[n]) for n in names) == want


def _reference_keys():
    """The keys of the reference's ``dryrun_cell`` result (read from its
    source: running it needs 256 host devices and a full compile)."""
    tree = ast.parse(open(os.path.join(REPO, "src", "repro", "launch", "dryrun.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "result" for t in node.targets)):
            keys = [k.value for k in node.value.keys]
            memory = node.value.values[keys.index("memory")]
            return set(keys), {k.value for k in memory.keys}
    raise AssertionError("no result dict in the reference's dryrun_cell")


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_decode_cell_counts_and_bytes_equal_the_reference(jdryrun, arch):
    r = TD.dryrun_cell(arch, "decode_32k", verbose=False, device="cpu")
    spec = J_ARCHS[arch]
    assert r["status"] == "ok" and r["mesh"] == "16x16" and r["devices"] == 1
    assert r["n_params"] == spec.param_count()
    assert r["n_active_params"] == spec.active_param_count()
    args, shardings, step = _reference_cell(jdryrun, arch, "decode_32k", False)
    assert r["memory"]["argument_bytes"] == sum(_jbytes(a, s) for a, s in zip(args, shardings))
    logits = jax.eval_shape(step, *args)[0]
    out_bytes = _jbytes(logits, jdryrun._batch_shardings(_amesh(False), logits)) + \
        _jbytes(args[1], shardings[1])
    assert r["memory"]["output_bytes"] == out_bytes
    keys, memory = _reference_keys()
    assert keys <= set(r) and set(r["memory"]) == memory
    for k in ("collective_bytes_per_device", "collective_counts",
              "xla_flops_per_device_uncorrected", "lower_s", "compile_s"):
        assert r[k] is None, k
    assert r["memory"]["temp_bytes"] is None and r["flops_total"] > 0
    # the port runs a decode step whole on one device: position (0, 0) runs all of it
    assert r["flops_per_device"] == r["flops_total"]
    whole = r["whole_cell"]
    assert whole["peak_bytes"] >= whole["argument_bytes"] > r["memory"]["argument_bytes"]
    assert r["fits_one_card"] == (whole["peak_bytes"] <= TD.CARD_BYTES)
    assert r["card"] is None  # the CPU pool runs nothing


def _reference_train_flops(arch, batch=None):
    spec = J_ARCHS[arch]
    params = jax.eval_shape(lambda: spec.init(jax.random.PRNGKey(0), reduced=True)[0])
    batch = batch or spec.input_specs("train_4k", reduced=True)
    hlo = jax.jit(spec.make_train_step(reduced=True)).lower(
        params, JC.abstract_opt_state(params), batch).compile().as_text()
    return hlocost.analyze(hlo).flops


@pytest.mark.parametrize("arch", sorted(STATED_GAPS))
def test_flops_against_the_reference_hlocost(arch):
    want = _reference_train_flops(arch)
    got = TD.count_step(T_ARCHS[arch], "train_4k", reduced=True)["flops"]
    gap = 100 * (got - want) / want
    assert gap == pytest.approx(STATED_GAPS[arch], abs=0.01), gap
    cfg = T_ARCHS[arch].cfg(reduced=True)
    if T_ARCHS[arch].kind in ("lm", "encdec"):
        # the gap is one unembedding pass over the padded chunk (and, for
        # the MoE, 262,144 of the router's small products)
        vocab = T_ARCHS[arch].init(None, reduced=True, device="meta")[0]["embed"]["table"].shape[0]
        assert abs(got - want - 2 * 2 * LOSS_CHUNK * cfg.d_model * vocab) <= 0.001 * want


@pytest.mark.parametrize("arch", ["gemma3-4b", "olmoe-1b-7b"])
def test_two_loss_chunks_count_alike(arch):
    """With 1,024 tokens (two loss chunks) XLA keeps the recompute too:
    the counts agree (0.00% and +0.03%, the router's small products)."""
    S = 2 * LOSS_CHUNK
    want = _reference_train_flops(arch, {"tokens": jax.ShapeDtypeStruct((2, S + 1), jnp.int32)})
    spec = T_ARCHS[arch]
    params, _ = spec.init(None, reduced=True, device="meta")
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.common import abstract_opt_state

    with FlopCounterMode(display=False) as fc:
        spec.make_train_step(reduced=True)(
            params, abstract_opt_state(params),
            {"tokens": torch.empty((2, S + 1), dtype=torch.int32, device="meta")})
    assert abs(fc.get_total_flops() - want) <= 0.001 * want


@pytest.mark.parametrize("arch", sorted(STATED_GAPS))
def test_position_count_is_affine_in_depth(arch):
    """``flops_per_device`` and the tensor-parallel collectives of a train
    cell are counted at one and two layer units and carried to the arch's
    depth: on the reduced configs, over a (2, 2) mesh, that equals the
    count at full depth exactly; position (0, 0) runs less than its
    group's whole step and more than a quarter of it."""
    from repro_torch.configs.common import abstract_opt_state
    from repro_torch.launch.mesh import make_mesh
    from torch.utils.flop_counter import FlopCounterMode

    spec = T_ARCHS[arch]
    mesh = make_mesh(4, model_parallel=2, devices=(CPU,) * 4)
    got = TD.position_count(spec, "train_4k", mesh, reduced=True)
    assert got == TD._group_count(spec, "train_4k", mesh, True, None)
    assert got["activations"]["all-reduce"][1] > 0
    params, _ = spec.init(None, reduced=True, device="meta")
    batch = {n: x[:1] for n, x in spec.input_specs("train_4k", reduced=True).items()}
    with FlopCounterMode(display=False) as fc:
        spec.make_train_step(reduced=True)(params, abstract_opt_state(params), batch)
    assert fc.get_total_flops() / 4 < got["flops"] < fc.get_total_flops()


def test_main_writes_the_reference_keys(tmp_path, capsys):
    out = tmp_path / "cells.json"
    TD.main(["--arch", "mamba2-780m", "--shape", "long_500k", "--out", str(out),
             "--device", "cpu"])
    (r,) = json.loads(out.read_text())
    keys, memory = _reference_keys()
    assert keys <= set(r) and set(r["memory"]) == memory
    assert r["status"] == "ok" and r["fits_one_card"] and r["card"] is None
    assert "1/1 cells counted OK" in capsys.readouterr().out
    TD.main(["--arch", "gemma2-27b", "--shape", "long_500k", "--out", str(out),
             "--device", "cpu"])
    (skipped,) = json.loads(out.read_text())
    assert skipped["status"] == "skipped" and "long_500k" in skipped["note"]
    TD.main(["--arch", "mamba2-781m", "--shape", "decode_32k", "--out", str(out),
             "--device", "cpu"])
    (failed,) = json.loads(out.read_text())
    assert failed["status"] == "FAILED" and "KeyError" in failed["error"]
    assert "FAILED mamba2-781m x decode_32k" in capsys.readouterr().out


def test_default_pool_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.dryrun_cell("mamba2-780m", "long_500k", verbose=False)


def test_run_cell_and_live_bytes_on_the_cpu():
    r = TD.run_cell(T_ARCHS["mamba2-780m"], "decode_32k", "cpu", reduced=True)
    assert r["finite"] and r["max_memory_allocated"] is None and r["ms"] > 0
    assert r["allocated_before"] is None
    assert r["clock"] == "host"
    x = torch.empty(1000, device="meta")  # 4,000 B of arguments
    with TD.LiveBytes([x]) as live:
        y = x * 2  # +4,000
        z = y.view(10, 100)  # a view: no new storage
        del y
        w = z + 1  # +4,000 (z still holds y's storage)
        del z, w
        v = torch.empty(250, device="meta")  # +1,000 after both were freed
    assert live.peak == 12_000 and live.live == 5_000 and v.numel() == 250


def test_cost_totals_fields_are_the_reference_parser():
    from repro_torch.launch import hlocost as T

    assert [f.name for f in dataclasses.fields(T.CostTotals)] == \
        [f.name for f in dataclasses.fields(hlocost.CostTotals)]
    assert np.isfinite(TD.CARD_BYTES)
