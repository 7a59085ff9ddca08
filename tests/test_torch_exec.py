"""The port's plan executor (``repro_torch.core.exec``, ``core.dist``)
against the reference's, on pools of CPU devices.

* The decision rule, the byte model, ``ShardingDecision`` and the
  machine constants equal the reference's over a grid of workloads.
* Placement: the span leaves of ``PlanExecutor.prepare`` equal the
  reference's for ``tiles`` 8x1, ``features`` 1x8 and ``2d`` 4x2 (padding
  coordinates rewritten, perm -1), and so do the imbalance numbers.  The
  reference's placement needs eight devices, so it runs in one subprocess
  with ``--xla_force_host_platform_device_count=8`` (this file run as a
  script), which also records ``validate_plan``'s verdicts on the
  placement and on seeded faults.
* Outputs: sharded aggregation, through every decision and the ``dist``
  façade, is bit-exact with the reference's eager single-device
  ``aggregate_scv_plan(backend="jnp")`` on integer values and Z, and
  within 1e-5 on normal floats.  The reference's own sharded path fails
  under the installed jax (ROADMAP §3), so it is not the yardstick.
* Models: the four GNN kinds through ``prepare_graph`` match the
  reference's single-device forward within 1e-5; ``gnn_loss`` gradients
  through a sharded graph match ``jax.grad`` of the reference's unsharded
  loss within 1e-5 of each gradient's largest magnitude (at least 1).
* Launches: the kernel wrapper is called exactly ``plan_launches`` times.

Tolerances: 1e-5, float32 sums in another order (span partials are summed
after each span's chain).  Integers: exact.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import exec as jexec
from repro.core import scv as jscv
from repro.core.aggregate import aggregate_scv_plan as j_aggregate
from repro.core.formats import COOMatrix as JCOO
from repro.models import gnn as jgnn
from repro.simul.machine import MachineConfig as JMachine
from repro.tune import cost as jcost
from repro_torch.core import dist as tdist
from repro_torch.core import exec as texec
from repro_torch.core import scv as tscv
from repro_torch.core.aggregate import aggregate_scv_plan
from repro_torch.core.formats import COOMatrix
from repro_torch.core.validate import validate_plan
from repro_torch.kernels.scv_spmm import ops
from repro_torch.models import gnn as tgnn
from repro_torch.serve.graph_engine import plan_launches
from repro_torch.simul.datasets import gcn_normalize, powerlaw_graph
from repro_torch.simul.machine import MachineConfig
from repro_torch.tune import cost as tcost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEAVES = ("tile_row", "tile_col", "rows", "cols", "vals", "nnz_in_tile", "perm")
CAPS = (8, 32, 64)
DECISIONS = {"tiles": ("tiles", 8, 1), "features": ("features", 1, 8), "2d": ("2d", 4, 2)}
CPU8 = (torch.device("cpu"),) * 8
KINDS = ["gcn", "sage", "gin", "gat"]


def _graph(integer: bool):
    """The reference tests' graph: ``powerlaw_graph(700, 5000, seed=0)``,
    with integer values in -3..3 or GCN-normalised."""
    a = powerlaw_graph(700, 5000, seed=0)
    if integer:
        vals = np.random.default_rng(0).integers(-3, 4, a.nnz).astype(np.float32)
        return COOMatrix(a.rows, a.cols, vals, a.shape)
    return gcn_normalize(a)


def _plans(a):
    """The same bucketed plan (T = 32, caps (8, 32, 64)) in both packages."""
    jt = jscv.coo_to_scv_tiles(JCOO(a.rows, a.cols, a.vals, a.shape), 32, cap=CAPS[-1])
    tt = tscv.coo_to_scv_tiles(a, 32, cap=CAPS[-1])
    return (jscv.plan_from_tiles_bucketed(jt, caps=CAPS),
            tscv.plan_from_tiles_bucketed(tt, caps=CAPS))


# ---------------------------------------------------------------------------
# seeded faults, applied alike to both packages' stacked leaves
# ---------------------------------------------------------------------------
def _drop_last_span(stacked):
    stacked[1] = {k: v[:-1] for k, v in stacked[1].items()}


def _empty_first_span(stacked):
    """Span 0 of segment 0 replaced by an all-padding span."""
    seg = stacked[0]
    for k in LEAVES:
        seg[k][0] = -1 if k == "perm" else 0


def _duplicate_perm(stacked):
    seg = stacked[0]
    p = seg["tile_row"].shape[0] - 1
    t = int(np.flatnonzero(seg["nnz_in_tile"][p] >= 2)[0])
    seg["perm"][p, t, 1] = seg["perm"][p, t, 0]


FAULTS = {"green": lambda stacked: None, "shard-span": _drop_last_span,
          "shard-coverage": _empty_first_span, "perm": _duplicate_perm}


def _verdicts(report, invariants=None):
    """(invariant, segment, part, ok, offending) of each check, through
    JSON (the form the subprocess writes)."""
    return json.loads(json.dumps([
        (c.invariant, c.segment, c.part, c.ok, list(c.offending)) for c in report.checks
        if invariants is None or c.invariant in invariants
    ]))


def _reference_dump(path):
    """Run as a script (eight host devices): the reference's placements of
    the normalised graph's plan, and its verdicts on them and on the
    seeded faults, into ``path`` (npz)."""
    from repro.core.validate import validate_plan as j_validate

    assert len(jax.devices()) == 8, jax.devices()
    a = _graph(integer=False)
    jp, _ = _plans(a)
    coo = JCOO(a.rows, a.cols, a.vals, a.shape)
    out = {}
    for name, dec in DECISIONS.items():
        sp = jexec.PlanExecutor().prepare(jp, decision=jexec.ShardingDecision(*dec))
        stacked = [{k: np.array(getattr(s, k)) for k in LEAVES} for s in sp.segments]
        for j, seg in enumerate(stacked):
            for k, v in seg.items():
                out[f"{name}/{j}/{k}"] = v
        out[f"{name}/imbalance"] = np.float64(sp.imbalance)
        out[f"{name}/imbalance_per_segment"] = np.array(sp.imbalance_per_segment)
        out[f"{name}/nnz_per_part"] = sp.nnz_per_part()
        for fault, apply in FAULTS.items():
            bad = [{k: v.copy() for k, v in seg.items()} for seg in stacked]
            apply(bad)
            bad_sp = dataclasses.replace(sp, segments=tuple(
                dataclasses.replace(s, **{k: jnp.asarray(v) for k, v in b.items()})
                for s, b in zip(sp.segments, bad)))
            out[f"{name}/verdict/{fault}"] = np.array(
                json.dumps(_verdicts(j_validate(bad_sp, coo=coo))))
    np.savez(path, **out)


@pytest.fixture(scope="session")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("exec") / "reference.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(filter(None, [os.path.join(REPO, "src"),
                                                        os.environ.get("PYTHONPATH")])))
    res = subprocess.run([sys.executable, os.path.abspath(__file__), path], env=env,
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def normalised():
    a = _graph(integer=False)
    return (a,) + _plans(a)


@pytest.fixture(scope="module")
def integer():
    a = _graph(integer=True)
    return (a,) + _plans(a)


def _decision(name):
    return texec.ShardingDecision(*DECISIONS[name])


def _rebuilt(sp, stacked):
    """A port ``ShardedPlan`` holding ``stacked`` leaves, each span with the
    run index of its own leaves."""
    template = sp.segments[0][0]
    segs = []
    for j, seg in enumerate(stacked):
        spans = []
        for p in range(seg["tile_row"].shape[0]):
            leaves = {k: torch.from_numpy(np.ascontiguousarray(v[p])) for k, v in seg.items()}
            spans.append(dataclasses.replace(
                template, **leaves, cap=seg["rows"].shape[-1],
                runs=tscv.RunIndex.of(seg["tile_row"][p], seg["nnz_in_tile"][p])))
        segs.append(tuple(spans))
    return dataclasses.replace(sp, segments=tuple(segs))


# ---------------------------------------------------------------------------
# decisions, byte model, constants
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 8])
def test_decide_sharding_matches_reference(n_devices):
    for nnz in (0, 100, 5_000, 20_000, 10**6, 10**7):
        for f in (4, 40, 128, 256, 1024):
            for n_rows in (None, 2_000, 169_343):
                for n_slots in (None, 3 * nnz + 1):
                    kw = dict(n_rows=n_rows, n_slots=n_slots)
                    want = jexec.decide_sharding(nnz, f, n_devices, **kw)
                    got = texec.decide_sharding(nnz, f, n_devices, **kw)
                    assert dataclasses.astuple(got) == dataclasses.astuple(want), (nnz, f, kw)
                    kw.update(min_nnz_per_part=64, min_features_per_part=4)
                    want = jexec.decide_sharding(nnz, f, n_devices, **kw)
                    got = texec.decide_sharding(nnz, f, n_devices, **kw)
                    assert dataclasses.astuple(got) == dataclasses.astuple(want), (nnz, f, kw)
    with pytest.raises(ValueError, match="n_devices"):
        texec.decide_sharding(10, 4, 0)


def test_constants_and_byte_model_match_reference():
    for name in ("TILE_AXIS", "FEATURE_AXIS", "MIN_NNZ_PER_PART", "MIN_FEATURES_PER_PART",
                 "EST_AVG_DEGREE"):
        assert getattr(texec, name) == getattr(jexec, name), name
    for nnz, f, tp, fp, kw in [(10**6, 256, 4, 2, dict(n_rows=125_000)),
                               (10**6, 256, 1, 2, {}), (5_000, 40, 8, 1, dict(n_slots=20_000)),
                               (1_305_163, 128, 4, 1, dict(n_rows=169_343, n_slots=7_470_000))]:
        assert texec.placement_bytes(nnz, f, tp, fp, **kw) == jexec.placement_bytes(
            nnz, f, tp, fp, **kw)
    machine = MachineConfig(dram_gbps=3.0, bytes_per_elem=2)
    assert texec.placement_bytes(10**5, 64, 2, 2, machine=machine) == jexec.placement_bytes(
        10**5, 64, 2, 2, machine=JMachine(dram_gbps=3.0, bytes_per_elem=2))
    assert MachineConfig().fingerprint() == JMachine().fingerprint()
    assert machine.fingerprint() == JMachine(dram_gbps=3.0, bytes_per_elem=2).fingerprint()
    assert dataclasses.asdict(MachineConfig()) == dataclasses.asdict(JMachine())
    assert tcost.plan_slot_bytes(1234) == jcost.plan_slot_bytes(1234)


def test_plan_launched_slots_matches_reference(normalised):
    _, jp, tp = normalised
    assert tcost.plan_launched_slots(tp) == jcost.plan_launched_slots(jp)
    assert tcost.plan_launched_slots(tp.segments[0]) == jcost.plan_launched_slots(jp.segments[0])
    jex = jexec.PlanExecutor(devices=(jax.devices()[0],) * 8)
    tex = texec.PlanExecutor(devices=CPU8)
    for f in (4, 48, 128, 256, 1024):
        assert dataclasses.astuple(tex.decide(tp, f)) == dataclasses.astuple(jex.decide(jp, f))


@pytest.mark.parametrize("args", [("2d", 1, 4), ("replicated", 2, 1), ("sideways", 2, 1),
                                  ("tiles", 0, 1), ("features", 2, 2), ("tiles", 2, 2)])
def test_decision_errors_match_reference(args):
    with pytest.raises(ValueError) as want:
        jexec.ShardingDecision(*args)
    with pytest.raises(ValueError) as got:
        texec.ShardingDecision(*args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("args", [("replicated", 1, 1), ("tiles", 1, 1), ("tiles", 8, 1),
                                  ("features", 1, 8), ("2d", 4, 2)])
def test_decision_signature_and_devices_match_reference(args):
    got, want = texec.ShardingDecision(*args), jexec.ShardingDecision(*args)
    assert (got.signature, got.n_devices) == (want.signature, want.n_devices)
    assert hash(got) == hash(texec.ShardingDecision(*args))


# ---------------------------------------------------------------------------
# placement against the reference's (eight host devices, subprocess)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(DECISIONS))
def test_span_leaves_match_reference_prepare(reference, normalised, name):
    _, _, tp = normalised
    sp = texec.PlanExecutor(devices=CPU8).prepare(tp, decision=_decision(name))
    stacked = sp.stacked()
    assert len(stacked) == len(CAPS)
    for j, seg in enumerate(stacked):
        for k in LEAVES:
            want = reference[f"{name}/{j}/{k}"]
            assert seg[k].dtype == want.dtype and seg[k].shape == want.shape, (j, k)
            np.testing.assert_array_equal(seg[k], want, err_msg=f"segment {j} {k}")
    assert sp.imbalance == float(reference[f"{name}/imbalance"])
    assert sp.imbalance_per_segment == tuple(reference[f"{name}/imbalance_per_segment"])
    np.testing.assert_array_equal(sp.nnz_per_part(), reference[f"{name}/nnz_per_part"])
    assert (sp.n_parts, sp.caps, sp.tile, sp.shape, sp.padded_shape, sp.order) == (
        DECISIONS[name][1], CAPS, 32, (700, 700), (704, 704), "zmorton")


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", ["tiles", "2d"])
def test_sharded_verdicts_match_reference(reference, normalised, name, fault):
    a, _, tp = normalised
    sp = texec.PlanExecutor(devices=CPU8).prepare(tp, decision=_decision(name))
    stacked = list(sp.stacked())
    FAULTS[fault](stacked)
    report = validate_plan(_rebuilt(sp, stacked), coo=a)
    want = json.loads(str(reference[f"{name}/verdict/{fault}"]))
    assert _verdicts(report, {v[0] for v in want}) == want
    assert report.kind == "sharded"
    assert report.ok == (fault == "green")
    if fault != "green":
        assert report.failed(fault)
    # the port's extra check, one per span, passes on every span it checks
    assert all(c.ok for c in report.checks if c.invariant == "run-index")


def test_stale_span_run_index_fails_run_index(normalised):
    _, _, tp = normalised
    sp = texec.PlanExecutor(devices=CPU8).prepare(tp, decision=_decision("tiles"))
    assert validate_plan(sp).ok
    segs = [list(spans) for spans in sp.segments]
    segs[0][3] = dataclasses.replace(segs[0][3], runs=segs[0][2].runs)
    report = validate_plan(dataclasses.replace(sp, segments=tuple(map(tuple, segs))))
    bad = report.failed("run-index")
    assert [(c.segment, c.part) for c in bad] == [(0, 3)]
    assert {c.invariant for c in report.failures} == {"run-index"}


# ---------------------------------------------------------------------------
# outputs against the reference's eager single-device aggregation
# ---------------------------------------------------------------------------
def _count_launches(monkeypatch):
    calls = []
    real = ops.scv_spmm_chain  # the vector body: one launch a chain

    def counted(*args, **kw):
        calls.append(args[2].shape)  # z's shape: one entry per launch
        return real(*args, **kw)

    monkeypatch.setattr(ops, "scv_spmm_chain", counted)
    return calls


@pytest.mark.parametrize("name", list(DECISIONS))
def test_sharded_output_bit_exact_on_integers(integer, name, monkeypatch):
    a, jp, tp = integer
    z = np.random.default_rng(0).integers(-3, 4, (a.shape[1], 48)).astype(np.float32)
    want = np.asarray(j_aggregate(jp, jnp.asarray(z), backend="jnp"))
    sp = texec.PlanExecutor(devices=CPU8).prepare(tp, decision=_decision(name))
    calls = _count_launches(monkeypatch)
    got = aggregate_scv_plan(sp, torch.from_numpy(z))
    assert len(calls) == plan_launches(sp) > 0
    assert got.shape == want.shape == (700, 48)
    np.testing.assert_array_equal(got.numpy(), want)
    via_executor = texec.PlanExecutor(devices=CPU8).aggregate(sp, torch.from_numpy(z))
    np.testing.assert_array_equal(via_executor.numpy(), want)


@pytest.mark.parametrize("name", list(DECISIONS))
def test_sharded_output_close_on_floats(normalised, name):
    a, jp, tp = normalised
    rng = np.random.default_rng(1)
    for f in (48, 45):  # 45: feature slabs of unequal width
        z = rng.standard_normal((a.shape[1], f)).astype(np.float32)
        want = np.asarray(j_aggregate(jp, jnp.asarray(z), backend="jnp"))
        sp = texec.PlanExecutor(devices=CPU8).prepare(tp, decision=_decision(name))
        np.testing.assert_allclose(aggregate_scv_plan(sp, torch.from_numpy(z)).numpy(), want,
                                   rtol=1e-5, atol=1e-5)


def test_dist_facade_bit_exact(integer):
    a, jp, tp = integer
    z = np.random.default_rng(2).integers(-3, 4, (a.shape[1], 16)).astype(np.float32)
    want = np.asarray(j_aggregate(jp, jnp.asarray(z), backend="jnp"))
    g = tdist.distribute_plan(tp, 8, devices=CPU8)
    assert isinstance(g, tdist.DistributedGraph)
    assert g.decision == texec.ShardingDecision("tiles", 8)
    np.testing.assert_array_equal(tdist.aggregate_distributed(g, torch.from_numpy(z)).numpy(), want)
    one = tdist.distribute_plan(tp.segments[0], 1, devices=CPU8[:1])
    np.testing.assert_array_equal(
        tdist.aggregate_distributed(one, torch.from_numpy(z)).numpy(),
        np.asarray(j_aggregate(jp.segments[0], jnp.asarray(z), backend="jnp")))
    tiles = tscv.coo_to_scv_tiles(a, 32, cap=64)
    jtiles = jscv.coo_to_scv_tiles(JCOO(a.rows, a.cols, a.vals, a.shape), 32, cap=64)
    np.testing.assert_array_equal(
        tdist.aggregate_distributed(tdist.distribute_tiles(tiles, 4, devices=CPU8[:4]),
                                    torch.from_numpy(z)).numpy(),
        np.asarray(j_aggregate(jscv.plan_from_tiles(jtiles), jnp.asarray(z), backend="jnp")))


def test_all_padding_spans_launch_nothing(monkeypatch):
    """More spans than a segment has tiles: the empty spans launch nothing,
    the output stays bit-exact and the placement validates."""
    a = COOMatrix(np.array([0, 1, 40, 70], np.int32), np.array([3, 50, 40, 2], np.int32),
                  np.array([1, 2, -3, 4], np.float32), (80, 80))
    tp = tscv.plan_from_tiles_bucketed(tscv.coo_to_scv_tiles(a, 32, cap=8), caps=(8,))
    sp = texec.PlanExecutor(devices=CPU8).prepare(tp, decision=_decision("tiles"))
    assert [s.runs.max_nnz > 0 for s in sp.segments[0]].count(True) < 8
    assert validate_plan(sp, coo=a).ok
    calls = _count_launches(monkeypatch)
    z = torch.arange(80 * 3, dtype=torch.float32).reshape(80, 3)
    got = aggregate_scv_plan(sp, z)
    assert len(calls) == plan_launches(sp) == 4  # one a tile holding an entry
    torch.testing.assert_close(got, aggregate_scv_plan(tp, z), rtol=0, atol=0)


def test_reweighted_through_span_perms(normalised):
    a, jp, tp = normalised
    rng = np.random.default_rng(3)
    z = rng.standard_normal((a.shape[1], 8)).astype(np.float32)
    ev = rng.standard_normal(a.nnz).astype(np.float32)
    want = np.asarray(j_aggregate(jp.reweighted(jnp.asarray(ev)), jnp.asarray(z), backend="jnp"))
    sp = texec.PlanExecutor(devices=CPU8).prepare(tp, decision=_decision("2d"))
    assert sp.perm is not None
    got = aggregate_scv_plan(sp.reweighted(torch.from_numpy(ev)), torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# models through a placed graph
# ---------------------------------------------------------------------------
def _models(kind):
    jcfg = jgnn.GNNConfig(name=kind, kind=kind, d_in=16, d_hidden=16, n_classes=4,
                          backend="jnp")
    tcfg = tgnn.GNNConfig(name=kind, kind=kind, d_in=16, d_hidden=16, n_classes=4)
    jparams, _ = jgnn.init_gnn(jax.random.PRNGKey(0), jcfg)
    if kind == "gin":  # a nonzero eps exercises the (1 + eps) h term
        jparams = {k: {**v, "eps": jnp.asarray(0.25, jnp.float32)} for k, v in jparams.items()}
    host = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tgnn.params_from_jax(host, device="cpu")


@pytest.fixture(scope="module")
def model_graph():
    """The reference's sharded-GNN test graph, both packages, and the port's
    graph placed 2d 4x2 (the reference test's executor floors)."""
    a = gcn_normalize(powerlaw_graph(400, 2400, seed=1))
    jg = jgnn.build_graph(JCOO(a.rows, a.cols, a.vals, a.shape), tile=64, bucket_caps=CAPS)
    tg = tgnn.build_graph(a, tile=64, bucket_caps=CAPS, device="cpu")
    ex = texec.PlanExecutor(devices=CPU8, min_nnz_per_part=64, min_features_per_part=4)
    placed = ex.prepare_graph(tg, decision=texec.ShardingDecision("2d", 4, 2))
    x = np.random.default_rng(0).standard_normal((400, 16)).astype(np.float32)
    return a, jg, placed, x


@pytest.mark.parametrize("kind", KINDS)
def test_gnn_forward_through_placed_graph_matches_reference(model_graph, kind):
    _, jg, placed, x = model_graph
    assert isinstance(placed.plan, texec.ShardedPlan)
    jcfg, tcfg, jparams, tparams = _models(kind)
    want = np.asarray(jgnn.gnn_forward(jparams, jcfg, jg, jnp.asarray(x)))
    got = tgnn.gnn_forward(tparams, tcfg, placed, torch.from_numpy(x))
    assert got.shape == want.shape == (400, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_gnn_loss_grads_through_placed_graph_match_jax(model_graph, kind):
    _, jg, placed, x = model_graph
    jcfg, tcfg, jparams, tparams = _models(kind)
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 4, 400).astype(np.int32)
    mask = (rng.random(400) < 0.6).astype(np.float32)
    want = jax.grad(jgnn.gnn_loss)(jparams, jcfg, jg, jnp.asarray(x), jnp.asarray(labels),
                                   jnp.asarray(mask))
    flat = {(layer, k): p.requires_grad_(True) for layer, ps in tparams.items()
            for k, p in ps.items()}
    loss = tgnn.gnn_loss(tparams, tcfg, placed, torch.from_numpy(x),
                         torch.from_numpy(labels), torch.from_numpy(mask))
    grads = torch.autograd.grad(loss, list(flat.values()))
    for (layer, k), g in zip(flat, grads):
        w = np.asarray(want[layer][k])
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * scale, (layer, k)


# ---------------------------------------------------------------------------
# the executor's own contract
# ---------------------------------------------------------------------------
def test_prepare_replicated_and_decided(normalised):
    _, _, tp = normalised
    ex = texec.PlanExecutor(devices=CPU8)
    assert ex.prepare(tp, decision=texec.ShardingDecision("replicated")) is tp
    with pytest.raises(ValueError, match="decision or n_features"):
        ex.prepare(tp)
    decided = ex.decide(tp, 128)
    placed = ex.prepare(tp, n_features=128)
    assert placed is tp if decided.kind == "replicated" else placed.decision == decided
    with pytest.raises(ValueError, match="needs 16 devices"):
        ex.devices_for(texec.ShardingDecision("2d", 4, 4))
    grid = ex.devices_for(texec.ShardingDecision("2d", 4, 2))
    assert len(grid) == 4 and all(len(row) == 2 for row in grid)
    g = tgnn.build_graph(_graph(integer=False), tile=32, bucket_caps=CAPS, device="cpu")
    assert ex.prepare_graph(g, decision=texec.ShardingDecision("replicated")) is g


@pytest.mark.parametrize("n_feat,parts", [(3, 8), (3, 4), (5, 8)])
def test_feature_slabs_narrower_than_one_column(integer, n_feat, parts):
    """Fewer columns than feature slabs: the last slabs are empty, and the
    output and ``d/dz`` equal the reference's eager ones bit for bit on
    integers (the reference pads Z's columns to the slab multiple)."""
    a, jp, tp = integer
    rng = np.random.default_rng(n_feat + parts)
    z = rng.integers(-3, 4, (a.shape[1], n_feat)).astype(np.float32)
    w = rng.integers(-3, 4, (a.shape[0], n_feat)).astype(np.float32)
    want = np.asarray(j_aggregate(jp, jnp.asarray(z), backend="jnp"))
    want_dz = np.asarray(jax.grad(lambda zz: jnp.sum(
        j_aggregate(jp, zz, backend="jnp") * jnp.asarray(w)))(jnp.asarray(z)))
    sp = texec.PlanExecutor(devices=CPU8).prepare(
        tp, decision=texec.ShardingDecision("features", 1, parts))
    tz = torch.from_numpy(z).requires_grad_(True)
    got = aggregate_scv_plan(sp, tz)
    assert got.shape == want.shape == (700, n_feat)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (dz,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), tz)
    np.testing.assert_array_equal(dz.numpy(), want_dz)


def test_pool_refuses_absent_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is available"):
        texec.PlanExecutor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texec.PlanExecutor(devices=("cuda:0", "cuda:0"))
    with pytest.raises(RuntimeError, match="none is available"):
        tdist.distribute_plan(None, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="only 1 CUDA"):
        texec.PlanExecutor(devices=("cuda:0", "cuda:3"))
    ex = texec.PlanExecutor(devices=("cuda:0", "cuda:0"))
    assert ex.devices == (torch.device("cuda:0"),) * 2 and ex.n_devices == 2


if __name__ == "__main__":
    _reference_dump(sys.argv[1])
