"""The port's SPMD train step (``ArchSpec.make_train_step`` on params and
Adam state placed by ``train/sharding.py``) against the reference's
jitted step on ("data", "model") meshes of four forced host devices.

This file runs itself as a script in ``PARTS`` subprocesses with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``: there seeded numpy
weights (``tests/test_torch_train_step.py``'s) and a fresh Adam state are
placed as ``src/repro/launch/train.py:74-82`` places them and the
reference's ``make_train_step`` runs under ``jax.jit`` for two steps, with
that placement as its ``out_shardings``; every position's shard of every
param, m and v leaf is saved with its index.  The port runs the same two
steps from the same weights (``transformer.params_from_jax``) on the same
mesh over four CPU positions, and each position's shard is held to the
reference's ``addressable_shards`` entry for the device at that position:
the same index slices exactly, values within 1e-5 of the largest
magnitude; losses and ``grad_norm`` within 1e-5 relative, on a (2, 2)
mesh (``make_mesh(4, model_parallel=2)``), five reduced archs, in one or
two data groups and microbatches, heads, MLP columns, experts, mamba heads
and vocabulary split two ways.  ``tests/test_torch_spmd_split.py`` runs
(1, 4) and ``seq_sharded`` cases through the same runner.

Stated here, as in ``ROADMAP.md`` §3:

* Under jax 0.9.0 the reference's ``launch/mesh.py::make_mesh`` gives a
  mesh of ``Explicit`` axes, on which its embedding gather raises
  ``ShardingTypeError``.  The reference runs on the same layout of the
  same four devices with ``Auto`` axes (GSPMD, which its
  ``with_sharding_constraint`` calls are written for).
* Left to choose, GSPMD lays some leaves placed whole (``a_log``,
  ``d_skip``, ``dt_bias``) out split over "model" after a step, so the
  reference's jit is given the placement as ``out_shardings``; the port
  keeps the placement.
* Both packages split each constrained product over "model"; the port
  keeps the residual stream and the norms whole on each group's first
  position, where GSPMD splits the residual's features, and sums every
  combine in position order.  The math is the same, the rounding is not,
  hence the tolerances.
* OLMoE's aux loss counts the slots routed in one forward: the port gives
  every data group the whole microbatch's expert shares
  (``layers.expert_shares``), so it is the reference's global aux, and its
  capacity is sized per batch row in both packages.
"""
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

SEQ = 12
ADAM = dict(lr=1e-5, warmup_steps=2, total_steps=10)  # LR 5e-6 at the first step
TOL = 1e-5
STEPS = 2
ARCH_NAMES = ("mamba2-780m", "zamba2-2.7b", "gemma3-4b", "whisper-small", "olmoe-1b-7b")
# (arch, global batch, microbatches, gather_params_once, model axis, heads):
# on the (2, 2) mesh B = 4 makes two data groups on the 2-way data axis,
# B = 2 in two microbatches one; ``heads`` replaces the reduced config's
# (n_heads, n_kv_heads)
CASES = [(a, 4, 1, False, 2, None) for a in ARCH_NAMES] + \
        [(a, 2, 2, False, 2, None) for a in ARCH_NAMES] + \
        [("zamba2-2.7b", 2, 2, True, 2, None), ("zamba2-2.7b", 4, 2, True, 2, None)]
#: One group over a (1, 4) mesh; two of them with heads 4 does not
#: divide (``tests/test_torch_spmd_split.py``).
WIDE_CASES = [(a, 2, 1, False, 4, None) for a in ARCH_NAMES] + \
             [("whisper-small", 2, 1, False, 4, (2, 2)), ("gemma3-4b", 2, 1, False, 4, (2, 1))]
#: Index layouts held to ``devices_indices_map`` on a (pod 2, data 2, model 1) mesh.
INDEX_SPECS = [((8, 6), (("pod", "data"), None)), ((8, 6), ("data", "pod")),
               ((4, 6), ("pod", "model")), ((), ())]
COLLECTIVE_CASE = ("mamba2-780m", 4, 1, False, 2, None)
METRICS = ("loss", "grad_norm", "lr")
PARTS = 3  # subprocesses the reference's runs are dealt over


def case_id(case):
    arch, b, k, once, model, heads = case
    return f"{arch}-B{b}-k{k}" + ("-once" if once else "") + \
        ("" if model == 2 else f"-1x{model}") + ("" if heads is None else f"-H{heads[0]}")


def spec_of(archs, arch, heads):
    """``archs[arch]`` (either package's registry), its reduced config's
    heads replaced by ``heads = (n_heads, n_kv_heads)`` when given."""
    spec = archs[arch]
    if heads is None:
        return spec
    fields = {"n_heads": heads[0]}
    if hasattr(spec.reduced, "n_kv_heads"):
        fields["n_kv_heads"] = heads[1]
    return dataclasses.replace(spec, reduced=dataclasses.replace(spec.reduced, **fields))


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _index(index) -> list:
    """A tuple of slices as JSON: ``None`` for a whole dim, else [start, stop]."""
    return [None if s == slice(None) else [s.start, s.stop] for s in index]


def host_weights(arch, heads=None) -> dict:
    """Seeded numpy weights over the reduced arch's shapes, as the port's
    training-step tests draw them."""
    from test_torch_train_step import _host_weights, numpy_weights

    if heads is None:
        return _host_weights(arch)
    from repro_torch.configs import ARCHS

    spec = spec_of(ARCHS, arch, heads)
    shapes, _ = spec.init(None, reduced=True, device="meta")
    return numpy_weights(shapes, np.random.default_rng(0), spec.reduced.d_model)


def host_batch(arch, batch, batch_id):
    from repro_torch.configs import ARCHS
    from repro_torch.data import pipeline as tpipe

    spec = ARCHS[arch]
    cfg = spec.cfg(reduced=True)
    pcfg = tpipe.TokenPipelineConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=batch)
    if spec.kind == "encdec":
        return tpipe.audio_batch(pcfg, batch_id, n_frames=SEQ, d_model=cfg.d_model)
    return tpipe.token_batch(pcfg, batch_id)


# -- the reference, in the subprocess -------------------------------------------
def _reference(out_dir, part, parts, cases, cost_cases):
    """The reference's runs of ``cases`` dealt by arch (``part`` of
    ``parts``), and the compiled first step's ``hlocost`` of each of
    ``cost_cases`` (lowered only where it is not also run)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from jax.sharding import NamedSharding as JNS
    from jax.sharding import PartitionSpec as JP

    from repro.configs import ARCHS
    from repro.launch.mesh import make_mesh
    from repro.optim.adam import AdamConfig, init_adam
    from repro.train import sharding as jshd
    from repro_torch.launch import hlocost

    assert len(jax.devices()) == 4
    meta = {"cases": {}, "index": [], "costs": {}}
    meshes = {}
    for model in (2, 4):
        explicit = make_mesh(4, model_parallel=model)
        meshes[model] = jax.make_mesh((4 // model, model), ("data", "model"),
                                      axis_types=(AxisType.Auto,) * 2)
        assert (meshes[model].devices == explicit.devices).all()
        assert meshes[model].shape == explicit.shape
        meta["axis_types"] = [str(t) for t in explicit.axis_types]
    arrays = {}
    every = cases + [c for c in cost_cases if c not in cases]
    for arch in list(dict.fromkeys(c[0] for c in every))[part::parts]:
        for case in [c for c in every if c[0] == arch]:
            _, b, k, once, model, heads = case
            mesh = meshes[model]
            rep = JNS(mesh, JP())
            spec = spec_of(ARCHS, arch, heads)
            params = jax.tree.map(jnp.asarray, host_weights(arch, heads))
            axes = spec.init(jax.random.PRNGKey(0), reduced=True)[1]
            pshard = jshd.make_param_sharding(mesh, params, axes)
            oshard = {"m": pshard, "v": pshard, "step": rep}
            p = jax.device_put(params, pshard)
            st = jax.device_put(init_adam(params), oshard)
            step = jax.jit(spec.make_train_step(AdamConfig(**ADAM), reduced=True,
                                                microbatch=k, gather_params_once=once),
                           out_shardings=(pshard, oshard, dict.fromkeys(METRICS, rep)))
            metrics = []
            with jshd.use_mesh(mesh):
                for i in range(STEPS if case in cases else 1):
                    batch = {n: jnp.asarray(v) for n, v in host_batch(arch, b, i).items()}
                    if case in cost_cases and i == 0:
                        hlo = step.lower(p, st, batch).compile().as_text()
                        cost = hlocost.analyze(hlo)
                        meta["costs"][case_id(case)] = {
                            "bytes": cost.collective_bytes, "counts": cost.collective_counts,
                            "flops": cost.flops}
                    if case in cases:
                        p, st, m = step(p, st, batch)
                        metrics.append({n: float(v) for n, v in m.items()})
            if case not in cases:
                continue
            name = case_id(case)
            index = {}
            for tree, leaves_ in (("params", p), ("m", st["m"]), ("v", st["v"])):
                for path, x in _flat(leaves_):
                    by_dev = {s.device: s for s in x.addressable_shards}
                    for pos in np.ndindex(mesh.devices.shape):
                        s = by_dev[mesh.devices[pos]]
                        key = f"{name}/{tree}/{path}/{pos[0]}{pos[1]}"
                        arrays[key] = np.asarray(s.data)
                        index[key] = _index(s.index)
            meta["cases"][name] = {"metrics": metrics, "index": index}
    pods = jax.make_mesh((2, 2, 1), ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
    for shape, spec in INDEX_SPECS:
        got = JNS(pods, JP(*spec)).devices_indices_map(shape)
        meta["index"].append({"".join(map(str, pos)): _index(got[pods.devices[pos]])
                              for pos in np.ndindex(pods.devices.shape)})
    np.savez(os.path.join(out_dir, f"ref{part}.npz"), **arrays)
    with open(os.path.join(out_dir, f"ref{part}.json"), "w") as f:
        json.dump(meta, f)


def reference_runs(tmp_path_factory, script, parts) -> tuple:
    """``script`` run as ``parts`` subprocesses at once (its
    ``__main__`` calls :func:`_reference`): ``(meta, arrays)``."""
    out = tmp_path_factory.mktemp("spmd")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(script), str(out), str(i),
                               str(parts)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in range(parts)]
    for proc in procs:
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, log
    meta, arrays = {"cases": {}, "costs": {}}, {}
    for i in range(parts):
        with open(out / f"ref{i}.json") as f:
            part = json.load(f)
        meta["cases"].update(part.pop("cases"))
        meta["costs"].update(part.pop("costs"))
        meta.update(part)
        with np.load(out / f"ref{i}.npz") as z:
            arrays.update({n: z[n] for n in z.files})
    return meta, arrays


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's runs of ``CASES``, the archs dealt over ``PARTS``
    subprocesses run at once: ``(meta, arrays)``."""
    return reference_runs(tmp_path_factory, __file__, PARTS)


# -- the port ------------------------------------------------------------------------
CPU = torch.device("cpu")


def place(spec, params, mesh):
    from repro_torch.optim.adam import init_adam
    from repro_torch.train import sharding as shd

    axes = spec.init(None, reduced=True, device="meta")[1]
    pshard = shd.make_param_sharding(mesh, params, axes)
    opt = init_adam(params)
    return shd.device_put(params, pshard), shd.device_put(
        opt, {"m": pshard, "v": pshard, "step": shd.NamedSharding(mesh, shd.P())})


def port_steps(case, weights, mesh):
    """The port's two steps of ``case`` from ``weights`` (a tree of numpy
    arrays): ``(params, opt_state, metrics)``, placed on ``mesh`` (or
    whole with ``mesh=None``)."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import pipeline as tpipe
    from repro_torch.models import transformer as TT
    from repro_torch.optim.adam import AdamConfig, init_adam

    arch, b, k, once, _, heads = case
    spec = spec_of(ARCHS, arch, heads)
    params = TT.params_from_jax(weights, device="cpu")
    if mesh is None:
        opt = init_adam(params)
    else:
        params, opt = place(spec, params, mesh)
    step = spec.make_train_step(AdamConfig(**ADAM), reduced=True, microbatch=k,
                                gather_params_once=once)
    metrics = []
    for i in range(STEPS):
        params, opt, m = step(params, opt, tpipe.to_device(host_batch(arch, b, i), CPU))
        metrics.append({n: float(v) for n, v in m.items()})
    return params, opt, metrics


def mesh4(model=2):
    """Four CPU positions, ``4 // model`` x ``model``."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(4, model_parallel=model, devices=(CPU,) * 4)


def _held_to_the_reference(reference, case):
    from repro_torch.train import sharding as shd

    meta, arrays = reference
    ref = meta["cases"][case_id(case)]
    mesh = mesh4(case[4])
    params, opt, metrics = port_steps(case, host_weights(case[0], case[5]), mesh)
    for got, want in zip(metrics, ref["metrics"]):
        for n in METRICS:
            assert abs(got[n] - want[n]) <= TOL * abs(want[n]), (n, got[n], want[n])
    for tree, t in (("params", params), ("m", opt["m"]), ("v", opt["v"])):
        for path, x in _flat(t):
            assert isinstance(x, shd.Sharded) and x.sharding.mesh is mesh
            for pos in shd.positions(mesh):
                key = f"{case_id(case)}/{tree}/{path}/{pos[0]}{pos[1]}"
                assert _index(x.sharding.shard_index(pos, x.shape)) == ref["index"][key], key
                got, want = x.shards[pos].double().numpy(), arrays[key].astype(np.float64)
                assert got.shape == want.shape, key
                err = float(np.abs(got - want).max()) if got.size else 0.0
                assert err <= TOL * max(1.0, float(np.abs(want).max(initial=0.0))), (key, err)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_spmd_step_matches_the_reference_shard_for_shard(reference, case):
    _held_to_the_reference(reference, case)


def test_shard_index_matches_devices_indices_map(reference):
    """Dims split over one or two mesh axes (row-major over ("pod",
    "data")), over an axis of size 1, and a scalar."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import sharding as shd

    meta, _ = reference
    mesh = make_mesh(4, model_parallel=1, n_pods=2, devices=(CPU,) * 4)
    assert tuple(mesh.shape.items()) == (("pod", 2), ("data", 2), ("model", 1))
    for (shape, spec), want in zip(INDEX_SPECS, meta["index"]):
        sh = shd.NamedSharding(mesh, shd.P(*spec))
        got = {"".join(map(str, pos)): _index(sh.shard_index(pos, shape))
               for pos in shd.positions(mesh)}
        assert got == want, spec


def _position_count(case):
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun

    arch, b, _, _, model, heads = case
    batch = {n: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype, device="meta")
             for n, v in host_batch(arch, b, 0).items()}
    return dryrun.position_count(spec_of(ARCHS, arch, heads), "train_4k", mesh4(model),
                                 reduced=True, batch=batch)


def test_dryrun_collectives_beside_the_reference_hlo(reference, capsys):
    """The dry run's count of the SPMD step's collectives, a position's
    bytes by kind, printed beside the reference's compiled step on the
    same cell (hlocost, trip counts corrected).  The gap is stated, not
    held: GSPMD also splits the residual stream and moves what its
    partitioner chooses.  What is held: the param gathers move the batch
    axes' factor only (to the block a position computes with), the
    reduce-scatter the float32 shards, and the tensor-parallel products'
    collectives are counted in."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.train import sharding as shd
    from repro_torch.tree import leaves

    meta, _ = reference
    arch, b, k = COLLECTIVE_CASE[:3]
    spec = ARCHS[arch]
    params, axes = spec.init(None, reduced=True, device="meta")
    pshard = shd.make_param_sharding(mesh4(), params, axes)
    acts = _position_count(COLLECTIVE_CASE)["activations"]
    assert acts["all-reduce"][1] > 0
    got, counts = dryrun.spmd_collectives(params, pshard, k, activations=acts)

    def act(kind, i):
        return acts.get(kind, [0, 0])[i]

    split = [(x, sh) for x, sh in zip(leaves(params), leaves(pshard))
             if sh.shard_shape(x.shape) != tuple(x.shape)]
    gathered = [(x, shd.compute_sharding(sh).shard_shape(x.shape)) for x, sh in split
                if sh.shard_shape(x.shape) != shd.compute_sharding(sh).shard_shape(x.shape)]
    assert got["all-gather"] == sum(x.element_size() * math.prod(c) for x, c in gathered) \
        + act("all-gather", 0)
    assert got["reduce-scatter"] == sum(4 * math.prod(sh.shard_shape(x.shape))
                                        for x, sh in split) + act("reduce-scatter", 0)
    assert counts["all-gather"] == len(gathered) + act("all-gather", 1)
    assert counts["reduce-scatter"] == len(split) + act("reduce-scatter", 1)
    assert counts["all-reduce"] == len(leaves(params)) - len(split) + act("all-reduce", 1)
    want = meta["costs"][case_id(COLLECTIVE_CASE)]["bytes"]
    with capsys.disabled():
        print(f"\n[spmd] {arch} reduced, B = {b}, (2, 2) mesh: a position's collective bytes, "
              f"port {got} against the reference's HLO {want}; total "
              f"{sum(got.values())} against {sum(want.values()):.0f} "
              f"({sum(got.values()) / max(sum(want.values()), 1):.3f}x)")


def test_dryrun_train_cell_reports_the_spmd_collectives():
    """A train cell of the dry run reports the SPMD step's collectives on
    the 16x16 mesh (no longer ``null``): the param gathers, the gradient
    reduce-scatter and the tensor-parallel products' collectives that
    position (0, 0) runs (``position_count``); with
    ``gather_params_once`` each leaf's batch axes' factor is gathered once
    a step, not once a microbatch.  ``flops_per_device`` is position
    (0, 0)'s count, below the whole step's."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train import sharding as shd
    from repro_torch.tree import leaves

    spec = ARCHS["whisper-small"]
    r = dryrun.dryrun_cell("whisper-small", "train_4k", verbose=False, device="cpu")
    cell = dryrun.cell_trees(spec, "train_4k")
    mesh = make_production_mesh(devices=(CPU,))
    pshard = shd.make_param_sharding(mesh, cell["params"], cell["axes"])
    k = spec.train_microbatch
    got, counts = r["collective_bytes_per_device"], r["collective_counts"]
    params_only = dryrun.spmd_collectives(cell["params"], pshard, k)
    acts = {kind: [got[kind] - params_only[0][kind], counts[kind] - params_only[1][kind]]
            for kind in got}
    assert (got, counts) == dryrun.spmd_collectives(cell["params"], pshard, k, activations=acts)
    assert all(b >= 0 and n >= 0 for b, n in acts.values())
    assert acts["all-gather"][1] > 0  # seq_sharded keys and values
    assert acts["reduce-scatter"][1] > 0 and acts["all-reduce"][1] > 0
    assert 0 < r["flops_per_device"] < r["flops_total"] / 16
    gathered = sum(sh.shard_shape(x.shape) != shd.compute_sharding(sh).shard_shape(x.shape)
                   for x, sh in zip(leaves(cell["params"]), leaves(pshard)))
    _, every = dryrun.spmd_collectives(cell["params"], pshard, 4)
    _, once = dryrun.spmd_collectives(cell["params"], pshard, 4, once=True)
    assert (every["all-gather"], once["all-gather"]) == (4 * gathered, gathered)


# -- small checks, no reference ----------------------------------------------------
def test_batch_groups_follow_the_reference_resolve():
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train import sharding as shd

    prod = make_production_mesh(devices=(CPU,))
    multi = make_production_mesh(multi_pod=True, devices=(CPU,))
    assert shd.batch_groups(prod, 2) == ((), 1)  # 16 does not divide 2
    assert shd.batch_groups(prod, 4) == ((), 1)
    assert shd.batch_groups(prod, 16) == (("data",), 16)
    assert shd.batch_groups(multi, 2) == (("pod",), 2)
    assert shd.batch_groups(multi, 64) == (("pod", "data"), 32)
    assert shd.batch_groups(mesh4(), 4) == (("data",), 2)


@pytest.mark.parametrize("n_cards", [1, 2, 3, 8, 32])
def test_group_devices_deal_groups_round_robin(n_cards):
    """16 groups on a 16x16 mesh laid over ``n_cards`` cards (device
    objects only: no card is touched): each group runs on a card that holds
    one of its positions, and no card runs more than ceil(G / P)."""
    from repro_torch.train import sharding as shd

    pool = [torch.device(f"cuda:{i}") for i in range(n_cards)]
    devices = np.empty(256, dtype=object)
    devices[:] = [pool[i % n_cards] for i in range(256)]
    devices = devices.reshape(16, 16)
    got = shd.group_devices(devices, ("data", "model"), ("data",))
    assert len(got) == 16
    for g, d in enumerate(got):
        assert d in set(devices[g])
    load = {d: got.count(d) for d in pool}
    assert max(load.values()) == math.ceil(16 / n_cards)
    assert shd.group_devices(devices, ("data", "model"), ()) == [pool[0]]


def test_placement_holds_separate_shards_and_their_bytes():
    """Every position of a (2, 2) and a 16x16 mesh over one CPU holds its
    own tensors of its shard shape: ``held_bytes`` equals the shard-shape
    count at each position, and no two positions share storage; the
    collectives give the leaf back."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train import sharding as shd
    from repro_torch.tree import leaves

    spec = ARCHS["zamba2-2.7b"]
    params, axes = spec.init(torch.Generator().manual_seed(0), reduced=True, device="cpu")
    for mesh in (mesh4(), make_production_mesh(devices=(CPU,))):
        pshard = shd.make_param_sharding(mesh, params, axes)
        placed = shd.device_put(params, pshard)
        want = shd.shard_bytes(params, pshard)
        ptrs = set()
        for pos in shd.positions(mesh):
            assert shd.held_bytes(placed, pos) == want
            for x in leaves(placed):
                t = x.shards[pos]
                assert tuple(t.shape) == x.sharding.shard_shape(x.shape)
                ptrs.add(t.untyped_storage().data_ptr())
        assert len(ptrs) == mesh.size * len(leaves(params))
        for x, w in zip(leaves(placed), leaves(params)):
            assert torch.equal(shd.gather(x, CPU), w)
        unf = shd.unfsdp_params(placed, axes)
        assert all(torch.equal(shd.gather(x, CPU), w) for x, w in zip(leaves(unf), leaves(params)))
        back = shd.refsdp_params(unf, axes)
        for x, y in zip(leaves(back), leaves(placed)):
            assert x.sharding.spec == y.sharding.spec
            assert all(torch.equal(x.shards[p], y.shards[p]) for p in shd.positions(mesh))


#: How far a step split over "model" may be from ``--mesh none`` on the
#: CPU: the metrics relative, the params absolute (their largest leaves
#: are O(1)).  The split products and combines round otherwise.
SPLIT_TOL = 1e-5


def _near(got, want, got_p, want_p):
    from repro_torch.train import sharding as shd
    from repro_torch.tree import leaves

    for g, w in zip(got, want):
        assert all(abs(g[n] - w[n]) <= SPLIT_TOL * abs(w[n]) for n in METRICS), (g, w)
    for x, w in zip(leaves(got_p), leaves(want_p)):
        x = shd.gather(x, CPU) if isinstance(x, shd.Sharded) else x
        assert float((x - w).abs().max()) <= SPLIT_TOL, float((x - w).abs().max())


def _equal(got, want):
    """Two runs' ``(params, opt_state, metrics)`` bit for bit: metrics,
    and every leaf of the params and moments (gathered when placed)."""
    from repro_torch.train import sharding as shd
    from repro_torch.tree import leaves

    assert got[2] == want[2]

    def whole(x):
        return shd.gather(x, CPU) if isinstance(x, shd.Sharded) else x

    for x, w in zip(leaves((got[0], got[1]["m"], got[1]["v"])),
                    leaves((want[0], want[1]["m"], want[1]["v"]))):
        assert torch.equal(whole(x), whole(w))


def test_one_position_step_equals_no_mesh_bit_for_bit():
    """A mesh of one position, and a (2, 1) mesh (data only) whose batch
    splits into one group: the step gives the unplaced step's losses and
    params bit for bit.  With a "model" axis of 2, the (2, 2) mesh in one
    group gives the (1, 2) mesh's bits, and is within ``SPLIT_TOL`` of
    the unplaced step."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.tree import tree_map

    case = ("mamba2-780m", 2, 2, False, 2, None)
    params, _ = ARCHS["mamba2-780m"].init(torch.Generator().manual_seed(0), reduced=True,
                                          device="cpu")
    weights = tree_map(lambda t: t.numpy(), params)
    want = port_steps(case, weights, None)
    for mesh in (make_mesh(1, model_parallel=1, devices=(CPU,)),
                 make_mesh(2, model_parallel=1, devices=(CPU,) * 2)):
        _equal(port_steps(case, weights, mesh), want)
    split = port_steps(case, weights, mesh4())
    _equal(split, port_steps(case, weights, make_mesh(2, model_parallel=2, devices=(CPU,) * 2)))
    _near(split[2], want[2], split[0], want[0])


def test_gather_params_once_gives_the_same_bits():
    """Gathering the "data" factor once a step or at every microbatch moves
    the same values: the steps agree bit for bit (two groups, two
    microbatches), on a (2, 1) mesh and on the (2, 2) mesh, whose
    "model" axis splits the products.  The (2, 2) step gives the bits of
    the (1, 2) mesh with four microbatches (the same slices in the same
    order), and is within ``SPLIT_TOL`` of the unplaced step."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import pipeline as tpipe
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adam import AdamConfig, init_adam

    spec = ARCHS["gemma3-4b"]
    params, _ = spec.init(torch.Generator().manual_seed(0), reduced=True, device="cpu")
    batch = tpipe.to_device(host_batch("gemma3-4b", 8, 0), CPU)

    def one(mesh, k, once):
        step = spec.make_train_step(AdamConfig(**ADAM), reduced=True, microbatch=k,
                                    gather_params_once=once)
        p, st = place(spec, params, mesh) if mesh is not None else (params, init_adam(params))
        p, st, m = step(p, st, batch)
        return p, st, [{n: float(v) for n, v in m.items()}]

    data_only = make_mesh(2, model_parallel=1, devices=(CPU,) * 2)
    _equal(one(data_only, 2, True), one(data_only, 2, False))
    split = one(mesh4(), 2, True)
    _equal(split, one(mesh4(), 2, False))
    _equal(split, one(make_mesh(2, model_parallel=2, devices=(CPU,) * 2), 4, True))
    want = one(None, 4, False)
    _near(split[2], want[2], split[0], want[0])


@pytest.mark.parametrize("case", [("mamba2-780m", 4, 1), ("gemma3-4b", 8, 2)],
                         ids=lambda c: f"{c[0]}-B{c[1]}-k{c[2]}")
def test_groups_equal_microbatches_bit_for_bit(case):
    """G data groups of ``k`` microbatches run the same passes on the same
    slices as the unplaced step with ``k G`` microbatches, and sum their
    gradients and losses in the same float32 order with the same ``1 / (k
    G)`` scale: on the (2, 1) mesh (data only, two groups) both steps agree
    bit for bit, losses, ``grad_norm``, params and moments.  On the (2, 2)
    mesh the groups split their products over "model": its step gives the
    bits of the (1, 2) mesh with ``k G`` microbatches, and is within
    ``SPLIT_TOL`` of the unplaced step (archs without MoE, whose aux takes
    the whole microbatch's shares under a mesh)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import sharding as shd
    from repro_torch.tree import tree_map

    arch, b, k = case
    params, _ = ARCHS[arch].init(torch.Generator().manual_seed(0), reduced=True, device="cpu")
    weights = tree_map(lambda t: t.numpy(), params)
    data_only = make_mesh(2, model_parallel=1, devices=(CPU,) * 2)
    assert shd.batch_groups(data_only, b // k)[1] == shd.batch_groups(mesh4(), b // k)[1] == 2
    want = port_steps((arch, b, 2 * k, False, 1, None), weights, None)
    _equal(port_steps((arch, b, k, False, 1, None), weights, data_only), want)
    split = port_steps((arch, b, k, False, 2, None), weights, mesh4())
    one_row = make_mesh(2, model_parallel=2, devices=(CPU,) * 2)
    _equal(split, port_steps((arch, b, 2 * k, False, 2, None), weights, one_row))
    _near(split[2], want[2], split[0], want[0])


def test_expert_shares_reach_remat_recompute_on_another_thread():
    """For CUDA tensors autograd runs the backward, and remat's recompute
    in it, on a device thread of its own.  The shares that
    ``expert_shares`` sets must reach the recompute there: a backward run
    on another thread (on the CPU) gives the router the gradient of the
    table's shares, not of the batch's own."""
    import threading

    from repro_torch.models import layers as L

    cfg = L.MoEConfig(n_experts=8, top_k=2, d_model=16, d_ff=8, capacity_factor=1.0)
    key = L.ParamInit(torch.Generator().manual_seed(0), CPU)
    p = {n: t.requires_grad_(True) for n, (t, _) in L.init_moe(key, cfg).items()}
    x = torch.randn(2, 6, 16, generator=torch.Generator().manual_seed(1))
    table = {p["router"].data_ptr(): torch.full((8,), 1 / 8) + torch.arange(8) / 80 - 0.04375}

    def aux_grad(shares, threaded):
        with L.expert_shares(table=shares) if shares else contextlib.nullcontext():
            aux = L.remat(lambda q, y: L.moe_sorted(q, y, cfg)[1], p, x)
            out = []
            run = lambda: out.append(torch.autograd.grad(aux, p["router"])[0])  # noqa: E731
            if threaded:
                t = threading.Thread(target=run)
                t.start()
                t.join()
            else:
                run()
        return out[0]

    want = aux_grad(table, threaded=False)
    assert not torch.equal(want, aux_grad(None, threaded=False))
    assert torch.equal(aux_grad(table, threaded=True), want)


if __name__ == "__main__":
    _reference(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), CASES, [COLLECTIVE_CASE])
