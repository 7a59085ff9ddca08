"""The port's sharding rules (``repro_torch.train.sharding``) against the
reference's ``src/repro/train/sharding.py``: the rule tables value for
value, the reference's own cases (``tests/test_sharding_rules.py``,
``tests/test_train_stack.py``) mirrored, and every param leaf and every
decode-state leaf of every arch at full size (abstract trees only)
resolved to the reference's ``PartitionSpec`` on the production meshes
and four elastic ones, compared by leaf path as ``tuple(jax_spec)``.
The mesh context, the one-device no-ops and the refusal of a mesh over
several distinct devices are the port's own."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.train import sharding as jshd
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.transformer import leaf_paths
from repro_torch.train import sharding as shd

CPU = torch.device("cpu")
MESHES = {
    "16x16": lambda devs: make_production_mesh(devices=devs),
    "2x16x16": lambda devs: make_production_mesh(multi_pod=True, devices=devs),
    **{f"elastic{n}": (lambda n: lambda devs: make_mesh(n, devices=devs))(n)
       for n in (16, 64, 192, 240)},
}


class FakeMesh:
    def __init__(self, mesh):
        self.shape = dict(mesh.shape)


def _mesh_1x1():
    return shd.Mesh(np.array([[CPU]], dtype=object), ("data", "model"))


def _jpaths(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): x
            for p, x in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, tuple) or hasattr(x, "shape"))[0]}


def test_rule_tables_equal_the_reference():
    assert shd.PARAM_RULES == jshd.PARAM_RULES
    assert shd.ACT_RULES == jshd.ACT_RULES
    assert list(shd.PARAM_RULES) == list(jshd.PARAM_RULES)
    assert list(shd.ACT_RULES) == list(jshd.ACT_RULES)


def test_partition_spec_is_the_reference_tuple():
    from jax.sharding import PartitionSpec as JP

    for parts in [(), (None,), ("data", "model"), (("pod", "data"), None, "model")]:
        assert tuple(JP(*parts)) == shd.P(*parts)
    assert repr(shd.P("data", None)) == "PartitionSpec('data', None)"


# -- the reference's own cases, mirrored --------------------------------------
def test_resolve_divisibility_fallback():
    spec = shd._resolve((16, 32), ("embed", "mlp"), shd.PARAM_RULES, _mesh_1x1())
    assert spec == shd.P("data", "model")


def test_resolve_conflict_first_dim_wins():
    spec = shd._resolve((8, 16, 32), ("expert", "embed", "mlp"), shd.PARAM_RULES, _mesh_1x1())
    assert spec == shd.P("model", "data", None)


def test_resolve_indivisible_drops():
    class Fake:
        shape = {"data": 16, "model": 16}

    assert shd._resolve((4, 128), ("kv_heads", "head_dim"), shd.PARAM_RULES, Fake()) == \
        shd.P(None, None)
    assert shd._resolve((48, 128), ("heads", "head_dim"), shd.PARAM_RULES, Fake()) == \
        shd.P("model", None)


def test_param_spec_resolves_rules():
    mesh = _mesh_1x1()
    assert shd.param_spec((8, 16), ("gnn_in", "gnn_out"), mesh=mesh) == shd.P("data", "model")
    assert shd.param_spec((8,), ("head_dim",), mesh=mesh) == shd.P(None)


def test_param_spec_divisibility_fallback():
    mesh = shd.Mesh(np.array([[CPU] * 4], dtype=object), ("data", "model"))
    assert shd.param_spec((6,), ("mlp",), mesh=mesh) == shd.P(None)
    assert shd.param_spec((8,), ("mlp",), mesh=mesh) == shd.P("model")


def test_use_mesh_installs_and_restores():
    outer, inner = _mesh_1x1(), make_production_mesh(devices=(CPU,))
    assert shd.active_mesh() is None
    with shd.use_mesh(outer) as m:
        assert m is outer and shd.active_mesh() is outer
        assert shd.attn_axes(4) == ("batch", None, "heads", None)
        with shd.use_mesh(inner):
            assert shd.active_mesh() is inner
            assert shd.attn_axes(40) == ("batch", "seq_sharded", None, None)
            assert shd.attn_axes(48) == ("batch", None, "heads", None)
        assert shd.active_mesh() is outer
    assert shd.active_mesh() is None
    with pytest.raises(KeyError), shd.use_mesh(outer):
        raise KeyError("restored on error too")
    assert shd.active_mesh() is None


def test_constrain_and_param_helpers_return_their_input_without_a_mesh():
    x = torch.ones((4, 8))
    assert shd.constrain(x, ("batch", "embed")) is x
    params = {"w": torch.ones((4, 4))}
    axes = {"w": ("gnn_in", "gnn_out")}
    assert shd.unfsdp_params(params, axes) is params
    assert shd.refsdp_params(params, axes) is params


def test_one_device_mesh_keeps_values_and_checks_specs():
    x = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    params = {"w": x.clone(), "b": {"c": torch.ones(4)}}
    axes = {"w": ("gnn_in", "gnn_out"), "b": {"c": ("embed",)}}
    with shd.use_mesh(make_production_mesh(devices=(CPU,) * 3)):
        y = shd.constrain(x, ("batch", "embed"))
        assert y is x and torch.equal(y, torch.arange(16, dtype=torch.float32).reshape(4, 4))
        assert shd.unfsdp_params(params, axes) is params
        assert shd.refsdp_params(params, axes) is params
        assert torch.equal(params["w"], x)
        with pytest.raises(ValueError, match="logical axes"):
            shd.constrain(x, ("batch",))  # rank
        with pytest.raises(ValueError, match="no sharding rule"):
            shd.constrain(x, ("batch", "nonsense"))
        with pytest.raises(ValueError, match="no sharding rule"):
            shd.unfsdp_params(params, {"w": ("gnn_in", "nonsense"), "b": {"c": ("embed",)}})


def test_several_distinct_devices_are_refused():
    """No longer refused: on a mesh over two distinct devices (the CPU and
    ``meta``), the helpers check specs and return plain tensors as they
    are, and ``device_put`` places every position's shard on that
    position's device with its shard shape and slice of the leaf."""
    mesh = make_production_mesh(devices=(CPU, torch.device("meta")))
    assert len(mesh.distinct_devices) == 2
    x = torch.arange(256, dtype=torch.float32).reshape(16, 16)
    with shd.use_mesh(mesh):
        assert shd.constrain(x, ("batch", "embed")) is x
        assert shd.unfsdp_params({"w": x}, {"w": ("embed", "mlp")})["w"] is x
        assert shd.refsdp_params({"w": x}, {"w": ("embed", "mlp")})["w"] is x
    sh = shd.make_param_sharding(mesh, {"w": x}, {"w": ("embed", "mlp")})
    placed = shd.device_put({"w": x}, sh)["w"]
    assert isinstance(placed, shd.Sharded) and placed.shards.shape == (16, 16)
    for pos in shd.positions(mesh):
        t = placed.shards[pos]
        assert t.device == mesh.devices[pos] and tuple(t.shape) == (1, 1)
        if t.device == CPU:
            assert torch.equal(t, x[pos[0]:pos[0] + 1, pos[1]:pos[1] + 1])


def test_device_put_and_shard_bytes_on_one_device():
    """Every position of a mesh over one device holds its own block, cut
    as ``shard_index`` says: ``held_bytes`` is the shard-shape count, and
    ``gather`` gives the leaf back."""
    mesh = make_production_mesh(devices=(CPU,))
    tree = {"w": torch.arange(32 * 64, dtype=torch.float32).reshape(32, 64),
            "s": torch.zeros((), dtype=torch.int32)}
    sh = {"w": shd.NamedSharding(mesh, shd.param_spec((32, 64), ("embed", "mlp"), mesh)),
          "s": shd.NamedSharding(mesh, shd.P())}
    placed = shd.device_put(tree, sh)
    assert sh["w"].spec == shd.P("data", "model")
    assert sh["w"].shard_shape((32, 64)) == (2, 4)
    assert sh["w"].shard_index((3, 5), (32, 64)) == (slice(6, 8), slice(20, 24))
    assert torch.equal(placed["w"].shards[3, 5], tree["w"][6:8, 20:24])
    assert placed["s"].shards[0, 0] is not placed["s"].shards[0, 1]
    assert shd.shard_bytes(tree, sh) == 2 * 4 * 4 + 4
    assert all(shd.held_bytes(placed, pos) == 2 * 4 * 4 + 4 for pos in shd.positions(mesh))
    assert torch.equal(shd.gather(placed["w"], CPU), tree["w"])
    with pytest.raises(ValueError, match="does not split"):
        shd.NamedSharding(mesh, shd.P("data")).shard_shape((24,))


def test_batch_sharding_matches_the_reference():
    from jax.sharding import Mesh as JMesh

    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi, devices=(CPU,))
        jmesh = JMesh(np.array(jax.devices()[:1]).reshape((1,) * len(mesh.axis_names)),
                      mesh.axis_names)
        assert shd.batch_sharding(mesh).spec == tuple(jshd.batch_sharding(jmesh).spec)


# -- every arch at full size, against the reference's _resolve -------------------
def _reference_params(arch):
    spec = J_ARCHS[arch]
    shapes = jax.eval_shape(lambda: spec.init(jax.random.PRNGKey(0))[0])
    _, axes = spec.init(jax.random.PRNGKey(0), reduced=True)
    return _jpaths(shapes), _jpaths(axes)


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_every_param_leaf_resolves_as_the_reference(arch):
    jshapes, jaxes = _reference_params(arch)
    params, axes = T_ARCHS[arch].init(None, device="meta")
    tshapes, taxes = dict(leaf_paths(params)), dict(leaf_paths(axes))
    assert set(tshapes) == set(jshapes) == set(taxes)
    n = 0
    for name, build in MESHES.items():
        mesh = build((CPU,))
        fake = FakeMesh(mesh)
        shardings = dict(leaf_paths(shd.make_param_sharding(mesh, params, axes)))
        for path, t in tshapes.items():
            assert tuple(t.shape) == tuple(jshapes[path].shape), path
            assert tuple(taxes[path]) == tuple(jaxes[path]), path
            want = tuple(jshd._resolve(jshapes[path].shape, jaxes[path], jshd.PARAM_RULES, fake))
            assert shardings[path].spec == want, (name, path)
            assert shd.param_spec(t.shape, taxes[path], mesh) == want, (name, path)
            n += 1
    assert n == len(MESHES) * len(tshapes)


DECODE_CELLS = [(a, s) for a in sorted(J_ARCHS) for s in J_ARCHS[a].shapes
                if s in ("decode_32k", "long_500k")]


@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_every_decode_state_leaf_resolves_as_the_reference(arch, shape):
    jstate, jaxes = J_ARCHS[arch].state_specs(shape)
    jstate, jaxes = _jpaths(jstate), _jpaths(jaxes)
    tstate, taxes = T_ARCHS[arch].state_specs(shape)
    tstate, taxes = dict(leaf_paths(tstate)), dict(leaf_paths(taxes))
    assert set(tstate) == set(jstate) == set(taxes)
    for name, build in MESHES.items():
        mesh = build((CPU,))
        fake = FakeMesh(mesh)
        for path, t in tstate.items():
            want = tuple(jshd._resolve(jstate[path].shape, jaxes[path], jshd.ACT_RULES, fake))
            got = shd._resolve(t.shape, taxes[path], shd.ACT_RULES, mesh)
            assert got == want, (name, path)
