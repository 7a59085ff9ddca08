"""Logical-axis sharding rules (MaxText-style) with divisibility fallback.

Port of ``src/repro/train/sharding.py``.  Params carry logical axis names
(see ``models/layers.py``).  ``PARAM_RULES`` maps each name to the
preferred mesh axes; at resolution time an axis is silently dropped
(replicated) when the dimension is not divisible by the mesh axis size or
the mesh axis is already consumed by an earlier dim -- this is what lets
e.g. kv_heads=4 coexist with a 16-way model axis.  The rules and
:func:`_resolve` are the reference's, value for value.

The JAX types have counterparts here: :class:`PartitionSpec` is a tuple
(``tuple(jax_spec) == port_spec``), :class:`Mesh` an ``ndarray`` of
``torch.device`` laid over a device pool (``launch/mesh.py``), and
:class:`NamedSharding` a ``(mesh, spec)`` pair that gives each position's
shard shape.  One process holds the pool.  On a mesh whose positions all
name one device there is no layout to constrain: :func:`constrain`,
:func:`unfsdp_params` and :func:`refsdp_params` check the spec and return
their input, and :func:`device_put` leaves every leaf whole on that
device.  A mesh over several distinct cards is refused
(:data:`SPMD_ITEM`); with no mesh active they return their input, as in
the reference.
"""
from __future__ import annotations

import collections
import contextlib
import math
import threading

import numpy as np

from repro_torch.tree import leaves, tree_map

#: What a mesh over more than one distinct card waits for.
SPMD_ITEM = ("ROADMAP.md §1 item 6 (a step run SPMD over more than one distinct card: "
             "placement, collectives and compressed_psum across cards)")

# params: fsdp over "data", tensor-parallel over "model"
PARAM_RULES: dict[str, tuple] = {
    "vocab": ("model",),
    "embed": ("data",),
    "embed2": None,
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "expert": ("model",),
    "mla_rank": None,
    "inner": ("model",),
    "conv": None,
    "mamba_heads": None,
    "layers": None,
    "sublayers": None,
    "seq": None,
    "gnn_in": ("data",),
    "gnn_out": ("model",),
}

# activations and serve-time caches/states
ACT_RULES: dict[str, tuple] = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "embed": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "expert": ("model",),
    "mlp": ("model",),
    "inner": ("model",),
    "mamba_heads": ("model",),
    "seq": None,
    "seq_sharded": ("model",),
    # caches: when kv_heads can't shard the model axis (kv=4/8/12/40),
    # head_dim takes it instead (resolver's used-set keeps them exclusive)
    "head_dim": ("model",),
    "mla_rank": None,
    "state": None,
    "conv": None,
    "layers": None,
    "sublayers": None,
}


class PartitionSpec(tuple):
    """One entry per dim: ``None`` (replicated), a mesh axis name, or a
    tuple of names (the dim split over their product)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """Named axes over an ``ndarray`` of ``torch.device`` (one entry per
    position).  A device may stand at many positions: a pool that names
    one card 256 times is a 16x16 mesh on that card."""

    def __init__(self, devices: np.ndarray, axis_names):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> collections.OrderedDict:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh.shape``)."""
        return collections.OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def distinct_devices(self) -> tuple:
        """The devices the positions name, each once, in position order."""
        return tuple(dict.fromkeys(self.devices.flat))

    def __repr__(self):
        dims = "x".join(str(n) for n in self.devices.shape)
        return (f"Mesh({dims} {self.axis_names}, over "
                f"{', '.join(map(str, self.distinct_devices))})")


class NamedSharding:
    """A spec on a mesh: which slice of a global array each position holds."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def _ways(self, entry) -> int:
        if entry is None:
            return 1
        names = entry if isinstance(entry, tuple) else (entry,)
        return math.prod(self.mesh.shape[a] for a in names)

    def shard_shape(self, global_shape) -> tuple:
        """Each position's block of an array of ``global_shape``."""
        global_shape = tuple(global_shape)
        if len(self.spec) > len(global_shape):
            raise ValueError(f"spec {self.spec} has more entries than shape {global_shape}")
        out = []
        for i, dim in enumerate(global_shape):
            ways = self._ways(self.spec[i]) if i < len(self.spec) else 1
            if dim % ways:
                raise ValueError(f"dim {i} of {global_shape} does not split {ways} ways "
                                 f"({self.spec})")
            out.append(dim // ways)
        return tuple(out)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


_local = threading.local()


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Install ``mesh`` for :func:`constrain` and the param helpers; the
    previous mesh comes back on exit."""
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev


def active_mesh() -> Mesh | None:
    return getattr(_local, "mesh", None)


def _resolve(shape, axes, rules, mesh) -> P:
    """Logical axes -> PartitionSpec with divisibility/conflict fallback."""
    used = set()
    parts = []
    for dim, name in zip(shape, axes):
        entry = rules.get(name)
        if entry is None:
            parts.append(None)
            continue
        assign = []
        size = 1
        for ax in entry:
            if ax not in mesh.shape or ax in used:
                continue
            if dim % (size * mesh.shape[ax]) != 0:
                continue
            assign.append(ax)
            size *= mesh.shape[ax]
        if assign:
            used.update(assign)
            parts.append(tuple(assign) if len(assign) > 1 else assign[0])
        else:
            parts.append(None)
    return P(*parts)


def param_spec(shape, axes, mesh=None) -> P:
    mesh = mesh or active_mesh()
    return _resolve(shape, axes, PARAM_RULES, mesh)


def make_param_sharding(mesh: Mesh, params_shapes, specs):
    """NamedSharding tree for a params tree.  ``params_shapes`` may be
    tensors on any device (``meta`` included); ``specs`` the logical-axes
    tree."""
    return tree_map(
        lambda x, ax: NamedSharding(mesh, _resolve(x.shape, ax, PARAM_RULES, mesh)),
        params_shapes,
        specs,
    )


def require_one_device(mesh: Mesh, what: str) -> None:
    """Raise unless every position of ``mesh`` names one device."""
    if len(mesh.distinct_devices) > 1:
        raise NotImplementedError(
            f"{what} on a mesh over {len(mesh.distinct_devices)} distinct devices: "
            f"not ported; {SPMD_ITEM}")


def _checked(x, axes, rules, mesh) -> P:
    """The resolved spec of ``x``, after checking that ``axes`` names one
    rule (or ``None``) per dim."""
    axes = tuple(axes)
    if len(axes) != x.ndim:
        raise ValueError(f"{len(axes)} logical axes {axes} for a {x.ndim}-d tensor")
    unknown = [a for a in axes if a is not None and a not in rules]
    if unknown:
        raise ValueError(f"logical axes {unknown} have no sharding rule")
    return _resolve(x.shape, axes, rules, mesh)


def constrain(x, logical_axes):
    """The counterpart of ``with_sharding_constraint`` against the active
    mesh: ``x`` itself (no mesh, or a mesh on one device: the tensor is
    whole there, and the spec is still checked)."""
    mesh = active_mesh()
    if mesh is None:
        return x
    require_one_device(mesh, "constrain")
    _checked(x, logical_axes, ACT_RULES, mesh)
    return x


def attn_axes(n_heads: int):
    """Sharding axes for [B, S, H, D] attention activations: shard heads
    over model when divisible, else fall back to sharding the sequence
    (qwen's 40 heads / whisper's 12 heads on a 16-way model axis)."""
    mesh = active_mesh()
    if mesh is None or "model" not in mesh.shape or n_heads % mesh.shape["model"] == 0:
        return ("batch", None, "heads", None)
    return ("batch", "seq_sharded", None, None)


def batch_sharding(mesh: Mesh, n_leading=1):
    """Sharding for input batches: leading axis over all data-like axes."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return NamedSharding(mesh, P(axes if len(axes) > 1 else axes[0]))


def _constrain_tree(tree, axes_tree, rules, what):
    mesh = active_mesh()
    if mesh is None:
        return tree
    require_one_device(mesh, what)
    tree_map(lambda x, ax: _checked(x, ax, rules, mesh), tree, axes_tree)
    return tree


def unfsdp_params(params, axes_tree):
    """Drop the fsdp ("data") factor from every param's sharding while
    keeping tensor parallelism (the reference's one all-gather per step).
    On one device the params are whole already: ``params`` itself."""
    rules = {k: (tuple(a for a in v if a != "data") or None) if v else v
             for k, v in PARAM_RULES.items()}
    return _constrain_tree(params, axes_tree, rules, "unfsdp_params")


def refsdp_params(tree, axes_tree):
    """Constrain a grad tree back to the full param sharding (undo the
    unfsdp gather for the accumulation buffer): ``tree`` itself on one
    device."""
    return _constrain_tree(tree, axes_tree, PARAM_RULES, "refsdp_params")


def device_put(tree, shardings):
    """The counterpart of ``jax.device_put(tree, shardings)``: each leaf
    placed by its sharding.  On a mesh over one device every leaf goes
    there whole (the same tensor when it is there already)."""

    def place(x, sh):
        require_one_device(sh.mesh, "device_put")
        sh.shard_shape(x.shape)  # the spec must fit the leaf
        return x.to(sh.mesh.distinct_devices[0])

    return tree_map(place, tree, shardings)


def shard_bytes(tree, shardings) -> int:
    """Bytes one mesh position holds of ``tree`` under ``shardings``: each
    leaf's shard shape times its item size (every position holds a block
    of the same shape)."""
    return sum(leaves(tree_map(
        lambda x, sh: math.prod(sh.shard_shape(x.shape)) * x.element_size(), tree, shardings)))
