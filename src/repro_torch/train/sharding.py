"""Logical-axis sharding rules (MaxText-style) with divisibility fallback,
placement on a mesh, and the collectives of the SPMD train step.

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
shard shape and slices (:meth:`NamedSharding.shard_index`, the layout of
``jax.sharding.NamedSharding.devices_indices_map``).  One process holds
the pool.  :func:`device_put` places a leaf as a :class:`Sharded`: one
tensor per mesh position, on that position's device, whether or not two
positions name one device (as forced host devices hold separate buffers).
The collectives are plain functions over placed leaves, each run by the
one controller in position order, so their bits do not depend on
scheduling: :func:`gather_block` (a block built on a device from the
stored blocks that meet it), :func:`gather` (all-gather), :func:`reshard`
(what :func:`unfsdp_params` and :func:`refsdp_params` do to placed leaves;
each position's new block is built on its own device) and
:func:`reduce_scatter`.  The train step that uses them is
``configs/common.py::ArchSpec.make_train_step``: each data group
(:func:`batch_groups`, :func:`group_positions`) computes over its
"model" positions with the blocks of :func:`compute_sharding`, splitting
its products there (``train/tp.py``), and the gradients go back to the
positions' shards by the plan of :func:`grad_sources` and
:func:`reduce_scatter_plan`, a plain function of the mesh.
:func:`constrain` checks its spec and returns its input: the model code
splits at the reference's constrain sites itself.
"""
from __future__ import annotations

import collections
import contextlib
import math
import threading

import numpy as np
import torch

from repro_torch.tree import leaves, tree_map

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

# the params' rules without the fsdp factor (``unfsdp_params``)
UNFSDP_RULES: dict[str, tuple] = {k: (tuple(a for a in v if a != "data") or None) if v else v
                                  for k, v in PARAM_RULES.items()}

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

    def shard_index(self, position, global_shape) -> tuple:
        """The slices of an array of ``global_shape`` that the mesh
        position ``position`` (an index into ``mesh.devices``) holds:
        ``slice(None)`` on a dim held whole; a dim split over several mesh
        axes is cut in row-major order of those axes, as
        ``jax.sharding.NamedSharding.devices_indices_map`` cuts it."""
        block = self.shard_shape(global_shape)
        coords = dict(zip(self.mesh.axis_names, position))
        out = []
        for i, n in enumerate(block):
            entry = self.spec[i] if i < len(self.spec) else None
            if self._ways(entry) == 1:
                out.append(slice(None))
                continue
            k = 0
            for a in entry if isinstance(entry, tuple) else (entry,):
                k = k * self.mesh.shape[a] + coords[a]
            out.append(slice(k * n, (k + 1) * n))
        return tuple(out)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def positions(mesh: Mesh):
    """Every position of ``mesh`` (an index into ``mesh.devices``), in
    row-major order."""
    return np.ndindex(mesh.devices.shape)


class Sharded:
    """A leaf placed on a mesh: the global shape and dtype, the
    :class:`NamedSharding`, and ``shards``, an object ``ndarray`` of the
    mesh's shape holding one tensor per position on that position's
    device.  No two positions share a tensor or its storage."""

    def __init__(self, shape, dtype, sharding: NamedSharding, shards: np.ndarray):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.sharding = sharding
        self.shards = shards

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def element_size(self) -> int:
        return torch.empty((), dtype=self.dtype, device="meta").element_size()

    def __repr__(self):
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, {self.sharding.spec!r}, "
                f"{self.shards.size} shards)")


def _block(whole: torch.Tensor, index, device) -> torch.Tensor:
    """A new tensor on ``device`` holding ``whole[index]``."""
    part = whole[index]
    return torch.empty(tuple(part.shape), dtype=whole.dtype, device=device).copy_(part)


def reduce_scatter(whole: torch.Tensor, sharding: NamedSharding) -> Sharded:
    """``whole`` (the summed tensor) split back into each position's block
    by ``sharding``, position by position."""
    mesh = sharding.mesh
    shards = np.empty(mesh.devices.shape, dtype=object)
    for pos in positions(mesh):
        shards[pos] = _block(whole, sharding.shard_index(pos, whole.shape), mesh.devices[pos])
    return Sharded(whole.shape, whole.dtype, sharding, shards)


def region(index, shape) -> tuple:
    """A tuple of slices as ``(start, stop)`` per dim of ``shape``."""
    return tuple(s.indices(n)[:2] for s, n in zip(index, shape))


def overlap(a: tuple, b: tuple):
    """The part of region ``b`` inside region ``a``, as slices relative to
    ``a`` and to ``b``; ``None`` when they do not meet."""
    rel_a, rel_b = [], []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi and (a1 > a0 or b1 > b0):
            return None
        rel_a.append(slice(lo - a0, hi - a0))
        rel_b.append(slice(lo - b0, hi - b0))
    return tuple(rel_a), tuple(rel_b)


def gather_block(x, index, device) -> torch.Tensor:
    """``x[index]`` on ``device``: each distinct stored block that meets
    it copied there once, in position order, from the first position that
    holds it (a gather over the axes ``index`` does not split).  A plain
    tensor is cut and moved."""
    if not isinstance(x, Sharded):
        return x[index].to(device)
    want = region(index, x.shape)
    out = torch.empty(tuple(b - a for a, b in want), dtype=x.dtype, device=device)
    for have, pos in _holders(x.sharding, tuple(x.shape)).items():
        hit = overlap(want, have)
        if hit is not None:
            out[hit[0]].copy_(x.shards[pos][hit[1]])
    return out


def _holders(sharding: NamedSharding, shape: tuple) -> dict:
    """Each distinct stored block (its region) -> the first position, in
    position order, that holds it (kept on the sharding, by shape)."""
    tables = sharding.__dict__.setdefault("_holders", {})
    if shape not in tables:
        table = {}
        for pos in positions(sharding.mesh):
            table.setdefault(region(sharding.shard_index(pos, shape), shape), pos)
        tables[shape] = table
    return tables[shape]


def gather(x, device) -> torch.Tensor:
    """The whole of ``x`` on ``device`` (an all-gather): each distinct
    block copied once, from the first position that holds it.  A plain
    tensor is moved there."""
    return gather_block(x, (slice(None),) * len(x.shape), device)


def reshard(x: Sharded, sharding: NamedSharding) -> Sharded:
    """``x`` placed by another sharding on its mesh: each position's new
    block built on its own device from the stored blocks that meet it
    (no device gathers the whole)."""
    mesh = sharding.mesh
    shards = np.empty(mesh.devices.shape, dtype=object)
    for pos in positions(mesh):
        shards[pos] = gather_block(x, sharding.shard_index(pos, x.shape), mesh.devices[pos])
    return Sharded(x.shape, x.dtype, sharding, shards)


def compute_sharding(sharding: NamedSharding) -> NamedSharding:
    """What a position computes with once the batch axes' factor of its
    params is gathered (the reference's ``unfsdp_params``): the spec with
    only its "model" entries left."""
    def keep(entry):
        names = entry if isinstance(entry, tuple) else (entry,)
        kept = tuple(a for a in names if a == "model")
        return None if not kept else kept[0]

    return NamedSharding(sharding.mesh, P(*(None if e is None else keep(e)
                                            for e in sharding.spec)))


def model_split_dim(sharding: NamedSharding) -> int | None:
    """The dim that "model" splits under ``sharding`` (``None``: held
    whole over "model", or a "model" axis of one)."""
    if sharding.mesh.shape.get("model", 1) == 1:
        return None
    return model_entry(sharding.spec)


def model_entry(spec) -> int | None:
    """The index of the entry of ``spec`` that names "model", if any."""
    for i, entry in enumerate(spec):
        if entry == "model" or (isinstance(entry, tuple) and "model" in entry):
            return i
    return None


def group_positions(mesh: Mesh, axes) -> list:
    """For each data group (the batch split over ``axes`` in row-major
    order), its positions along "model", in order: the group's coordinate
    on ``axes``, 0 on every other axis but "model"."""
    sizes = mesh.shape
    G = math.prod(sizes[a] for a in axes)
    out = []
    for g in range(G):
        coords, rest = {}, g
        for a in reversed(axes):
            coords[a] = rest % sizes[a]
            rest //= sizes[a]
        out.append([tuple(m if a == "model" else coords.get(a, 0) for a in mesh.axis_names)
                    for m in range(sizes.get("model", 1))])
    return out


def grad_sources(sharding: NamedSharding, shape, groups, group_devs) -> list:
    """The gradient blocks of one leaf that devices accumulate in a step:
    ``(region, device)`` pairs, each a block of the leaf as the positions
    compute with it (:func:`compute_sharding`) summed over the groups that
    ``device`` runs, in group then position order.  ``groups[g]`` are
    group ``g``'s positions along "model" and ``group_devs[g]`` their
    devices."""
    view = compute_sharding(sharding)
    split = model_split_dim(sharding)
    out = []
    for row, devs in zip(groups, group_devs):
        for m, pos in enumerate(row):
            if split is None and m:
                break
            src = (region(view.shard_index(pos, shape), shape), devs[m])
            if src not in out:
                out.append(src)
    return out


def reduce_scatter_plan(sharding: NamedSharding, shape, sources) -> list:
    """The transfers that reduce-scatter one leaf's gradient: for every
    position in position order, ``(position, device, [(source device,
    source region, slices into the source), ...])``, the pieces that
    position sums in that order.  Each piece goes from the device that
    accumulated it straight to the position's device."""
    plan = []
    for pos in positions(sharding.mesh):
        want = region(sharding.shard_index(pos, shape), shape)
        pieces = []
        for reg, dev in sources:
            hit = overlap(reg, want)
            if hit is not None and all(
                    (s.stop - s.start) == (b - a) for s, (a, b) in zip(hit[0], want)):
                pieces.append((dev, reg, hit[0]))
        plan.append((pos, sharding.mesh.devices[pos], pieces))
    return plan


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
    mesh: ``x`` itself, after checking the spec (the model code splits a
    data group's products at the reference's constrain sites itself,
    ``train/tp.py``)."""
    mesh = active_mesh()
    if mesh is None:
        return x
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


def _param_tree(tree, axes_tree, rules):
    """Placed leaves of ``tree`` resharded by ``rules`` on their mesh; a
    tree of plain tensors checked against the active mesh and returned as
    it is (whole tensors hold every layout)."""
    if not any(isinstance(x, Sharded) for x in leaves(tree)):
        mesh = active_mesh()
        if mesh is not None:
            tree_map(lambda x, ax: _checked(x, ax, rules, mesh), tree, axes_tree)
        return tree

    def one(x, ax):
        mesh = x.sharding.mesh
        return reshard(x, NamedSharding(mesh, _checked(x, ax, rules, mesh)))

    return tree_map(one, tree, axes_tree)


def unfsdp_params(params, axes_tree):
    """Drop the fsdp ("data") factor from every param's sharding while
    keeping tensor parallelism (the reference's one all-gather per step):
    placed params resharded, plain tensors (whole) returned as they are."""
    return _param_tree(params, axes_tree, UNFSDP_RULES)


def refsdp_params(tree, axes_tree):
    """Constrain a grad tree back to the full param sharding (undo the
    unfsdp gather for the accumulation buffer): placed leaves resharded,
    plain tensors returned as they are."""
    return _param_tree(tree, axes_tree, PARAM_RULES)


def device_put(tree, shardings):
    """The counterpart of ``jax.device_put(tree, shardings)``: each leaf
    placed by its sharding as a :class:`Sharded`, every position's block a
    tensor of its own on its device (a placed leaf is resharded)."""

    def place(x, sh):
        if isinstance(x, Sharded):
            return reshard(x, sh)
        return reduce_scatter(x, sh)

    return tree_map(place, tree, shardings)


def sharding_tree(tree):
    """The :class:`NamedSharding` of every placed leaf of ``tree``."""
    return tree_map(lambda x: x.sharding, tree)


def shard_bytes(tree, shardings) -> int:
    """Bytes one mesh position holds of ``tree`` under ``shardings``: each
    leaf's shard shape times its item size (every position holds a block
    of the same shape)."""
    return sum(leaves(tree_map(
        lambda x, sh: math.prod(sh.shard_shape(x.shape)) * x.element_size(), tree, shardings)))


def held_bytes(tree, position) -> int:
    """Bytes of storage the tensors of mesh position ``position`` really
    hold, summed over the placed leaves of ``tree``."""
    return sum(x.shards[position].untyped_storage().nbytes() for x in leaves(tree))


def batch_groups(mesh: Mesh, batch_size: int) -> tuple:
    """``(axes, G)``: the mesh axes the reference keeps for a batch dim of
    ``batch_size`` under ``ACT_RULES["batch"]`` (an axis that does not
    divide it is dropped), and the number of data groups, their product."""
    entry = _resolve((batch_size,), ("batch",), ACT_RULES, mesh)[0]
    axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
    return axes, math.prod(mesh.shape[a] for a in axes)


def group_devices(devices: np.ndarray, axis_names, axes) -> list:
    """The device each data group runs on.  The batch is split over the
    mesh axes ``axes`` in row-major order; group ``g`` holds the positions
    whose coordinates on ``axes`` number ``g``, and runs on device
    ``g mod n`` of the ``n`` distinct devices of those positions (position
    order): over a pool of P distinct cards each runs ceil(G / P) groups."""
    sizes = dict(zip(axis_names, devices.shape))
    rows = [[] for _ in range(math.prod(sizes[a] for a in axes))]
    for pos in np.ndindex(devices.shape):
        coords = dict(zip(axis_names, pos))
        g = 0
        for a in axes:
            g = g * sizes[a] + coords[a]
        rows[g].append(devices[pos])
    out = []
    for g, row in enumerate(rows):
        distinct = list(dict.fromkeys(row))
        out.append(distinct[g % len(distinct)])
    return out
