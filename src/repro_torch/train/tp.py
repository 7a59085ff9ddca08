"""Tensor parallelism over a mesh's "model" axis, in compute.

Under the SPMD train step (``configs/common.py::spmd_step``) a data group
whose mesh has a "model" axis of ``M > 1`` positions runs every product
that the reference constrains split over those positions: each position
computes its share with the params it holds once the "data" factor is
gathered (the reference's ``unfsdp_params``), and the shares meet in
explicit collectives.  The split at each site is the reference's: the
activation's logical axes (``train/sharding.py::attn_axes`` and the
constants at each call) resolved by :func:`model_dim` with
``sharding._resolve`` against ``ACT_RULES``, so a site computes whole
exactly where the rule drops "model" because the dimension does not
divide.

* A param leaf that the step splits over "model" reaches the model code as
  a :class:`Split`: one part per position, on that position's device, cut
  along one dim.  A leaf held whole over "model" is a plain tensor on the
  group's home device (its first position's).
* :func:`use_group` installs a group's positions for the model code (a
  module variable, so that autograd's device thread, which runs remat's
  recompute, sees it as well); :func:`active` reads it.
* The residual stream, the norms and whatever a site computes whole stay
  on the home device.  A position's share runs on its device inside
  :meth:`Group.at`, which the dry run reads to count one position's FLOPs.
* The collectives run in position order on the home device, so two runs
  give the same bits: :func:`psum` (partial products summed, an
  all-reduce), :func:`gather` (parts concatenated, an all-gather; its
  backward is a reduce-scatter) and :func:`take` (a param's columns cut
  from the parts that hold them, an all-to-all).  Each notes its bytes in
  a :func:`recording` context, forward and backward.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.train import sharding as shd


class Split:
    """A param leaf cut over the model positions of a data group:
    ``parts[m]`` is position ``m``'s block of dim ``dim`` of the global
    ``shape``, on that position's device."""

    def __init__(self, parts, dim: int, shape=None):
        self.parts = list(parts)
        self.dim = dim
        if shape is None:
            shape = list(self.parts[0].shape)
            shape[dim] = sum(p.shape[dim] for p in self.parts)
        self.shape = torch.Size(shape)

    @property
    def requires_grad(self) -> bool:
        return any(p.requires_grad for p in self.parts)

    def unbind(self) -> list:
        """The leaf's layers (dim 0, a stacking dim held whole)."""
        if self.dim == 0:
            raise ValueError("a Split is unbound along a dim held whole")
        shape = tuple(self.shape[1:])
        per = [torch.unbind(p) for p in self.parts]
        return [Split([rows[i] for rows in per], self.dim - 1, shape)
                for i in range(self.shape[0])]

    def __repr__(self):
        return f"Split({tuple(self.shape)}, dim={self.dim}, {len(self.parts)} parts)"


# -- the group's positions ----------------------------------------------------
class Group:
    """The model positions of one data group: ``devices[m]`` runs position
    ``m``; ``home`` (position 0's device) holds the residual stream."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        self.M = len(self.devices)
        self.home = self.devices[0]
        self.mesh = shd.Mesh(np.asarray(self.devices, dtype=object), ("model",))

    @contextlib.contextmanager
    def at(self, m: int):
        """Position ``m``'s share is computed inside."""
        global _POS
        prev, _POS = _POS, m
        try:
            yield self.devices[m]
        finally:
            _POS = prev


_GROUP: Group | None = None
_POS: int | None = None
_RECORD: dict | None = None


@contextlib.contextmanager
def use_group(group: Group | None):
    """Install ``group`` for the model code (``None``: compute whole)."""
    global _GROUP
    prev, _GROUP = _GROUP, group
    try:
        yield group
    finally:
        _GROUP = prev


def active() -> Group | None:
    return _GROUP


def current_position() -> int | None:
    """The position whose share is being computed (``None`` at home)."""
    return _POS


@contextlib.contextmanager
def recording():
    """Collect the collectives run inside: kind -> [bytes a position's
    output holds, number of ops], forward and backward."""
    global _RECORD
    prev, _RECORD = _RECORD, {}
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def note(kind: str, t: torch.Tensor):
    if _RECORD is not None:
        entry = _RECORD.setdefault(kind, [0, 0])
        entry[0] += t.numel() * t.element_size()
        entry[1] += 1


# -- where "model" splits an activation -----------------------------------------
def model_dim(shape, axes, group: Group | None = None) -> int | None:
    """The dim of an activation of ``shape`` with logical ``axes`` that
    the group's "model" axis splits under ``ACT_RULES`` (``None``: held
    whole), as ``sharding._resolve`` resolves it."""
    group = group or _GROUP
    if group is None or group.M == 1:
        return None
    return shd.model_entry(shd._resolve(tuple(shape), tuple(axes), shd.ACT_RULES, group.mesh))


def attn_split(n_heads: int, shape, group: Group | None = None) -> int | None:
    """Where "model" splits ``[B, S, H, D]`` attention activations:
    dim 2 (heads), dim 1 (``seq_sharded``, when the heads do not divide)
    or ``None``."""
    group = group or _GROUP
    if group is None or group.M == 1:
        return None
    ax = ("batch", None, "heads", None) if n_heads % group.M == 0 else \
        ("batch", "seq_sharded", None, None)
    return model_dim(shape, ax, group)


# -- collectives, in position order ---------------------------------------------
class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, home, *parts):
        ctx.devices = [p.device for p in parts]
        wide = torch.promote_types(parts[0].dtype, torch.float32)
        out = parts[0].to(device=home, dtype=wide)
        for p in parts[1:]:
            out = out + p.to(device=home, dtype=wide)
        out = out.to(parts[0].dtype)
        note("all-reduce", out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return (None,) + tuple(grad.to(d) for d in ctx.devices)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, home, kinds, *parts):
        ctx.dim, ctx.kinds = dim, kinds
        ctx.devices = [p.device for p in parts]
        ctx.sizes = [p.shape[dim] for p in parts]
        out = torch.cat([p.to(home) for p in parts], dim=dim)
        note(kinds[0], out)
        return out

    @staticmethod
    def backward(ctx, grad):
        pieces = torch.split(grad, ctx.sizes, dim=ctx.dim)
        note(ctx.kinds[1], pieces[0])
        return (None, None, None) + tuple(g.to(d) for g, d in zip(pieces, ctx.devices))


def psum(parts, home=None) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` on ``home`` (default the group's), in
    position order: the partial products of a row-split product, summed
    in float32 (at least) and rounded once to their dtype."""
    home = home if home is not None else _GROUP.home
    if len(parts) == 1:
        return parts[0].to(home)
    return _PSum.apply(home, *parts)


def gather(parts, dim: int, home=None) -> torch.Tensor:
    """The parts concatenated along ``dim`` on ``home``, in position order."""
    home = home if home is not None else _GROUP.home
    if len(parts) == 1:
        return parts[0].to(home)
    return _Gather.apply(dim, home, ("all-gather", "reduce-scatter"), *parts)


def _ranges_of(leaf, dim):
    """``(start, stop, tensor)`` of each block of ``leaf`` along ``dim``."""
    if isinstance(leaf, Split) and leaf.dim == dim:
        out, start = [], 0
        for p in leaf.parts:
            out.append((start, start + p.shape[dim], p))
            start += p.shape[dim]
        return out
    t = whole(leaf)
    return [(0, t.shape[dim], t)]


def take(leaf, dim: int, ranges, device) -> torch.Tensor:
    """The global ``ranges`` (``(start, stop)`` pairs) of ``leaf``'s dim
    ``dim``, concatenated on ``device``, cut from the blocks that hold
    them in position order (differentiable; noted as an all-to-all of the
    whole cut, forward and backward, when it joins several pieces)."""
    dim = dim % len(leaf.shape)
    pieces = []
    for lo, hi in ranges:
        for start, stop, t in _ranges_of(leaf, dim):
            a, b = max(lo, start), min(hi, stop)
            if a < b:
                pieces.append(t.narrow(dim, a - start, b - a))
    if len(pieces) == 1 and pieces[0].device == torch.device(device):
        return pieces[0]
    return _Gather.apply(dim, torch.device(device), ("all-to-all", "all-to-all"), *pieces)


def whole(leaf) -> torch.Tensor:
    """The leaf whole on the home device (a :class:`Split`'s parts
    gathered; a plain tensor as it is)."""
    if not isinstance(leaf, Split):
        return leaf
    return gather(leaf.parts, leaf.dim, leaf.parts[0].device)


def whole_tree(tree):
    """:func:`whole` over a dict of leaves."""
    if isinstance(tree, dict):
        return {k: whole_tree(v) for k, v in tree.items()}
    return whole(tree)


def block(leaf, dim: int, m: int, M: int) -> torch.Tensor:
    """Position ``m``'s block of ``M`` along ``dim`` of ``leaf``, on its
    device: the part it holds when the leaf is split there, else cut."""
    dev = _GROUP.devices[m]
    dim = dim % len(leaf.shape)
    if isinstance(leaf, Split) and leaf.dim == dim and len(leaf.parts) == M:
        return leaf.parts[m]
    n = leaf.shape[dim] // M
    if not isinstance(leaf, Split):
        return leaf.narrow(dim, m * n, n).to(dev)
    return take(leaf, dim, [(m * n, (m + 1) * n)], dev)


def shares(n: int, M: int) -> list:
    """The ``(start, stop)`` of each of ``M`` equal shares of ``n``."""
    k = n // M
    return [(m * k, (m + 1) * k) for m in range(M)]


def flatten(leaves_) -> list:
    """The tensors of a list of leaves (a :class:`Split`'s parts in
    position order)."""
    return [t for x in leaves_ for t in (x.parts if isinstance(x, Split) else [x])]


def rebuild(leaves_, tensors) -> list:
    """``leaves_`` with their tensors replaced by ``tensors`` (in
    :func:`flatten`'s order)."""
    it = iter(tensors)
    out = []
    for x in leaves_:
        if isinstance(x, Split):
            out.append(Split([next(it) for _ in x.parts], x.dim, x.shape))
        else:
            out.append(next(it))
    return out


def describe(spec, reduced=False, M: int = 16) -> str:
    """How a "model" axis of ``M`` positions splits an arch's products in
    the train step, in a few words (the ``[mesh]`` line)."""
    cfg = spec.cfg(reduced)
    vocab = spec.init(None, reduced=reduced, device="meta")[0]["embed"]["table"].shape[0]

    def share(n, what):
        return f"{what} {n // M} a position" if n % M == 0 else f"{what} whole ({n} on {M})"

    words = []
    if spec.kind in ("mamba_lm", "hybrid"):
        mc = cfg.block_cfg if spec.kind == "mamba_lm" else cfg.mamba_cfg
        words.append(share(mc.n_heads, "mamba heads"))
    if spec.kind != "mamba_lm":
        mla = getattr(cfg, "mla", None)
        H = mla.n_heads if mla is not None else cfg.n_heads
        words.append(f"attention heads {H // M} a position" if H % M == 0 else
                     f"attention seq_sharded ({H} heads on {M}; where {M} divides the sequence)")
        moe = getattr(cfg, "moe", None)
        words.append(share(moe.n_experts, "experts") if moe is not None
                     else share(cfg.d_ff, "mlp columns"))
    words.append(share(vocab, "vocab rows"))
    return f"model axis {M}: " + ", ".join(words)
