"""Nested containers of tensors (the port's counterpart of a JAX pytree).

Parameter, gradient and optimizer trees are dicts of dicts of tensors.
:func:`leaves` visits a dict's keys in sorted order, as
``jax.tree.flatten`` does, so the i-th leaf of a port tree and of the
reference's tree of the same structure are the same array (a checkpoint
written by either package restores into the other's tree).  Lists and
tuples are visited in order; ``None`` holds no leaf.
"""
from __future__ import annotations

from typing import Any, Callable


def leaves(tree) -> list:
    """The tree's leaves, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in leaves(x)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result has ``tree``'s."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return None if tree is None else fn(tree, *rest)


def unflatten(like, flat: list) -> Any:
    """A tree of ``like``'s structure holding ``flat`` (in :func:`leaves`
    order)."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            got = {k: build(t[k]) for k in sorted(t)}
            return {k: got[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return None if t is None else next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def structure(tree) -> str:
    """The tree's structure as a string: dict keys in sorted order, ``*``
    for a leaf."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        o, c = ("[", "]") if isinstance(tree, list) else ("(", ")")
        return o + ", ".join(structure(x) for x in tree) + c
    return "None" if tree is None else "*"
