"""Minimal pytrees with JAX's flatten order.

Gradients are nested dicts of tensors.  The compiled sync program is
cached per tree structure and its inputs are the leaves in flatten order,
so the order must be the reference's: dict keys sorted, lists and tuples
in order, ``None`` an empty node.  Everything else is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable

PyTree = Any


def _children(t):
    if isinstance(t, dict):
        keys = tuple(sorted(t))
        return ("dict", keys), [t[k] for k in keys]
    if isinstance(t, (list, tuple)):
        return (type(t).__name__, len(t)), list(t)
    if t is None:
        return ("none", 0), []
    return None, None


def tree_flatten(t: PyTree) -> tuple[list, tuple]:
    """``(leaves, treedef)``; ``treedef`` is hashable and only
    describes the structure."""
    leaves: list = []

    def walk(node):
        kind, kids = _children(node)
        if kind is None:
            leaves.append(node)
            return "*"
        return (kind, tuple(walk(k) for k in kids))

    return leaves, walk(t)


def tree_unflatten(treedef: tuple, leaves) -> PyTree:
    it = iter(leaves)

    def build(d):
        if d == "*":
            return next(it)
        (kind, meta), kids = d
        vals = [build(k) for k in kids]
        if kind == "dict":
            return dict(zip(meta, vals))
        if kind == "list":
            return vals
        if kind == "tuple":
            return tuple(vals)
        return None

    out = build(treedef)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree structure holds")
    return out


_END = object()


def tree_leaves(t: PyTree) -> list:
    return tree_flatten(t)[0]


def tree_map(fn: Callable, t: PyTree, *rest: PyTree) -> PyTree:
    leaves, td = tree_flatten(t)
    others = []
    for r in rest:
        ls, rd = tree_flatten(r)
        if rd != td:
            raise ValueError("tree_map over trees of different structure")
        others.append(ls)
    return tree_unflatten(td, [fn(*xs) for xs in zip(leaves, *others)])
