"""Nested-dict trees of tensors: the port's stand-in for JAX's pytrees.

A tree is a nested ``dict`` whose leaves are tensors (or specs). Every
traversal visits keys in sorted order, the order in which JAX flattens a
dict, so a leaf's position (which the draw sources rely on) is the same in
both packages. This module imports nothing of the package, so any module
may use it without an import cycle.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree) -> List[Any]:
    """Leaves in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of ``tree`` and ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_unflatten(template, leaves: List[Any]):
    """Rebuild ``template``'s structure from leaves in sorted-key order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out
