"""Trees of tensors: the port's stand-in for JAX's pytrees.

A tree is a nested ``dict``, ``tuple`` or ``list`` whose leaves are
tensors (or specs). Every traversal visits a dict's keys in sorted order
and a tuple's or list's elements in position order, the order in which
JAX flattens them, so a leaf's position (which the draw sources rely on)
is the same in both packages. ``tree_map`` keeps each container's type:
the hybrid family's cache is the tuple ``(ssm_states, attn_caches)`` in
both packages. This module imports nothing of the package, so any module
may use it without an import cycle.
"""
from __future__ import annotations

from typing import Any, Callable, List

_SEQUENCES = (tuple, list)


def tree_leaves(tree) -> List[Any]:
    """Leaves in sorted-key / position order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, _SEQUENCES):
        return [leaf for child in tree for leaf in tree_leaves(child)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of ``tree`` and ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, _SEQUENCES):
        for r in rest:
            if len(r) != len(tree):
                raise ValueError(f"trees differ in length: {len(tree)} and "
                                 f"{len(r)}")
        return type(tree)(tree_map(fn, child, *(r[i] for r in rest))
                          for i, child in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(template, leaves: List[Any]):
    """Rebuild ``template``'s structure from leaves in traversal order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out
