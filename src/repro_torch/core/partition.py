"""Party-plane parameter partition, over nested dicts of tensors.

The cascade's party boundary is a functional split of the parameter tree:
``client`` subtree(s) are updated with ZOO, the ``server`` subtree with
FOO. For the paper's tabular experiments the clients are a stacked
(M, ...) tree of per-client feature extractors.

A tree here is a nested ``dict`` whose leaves are tensors. Every traversal
visits keys in sorted order, the order in which JAX flattens a dict, so a
leaf's position (which the draw sources rely on) is the same in both
packages.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import torch


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


def split_params(params: Dict, client_keys: Tuple[str, ...]
                 ) -> Tuple[Dict, Dict]:
    client = {k: v for k, v in params.items() if k in client_keys}
    server = {k: v for k, v in params.items() if k not in client_keys}
    return client, server


def merge_params(client: Dict, server: Dict) -> Dict:
    out = dict(server)
    out.update(client)
    return out


def tree_dim(tree) -> int:
    """Total parameter dimension d of a partition (ZOO's d_m)."""
    return int(sum(math.prod(x.shape) for x in tree_leaves(tree)))


def tree_flat_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    return torch.sqrt(sq)
