"""Party-plane parameter partition, over nested dicts of tensors.

The cascade's party boundary is a functional split of the parameter tree:
``client`` subtree(s) are updated with ZOO, the ``server`` subtree with
FOO. For the paper's tabular experiments the clients are a stacked
(M, ...) tree of per-client feature extractors.

For an LM config the clients own the token embedding (``LM_CLIENT_KEYS``)
and the server everything else; :func:`lm_engine_params` maps a global
model tree into that engine layout.

A tree here is a nested ``dict`` whose leaves are tensors
(``repro_torch.tree``: sorted-key traversal, as JAX flattens a dict).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["LM_CLIENT_KEYS", "lm_engine_params", "merge_params",
           "split_params", "tree_dim", "tree_flat_norm", "tree_leaves",
           "tree_map", "tree_unflatten"]

# top-level param keys forming the ZOO client partition of an LM config
# (matches model_api.Model.client_keys for the supported families)
LM_CLIENT_KEYS = ("embed",)


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


def lm_engine_params(global_params: Dict, n_clients: int) -> Dict:
    """Map a global ``build_model`` parameter tree into the engine layout.

    Every client party receives the same copy of the embedding table (the
    replicated bottom layer), stacked along a leading (M,) clients axis;
    the server keeps everything else (minus the token-consuming MTP head)
    as the same tensors, uncopied."""
    client, server = split_params(global_params, LM_CLIENT_KEYS)
    clients = tree_map(
        lambda w: w.unsqueeze(0).repeat((n_clients,) + (1,) * w.ndim),
        client)
    server = {k: v for k, v in server.items() if k != "mtp"}
    return {"clients": clients, "server": server}
