"""The paper's base experiment model (§VI-A-b): MLP over vertically
partitioned tabular features.

* M clients, each a single FC layer: c_m = relu(x_m @ W_m + b_m)
  (client params stacked along a leading M axis).
* server: two FC layers over the concatenation [c_1 .. c_M].

Every function broadcasts over leading batch dims (the engine's client
block and ZOO lane axes), where the JAX package used ``vmap``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.models.common import ParamSpec


def param_specs(cfg: PaperMLPConfig):
    f, e = cfg.features_per_client, cfg.client_embed
    M, se, C = cfg.n_clients, cfg.server_embed, cfg.n_classes
    return {
        "clients": {
            "w": ParamSpec((M, f, e), "float32",
                           ("clients", None, None), "scaled"),
            "b": ParamSpec((M, e), "float32", ("clients", None), "zeros"),
        },
        "server": {
            "w1": ParamSpec((M * e, se), "float32", (None, None), "scaled"),
            "b1": ParamSpec((se,), "float32", (None,), "zeros"),
            "w2": ParamSpec((se, C), "float32", (None, None), "scaled"),
            "b2": ParamSpec((C,), "float32", (None,), "zeros"),
        },
    }


CLIENT_KEYS = ("clients",)


def client_forward(client_m, x_m):
    """client_m: {w (..., f, e), b (..., e)}; x_m (..., B, f) ->
    (..., B, e)."""
    return torch.relu(x_m @ client_m["w"] + client_m["b"].unsqueeze(-2))


def all_clients_forward(clients, x_parts):
    """clients stacked (M, ...), x_parts (M, B, f) -> (M, B, e)."""
    return client_forward(clients, x_parts)


def server_forward(server, c_all):
    """c_all (..., M, B, e) -> logits (..., B, C)."""
    *lead, M, B, e = c_all.shape
    h = c_all.transpose(-3, -2).reshape(*lead, B, M * e)
    h = torch.relu(h @ server["w1"] + server["b1"])
    return h @ server["w2"] + server["b2"]


def xent(logits, labels):
    """Mean cross-entropy over the batch: logits (..., B, C), labels (B,)
    int64 -> (...)."""
    lse = torch.logsumexp(logits, dim=-1)
    index = labels.unsqueeze(-1).expand(*logits.shape[:-1], 1)
    gold = torch.gather(logits, -1, index).squeeze(-1)
    return torch.mean(lse - gold, dim=-1)


def global_loss(params, batch):
    """Synchronous global loss (Split-Learning view of the same model)."""
    x_parts, y = batch["x_parts"], batch["y"]
    c = all_clients_forward(params["clients"], x_parts)
    logits = server_forward(params["server"], c)
    return xent(logits, y), {"logits": logits}


def accuracy(params, x_parts, y):
    c = all_clients_forward(params["clients"], x_parts)
    logits = server_forward(params["server"], c)
    return torch.mean((torch.argmax(logits, -1) == y).float())
