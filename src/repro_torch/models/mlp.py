"""Dense MLP blocks (SwiGLU / GELU / squared-ReLU)."""
from __future__ import annotations

from repro_torch.models.common import ParamSpec
from repro_torch.models.layers import activation
from repro_torch.sharding.rules import shard_constraint


def mlp_specs(cfg, d: int, d_ff: int):
    pd = cfg.param_dtype
    sp = {
        "w_up": ParamSpec((d, d_ff), pd, ("embed", "ffn"), "scaled"),
        "w_down": ParamSpec((d_ff, d), pd, ("ffn", "embed"), "scaled"),
    }
    if cfg.act == "swiglu":
        sp["w_gate"] = ParamSpec((d, d_ff), pd, ("embed", "ffn"), "scaled")
    return sp


def mlp_apply(cfg, p, x):
    """x (B, S, d) -> (B, S, d) in x's dtype."""
    h = x @ p["w_up"]
    gate = x @ p["w_gate"] if cfg.act == "swiglu" else None
    h = shard_constraint(activation(cfg.act, h, gate), ("batch", None,
                                                         "ffn_act"))
    return (h @ p["w_down"]).to(x.dtype)
