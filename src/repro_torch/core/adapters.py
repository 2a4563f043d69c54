"""Model adapters: the async engine's protocol for client/server pairs.

The asynchronous protocol simulation (``repro_torch.core.async_engine``)
needs three things from a model: a per-client feature extractor, a
server loss over the stacked client embeddings, and (optionally) a fused
"lanes" forward that evaluates the clean + q ZOO-perturbed client
forwards in one pass. Packaging those as a :class:`ModelAdapter` lets the
same engine drive any client/server pair; this slice ships the paper's
tabular MLP.

Where the JAX engine ``vmap``-ed an adapter's hooks over the activated
client block, the port calls them once with the block written out as
leading batch dims, so every hook broadcasts over leading dims.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.analysis import tags
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.kernels.zoo_dual_matmul.ops import zoo_dual_matmul_stacked
from repro_torch.models import common, tabular


@dataclasses.dataclass(frozen=True)
class ModelAdapter:
    """Protocol bridging one model family into the async VFL engine.

    * ``client_forward(client, x)``           -> (..., bs, e) embedding;
      params and inputs share any leading dims (clients, block rows, lanes)
    * ``server_loss(server, c_all, y_batch)`` -> loss over the (..., M, bs,
      e) table slice of all client embeddings, one per leading index
    * ``param_specs()``                       -> {"clients": stacked
      (M, ...) specs, "server": specs} for ``common.materialize``
    * ``client_lanes(client_blk, u_stack, mu, x_blk)`` (optional) ->
      (R, 1+q, bs, e) for R block rows: lane 0 the clean forward, lanes
      1..q the μ-perturbed forwards — the hook that routes the stacked ZOO
      fan-out through a fused kernel.
    * ``row_mask(client_blk, x_blk)`` (optional) -> 0/1 row-mask tree
      matching the client params, each leaf (R, rows): restricts the ZOO
      perturbation to the rows a batch actually touches.
    """
    name: str
    client_forward: Callable
    server_loss: Callable
    param_specs: Callable
    client_lanes: Optional[Callable] = None
    row_mask: Optional[Callable] = None

    def init_params(self, generator: torch.Generator, device=None):
        return common.materialize(self.param_specs(), generator,
                                  device=device)

    @tags.wire("up", accounted_by="Transport.account", kind="embedding",
               reason="Split-Learning oracle: fresh client embeddings "
                      "uploaded every step; the sync cascade meters it "
                      "per round")
    def global_loss(self, params, x_parts, y_batch):
        """Synchronous view: every client fresh, one loss (Split-Learning)."""
        c = self.client_forward(params["clients"], x_parts)
        return self.server_loss(params["server"], c, y_batch)


# ========================================================== paper tabular ==

def tabular_adapter(cfg: Optional[PaperMLPConfig] = None,
                    *, use_kernel_lanes: bool = False) -> ModelAdapter:
    """The paper's §VI-A-b MLP (single-FC clients, two-FC server).

    ``use_kernel_lanes=True`` computes the clean + q perturbed client
    forwards of the whole activated block through the fused
    ``zoo_dual_matmul_stacked`` CUDA kernel with the bias+ReLU epilogue in
    the same launch (the plain version on CPU tensors); the default
    composes the same lanes with plain PyTorch ops.
    """
    cfg = cfg or PaperMLPConfig()

    @tags.party("server")
    def server_loss(server, c_all, y_batch):
        return tabular.xent(tabular.server_forward(server, c_all), y_batch)

    @tags.party("client")
    def client_lanes(client_blk, u_stack, mu, x_blk):
        """client_blk {w (R, f, e), b (R, e)}, u_stack {w (R, q, f, e),
        b (R, q, e)}, x_blk (R, bs, f) -> (R, 1+q, bs, e)."""
        w, b = client_blk["w"], client_blk["b"]
        if use_kernel_lanes:
            clean, pert = zoo_dual_matmul_stacked(
                x_blk, w, u_stack["w"], mu, b=b.float(),
                ub=u_stack["b"].float())
        else:
            y = x_blk @ w
            y_hat = y.unsqueeze(1) + mu * torch.einsum(
                "rbf,rqfe->rqbe", x_blk, u_stack["w"])
            clean = torch.relu(y + b.unsqueeze(-2))
            pert = torch.relu(
                y_hat + (b.unsqueeze(1) + mu * u_stack["b"]).unsqueeze(-2))
        return torch.cat([clean.unsqueeze(1), pert], dim=1)

    return ModelAdapter(
        name="tabular-kernel" if use_kernel_lanes else "tabular",
        client_forward=tabular.client_forward,
        server_loss=server_loss,
        param_specs=lambda: tabular.param_specs(cfg),
        client_lanes=client_lanes,
    )
