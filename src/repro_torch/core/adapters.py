"""Model adapters: the async engine's protocol for client/server pairs.

The asynchronous protocol simulation (``repro_torch.core.async_engine``)
needs three things from a model: a per-client feature extractor, a
server loss over the stacked client embeddings, and (optionally) a fused
"lanes" forward that evaluates the clean + q ZOO-perturbed client
forwards in one pass. Packaging those as a :class:`ModelAdapter` lets the
same engine drive any client/server pair: the paper's tabular MLP, and
(via :func:`from_model_config`) the serve plane of a registered
decoder-only ``ModelConfig`` — the clients own the embedding, the server
the transformer backbone plus head.

Where the JAX engine ``vmap``-ed an adapter's hooks over the activated
client block, the port calls them once with the block written out as
leading batch dims, so every hook broadcasts over leading dims.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.analysis import tags
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core.partition import LM_CLIENT_KEYS, split_params
from repro_torch.kernels.zoo_dual_matmul.ops import zoo_dual_matmul_stacked
from repro_torch.models import common, model_api, tabular, transformer
from repro_torch.models.layers import apply_norm, embed_lookup, unembed


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

    Serve plane (optional — set by :func:`from_model_config`; tabular
    adapters have no decode concept and leave them ``None``):

    * ``client_embed(client_m, tokens)``  -> (bs, S, d): the owning party
      embeds its tokens — one call covers a single decode token (S = 1)
      or a whole prompt span (chunked prefill), its only serve-time
      uplink.
    * ``server_decode(server, x, caches, cur_pos)`` -> (logits, caches):
      backbone + head over the uploaded embedding; KV caches and logits
      never leave the server (the caches are updated in place).
    * ``server_prefill(server, x, caches, t0)`` -> (logits, caches):
      consume a whole (bs, chunk, d) span upload in one pass (positions
      t0 .. t0 + chunk) — the chunked-prefill hook.
    * ``cache_specs(batch, max_seq)``     -> decode-state spec tree.
    * ``server_decode_paged(server, x, caches, tables, cur_pos, active,
      page_size)`` -> (logits, caches): the continuous scheduler's batched
      step — every slot advances one token at its OWN position (``cur_pos``
      and ``active`` are (n_slots,) device tensors), the KV leaves are
      shared page pools addressed through ``tables``, and nothing syncs
      with the host.
    """
    name: str
    client_forward: Callable
    server_loss: Callable
    param_specs: Callable
    client_lanes: Optional[Callable] = None
    row_mask: Optional[Callable] = None
    client_embed: Optional[Callable] = None
    server_decode: Optional[Callable] = None
    server_prefill: Optional[Callable] = None
    cache_specs: Optional[Callable] = None
    server_decode_paged: Optional[Callable] = None

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


# ================================================= ModelConfig bridge =====

def from_model_config(cfg: ModelConfig, *, n_clients: int = 2,
                      seq_len: int = 32) -> ModelAdapter:
    """Derive the serve plane of a decoder-only ``ModelConfig``.

    The vertical split follows the paper's LM experiments: each of the M
    client parties owns a disjoint span of ``seq_len / M`` token positions
    plus its own copy of the embedding table (the bottom layer), and the
    server owns the backbone (for the hybrid family the Mamba2 trunk and
    the shared attention block), final norm and LM head. The
    serve hooks are the exact post-embedding half of
    ``transformer.forward``'s decode path, so split decode equals global
    decode. The async engine's training hooks (``client_forward``,
    ``client_lanes``, ``server_loss``, ``row_mask``) belong to the
    async-engine LM plane and raise ``NotImplementedError``; the sync
    training plane is ``Federation.sync_step``.
    """
    transformer.check_family(cfg)
    if n_clients < 1 or seq_len % n_clients:
        raise ValueError(
            f"seq_len={seq_len} must split evenly over "
            f"n_clients={n_clients} token spans")
    model = model_api.build_model(cfg, max_seq=seq_len)
    client_spec, server_spec = split_params(model.param_specs,
                                            LM_CLIENT_KEYS)

    def training_hook(*_args):
        raise NotImplementedError(
            "LM training through the async engine is not ported yet "
            "(ROADMAP.md, Queue 1 item 10, the async-engine LM plane); this "
            "adapter serves only — LM training runs through "
            "Federation.sync_step and launch/train.py")

    def param_specs():
        return {"clients": common.stack_layer_specs(client_spec, n_clients,
                                                    axis_name="clients"),
                "server": server_spec}

    @tags.party("client")
    def client_embed(client_m, tokens):
        """tokens (bs, S) int -> (bs, S, d) — the serve-time uplink. S = 1
        per decode step; S = chunk for a whole prompt span."""
        return embed_lookup(client_m["embed"], tokens, iota=cfg.iota_embed)

    def _decode_tail(server, x, caches, cur_pos, positions):
        if "pos_embed" in server:
            pos_table = server["pos_embed"]
            pe = pos_table[positions.clamp(0, pos_table.shape[0] - 1)]
            x = x + pe.to(x.dtype)
        h, new_caches, _ = transformer.backbone_apply(
            cfg, server, x, positions=positions, caches=caches,
            cur_pos=cur_pos)
        h = apply_norm(cfg, server["final_norm"], h)
        return unembed(server["lm_head"], h), new_caches

    @tags.party("server")
    def server_decode(server, x, caches, cur_pos):
        """x (bs, 1, d) at position ``cur_pos``, shared by the batch: a
        Python int (the eager loop), or a 0-d or (1,) int64 device tensor
        (the captured step: positions are built on the device, the cache
        row written at a device index). Both forms compute the same."""
        if isinstance(cur_pos, torch.Tensor):
            cur_pos = cur_pos.reshape(1)
            positions = cur_pos
        else:
            positions = torch.full((1,), int(cur_pos), device=x.device)
        return _decode_tail(server, x, caches, cur_pos, positions)

    @tags.party("server")
    def server_prefill(server, x, caches, t0):
        """x (bs, chunk, d): one party's whole span upload, consumed in a
        single pass — the same post-embedding ops as ``server_decode`` per
        position."""
        positions = int(t0) + torch.arange(x.shape[1], device=x.device)
        return _decode_tail(server, x, caches, t0, positions)

    @tags.party("server")
    def server_decode_paged(server, x, caches, tables, cur_pos, active,
                            page_size):
        """Batched paged decode: x (n_slots, 1, d), every slot at its own
        position. Per-row positions (n_slots, 1) drive RoPE, the learned
        position table and the attention mask, so each active row computes
        what the B = 1 ``server_decode`` would; the positions stay on the
        device."""
        positions = cur_pos[:, None]
        paging = common.PageContext.for_step(tables, active, cur_pos,
                                             page_size)
        if "pos_embed" in server:
            pos_table = server["pos_embed"]
            pe = pos_table[positions.clamp(0, pos_table.shape[0] - 1).long()]
            x = x + pe.to(x.dtype)
        h, new_caches, _ = transformer.backbone_apply(
            cfg, server, x, positions=positions, caches=caches,
            cur_pos=cur_pos, paging=paging)
        h = apply_norm(cfg, server["final_norm"], h)
        return unembed(server["lm_head"], h), new_caches

    def cache_specs(batch, max_seq):
        return model_api.build_cache_specs(cfg, batch, max_seq)

    return ModelAdapter(
        name=f"lm-{cfg.arch_id}-m{n_clients}-s{seq_len}",
        client_forward=training_hook,
        server_loss=training_hook,
        param_specs=param_specs,
        client_lanes=training_hook,
        row_mask=training_hook,
        client_embed=client_embed,
        server_decode=server_decode,
        server_prefill=server_prefill,
        cache_specs=cache_specs,
        server_decode_paged=server_decode_paged,
    )
