"""Model adapters: the async engine's protocol for client/server pairs.

The asynchronous protocol simulation (``repro_torch.core.async_engine``)
needs three things from a model: a per-client feature extractor, a
server loss over the stacked client embeddings, and (optionally) a fused
"lanes" forward that evaluates the clean + q ZOO-perturbed client
forwards in one pass. Packaging those as a :class:`ModelAdapter` lets the
same engine drive any client/server pair: the paper's tabular MLP, a
SwiGLU-MLP stack (:func:`mlp_adapter`), and (via
:func:`from_model_config`) a registered decoder-only ``ModelConfig`` —
the clients own the embedding, the server the transformer backbone plus
head — for training and for serving.

Where the JAX engine ``vmap``-ed an adapter's hooks over the activated
client block, the port calls them once with the block written out as
leading batch dims, so every hook takes leading dims: the tabular hooks
broadcast them through their products, the MLP and LM hooks loop over
them (:func:`_over_lead`; the LM's kernels cannot be ``vmap``-ed).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional, Tuple

import torch

from repro_torch.analysis import marks, tags
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core import zoo
from repro_torch.core.partition import LM_CLIENT_KEYS, split_params
from repro_torch.kernels.zoo_dual_matmul.ops import zoo_dual_matmul_stacked
from repro_torch.models import common, mlp, model_api, tabular, transformer
from repro_torch.models.common import ParamSpec
from repro_torch.models.layers import apply_norm, embed_lookup, unembed
from repro_torch.sharding.rules import shard_constraint
from repro_torch.tree import tree_leaves, tree_map


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
    * ``table_logical`` — per-dim logical axis names of the server's
      (M, n, e) embedding table; the engine's sharded path resolves its
      partitioning from these via ``repro_torch.sharding.rules`` (the
      leading "clients" axis splits rows over the mesh "data" axis).

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
    table_logical: Tuple[Optional[str], ...] = ("clients", None, None)
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
        c = marks.wire_boundary(self.client_forward(params["clients"],
                                                    x_parts),
                                kind="emb", direction="up")
        return self.server_loss(params["server"], c, y_batch)


def _over_lead(fn, args, bases):
    """``fn(*args)`` for every index of the args' leading dims.

    ``bases[i]`` is the number of trailing dims of every leaf of
    ``args[i]`` (a tensor or a tree) that ``fn`` takes, or None for an
    argument passed to every call as it is; the dims before them are
    leading dims, broadcast across all leaves as numpy broadcasts
    (right-aligned, size 1 repeats, by indexing: nothing is expanded or
    copied). Returns ``fn``'s tensor results stacked into (*lead, ...),
    or ``fn(*args)`` itself when there are no leading dims."""
    leads = [leaf.shape[:leaf.ndim - base]
             for a, base in zip(args, bases) if base is not None
             for leaf in tree_leaves(a)]
    lead = torch.broadcast_shapes(*leads)
    if not lead:
        return fn(*args)

    def pick(leaf, base, idx):
        own = leaf.shape[:leaf.ndim - base]
        own_idx = idx[len(idx) - len(own):]
        return leaf[tuple(i if n > 1 else 0 for i, n in zip(own_idx, own))]

    outs = [fn(*(a if base is None else
                 tree_map(lambda leaf, b=base: pick(leaf, b, idx), a)
                 for a, base in zip(args, bases)))
            for idx in itertools.product(*(range(n) for n in lead))]
    out = torch.stack(outs)
    return out.reshape(*lead, *out.shape[1:])


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
        table_logical=("clients", None, None),
    )


def example_engine_args(adapter: ModelAdapter, cfg: PaperMLPConfig, *,
                        n_rows: int = 16, batch: int = 4, block: int = 1,
                        q: int = 1, seed: int = 0, device=None):
    """Small concrete engine-step arguments for tracing.

    Builds the ``(params, table, m_blk, idx, t, draws, x_parts, y)``
    tuple a train-step closure takes (``Federation.traceable_train_step``),
    sized off the tabular protocol config — the certifier
    (``repro_torch.analysis.certify``) traces the step over these. The
    params, table and data are zero-filled, as the JAX package's are; the
    round's draws are filled before the trace from a ``TorchDraws(seed)``
    (:class:`~repro_torch.core.draws.FilledDraws`) and enter the graph as
    inputs, as the port injects draws everywhere else. ``params`` keeps
    its ``{"clients": ..., "server": ...}`` key paths: that is how the
    certifier labels which inputs are server-held."""
    from repro_torch.core.draws import FilledDraws, TorchDraws
    device = torch.device("cpu" if device is None else device)
    params = tree_map(
        lambda s: torch.zeros(s.shape, dtype=common.torch_dtype(s.dtype),
                              device=device),
        adapter.param_specs())
    M = cfg.n_clients
    table = torch.zeros((M, n_rows, cfg.client_embed), device=device)
    m_blk = torch.arange(block, device=device)
    idx = torch.zeros((batch,), dtype=torch.int64, device=device)
    draws = FilledDraws.fill(
        TorchDraws(seed, device), 0,
        client=tree_map(lambda a: a[0], params["clients"]),
        server=params["server"], params=params, n_rows=block, q=q)
    x_parts = torch.zeros((M, n_rows, cfg.features_per_client),
                          device=device)
    y = torch.zeros((n_rows,), dtype=torch.int64, device=device)
    return params, table, m_blk, idx, 0, draws, x_parts, y


# ======================================================== SwiGLU-MLP pair ==

def mlp_adapter(*, n_clients: int = 4, features: int = 32,
                client_embed: int = 32, d_ff: int = 64,
                server_embed: int = 64, n_classes: int = 4,
                act: str = "swiglu") -> ModelAdapter:
    """Non-tabular client/server pair built from ``repro_torch.models.mlp``
    blocks: each client projects its feature slice and applies a residual
    SwiGLU MLP; the server does the same over the concatenated embeddings
    before a linear head. Exercises the engine with a model whose client
    partition is a multi-layer tree (not one FC layer)."""
    acfg = ModelConfig(act=act, dtype="float32", param_dtype="float32")
    f_per = features // n_clients
    e, se = client_embed, server_embed

    def param_specs():
        client = {
            "w_in": ParamSpec((f_per, e), "float32", (None, None), "scaled"),
            "mlp": mlp.mlp_specs(acfg, e, d_ff),
        }
        return {
            "clients": common.stack_layer_specs(client, n_clients,
                                                axis_name="clients"),
            "server": {
                "w_in": ParamSpec((n_clients * e, se), "float32",
                                  (None, None), "scaled"),
                "mlp": mlp.mlp_specs(acfg, se, 2 * d_ff),
                "head": ParamSpec((se, n_classes), "float32", (None, None),
                                  "scaled"),
            },
        }

    def _rms(h):
        # parameter-free rms norm keeps the residual stack well-conditioned
        # regardless of feature scale (ZOO loses to exploding logits fast)
        return h * torch.rsqrt(torch.mean(torch.square(h), -1,
                                          keepdim=True) + 1e-6)

    def _client_one(client_m, x_m):
        h = _rms(x_m @ client_m["w_in"])
        return _rms(h + mlp.mlp_apply(acfg, client_m["mlp"],
                                      h[:, None, :])[:, 0])

    @tags.party("client")
    def client_forward(client, x):
        """x (..., bs, f_per) -> (..., bs, e)."""
        return _over_lead(_client_one, (client, x), (2, 2))

    def _server_one(server, c_all, y_batch):
        M, B, _ = c_all.shape
        h = _rms(c_all.transpose(0, 1).reshape(B, M * e) @ server["w_in"])
        h = _rms(h + mlp.mlp_apply(acfg, server["mlp"],
                                   h[:, None, :])[:, 0])
        return tabular.xent(h @ server["head"], y_batch)

    @tags.party("server")
    def server_loss(server, c_all, y_batch):
        """c_all (..., M, bs, e) -> loss (...)."""
        return _over_lead(_server_one, (server, c_all, y_batch),
                          (None, 3, None))

    return ModelAdapter(name=f"mlp-{act}", client_forward=client_forward,
                        server_loss=server_loss, param_specs=param_specs,
                        table_logical=("clients", None, None))


# ================================================= ModelConfig bridge =====

EMBED_ACT = ("batch", None, "embed_act")
VOCAB_ACT = ("batch", None, "vocab_act")


def from_model_config(cfg: ModelConfig, *, n_clients: int = 2,
                      seq_len: int = 32,
                      active_rows: bool = True) -> ModelAdapter:
    """Derive a :class:`ModelAdapter` for a decoder-only ``ModelConfig``
    (the dense, MoE — MLA and ``first_k_dense`` included — ssm and hybrid
    families).

    The vertical split follows the paper's LM experiments: each of the M
    client parties owns a disjoint span of ``seq_len / M`` token positions
    plus its own copy of the embedding table (the bottom layer), and the
    server owns the backbone (for the hybrid family the Mamba2 trunk and
    the shared attention block; for the ssm family the RWKV blocks; for
    the MoE family every block's experts and router), final norm and LM
    head. A client's uplink
    "embedding" is its span's token embeddings flattened to one
    ``(batch, span·d_model)`` vector, so the engine's (M, n, e) table,
    staleness bookkeeping and wire accounting all apply unchanged; the
    server loss folds the M spans back into a (batch, S, d_model)
    sequence and runs the post-embedding half of the model's loss, the
    MoE load-balance loss included. On the card that reaches the
    flash-attention and RMSNorm kernels (and the SSD scan for the hybrid
    family; the ssm family runs none) exactly as the sync training step
    does; a server loss over leading dims (the 1 + q lanes) runs one
    forward per index.

    ``active_rows=True`` (default) attaches a :attr:`ModelAdapter.row_mask`
    hook restricting each client's ZOO perturbation to the embedding rows
    its batch touches.

    ``x_parts`` for the engine are integer token spans,
    ``data.vertical_partition(tokens, M)``; ``y`` is the full (n, S) token
    array. ``partition.lm_engine_params`` maps a global ``build_model``
    parameter tree into the engine's {"clients", "server"} layout.

    The serve hooks are the exact post-embedding half of
    ``transformer.forward``'s decode path, so split decode equals global
    decode.

    Encoder-decoder and VLM configs need a modality frontend on the wire
    and are refused with the JAX package's ``ValueError``.
    """
    if cfg.is_encoder_decoder or cfg.family == "vlm":
        raise ValueError(
            f"from_model_config supports decoder-only families; "
            f"{cfg.arch_id!r} (family={cfg.family!r}, "
            f"encoder_decoder={cfg.is_encoder_decoder}) needs a modality "
            "frontend that never crosses the VFL wire")
    if n_clients < 1 or seq_len % n_clients:
        raise ValueError(
            f"seq_len={seq_len} must split evenly over "
            f"n_clients={n_clients} token spans")
    model = model_api.build_model(cfg, max_seq=seq_len)
    client_spec, server_spec = split_params(model.param_specs,
                                            LM_CLIENT_KEYS)
    # the server partition leaves out the token-consuming MTP head, as
    # ``partition.lm_engine_params`` does: the engine's global loss is the
    # model's loss without it
    server_spec = {k: v for k, v in server_spec.items() if k != "mtp"}
    span = seq_len // n_clients
    d = cfg.d_model

    def _embed_one(client_m, x_m):
        e = embed_lookup(client_m["embed"], x_m, iota=cfg.iota_embed)
        return e.reshape(x_m.shape[0], span * d)

    @tags.party("client")
    def client_forward(client, x):
        """x (..., bs, span) int tokens -> (..., bs, span·d) embedding."""
        return _over_lead(_embed_one, (client, x), (2, 2))

    @tags.party("client")
    def client_lanes(client_blk, u_stack, mu, x_blk):
        """Fused clean + q perturbed fan-out: client_blk leaves (R, V, d),
        u_stack (R, q, V, d), x_blk (R, bs, span) -> (R, 1+q, bs, span·d).
        Embedding lookup is linear in the table, so the q perturbed
        forwards are one gather into the stacked direction tables instead
        of q re-embeddings of a perturbed copy — equal to
        perturb-then-lookup (the gather commutes with the elementwise
        w + μu and the dtype round-trip)."""
        clean = client_forward(client_blk, x_blk)           # (R, bs, e)
        u_rows = _over_lead(
            lambda u, x: embed_lookup(u["embed"], x),
            (u_stack, x_blk.unsqueeze(-3)), (2, 2))   # (R, q, bs, span, d)
        lead = u_rows.shape[:-3]
        pert = (clean.unsqueeze(-3).float()
                + mu * u_rows.reshape(*lead, x_blk.shape[-2], span * d)
                ).to(clean.dtype)
        return torch.cat([clean.unsqueeze(-3), pert], dim=-3)

    def _loss_one(server, c_all, y_batch):
        M, bs, _ = c_all.shape
        x = (c_all.reshape(M, bs, span, d)
             .transpose(0, 1).reshape(bs, seq_len, d))
        positions = torch.arange(seq_len, device=x.device)
        if "pos_embed" in server:
            pos_table = server["pos_embed"]
            pe = pos_table[positions.clamp(0, pos_table.shape[0] - 1)]
            x = x + pe.to(x.dtype)
        x = shard_constraint(x, EMBED_ACT)
        h, _, aux = transformer.backbone_apply(cfg, server, x,
                                               positions=positions)
        h = apply_norm(cfg, server["final_norm"], h)
        logits = shard_constraint(unembed(server["lm_head"], h), VOCAB_ACT)
        ce = transformer.softmax_xent(logits[:, :-1], y_batch[:, 1:],
                                      cfg.padded_vocab)
        return torch.mean(ce) + aux

    @tags.party("server")
    def server_loss(server, c_all, y_batch):
        """c_all (..., M, bs, span·d) client spans -> LM loss (...): the
        post-embedding half of ``transformer.lm_loss`` (same ops, same
        order), one forward per leading index."""
        return _over_lead(_loss_one, (server, c_all, y_batch),
                          (None, 3, None))

    def row_mask(client, x):
        """{"embed": {"table": (..., V)}}: the vocabulary rows each leading
        index's tokens touch."""
        vocab = client["embed"]["table"].shape[-2]
        return {"embed": {"table": _over_lead(
            lambda xx: zoo.embedding_row_mask(xx, vocab), (x,), (2,))}}

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
        x = shard_constraint(x, EMBED_ACT)
        h, new_caches, _ = transformer.backbone_apply(
            cfg, server, x, positions=positions, caches=caches,
            cur_pos=cur_pos)
        h = apply_norm(cfg, server["final_norm"], h)
        return (shard_constraint(unembed(server["lm_head"], h), VOCAB_ACT),
                new_caches)

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
        x = shard_constraint(x, EMBED_ACT)
        h, new_caches, _ = transformer.backbone_apply(
            cfg, server, x, positions=positions, caches=caches,
            cur_pos=cur_pos, paging=paging)
        h = apply_norm(cfg, server["final_norm"], h)
        return (shard_constraint(unembed(server["lm_head"], h), VOCAB_ACT),
                new_caches)

    def cache_specs(batch, max_seq):
        return model_api.build_cache_specs(cfg, batch, max_seq)

    return ModelAdapter(
        name=f"lm-{cfg.arch_id}-m{n_clients}-s{seq_len}",
        client_forward=client_forward,
        server_loss=server_loss,
        param_specs=param_specs,
        client_lanes=client_lanes,
        table_logical=("clients", None, None),
        row_mask=row_mask if active_rows else None,
        client_embed=client_embed,
        server_decode=server_decode,
        server_prefill=server_prefill,
        cache_specs=cache_specs,
        server_decode_paged=server_decode_paged,
    )
