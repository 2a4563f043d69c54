"""Decoder-only transformer assembly: the dense attention family
(internlm2 / granite / phi3 / nemotron), the multimodal family (internvl2:
an InternLM2 backbone behind a stub vision prefix: precomputed patch
embeddings mapped to d_model by the client's projector ``proj`` and put
before the text), the MoE family (qwen3-moe: every
block's MLP is a routed mixture of experts; deepseek-v3: multi-head latent
attention, ``first_k_dense`` leading dense blocks, then MoE blocks, and a
depth-1 multi-token-prediction head in the loss), the ssm family (rwkv6:
time-mix and channel-mix blocks, attention-free) and the hybrid family
(zamba2: a Mamba2 trunk with a shared attention block every
``attn_every`` layers).

Ported from the JAX package's ``models/transformer.py``. Layers are
stacked params (a leading layer axis on every block leaf, the JAX
package's layout; the hybrid trunk is stacked (n_super, attn_every, ...));
its ``lax.scan`` over them becomes a Python loop over that axis, and the
per-layer KV caches and recurrent states are views into the stacked
caches, updated in place. The continuous scheduler's batched decode step
passes a ``paging`` context (``models/common.PageContext``): the KV
leaves are then shared page pools, and the Mamba2 and RWKV states of
inactive slots stay frozen (``freeze_state``). With ``cfg.remat``, a
training forward (no caches, grad on) recomputes each block (a hybrid
super-block) in the backward, as the JAX package's ``jax.checkpoint``
over the scan body does. The MoE load-balance loss of every block is
summed through the layer loop and added to the loss in ``lm_loss``; a
call with caches (decode, and a cached prefill chunk) takes the MoE dense
form, as in the JAX package. A ``first_k_dense`` config runs its stack of
dense blocks, then its MoE blocks, over the caches {"dense", "main"}.
Under a mesh (``sharding.rules.use_mesh``, DTensor parameters) the
activations are constrained at the JAX package's sites: the embeddings,
each block's input (the sequence-parallel boundary, ``seq_shard_acts``),
the attention and MLP outputs with ``rs_outputs``, and the logits; with no
mesh each constraint returns its operand.
``lm_loss`` is the training loss over the text positions, plus 0.3 x
the MTP head's loss where the tree holds one. The encoder-decoder family
(whisper) is ``models/encdec.py``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ParamSpec, freeze_state,
                                       stack_layer_specs)
from repro_torch.models.layers import (apply_norm, embed_lookup,
                                       gather_inner, norm_specs,
                                       unembed)
from repro_torch.models.mlp import mlp_apply, mlp_specs
from repro_torch.sharding.rules import shard_constraint

RESIDUAL = ("batch", "seq_act", "embed_act")


# ============================================================ param specs ==

def _attn_block_specs(cfg, d_ff: Optional[int] = None, moe: bool = False):
    sp = {"ln1": norm_specs(cfg, cfg.d_model),
          "ln2": norm_specs(cfg, cfg.d_model),
          "attn": attn.attention_specs(cfg)}
    if moe:
        sp["moe"] = moe_mod.moe_specs(cfg, cfg.d_model)
    else:
        sp["mlp"] = mlp_specs(cfg, cfg.d_model, d_ff or cfg.d_ff)
    return sp


def _rwkv_block_specs(cfg):
    return {"ln1": norm_specs(cfg, cfg.d_model),
            "tmix": rwkv_mod.rwkv_specs(cfg, cfg.d_model),
            "ln2": norm_specs(cfg, cfg.d_model),
            "cmix": rwkv_mod.rwkv_channel_mix_specs(cfg, cfg.d_model)}


def _mamba_block_specs(cfg):
    return {"ln1": norm_specs(cfg, cfg.d_model),
            "ssm": ssm_mod.ssm_specs(cfg, cfg.d_model)}


def backbone_specs(cfg, max_seq: int):
    """Full parameter spec tree for a decoder-only config (with the
    modality projector ``proj`` where the config has a frontend)."""
    sp = {"embed": {"table": ParamSpec((cfg.padded_vocab, cfg.d_model),
                                       cfg.param_dtype, ("vocab", "embed"))},
          "final_norm": norm_specs(cfg, cfg.d_model),
          "lm_head": {"table": ParamSpec((cfg.padded_vocab, cfg.d_model),
                                         cfg.param_dtype, ("vocab", "embed"),
                                         "scaled")}}
    if cfg.pos == "learned":
        sp["pos_embed"] = ParamSpec((max_seq, cfg.d_model), cfg.param_dtype,
                                    ("vocab", "embed"))
    if cfg.frontend_dim:
        sp["proj"] = {"w": ParamSpec((cfg.frontend_dim, cfg.d_model),
                                     cfg.param_dtype, ("frontend", "embed"),
                                     "scaled"),
                      "b": ParamSpec((cfg.d_model,), "float32", (None,),
                                     "zeros")}
    if cfg.family == "ssm":
        sp["blocks"] = stack_layer_specs(_rwkv_block_specs(cfg), cfg.n_layers)
    elif cfg.family == "hybrid":
        n_super = cfg.n_layers // cfg.attn_every
        inner = stack_layer_specs(_mamba_block_specs(cfg), cfg.attn_every)
        sp["blocks"] = stack_layer_specs(inner, n_super)
        sp["shared_block"] = _attn_block_specs(cfg)
    elif cfg.n_experts:
        n_moe = cfg.n_layers - cfg.first_k_dense
        sp["blocks"] = stack_layer_specs(_attn_block_specs(cfg, moe=True),
                                         n_moe)
        if cfg.first_k_dense:
            sp["dense_blocks"] = stack_layer_specs(
                _attn_block_specs(cfg, moe=False), cfg.first_k_dense)
        if cfg.n_mtp:
            sp["mtp"] = {"block": _attn_block_specs(cfg, moe=False),
                         "proj": ParamSpec((2 * cfg.d_model, cfg.d_model),
                                           cfg.param_dtype, ("embed", None),
                                           "scaled"),
                         "norm": norm_specs(cfg, cfg.d_model)}
    else:
        sp["blocks"] = stack_layer_specs(_attn_block_specs(cfg),
                                         cfg.n_layers)
    return sp


# ============================================================== blocks =====

def _attn_block_apply(cfg, p, x, *, positions, cache=None, cur_pos=None,
                      window=0, decode=False, gather_experts=False,
                      paging=None):
    """An attention block with a dense MLP or a mixture of experts.
    Returns (x, cache, aux): aux is the block's MoE load-balance loss
    (None for a dense MLP)."""
    h = apply_norm(cfg, p["ln1"], x)
    if cfg.use_mla:
        a, new_cache = attn.mla_apply(cfg, p["attn"], h, positions=positions,
                                      cache=cache, cur_pos=cur_pos,
                                      window=window, paging=paging)
    else:
        a, new_cache = attn.attention_apply(
            cfg, p["attn"], h, positions=positions, cache=cache,
            cur_pos=cur_pos, window=window, paging=paging)
    if cfg.rs_outputs:
        # the TP output projection's partial sums land directly in the
        # seq-sharded residual layout: a reduce-scatter, not an all-reduce
        a = shard_constraint(a, RESIDUAL)
    x = x + a
    h = apply_norm(cfg, p["ln2"], x)
    aux = None
    if "moe" in p:
        m, aux = moe_mod.moe_apply(cfg, p["moe"], h, decode=decode,
                                   gather_experts=gather_experts)
    else:
        m = mlp_apply(cfg, p["mlp"], h)
    if cfg.rs_outputs:
        m = shard_constraint(m, RESIDUAL)
    return x + m, new_cache, aux


def _store_state(state, new_state, active):
    """Write a block's new recurrent state into its views of the stacked
    state, in place; with ``active`` (B,) the rows of inactive slots keep
    their state exactly (``freeze_state``)."""
    for name, leaf in state.items():
        new = new_state[name]
        if active is not None:
            new = freeze_state(active, new, leaf)
        leaf.copy_(new)


def _rwkv_block_apply(cfg, p, x, *, state=None, active=None):
    """An RWKV6 block: time-mix then channel-mix, each behind its norm.
    ``state`` (views into the stacked wkv, shift and shift_c leaves) is
    read whole before it is updated in place."""
    h = apply_norm(cfg, p["ln1"], x)
    tstate = None if state is None else {"wkv": state["wkv"],
                                         "shift": state["shift"]}
    t, new_t = rwkv_mod.rwkv_time_mix(cfg, p["tmix"], h, state=tstate)
    x = x + t
    h2 = apply_norm(cfg, p["ln2"], x)
    prev_c = None if state is None else state["shift_c"].to(x.dtype)
    c = rwkv_mod.rwkv_channel_mix(cfg, p["cmix"], h2, prev=prev_c)
    if state is not None:
        _store_state(state, {"wkv": new_t["wkv"], "shift": new_t["shift"],
                             "shift_c": h2[:, -1]}, active)
    return x + c


def _mamba_block_apply(cfg, p, x, *, state=None, active=None):
    """A Mamba2 block; ``state`` (views into the stacked SSM state) is
    updated in place. With ``active`` (B,) the rows of inactive slots keep
    their state exactly (``freeze_state``)."""
    h = apply_norm(cfg, p["ln1"], x)
    s, new_state = ssm_mod.ssm_apply(cfg, p["ssm"], h, state=state)
    if state is not None:
        _store_state(state, new_state, active)
    return x + s


def _boundary(cfg, x):
    """A block's input: the sequence-parallel residual layout (the saved
    tensor of a recomputed block) with ``cfg.seq_shard_acts``. Under a
    mesh the block then reads it gathered along the sequence
    (``gather_inner``): DTensor will not flatten a sequence-sharded
    activation, or its gradient, into a product, where the JAX package's
    partitioner inserts that all-gather itself."""
    if cfg.seq_shard_acts:
        return gather_inner(shard_constraint(x, RESIDUAL))
    return x


def _maybe_remat(cfg, fn, caches=None):
    """``fn`` recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant) when ``cfg.remat`` and the call can be differentiated:
    a training forward with grad on and no caches. The JAX package's
    ``"dots"`` policy (keep the weight products, recompute the rest) has
    no checkpoint counterpart in torch, so both policies recompute the
    whole block. A forward that nothing differentiates runs ``fn`` as it
    is. The blocks draw no random numbers, so the checkpoint keeps no RNG
    state: a captured engine round (a CUDA graph) may neither read nor
    set the card's generator state."""
    if not cfg.remat or caches is not None or not torch.is_grad_enabled():
        return fn

    def remat(*args, **kwargs):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False,
            **kwargs)
    return remat


def _layer(tree, i: int):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _layers(tree, n: int):
    """The n per-layer trees of a stacked tree, as views. One ``unbind``
    per leaf: its backward stacks the n layer gradients once, where
    indexing layer by layer would give each index's backward a zero
    tensor of the whole stack to accumulate into."""
    parts = {k: _layers(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


# ======================================================== backbone passes ==

def backbone_apply(cfg, params, x, *, positions, caches=None, cur_pos=None,
                   window=0, gather_experts=False, paging=None):
    """Run the stacked blocks. x: (B, S, d) embeddings.

    caches: {"k", "v"} stacked over layers (leading dim; MLA's
    {"latent"}), for a ``first_k_dense`` config {"dense": ..., "main":
    ...} (its dense stack's and its MoE stack's), for the ssm family
    {"wkv", "shift", "shift_c"}, for the hybrid family the tuple
    (ssm_states, attn_caches), or None; each layer writes its slice in
    place. ``paging`` (a ``PageContext``) switches the KV leaves to the
    paged-pool layout with per-row positions (the continuous scheduler's
    batched decode step); the recurrent state leaves are then
    slot-stacked and frozen on inactive rows. A call with caches takes
    the MoE dense form (or, with ``gather_experts``, the gather form for
    a small enough batch). Returns (hidden (B, S, d), caches, aux): aux
    is the sum of the blocks' MoE load-balance losses (0.0 without
    experts)."""
    decode = caches is not None
    zero = torch.zeros((), device=x.device)
    if cfg.family == "ssm":
        active = None if paging is None else paging.active

        def rwkv_body(h, p_l, st_l):
            return _rwkv_block_apply(cfg, p_l, _boundary(cfg, h),
                                     state=st_l, active=active)
        rwkv_body = _maybe_remat(cfg, rwkv_body, caches)
        for i, p_l in enumerate(_layers(params["blocks"], cfg.n_layers)):
            x = rwkv_body(x, p_l, None if caches is None else _layer(caches, i))
        return x, caches, zero
    if cfg.family == "hybrid":
        x = _hybrid_apply(cfg, params, x, positions=positions, caches=caches,
                          cur_pos=cur_pos, window=window, paging=paging)
        return x, caches, zero

    def body(h, p_l, c_l):
        h, _, aux = _attn_block_apply(
            cfg, p_l, _boundary(cfg, h), positions=positions, cache=c_l, cur_pos=cur_pos,
            window=window, decode=decode, gather_experts=gather_experts,
            paging=paging)
        return h, aux
    body = _maybe_remat(cfg, body, caches)
    if cfg.first_k_dense and cfg.n_experts:
        stacks = [("dense_blocks", cfg.first_k_dense,
                   None if caches is None else caches["dense"]),
                  ("blocks", cfg.n_layers - cfg.first_k_dense,
                   None if caches is None else caches["main"])]
    else:
        stacks = [("blocks", cfg.n_layers, caches)]
    aux_total = zero
    for key, n, stack_caches in stacks:
        for i, p_l in enumerate(_layers(params[key], n)):
            x, aux = body(x, p_l, None if stack_caches is None
                          else _layer(stack_caches, i))
            if aux is not None:
                aux_total = aux_total + aux
    return x, caches, aux_total


def _hybrid_apply(cfg, params, x, *, positions, caches, cur_pos, window,
                  paging=None):
    """The Mamba2 trunk in super-blocks of ``attn_every`` layers, each
    followed by the shared attention block (one set of weights, its own KV
    cache slice per site)."""
    ssm_states, attn_caches = (None, None) if caches is None else caches
    active = None if paging is None else paging.active

    def super_body(h, p_sup, shared, s):
        h = _boundary(cfg, h)
        for j, p_l in enumerate(_layers(p_sup, cfg.attn_every)):
            st = (None if ssm_states is None
                  else {k: v[s, j] for k, v in ssm_states.items()})
            h = _mamba_block_apply(cfg, p_l, _boundary(cfg, h), state=st,
                                   active=active)
        h, _, _ = _attn_block_apply(
            cfg, shared, h, positions=positions,
            cache=None if attn_caches is None else _layer(attn_caches, s),
            cur_pos=cur_pos, window=window, paging=paging)
        return h
    super_body = _maybe_remat(cfg, super_body, caches)
    n_super = cfg.n_layers // cfg.attn_every
    for s, p_sup in enumerate(_layers(params["blocks"], n_super)):
        x = super_body(x, p_sup, params["shared_block"], s)
    return x


# ============================================================== forward ====

def embed_inputs(cfg, params, inputs, *, positions):
    """Map raw inputs -> (B, S, d) embeddings (plus the learned position
    table where the config has one). A VLM input with ``patch_embeds``
    (B, Nv, frontend_dim) becomes [proj(patch_embeds); embed(tokens)].
    This is the CLIENT part of the cascade partition."""
    x = embed_lookup(params["embed"], inputs["tokens"], iota=cfg.iota_embed)
    if cfg.family == "vlm" and "patch_embeds" in inputs:
        proj = params["proj"]
        pe = (inputs["patch_embeds"].to(x.dtype) @ proj["w"]
              + proj["b"].to(x.dtype))
        x = torch.cat([pe, x], dim=1)
    if cfg.pos == "learned":
        pos_table = params["pos_embed"]
        pe = pos_table[positions.clamp(0, pos_table.shape[0] - 1)]
        x = x + pe.to(x.dtype)
    return shard_constraint(x, ("batch", None, "embed_act"))


def forward(cfg, params, inputs, *, caches=None, cur_pos=None, window=0,
            gather_experts=False):
    """Full forward. Training/prefill: inputs over S (a VLM input's S
    counts its vision positions first). Decode: S == 1, or a
    cur_pos-offset chunk (chunked prefill); text only. ``cur_pos`` is a
    Python int, or for a one-token step a 0-d or (1,) int64 device tensor
    (the captured global decode step: positions are built on the device,
    with no host read); both forms compute the same.

    Returns (logits (B, S, vocab), caches, aux)."""
    tokens = inputs["tokens"]
    S = tokens.shape[1]
    if caches is None and cfg.family == "vlm" and "patch_embeds" in inputs:
        S += cfg.n_vision_tokens
    positions = torch.arange(S, device=tokens.device)
    if caches is not None:
        if isinstance(cur_pos, torch.Tensor):
            cur_pos = cur_pos.reshape(1)
            positions = positions + cur_pos
        else:
            positions = positions + int(cur_pos)
    x = embed_inputs(cfg, params, inputs, positions=positions)
    h, new_caches, aux = backbone_apply(
        cfg, params, x, positions=positions, caches=caches, cur_pos=cur_pos,
        window=window, gather_experts=gather_experts)
    h = apply_norm(cfg, params["final_norm"], h)
    logits = shard_constraint(unembed(params["lm_head"], h),
                              ("batch", None, "vocab_act"))
    return logits, new_caches, aux


# ================================================================= loss ====

def lm_loss(cfg, params, inputs, *, window=0, label_mask=None):
    """Next-token CE over the text positions. Returns (loss, aux_dict)."""
    logits, _, aux = forward(cfg, params, inputs, window=window)
    labels = inputs["labels"]
    if cfg.family == "vlm":
        # logits cover [vision; text]; predict the text tokens only
        logits = logits[:, cfg.n_vision_tokens:]
    ce = softmax_xent(logits[:, :-1], labels[:, 1:], cfg.padded_vocab)
    mask = (torch.ones(labels[:, 1:].shape, dtype=torch.float32,
                       device=labels.device) if label_mask is None
            else label_mask[:, 1:].float())
    loss = torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)
    if cfg.n_mtp and "mtp" in params:
        loss = loss + 0.3 * _mtp_loss(cfg, params, inputs, window=window)
    return loss + aux, {"aux": aux}


def _mtp_loss(cfg, params, inputs, *, window=0):
    """DeepSeek-style multi-token-prediction head (depth 1), as the JAX
    package simplifies it: one extra block predicts token t + 2 from
    [emb(tok_t) ; emb(tok_{t+1})] (the combiner takes embeddings, not final
    hidden states), then the MTP norm and the shared LM head."""
    tokens, labels = inputs["tokens"], inputs["labels"]
    x = embed_lookup(params["embed"], tokens, iota=cfg.iota_embed)
    e_next = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    comb = torch.cat([x, e_next], dim=-1)
    h = comb @ params["mtp"]["proj"]
    h, _, _ = _attn_block_apply(cfg, params["mtp"]["block"], h,
                                positions=torch.arange(h.shape[1],
                                                       device=h.device),
                                window=window)
    h = apply_norm(cfg, params["mtp"]["norm"], h)
    lg = unembed(params["lm_head"], h)
    ce = softmax_xent(lg[:, :-2], labels[:, 2:], cfg.padded_vocab)
    return torch.mean(ce)


def softmax_xent(logits, labels, vocab):
    """Stable CE in the JAX package's masked-reduction form (log-sum-exp
    minus the gold logit picked by an iota compare), in f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    vidx = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.sum(torch.where(vidx == labels[..., None].long(), logits,
                                 0.0), dim=-1)
    return lse - gold
