"""The port's mixture of experts (``repro_torch.models.moe``) and the MoE
family (``transformer``'s MoE blocks, the aux loss through the layer
loop) against the JAX package's, on the CPU in f32 with inputs from
numpy seeds and params carried from ``repro``.

Routing first: a near-tie between the k-th and (k+1)-th router
probability would pick another expert in torch than in JAX and move the
output by a whole expert's share, so every parity case compares the
routed ``idx`` exactly and asserts that its inputs' smallest top-k margin
(the k-th minus the (k+1)-th probability) is above 1e-5. Outputs are then
held to ``repro``'s own dispatch-vs-dense tolerance (``tests/test_moe.py``,
2e-4 absolute and 1e-3 relative); gates and the aux loss to 1e-6; the
reduced model's logits to 1e-4 and its loss to a relative 1e-5;
gradients to 1e-4 absolute and relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import common as j_common
from repro.models import moe as j_moe
from repro.models.model_api import build_model as j_build_model
from repro_torch.configs import get_config, reduced
from repro_torch.models import moe, transformer
from repro_torch.models.model_api import build_cache_specs, build_model
from repro_torch.tree import tree_leaves, tree_map
from test_torch_support import (MODALITY_ARCHS, split_plane_refusal,
                                to_numpy, to_torch)

ARCH = "qwen3-moe-30b-a3b"
F32 = dict(param_dtype="float32", dtype="float32")
TOL = dict(atol=2e-4, rtol=1e-3)
MIN_MARGIN = 1e-5


def _close(ours, theirs, **tol):
    np.testing.assert_allclose(to_numpy(ours), to_numpy(theirs),
                               **(tol or TOL))


def _cfgs(**kw):
    """reduced(qwen3-moe): d_model 128, 4 experts top-2, expert d_ff 64,
    moe_groups 4."""
    return (j_reduced(j_get_config(ARCH), **{**F32, **kw}),
            reduced(get_config(ARCH), **{**F32, **kw}))


def _layer(seed=0, **kw):
    jcfg, cfg = _cfgs(**kw)
    jp = j_common.materialize(j_moe.moe_specs(jcfg, jcfg.d_model),
                              jax.random.key(seed), dtype_override="float32")
    return jcfg, cfg, jp, to_torch(jp)


def _x(seed, *shape, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale)
    a = a.astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


def _same_routing(cfg, jcfg, tp, jp, x, jx):
    """The routed experts agree exactly, and the inputs' smallest top-k
    margin is stated and above MIN_MARGIN. Returns the margin."""
    gates, idx, aux = moe._router(cfg, tp, x)
    jgates, jidx, jaux = j_moe._router(jcfg, jp, jx)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    logits = np.asarray(jnp.einsum("bsd,de->bse", jx, jp["router"]))
    probs = np.sort(np.asarray(jax.nn.softmax(logits, -1)), -1)[..., ::-1]
    margin = float((probs[..., cfg.top_k - 1] - probs[..., cfg.top_k]).min())
    assert margin > MIN_MARGIN, f"top-k margin {margin}: pick another seed"
    _close(gates, jgates, atol=1e-6, rtol=0)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    return margin


# ------------------------------------------------------------------ router

@pytest.mark.parametrize("seed", [4, 9])
def test_router_matches_reference(seed):
    jcfg, cfg, jp, tp = _layer()
    x, jx = _x(seed, 2, 8, cfg.d_model)
    _same_routing(cfg, jcfg, tp, jp, x, jx)
    gates, idx, aux = moe._router(cfg, tp, x)
    torch.testing.assert_close(gates.sum(-1), torch.ones(2, 8), atol=1e-5,
                               rtol=0)
    assert int(idx.max()) < cfg.n_experts and float(aux) >= 0


def test_router_bf16_input_accumulates_in_f32():
    """bf16 activations: the router dot takes x's values and the weights
    rounded to bf16, accumulating in f32, as the JAX package's
    ``preferred_element_type`` dot does."""
    jcfg, cfg, jp, tp = _layer()
    x, jx = _x(11, 2, 8, cfg.d_model)
    xb = x.to(torch.bfloat16)
    jxb = jnp.asarray(to_numpy(xb)).astype(jnp.bfloat16)
    gates, idx, _ = moe._router(cfg, tp, xb)
    jgates, jidx, _ = j_moe._router(jcfg, jp, jxb)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(gates, jgates, atol=1e-5, rtol=0)


# ---------------------------------------------------------------- dispatch

@pytest.mark.parametrize("cf,S,seed", [(8.0, 16, 1), (0.25, 32, 3),
                                       (1.25, 24, 5)])
def test_dispatch_matches_reference(cf, S, seed):
    """Capacity dispatch, with no drops (cf 8), heavy drops (cf 0.25: C =
    max(⌈8·2/4·0.25⌉, 4) = 4 of 16 pairs a group) and S = 24 over 4 groups
    of 6 (the group count shrunk until it divides S is kept)."""
    jcfg, cfg, jp, tp = _layer(capacity_factor=cf, moe_groups=4)
    x, jx = _x(seed, 2, S, cfg.d_model)
    _same_routing(cfg, jcfg, tp, jp, x, jx)
    y, aux = moe.moe_apply_dispatch(cfg, tp, x)
    jy, jaux = j_moe.moe_apply_dispatch(jcfg, jp, jx)
    _close(y, jy)
    assert abs(float(aux) - float(jaux)) <= 1e-6


def test_dispatch_drops_against_dense():
    """Without drops dispatch equals the dense form; with cf 0.25 it
    drops pairs and the output's energy falls (``tests/test_moe.py``)."""
    _, cfg_hi, _, tp = _layer(capacity_factor=8.0)
    cfg_lo = dataclasses.replace(cfg_hi, capacity_factor=0.25)
    x, _ = _x(3, 2, 32, cfg_hi.d_model)
    y_hi, a_hi = moe.moe_apply_dispatch(cfg_hi, tp, x)
    y_d, a_d = moe.moe_apply_dense(cfg_hi, tp, x)
    _close(y_hi, y_d)
    assert abs(float(a_hi - a_d)) < 1e-6
    y_lo, _ = moe.moe_apply_dispatch(cfg_lo, tp, x)
    assert float(torch.sum(y_lo ** 2)) < float(torch.sum(y_hi ** 2))


def test_dispatch_odd_group_count():
    """S = 7 shrinks moe_groups 4 to 1 group of 7 tokens."""
    jcfg, cfg, jp, tp = _layer(capacity_factor=1.25)
    x, jx = _x(13, 3, 7, cfg.d_model)
    _same_routing(cfg, jcfg, tp, jp, x, jx)
    _close(moe.moe_apply_dispatch(cfg, tp, x)[0],
           j_moe.moe_apply_dispatch(jcfg, jp, jx)[0])


# ------------------------------------------------------------ dense, gather

@pytest.mark.parametrize("block_bytes", [None, 1])
def test_dense_matches_reference_and_einsum(block_bytes, monkeypatch):
    """The blocked dense form equals ``repro``'s one-einsum dense form:
    with the default block (all 4 experts in one block here) and with a
    block budget of 1 byte (one expert a block)."""
    if block_bytes is not None:
        monkeypatch.setattr(moe, "DENSE_BLOCK_BYTES", block_bytes)
    jcfg, cfg, jp, tp = _layer()
    x, jx = _x(6, 2, 12, cfg.d_model)
    _same_routing(cfg, jcfg, tp, jp, x, jx)
    assert moe.dense_block(cfg, 24) == (4 if block_bytes is None else 1)
    y, aux = moe.moe_apply_dense(cfg, tp, x)
    jy, jaux = j_moe.moe_apply_dense(jcfg, jp, jx)
    _close(y, jy)
    assert abs(float(aux) - float(jaux)) <= 1e-6


def test_dense_block_at_the_serve_shapes():
    """Qwen3's prefill chunk (B = 8 x 576 rows) takes 8 experts a block:
    an f32 (8, 4608, 2048) transient of 302 MB; a B = 8 decode step takes
    all 128 in one block."""
    cfg = get_config(ARCH)
    assert moe.dense_block(cfg, 8 * 576) == 8
    assert moe.dense_block(cfg, 8) == 128


@pytest.mark.parametrize("B", [1, 2])
def test_gather_matches_reference_and_dense(B):
    jcfg, cfg, jp, tp = _layer()
    x, jx = _x(2 + B, B, 1, cfg.d_model)
    _same_routing(cfg, jcfg, tp, jp, x, jx)
    y, _ = moe.moe_apply_gather(cfg, tp, x)
    _close(y, j_moe.moe_apply_gather(jcfg, jp, jx)[0])
    _close(y, moe.moe_apply_dense(cfg, tp, x)[0])


def test_path_choice_is_the_reference_one(monkeypatch):
    """moe_apply: dispatch without decode; dense for decode; gather for a
    decode batch with B·k <= E and gather_experts."""
    calls = []
    for name in ("moe_apply_dispatch", "moe_apply_dense", "moe_apply_gather"):
        fn = getattr(moe, name)
        monkeypatch.setattr(moe, name, lambda *a, _n=name, _f=fn, **k:
                            (calls.append(_n), _f(*a, **k))[1])
    _, cfg, _, tp = _layer()
    x1, _ = _x(0, 2, 1, cfg.d_model)
    x3, _ = _x(0, 3, 1, cfg.d_model)
    moe.moe_apply(cfg, tp, x1)
    moe.moe_apply(cfg, tp, x1, decode=True)
    moe.moe_apply(cfg, tp, x1, decode=True, gather_experts=True)
    moe.moe_apply(cfg, tp, x3, decode=True, gather_experts=True)  # 6 > 4
    assert calls == ["moe_apply_dispatch", "moe_apply_dense",
                     "moe_apply_gather", "moe_apply_dense"]


def test_shared_experts_match_reference():
    """reduced(qwen3, n_shared_experts=1): the shared expert's MLP is
    added to every path."""
    jcfg, cfg, jp, tp = _layer(n_shared_experts=1)
    assert "shared_up" in tp
    x, jx = _x(7, 2, 8, cfg.d_model)
    _same_routing(cfg, jcfg, tp, jp, x, jx)
    _close(moe._shared(cfg, tp, x), j_moe._shared(jcfg, jp, jx))
    _close(moe.moe_apply_dispatch(cfg, tp, x)[0],
           j_moe.moe_apply_dispatch(jcfg, jp, jx)[0])
    _close(moe.moe_apply_dense(cfg, tp, x)[0],
           j_moe.moe_apply_dense(jcfg, jp, jx)[0])
    x1, jx1 = _x(8, 2, 1, cfg.d_model)
    _close(moe.moe_apply_gather(cfg, tp, x1)[0],
           j_moe.moe_apply_gather(jcfg, jp, jx1)[0])


def test_backward_matches_reference():
    """Gradients of mean(y²) + aux through dispatch at cf 1.25, for every
    expert leaf and the router, against ``jax.grad``."""
    jcfg, cfg, jp, tp = _layer(capacity_factor=1.25)
    x, jx = _x(5, 2, 16, cfg.d_model)
    _same_routing(cfg, jcfg, tp, jp, x, jx)

    def jloss(p_):
        y, aux = j_moe.moe_apply_dispatch(jcfg, p_, jx)
        return jnp.mean(jnp.square(y)) + aux
    jg = jax.grad(jloss)(jp)
    params = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    y, aux = moe.moe_apply_dispatch(cfg, params, x)
    (torch.mean(torch.square(y)) + aux).backward()
    for name in sorted(jp):
        g = params[name].grad
        assert bool(torch.isfinite(g).all()), name
        _close(g, jg[name], atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------------- model

@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _cfgs()
    jm, m = j_build_model(jcfg, max_seq=64), build_model(cfg, max_seq=64)
    jp = j_common.materialize(jm.param_specs, jax.random.key(0))
    return jcfg, cfg, jm, m, jp, to_torch(jp)


def test_model_forward_loss_and_aux_match_reference(model):
    """The reduced model's logits, its loss with the aux of both MoE
    blocks added (carried through the layer loop) and its aux alone; and
    the gradient of the loss for the first block's experts and router."""
    jcfg, cfg, jm, m, jp, tp = model
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32))
    toks = toks.astype(np.int32)
    _close(m.forward_fn(tp, {"tokens": torch.from_numpy(toks)}),
           jm.forward_fn(jp, {"tokens": jnp.asarray(toks)}),
           atol=1e-4, rtol=1e-4)
    batch = {"tokens": torch.from_numpy(toks), "labels":
             torch.from_numpy(toks)}
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (jloss, jaux), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, jbatch)
    params = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    loss, aux = m.loss_fn(params, batch)
    loss.backward()
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert float(jaux["aux"]) > 0
    assert abs(float(aux["aux"]) - float(jaux["aux"])) <= 1e-6
    for name in ("router", "w_up", "w_gate", "w_down"):
        g = params["blocks"]["moe"][name].grad
        assert float(g[0].abs().max()) > 0, name
        _close(g, jg["blocks"]["moe"][name], atol=1e-4, rtol=1e-4)


def test_cached_prefill_takes_the_dense_form(model, monkeypatch):
    """A call with caches (a cached prefill chunk, and decode) routes
    every MoE block through the dense form, as in ``repro``; the logits
    equal ``repro``'s ``decode_fn`` over a two-chunk prefill and 4 decode
    steps, greedy tokens equal."""
    jcfg, cfg, jm, m, jp, tp = model
    seen = []
    dense = moe.moe_apply_dense
    monkeypatch.setattr(moe, "moe_apply_dense",
                        lambda *a, **k: (seen.append(a[2].shape[1]),
                                         dense(*a, **k))[1])
    B, P, G = 2, 12, 4
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, P))
    toks = toks.astype(np.int32)
    from repro.models.model_api import build_cache_specs as jbcs
    caches = tree_map(lambda s: torch.zeros(s.shape),
                      build_cache_specs(cfg, B, P + G))
    jcaches = jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.float32),
                           jbcs(jcfg, B, P + G), is_leaf=j_common.is_spec)
    for t0, t1 in ((0, 8), (8, 12)):
        logits, caches = m.decode_fn(
            tp, {"tokens": torch.from_numpy(toks[:, t0:t1])}, caches, t0)
        jlogits, jcaches = jm.decode_fn(
            jp, {"tokens": jnp.asarray(toks[:, t0:t1])}, jcaches, t0)
        _close(logits, jlogits, atol=1e-4, rtol=1e-4)
    for t in range(P, P + G):
        nxt = logits[:, -1].argmax(-1).to(torch.int32)
        jnxt = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        logits, caches = m.decode_fn(tp, {"tokens": nxt[:, None]}, caches, t)
        jlogits, jcaches = jm.decode_fn(jp, {"tokens": jnxt[:, None]},
                                        jcaches, t)
        _close(logits, jlogits, atol=1e-4, rtol=1e-4)
    assert seen == [8, 8, 4, 4] + [1, 1] * G


def test_gather_experts_decode_matches_dense(model):
    """``build_model(gather_experts=True)``'s one-token decode steps (B·k
    = 4 <= E = 4: the gather form) give the dense decode's logits. As in
    ``repro``, the gather form takes one token: a multi-token chunk
    through it raises."""
    _, cfg, _, m, _, tp = model
    mg = build_model(cfg, max_seq=64, gather_experts=True)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 5)).astype(np.int32))
    outs = []
    for mm in (m, mg):
        caches = tree_map(lambda s: torch.zeros(s.shape),
                          build_cache_specs(cfg, 2, 8))
        for t in range(5):
            logits, caches = mm.decode_fn(tp, {"tokens": toks[:, t:t + 1]},
                                          caches, t)
            outs.append(logits)
    for a, b in zip(outs[5:], outs[:5]):
        _close(a, b, atol=1e-4, rtol=1e-4)
    caches = tree_map(lambda s: torch.zeros(s.shape),
                      build_cache_specs(cfg, 2, 8))
    with pytest.raises(ValueError, match="one token"):
        mg.decode_fn(tp, {"tokens": toks[:, :4]}, caches, 0)


def test_check_family_admits_moe_without_mla():
    """The MoE family without MLA, and with MLA, ``first_k_dense`` and
    MTP, builds; so do the multimodal and encoder-decoder families, which
    the split plane refuses with ``repro``'s ``ValueError``
    (``check_family`` is gone)."""
    assert not hasattr(transformer, "check_family")
    assert "mtp" in build_model(
        reduced(get_config("deepseek-v3-671b"))).param_specs
    for arch in MODALITY_ARCHS:
        split_plane_refusal(arch)
    cfg = reduced(get_config(ARCH))
    assert len(tree_leaves(build_model(cfg).param_specs)) > 0
    # a leading dense layer and the MTP head on the Qwen3 blocks build
    specs = build_model(dataclasses.replace(cfg, first_k_dense=1)).param_specs
    assert "mlp" in specs["dense_blocks"] and "moe" in specs["blocks"]
    assert specs["blocks"]["moe"]["w_up"].shape[0] == cfg.n_layers - 1
    specs = build_model(dataclasses.replace(cfg, n_mtp=1)).param_specs
    assert sorted(specs["mtp"]) == ["block", "norm", "proj"]
    assert "dense_blocks" not in specs
