"""The port's LM building blocks (``repro_torch.models``) against the JAX
package's, on ``reduced(phi3-mini-3.8b)`` in f32 (``param_dtype`` and
``dtype`` float32) with params carried from ``repro`` through
``params_from_numpy``: norms, RoPE, activations, embeddings, the MLP,
attention (plain chunked, decode, and the sub-layer's no-cache, decode,
chunked-prefill and paged-decode branches) and the full forward with its KV cache; and the
param spec trees and init kinds.

Tolerance: f32 2e-5 on activations of order one (f32 math both sides,
matmuls summed in other orders). The reduced model's weights are large
(the ``scaled`` init takes its fan-in from the stacked layer axis, 2 here,
so they have std 0.7): attention scores reach the hundreds and the
residual stream the thousands. Sub-layer outputs are held to 1e-3 plus a
relative 2e-5, and logits (order 1) to 1e-4 plus a relative 1e-4. The KV
cache is bf16 in both packages whatever the model dtype, and a value
within f32 rounding of a bf16 rounding boundary may round either way: the
cache is held to a relative 1e-2 (two bf16 steps), and logits computed
over it to 3e-4 (one such flip of a v entry moved them by 2e-4 in the
forward test's data)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import layers as j_layers
from repro.models import mlp as j_mlp
from repro.models import transformer as j_transformer
from repro.models.model_api import build_cache_specs as j_build_cache_specs
from repro.models.model_api import build_model as j_build_model
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention, common, layers, mlp, transformer
from repro_torch.models.model_api import build_cache_specs, build_model
from test_torch_support import to_numpy, to_torch

F32 = dict(param_dtype="float32", dtype="float32")
ATOL = 2e-5


def _cfgs(arch="phi3-mini-3.8b", **kw):
    return (j_reduced(j_get_config(arch), **{**F32, **kw}),
            reduced(get_config(arch), **{**F32, **kw}))


LOGITS = dict(atol=1e-4, rtol=1e-4)
LOGITS_OVER_CACHE = dict(atol=3e-4, rtol=1e-4)


def _close(ours, theirs, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(to_numpy(ours), to_numpy(theirs), atol=atol,
                               rtol=rtol)


def _rand(seed, *shape, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale)
    a = a.astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


@pytest.fixture(scope="module")
def phi3():
    """(jcfg, cfg, global params as jax and as torch trees)."""
    jcfg, cfg = _cfgs()
    jp = j_common.materialize(j_build_model(jcfg, max_seq=64).param_specs,
                              jax.random.key(0))
    return jcfg, cfg, jp, to_torch(jp)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# ---------------------------------------------------------------- specs ----

def _spec_tuples(tree, is_spec):
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)[0]
    return {jax.tree_util.keystr(p): (tuple(s.shape), s.dtype, s.logical,
                                      s.init, s.scale) for p, s in leaves}


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "granite-20b",
                                  "nemotron-4-15b", "internlm2-20b"])
@pytest.mark.parametrize("full", [False, True])
def test_param_and_cache_specs_equal(arch, full):
    """Same key paths, shapes, dtypes, logical axes and init kinds as the
    JAX package's, reduced and at full width (specs only, no tensors)."""
    jcfg, cfg = (j_get_config(arch), get_config(arch)) if full else _cfgs(arch)
    ours = build_model(cfg, max_seq=48).param_specs
    theirs = j_build_model(jcfg, max_seq=48).param_specs
    assert (_spec_tuples(ours, common.is_spec)
            == _spec_tuples(theirs, j_common.is_spec))
    assert common.param_count(ours) == j_common.param_count(theirs)
    assert common.param_bytes(ours) == j_common.param_bytes(theirs)
    assert (_spec_tuples(build_cache_specs(cfg, 3, 48), common.is_spec)
            == _spec_tuples(j_build_cache_specs(jcfg, 3, 48),
                            j_common.is_spec))


def test_materialize_init_kinds():
    """zeros / ones exact; normal at its scale; scaled at 1/sqrt(shape[0])
    — after stack_layer_specs that is the layer count, as in repro."""
    specs = common.stack_layer_specs({
        "z": common.ParamSpec((8,), "float32", init="zeros"),
        "o": common.ParamSpec((8,), "bfloat16", init="ones"),
        "n": common.ParamSpec((64, 512), "float32", init="normal",
                              scale=0.5),
        "s": common.ParamSpec((64, 512), "float32", init="scaled")}, 4)
    assert specs["s"].shape == (4, 64, 512)
    assert specs["s"].logical == ("layers", None, None)
    p = common.materialize(specs, torch.Generator().manual_seed(0))
    assert p["z"].dtype == torch.float32 and not p["z"].any()
    assert p["o"].dtype == torch.bfloat16 and bool((p["o"] == 1).all())
    assert float(p["n"].std()) == pytest.approx(0.5, rel=0.02)
    assert float(p["s"].std()) == pytest.approx(4 ** -0.5, rel=0.02)


def test_bf16_params_cross_from_jax():
    """repro's bf16 leaves (ml_dtypes arrays) load bit for bit."""
    a = jax.random.normal(jax.random.key(1), (3, 5), jnp.bfloat16)
    t = common.params_from_numpy({"w": np.asarray(a)})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a, np.float32))


# ---------------------------------------------------------- primitives ----

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm(norm, dtype):
    jcfg, cfg = _cfgs(norm=norm)
    x, jx = _rand(0, 2, 5, 128, scale=3.0)
    sc, jsc = _rand(1, 128)
    b, jb = _rand(2, 128)
    p, jp = {"scale": sc, "bias": b}, {"scale": jsc, "bias": jb}
    x, jx = x.to(getattr(torch, dtype)), jx.astype(getattr(jnp, dtype))
    ours = layers.apply_norm(cfg, p, x)
    assert ours.dtype == x.dtype
    _close(ours, j_layers.apply_norm(jcfg, jp, jx),
           atol=ATOL if dtype == "float32" else 2e-2)
    _close(layers.rms_norm_simple(x, sc),
           j_layers.rms_norm_simple(jx, jsc),
           atol=ATOL if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("has_heads", [True, False])
def test_apply_rope(has_heads):
    shape = (2, 7, 4, 32) if has_heads else (2, 7, 32)
    x, jx = _rand(3, *shape, scale=5.0)
    pos = np.arange(7) + 13
    ours = layers.apply_rope(x, torch.from_numpy(pos), 10_000.0,
                             has_heads=has_heads)
    _close(ours, j_layers.apply_rope(jx, jnp.asarray(pos), 10_000.0,
                                     has_heads=has_heads))
    one = layers.apply_rope(x[:, :1], torch.tensor([9]), 10_000.0,
                            has_heads=has_heads)
    _close(one, j_layers.apply_rope(jx[:, :1], jnp.asarray([9]), 10_000.0,
                                    has_heads=has_heads), atol=ATOL)


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu2"])
def test_activation(act):
    x, jx = _rand(4, 3, 40, scale=2.0)
    g, jg = _rand(5, 3, 40, scale=2.0)
    _close(layers.activation(act, x, g), j_layers.activation(act, jx, jg))


@pytest.mark.parametrize("iota", [False, True])
def test_embed_lookup_and_unembed(iota):
    t, jt = _rand(6, 40, 16)
    toks = np.random.default_rng(7).integers(0, 40, (2, 9)).astype(np.int32)
    e = layers.embed_lookup({"table": t}, torch.from_numpy(toks), iota=iota)
    _close(e, j_layers.embed_lookup({"table": jt}, jnp.asarray(toks),
                                    iota=iota))
    _close(layers.unembed({"table": t}, e),
           j_layers.unembed({"table": jt}, jnp.asarray(to_numpy(e))))


@pytest.mark.parametrize("act", ["swiglu", "relu2"])
def test_mlp_apply(act):
    jcfg, cfg = _cfgs(act=act)
    jp = j_common.materialize(j_mlp.mlp_specs(jcfg, 128, 256),
                              jax.random.key(2))
    x, jx = _rand(8, 2, 5, 128)
    _close(mlp.mlp_apply(cfg, to_torch(jp), x),
           j_mlp.mlp_apply(jcfg, jp, jx), atol=1e-4, rtol=ATOL)


# ------------------------------------------------------------- attention --

@pytest.mark.parametrize("kw", [
    dict(), dict(window=3), dict(logit_softcap=5.0), dict(q_offset=4),
    dict(causal=False), dict(q_chunk=3)])
def test_mha_chunked(kw):
    """The CPU path of attention: ragged query chunks (Sq = 7, chunk 3),
    GQA, offsets, windows and softcap as repro's."""
    q, jq = _rand(9, 2, 7, 4, 32)
    k, jk = _rand(10, 2, 11, 2, 32)
    v, jv = _rand(11, 2, 11, 2, 32)
    _close(attention.mha_chunked(q, k, v, **kw),
           j_attn.mha_chunked(jq, jk, jv, **kw))


@pytest.mark.parametrize("kw", [dict(), dict(window=4),
                                dict(window=4, window_gather=True),
                                dict(logit_softcap=5.0)])
def test_decode_attend(kw):
    q, jq = _rand(12, 2, 1, 4, 32)
    k, jk = _rand(13, 2, 12, 2, 32)
    v, jv = _rand(14, 2, 12, 2, 32)
    _close(attention.decode_attend(q, k, v, 6, **kw),
           j_attn.decode_attend(jq, jk, jv, 6, **kw))


def test_attention_apply_branches(phi3):
    """No-cache, chunked-prefill (S > 1 with a cache) and decode (S = 1)
    on layer 0 of reduced phi3; the bf16 cache is written in place where
    repro returns a new one."""
    jcfg, cfg, jp, tp = phi3
    jpa, tpa = _layer0(jp["blocks"]["attn"]), _layer0(tp["blocks"]["attn"])
    x, jx = _rand(15, 2, 7, 128)
    pos = np.arange(6)
    out, c = attention.attention_apply(cfg, tpa, x[:, :6],
                                       positions=torch.from_numpy(pos))
    jout, _ = j_attn.attention_apply(jcfg, jpa, jx[:, :6],
                                     positions=jnp.asarray(pos))
    assert c is None
    _close(out, jout, atol=1e-3, rtol=ATOL)

    spec = build_cache_specs(cfg, 2, 10)
    cache = {k: torch.zeros(s.shape[1:], dtype=torch.bfloat16)
             for k, s in spec.items()}
    jcache = {k: jnp.zeros(s.shape[1:], jnp.bfloat16) for k, s in spec.items()}
    for t0, n in ((0, 4), (4, 2), (6, 1)):        # two chunks, one decode
        pos = np.arange(t0, t0 + n)
        out, c = attention.attention_apply(
            cfg, tpa, x[:, t0:t0 + n], positions=torch.from_numpy(pos),
            cache=cache, cur_pos=t0)
        jout, jcache = j_attn.attention_apply(
            jcfg, jpa, jx[:, t0:t0 + n], positions=jnp.asarray(pos),
            cache=jcache, cur_pos=t0)
        assert c is cache
        _close(out, jout, atol=1e-3, rtol=ATOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(to_numpy(cache[name]),
                                       to_numpy(jcache[name]), rtol=1e-2)


def test_paged_decode_equals_solo_decode(phi3):
    """The ``paging=`` branch: three slots over a shared page pool (page
    size 2), each at its own position, the third inactive. Each active
    row's output equals the dense decode of that row alone at its
    position (B = 1, the solo path), its new k/v row lands in its own
    page, and the inactive row writes only the trash page."""
    _, cfg, _, tp = phi3
    tpa = _layer0(tp["blocks"]["attn"])
    pg, n_pages, S = 2, 20, 10
    g = torch.Generator().manual_seed(4)
    x = torch.randn(3, S, cfg.d_model, generator=g)
    hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    spec = build_cache_specs(cfg, 1, S)
    # dense per-row caches after a prefill of each row's prefix
    cur = torch.tensor([6, 3, 5])
    dense = []
    for b in range(3):
        cache = {k: torch.zeros(s.shape[1:], dtype=torch.bfloat16)
                 for k, s in spec.items()}
        n = int(cur[b])
        attention.attention_apply(cfg, tpa, x[b:b + 1, :n],
                                  positions=torch.arange(n), cache=cache,
                                  cur_pos=0)
        dense.append(cache)
    tables = torch.tensor([[5, 9, 2, 14, 7], [11, 3, 16, 4, 8],
                           [0, 0, 0, 0, 0]], dtype=torch.int32)
    active = torch.tensor([1, 1, 0])
    pool = {k: torch.full((n_pages, pg, hkv, hd), 7.0, dtype=torch.bfloat16)
            for k in ("k", "v")}
    for k in pool:
        pool[k][0] = 0                                # the zero page
        for b in range(2):
            rows = (tables[b, :, None].long() * pg
                    + torch.arange(pg)).reshape(-1)
            pool[k].view(n_pages * pg, hkv, hd)[rows] = dense[b][k][0]
    ctx = common.PageContext.for_step(tables, active, cur, pg)
    step = x[torch.arange(3), cur][:, None]
    out, got_pool = attention.attention_apply(
        cfg, tpa, step, positions=cur[:, None], cache=pool, cur_pos=cur,
        paging=ctx)
    assert got_pool is pool
    for b in range(2):
        n = int(cur[b])
        solo, _ = attention.attention_apply(
            cfg, tpa, step[b:b + 1], positions=torch.tensor([n]),
            cache=dense[b], cur_pos=n)
        # the sub-layer tolerance above (a B = 3 product against B = 1),
        # and the bf16 cache rows to one relative bf16 step
        _close(out[b:b + 1], solo, atol=1e-3, rtol=ATOL)
        for k in pool:
            page, slot = int(tables[b, n // pg]), n % pg
            np.testing.assert_allclose(to_numpy(pool[k][page, slot]),
                                       to_numpy(dense[b][k][0, n]),
                                       rtol=1e-2)
    # the inactive row wrote the trash page, never its table's zero page
    assert not pool["k"][0].any()
    assert (pool["k"][1] != 7.0).any()


def test_unported_branches_raise(phi3):
    """Nothing the model API reaches raises as unported any more: the
    cross-attention branch (``kv_override``) equals ``repro``'s on a
    Phi-3 layer (no RoPE on a cross call), and the encoder-decoder,
    multimodal and DeepSeek-V3 trees build with ``repro``'s key paths."""
    jcfg, cfg, jp, tp = phi3
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1, 2, 128)).astype(np.float32)
    src = rng.normal(size=(1, 5, 128)).astype(np.float32)
    out, cache = attention.attention_apply(
        cfg, _layer0(tp["blocks"]["attn"]), torch.from_numpy(x),
        positions=torch.arange(2), kv_override=torch.from_numpy(src))
    want, _ = j_attn.attention_apply(
        jcfg, jax.tree.map(lambda a: a[0], jp["blocks"]["attn"]),
        jnp.asarray(x), positions=jnp.arange(2),
        kv_override=jnp.asarray(src))
    assert cache is None
    np.testing.assert_allclose(to_numpy(out), to_numpy(want), atol=2e-5,
                               rtol=1e-4)
    for arch in ("whisper-medium", "internvl2-26b", "deepseek-v3-671b"):
        specs = build_model(reduced(get_config(arch))).param_specs
        jspecs = j_build_model(j_reduced(j_get_config(arch))).param_specs
        assert sorted(specs) == sorted(jspecs)


# ---------------------------------------------------------------- forward --

def test_forward_with_and_without_cache(phi3):
    """The whole model: one no-cache forward over the prompt, then a
    chunked prefill of two chunks and two decode steps against the stacked
    bf16 cache, each step's logits and the cache against repro's."""
    jcfg, cfg, jp, tp = phi3
    toks = np.random.default_rng(16).integers(0, cfg.vocab_size, (2, 9))
    toks = toks.astype(np.int32)
    logits, _, _ = transformer.forward(cfg, tp, {"tokens": torch.from_numpy(
        toks)})
    jlogits, _, _ = j_transformer.forward(jcfg, jp,
                                          {"tokens": jnp.asarray(toks)})
    assert logits.shape == (2, 9, cfg.padded_vocab)
    _close(logits, jlogits, **LOGITS)

    model, jmodel = build_model(cfg, max_seq=12), j_build_model(jcfg,
                                                                max_seq=12)
    caches = {k: torch.zeros(s.shape, dtype=torch.bfloat16)
              for k, s in build_cache_specs(cfg, 2, 12).items()}
    jcaches = {k: jnp.zeros(s.shape, jnp.bfloat16)
               for k, s in j_build_cache_specs(jcfg, 2, 12).items()}
    for t0, t1 in ((0, 5), (5, 7), (7, 8), (8, 9)):
        inp = {"tokens": torch.from_numpy(toks[:, t0:t1])}
        logits, caches = model.decode_fn(tp, inp, caches, t0)
        jlogits, jcaches = jmodel.decode_fn(
            jp, {"tokens": jnp.asarray(toks[:, t0:t1])}, jcaches, t0)
        _close(logits, jlogits, **LOGITS_OVER_CACHE)
    for name in ("k", "v"):
        np.testing.assert_allclose(to_numpy(caches[name]),
                                   to_numpy(jcaches[name]), rtol=1e-2)
    _close(model.forward_fn(tp, {"tokens": torch.from_numpy(toks)}),
           jmodel.forward_fn(jp, {"tokens": jnp.asarray(toks)}), **LOGITS)


def test_forward_learned_positions_layernorm():
    """granite's family: learned position table and LayerNorm."""
    jcfg, cfg = _cfgs("granite-20b")
    jp = j_common.materialize(j_build_model(jcfg, max_seq=16).param_specs,
                              jax.random.key(3))
    toks = np.random.default_rng(17).integers(0, cfg.vocab_size, (2, 6))
    ours = build_model(cfg, max_seq=16).forward_fn(
        to_torch(jp), {"tokens": torch.from_numpy(toks.astype(np.int32))})
    theirs = j_build_model(jcfg, max_seq=16).forward_fn(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    _close(ours, theirs, **LOGITS)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
