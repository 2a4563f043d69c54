"""DeepSeek-V3 in the port: multi-head latent attention
(``repro_torch.models.attention``'s MLA branch), the ``first_k_dense``
stack, the MTP head in ``lm_loss``, the {"dense", "main"} latent cache and
the server partition without MTP, against the JAX package's, on the CPU in
f32 with inputs from numpy seeds and params carried from ``repro``; the
flash kernel's plain version and argument checks at the (d_qk, d_v) pair
MLA needs; ``materialize``'s slicing and the depth cut.

The configs are reduced DeepSeek-V3 with a q/k head dim unlike its v head
dim (``qk_nope_dim`` 32 + ``qk_rope_dim`` 16 = 48 against ``v_head_dim``
32; ``reduced()`` alone gives 32 and 32): 2 layers, the first dense, the
second MoE (4 experts top-2), and the depth-1 MTP head.

Tolerances: attention outputs and the latent cache 2e-5 absolute and
1e-4 relative (f32 on both sides, summed in other orders); the whole
model's logits 1e-4 (``tests/test_torch_moe.py``'s, with routing held
equal first); the loss a relative 1e-5; the absorbed decode against the
expanded one ``repro``'s own atol 2e-3, rtol 1e-3
(``tests/test_perf_variants.py``)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.adapters import from_model_config as j_from_model_config
from repro.core.adapters import lm_engine_params as j_lm_engine_params
from repro.models import attention as j_attention
from repro.models import common as j_common
from repro.models import transformer as j_transformer
from repro.models.model_api import build_cache_specs as j_build_cache_specs
from repro.models.model_api import build_model as j_build_model
from repro_torch.configs import cut_depth, get_config, reduced
from repro_torch.core.adapters import from_model_config
from repro_torch.core.partition import lm_engine_params
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.launch import serve
from repro_torch.models import attention, common, transformer
from repro_torch.models.model_api import build_cache_specs, build_model
from repro_torch.tree import tree_leaves, tree_map
from test_torch_support import (MODALITY_ARCHS, split_plane_refusal,
                                to_numpy, to_torch, torch_threads)

ARCH = "deepseek-v3-671b"
MLA = dict(param_dtype="float32", dtype="float32", qk_nope_dim=32,
           qk_rope_dim=16, v_head_dim=32)
ATTN_TOL = dict(atol=2e-5, rtol=1e-4)
LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _threads():
    with torch_threads(2):
        yield


def _cfgs(**kw):
    return (j_reduced(j_get_config(ARCH), **{**MLA, **kw}),
            reduced(get_config(ARCH), **{**MLA, **kw}))


def _close(ours, theirs, **tol):
    np.testing.assert_allclose(to_numpy(ours), to_numpy(theirs),
                               **(tol or ATTN_TOL))


def _spec_tuples(tree):
    return [(tuple(s.shape), str(s.dtype), tuple(s.logical), s.init)
            for s in tree_leaves(tree)]


def _j_spec_tuples(tree):
    return [(tuple(s.shape), str(s.dtype), tuple(s.logical), s.init)
            for s in jax.tree.leaves(tree, is_leaf=j_common.is_spec)]


def _layer(seed=0, **kw):
    """One MLA layer's params, carried from ``repro``."""
    jcfg, cfg = _cfgs(**kw)
    jp = j_common.materialize(j_attention.attention_specs(jcfg),
                              jax.random.key(seed))
    return jcfg, cfg, jp, to_torch(jp)


def _x(seed, *shape):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


def _latent_cache(cfg, B, S):
    """A zero per-layer latent cache (B, S, r + rd) in f32, both packages."""
    width = cfg.kv_lora_rank + cfg.qk_rope_dim
    return ({"latent": torch.zeros(B, S, width)},
            {"latent": jnp.zeros((B, S, width), jnp.float32)})


# ------------------------------------------------------------------ specs

def test_specs_match_reference():
    """The MLA leaves in ``repro``'s (in, out) layout and key names, the
    latent cache leaf, the {"dense", "main"} cache split and the
    backbone's dense_blocks / blocks / mtp trees."""
    jcfg, cfg = _cfgs()
    assert sorted(attention.attention_specs(cfg)) == [
        "kv_norm", "q_norm", "wkv_a", "wkv_b", "wo", "wq_a", "wq_b"]
    assert (_spec_tuples(attention.attention_specs(cfg))
            == _j_spec_tuples(j_attention.attention_specs(jcfg)))
    assert (_spec_tuples(attention.cache_specs(cfg, 2, 12))
            == _j_spec_tuples(j_attention.cache_specs(jcfg, 2, 12)))
    caches = build_cache_specs(cfg, 2, 12)
    assert sorted(caches) == ["dense", "main"]
    assert {k: sorted(v) for k, v in caches.items()} == {
        "dense": ["latent"], "main": ["latent"]}
    assert caches["dense"]["latent"].shape == (1, 2, 12, 32 + 16)
    assert (_spec_tuples(caches)
            == _j_spec_tuples(j_build_cache_specs(jcfg, 2, 12)))
    specs = build_model(cfg).param_specs
    jspecs = j_build_model(jcfg).param_specs
    assert sorted(specs) == sorted(jspecs)
    assert {"dense_blocks", "blocks", "mtp"} <= set(specs)
    assert sorted(specs["mtp"]) == ["block", "norm", "proj"]
    assert _spec_tuples(specs) == _j_spec_tuples(jspecs)


def test_check_family_admits_deepseek_only_of_the_later_families():
    """No family is refused by the model API any more (``check_family``
    is gone): DeepSeek-V3 builds at full and reduced size and crosses the
    split plane; the multimodal and encoder-decoder families build and the
    split plane refuses them with ``repro``'s ``ValueError``."""
    assert not hasattr(transformer, "check_family")
    for cfg in (reduced(get_config(ARCH)), get_config(ARCH)):
        assert "mtp" in build_model(cfg).param_specs
    from_model_config(reduced(get_config(ARCH)), n_clients=2, seq_len=16)
    for arch in MODALITY_ARCHS:
        split_plane_refusal(arch)


def test_cut_depth_keeps_dense_layers_first():
    cfg = get_config(ARCH)
    assert cut_depth(cfg, 0) is cfg
    for n, dense in ((5, 3), (4, 3), (3, 3), (2, 2)):
        cut = cut_depth(cfg, n)
        assert (cut.n_layers, cut.first_k_dense) == (n, dense)
        assert cut.d_model == cfg.d_model and cut.n_experts == 256
    phi3 = get_config("phi3-mini-3.8b")
    assert cut_depth(phi3, 4) == dataclasses.replace(phi3, n_layers=4)


# ------------------------------------------------------- mla_apply branches

def test_mla_no_cache_matches_reference():
    jcfg, cfg, jp, tp = _layer()
    x, jx = _x(1, 2, 12, cfg.d_model)
    out, cache = attention.mla_apply(cfg, tp, x, positions=torch.arange(12))
    jout, _ = j_attention.mla_apply(jcfg, jp, jx, positions=jnp.arange(12))
    assert cache is None and out.shape == (2, 12, cfg.d_model)
    _close(out, jout)


def test_mla_chunked_prefill_and_decode_match_reference():
    """Two prefill chunks (S > 1 against the latent cache, offset 8) and
    three one-token decode steps; each output and the latent cache against
    ``repro``'s; the cache is written in place and returned."""
    jcfg, cfg, jp, tp = _layer(seed=2)
    x, jx = _x(3, 2, 15, cfg.d_model)
    cache, jcache = _latent_cache(cfg, 2, 16)
    leaf = cache["latent"]
    spans = [(0, 8), (8, 12), (12, 13), (13, 14), (14, 15)]
    for t0, t1 in spans:
        out, cache = attention.mla_apply(
            cfg, tp, x[:, t0:t1], positions=torch.arange(t0, t1),
            cache=cache, cur_pos=t0)
        jout, jcache = j_attention.mla_apply(
            jcfg, jp, jx[:, t0:t1], positions=jnp.arange(t0, t1),
            cache=jcache, cur_pos=t0)
        _close(out, jout)
        _close(cache["latent"], jcache["latent"])
    assert cache["latent"] is leaf
    assert not bool(leaf[:, 15:].any()) and bool(leaf[:, :15].any())


@pytest.mark.parametrize("absorb", [False, True],
                         ids=["expanded", "absorbed"])
def test_mla_device_position_decode_equals_int_position(absorb):
    """The captured step's form: a one-token step at a (1,) int64 device
    position writes the same cache row and gives the same output as at a
    Python-int position, bitwise."""
    _, cfg, _, tp = _layer(seed=4, mla_absorb=absorb)
    x, _ = _x(5, 2, 7, cfg.d_model)
    outs = []
    for dev in (False, True):
        cache, _ = _latent_cache(cfg, 2, 8)
        attention.mla_apply(cfg, tp, x[:, :6], positions=torch.arange(6),
                            cache=cache, cur_pos=0)
        pos = torch.tensor([6]) if dev else 6
        out, cache = attention.mla_apply(
            cfg, tp, x[:, 6:7], positions=torch.full((1,), 6), cache=cache,
            cur_pos=pos)
        outs.append((out, cache["latent"].clone()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def _page_case(cfg, seed):
    """A 3-slot paged step: slot 0 at position 5, slot 1 at 2, slot 2
    inactive; pages of 4 rows, 2 pages a slot, pool rows written with the
    slots' earlier latents (and garbage on a free page)."""
    width = cfg.kv_lora_rank + cfg.qk_rope_dim
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((8, 4, width)).astype(np.float32)
    tables = np.array([[2, 3], [4, 0], [5, 6]], np.int32)
    active = np.array([1, 1, 0], np.int32)
    cur = np.array([5, 2, 3], np.int64)
    return pool, tables, active, cur


@pytest.mark.parametrize("absorb", [False, True],
                         ids=["expanded", "absorbed"])
def test_mla_paged_decode_matches_reference(absorb):
    """The paged branch over the latent pool (the continuous scheduler's
    batched step) against ``repro``'s: the output of each active slot,
    and the pool after the write (the inactive slot's row on the trash
    page, which nothing reads, left out)."""
    jcfg, cfg, jp, tp = _layer(seed=6, mla_absorb=absorb)
    pool, tables, active, cur = _page_case(cfg, 7)
    x, jx = _x(8, 3, 1, cfg.d_model)
    ctx = common.PageContext.for_step(torch.from_numpy(tables),
                                      torch.from_numpy(active),
                                      torch.from_numpy(cur), 4)
    tpool = {"latent": torch.from_numpy(pool.copy())}
    out, tpool = attention.mla_apply(cfg, tp, x,
                                     positions=torch.from_numpy(cur)[:, None],
                                     cache=tpool,
                                     cur_pos=torch.from_numpy(cur),
                                     paging=ctx)
    jctx = j_common.PageContext(tables=jnp.asarray(tables),
                                active=jnp.asarray(active), page_size=4)
    jout, jpool = j_attention.mla_apply(
        jcfg, jp, jx, positions=jnp.asarray(cur)[:, None],
        cache={"latent": jnp.asarray(pool)}, cur_pos=jnp.asarray(cur),
        paging=jctx)
    _close(out[:2], jout[:2])
    keep = [p for p in range(8) if p != 1]
    _close(tpool["latent"][keep], np.asarray(jpool["latent"])[keep])


def test_mla_absorbed_decode_matches_expanded():
    """``cfg.mla_absorb``: the weight-absorbed decode against the expanded
    decode on the same cache, at ``repro``'s own tolerance; and against
    ``repro``'s absorbed decode in f32."""
    jcfg, cfg, jp, tp = _layer(seed=9)
    x, jx = _x(10, 2, 10, cfg.d_model)
    outs = {}
    for absorb in (False, True):
        c = dataclasses.replace(cfg, mla_absorb=absorb)
        cache, _ = _latent_cache(cfg, 2, 12)
        attention.mla_apply(c, tp, x[:, :8], positions=torch.arange(8),
                            cache=cache, cur_pos=0)
        for t in (8, 9):
            out, cache = attention.mla_apply(
                c, tp, x[:, t:t + 1], positions=torch.full((1,), t),
                cache=cache, cur_pos=t)
        outs[absorb] = (out, cache)
    _close(outs[True][0], outs[False][0], atol=2e-3, rtol=1e-3)
    jc = dataclasses.replace(jcfg, mla_absorb=True)
    _, jcache = _latent_cache(cfg, 2, 12)
    _, jcache = j_attention.mla_apply(jc, jp, jx[:, :8],
                                      positions=jnp.arange(8), cache=jcache,
                                      cur_pos=0)
    for t in (8, 9):
        jout, jcache = j_attention.mla_apply(
            jc, jp, jx[:, t:t + 1], positions=jnp.full((1,), t),
            cache=jcache, cur_pos=t)
    _close(outs[True][0], jout)


# ------------------------------------------------------------- the model --

@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _cfgs()
    jm = j_build_model(jcfg, max_seq=32)
    m = build_model(cfg, max_seq=32)
    jp = j_common.materialize(jm.param_specs, jax.random.key(11))
    return jcfg, cfg, jm, m, jp, to_torch(jp)


def test_model_forward_and_decode_match_reference(model):
    """The first_k_dense model: the no-cache forward, then a two-chunk
    prefill and three decode steps over the {"dense", "main"} latent
    caches, greedy tokens and logits against ``repro``'s, and both
    stacks' caches."""
    jcfg, cfg, jm, m, jp, tp = model
    B, P, G = 2, 12, 3
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (B, P))
    toks = toks.astype(np.int32)
    _close(m.forward_fn(tp, {"tokens": torch.from_numpy(toks)}),
           jm.forward_fn(jp, {"tokens": jnp.asarray(toks)}), **LOGITS_TOL)
    caches = tree_map(lambda s: torch.zeros(s.shape),
                      build_cache_specs(cfg, B, P + G))
    jcaches = jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.float32),
                           j_build_cache_specs(jcfg, B, P + G),
                           is_leaf=j_common.is_spec)
    for t0, t1 in ((0, 8), (8, 12)):
        logits, caches = m.decode_fn(
            tp, {"tokens": torch.from_numpy(toks[:, t0:t1])}, caches, t0)
        jlogits, jcaches = jm.decode_fn(
            jp, {"tokens": jnp.asarray(toks[:, t0:t1])}, jcaches, t0)
        _close(logits, jlogits, **LOGITS_TOL)
    for t in range(P, P + G):
        nxt = logits[:, -1].argmax(-1).to(torch.int32)
        jnxt = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        logits, caches = m.decode_fn(tp, {"tokens": nxt[:, None]}, caches, t)
        jlogits, jcaches = jm.decode_fn(jp, {"tokens": jnxt[:, None]},
                                        jcaches, t)
        _close(logits, jlogits, **LOGITS_TOL)
    for part in ("dense", "main"):
        _close(caches[part]["latent"], jcaches[part]["latent"], atol=1e-4,
               rtol=1e-4)
        assert bool(caches[part]["latent"][:, :, :P + G].abs().sum() > 0)


def test_lm_loss_with_mtp_matches_reference(model):
    """The global loss: next-token CE + the MoE aux + 0.3 x the MTP head's
    loss, and its gradient at the MTP head, the dense stack and the MoE
    stack, against ``repro``'s; without the MTP tree the loss drops that
    term exactly."""
    jcfg, cfg, jm, m, jp, tp = model
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, 16))
    toks = toks.astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(toks)}
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (jloss, jaux), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, jbatch)
    params = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    loss, aux = m.loss_fn(params, batch)
    loss.backward()
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert abs(float(aux["aux"]) - float(jaux["aux"])) <= 1e-6
    for path in (("mtp", "proj"), ("mtp", "block", "attn", "wkv_b"),
                 ("mtp", "norm", "scale"), ("dense_blocks", "attn", "wq_a"),
                 ("blocks", "attn", "wo"), ("blocks", "moe", "w_up")):
        g, jgl = params, jg
        for k in path:
            g, jgl = g[k], jgl[k]
        assert float(g.grad.abs().max()) > 0, path
        _close(g.grad, jgl, atol=1e-4, rtol=1e-4)
    no_mtp = {k: v for k, v in tp.items() if k != "mtp"}
    mtp = transformer._mtp_loss(cfg, tp, batch)
    jmtp = j_transformer._mtp_loss(jcfg, jp, jbatch)
    assert abs(float(mtp) - float(jmtp)) <= 1e-5 * abs(float(jmtp))
    base = m.loss_fn(no_mtp, batch)[0]
    assert abs(float(base) + 0.3 * float(mtp) - float(loss)) <= 1e-5


def test_server_partition_leaves_out_mtp(model):
    """``lm_engine_params`` and ``from_model_config``'s server spec drop
    the MTP head, so the engine's global loss is the model's without it,
    as in ``repro``."""
    jcfg, cfg, jm, m, jp, tp = model
    eng = lm_engine_params(tp, 2)
    jeng = j_lm_engine_params(jp, 2)
    assert "mtp" not in eng["server"]
    assert sorted(eng["server"]) == sorted(jeng["server"])
    assert {"dense_blocks", "blocks"} <= set(eng["server"])
    ad = from_model_config(cfg, n_clients=2, seq_len=16)
    jad = j_from_model_config(jcfg, n_clients=2, seq_len=16)
    specs = ad.param_specs()
    assert "mtp" not in specs["server"]
    assert _spec_tuples(specs) == _j_spec_tuples(jad.param_specs())
    assert sorted(specs["server"]) == sorted(eng["server"])
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, (2, 16))
    toks = toks.astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(toks)}
    no_mtp = {k: v for k, v in tp.items() if k != "mtp"}
    want = float(m.loss_fn(no_mtp, batch)[0])
    x_parts = torch.from_numpy(toks).reshape(2, 2, 8).transpose(0, 1)
    c_all = ad.client_forward(eng["clients"], x_parts)
    got = float(ad.server_loss(eng["server"], c_all,
                               torch.from_numpy(toks)))
    assert abs(got - want) <= 1e-5 * abs(want)


# ------------------------------------------- the flash kernel at d_v != d

@pytest.mark.parametrize("d,dv,Sq,Skv,off,Hq,Hkv", [
    (48, 32, 12, 20, 8, 4, 4), (48, 32, 20, 20, 0, 4, 2),
    (192, 128, 9, 16, 7, 2, 2), (192, 128, 16, 16, 0, 2, 1)])
def test_flash_plain_version_takes_a_v_head_dim_of_its_own(d, dv, Sq, Skv,
                                                           off, Hq, Hkv):
    """``flash_attention_bshd_ref`` with v's head dim unlike q's and k's
    against ``repro``'s ``mha_chunked`` (its MLA path: scale from q's head
    dim, output in v's), causal from ``q_offset`` over a cache zero past
    it; the wrapper's CPU path at the kernel's (192, 128) pair."""
    rng = np.random.default_rng(d + Sq + off)
    q, k = (rng.standard_normal(s).astype(np.float32)
            for s in ((2, Sq, Hq, d), (2, Skv, Hkv, d)))
    v = rng.standard_normal((2, Skv, Hkv, dv)).astype(np.float32)
    k[:, off + Sq:], v[:, off + Sq:] = 0, 0
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    ours = flash_ref.flash_attention_bshd_ref(tq, tk, tv, causal=True,
                                              q_offset=off)
    assert ours.shape == (2, Sq, Hq, dv)
    theirs = j_attention.mha_chunked(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True,
                                     q_offset=off)
    _close(ours, theirs)
    _close(attention.mha_chunked(tq, tk, tv, causal=True, q_offset=off),
           theirs)
    if (d, dv) in flash_ops.HEAD_DIMS:
        got = flash_ops.flash_attention_bshd(tq, tk, tv, causal=True,
                                             q_offset=off)
        assert torch.equal(got, ours)


def test_flash_wrapper_takes_only_instantiated_head_dim_pairs():
    """``ops._validate`` accepts (192, 128) and every (d, d) the kernel
    instantiates, and raises for any other pair, on either device."""
    assert (192, 128) in flash_ops.HEAD_DIMS
    assert {(d, d) for d in range(16, 129, 16)} < flash_ops.HEAD_DIMS
    assert len(flash_ops.HEAD_DIMS) == 9

    def ops(d, dv):
        return (torch.zeros(1, 4, 2, d), torch.zeros(1, 4, 2, d),
                torch.zeros(1, 4, 2, dv))
    assert flash_ops._validate(*ops(192, 128), 0, 0) is False
    assert flash_ops._validate(*ops(128, 128), 0, 0) is False
    for d, dv in ((48, 32), (192, 192), (128, 192), (192, 64), (144, 144),
                  (256, 128)):
        with pytest.raises(ValueError, match="head dims"):
            flash_ops._validate(*ops(d, dv), 0, 0)
    q, k, v = ops(192, 128)
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_ops._validate(q, k, v[:, :3], 0, 0)


# ------------------------------------------------------- materialize -------

def _draw_before(s, generator, threshold):
    """``materialize``'s draw of one leaf as it was: whole, or one slice
    of its leading axis at a time above ``threshold``."""
    def draw(shape):
        out = torch.randn(shape, generator=generator, dtype=torch.float32)
        if s.init == "scaled":
            return out * (1.0 / math.sqrt(max(s.shape[0], 1)))
        return out * s.scale
    if math.prod(s.shape) <= threshold:
        return draw(s.shape).to(torch.bfloat16)
    out = torch.empty(s.shape, dtype=torch.bfloat16)
    for i in range(s.shape[0]):
        out[i] = draw(s.shape[1:])
    return out


def test_materialize_slices_along_the_next_axis(monkeypatch):
    """With the threshold at 512 values: a leaf under it and a leaf whose
    leading slices are under it (Qwen3's stacked experts) draw exactly
    the values they drew before; a leaf whose leading slices are above it
    (DeepSeek-V3's) is drawn in draws of at most 512 values, each slice
    of its second axis at a time, with the fan-in of the whole leaf."""
    monkeypatch.setattr(common, "SLICED_DRAW_ELEMENTS", 512)
    small = common.ParamSpec((4, 8, 16), "bfloat16", (), "scaled")
    qwen = common.ParamSpec((3, 4, 8, 16), "bfloat16", (), "normal")
    for s in (small, qwen):
        got = common.materialize({"w": s}, torch.Generator().manual_seed(3))
        want = _draw_before(s, torch.Generator().manual_seed(3), 512)
        assert torch.equal(got["w"], want)
    sizes = []
    randn = torch.randn

    def spy(shape, *a, **kw):
        sizes.append(math.prod(shape))
        return randn(shape, *a, **kw)
    deep = common.ParamSpec((2, 3, 16, 32), "bfloat16", (), "scaled")
    monkeypatch.setattr(torch, "randn", spy)
    got = common.materialize({"w": deep}, torch.Generator().manual_seed(4))
    monkeypatch.setattr(torch, "randn", randn)
    assert sizes == [16 * 32] * 6
    g = torch.Generator().manual_seed(4)
    want = torch.stack([torch.stack([
        randn((16, 32), generator=g) * (1.0 / math.sqrt(2))
        for _ in range(3)])
        for _ in range(2)]).to(torch.bfloat16)
    assert torch.equal(got["w"], want)


# ----------------------------------------------------------- the launcher

def test_serve_driver_cuts_depth_with_layers():
    """``serve(n_layers=)`` / ``--layers``: the split path and the global
    path at 1 layer (the dense one) and at 3 (1 dense + 2 MoE, whose
    first_k_dense stays 1), greedy tokens equal between the paths."""
    out = {}
    for layers in (1, 3):
        for clients in (2, 0):
            out[layers, clients] = serve.serve(
                ARCH, batch=2, prompt_len=6, gen_len=4, n_clients=clients,
                n_layers=layers, device="cpu")
        assert (out[layers, 2]["sample_output"]
                == out[layers, 0]["sample_output"])
    assert out[1, 2]["sample_output"] != out[3, 2]["sample_output"]
    import io
    import json
    from contextlib import redirect_stdout
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve.main(["--arch", ARCH, "--device", "cpu", "--layers", "1",
                    "--batch", "2", "--prompt-len", "6", "--gen-len", "4"])
    res = json.loads(buf.getvalue())
    assert res["sample_output"] == out[1, 2]["sample_output"]
