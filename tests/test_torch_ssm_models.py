"""The port's Mamba2 layer (``repro_torch.models.ssm``) and hybrid family
(``transformer``'s Mamba2 trunk with a shared attention block,
``model_api``'s tuple cache) against the JAX package's, on the CPU with
inputs from numpy seeds and params carried from ``repro``; and the tuple
trees of ``repro_torch.tree`` that the hybrid cache needs.

Tolerances: the SSD scan in f32, 2e-4 absolute and 1e-3 relative
(``tests/test_ssm_rwkv.py``'s, for chunked against per-token forms);
a whole Mamba2 layer to 2e-5 of its output's largest magnitude: the
reduced model's weights are large (see ``test_torch_serve_models.py``),
its outputs reach 1e5, and f32 sums in another order differ by a few
units there, also where terms cancel to a small value; logits 1e-4 plus
a relative 1e-4, and 3e-4 over the bf16 KV cache; the f32 SSM and conv
states, which grow to the thousands over a prompt, as the layer outputs
(2e-5 of their largest magnitude) after a whole model, and to 1e-3 plus
a relative 1e-4 after one layer; the bf16 KV cache to a relative 1e-2
(two bf16 steps) plus 1e-5: an entry near zero is the cancellation of
order-one terms, which f32 sums in other orders leave a few 1e-6 apart."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import common as j_common
from repro.models import ssm as j_ssm
from repro.models import transformer as j_transformer
from repro.models.model_api import build_cache_specs as j_build_cache_specs
from repro.models.model_api import build_model as j_build_model
from repro_torch.configs import get_config, reduced
from repro_torch.models import common, ssm, transformer
from repro_torch.models.model_api import build_cache_specs, build_model
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
from test_torch_support import (MODALITY_ARCHS, split_plane_refusal,
                                to_numpy, to_torch)

ZAMBA = "zamba2-2.7b"
F32 = dict(param_dtype="float32", dtype="float32")
SSD_TOL = dict(atol=2e-4, rtol=1e-3)
LAYER_REL = 2e-5
LOGITS = dict(atol=1e-4, rtol=1e-4)
LOGITS_OVER_CACHE = dict(atol=3e-4, rtol=1e-4)


def _close(ours, theirs, **tol):
    np.testing.assert_allclose(to_numpy(ours), to_numpy(theirs),
                               **(tol or dict(atol=2e-5, rtol=0.0)))


def _close_to_scale(ours, theirs, rel=LAYER_REL):
    """|ours - theirs| within ``rel`` of theirs' largest magnitude."""
    scale = float(np.abs(to_numpy(theirs)).max())
    _close(ours, theirs, atol=rel * scale, rtol=0.0)


def _rand(seed, *shape, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale)
    a = a.astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


def _ssd_inputs(seed, B, S, H, P, N):
    """repro's test draws (tests/test_ssm_rwkv.py), made with numpy."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, H, P)).astype(np.float32) * 0.5,
            (1 / (1 + np.exp(-rng.standard_normal((B, S, H)))) * 0.9
             + 0.05).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(
                np.float32) * 0.5,
            rng.standard_normal((B, S, N)).astype(np.float32) * 0.5,
            rng.standard_normal((B, S, N)).astype(np.float32) * 0.5]
    return ([torch.from_numpy(a) for a in arrs],
            [jnp.asarray(a) for a in arrs])


def _cfgs(**kw):
    return (j_reduced(j_get_config(ZAMBA), **{**F32, **kw}),
            reduced(get_config(ZAMBA), **{**F32, **kw}))


@pytest.fixture(scope="module")
def zamba():
    """reduced(zamba2, n_layers=4) in f32: 2 super-blocks of 2 Mamba2
    layers, so the shared attention block runs at two sites. (jcfg, cfg,
    global params as jax and as torch trees)."""
    jcfg, cfg = _cfgs(n_layers=4)
    jp = j_common.materialize(j_build_model(jcfg, max_seq=48).param_specs,
                              jax.random.key(0))
    return jcfg, cfg, jp, to_torch(jp)


def _ssm_layer(tree, s=0, j=0):
    return jax.tree.map(lambda a: a[s, j], tree["blocks"]["ssm"])


# ------------------------------------------------------------------ trees --

def test_tree_helpers_take_tuples_and_lists_in_position_order():
    tree = {"b": (torch.tensor(1), [torch.tensor(2), torch.tensor(3)]),
            "a": {"y": torch.tensor(0)}}
    leaves = tree_leaves(tree)
    # sorted keys, then tuple and list elements in position order — JAX's
    assert [int(t) for t in leaves] == [0, 1, 2, 3]
    jtree = jax.tree.map(lambda t: int(t), tree)
    assert [int(t) for t in leaves] == jax.tree.leaves(jtree)
    out = tree_map(lambda t, u: t + u, tree, tree)
    assert isinstance(out["b"], tuple) and isinstance(out["b"][1], list)
    assert [int(t) for t in tree_leaves(out)] == [0, 2, 4, 6]
    back = tree_unflatten(tree, [torch.tensor(9)] * 4)
    assert isinstance(back["b"], tuple) and int(back["b"][1][1]) == 9
    with pytest.raises(ValueError):
        tree_map(lambda t, u: t, (1, 2), (1,))
    with pytest.raises(ValueError):
        tree_unflatten((1, 2), [1, 2, 3])


def test_hybrid_cache_tree_zeros_and_order(zamba):
    """The hybrid cache is repro's tuple (ssm_states, attn_caches): zeroing
    it through tree_map keeps the tuple, and its leaves come in JAX's
    flattening order with repro's shapes and dtypes."""
    jcfg, cfg, _, _ = zamba
    caches = tree_map(lambda s: torch.zeros(s.shape,
                                            dtype=common.torch_dtype(s.dtype)),
                      build_cache_specs(cfg, 3, 20))
    theirs = jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.dtype(s.dtype)),
                          j_build_cache_specs(jcfg, 3, 20),
                          is_leaf=j_common.is_spec)
    assert isinstance(caches, tuple) and len(caches) == 2
    ours_l, theirs_l = tree_leaves(caches), jax.tree.leaves(theirs)
    assert [(tuple(t.shape), str(t.dtype)[6:]) for t in ours_l] == [
        (tuple(t.shape), str(t.dtype)) for t in theirs_l]
    assert tuple(caches[0]["ssm"].shape) == (2, 2, 3, 8, 32, 16)
    assert tuple(caches[0]["conv"].shape) == (2, 2, 3, 3, 256)
    assert tuple(caches[1]["k"].shape) == (2, 3, 20, 2, 32)


def test_chunk_divisor_equals_repro():
    from repro.models.common import chunk_divisor as j_chunk_divisor
    for seq in range(1, 700, 7):
        for cap in (1, 7, 16, 96, 128):
            assert (common.chunk_divisor(seq, cap)
                    == j_chunk_divisor(seq, cap)), (seq, cap)
    # the serve path's two prefill chunks at ssm_chunk 128
    assert common.chunk_divisor(576, 128) == 96
    assert common.chunk_divisor(448, 128) == 112


# ----------------------------------------------------------------- specs ----

@pytest.mark.parametrize("full", [False, True])
def test_param_and_cache_specs_equal(full):
    """Same key paths, shapes, dtypes, logical axes and init kinds as the
    JAX package's hybrid specs, reduced and at Zamba2-2.7B's full width."""
    jcfg, cfg = (j_get_config(ZAMBA), get_config(ZAMBA)) if full else _cfgs()

    def tuples(tree, is_spec):
        leaves = jax.tree_util.tree_flatten_with_path(tree,
                                                      is_leaf=is_spec)[0]
        return {jax.tree_util.keystr(p): (tuple(s.shape), s.dtype,
                                          s.logical, s.init, s.scale)
                for p, s in leaves}
    ours = build_model(cfg, max_seq=48).param_specs
    theirs = j_build_model(jcfg, max_seq=48).param_specs
    assert tuples(ours, common.is_spec) == tuples(theirs, j_common.is_spec)
    assert common.param_count(ours) == j_common.param_count(theirs)
    assert (tuples(build_cache_specs(cfg, 3, 48), common.is_spec)
            == tuples(j_build_cache_specs(jcfg, 3, 48), j_common.is_spec))
    assert (tuples(ssm.ssm_state_specs(cfg, 3, cfg.d_model), common.is_spec)
            == tuples(j_ssm.ssm_state_specs(jcfg, 3, jcfg.d_model),
                      j_common.is_spec))
    if full:   # ~2.4 B parameters, 54 Mamba2 layers in 9 super-blocks
        assert 2.3e9 < common.param_count(ours) < 2.5e9
        assert ours["blocks"]["ssm"]["w_in"].shape == (9, 6, 2560, 10240)


# ------------------------------------------------------------ the SSD scan --

@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("S", [16, 32, 64])
def test_ssd_chunked_matches_repro_and_recurrence(S, chunk):
    ours, theirs = _ssd_inputs(S + chunk, 2, S, 2, 8, 4)
    y, s = ssm._ssd_chunked(*ours, chunk)
    jy, js = j_ssm._ssd_chunked(*theirs, chunk)
    _close(y, jy, **SSD_TOL)
    _close(s, js, **SSD_TOL)
    _close(y, j_ssm.ssd_recurrent_ref(*theirs), **SSD_TOL)
    _close(ssm.ssd_recurrent_ref(*ours), j_ssm.ssd_recurrent_ref(*theirs),
           **SSD_TOL)


def test_ssd_state_carry():
    """tests/test_ssm_rwkv.py's split at 16: two halves with the state
    handed on equal one pass; and the port's halves equal repro's."""
    ours, theirs = _ssd_inputs(1, 1, 32, 2, 8, 4)
    y_full, s_full = ssm._ssd_chunked(*ours, 8)
    y1, s1 = ssm._ssd_chunked(*(t[:, :16] for t in ours), 8)
    y2, s2 = ssm._ssd_chunked(*(t[:, 16:] for t in ours), 8, state0=s1)
    _close(torch.cat([y1, y2], 1), y_full, **SSD_TOL)
    _close(s2, s_full, **SSD_TOL)
    jy1, js1 = j_ssm._ssd_chunked(*(t[:, :16] for t in theirs), 8)
    jy2, js2 = j_ssm._ssd_chunked(*(t[:, 16:] for t in theirs), 8,
                                  state0=js1)
    _close(y2, jy2, **SSD_TOL)
    _close(s2, js2, **SSD_TOL)
    with pytest.raises(ValueError, match="divide"):
        ssm._ssd_chunked(*(t[:, :12] for t in ours), 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv(dtype, with_tail):
    """The depthwise causal conv and its carried tail; an f32 tail stays
    f32 after a bf16 step (the dtype flip repro once had)."""
    x, jx = _rand(3, 2, 5, 16)
    w, jw = _rand(4, 4, 16)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x, jx, w, jw = x.to(tdt), jx.astype(jdt), w.to(tdt), jw.astype(jdt)
    tail = jtail = None
    if with_tail:
        tail, jtail = _rand(5, 2, 3, 16)
    out, new_tail = ssm._causal_conv(x, w, tail)
    jout, jnew_tail = j_ssm._causal_conv(jx, jw, jtail)
    assert out.dtype == x.dtype
    tol = dict(atol=2e-5, rtol=0.0) if dtype == "float32" else dict(
        atol=6e-2, rtol=2e-2)
    _close(out, jout, **tol)
    _close(new_tail, jnew_tail, **tol)
    assert str(new_tail.dtype)[6:] == str(jnew_tail.dtype)
    if with_tail:
        assert new_tail.dtype == torch.float32
    # one token at a time through the tail equals the whole sequence
    t = torch.zeros(2, 3, 16)
    steps = []
    for i in range(5):
        o, t = ssm._causal_conv(x[:, i:i + 1], w, t)
        steps.append(o)
        assert t.dtype == torch.float32
    _close(torch.cat(steps, 1), ssm._causal_conv(x, w)[0],
           **(dict(atol=1e-6, rtol=0.0) if dtype == "float32" else tol))


def test_ssm_apply_branches(zamba):
    """ssm_apply's three branches on layer (0, 0) of reduced zamba2: no
    state (chunk ssm_chunk), chunked prefill from a carried state (chunk
    chunk_divisor(S, ssm_chunk): 12 for S = 12), and the one-token step."""
    jcfg, cfg, jp, tp = zamba
    jpl, tpl = _ssm_layer(jp), _ssm_layer(tp)
    x, jx = _rand(7, 2, 16, cfg.d_model)
    out, st = ssm.ssm_apply(cfg, tpl, x)
    jout, jst = j_ssm.ssm_apply(jcfg, jpl, jx)
    assert st is None and jst is None
    _close_to_scale(out, jout)

    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    s0, js0 = _rand(8, 2, H, cfg.ssm_head_dim, cfg.ssm_state, scale=3.0)
    c0, jc0 = _rand(9, 2, 3, d_in)
    state = {"ssm": s0, "conv": c0}
    jstate = {"ssm": js0, "conv": jc0}
    for t0, t1 in ((0, 12), (12, 13), (13, 16)):
        out, state = ssm.ssm_apply(cfg, tpl, x[:, t0:t1], state=state)
        jout, jstate = j_ssm.ssm_apply(jcfg, jpl, jx[:, t0:t1], state=jstate)
        _close_to_scale(out, jout)
        assert state["ssm"].dtype == state["conv"].dtype == torch.float32
        _close(state["ssm"], jstate["ssm"], atol=1e-3, rtol=1e-4)
        _close(state["conv"], jstate["conv"])


# ------------------------------------------------------------ the family ---

def test_hybrid_forward_logits_and_caches(zamba):
    """The whole hybrid model: one no-cache forward, then a chunked prefill
    of two chunks and two decode steps against the tuple cache (SSM and
    conv states f32, KV bf16), each step's logits and the caches against
    repro's."""
    jcfg, cfg, jp, tp = zamba
    toks = np.random.default_rng(16).integers(0, cfg.vocab_size, (2, 16))
    toks = toks.astype(np.int32)
    logits, _, _ = transformer.forward(cfg, tp,
                                       {"tokens": torch.from_numpy(toks)})
    jlogits, _, _ = j_transformer.forward(jcfg, jp,
                                          {"tokens": jnp.asarray(toks)})
    assert logits.shape == (2, 16, cfg.padded_vocab)
    _close(logits, jlogits, **LOGITS)

    model, jmodel = build_model(cfg, max_seq=20), j_build_model(jcfg,
                                                                max_seq=20)
    caches = tree_map(lambda s: torch.zeros(s.shape,
                                            dtype=common.torch_dtype(s.dtype)),
                      build_cache_specs(cfg, 2, 20))
    jcaches = jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.dtype(s.dtype)),
                           j_build_cache_specs(jcfg, 2, 20),
                           is_leaf=j_common.is_spec)
    for t0, t1 in ((0, 12), (12, 14), (14, 15), (15, 16)):
        inp = {"tokens": torch.from_numpy(toks[:, t0:t1])}
        logits, new = model.decode_fn(tp, inp, caches, t0)
        assert new is caches                       # updated in place
        jlogits, jcaches = jmodel.decode_fn(
            jp, {"tokens": jnp.asarray(toks[:, t0:t1])}, jcaches, t0)
        _close(logits, jlogits, **LOGITS_OVER_CACHE)
    (ssm_st, kv), (jssm_st, jkv) = caches, jcaches
    _close_to_scale(ssm_st["ssm"], jssm_st["ssm"])
    _close_to_scale(ssm_st["conv"], jssm_st["conv"])
    for name in ("k", "v"):
        np.testing.assert_allclose(to_numpy(kv[name]), to_numpy(jkv[name]),
                                   rtol=1e-2, atol=1e-5)
    # the shared block wrote its own cache slice at both sites
    assert all(bool(kv["k"][s, :, :16].abs().sum() > 0) for s in range(2))
    _close(model.forward_fn(tp, {"tokens": torch.from_numpy(toks)}),
           jmodel.forward_fn(jp, {"tokens": jnp.asarray(toks)}), **LOGITS)


def test_check_family_admits_hybrid_only():
    """The hybrid family builds and crosses the split plane; the
    multimodal and encoder-decoder families build and the split plane
    refuses them with ``repro``'s ``ValueError`` (``check_family`` is
    gone)."""
    from repro_torch.core.adapters import from_model_config
    assert not hasattr(transformer, "check_family")
    cfg = reduced(get_config(ZAMBA))
    assert "shared_block" in build_model(cfg).param_specs
    from_model_config(cfg, n_clients=2, seq_len=16)
    for arch in MODALITY_ARCHS:
        split_plane_refusal(arch)
