"""The port's RWKV6 layer (``repro_torch.models.rwkv``) and ssm family
(``transformer``'s RWKV blocks, ``model_api``'s state cache) against the
JAX package's, on the CPU with inputs from numpy seeds and params carried
from ``repro``.

Tolerances are ``repro``'s (``tests/test_ssm_rwkv.py``): the wkv6 scan in
f32, 2e-4 absolute and 1e-3 relative, for the chunked form against the
per-token one and for the port against ``repro``; the same for a time-mix
or channel-mix layer and for the reduced model's logits. The f32 wkv
states after a whole model and several decode steps grow to tens, and f32
sums in another order leave an entry near zero a few 1e-4 apart: they are
held to ``repro``'s 1e-3 relative plus 2e-5 of their largest magnitude
(the hybrid family's state rule, ``tests/test_torch_ssm_models.py``),
never less than its 2e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import common as j_common
from repro.models import rwkv as j_rwkv
from repro.models.model_api import build_cache_specs as j_build_cache_specs
from repro.models.model_api import build_model as j_build_model
from repro_torch.configs import get_config, reduced
from repro_torch.models import rwkv, transformer
from repro_torch.models.model_api import build_cache_specs, build_model
from repro_torch.tree import tree_leaves, tree_map
from test_torch_support import to_numpy, to_torch

ARCH = "rwkv6-7b"
F32 = dict(param_dtype="float32", dtype="float32")
TOL = dict(atol=2e-4, rtol=1e-3)


def _close(ours, theirs, **tol):
    np.testing.assert_allclose(to_numpy(ours), to_numpy(theirs),
                               **(tol or TOL))


def _close_states(ours, theirs):
    scale = float(np.abs(to_numpy(theirs)).max())
    _close(ours, theirs, atol=max(TOL["atol"], 2e-5 * scale),
           rtol=TOL["rtol"])


def _wkv_inputs(seed, B, S, H, K):
    """``tests/test_ssm_rwkv.py``'s draws, made with numpy: r, k, v at
    0.5 N(0, 1), w = exp(clip(-exp(N(0, 1)), -4, -1e-3)), u at 0.3."""
    rng = np.random.default_rng(seed)
    r, k, v = [rng.standard_normal((B, S, H, K)).astype(np.float32) * 0.5
               for _ in range(3)]
    w = np.exp(np.clip(-np.exp(rng.standard_normal((B, S, H, K))), -4.0,
                       -1e-3)).astype(np.float32)
    u = (rng.standard_normal((H, K)) * 0.3).astype(np.float32)
    arrs = (r, k, v, w, u)
    return ([torch.from_numpy(a) for a in arrs],
            [jnp.asarray(a) for a in arrs])


def _cfgs(**kw):
    return (j_reduced(j_get_config(ARCH), **{**F32, **kw}),
            reduced(get_config(ARCH), **{**F32, **kw}))


def _random_layer_params(jspecs, seed):
    """A layer's params with every leaf drawn (the zeros/ones inits of
    decay_base, bonus_u, the mixes and ln_x would leave branches of the
    math untested): scaled leaves as repro materializes them, the rest
    N(0, 1) x 0.5 from numpy."""
    jp = j_common.materialize(jspecs, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    out = {}
    for name, a in jp.items():
        if jspecs[name].init in ("zeros", "ones"):
            a = jnp.asarray(np.asarray(a) + 0.5 * rng.standard_normal(
                a.shape).astype(np.float32))
        out[name] = a
    return out, to_torch(out)


@pytest.fixture(scope="module")
def model():
    """reduced(rwkv6-7b) in f32: 2 layers, d_model 128, 4 heads of 32,
    chunk 16. (jcfg, cfg, jmodel, tmodel, global params jax and torch)."""
    jcfg, cfg = _cfgs()
    jm, m = j_build_model(jcfg, max_seq=64), build_model(cfg, max_seq=64)
    jp = j_common.materialize(jm.param_specs, jax.random.key(0))
    return jcfg, cfg, jm, m, jp, to_torch(jp)


# ------------------------------------------------------------ the wkv6 scan

@pytest.mark.parametrize("seed,chunk,S", [(0, 4, 16), (1, 8, 32),
                                          (2, 16, 64), (3, 16, 16),
                                          (4, 8, 64)])
def test_wkv6_chunked_matches_reference_and_recurrence(seed, chunk, S):
    (r, k, v, w, u), jargs = _wkv_inputs(seed, 2, S, 2, 8)
    y, s = rwkv.wkv6_chunked(r, k, v, w, u, chunk)
    jy, js = j_rwkv.wkv6_chunked(*jargs, chunk)
    _close(y, jy)
    _close(s, js)
    _close(y, rwkv.wkv6_recurrent_ref(r, k, v, w, u))
    _close(rwkv.wkv6_recurrent_ref(r, k, v, w, u),
           j_rwkv.wkv6_recurrent_ref(*jargs))


def test_wkv6_state_carry_across_chunks():
    """Two half-sequences with the state carried == one full pass, and
    the carried form equals repro's."""
    (r, k, v, w, u), jargs = _wkv_inputs(0, 1, 32, 2, 8)
    y_full, s_full = rwkv.wkv6_chunked(r, k, v, w, u, 8)
    y1, s1 = rwkv.wkv6_chunked(r[:, :16], k[:, :16], v[:, :16], w[:, :16],
                               u, 8)
    y2, s2 = rwkv.wkv6_chunked(r[:, 16:], k[:, 16:], v[:, 16:], w[:, 16:],
                               u, 8, state0=s1)
    _close(torch.cat([y1, y2], 1), y_full)
    _close(s2, s_full)
    jr, jk, jv, jw, ju = jargs
    _, js1 = j_rwkv.wkv6_chunked(jr[:, :16], jk[:, :16], jv[:, :16],
                                 jw[:, :16], ju, 8)
    jy2, js2 = j_rwkv.wkv6_chunked(jr[:, 16:], jk[:, 16:], jv[:, 16:],
                                   jw[:, 16:], ju, 8, state0=js1)
    _close(y2, jy2)
    _close(s2, js2)


def test_wkv6_chunked_long_sequence_stable():
    """No overflow/NaN at 1k tokens with extreme (clamped) decays."""
    (r, k, v, w, u), _ = _wkv_inputs(2, 1, 1024, 2, 8)
    y, s = rwkv.wkv6_chunked(r, k, v, w, u, 32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())


def test_wkv6_rejects_a_chunk_that_does_not_tile():
    (r, k, v, w, u), _ = _wkv_inputs(0, 1, 12, 2, 8)
    with pytest.raises(ValueError, match="tile"):
        rwkv.wkv6_chunked(r, k, v, w, u, 5)


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("branch", ["no_state", "chunked_prefill",
                                    "decode"])
def test_time_mix_branches_match_reference(branch):
    """All three branches of rwkv_time_mix: no state (training), a
    chunked prefill from a carried state (S = 12 at chunk 16: the chunk
    divisor 12), and the one-token decode step."""
    jcfg, cfg = _cfgs()
    d, H, K = cfg.d_model, cfg.n_rwkv_heads, cfg.rwkv_head_dim
    jp, tp = _random_layer_params(j_rwkv.rwkv_specs(jcfg, d), 3)
    S = {"no_state": 32, "chunked_prefill": 12, "decode": 1}[branch]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    if branch == "no_state":
        tstate = jstate = None
    else:
        st = {"wkv": rng.standard_normal((2, H, K, K)).astype(np.float32),
              "shift": rng.standard_normal((2, d)).astype(np.float32)}
        jstate = {n: jnp.asarray(a) for n, a in st.items()}
        tstate = {n: torch.from_numpy(a) for n, a in st.items()}
    out, new = rwkv.rwkv_time_mix(cfg, tp, torch.from_numpy(x), state=tstate)
    jout, jnew = j_rwkv.rwkv_time_mix(jcfg, jp, jnp.asarray(x), state=jstate)
    _close(out, jout)
    if branch == "no_state":
        assert new is None and jnew is None
    else:
        for n in ("wkv", "shift"):
            _close(new[n], jnew[n])


def test_channel_mix_matches_reference():
    jcfg, cfg = _cfgs()
    jp, tp = _random_layer_params(
        j_rwkv.rwkv_channel_mix_specs(jcfg, cfg.d_model), 4)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    prev = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    for tprev, jprev in ((None, None),
                         (torch.from_numpy(prev), jnp.asarray(prev))):
        _close(rwkv.rwkv_channel_mix(cfg, tp, torch.from_numpy(x),
                                     prev=tprev),
               j_rwkv.rwkv_channel_mix(jcfg, jp, jnp.asarray(x),
                                       prev=jprev))


def test_specs_match_reference():
    jcfg, cfg = _cfgs()
    for fn, jfn in ((rwkv.rwkv_specs, j_rwkv.rwkv_specs),
                    (rwkv.rwkv_channel_mix_specs,
                     j_rwkv.rwkv_channel_mix_specs)):
        a, b = fn(cfg, cfg.d_model), jfn(jcfg, cfg.d_model)
        assert {n: (s.shape, s.dtype, s.init) for n, s in a.items()} == \
            {n: (s.shape, s.dtype, s.init) for n, s in b.items()}
    st, jst = build_cache_specs(cfg, 3, 40), j_build_cache_specs(jcfg, 3, 40)
    assert {n: (s.shape, s.dtype, s.logical) for n, s in st.items()} == \
        {n: (s.shape, s.dtype, s.logical) for n, s in jst.items()}
    assert rwkv.W_LORA == j_rwkv.W_LORA


# ------------------------------------------------------------------- model

def test_model_forward_and_loss_match_reference(model):
    jcfg, cfg, jm, m, jp, tp = model
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32))
    toks = toks.astype(np.int32)
    _close(m.forward_fn(tp, {"tokens": torch.from_numpy(toks)}),
           jm.forward_fn(jp, {"tokens": jnp.asarray(toks)}))
    loss, aux = m.loss_fn(tp, {"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(toks)})
    jloss, jaux = jm.loss_fn(jp, {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(toks)})
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert float(aux["aux"]) == float(jaux["aux"]) == 0.0


def test_chunked_prefill_then_decode_matches_reference(model):
    """A prompt prefilled in two chunks (20 and 12 tokens: chunks 10 and
    12 of the carried-state form) and 6 decode steps, through the port's
    ``decode_fn`` and ``repro``'s: logits, the state after each step and
    the greedy tokens; then the same prompt without caches."""
    jcfg, cfg, jm, m, jp, tp = model
    B, P, G = 2, 32, 6
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, P))
    toks = toks.astype(np.int32)
    specs, jspecs = build_cache_specs(cfg, B, P + G), \
        j_build_cache_specs(jcfg, B, P + G)
    caches = tree_map(lambda s: torch.zeros(s.shape), specs)
    jcaches = jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.float32), jspecs,
                           is_leaf=j_common.is_spec)
    for t0, t1 in ((0, 20), (20, 32)):
        logits, caches = m.decode_fn(
            tp, {"tokens": torch.from_numpy(toks[:, t0:t1])}, caches, t0)
        jlogits, jcaches = jm.decode_fn(
            jp, {"tokens": jnp.asarray(toks[:, t0:t1])}, jcaches, t0)
        _close(logits, jlogits)
    for n in ("wkv", "shift", "shift_c"):
        _close_states(caches[n], jcaches[n])
    _close(logits[:, -1], jm.forward_fn(jp, {"tokens": jnp.asarray(toks)})
           [:, -1])
    for t in range(P, P + G):
        nxt = logits[:, -1].argmax(-1).to(torch.int32)
        jnxt = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        logits, caches = m.decode_fn(tp, {"tokens": nxt[:, None]}, caches, t)
        jlogits, jcaches = jm.decode_fn(jp, {"tokens": jnxt[:, None]},
                                        jcaches, t)
        _close(logits, jlogits)
    for leaf, jleaf in zip(tree_leaves(caches), jax.tree.leaves(jcaches)):
        _close_states(leaf, jleaf)


def test_inactive_slots_keep_their_state_exactly(model):
    """The batched paged step's freeze: a block applied with ``active``
    writes the new state for active rows and leaves the others bitwise."""
    _, cfg, _, _, _, tp = model
    specs = build_cache_specs(cfg, 3, 8)
    gen = torch.Generator().manual_seed(0)
    state = tree_map(lambda s: torch.randn(s.shape, generator=gen), specs)
    before = tree_map(lambda t: t.clone(), state)
    p0 = {k: tree_map(lambda a: a[0], v) for k, v in tp["blocks"].items()}
    x = torch.randn(3, 1, cfg.d_model, generator=gen)
    st0 = {n: leaf[0] for n, leaf in state.items()}
    transformer._rwkv_block_apply(cfg, p0, x, state=st0,
                                  active=torch.tensor([1, 0, 1]))
    for n in state:
        assert torch.equal(state[n][0, 1], before[n][0, 1])
        assert not torch.equal(state[n][0, 0], before[n][0, 0])
        assert torch.equal(state[n][1], before[n][1])    # layer 1 untouched


def test_remat_forward_and_grads_equal_plain(model):
    """cfg.remat recomputes each RWKV block in the backward: the same loss
    and gradients as without it."""
    _, cfg, _, _, _, tp = model
    import dataclasses
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int64))
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        params = tree_map(lambda t: t.clone().requires_grad_(True), tp)
        loss, _ = transformer.lm_loss(c, params, {"tokens": toks,
                                                  "labels": toks})
        loss.backward()
        out.append((loss.detach(), tree_map(lambda t: t.grad, params)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
