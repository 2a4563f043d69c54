"""The port's paged serve storage and batched paged decode step against
the JAX package's.

* ``federation/paging.py``: ``default_page_size``, ``pages_needed``,
  ``install_rows``, ``leaf_plans`` and ``paged_specs`` equal ``repro``'s on
  the same cache specs (reduced phi3 and reduced zamba2 with 4 layers);
  ``PageAllocator``'s allocation order, peak, errors and snapshot round
  trip equal ``repro``'s.
* ``models/common.py``: ``PageContext``'s row maps equal ``repro``'s;
  ``freeze_state`` keeps inactive rows bitwise and the carried dtype.
* One paged step: ``decode_attend`` with a per-row ``cur_pos`` and
  ``paged_update_gather`` against ``repro``'s on the same arrays (1e-5);
  one ``server_decode_paged`` step against ``repro``'s on the same
  weights, pool, tables, positions and active mask (some slots inactive),
  in f32: logits within 1e-4, the pool equal outside the written rows
  (the written k/v rows are bf16 roundings of f32 products summed in
  other orders, held to a relative 1e-2, two bf16 steps, as
  ``tests/test_torch_serve_models.py`` holds the KV cache; the trash page,
  which several inactive slots write, is never read and not compared),
  and the inactive slots' SSM state unchanged, bitwise (the active ones
  within 1e-5 of the leaf's largest entry).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.federation import Federation as JFederation
from repro.federation import paging as j_paging
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro_torch.configs import get_config, reduced
from repro_torch.federation import Federation, paging
from repro_torch.models import attention, common
from repro_torch.models.layers import apply_rope
from repro_torch.tree import tree_leaves
from test_torch_support import to_numpy, to_torch

F32 = dict(param_dtype="float32", dtype="float32")
ARCHS = {"phi3-mini-3.8b": dict(d_model=64, n_heads=2, n_kv_heads=1,
                                d_ff=128, vocab_size=256),
         "zamba2-2.7b": dict(n_layers=4),
         # MLA's latent pool in both stacks (q/k head dim 48, v 32)
         "deepseek-v3-671b": dict(qk_nope_dim=32, qk_rope_dim=16,
                                  v_head_dim=32)}
SEQ = 16


def _sessions(arch):
    jcfg = j_reduced(j_get_config(arch), **F32, **ARCHS[arch])
    cfg = reduced(get_config(arch), **F32, **ARCHS[arch])
    jfed = JFederation.build(jcfg, n_clients=2, seq_len=SEQ)
    fed = Federation.build(cfg, n_clients=2, seq_len=SEQ, device="cpu")
    return jfed, fed


def _spec_tuples(tree):
    return [(tuple(s.shape), s.dtype, tuple(s.logical), s.init)
            for s in tree]


# ------------------------------------------------------------- paging.py --

def test_page_arithmetic_matches_repro():
    for seq in (1, 7, 8, 12, 16, 24, 1152, 1153):
        for cap in (1, 4, 8, 16):
            assert (paging.default_page_size(seq, cap)
                    == j_paging.default_page_size(seq, cap))
    for n in (1, 7, 8, 9, 1152):
        for pg in (1, 4, 8):
            assert paging.pages_needed(n, pg) == j_paging.pages_needed(n, pg)
    ids = np.array([5, 2, 9, 3], np.int32)
    for n in (1, 7, 8, 13, 16):
        got = paging.install_rows(ids, n, 4)
        np.testing.assert_array_equal(got, j_paging.install_rows(ids, n, 4))
        assert got.dtype == np.int32


@pytest.mark.parametrize("arch", list(ARCHS))
def test_leaf_plans_and_paged_specs_match_repro(arch):
    jfed, fed = _sessions(arch)
    dense = fed.adapter.cache_specs(1, SEQ)
    jdense = jfed.adapter.cache_specs(1, SEQ)
    is_spec = j_common.is_spec
    jplans = jax.tree.leaves(j_paging.leaf_plans(jdense))
    plans = tree_leaves(paging.leaf_plans(dense))
    assert [(p.pooled, p.batch_axis, p.seq_axis) for p in plans] == \
        [(p.pooled, p.batch_axis, p.seq_axis) for p in jplans]
    assert any(p.pooled for p in plans)
    if arch == "zamba2-2.7b":
        assert not all(p.pooled for p in plans)     # slot-stacked states
    got = paging.paged_specs(dense, n_slots=3, n_pages=9, page_size=4)
    want = j_paging.paged_specs(jdense, n_slots=3, n_pages=9, page_size=4)
    assert _spec_tuples(tree_leaves(got)) == _spec_tuples(
        jax.tree.leaves(want, is_leaf=is_spec))
    bad = common.ParamSpec((2, 4), "float32", (None, None))
    with pytest.raises(ValueError, match="cache_batch"):
        paging.leaf_plans({"x": bad})


def test_page_allocator_matches_repro():
    ours, theirs = paging.PageAllocator(12), j_paging.PageAllocator(12)
    for n in (3, 2):
        np.testing.assert_array_equal(ours.alloc(n), theirs.alloc(n))
    for a in (ours, theirs):
        a.free_([3, 2])
    np.testing.assert_array_equal(ours.alloc(4), theirs.alloc(4))
    for attr in ("capacity", "available", "in_use", "peak_in_use"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert ours.snapshot() == theirs.snapshot()
    restored = paging.PageAllocator.restore(theirs.snapshot())
    assert restored.snapshot() == ours.snapshot()
    np.testing.assert_array_equal(restored.alloc(1), theirs.alloc(1))
    with pytest.raises(RuntimeError, match="exhausted"):
        ours.alloc(ours.available + 1)
    with pytest.raises(ValueError, match="invalid page"):
        ours.free_([paging.TRASH_PAGE])
    with pytest.raises(ValueError, match="reserved"):
        paging.PageAllocator(paging.N_RESERVED)
    assert (paging.ZERO_PAGE, paging.TRASH_PAGE, paging.N_RESERVED) == \
        (j_paging.ZERO_PAGE, j_paging.TRASH_PAGE, j_paging.N_RESERVED)


# --------------------------------------------------------------- common ---

def _tables(rng, B, npt, n_pages):
    ids = rng.permutation(np.arange(paging.N_RESERVED, n_pages))
    return ids[:B * npt].reshape(B, npt).astype(np.int32)


def test_page_context_rows_match_repro():
    rng = np.random.default_rng(0)
    tables = _tables(rng, 4, 3, 16)
    cur = np.array([0, 5, 11, 7], np.int32)
    active = np.array([1, 0, 1, 1], np.int32)
    ctx = common.PageContext.for_step(
        torch.from_numpy(tables), torch.from_numpy(active),
        torch.from_numpy(cur), page_size=4)
    jctx = j_common.PageContext(tables=jnp.asarray(tables),
                                active=jnp.asarray(active), page_size=4)
    np.testing.assert_array_equal(to_numpy(ctx.gather_rows),
                                  np.asarray(jctx.gather_rows()))
    for got, want in zip((ctx.dest_page, ctx.in_page),
                         jctx.write_rows(jnp.asarray(cur))):
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    # a retired slot one past its table clamps, and writes the trash page
    retired = common.PageContext.for_step(
        torch.from_numpy(tables), torch.from_numpy(active),
        torch.tensor([12, 12, 3, 3]), page_size=4)
    assert to_numpy(retired.dest_page).tolist()[1] == paging.TRASH_PAGE


def test_freeze_state_keeps_inactive_rows_and_dtype():
    g = torch.Generator().manual_seed(0)
    old = torch.randn(3, 2, 5, generator=g)
    new = torch.randn(3, 2, 5, generator=g).to(torch.bfloat16)
    active = torch.tensor([1, 0, 1])
    out = common.freeze_state(active, new, old)
    assert out.dtype == torch.float32          # an f32 tail stays f32
    assert torch.equal(out[1], old[1])
    assert torch.equal(out[0], new[0].float())
    want = j_common.freeze_state(jnp.asarray(active.numpy()),
                                 jnp.asarray(new.float().numpy(),
                                             jnp.bfloat16),
                                 jnp.asarray(old.numpy()))
    np.testing.assert_array_equal(to_numpy(out), np.asarray(want))


def test_rope_broadcasts_per_row_positions():
    """(B, 1) positions give each row the rotation its own position gives
    at B = 1."""
    x = torch.randn(3, 1, 2, 8, generator=torch.Generator().manual_seed(1))
    pos = torch.tensor([4, 0, 9])
    got = apply_rope(x, pos[:, None], 10000.0)
    for b in range(3):
        torch.testing.assert_close(
            got[b:b + 1], apply_rope(x[b:b + 1], pos[b:b + 1], 10000.0),
            rtol=0, atol=0)


# -------------------------------------------------------- one paged step --

def test_decode_attend_per_row_and_paged_gather_match_repro():
    rng = np.random.default_rng(2)
    B, S, Hq, Hkv, hd, pg = 4, 16, 4, 2, 8, 4
    q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    cur = np.array([3, 15, 0, 9], np.int32)
    for window in (0, 5):
        got = attention.decode_attend(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(cur), window=window)
        want = j_attn.decode_attend(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(cur),
                                    window=window)
        np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                   atol=1e-5, rtol=0)
    # the scalar (solo) form is unchanged: one shared position
    got = attention.decode_attend(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), 7)
    want = j_attn.decode_attend(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), 7)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-5)

    n_pages = 20
    pool = rng.standard_normal((n_pages, pg, Hkv, hd)).astype(np.float32)
    row = rng.standard_normal((B, Hkv, hd)).astype(np.float32)
    tables = _tables(rng, B, S // pg, n_pages)
    active = np.array([1, 1, 0, 1], np.int32)
    ctx = common.PageContext.for_step(
        torch.from_numpy(tables), torch.from_numpy(active),
        torch.from_numpy(cur), page_size=pg)
    dest, in_page = ctx.dest_page, ctx.in_page
    tpool = torch.from_numpy(pool.copy())
    same, gathered = attention.paged_update_gather(
        tpool, torch.from_numpy(row), dest, in_page, ctx.gather_rows)
    jpool, jgathered = j_attn.paged_update_gather(
        jnp.asarray(pool), jnp.asarray(row), jnp.asarray(to_numpy(dest)),
        jnp.asarray(to_numpy(in_page)), jnp.asarray(
            to_numpy(ctx.gather_rows)))
    assert same is tpool                          # written in place
    np.testing.assert_allclose(to_numpy(tpool), np.asarray(jpool),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(to_numpy(gathered), np.asarray(jgathered),
                               atol=1e-5, rtol=0)


def _pool_case(arch, seed=3):
    """Both adapters' paged step inputs on the same weights and arrays."""
    jfed, fed = _sessions(arch)
    key = jax.random.key(0)
    gp = j_common.materialize(jfed.model.param_specs, key)
    jparams = jfed.params_from_global(gp)
    params = fed.params_from_global(to_torch(gp))
    B, pg, n_pages = 4, 4, 20
    rng = np.random.default_rng(seed)
    specs = j_paging.paged_specs(jfed.adapter.cache_specs(1, SEQ),
                                 n_slots=B, n_pages=n_pages, page_size=pg)
    jcaches = jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape), s.dtype),
        specs, is_leaf=j_common.is_spec)
    # the ZERO page reads as zeros, as a live pool's does
    jplans = j_paging.leaf_plans(jfed.adapter.cache_specs(1, SEQ))
    jcaches = jax.tree.map(
        lambda a, plan: a.at[:, j_paging.ZERO_PAGE].set(0) if plan.pooled
        else a, jcaches, jplans)
    tables = _tables(rng, B, SEQ // pg, n_pages)
    cur = np.array([5, 12, 3, 9], np.int32)
    active = np.array([1, 0, 1, 0], np.int32)
    d = jfed.model_cfg.d_model
    x = (rng.standard_normal((B, 1, d))
         * active[:, None, None]).astype(np.float32)
    return dict(jfed=jfed, fed=fed, jparams=jparams, params=params,
                jcaches=jcaches, tables=tables, cur=cur, active=active, x=x,
                pg=pg, n_pages=n_pages)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_server_decode_paged_matches_repro(arch):
    c = _pool_case(arch)
    caches = to_torch(c["jcaches"])
    before = jax.tree.map(np.asarray, c["jcaches"])
    logits, out = c["fed"].adapter.server_decode_paged(
        c["params"]["server"], torch.from_numpy(c["x"]), caches,
        torch.from_numpy(c["tables"]), torch.from_numpy(c["cur"]).long(),
        torch.from_numpy(c["active"]).long(), c["pg"])
    jlogits, jout = c["jfed"].adapter.server_decode_paged(
        c["jparams"]["server"], jnp.asarray(c["x"]), c["jcaches"],
        jnp.asarray(c["tables"]), jnp.asarray(c["cur"]),
        jnp.asarray(c["active"]), c["pg"])
    assert out is caches                          # updated in place
    np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)

    plans = tree_leaves(paging.leaf_plans(c["fed"].adapter.cache_specs(
        1, SEQ)))
    written = np.zeros((c["n_pages"], c["pg"]), bool)
    for b in np.flatnonzero(c["active"]):
        written[c["tables"][b, c["cur"][b] // c["pg"]],
                c["cur"][b] % c["pg"]] = True
    written[paging.TRASH_PAGE] = True
    for got, want, old, plan in zip(tree_leaves(out),
                                    jax.tree.leaves(jout),
                                    jax.tree.leaves(before), plans):
        got, want = to_numpy(got), np.asarray(want, np.float32)
        if plan.pooled:
            keep = ~written
            np.testing.assert_array_equal(got[:, keep], want[:, keep])
            np.testing.assert_array_equal(got[:, keep],
                                          np.asarray(old, np.float32)[:,
                                                                      keep])
            w = written.copy()
            w[paging.TRASH_PAGE] = False
            np.testing.assert_allclose(got[:, w], want[:, w], rtol=1e-2,
                                       atol=1e-2)
        else:
            # slot-stacked recurrent state: inactive slots bitwise frozen,
            # active ones within 1e-5 of the leaf's largest entry, as
            # tests/test_torch_ssm_models.py holds the Mamba2 layer's
            # outputs (the reduced model's SSM state reaches 5e3)
            b = plan.batch_axis
            idle = (slice(None),) * b + (c["active"] == 0,)
            np.testing.assert_array_equal(got[idle], np.asarray(old)[idle])
            np.testing.assert_allclose(
                got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
