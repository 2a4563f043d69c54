"""The port's continuous serve plane (``Federation.serve``, the
``ServeScheduler``, ``launch.serve --continuous``) against its own solo
decode and against the JAX package's scheduler, with the failure policy
``tests/test_serving_engine.py`` requires of ``repro``.

Both packages run on the CPU in f32 on the same weights (carried from
``repro``): ``repro``'s ``tiny_dense`` (reduced phi3 at d_model 64) and
reduced zamba2 with 4 layers (the hybrid family: paged KV at the shared
attention block's two sites, slot-stacked SSM states frozen on inactive
slots), reduced rwkv6 (``repro``'s "ssm" cases: attention-free, its wkv
and token-shift states slot-stacked and frozen) and reduced qwen3-moe
(paged KV, the MoE dense form in every batched step).

* Continuous == solo on the port: tokens equal the port's solo
  ``fed.decode`` per request (at temperature 0.8 both draw from the
  request's ``PositionGumbel(seed)``), logits within 1e-4, ledgers message
  for message.
* Continuous == ``repro``'s scheduler: greedy, and at 0.8 with ``repro``'s
  ``fold_in(key_r, 100 + t)`` noise injected per request: tokens, ledgers
  (message for message), statuses, admission and retirement steps equal.
* Host syncs: one fetch a retirement wave; nothing inside a block reads a
  device value on the host.
* The failure policy: preemption resumes with the unpreempted tokens,
  ``QueueFull``, deadlines and cancels meter exactly, poison is isolated
  and scrubbed, a small pool with preemption drains clean, a reused
  scheduler returns only its new results, the constructor validates.
* Durability: snapshot, ``fed.save(serve_state=)``, ``Federation.restore``
  and ``fed.serve(params, state=)`` continue with equal tokens and
  byte-identical ledgers; a snapshot written by ``repro`` is refused.
* The driver: ``serve(continuous=True, device="cpu")`` returns ``repro``'s
  keys and its wire bytes.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.privacy import serve_messages
from repro.federation import Federation as JFederation
from repro.launch import serve as j_serve
from repro.models import common as j_common
from repro_torch.configs import get_config, reduced
from repro_torch.federation import Federation, QueueFull, scheduler
from repro_torch.federation.serving import PositionGumbel
from repro_torch.launch import serve
from repro_torch.tree import tree_leaves
from test_torch_support import ledger_tuples, to_numpy, to_torch, torch_threads

F32 = dict(param_dtype="float32", dtype="float32")
FAMILIES = {
    # repro's tiny_dense (tests/test_serving_engine.py), in f32
    "dense": ("phi3-mini-3.8b", dict(d_model=64, n_heads=2, n_kv_heads=1,
                                     d_ff=128, vocab_size=256)),
    "hybrid": ("zamba2-2.7b", dict(n_layers=4)),
    # repro's "ssm" cases: reduced rwkv6, its states slot-stacked
    "ssm": ("rwkv6-7b", {}),
    "moe": ("qwen3-moe-30b-a3b", {}),
    # DeepSeek-V3's MLA (q/k head dim 48, v 32): the latent page pool of
    # the {"dense", "main"} stacks
    "mla": ("deepseek-v3-671b", dict(qk_nope_dim=32, qk_rope_dim=16,
                                     v_head_dim=32)),
}
LOGITS_ATOL = 1e-4
_SESSIONS = {}


@pytest.fixture(autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


def _build(family="dense", seq=12):
    """(jfed, jparams, fed, params, cfg) on the same weights, cached."""
    if (family, seq) not in _SESSIONS:
        arch, kw = FAMILIES[family]
        jcfg = j_reduced(j_get_config(arch), **F32, **kw)
        cfg = reduced(get_config(arch), **F32, **kw)
        jfed = JFederation.build(jcfg, n_clients=2, seq_len=seq)
        fed = Federation.build(cfg, n_clients=2, seq_len=seq, device="cpu")
        gp = j_common.materialize(jfed.model.param_specs, jax.random.key(0))
        _SESSIONS[family, seq] = (jfed, jfed.params_from_global(gp), fed,
                                  fed.params_from_global(to_torch(gp)), cfg)
    return _SESSIONS[family, seq]


def _prompts(cfg, specs, salt):
    rng = np.random.default_rng(salt)
    return [rng.integers(0, cfg.vocab_size, pl).astype(np.int32)
            for pl, _ in specs]


class JaxNoise:
    """``repro``'s per-request sampling noise, handed to the port: the
    Gumbel rows ``jax.random.categorical`` adds at position t on
    ``fold_in(key, 100 + t)`` — as a scheduler table (``rows``) and as a
    solo decode's source (``gumbel``)."""

    def __init__(self, key):
        self.key = key

    def _row(self, t, vocab):
        return np.asarray(jax.random.gumbel(
            jax.random.fold_in(self.key, 100 + t), (1, vocab),
            jnp.float32))[0]

    def rows(self, t0, n, vocab, device):
        return torch.from_numpy(np.stack(
            [self._row(t, vocab) for t in range(t0, t0 + n)])).to(device)

    def gumbel(self, t, shape, device):
        return torch.from_numpy(self._row(t, shape[1])[None]).to(device)


def _solo(fed, params, prompt, gen_len, temperature, draws):
    return fed.decode(params, prompt[None], gen_len=gen_len,
                      temperature=temperature,
                      draws=draws if temperature > 0 else None)


def _assert_solo(fed, params, prompt, gen_len, temperature, draws, res):
    solo = _solo(fed, params, prompt, gen_len, temperature, draws)
    np.testing.assert_array_equal(res.tokens, solo.tokens[0])
    assert ledger_tuples(res.ledger) == ledger_tuples(solo.ledger)
    return solo


# ------------------------------------------------ continuous == solo ------

@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_continuous_matches_solo_with_churn(family, temperature):
    """More requests than slots, mixed lengths, the first two of one
    prompt length (a width-2 wave): every request's tokens equal a solo
    decode with the same draw source, its final logits within 1e-4, and
    its ledger is the solo ledger message for message."""
    _, _, fed, params, cfg = _build(family, 12)
    srv = fed.serve(params, max_batch=2, temperature=temperature)
    specs = [(4, 8), (4, 5), (6, 6), (3, 4), (2, 3)]
    prompts = _prompts(cfg, specs, 10)
    for i, (p, (_, gl)) in enumerate(zip(prompts, specs)):
        srv.submit(p, gl, seed=100 + i)
    results = srv.run()
    assert [r.rid for r in results] == list(range(len(specs)))
    for i, (p, (_, gl)) in enumerate(zip(prompts, specs)):
        res = results[i]
        assert res.status == "ok" and not res.transmits_gradients
        solo = _assert_solo(fed, params, p, gl, temperature,
                            PositionGumbel(100 + i), res)
        np.testing.assert_allclose(res.logits, to_numpy(solo.logits)[0],
                                   atol=LOGITS_ATOL, rtol=0)
    assert results[1].admitted_at == 0            # a width-2 wave
    assert results[2].admitted_at > 0             # admitted mid-flight
    assert max(r.finished_at for r in results) == srv.steps
    assert srv.generated_tokens == sum(gl for _, gl in specs)


def test_wave_admission_under_sampling_on_injected_noise():
    """Equal-length prompts admit as one batched wave; at temperature 0.8
    with each request's own injected noise the batched rows sample what a
    solo decode samples."""
    jfed, _, fed, params, cfg = _build("dense", 10)
    srv = fed.serve(params, max_batch=2, temperature=0.8)
    specs = [(4, 6)] * 4
    prompts = _prompts(cfg, specs, 40)
    noise = [JaxNoise(jax.random.fold_in(jax.random.key(0), 400 + i))
             for i in range(4)]
    for p, n in zip(prompts, noise):
        srv.submit(p, 6, draws=n)
    results = srv.run()
    assert results[1].admitted_at == 0            # a width-2 wave happened
    for p, n, res in zip(prompts, noise, results):
        _assert_solo(fed, params, p, 6, 0.8, n, res)


def test_retirement_fetch_is_per_wave_not_per_step():
    """A churn-heavy drain makes one device-to-host fetch per retirement
    wave: O(requests), not O(steps)."""
    _, _, fed, params, _ = _build("dense", 10)
    srv = fed.serve(params, max_batch=2)
    n_req, gl = 4, 8
    for i in range(n_req):
        srv.submit(np.full(2, i, np.int32), gl)
    results = srv.run()
    assert len(results) == n_req and srv.generated_tokens == n_req * gl
    assert srv.host_transfers == n_req // 2       # both slots retire at once
    assert srv.host_transfers <= n_req < srv.generated_tokens


def test_no_host_sync_inside_a_decode_block(monkeypatch):
    """Inside a K-step block nothing reads a device value on the host: the
    block runs with every tensor-to-host conversion raising."""
    _, _, fed, params, cfg = _build("hybrid", 12)
    srv = fed.serve(params, max_batch=2, temperature=0.8)
    for i, p in enumerate(_prompts(cfg, [(4, 8), (3, 5), (5, 4)], 5)):
        srv.submit(p, [8, 5, 4][i], seed=i)
    make = scheduler.make_paged_decode_block
    blocks = []

    def strict(*args):
        block = make(*args)

        def run(*a):
            def refuse(*_a, **_k):
                raise AssertionError("host sync inside a decode block")
            with monkeypatch.context() as m:
                for name in ("item", "tolist", "cpu", "numpy", "__bool__",
                             "__int__", "__float__"):
                    m.setattr(torch.Tensor, name, refuse)
                block(*a)
            blocks.append(args[-1])
        return run
    monkeypatch.setattr(scheduler, "make_paged_decode_block", strict)
    results = srv.run()
    assert [r.status for r in results] == ["ok"] * 3
    assert sum(blocks) == srv.steps and len(blocks) >= 3


def test_paged_memory_tracks_lengths_in_flight():
    """Peak slot-cache memory follows the pages requests touch, not
    max_batch x seq_len."""
    _, _, fed, params, _ = _build("dense", 16)
    srv = fed.serve(params, max_batch=4)
    assert srv.page_size == 8 and srv.pages_per_seq == 2
    for i in range(4):
        srv.submit(np.full(3, i, np.int32), 4)   # 7 tokens -> 1 page each
    srv.run()
    assert srv.allocator.peak_in_use == 4 < srv.max_batch * srv.pages_per_seq
    assert srv.allocator.in_use == 0


def test_small_pool_gates_admission_on_pages():
    """An undersized pool gates admission on free pages (FIFO) instead of
    free slots: requests still drain in order, tokens equal solo."""
    _, _, fed, params, cfg = _build("dense", 12)
    srv = fed.serve(params, max_batch=2, n_pages=4)   # room for ONE request
    specs = [(4, 7)] * 3
    prompts = _prompts(cfg, specs, 41)
    for p in prompts:
        srv.submit(p, 7)                             # 11 tokens -> 2 pages
    results = srv.run()
    for p, res in zip(prompts, results):
        _assert_solo(fed, params, p, 7, 0.0, None, res)
    assert results[1].admitted_at > 0
    assert srv.allocator.peak_in_use == 2
    with pytest.raises(ValueError, match="pages"):
        fed.serve(params, max_batch=1, n_pages=3).submit(
            np.zeros(5, np.int32), 7)


# ---------------------------------------------- continuous == repro -------

def _both_drain(family, seq, specs, temperature, *, max_batch=2, salt=20,
                **kw):
    """The same requests through repro's scheduler and the port's, the
    port handed repro's per-request noise."""
    jfed, jparams, fed, params, cfg = _build(family, seq)
    prompts = _prompts(cfg, specs, salt)
    keys = [jax.random.fold_in(jax.random.key(0), 200 + i)
            for i in range(len(specs))]
    jsrv = jfed.serve(jparams, max_batch=max_batch, temperature=temperature,
                      **kw)
    srv = fed.serve(params, max_batch=max_batch, temperature=temperature,
                    **kw)
    for p, (_, gl), k in zip(prompts, specs, keys):
        jsrv.submit(p, gl, key=k)
        srv.submit(p, gl, draws=JaxNoise(k))
    return jsrv, jsrv.run(), srv, srv.run()


def _assert_same_drain(jsrv, jres, srv, res):
    assert len(res) == len(jres)
    for got, want in zip(res, jres):
        assert got.rid == want.rid and got.status == want.status
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert ledger_tuples(got.ledger) == ledger_tuples(want.ledger)
        assert (got.admitted_at, got.finished_at, got.preemptions) == \
            (want.admitted_at, want.finished_at, want.preemptions)
    for name in ("steps", "generated_tokens", "host_transfers",
                 "preemptions", "deadline_misses", "poisoned"):
        assert getattr(srv, name) == getattr(jsrv, name), name
    assert srv.allocator.snapshot() == jsrv.allocator.snapshot()


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_continuous_matches_repro_scheduler(family, temperature):
    specs = [(4, 8), (4, 5), (6, 6), (2, 3)]
    _assert_same_drain(*_both_drain(family, 12, specs, temperature))


def test_preemption_matches_repro_scheduler(family="dense"):
    """A page-starved pool with preemption: the same victims, the same
    re-prefill and replay metering, the same tokens as repro's."""
    specs = [(4, 12), (4, 2), (4, 12)]
    jsrv, jres, srv, res = _both_drain(family, 32, specs, 0.8, salt=50,
                                       page_size=4, n_pages=8, preempt=True)
    assert srv.preemptions >= 1
    _assert_same_drain(jsrv, jres, srv, res)


def test_preemption_matches_repro_scheduler_ssm():
    """The same for the ssm family: a victim's slot-stacked state is
    rebuilt by the re-prefill and the replay."""
    test_preemption_matches_repro_scheduler("ssm")


def test_preemption_matches_repro_scheduler_mla():
    """The same for MLA: a victim's latent pages are freed, re-prefilled
    and replayed into new pages of both stacks' pools."""
    test_preemption_matches_repro_scheduler("mla")


# ------------------------------------------------------ failure policy ----

def test_preempted_requests_resume_with_unpreempted_tokens(family="dense"):
    """preempt=True and a page-starved pool: a victim is evicted mid-flight
    and re-admitted through re-prefill + replay; its tokens equal an
    unpreempted solo decode on the same source, and its ledger pays the
    extra wire."""
    _, _, fed, params, cfg = _build(family, 32)
    srv = fed.serve(params, max_batch=2, temperature=0.8, page_size=4,
                    n_pages=8, preempt=True)
    specs = [(4, 12), (4, 2), (4, 12)]
    prompts = _prompts(cfg, specs, 50)
    for i, (p, (_, gl)) in enumerate(zip(prompts, specs)):
        srv.submit(p, gl, seed=500 + i)
    results = srv.run()
    assert srv.preemptions >= 1
    assert sum(r.preemptions for r in results) == srv.preemptions
    assert srv.replay_steps > 0
    # the noise table holds the longest generation admitted, not seq_len
    assert srv._noise_st.shape[:2] == (2, 12)
    for i, (p, (_, gl)) in enumerate(zip(prompts, specs)):
        res = results[i]
        assert res.status == "ok"
        solo = _solo(fed, params, p, gl, 0.8, PositionGumbel(500 + i))
        np.testing.assert_array_equal(res.tokens, solo.tokens[0])
        assert res.ledger.total_bytes >= solo.ledger.total_bytes
        if res.preemptions:
            assert res.ledger.total_bytes > solo.ledger.total_bytes
    assert srv.allocator.in_use == 0


def test_preempted_ssm_requests_resume_with_unpreempted_tokens():
    test_preempted_requests_resume_with_unpreempted_tokens("ssm")


def test_position_gumbel_is_a_pure_function_of_seed_and_position():
    """A request's noise depends on (seed, t) only: a table drawn at once
    equals its rows drawn one by one, another seed draws other noise, the
    integer hash is exact mod 2**32, and the rows are Gumbel(0, 1)."""
    from repro_torch.federation import serving
    x = torch.randint(0, 2 ** 32, (4096,), dtype=torch.int64,
                      generator=torch.Generator().manual_seed(0))
    assert serving._mul32(x, 0x85EBCA6B).tolist() == [
        (int(v) * 0x85EBCA6B) % 2 ** 32 for v in x]
    g = PositionGumbel(7)
    table = g.rows(100, 6, 1000, "cpu")
    for i in range(6):
        assert torch.equal(g.rows(100 + i, 1, 1000, "cpu"), table[i:i + 1])
    assert torch.equal(g.gumbel(103, (1, 1000), "cpu"), table[3:4])
    assert not torch.equal(PositionGumbel(8).rows(100, 6, 1000, "cpu"),
                           table)
    big = g.rows(0, 64, 4096, "cpu")       # mean 0.5772, sd pi / sqrt(6)
    assert abs(float(big.mean()) - 0.5772) < 0.02
    assert abs(float(big.std()) - 1.2825) < 0.02


def test_queue_full_is_typed_and_recoverable():
    _, _, fed, params, _ = _build("dense", 8)
    srv = fed.serve(params, max_batch=1, max_queue=2)
    srv.submit(np.zeros(4, np.int32), 3)
    srv.submit(np.ones(4, np.int32), 3)
    with pytest.raises(QueueFull, match="admission queue full"):
        srv.submit(np.full(4, 2, np.int32), 3)
    assert isinstance(QueueFull("x"), RuntimeError)
    assert [r.status for r in srv.run()] == ["ok", "ok"]
    assert srv.submit(np.full(4, 3, np.int32), 3) == 2    # admits again
    (late,) = srv.run()
    assert late.status == "ok"


def test_deadline_miss_and_cancel_ledger_exact():
    """A queued request that can no longer meet its deadline fails typed;
    an in-flight cancel returns the tokens so far with a ledger equal to a
    solo decode of that length, message for message."""
    _, _, fed, params, cfg = _build("dense", 12)
    srv = fed.serve(params, max_batch=1, temperature=0.8)
    (prompt,) = _prompts(cfg, [(4, 8)], 60)
    a = srv.submit(prompt, 8, seed=600)
    b = srv.submit(np.zeros(4, np.int32), 6, deadline=2)   # infeasible
    c = srv.submit(np.full(4, 3, np.int32), 3, deadline=100)
    srv.run(max_steps=4)
    res_a = srv.cancel(a)
    assert res_a.status == "cancelled" and res_a.rid == a
    ran = res_a.tokens.size
    assert 0 < ran < 8
    _assert_solo(fed, params, prompt, ran, 0.8, PositionGumbel(600), res_a)
    assert srv.cancel(a) is None and srv.cancel(999) is None
    srv.run()
    assert srv.results[b].status == "deadline"
    assert srv.results[b].tokens.size == 0
    assert srv.results[b].ledger.total_bytes == 0
    assert srv.results[c].status == "ok"
    assert srv.deadline_misses == 1 and srv.allocator.in_use == 0
    # a queued cancel leaves an empty ledger
    d = srv.submit(np.zeros(4, np.int32), 2)
    assert srv.cancel(d).ledger.total_bytes == 0


def test_poisoned_request_isolated_and_pages_scrubbed():
    """A request whose cache pages go non-finite ends as "poisoned" instead
    of crashing the engine or returning NaN tokens as "ok"; its pages are
    zeroed before reuse, so the next tenant decodes as solo does."""
    _, _, fed, params, cfg = _build("dense", 12)
    srv = fed.serve(params, max_batch=2, temperature=0.8)
    (prompt,) = _prompts(cfg, [(4, 8)], 80)
    a = srv.submit(prompt, 8, seed=800)
    srv.run(max_steps=2)
    pages = [int(p) for p in srv._slot_pages[0]]
    plans = tree_leaves(srv._plans)
    for leaf, plan in zip(tree_leaves(srv._caches_st), plans):
        if plan.pooled:
            leaf[:, pages[0]] = float("nan")
    (res_a,) = srv.run()
    assert res_a.rid == a and res_a.status == "poisoned"
    assert srv.poisoned == 1 and srv.allocator.in_use == 0
    assert not np.isfinite(res_a.logits).all()
    for leaf, plan in zip(tree_leaves(srv._caches_st), plans):
        if plan.pooled:
            assert torch.isfinite(leaf).all()
            assert not leaf[:, pages].any()          # scrubbed to zero
    (prompt_b,) = _prompts(cfg, [(4, 6)], 81)
    srv.submit(prompt_b, 6, seed=801)
    (res_b,) = srv.run()
    assert res_b.status == "ok"
    _assert_solo(fed, params, prompt_b, 6, 0.8, PositionGumbel(801), res_b)


def test_small_pool_churn_with_preemption_drains_clean():
    _, _, fed, params, cfg = _build("dense", 16)
    srv = fed.serve(params, max_batch=2, temperature=0.8, page_size=4,
                    n_pages=6, preempt=True)        # capacity: 4 pages
    specs = [(4, 10), (4, 2), (4, 8), (2, 3), (4, 4)]
    prompts = _prompts(cfg, specs, 90)
    for i, (p, (_, gl)) in enumerate(zip(prompts, specs)):
        srv.submit(p, gl, seed=900 + i)
    results = srv.run()
    assert [r.status for r in results] == ["ok"] * len(specs)
    for i, (p, (_, gl)) in enumerate(zip(prompts, specs)):
        solo = _solo(fed, params, p, gl, 0.8, PositionGumbel(900 + i))
        np.testing.assert_array_equal(results[i].tokens, solo.tokens[0])
    assert srv.allocator.in_use == 0
    assert srv.allocator.peak_in_use <= srv.allocator.capacity


def test_scheduler_reuse_returns_only_new_results():
    _, _, fed, params, _ = _build("dense", 8)
    srv = fed.serve(params, max_batch=2)
    a = srv.submit(np.zeros(4, np.int32), 3)
    (first,) = srv.run()
    b = srv.submit(np.ones(4, np.int32), 3, seed=1)
    (second,) = srv.run()
    assert (first.rid, second.rid) == (a, b)
    assert set(srv.results) == {a, b}


def test_scheduler_validation():
    _, _, fed, params, _ = _build("dense", 8)
    srv = fed.serve(params, max_batch=2)
    with pytest.raises(ValueError, match="seq_len"):
        srv.submit(np.zeros(6, np.int32), 6)
    with pytest.raises(ValueError, match="max_batch"):
        fed.serve(params, max_batch=0)
    with pytest.raises(ValueError, match="max_queue"):
        fed.serve(params, max_queue=0)
    with pytest.raises(ValueError, match="page_size"):
        fed.serve(params, page_size=3)
    with pytest.raises(ValueError, match="gen_len"):
        srv.submit(np.zeros(4, np.int32), 0)
    with pytest.raises(ValueError, match="prompt"):
        srv.submit(np.zeros(0, np.int32), 4)
    with pytest.raises(ValueError, match="deadline"):
        srv.submit(np.zeros(4, np.int32), 2, deadline=0)
    with pytest.raises(ValueError, match="not both"):
        srv.submit(np.zeros(4, np.int32), 2, seed=1,
                   draws=PositionGumbel(1))
    with pytest.raises(ValueError, match="seed"):
        PositionGumbel(-1)
    with pytest.raises(ValueError, match="ModelConfig"):
        Federation.build(fed.adapter, device="cpu").serve(params)


# ----------------------------------------------------------- durability ---

def test_serve_kill_mid_drain_resumes(tmp_path, family="hybrid"):
    """Snapshot after a bounded run, persist through fed.save, restore in
    a fresh session and finish: tokens, statuses and ordered ledgers equal
    an uninterrupted drain's."""
    _, _, fed, params, cfg = _build(family, 12)
    specs = [(4, 8), (3, 5), (6, 6), (2, 3)]
    prompts = _prompts(cfg, specs, 70)

    def submit_all(srv):
        for i, (p, (_, gl)) in enumerate(zip(prompts, specs)):
            srv.submit(p, gl, seed=700 + i)

    ref = fed.serve(params, max_batch=2, temperature=0.8)
    submit_all(ref)
    ref.run()

    srv = fed.serve(params, max_batch=2, temperature=0.8)
    submit_all(srv)
    srv.run(max_steps=6)
    assert srv.active > 0 and srv.pending > 0 and srv.results
    path = fed.save(str(tmp_path / "ck"), params,
                    serve_state=srv.snapshot())
    del srv
    manifest = json.load(open(os.path.join(path, "session.json")))
    assert manifest["serve_plane"] is True

    fed2, params2, state = Federation.restore(path, device="cpu")
    assert state.serve_state is not None
    srv2 = fed2.serve(params2, state=state.serve_state)
    assert srv2.temperature == 0.8 and srv2.max_batch == 2
    srv2.run()
    assert set(srv2.results) == set(ref.results)
    for rid, want in ref.results.items():
        got = srv2.results[rid]
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert got.status == want.status
        assert ledger_tuples(got.ledger) == ledger_tuples(want.ledger)
    assert srv2.allocator.in_use == 0
    assert srv2.host_transfers == ref.host_transfers

    # an injected draw source cannot be recorded
    inj = fed.serve(params, max_batch=2, temperature=0.8)
    inj.submit(prompts[0], 4, draws=PositionGumbel(3))
    with pytest.raises(ValueError, match="injected draw source"):
        inj.snapshot()


def test_serve_kill_mid_drain_resumes_ssm(tmp_path):
    """The same with the ssm family's slot-stacked states in the
    snapshot."""
    test_serve_kill_mid_drain_resumes(tmp_path, "ssm")


def test_serve_kill_mid_drain_resumes_mla(tmp_path):
    """The same with MLA's {"dense", "main"} latent pools in the
    snapshot."""
    test_serve_kill_mid_drain_resumes(tmp_path, "mla")


def test_repro_serve_snapshot_is_refused(tmp_path):
    """A SAMPLING serve snapshot written by repro draws from threefry key
    data, which the port cannot draw from: its restore says so (a greedy
    one crosses: ``test_greedy_serve_snapshot_crosses_both_ways``)."""
    jfed, jparams, _, _, _ = _build("dense", 12)
    jsrv = jfed.serve(jparams, max_batch=2, temperature=0.8)
    jsrv.submit(np.zeros(4, np.int32), 6, seed=3)
    jsrv.run(max_steps=2)
    path = jfed.save(str(tmp_path / "ck"), jparams,
                     serve_state=jsrv.snapshot())
    with pytest.raises(ValueError, match="threefry"):
        Federation.restore(path, device="cpu")


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_greedy_serve_snapshot_crosses_both_ways(tmp_path, writer,
                                                 family="dense"):
    """A greedy snapshot draws nothing, so it crosses: one package drains
    part of the traffic, saves the session with its serve plane, and the
    OTHER package restores it and finishes the drain. Tokens, statuses
    and ordered ledgers equal the writer's own uninterrupted drain."""
    jfed, jparams, fed, params, cfg = _build(family, 12)
    specs = [(4, 8), (3, 5), (6, 6), (2, 3)]
    prompts = _prompts(cfg, specs, 71)

    def drain(sess, p, steps=None):
        srv = sess.serve(p, max_batch=2)
        for prompt, (_, gl) in zip(prompts, specs):
            srv.submit(prompt, gl)
        srv.run(max_steps=steps)
        return srv

    ref = drain(*((jfed, jparams) if writer == "repro" else (fed, params)))
    srv = drain(*((jfed, jparams) if writer == "repro" else (fed, params)),
                steps=6)
    assert srv.active > 0 and srv.pending > 0 and srv.results
    writer_fed, writer_params = ((jfed, jparams) if writer == "repro"
                                 else (fed, params))
    path = writer_fed.save(str(tmp_path / "ck"), writer_params,
                           serve_state=srv.snapshot())
    if writer == "repro":
        fed2, params2, state = Federation.restore(path, device="cpu")
    else:
        fed2, params2, state = JFederation.restore(path)
    srv2 = fed2.serve(params2, state=state.serve_state)
    srv2.run()
    assert set(srv2.results) == set(ref.results)
    for rid, want in ref.results.items():
        got = srv2.results[rid]
        np.testing.assert_array_equal(np.asarray(got.tokens),
                                      np.asarray(want.tokens))
        assert got.status == want.status
        assert ledger_tuples(got.ledger) == ledger_tuples(want.ledger)
    assert srv2.allocator.in_use == 0


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_greedy_serve_snapshot_crosses_both_ways_mla(tmp_path, writer):
    """The same with MLA's latent pools: the {"dense", "main"} tree crosses
    by the JAX package's leaf keys."""
    test_greedy_serve_snapshot_crosses_both_ways(tmp_path, writer, "mla")


# ------------------------------------------------------------ the driver --

def test_continuous_driver_returns_repros_keys_and_wire():
    kw = dict(batch=5, prompt_len=4, gen_len=5, n_clients=2,
              continuous=True, max_batch=2)
    ours = serve.serve("phi3-mini-3.8b", device="cpu", **kw)
    theirs = j_serve.serve("phi3-mini-3.8b", **kw)
    assert set(theirs) <= set(ours)
    assert ours["mode"] == "continuous" and ours["device"] == "cpu"
    assert ours["statuses"] == theirs["statuses"] == {"ok": 5}
    assert ours["wire_bytes"] == theirs["wire_bytes"]
    assert ours["steps"] == theirs["steps"]
    up, token = serve_messages(1, reduced(get_config(
        "phi3-mini-3.8b")).d_model)
    assert ours["wire_bytes"] == 5 * ((4 + 5) * up.nbytes + 5 * token.nbytes)
    assert not ours["wire_has_gradients"]
    # bounded admission: the driver drains a step on QueueFull and retries
    bounded = serve.serve("phi3-mini-3.8b", device="cpu",
                          **dict(kw, max_queue=1))
    assert bounded["queue_retries"] > 0 and bounded["statuses"] == {"ok": 5}
    assert bounded["wire_bytes"] == ours["wire_bytes"]
    with pytest.raises(ValueError, match="n_clients"):
        serve.serve("phi3-mini-3.8b", device="cpu",
                    **dict(kw, n_clients=0))


def test_serve_cli_continuous_flags(monkeypatch):
    seen = []
    monkeypatch.setattr(serve, "serve",
                        lambda arch, **kw: seen.append(kw) or {"arch": arch})
    serve.main(["--continuous", "--max-batch", "8", "--max-queue", "3",
                "--preempt", "--n-pages", "40", "--deadline", "9",
                "--device", "cpu"])
    assert seen[0]["continuous"] and seen[0]["max_batch"] == 8
    assert (seen[0]["max_queue"], seen[0]["preempt"], seen[0]["n_pages"],
            seen[0]["deadline"]) == (3, True, 40, 9)
