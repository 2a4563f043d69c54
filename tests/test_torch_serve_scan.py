"""The port's scan-form decode (``serving.make_decode_scan``,
``Federation.decode(use_scan=True)``) and the scheduler's replay through
the device-position step, on the CPU, against the JAX package's
``make_decode_scan`` and against the port's own eager loop.

On the card ``use_scan=True`` captures one generated token as a CUDA graph
and replays it; here the same step body runs in a Python loop (the graph
itself runs only on the card, where ``chip_smoke.py`` holds it to the
eager loop). Four families in f32: reduced phi3, reduced zamba2 with 4
layers (the hybrid family's SSM states and shared attention block),
reduced rwkv6 (the ssm family's wkv and token-shift states: ``repro``'s
"ssm" scan cases) and reduced qwen3-moe (the MoE dense form every decode
step takes).

* The device-position step (a (1,) int64 position, the owner picked on
  the device, the cache row written at a device index) equals the
  Python-int step bitwise, logits and every cache leaf, at positions on
  both sides of the party boundary.
* ``fed.decode(use_scan=True)`` gives ``repro``'s scan-path greedy tokens,
  logits within 1e-4, across the party boundary.
* ``use_scan=True`` equals ``use_scan=False`` bitwise at temperature 0.8
  under ``TorchGumbel`` (the default source, B = 2) and under
  ``PositionGumbel`` (B = 1).
* The scan body makes no host sync: it runs with every tensor-to-host
  conversion raising.
* A scheduler drain with preemption gives the same tokens, logits,
  ledgers and ``replay_steps`` through the device-position replay as
  through the eager one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.federation import Federation as JFederation
from repro.models import common as j_common
from repro_torch.configs import get_config, reduced
from repro_torch.federation import Federation, serving
from repro_torch.federation.serving import PositionGumbel
from repro_torch.tree import tree_leaves
from test_torch_support import ledger_tuples, to_numpy, to_torch, torch_threads

ARCHS = {"phi3-mini-3.8b": dict(param_dtype="float32", dtype="float32"),
         "zamba2-2.7b": dict(param_dtype="float32", dtype="float32",
                             n_layers=4),
         "rwkv6-7b": dict(param_dtype="float32", dtype="float32"),
         "qwen3-moe-30b-a3b": dict(param_dtype="float32", dtype="float32"),
         # MLA (q/k head dim 48, v 32), one dense and one MoE layer
         "deepseek-v3-671b": dict(param_dtype="float32", dtype="float32",
                                  qk_nope_dim=32, qk_rope_dim=16,
                                  v_head_dim=32)}
# 2 client parties over 16 positions: the party boundary at 8 falls
# inside the generation
SEQ, PL, GL = 16, 6, 10
LOGITS_ATOL = 1e-4
HOST_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
              "__float__", "__index__")


@pytest.fixture(autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module", params=list(ARCHS))
def case(request):
    """Both sessions on the same reduced weights and prompts."""
    arch = request.param
    jcfg = j_reduced(j_get_config(arch), **ARCHS[arch])
    cfg = reduced(get_config(arch), **ARCHS[arch])
    jfed = JFederation.build(jcfg, n_clients=2, seq_len=SEQ)
    fed = Federation.build(cfg, n_clients=2, seq_len=SEQ, device="cpu")
    key = jax.random.key(0)
    gp = j_common.materialize(jfed.model.param_specs, key)
    toks = np.asarray(jax.random.randint(jax.random.fold_in(key, 1),
                                         (2, PL), 0, cfg.vocab_size))
    return dict(jfed=jfed, fed=fed, key=key, gp=gp,
                params=fed.params_from_global(to_torch(gp)), toks=toks,
                cfg=cfg)


def _prefilled(case, batch=2):
    """The prompts' chunked prefill: (last logits, caches)."""
    fed, params = case["fed"], case["params"]
    toks = torch.from_numpy(case["toks"][:batch].astype(np.int32))
    caches = serving.zero_caches(fed.adapter, batch, SEQ, "cpu")
    for t0, t1, m in serving.prefill_plan(PL, SEQ // 2):
        logits, caches = serving.prefill_chunk(fed.adapter, params,
                                               toks[:, t0:t1], caches, t0, m)
    return logits, caches


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_copy(v) for v in tree)
    return tree.clone()


def test_device_position_step_equals_int_step_bitwise(case):
    fed, params = case["fed"], case["params"]
    _, caches = _prefilled(case)
    by_int, by_dev = caches, _copy(caches)
    step = fed.serve_step()
    rng = np.random.default_rng(3)
    for t in range(PL, SEQ):                       # owners 0, then 1
        tok = torch.from_numpy(rng.integers(
            0, case["cfg"].vocab_size, (2, 1)).astype(np.int32))
        want, by_int = step(params, tok, by_int, t)
        got, by_dev = step(params, tok, by_dev,
                           torch.tensor([t], dtype=torch.int64))
        assert torch.equal(got, want), t
        for a, b in zip(tree_leaves(by_dev), tree_leaves(by_int)):
            assert torch.equal(a, b), t
    # a 0-d position is the same step
    got, _ = step(params, tok, _copy(by_int), torch.tensor(SEQ - 1))
    want, _ = step(params, tok, _copy(by_int), SEQ - 1)
    assert torch.equal(got, want)


def test_scan_decode_matches_repro_scan(case):
    jr = case["jfed"].decode(case["gp"], jnp.asarray(case["toks"]),
                             gen_len=GL, key=case["key"], use_scan=True)
    tr = case["fed"].decode(case["params"], case["toks"], gen_len=GL,
                            use_scan=True)
    np.testing.assert_array_equal(tr.tokens, jr.tokens)
    np.testing.assert_allclose(to_numpy(tr.logits), to_numpy(jr.logits),
                               atol=LOGITS_ATOL, rtol=0)
    assert ledger_tuples(tr.ledger) == ledger_tuples(jr.ledger)
    # the CPU runs the body in a loop: nothing is captured
    assert tr.graph is None and tr.compile_s == 0.0


@pytest.mark.parametrize("source", ["torch", "position"])
def test_scan_equals_eager_loop_when_sampling(case, source):
    fed, params = case["fed"], case["params"]
    toks = case["toks"] if source == "torch" else case["toks"][:1]

    def run(use_scan):
        kw = (dict(seed=7) if source == "torch"
              else dict(draws=PositionGumbel(7)))
        return fed.decode(params, toks, gen_len=GL, temperature=0.8,
                          use_scan=use_scan, **kw)
    scan, loop = run(True), run(False)
    np.testing.assert_array_equal(scan.tokens, loop.tokens)
    assert torch.equal(scan.logits, loop.logits)
    assert ledger_tuples(scan.ledger) == ledger_tuples(loop.ledger)
    # the sampled tokens are not the greedy ones
    greedy = fed.decode(params, toks, gen_len=GL)
    assert not np.array_equal(scan.tokens, greedy.tokens)


def test_noise_table_draws_as_the_eager_loop(case):
    """TorchGumbel's table is gen_len calls in position order; a source
    with ``rows`` fills it in one call."""
    vocab = case["cfg"].padded_vocab
    table = serving.noise_table(serving.TorchGumbel(5, "cpu"), PL, 3, 2,
                                vocab, "cpu")
    g = serving.TorchGumbel(5, "cpu")
    want = torch.stack([g.gumbel(t, (2, vocab), "cpu")
                        for t in range(PL, PL + 3)])
    assert table.shape == (3, 2, vocab) and torch.equal(table, want)
    table = serving.noise_table(PositionGumbel(5), PL, 3, 1, vocab, "cpu")
    want = torch.stack([PositionGumbel(5).gumbel(t, (1, vocab), "cpu")
                        for t in range(PL, PL + 3)])
    assert table.shape == (3, 1, vocab) and torch.equal(table, want)
    with pytest.raises(ValueError, match="batch 1"):
        serving.noise_table(PositionGumbel(5), PL, 3, 2, vocab, "cpu")


def test_scan_body_makes_no_host_sync(case, monkeypatch):
    fed, params, cfg = case["fed"], case["params"], case["cfg"]
    logits, caches = _prefilled(case)
    noise = serving.noise_table(serving.TorchGumbel(1, "cpu"), PL, GL, 2,
                                logits.shape[-1], "cpu")
    st = serving.decode_buffers(logits, caches, PL, GL, noise)
    scan = serving.make_decode_scan(fed.adapter, 2, SEQ, PL, GL, 0.8,
                                    cfg.vocab_size)

    def refuse(*_a, **_k):
        raise AssertionError("host sync inside the decode scan")
    with monkeypatch.context() as m:
        for name in HOST_READS:
            m.setattr(torch.Tensor, name, refuse)
        assert scan(params, st) is None
    assert int(st["pos"]) == PL + GL
    loop = fed.decode(params, case["toks"], gen_len=GL, temperature=0.8,
                      draws=serving.TorchGumbel(1, "cpu"), use_scan=False)
    np.testing.assert_array_equal(st["out"].numpy(), loop.tokens)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_preempted_drain_replays_as_the_eager_replay(case, temperature):
    """preempt=True on a page-starved pool: the device-position replay
    (use_scan) and the eager replay give the same tokens, final logits,
    ledgers, counters and replayed tokens."""
    fed, params, cfg = case["fed"], case["params"], case["cfg"]
    rng = np.random.default_rng(50)
    specs = [(4, 12), (4, 2), (4, 12)]
    prompts = [rng.integers(0, cfg.vocab_size, pl).astype(np.int32)
               for pl, _ in specs]

    def drain(use_scan):
        srv = fed.serve(params, max_batch=2, temperature=temperature,
                        page_size=4, n_pages=8, preempt=True,
                        use_scan=use_scan)
        for i, (p, (_, gl)) in enumerate(zip(prompts, specs)):
            srv.submit(p, gl, seed=500 + i)
        return srv, srv.run()
    srv, res = drain(True)
    esrv, eres = drain(False)
    assert srv.preemptions >= 1 and srv.replay_steps > 0
    assert srv._replay_st is not None and esrv._replay_st is None
    for name in ("steps", "generated_tokens", "host_transfers",
                 "preemptions", "replay_steps", "prefill_chunks"):
        assert getattr(srv, name) == getattr(esrv, name), name
    assert srv.graph_captures == esrv.graph_captures == 0
    for got, want in zip(res, eres):
        assert got.status == want.status == "ok"
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_array_equal(got.logits, want.logits)
        assert ledger_tuples(got.ledger) == ledger_tuples(want.ledger)
