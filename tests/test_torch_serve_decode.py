"""The port's split serve plane (``Federation.decode``, ``launch.serve``)
against the JAX package's, and its own invariants as
``tests/test_serving_engine.py`` holds them for ``repro``.

Every case runs on four families: reduced phi3 (dense), reduced zamba2
with 4 layers (hybrid: 2 super-blocks of 2 Mamba2 layers, the shared
attention block at 2 sites, the tuple cache of SSM states and KV),
reduced rwkv6 (ssm: the wkv and token-shift states, ``repro``'s "ssm"
cases) and reduced qwen3-moe (MoE: the dense form at every cached chunk
and step).

* Same weights (carried from ``repro``), same prompts, in f32: greedy
  tokens equal and the last logits within 1e-4, for both
  prefill modes; at temperature 0.8 the port is handed ``repro``'s own
  Gumbel draws (``jax.random.categorical`` is ``argmax(logits / T +
  gumbel(fold_in(key, 100 + t)))``) and the tokens are equal; the wire
  ledgers are message for message equal.
* Split == global (bitwise), token-by-token prefill == chunked prefill
  (tokens exact, logits to 1e-4), ``prefill_plan`` span-aligned.
* The driver: split and global paths agree, the wire bytes equal the
  JAX driver's and ``Transport.account_serve``'s formula, ``--no-reduced``
  selects full width, and the continuous path serves the same prompts to
  the same greedy tokens and wire bytes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.federation import Federation as JFederation
from repro.launch import serve as j_serve
from repro.models import common as j_common
from repro_torch.configs import get_config, reduced
from repro_torch.core.privacy import Ledger
from repro_torch.federation import Federation, ServeScheduler, Transport
from repro_torch.federation.serving import prefill_plan
from repro_torch.launch import serve
from repro_torch.models import common
from repro_torch.models.model_api import build_cache_specs, build_model
from repro_torch.tree import tree_map
from test_torch_support import (MODALITY_ARCHS, ledger_tuples,
                                split_plane_refusal, to_numpy, to_torch,
                                torch_threads)

# the reduced configs, in f32; zamba2 with 4 layers so that the shared
# attention block runs at two sites
ARCHS = {"phi3-mini-3.8b": dict(param_dtype="float32", dtype="float32"),
         "zamba2-2.7b": dict(param_dtype="float32", dtype="float32",
                             n_layers=4),
         "rwkv6-7b": dict(param_dtype="float32", dtype="float32"),
         "qwen3-moe-30b-a3b": dict(param_dtype="float32", dtype="float32"),
         # MLA at a q/k head dim (32 + 16) unlike its v head dim (32); one
         # dense layer, one MoE layer, the {"dense", "main"} latent cache
         "deepseek-v3-671b": dict(param_dtype="float32", dtype="float32",
                                  qk_nope_dim=32, qk_rope_dim=16,
                                  v_head_dim=32)}
B, PL, GL = 2, 8, 6
LOGITS_ATOL = 1e-4


@pytest.fixture(scope="module", params=list(ARCHS))
def case(request):
    """Both sessions on the same reduced weights and prompts."""
    arch = request.param
    jcfg = j_reduced(j_get_config(arch), **ARCHS[arch])
    cfg = reduced(get_config(arch), **ARCHS[arch])
    jfed = JFederation.build(jcfg, n_clients=2, seq_len=PL + GL)
    fed = Federation.build(cfg, n_clients=2, seq_len=PL + GL, device="cpu")
    key = jax.random.key(0)
    gp = j_common.materialize(jfed.model.param_specs, key)
    toks = np.asarray(jax.random.randint(jax.random.fold_in(key, 1),
                                         (B, PL), 0, cfg.vocab_size))
    with torch_threads(2):
        yield dict(jfed=jfed, fed=fed, key=key, gp=gp, tp=to_torch(gp),
                   toks=toks, cfg=cfg, arch=arch)


class JaxGumbel:
    """The port's Gumbel draw source, answered with the noise
    ``repro.federation.serving.sample_token`` draws at step ``t``."""

    def __init__(self, key):
        self.key = key

    def gumbel(self, t, shape, device):
        g = jax.random.gumbel(jax.random.fold_in(self.key, 100 + t), shape,
                              jnp.float32)
        return torch.from_numpy(np.asarray(g)).to(device)


@pytest.mark.parametrize("chunked", [True, False])
def test_greedy_decode_matches_repro(case, chunked):
    jr = case["jfed"].decode(case["gp"], jnp.asarray(case["toks"]),
                             gen_len=GL, key=case["key"],
                             chunked_prefill=chunked)
    tr = case["fed"].decode(case["tp"], case["toks"], gen_len=GL,
                            chunked_prefill=chunked)
    assert tr.tokens.shape == (B, GL) and tr.tokens.dtype == np.int32
    np.testing.assert_array_equal(tr.tokens, jr.tokens)
    assert tr.logits.shape == (B, 1, case["cfg"].padded_vocab)
    np.testing.assert_allclose(to_numpy(tr.logits), to_numpy(jr.logits),
                               atol=LOGITS_ATOL, rtol=0)
    assert ledger_tuples(tr.ledger) == ledger_tuples(jr.ledger)
    assert tr.ledger.total_bytes == jr.ledger.total_bytes
    assert not tr.transmits_gradients
    assert tr.compile_s == 0.0 and tr.prefill_s > 0 and tr.decode_s > 0


def test_sampled_decode_matches_repro_on_its_draws(case):
    jr = case["jfed"].decode(case["gp"], jnp.asarray(case["toks"]),
                             gen_len=GL, key=case["key"], temperature=0.8)
    tr = case["fed"].decode(case["tp"], case["toks"], gen_len=GL,
                            temperature=0.8, draws=JaxGumbel(case["key"]))
    np.testing.assert_array_equal(tr.tokens, jr.tokens)
    assert tr.ledger.total_bytes == jr.ledger.total_bytes
    # the default draw source is seeded and repeatable
    a = case["fed"].decode(case["tp"], case["toks"], gen_len=GL,
                           temperature=0.8, seed=3)
    b = case["fed"].decode(case["tp"], case["toks"], gen_len=GL,
                           temperature=0.8, seed=3)
    np.testing.assert_array_equal(a.tokens, b.tokens)


def _global_decode(cfg, gp, toks, gen_len):
    """The global serve loop (one party, token-by-token prefill through
    the decode step) — the bitwise oracle for split decode."""
    model = build_model(cfg, max_seq=toks.shape[1] + gen_len)
    caches = tree_map(
        lambda s: torch.zeros(s.shape, dtype=common.torch_dtype(s.dtype)),
        build_cache_specs(cfg, toks.shape[0], toks.shape[1] + gen_len))
    toks = torch.from_numpy(toks)
    logits = None
    for t in range(toks.shape[1]):
        logits, caches = model.decode_fn(gp, {"tokens": toks[:, t:t + 1]},
                                         caches, t)
    out = []
    for t in range(toks.shape[1], toks.shape[1] + gen_len):
        nxt = torch.argmax(logits[:, -1].float(), -1).clamp(
            max=cfg.vocab_size - 1).to(torch.int32)
        out.append(nxt)
        logits, caches = model.decode_fn(gp, {"tokens": nxt[:, None]},
                                         caches, t)
    return torch.stack(out, 1).numpy(), logits


def test_split_equals_global_and_loop_equals_chunked(case):
    """The port's own invariants: split decode (token-by-token prefill) is
    bitwise the global decode; chunked prefill gives the same tokens and
    logits within 1e-4; use_scan does not change the result."""
    fed, tp, toks = case["fed"], case["tp"], case["toks"]
    stepped = fed.decode(tp, toks, gen_len=GL, chunked_prefill=False)
    ref_tokens, ref_logits = _global_decode(case["cfg"], tp, toks, GL)
    np.testing.assert_array_equal(stepped.tokens, ref_tokens)
    np.testing.assert_array_equal(to_numpy(stepped.logits),
                                  to_numpy(ref_logits))
    chunked = fed.decode(tp, toks, gen_len=GL)
    np.testing.assert_array_equal(chunked.tokens, stepped.tokens)
    np.testing.assert_allclose(to_numpy(chunked.logits),
                               to_numpy(stepped.logits), atol=1e-4,
                               rtol=1e-5)
    unscanned = fed.decode(tp, toks, gen_len=GL, use_scan=False)
    np.testing.assert_array_equal(unscanned.tokens, chunked.tokens)
    # engine-layout params give the same result as the global tree
    engine = fed.params_from_global(tp)
    assert engine["clients"]["embed"]["table"].shape[0] == 2
    # the server holds everything but the embedding (the hybrid family's
    # shared attention block included) and DeepSeek-V3's MTP head, which
    # only the global training loss reads
    assert set(engine["server"]) == set(tp) - {"embed", "mtp"}
    np.testing.assert_array_equal(
        fed.decode(engine, toks, gen_len=GL).tokens, chunked.tokens)


def test_ledger_extends_and_counts_the_formula(case):
    fed, cfg = case["fed"], case["cfg"]
    first = fed.decode(case["tp"], case["toks"], gen_len=GL)
    # per step one (B, d_model) f32 embedding up; per generated token one
    # (B,) int32 id down
    per_call = (PL + GL) * B * cfg.d_model * 4 + GL * B * 4
    assert first.wire_bytes == per_call
    total = fed.decode(case["tp"], case["toks"], gen_len=GL,
                       ledger=first.ledger).ledger
    assert total is first.ledger and total.total_bytes == 2 * per_call
    assert (Transport().account_serve(batch=B, embed=cfg.d_model,
                                      n_steps=PL + GL, n_gen=GL).total_bytes
            == per_call)
    step = Ledger()
    for gen in (False, True):
        Transport().account_serve_step(batch=B, embed=cfg.d_model, gen=gen,
                                       ledger=step)
    assert step.total_bytes == 2 * B * cfg.d_model * 4 + B * 4
    with pytest.raises(ValueError):
        Transport().account_serve(batch=B, embed=8, n_steps=2, n_gen=3)


def test_prefill_plan_span_aligned():
    """Chunks never straddle a party boundary and tile the prompt."""
    assert prefill_plan(10, 4) == [(0, 4, 0), (4, 8, 1), (8, 10, 2)]
    assert prefill_plan(3, 8) == [(0, 3, 0)]
    plan = prefill_plan(16, 8)
    assert plan == [(0, 8, 0), (8, 16, 1)]
    assert all(t1 <= (m + 1) * 8 for t0, t1, m in plan)
    # the serve phase of the chip run: 8 x (1024 + 128) over 2 parties
    assert prefill_plan(1024, 576) == [(0, 576, 0), (576, 1024, 1)]


def test_decode_rejects_what_it_cannot_serve(case):
    fed = case["fed"]
    with pytest.raises(ValueError, match="seq_len"):
        fed.decode(case["tp"], case["toks"], gen_len=GL + 1)
    srv = fed.serve(case["tp"])          # continuous batching serves now
    assert isinstance(srv, ServeScheduler) and srv.device == fed.device
    # the multimodal and encoder-decoder families cannot cross the wire:
    # the split serve plane refuses them with repro's ValueError
    for arch in MODALITY_ARCHS:
        msg = split_plane_refusal(arch)
        modal = Federation.build(reduced(get_config(arch)), device="cpu")
        with pytest.raises(ValueError) as ours:
            modal.decode({}, case["toks"], gen_len=1)
        with pytest.raises(ValueError) as theirs:
            JFederation.build(j_reduced(j_get_config(arch))).decode(
                {}, jnp.asarray(case["toks"]), gen_len=1)
        assert str(ours.value) == str(theirs.value) == msg


# ------------------------------------------------------------ the driver --

def test_serve_driver_split_and_global(case):
    arch = case["arch"]
    with torch_threads(2):
        split = serve.serve(arch, batch=3, prompt_len=6, gen_len=5,
                            n_clients=2, device="cpu")
        glob = serve.serve(arch, batch=3, prompt_len=6, gen_len=5,
                           n_clients=0, device="cpu")
    theirs = j_serve.serve(arch, batch=3, prompt_len=6, gen_len=5,
                           n_clients=2)
    assert split["mode"] == "federated" and glob["mode"] == "global"
    assert split["sample_output"] == glob["sample_output"]
    assert split["wire_bytes"] == theirs["wire_bytes"]
    d = get_config(arch)
    assert split["wire_bytes"] == Transport().account_serve(
        batch=3, embed=reduced(d).d_model, n_steps=11, n_gen=5).total_bytes
    assert split["seq_len"] == 12 and not split["wire_has_gradients"]
    # the continuous path serves the same prompts one request each
    with torch_threads(2):
        cont = serve.serve(arch, batch=3, prompt_len=6, gen_len=5,
                           n_clients=2, continuous=True, device="cpu")
    assert cont["mode"] == "continuous" and cont["statuses"] == {"ok": 3}
    assert cont["sample_output"] == split["sample_output"]
    assert cont["wire_bytes"] == split["wire_bytes"]


def test_serve_cli_reduced_flag(monkeypatch, capsys):
    """``--no-reduced`` reaches full width (the JAX driver's store_true
    flag with default True cannot); the default stays reduced."""
    seen = []
    monkeypatch.setattr(serve, "serve",
                        lambda arch, **kw: seen.append(kw) or {"arch": arch})
    serve.main(["--no-reduced", "--batch", "8", "--device", "cpu"])
    serve.main([])
    assert seen[0]["use_reduced"] is False and seen[0]["batch"] == 8
    assert seen[0]["device"] == "cpu" and seen[1]["use_reduced"] is True
    assert seen[1]["n_clients"] == 2 and seen[1]["device"] is None
    assert '"arch": "phi3-mini-3.8b"' in capsys.readouterr().out
