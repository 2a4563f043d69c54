"""The global decode's compiled form (``launch.serve.make_global_steps``,
``_serve_global``): a prefill step and a decode step on static token,
position and cache buffers, replayed as CUDA graphs on the card and
looped here on the CPU, and the device position in the global forward.

* ``transformer.forward`` and ``encdec.forward`` (through
  ``decode_fn``) give bitwise the same logits and caches with a 0-d or a
  (1,) int64 tensor ``cur_pos`` as with the Python int, on reduced phi3,
  InternVL2 and Whisper.
* The step bodies, looped, decode ``repro``'s tokens greedily from
  ``repro``'s params (f32, reduced), with the final logits at the
  tolerance ``tests/test_torch_encdec.py`` holds decode logits to.
* The looped bodies equal the eager token-by-token loop over
  ``decode_fn`` at Python-int positions bitwise (tokens and final
  logits), greedy and sampled, as the bodies of this file's loop and as
  ``global_decode``; ``_serve_global`` carries no graph on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.launch import serve as j_serve
from repro.models import common as j_common
from repro.models import encdec as j_encdec
from repro.models.model_api import build_cache_specs as j_build_cache_specs
from repro.models.model_api import build_model as j_build_model
from repro_torch.configs import get_config, reduced
from repro_torch.federation import serving
from repro_torch.launch import serve
from repro_torch.models import encdec
from repro_torch.models.model_api import build_cache_specs, build_model
from repro_torch.tree import tree_leaves, tree_map
from test_torch_encdec import LOGITS_TOL, _close, lively
from test_torch_support import to_torch, torch_threads

ARCHS = ("phi3-mini-3.8b", "internvl2-26b", "whisper-medium")
F32 = dict(param_dtype="float32", dtype="float32")
B, P, G = 2, 4, 4


@pytest.fixture(autouse=True)
def _threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch = request.param
    jcfg = j_reduced(j_get_config(arch), **F32)
    cfg = reduced(get_config(arch), **F32)
    jmodel = j_build_model(jcfg, max_seq=P + G)
    model = build_model(cfg, max_seq=P + G)
    jparams = lively(j_common.materialize(jmodel.param_specs,
                                          jax.random.key(0)), 1)
    tparams = to_torch(jparams)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    extra, jextra = {}, {}
    if cfg.is_encoder_decoder:
        frames = rng.normal(size=(B, cfg.encoder_seq, cfg.frontend_dim)
                            ).astype(np.float32)
        extra["enc_out"] = encdec.encode(cfg, tparams,
                                         torch.from_numpy(frames))
        jextra["enc_out"] = j_encdec.encode(jcfg, jparams,
                                            jnp.asarray(frames))
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jmodel=jmodel, model=model,
                jparams=jparams, tparams=tparams, toks=toks, extra=extra,
                jextra=jextra)


def _zero_caches(cfg, seq, dtype=None):
    return tree_map(lambda s: torch.zeros(s.shape, dtype=getattr(
        torch, dtype or s.dtype)), build_cache_specs(cfg, B, seq))


@pytest.mark.parametrize("form", ["0-d", "(1,)"])
def test_device_position_equals_the_int_position(case, form):
    cfg, model, params = case["cfg"], case["model"], case["tparams"]
    toks = torch.from_numpy(case["toks"])
    caches = _zero_caches(cfg, P + G)
    for t in range(2):
        _, caches = model.decode_fn(
            params, {"tokens": toks[:, t:t + 1], **case["extra"]}, caches, t)
    other = tree_map(torch.clone, caches)
    for t in range(2, P):
        tok = {"tokens": toks[:, t:t + 1], **case["extra"]}
        pos = torch.tensor(t) if form == "0-d" else torch.tensor([t])
        want, caches = model.decode_fn(params, tok, caches, t)
        got, other = model.decode_fn(params, tok, other, pos)
        assert torch.equal(got, want)
        for a, b in zip(tree_leaves(other), tree_leaves(caches)):
            assert torch.equal(a, b)


def _looped(case, temperature=0.0, draws=None, cache_dtype=None):
    """The two step bodies in loops, as ``_serve_global`` runs them on
    the CPU: (tokens (B, G), final logits)."""
    cfg = case["cfg"]
    prefill, decode, st = serve.make_global_steps(
        case["model"], case["tparams"], torch.from_numpy(case["toks"]),
        _zero_caches(cfg, P + G, cache_dtype), case["extra"], gen_len=G,
        temperature=temperature, vocab_size=cfg.vocab_size)
    for _ in range(P):
        prefill()
    if temperature > 0:
        st["noise"] = serving.noise_table(draws, P, G, B,
                                          st["logits"].shape[-1], "cpu")
    for _ in range(G):
        decode()
    assert int(st["pos"]) == P + G
    return st["out"], st["logits"]


def _eager(case, temperature=0.0, draws=None):
    """The eager token-by-token loop over ``decode_fn`` at Python-int
    positions, sampling with ``serving.sample_token``: (tokens (B, G),
    final logits)."""
    cfg, model, params = case["cfg"], case["model"], case["tparams"]
    toks = torch.from_numpy(case["toks"])
    caches = _zero_caches(cfg, P + G)
    for t in range(P):
        logits, caches = model.decode_fn(
            params, {"tokens": toks[:, t:t + 1], **case["extra"]}, caches, t)
    out = torch.empty((B, G), dtype=torch.int32)
    for i, t in enumerate(range(P, P + G)):
        out[:, i] = serving.sample_token(logits, t, temperature,
                                         cfg.vocab_size, draws)
        logits, caches = model.decode_fn(
            params, {"tokens": out[:, i:i + 1], **case["extra"]}, caches, t)
    return out, logits


def test_looped_steps_decode_the_reference_tokens(case):
    """``repro``'s global decode (``jax.jit(decode_fn)`` token by token,
    greedy as its sampler clamps into the vocabulary) from the same
    params and prompts, over f32 caches on both sides (over the bf16
    cache one bf16 step of a K or V entry moves these logits 1e-3, past
    the decode tolerance; ``tests/test_torch_encdec.py`` holds the bf16
    caches themselves at 1e-2)."""
    jcfg, jmodel = case["jcfg"], case["jmodel"]
    jcaches = jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.float32),
                           j_build_cache_specs(jcfg, B, P + G),
                           is_leaf=j_common.is_spec)
    jdec = jax.jit(jmodel.decode_fn)
    toks = jnp.asarray(case["toks"])
    for t in range(P):
        jlogits, jcaches = jdec(case["jparams"], {
            "tokens": toks[:, t:t + 1], **case["jextra"]}, jcaches, t)
    jout = []
    for t in range(P, P + G):
        nxt = jnp.minimum(jnp.argmax(jlogits[:, -1], -1),
                          jcfg.vocab_size - 1).astype(jnp.int32)
        jout.append(np.asarray(nxt))
        jlogits, jcaches = jdec(case["jparams"], {
            "tokens": nxt[:, None], **case["jextra"]}, jcaches, t)
    out, logits = _looped(case, cache_dtype="float32")
    np.testing.assert_array_equal(out.numpy(), np.stack(jout, 1))
    _close(logits, jlogits, **LOGITS_TOL)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_looped_steps_equal_the_eager_loop_bitwise(case, temperature):
    draws = (lambda: serving.TorchGumbel(7, "cpu")) if temperature else (
        lambda: None)
    got = _looped(case, temperature, draws())
    want = _eager(case, temperature, draws())
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_global_decode_loops_on_the_cpu_as_the_eager_path(case, temperature):
    """``global_decode`` (the bodies, looped on the CPU) against the eager
    token-by-token loop, bitwise; ``_serve_global`` reports no graph on
    the CPU and keeps ``repro``'s keys."""
    cfg = case["cfg"]
    draws = (lambda: serving.TorchGumbel(7, "cpu")) if temperature else (
        lambda: None)
    got = serve.global_decode(
        case["model"], case["tparams"], torch.from_numpy(case["toks"]),
        _zero_caches(cfg, P + G), case["extra"], gen_len=G,
        temperature=temperature, vocab_size=cfg.vocab_size, draws=draws())
    want = _eager(case, temperature, draws())
    assert got["prefill_graph"] is got["decode_graph"] is None
    assert torch.equal(got["tokens"], want[0])
    assert torch.equal(got["logits"], want[1])
    small = reduced(get_config(case["arch"]), remat=False)
    ours = serve._serve_global(case["arch"], small, batch=2, prompt_len=3,
                               gen_len=3, seed=0, temperature=temperature,
                               device=torch.device("cpu"))
    assert ours["prefill_graph"] is ours["decode_graph"] is None
    theirs = j_serve.serve(case["arch"], batch=2, prompt_len=3, gen_len=3,
                           n_clients=0)
    assert set(theirs) <= set(ours)
    assert len(ours["sample_output"]) == len(theirs["sample_output"])
