"""InternVL2, the multimodal family, in the port (the vision prefix in
``repro_torch.models.transformer``: ``proj`` in ``backbone_specs``,
[proj(patch_embeds); embed(tokens)] in ``embed_inputs``, the vision
positions in ``forward`` and dropped from ``lm_loss``; the launchers'
global fallback and zero patch embeddings) against the JAX package's, on
the CPU in f32 with inputs from numpy seeds and params carried from
``repro``.

The config is reduced InternVL2-26B (2 layers, d_model 128, 4 query and 2
KV heads, 4 vision tokens, frontend_dim 64) in f32. Patch embeddings are
seeded N(0, 1), so the projector's input is not zero (the launchers' zero
patch embeddings would hide a wrong projector); the constant leaves (the
projector's bias, the RMSNorm scales) are moved off their constants
first. Tolerances as in ``tests/test_torch_encdec.py``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.adapters import from_model_config as j_from_model_config
from repro.federation import Federation as JFederation
from repro.launch import serve as j_serve
from repro.launch import train as j_train
from repro.models import attention as j_attention
from repro.models import common as j_common
from repro.models import transformer as j_transformer
from repro.models.model_api import build_cache_specs as j_build_cache_specs
from repro.models.model_api import build_model as j_build_model
from repro_torch.checkpoint import load_tree
from repro_torch.configs import INPUT_SHAPES, get_config, reduced
from repro_torch.core.adapters import from_model_config
from repro_torch.data import lm_token_batches
from repro_torch.federation import Federation
from repro_torch.launch import serve, train
from repro_torch.models import attention, transformer
from repro_torch.models.model_api import build_cache_specs, build_model
from repro_torch.tree import tree_map
from test_torch_encdec import (ATTN_TOL, LOGITS_TOL, _assert_cascaded_step,
                               _close, _j_spec_tuples, _paths, _spec_tuples,
                               lively)
from test_torch_support import _flat, to_torch, torch_threads

ARCH = "internvl2-26b"
F32 = dict(param_dtype="float32", dtype="float32")
B, S, MAX_SEQ = 2, 10, 16


@pytest.fixture(autouse=True)
def _threads():
    with torch_threads(2):
        yield


def _cfgs(**kw):
    return (j_reduced(j_get_config(ARCH), **{**F32, **kw}),
            reduced(get_config(ARCH), **{**F32, **kw}))


@pytest.fixture(scope="module")
def case():
    jcfg, cfg = _cfgs()
    jmodel = j_build_model(jcfg, max_seq=MAX_SEQ)
    model = build_model(cfg, max_seq=MAX_SEQ)
    jparams = lively(j_common.materialize(jmodel.param_specs,
                                          jax.random.key(0)), 1)
    rng = np.random.default_rng(3)
    patches = rng.normal(size=(B, cfg.n_vision_tokens, cfg.frontend_dim)
                         ).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, model=model,
                jparams=jparams, tparams=to_torch(jparams), patches=patches,
                toks=toks)


def _inputs(case, vision=True, labels=False):
    inp = {"tokens": case["toks"]}
    if vision:
        inp["patch_embeds"] = case["patches"]
    if labels:
        inp["labels"] = case["toks"]
    return ({k: torch.from_numpy(v) for k, v in inp.items()},
            {k: jnp.asarray(v) for k, v in inp.items()})


# ------------------------------------------------------------ the specs --

@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_spec_trees_match_reference(full):
    """The parameter tree with the projector (key paths, shapes, dtypes,
    logical axes, inits), the input specs of every shape (the text takes S
    - n_vision_tokens positions) and the cache specs."""
    jcfg = j_get_config(ARCH) if full else _cfgs()[0]
    cfg = get_config(ARCH) if full else _cfgs()[1]
    specs = build_model(cfg, max_seq=MAX_SEQ).param_specs
    jspecs = j_build_model(jcfg, max_seq=MAX_SEQ).param_specs
    assert _paths(specs) == _paths(jspecs)
    assert sorted(specs["proj"]) == ["b", "w"]
    assert specs["proj"]["w"].shape == (cfg.frontend_dim, cfg.d_model)
    assert _spec_tuples(specs) == _j_spec_tuples(jspecs)
    model, jmodel = build_model(cfg), j_build_model(jcfg)
    assert model.client_keys == jmodel.client_keys == ("embed", "proj")
    for name in INPUT_SHAPES:
        got = model.input_specs(INPUT_SHAPES[name])
        want = jmodel.input_specs(J_INPUT_SHAPES[name])
        assert {k: (v.shape, v.dtype, v.logical) for k, v in got.items()} \
            == {k: (v.shape, v.dtype, v.logical) for k, v in want.items()}
    assert (_spec_tuples(build_cache_specs(cfg, 2, 12))
            == _j_spec_tuples(j_build_cache_specs(jcfg, 2, 12)))


# ---------------------------------------------------- the vision prefix --

def test_embed_inputs_matches_reference(case):
    """[proj(patch_embeds); embed(tokens)]: the client's part of the
    cascade partition."""
    inp, jinp = _inputs(case)
    n = case["cfg"].n_vision_tokens + S
    ours = transformer.embed_inputs(case["cfg"], case["tparams"], inp,
                                    positions=torch.arange(n))
    theirs = j_transformer.embed_inputs(case["jcfg"], case["jparams"], jinp,
                                        positions=jnp.arange(n))
    assert ours.shape == (B, n, case["cfg"].d_model)
    _close(ours, theirs)


@pytest.mark.parametrize("vision", [True, False], ids=["vision", "text"])
def test_forward_matches_reference(case, vision):
    """``forward_fn`` with the vision prefix (S counts its positions,
    RoPE numbers [vision; text] from 0) and without it (text only)."""
    inp, jinp = _inputs(case, vision)
    ours = case["model"].forward_fn(case["tparams"], inp)
    theirs = case["jmodel"].forward_fn(case["jparams"], jinp)
    n = S + (case["cfg"].n_vision_tokens if vision else 0)
    assert ours.shape == (B, n, case["cfg"].padded_vocab)
    _close(ours, theirs, **LOGITS_TOL)


def test_loss_matches_reference(case):
    """``loss_fn`` predicts the text tokens only (the vision positions'
    logits are dropped); with grad on, the port's blocks under remat."""
    inp, jinp = _inputs(case, labels=True)
    params = tree_map(lambda t: t.detach().requires_grad_(True),
                      case["tparams"])
    loss, aux = case["model"].loss_fn(params, inp)
    jloss, jaux = case["jmodel"].loss_fn(case["jparams"], jinp)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(aux["aux"]) == float(jaux["aux"]) == 0.0
    loss.backward()
    assert float(params["proj"]["w"].grad.abs().max()) > 0


def test_attention_kv_override_skips_rope(case):
    """``attention_apply`` with ``kv_override`` on this RoPE config (GQA
    4:2): K and V from the source, no RoPE on either side, not causal."""
    cfg, jcfg = case["cfg"], case["jcfg"]
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, 3, cfg.d_model)).astype(np.float32)
    src = rng.normal(size=(B, 9, cfg.d_model)).astype(np.float32)
    tp = tree_map(lambda a: a[1], case["tparams"]["blocks"]["attn"])
    jp = jax.tree.map(lambda a: a[1], case["jparams"]["blocks"]["attn"])
    pos = np.array([5, 6, 7])
    ours, _ = attention.attention_apply(
        cfg, tp, torch.from_numpy(x), positions=torch.from_numpy(pos),
        kv_override=torch.from_numpy(src))
    theirs, _ = j_attention.attention_apply(
        jcfg, jp, jnp.asarray(x), positions=jnp.asarray(pos),
        kv_override=jnp.asarray(src))
    _close(ours, theirs, **ATTN_TOL)
    # the positions do not enter a cross call
    other, _ = attention.attention_apply(
        cfg, tp, torch.from_numpy(x), positions=torch.arange(3),
        kv_override=torch.from_numpy(src))
    assert torch.equal(other, ours)


def test_decode_is_text_only_and_matches_reference(case):
    """``decode_fn`` token by token from position 0 (the VLM decode path
    is text only): every step's logits against ``repro``'s over the bf16
    cache, and over an f32 cache the text-only full forward's last row."""
    cfg, jcfg, model, jmodel = (case["cfg"], case["jcfg"], case["model"],
                                case["jmodel"])
    toks = case["toks"]
    caches = tree_map(lambda s: torch.zeros(s.shape, dtype=getattr(
        torch, s.dtype)), build_cache_specs(cfg, B, MAX_SEQ))
    jcaches = jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.dtype(s.dtype)),
                           j_build_cache_specs(jcfg, B, MAX_SEQ),
                           is_leaf=j_common.is_spec)
    jdec = jax.jit(jmodel.decode_fn)
    for t in range(S):
        logits, caches = model.decode_fn(
            case["tparams"], {"tokens": torch.from_numpy(toks[:, t:t + 1])},
            caches, t)
        jlogits, jcaches = jdec(
            case["jparams"], {"tokens": jnp.asarray(toks[:, t:t + 1])},
            jcaches, t)
        _close(logits, jlogits, **LOGITS_TOL)
    full = model.forward_fn(case["tparams"], {"tokens": torch.from_numpy(toks)})
    caches = tree_map(lambda s: torch.zeros(s.shape),
                      build_cache_specs(cfg, B, MAX_SEQ))
    for t in range(S):
        logits, caches = model.decode_fn(
            case["tparams"], {"tokens": torch.from_numpy(toks[:, t:t + 1])},
            caches, t)
    _close(logits[:, 0], full[:, -1], **LOGITS_TOL)


# ------------------------------------------------------- the training step

def test_cascaded_step_matches_reference(case):
    """One cascaded step from the same params, batch (tokens from
    ``lm_token_batches``, seeded N(0, 1) patch embeddings) and draws: the
    client partition ("embed", "proj") ZOO-updated, the server's FOO
    update (``test_torch_encdec.py``'s gate)."""
    cfg = case["cfg"]
    nb = next(lm_token_batches(1, cfg.vocab_size, B, S))
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    batch["patch_embeds"] = torch.from_numpy(case["patches"])
    jbatch["patch_embeds"] = jnp.asarray(case["patches"])
    _assert_cascaded_step(cfg, case["jcfg"], case["model"], case["jmodel"],
                          case["jparams"], batch, jbatch)


# ----------------------------------------------------- the serve driver --

@pytest.mark.parametrize("n_clients,continuous", [(2, False), (2, True),
                                                  (0, False)])
def test_serve_falls_back_to_the_global_path(n_clients, continuous):
    """``launch.serve`` serves the family global, text only, as
    ``repro``'s does, with its ``fallback`` note where n_clients >= 1."""
    kw = dict(batch=2, prompt_len=3, gen_len=3, n_clients=n_clients,
              continuous=continuous)
    ours = serve.serve(ARCH, device="cpu", **kw)
    theirs = j_serve.serve(ARCH, **kw)
    assert ours["mode"] == theirs["mode"] == "global"
    assert ours.get("fallback") == theirs.get("fallback")
    assert ("fallback" in ours) == bool(n_clients)
    assert set(theirs) <= set(ours) and "encode_s" not in ours
    assert len(ours["sample_output"]) == len(theirs["sample_output"]) == 3


# ------------------------------------------------------ the split plane --

def test_split_plane_refuses_the_family_as_the_reference_does(case):
    """``from_model_config`` raises ``repro``'s ``ValueError`` with its
    message, and so do the session's split-plane entry points, the
    population driver and ``--engine population``."""
    cfg, jcfg = case["cfg"], case["jcfg"]
    with pytest.raises(ValueError) as theirs:
        j_from_model_config(jcfg, n_clients=2, seq_len=MAX_SEQ)
    msg = str(theirs.value)
    assert "family='vlm'" in msg
    with pytest.raises(ValueError) as ours:
        from_model_config(cfg, n_clients=2, seq_len=MAX_SEQ)
    assert str(ours.value) == msg
    fed = Federation.build(cfg, n_clients=2, seq_len=MAX_SEQ, device="cpu")
    y = np.zeros((B, 4), np.int64)
    x_parts = np.zeros((2, B, 2), np.int64)
    calls = [lambda: fed.decode(case["tparams"],
                                torch.from_numpy(case["toks"][:, :4]),
                                gen_len=2),
             lambda: fed.serve(case["tparams"]),
             lambda: fed.run(case["tparams"], x_parts, y),
             lambda: fed.run_population(case["tparams"], x_parts, y),
             lambda: train.train_population(ARCH, steps=2, device="cpu"),
             lambda: train.main(["--engine", "population", "--arch", ARCH,
                                 "--device", "cpu", "--steps", "2"])]
    for call in calls:
        with pytest.raises(ValueError) as ours:
            call()
        assert str(ours.value) == msg
    jfed = JFederation.build(jcfg, n_clients=2, seq_len=MAX_SEQ)
    with pytest.raises(ValueError) as theirs:
        jfed.serve(case["jparams"])
    assert str(theirs.value) == msg


# ------------------------------------------------------ the train driver --

def test_train_driver_matches_reference_and_resumes_bitwise(tmp_path):
    """``launch.train`` on reduced InternVL2 (zero patch embeddings in
    every batch, as ``repro``'s driver feeds them) against ``repro``'s
    driver: the same result keys, wire bytes a round, no gradient on the
    wire, the same normalised client lr; 2 steps saved and resumed to 4
    equal 4 without a break, bitwise; the clients' directory holds the
    embedding and the projector."""
    kw = dict(batch=2, seq=8, log_every=1000)
    res = train.train(ARCH, steps=2, device="cpu", **kw)
    jres = j_train.train(ARCH, steps=2, **kw)
    assert set(res) - {"device"} == set(jres)
    assert res["wire_bytes_per_round"] == jres["wire_bytes_per_round"]
    assert res["wire_has_gradients"] is jres["wire_has_gradients"] is False
    assert np.isfinite([res["loss_first"], res["loss_last"]]).all()
    fed = Federation.build(reduced(get_config(ARCH)), seq_len=8,
                           device="cpu")
    jfed = JFederation.build(j_reduced(j_get_config(ARCH)), seq_len=8)
    np.testing.assert_allclose(train._normalized_lr_client(fed, 0.01),
                               j_train._normalized_lr_client(jfed, 0.01),
                               rtol=1e-12)
    a, h, r = (str(tmp_path / n) for n in ("straight", "half", "resumed"))
    train.train(ARCH, steps=4, checkpoint_path=a, device="cpu", **kw)
    train.train(ARCH, steps=2, checkpoint_path=h, device="cpu", **kw)
    train.train(steps=4, resume=h, checkpoint_path=r, log_every=1000,
                device="cpu")
    for party in ("server", "clients"):
        ta, _, _ = load_tree(os.path.join(a, party))
        tb, _, _ = load_tree(os.path.join(r, party))
        fa, fb = _flat(ta), _flat(tb)
        assert sorted(fa) == sorted(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k],
                                          err_msg=f"{party}/{k}")
    clients, _, _ = load_tree(os.path.join(r, "clients"))
    assert sorted(clients) == ["embed", "proj"]
