"""Whisper, the encoder-decoder family, in the port
(``repro_torch.models.encdec``, cross-attention in
``models/attention.py``, its ``build_model`` branch, the launchers'
global fallback and zero frames) against the JAX package's, on the CPU in
f32 with inputs from numpy seeds and params carried from ``repro``.

The config is reduced Whisper-medium (2 encoder and 2 decoder layers,
d_model 128, encoder_seq 16, frontend_dim 64) in f32. Frames are seeded
N(0, 1), so the projector's input is not zero (the launchers' zero frames
would hide a wrong projector); the leaves that initialise to zeros or
ones (the projector's bias, LayerNorm's scale and bias) are moved off
them first so that they count.

Tolerances (``repro``'s own f32 ones): attention outputs and the encoder's
output 2e-5 absolute and 1e-4 relative (f32 on both sides, summed in
other orders), the absolute part taken of the output's largest |entry|
where that is above 1 (a stacked leaf's init takes its layer axis as its
fan-in, as in ``repro``, so these random weights give attention outputs
near 100, whose entries cancel); logits 1e-4; the loss a relative
1e-5; a decode over the bf16 KV cache as far from the full forward as
``repro``'s is (its 2e-2 in ``tests/test_models_smoke.py`` holds at its
weights, not at these, whose K and V reach 30), and over an f32 cache
equal to the full forward at 1e-4; the cascaded step as
``tests/test_torch_train_step.py`` holds it."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import VFLConfig as JVFLConfig
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import cascade as j_cascade
from repro.core.adapters import from_model_config as j_from_model_config
from repro.federation import Federation as JFederation
from repro.launch import serve as j_serve
from repro.launch import train as j_train
from repro.models import attention as j_attention
from repro.models import common as j_common
from repro.models import encdec as j_encdec
from repro.models.model_api import build_cache_specs as j_build_cache_specs
from repro.models.model_api import build_model as j_build_model
from repro.optim import sgd as j_sgd
from repro_torch.checkpoint import load_tree
from repro_torch.configs import INPUT_SHAPES, VFLConfig, get_config, reduced
from repro_torch.core import cascade
from repro_torch.core.adapters import from_model_config
from repro_torch.data import lm_token_batches
from repro_torch.federation import Federation
from repro_torch.launch import serve, train
from repro_torch.models import attention, encdec
from repro_torch.models.model_api import build_cache_specs, build_model
from repro_torch.optim import sgd
from repro_torch.tree import tree_leaves, tree_map
from test_torch_support import _flat, to_numpy, to_torch, torch_threads
from test_torch_train_step import JaxStepDraws

ARCH = "whisper-medium"
F32 = dict(param_dtype="float32", dtype="float32")
ATTN_TOL = dict(atol=2e-5, rtol=1e-4)
LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
B, S, MAX_SEQ = 2, 12, 16


@pytest.fixture(autouse=True)
def _threads():
    with torch_threads(2):
        yield


def _cfgs(**kw):
    return (j_reduced(j_get_config(ARCH), **{**F32, **kw}),
            reduced(get_config(ARCH), **{**F32, **kw}))


def lively(jparams, seed):
    """``repro``'s params with every constant leaf (zeros: biases; ones:
    norm scales) moved off its constant by seeded N(0, 0.1) noise, so a
    wrong bias or scale shows."""
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a)
        if a.size and np.all(a == a.reshape(-1)[0]):
            a = (a + rng.normal(0, 0.1, a.shape)).astype(a.dtype)
        return jnp.asarray(a)
    return jax.tree.map(one, jparams)


@pytest.fixture(scope="module")
def case():
    jcfg, cfg = _cfgs()
    jmodel = j_build_model(jcfg, max_seq=MAX_SEQ)
    model = build_model(cfg, max_seq=MAX_SEQ)
    jparams = lively(j_common.materialize(jmodel.param_specs,
                                          jax.random.key(0)), 1)
    rng = np.random.default_rng(2)
    frames = rng.normal(size=(B, cfg.encoder_seq, cfg.frontend_dim)
                        ).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, model=model,
                jparams=jparams, tparams=to_torch(jparams), frames=frames,
                toks=toks)


def _close(ours, theirs, **tol):
    want = to_numpy(theirs)
    tol = dict(tol or ATTN_TOL)
    tol["atol"] *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(to_numpy(ours), want, **tol)


def _spec_tuples(tree):
    return [(tuple(s.shape), str(s.dtype), tuple(s.logical), s.init)
            for s in tree_leaves(tree)]


def _j_spec_tuples(tree):
    return [(tuple(s.shape), str(s.dtype), tuple(s.logical), s.init)
            for s in jax.tree.leaves(tree, is_leaf=j_common.is_spec)]


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


# ------------------------------------------------------------ the specs --

@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_spec_trees_match_reference(full):
    """The parameter tree (key paths, shapes, dtypes, logical axes,
    inits), the input specs of every shape and the cache specs."""
    jcfg = j_get_config(ARCH) if full else _cfgs()[0]
    cfg = get_config(ARCH) if full else _cfgs()[1]
    specs = build_model(cfg, max_seq=448).param_specs
    jspecs = j_build_model(jcfg, max_seq=448).param_specs
    assert _paths(specs) == _paths(jspecs)
    assert {"proj", "embed", "enc_pos", "pos_embed", "enc_blocks",
            "enc_final_norm", "blocks", "final_norm", "lm_head"} == set(specs)
    assert {"ln_x", "xattn"} <= set(specs["blocks"])
    assert sorted(specs["proj"]) == ["b", "w"]
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


# ------------------------------------------------------ encoder, attention

def test_encode_matches_reference(case):
    ours = encdec.encode(case["cfg"], case["tparams"],
                         torch.from_numpy(case["frames"]))
    theirs = j_encdec.encode(case["jcfg"], case["jparams"],
                             jnp.asarray(case["frames"]))
    assert ours.shape == (B, case["cfg"].encoder_seq, case["cfg"].d_model)
    assert ours.dtype == torch.float32
    _close(ours, theirs)


def _layer0(tree):
    return tree_map(lambda a: a[0], tree)


@pytest.mark.parametrize("sq,window", [(1, 0), (6, 0), (6, 3)])
def test_cross_attention_matches_reference(case, sq, window):
    """``attention_apply`` with ``kv_override``: K and V from the (B, Se,
    d) source, no RoPE, never causal (``causal`` is left at its default,
    True), at Sq = 1 (a decode step) and Sq = 6 against Se = 16; a window
    masks keys at or before query position - window."""
    cfg, jcfg = case["cfg"], case["jcfg"]
    rng = np.random.default_rng(10 + sq + window)
    x = rng.normal(size=(B, sq, cfg.d_model)).astype(np.float32)
    src = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)
                     ).astype(np.float32)
    tp = _layer0(case["tparams"]["blocks"]["xattn"])
    jp = jax.tree.map(lambda a: a[0], case["jparams"]["blocks"]["xattn"])
    ours, cache = attention.attention_apply(
        cfg, tp, torch.from_numpy(x), positions=torch.arange(sq),
        kv_override=torch.from_numpy(src), window=window)
    theirs, _ = j_attention.attention_apply(
        jcfg, jp, jnp.asarray(x), positions=jnp.arange(sq),
        kv_override=jnp.asarray(src), window=window)
    assert cache is None and ours.shape == (B, sq, cfg.d_model)
    _close(ours, theirs)
    # not causal: the first query row sees every key
    if sq > 1 and window == 0:
        first = attention.attention_apply(
            cfg, tp, torch.from_numpy(x[:, :1]), positions=torch.arange(1),
            kv_override=torch.from_numpy(src))[0]
        _close(first, ours[:, :1], atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------ the model --

def test_forward_and_loss_match_reference(case):
    """``forward_fn`` on {frames, tokens} and ``loss_fn`` (with grad on,
    the port's blocks under remat, the JAX package's jax.checkpoint)."""
    model, jmodel = case["model"], case["jmodel"]
    inp = {"tokens": torch.from_numpy(case["toks"]),
           "frames": torch.from_numpy(case["frames"])}
    jinp = {"tokens": jnp.asarray(case["toks"]),
            "frames": jnp.asarray(case["frames"])}
    ours = model.forward_fn(case["tparams"], inp)
    theirs = jmodel.forward_fn(case["jparams"], jinp)
    assert ours.shape == (B, S, case["cfg"].padded_vocab)
    _close(ours, theirs, **LOGITS_TOL)
    inp["labels"], jinp["labels"] = inp["tokens"], jinp["tokens"]
    assert case["cfg"].remat
    params = tree_map(lambda t: t.detach().requires_grad_(True),
                      case["tparams"])
    loss, aux = model.loss_fn(params, inp)
    jloss, jaux = jmodel.loss_fn(case["jparams"], jinp)
    assert aux == jaux == {}
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    loss.backward()
    g = params["proj"]["w"].grad
    assert g is not None and float(g.abs().max()) > 0


def test_decode_matches_reference_and_full_forward(case):
    """``decode_fn`` token by token over the bf16 KV cache, with each
    package's own ``enc_out``: every step's logits and the cache against
    ``repro``'s, and the last step against the teacher-forced full forward
    (``tests/test_models_smoke.py``'s check)."""
    cfg, jcfg, model, jmodel = (case["cfg"], case["jcfg"], case["model"],
                                case["jmodel"])
    toks = case["toks"]
    enc = encdec.encode(cfg, case["tparams"], torch.from_numpy(case["frames"]))
    jenc = j_encdec.encode(jcfg, case["jparams"], jnp.asarray(case["frames"]))
    caches = tree_map(lambda s: torch.zeros(s.shape, dtype=getattr(
        torch, s.dtype)), build_cache_specs(cfg, B, MAX_SEQ))
    jcaches = jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.dtype(s.dtype)),
                           j_build_cache_specs(jcfg, B, MAX_SEQ),
                           is_leaf=j_common.is_spec)
    jdec = jax.jit(jmodel.decode_fn)
    for t in range(S):
        logits, caches = model.decode_fn(
            case["tparams"], {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                              "enc_out": enc}, caches, t)
        jlogits, jcaches = jdec(
            case["jparams"], {"tokens": jnp.asarray(toks[:, t:t + 1]),
                              "enc_out": jenc}, jcaches, t)
        _close(logits, jlogits, **LOGITS_TOL)
    for name in ("k", "v"):
        _close(caches[name], jcaches[name], atol=1e-2, rtol=1e-2)
    full = model.forward_fn(case["tparams"], {
        "tokens": torch.from_numpy(toks),
        "frames": torch.from_numpy(case["frames"])})
    jfull = jmodel.forward_fn(case["jparams"], {
        "tokens": jnp.asarray(toks), "frames": jnp.asarray(case["frames"])})
    # over the bf16 cache the decode is as far from the full forward as
    # repro's is (its K and V reach about 30 here); over an f32 cache it
    # is the full forward's last row
    err = float((logits[:, 0] - full[:, -1]).abs().max())
    jerr = float(jnp.abs(jlogits[:, 0] - jfull[:, -1]).max())
    np.testing.assert_allclose(err, jerr, rtol=1e-2)
    caches = tree_map(lambda s: torch.zeros(s.shape),
                      build_cache_specs(cfg, B, MAX_SEQ))
    for t in range(S):
        logits, caches = model.decode_fn(
            case["tparams"], {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                              "enc_out": enc}, caches, t)
    _close(logits[:, 0], full[:, -1], **LOGITS_TOL)


def test_learned_positions_clip_to_the_table(case):
    """A decode step past the position table reads its last row, as the
    JAX package's ``jnp.clip`` does."""
    cfg, model, jmodel = case["cfg"], case["model"], case["jmodel"]
    enc = encdec.encode(cfg, case["tparams"], torch.from_numpy(case["frames"]))
    jenc = j_encdec.encode(case["jcfg"], case["jparams"],
                           jnp.asarray(case["frames"]))
    seq = MAX_SEQ + 4
    caches = tree_map(lambda s: torch.zeros(s.shape, dtype=getattr(
        torch, s.dtype)), build_cache_specs(cfg, B, seq))
    jcaches = jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.dtype(s.dtype)),
                           j_build_cache_specs(case["jcfg"], B, seq),
                           is_leaf=j_common.is_spec)
    tok = case["toks"][:, :1]
    ours, _ = model.decode_fn(case["tparams"], {
        "tokens": torch.from_numpy(tok), "enc_out": enc}, caches, seq - 1)
    theirs, _ = jmodel.decode_fn(case["jparams"], {
        "tokens": jnp.asarray(tok), "enc_out": jenc}, jcaches, seq - 1)
    _close(ours, theirs, **LOGITS_TOL)


# ------------------------------------------------------- the training step

def test_cascaded_step_matches_reference(case):
    """One cascaded step from the same params, batch (tokens from
    ``lm_token_batches``, seeded N(0, 1) frames) and draws (the JAX step's
    threefry directions replayed): the client partition is
    ("embed", "proj"), each ZOO-updated with the JAX package's fused-lane
    tolerance; the server's FOO update at 1e-4 of each leaf's step."""
    cfg, jcfg, model, jmodel = (case["cfg"], case["jcfg"], case["model"],
                                case["jmodel"])
    nb = next(lm_token_batches(1, cfg.vocab_size, B, S))
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    batch["frames"] = torch.from_numpy(case["frames"])
    jbatch["frames"] = jnp.asarray(case["frames"])
    _assert_cascaded_step(cfg, jcfg, model, jmodel, case["jparams"], batch,
                          jbatch)


def _assert_cascaded_step(cfg, jcfg, model, jmodel, jparams, batch, jbatch):
    """One cascaded step of each package from ``jparams`` on the same
    batch and draws. The losses at 1e-5; the client's ZOO update at the
    fused-lane tolerance of ``tests/test_torch_train_step.py``. The
    server's FOO update is held as ``chip_smoke.py`` holds the card's
    step to the CPU's: this family's random-init gradients sit about 1e-3
    to 1e-2 of a leaf's largest entry from their f64 values in either
    package (the residual stream reaches 100 before each LayerNorm), so
    each leaf's step is held at 1e-4 of its largest entry plus one f32
    rounding of its largest param plus twice the port's own f32 error
    there (its step against the same step from f64 params), and the
    server's gradient norm at 1e-4 plus twice that error's share."""
    vk = dict(mu=1e-2, lr_server=0.05, lr_client=0.02, zoo_dist="normal")
    jstep = j_cascade.make_step_for_method(
        "cascaded", jmodel.loss_fn, jmodel.client_keys, JVFLConfig(**vk),
        j_sgd(0.05), vocab=jcfg.padded_vocab)
    step = cascade.make_step_for_method(
        "cascaded", model.loss_fn, model.client_keys, VFLConfig(**vk),
        sgd(0.05), vocab=cfg.padded_vocab)
    key = jax.random.fold_in(jax.random.key(5), 3)
    jp, _, jo = jax.jit(jstep)(jparams, j_sgd(0.05).init(jparams), jbatch,
                               key)
    outs = {}
    for name, cast in (("f32", lambda t: t),
                       ("f64", lambda t: t.double()
                        if t.is_floating_point() else t)):
        params = tree_map(cast, to_torch(jparams))
        outs[name] = step(params, sgd(0.05).init(params),
                          tree_map(cast, batch), 3,
                          JaxStepDraws(5, "cascaded"))
    (tp, _, to), (rp, _, ro) = outs["f32"], outs["f64"]
    np.testing.assert_allclose(float(to.loss), float(jo.loss), rtol=1e-5)
    np.testing.assert_allclose(float(to.loss_perturbed),
                               float(jo.loss_perturbed), rtol=1e-5)
    np.testing.assert_allclose(float(to.grad_client_norm),
                               float(jo.grad_client_norm), rtol=5e-3)
    own = abs(float(to.grad_server_norm) / float(ro.grad_server_norm) - 1)
    np.testing.assert_allclose(float(to.grad_server_norm),
                               float(jo.grad_server_norm),
                               rtol=1e-4 + 2 * own)
    p0, got, want, ref = _flat(jparams), _flat(tp), _flat(jp), _flat(rp)
    assert sorted(got) == sorted(want)
    client = tuple(f"{k}/" for k in model.client_keys)
    moved = set()
    for k in want:
        zoo = k.startswith(client)
        step_ = np.abs(want[k] - p0[k]).max()
        ulp = np.spacing(np.abs(p0[k]).max().astype(np.float32))
        if zoo:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       rtol=2e-3, atol=5e-4)
            atol = 1e-2 * step_ + ulp
        else:
            atol = (1e-4 * step_ + ulp
                    + 2 * np.abs(got[k] - ref[k]).max())
        np.testing.assert_allclose(got[k] - p0[k], want[k] - p0[k], rtol=0,
                                   atol=atol, err_msg=k)
        if step_ > 0:
            moved.add(k.split("/")[0])
    # the projector is perturbed whole and moves with the embedding
    assert {"embed", "proj"} <= moved


# ----------------------------------------------------- the serve driver --

@pytest.mark.parametrize("n_clients,continuous", [(2, False), (2, True),
                                                  (0, False)])
def test_serve_falls_back_to_the_global_path(n_clients, continuous):
    """``launch.serve`` sends the family to the global path, as
    ``repro``'s does: with n_clients >= 1 (split or continuous) its result
    carries ``repro``'s ``fallback`` note; with 0 it takes the path
    directly. The encoder runs once, before the prefill."""
    kw = dict(batch=2, prompt_len=3, gen_len=3, n_clients=n_clients,
              continuous=continuous)
    ours = serve.serve(ARCH, device="cpu", **kw)
    theirs = j_serve.serve(ARCH, **kw)
    assert ours["mode"] == theirs["mode"] == "global"
    assert ours.get("fallback") == theirs.get("fallback")
    assert ("fallback" in ours) == bool(n_clients)
    assert set(theirs) <= set(ours)
    assert len(ours["sample_output"]) == len(theirs["sample_output"]) == 3
    assert ours["encode_s"] > 0 and np.isfinite(ours["final_logits_absmax"])


# ------------------------------------------------------ the split plane --

def test_split_plane_refuses_the_family_as_the_reference_does(case):
    """``from_model_config`` raises ``repro``'s ``ValueError`` with its
    message, and so do the session's split-plane entry points
    (``decode``, ``serve``, ``run``, ``run_population``), the population
    driver and ``--engine population``."""
    cfg, jcfg = case["cfg"], case["jcfg"]
    with pytest.raises(ValueError) as theirs:
        j_from_model_config(jcfg, n_clients=2, seq_len=MAX_SEQ)
    msg = str(theirs.value)
    assert "modality frontend" in msg
    with pytest.raises(ValueError) as ours:
        from_model_config(cfg, n_clients=2, seq_len=MAX_SEQ)
    assert str(ours.value) == msg
    fed = Federation.build(cfg, n_clients=2, seq_len=MAX_SEQ, device="cpu")
    jfed = JFederation.build(jcfg, n_clients=2, seq_len=MAX_SEQ)
    toks = case["toks"][:, :4]
    y = np.zeros((B, 4), np.int64)
    x_parts = np.zeros((2, B, 2), np.int64)
    calls = [lambda: fed.decode(case["tparams"], torch.from_numpy(toks),
                                gen_len=2),
             lambda: fed.serve(case["tparams"]),
             lambda: fed.run(case["tparams"], x_parts, y),
             lambda: fed.run_population(case["tparams"], x_parts, y),
             lambda: fed.init_params(torch.Generator().manual_seed(0)),
             lambda: train.train_population(ARCH, steps=2, device="cpu"),
             lambda: train.main(["--engine", "population", "--arch", ARCH,
                                 "--device", "cpu", "--steps", "2"])]
    for call in calls:
        with pytest.raises(ValueError) as ours:
            call()
        assert str(ours.value) == msg
    with pytest.raises(ValueError) as theirs:
        jfed.decode(case["jparams"], jnp.asarray(toks), gen_len=2)
    assert str(theirs.value) == msg


# ------------------------------------------------------ the train driver --

def test_train_driver_matches_reference_and_resumes_bitwise(tmp_path):
    """``launch.train`` on reduced Whisper (zero frames in every batch,
    as ``repro``'s driver feeds them) against ``repro``'s driver at the
    same settings: the same result keys, wire bytes a round, no gradient
    on the wire and the same normalised client lr (the client partition
    counts the projector); then 2 steps saved and resumed to 4 equal 4
    without a break, bitwise."""
    kw = dict(batch=2, seq=8, log_every=1000)
    res = train.train(ARCH, steps=2, device="cpu", **kw)
    jres = j_train.train(ARCH, steps=2, **kw)
    assert set(res) - {"device"} == set(jres)
    assert res["wire_bytes_per_round"] == jres["wire_bytes_per_round"]
    assert res["wire_has_gradients"] is jres["wire_has_gradients"] is False
    assert np.isfinite([res["loss_first"], res["loss_last"]]).all()
    cfg, jcfg = reduced(get_config(ARCH)), j_reduced(j_get_config(ARCH))
    fed = Federation.build(cfg, seq_len=8, device="cpu")
    jfed = JFederation.build(jcfg, seq_len=8)
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
