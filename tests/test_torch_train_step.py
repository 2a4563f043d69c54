"""The LM training step of the port (``repro_torch.core.cascade`` over
``transformer.lm_loss``) against the JAX package's, on the CPU.

Both packages start from the same params (drawn by ``repro``), the same
batch (``lm_token_batches``) and the same draws: the port's draw source
replays the threefry directions and DP noise the JAX step makes from its
key. Losses are held at 1e-5. The FOO gradients are exact backprop in
both, in f32: against an f64 run of the port's loss, each package's
gradient sits up to 5e-5 of the leaf's largest entry off (reduced phi3,
measured), and entries that cancel differ far more than 1e-5 relative.
So a FOO gradient, and a FOO-updated leaf's step, is held to 1e-4 of the
leaf's largest entry, and gradient norms at 1e-4. The ZOO updates are held
at ``repro``'s own fused-vs-unrolled tolerance (rtol 2e-3, atol 5e-4 on
params, rtol 5e-3 on the gradient norm; ``tests/test_zoo_vectorized.py``)
and, as the engine harness holds them, each leaf's step to 1% of the
step's largest entry.
The ZOO estimator divides each lane loss's f32 rounding (~4e-7 at a loss
of 6) by μ and multiplies it by φ, so the ZOO cases take normal directions
(φ = 1) at μ = 1e-2, where ĥ − h stands well above that rounding; the
sphere default (φ = d = 65536 here) is held with the active-row mask and
through the DP channel, whose noise dominates ĥ − h."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import VFLConfig as JVFLConfig
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import cascade as j_cascade
from repro.core.privacy import GaussianLossChannel as JChannel
from repro.federation.transport import NOISE_SALT
from repro.federation.transport import Transport as JTransport
from repro.models import common as j_common
from repro.models import model_api as j_model_api
from repro.models import transformer as j_transformer
from repro.optim import sgd as j_sgd
from repro_torch.configs import VFLConfig, get_config, reduced
from repro_torch.core import cascade
from repro_torch.core.methods import canonical_method
from repro_torch.core.privacy import GaussianLossChannel
from repro_torch.data import lm_token_batches
from repro_torch.federation.transport import Transport
from repro_torch.models import model_api, transformer
from repro_torch.optim import sgd
from repro_torch.tree import tree_map
from test_torch_support import (_flat, raw_normals, to_numpy, to_torch,
                                torch_threads, tree_allclose)

B, S = 2, 16
ZOO_METHODS = ("zoo-vfl", "syn-zoo")
PHI3 = "phi3-mini-3.8b"
ZAMBA2 = "zamba2-2.7b"
RWKV = "rwkv6-7b"
QWEN3 = "qwen3-moe-30b-a3b"
DEEPSEEK = "deepseek-v3-671b"


def _cfgs(arch):
    kw = dict(param_dtype="float32")
    if arch == ZAMBA2:
        kw["n_layers"] = 4
    if arch == DEEPSEEK:
        # MLA at a q/k head dim (32 + 16) unlike its v head dim (32)
        kw.update(qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
    return (j_reduced(j_get_config(arch), **kw),
            reduced(get_config(arch), **kw))


def _setup(arch, seed=0):
    jcfg, cfg = _cfgs(arch)
    jmodel = j_model_api.build_model(jcfg, max_seq=S)
    model = model_api.build_model(cfg, max_seq=S)
    jparams = j_common.materialize(jmodel.param_specs, jax.random.key(seed))
    nb = next(lm_token_batches(seed + 1, cfg.vocab_size, B, S))
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    return jcfg, cfg, jmodel, model, jparams, jbatch, batch


class JaxStepDraws:
    """The port's step draw source answered with the JAX step's own
    draws from ``fold_in(key(seed), t)``: the cascaded step's directions
    on that key (``sample_directions``: split into q, then into the
    leaves), the full-ZOO step's client and server directions on its
    ``split`` halves, and the DP noise on ``fold_in(key, NOISE_SALT)``."""

    def __init__(self, seed, method):
        self.key = jax.random.key(seed)
        self.full_zoo = canonical_method(method) in ZOO_METHODS

    def _k(self, t):
        return jax.random.fold_in(self.key, t)

    def client_directions(self, t, template, n_rows, q):
        k = self._k(t)
        if self.full_zoo:
            k = jax.random.split(k)[0]
        return tree_map(lambda r: r[None], raw_normals(k, template, q))

    def server_directions(self, t, template, q):
        return raw_normals(jax.random.split(self._k(t))[1], template, q)

    def noise(self, t, n_rows, n):
        key = jax.random.fold_in(self._k(t), NOISE_SALT)
        return torch.from_numpy(np.array(
            jax.random.normal(key, (n,), jnp.float32)))[None]


@pytest.fixture(autouse=True)
def _threads():
    with torch_threads(2):
        yield


# ---------------------------------------------------------------- loss ---

@pytest.mark.parametrize("arch", [PHI3, ZAMBA2])
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_lm_loss_matches_reference(arch, grad):
    """lm_loss on reduced f32 configs; with grad on, the port's forward
    runs each block under remat (torch.utils.checkpoint), the JAX
    package's jax.checkpoint."""
    jcfg, cfg, jmodel, model, jparams, jbatch, batch = _setup(arch)
    assert cfg.remat
    want, _ = j_transformer.lm_loss(jcfg, jparams, jbatch)
    params = tree_map(lambda t: t.requires_grad_(grad), to_torch(jparams))
    with torch.set_grad_enabled(grad):
        got, aux = transformer.lm_loss(cfg, params, batch)
    assert got.requires_grad == grad
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert float(aux["aux"]) == 0.0
    got_fn, _ = model.loss_fn(to_torch(jparams), batch)
    np.testing.assert_allclose(float(got_fn), float(want), rtol=1e-5)


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 5, 40)).astype(np.float32) * 4
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    got = transformer.softmax_xent(torch.from_numpy(logits),
                                   torch.from_numpy(labels), 40)
    want = j_transformer.softmax_xent(jnp.asarray(logits),
                                      jnp.asarray(labels), 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", [PHI3, ZAMBA2, RWKV, QWEN3, DEEPSEEK])
def test_lm_loss_gradient_matches_reference(arch):
    """The server's FOO gradient (Eq. 4): autograd of the port's lm_loss
    (remat on) against jax.grad of the reference's, every leaf; for
    qwen3-moe through the capacity dispatch with its aux loss; for
    deepseek-v3 through MLA, the dense and MoE stacks and the MTP head."""
    jcfg, cfg, jmodel, model, jparams, jbatch, batch = _setup(arch)
    want = jax.grad(lambda p: j_transformer.lm_loss(jcfg, p, jbatch)[0])(
        jparams)
    params = tree_map(lambda t: t.requires_grad_(True), to_torch(jparams))
    loss, _ = transformer.lm_loss(cfg, params, batch)
    loss.backward()
    got, want = _flat(tree_map(lambda t: t.grad, params)), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, err_msg=k,
                                   atol=1e-4 * np.abs(want[k]).max())


# ---------------------------------------------------------------- step ---

def _vfl_kwargs(method, fused, dist, mu, **kw):
    out = dict(mu=mu, lr_server=0.05, lr_client=0.02, zoo_dist=dist, **kw)
    if canonical_method(method) == "cascaded":
        out["fused_dual"] = fused
    else:
        out["zoo_unrolled_oracle"] = not fused
    return out


def _run_step(method, *, fused=True, dist="normal", mu=1e-2, q=1,
              noise=None, arch=PHI3, t=3, **vkw):
    jcfg, cfg, jmodel, model, jparams, jbatch, batch = _setup(arch)
    vk = _vfl_kwargs(method, fused, dist, mu, zoo_queries=q, **vkw)
    jvfl, vfl = JVFLConfig(**vk), VFLConfig(**vk)
    jopt, opt = j_sgd(0.05), sgd(0.05)
    jtr = None if noise is None else JTransport(method,
                                                noise=JChannel(**noise))
    tr = None if noise is None else Transport(
        method, noise=GaussianLossChannel(**noise))
    jstep = j_cascade.make_step_for_method(
        method, jmodel.loss_fn, jmodel.client_keys, jvfl, jopt,
        vocab=jcfg.padded_vocab, transport=jtr)
    step = cascade.make_step_for_method(
        method, model.loss_fn, model.client_keys, vfl, opt,
        vocab=cfg.padded_vocab, transport=tr)
    key = jax.random.fold_in(jax.random.key(5), t)
    jp, js, jo = jax.jit(jstep)(jparams, jopt.init(jparams), jbatch, key)
    params = to_torch(jparams)
    tp, ts, to = step(params, opt.init(params), batch, t,
                      JaxStepDraws(5, method))
    return dict(jparams=jparams, jp=jp, js=js, jo=jo, tp=tp, ts=ts, to=to,
                params=params)


ZOO_TOL = dict(rtol=2e-3, atol=5e-4)


def _assert_step(r, zoo_parts):
    jo, to = r["jo"], r["to"]
    np.testing.assert_allclose(float(to.loss), float(jo.loss), rtol=1e-5)
    np.testing.assert_allclose(float(to.loss_perturbed),
                               float(jo.loss_perturbed), rtol=1e-5)
    for part in ("client", "server"):
        name = f"grad_{part}_norm"
        tol = 5e-3 if part in zoo_parts else 1e-4
        np.testing.assert_allclose(float(getattr(to, name)),
                                   float(getattr(jo, name)), rtol=tol,
                                   err_msg=name)
    assert int(r["ts"]["step"]) == int(r["js"]["step"]) == 1
    p0, got, want = _flat(r["jparams"]), _flat(r["tp"]), _flat(r["jp"])
    assert sorted(got) == sorted(want)
    for k in want:
        zoo = ("client" if k.startswith("embed/") else "server") in zoo_parts
        if zoo:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **ZOO_TOL)
        # the step, and one f32 rounding of the largest param it lands on
        step = np.abs(want[k] - p0[k]).max()
        ulp = np.spacing(np.abs(p0[k]).max().astype(np.float32))
        np.testing.assert_allclose(
            got[k] - p0[k], want[k] - p0[k], rtol=0, err_msg=k,
            atol=(1e-2 if zoo else 1e-4) * step + ulp)
    # the inputs are left as they were (the step is functional)
    tree_allclose(r["params"], r["jparams"], atol=0)


@pytest.mark.parametrize("method,fused", [
    ("cascaded", True), ("cascaded", False), ("vafl", True),
    ("split", True), ("zoo-vfl", True), ("zoo-vfl", False),
    ("syn-zoo", True), ("syn-zoo", False)])
def test_step_matches_reference(method, fused):
    """One step of each of the five methods (the cascaded step fused and
    as the unrolled oracle; the full-ZOO steps stacked and unrolled)."""
    zoo_parts = {"cascaded": ("client",), "vafl": (), "split": (),
                 "zoo-vfl": ("client", "server"),
                 "syn-zoo": ("client", "server")}[method]
    _assert_step(_run_step(method, fused=fused), zoo_parts)


@pytest.mark.parametrize("q", [1, 3])
def test_cascaded_step_queries_match_reference(q):
    _assert_step(_run_step("cascaded", q=q), ("client",))


def test_cascaded_step_hybrid_matches_reference():
    """The hybrid family (reduced zamba2, 4 layers): the server gradient
    runs through the Mamba2 trunk's chunked SSD form."""
    _assert_step(_run_step("cascaded", arch=ZAMBA2), ("client",))


@pytest.mark.parametrize("arch", [RWKV, QWEN3, DEEPSEEK])
def test_cascaded_step_rwkv_and_moe_match_reference(arch):
    """One cascaded step of the ssm family (reduced rwkv6: the server
    gradient through the chunked wkv6 form) and of the MoE family
    (reduced qwen3-moe: through the capacity dispatch, the aux loss in
    the server's loss; reduced deepseek-v3: MLA, a dense then an MoE
    layer, the MTP head in the global loss)."""
    _assert_step(_run_step("cascaded", arch=arch), ("client",))


@pytest.mark.parametrize("q", [1, 2])
def test_sphere_step_with_active_rows_matches_reference(q):
    """The sphere default (φ = d_eff) on the rows the batch touches (the
    full-ZOO server's sphere over all its params, φ = 4e5 here, is beyond
    what f32 lane losses can compare)."""
    r = _run_step("cascaded", dist="sphere", mu=5e-2, q=q,
                  active_rows_only=True)
    _assert_step(r, ("client",))
    # rows the batch does not touch are not perturbed, so not updated
    tokens = np.unique(np.asarray(next(lm_token_batches(
        1, 512, B, S))["tokens"]))
    delta = to_numpy(r["tp"]["embed"]["table"]) - to_numpy(
        r["params"]["embed"]["table"])
    untouched = np.setdiff1d(np.arange(delta.shape[0]), tokens)
    assert np.all(delta[untouched] == 0) and np.any(delta[tokens] != 0)


def test_dp_downlink_step_matches_reference():
    """The cascaded step through a DP transport: the client's Eq. 3 uses
    the clipped + noised downlink losses, with the reference's noise
    injected; the server keeps the exact loss (sphere, the default)."""
    noise = dict(clip=10.0, epsilon=1.0, delta=1e-5)
    r = _run_step("cascaded", dist="sphere", mu=1e-3, noise=noise)
    _assert_step(r, ("client",))
    with pytest.raises(ValueError, match="fused lane"):
        cascade.make_cascaded_step(
            lambda p, b: (0.0, {}), ("embed",),
            VFLConfig(fused_dual=False), sgd(0.1),
            transport=Transport("cascaded",
                                noise=GaussianLossChannel(**noise)))
    with pytest.raises(NotImplementedError, match="Federation.run"):
        cascade.make_step_for_method(
            "zoo-vfl", lambda p, b: (0.0, {}), ("embed",), VFLConfig(),
            sgd(0.1), transport=Transport(
                "zoo-vfl", noise=GaussianLossChannel(**noise)))


def test_active_rows_masks_equal():
    jcfg, cfg, jmodel, model, jparams, jbatch, batch = _setup(PHI3)
    jclient = {"embed": jparams["embed"]}
    client = {"embed": to_torch(jclient)["embed"]}
    for active in (False, True):
        jv, v = JVFLConfig(active_rows_only=active), VFLConfig(
            active_rows_only=active)
        want = j_cascade._maybe_row_mask(jv, jclient, jbatch,
                                         jcfg.padded_vocab)
        got = cascade._maybe_row_mask(v, client, batch, cfg.padded_vocab)
        if not active:
            assert want is None and got is None
            continue
        tree_allclose(got, want, atol=0)
        assert 0 < float(got["embed"]["table"].sum()) < cfg.padded_vocab


def test_step_factory_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="unknown method"):
        cascade.make_step_for_method("sgd-vfl", lambda p, b: (0.0, {}),
                                     ("embed",), VFLConfig(), sgd(0.1))
    with pytest.raises(ValueError, match="does not match"):
        cascade.make_step_for_method("vafl", lambda p, b: (0.0, {}),
                                     ("embed",), VFLConfig(), sgd(0.1),
                                     transport=Transport("cascaded"))


@pytest.mark.parametrize("arch", [PHI3, ZAMBA2])
def test_input_specs_match_reference(arch):
    from repro.configs.base import INPUT_SHAPES as J_SHAPES
    from repro_torch.configs.base import INPUT_SHAPES
    jcfg, cfg = _cfgs(arch)
    jmodel = j_model_api.build_model(jcfg, max_seq=S)
    model = model_api.build_model(cfg, max_seq=S)
    for name in INPUT_SHAPES:
        got = model.input_specs(INPUT_SHAPES[name])
        want = jmodel.input_specs(J_SHAPES[name])
        assert {k: (v.shape, v.dtype, v.logical) for k, v in got.items()} \
            == {k: (v.shape, v.dtype, v.logical) for k, v in want.items()}
