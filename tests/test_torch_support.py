"""Helpers for the parity tests of the PyTorch port (``repro_torch``)
against the JAX package (``repro``): numpy <-> torch <-> jax conversion, a
cross-framework ``tree_allclose``, and a draw source that replays the JAX
engine's threefry draws into the port's engine.

Both packages run on the CPU here; data crosses as numpy arrays."""
from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.async_engine import _row_keys
from repro.core.async_engine import make_schedule as jax_make_schedule
from repro.federation.transport import NOISE_SALT
from repro_torch.core.partition import tree_map, tree_unflatten
from repro_torch.models.common import params_from_numpy


@contextlib.contextmanager
def torch_threads(n: int):
    """Run torch's CPU ops on ``n`` threads: the port's eager loops of
    small ops slow down badly when every test worker's torch spins up a
    thread per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


# the families the split plane refuses, as the JAX package's does: they
# need a modality frontend on the VFL wire
MODALITY_ARCHS = ("whisper-medium", "internvl2-26b")


def split_plane_refusal(arch: str) -> str:
    """Build ``arch`` (reduced) in both packages' global model APIs and
    return the ``ValueError`` message of ``from_model_config``, after
    checking that the port raises the JAX package's message word for
    word."""
    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.core.adapters import from_model_config as j_from_model_config
    from repro.models.model_api import build_model as j_build_model
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.adapters import from_model_config
    from repro_torch.models.model_api import build_model
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    assert build_model(cfg).client_keys == j_build_model(jcfg).client_keys
    with pytest.raises(ValueError) as theirs:
        j_from_model_config(jcfg, n_clients=2, seq_len=16)
    with pytest.raises(ValueError) as ours:
        from_model_config(cfg, n_clients=2, seq_len=16)
    assert str(ours.value) == str(theirs.value)
    assert "modality frontend" in str(ours.value)
    return str(ours.value)


def to_numpy(x) -> np.ndarray:
    """A torch tensor or jax array -> numpy (bfloat16 widened to f32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def to_torch(tree):
    """A (nested dict) tree of jax/numpy arrays -> CPU tensors."""
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def to_jax(tree):
    """A tree of tensors/numpy arrays -> jax arrays."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(to_numpy(tree))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): to_numpy(tree)}


def tree_allclose(a, b, *, atol: float, rtol: float = 0.0) -> None:
    """Assert two trees (torch or jax leaves, nested dicts) have the same
    key paths and allclose leaves."""
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb), (sorted(fa), sorted(fb))
    for k in fa:
        assert fa[k].shape == fb[k].shape, (k, fa[k].shape, fb[k].shape)
        np.testing.assert_allclose(fa[k], fb[k], atol=atol, rtol=rtol,
                                   err_msg=k)


def raw_normals(key, template, q: int):
    """The N(0, 1) leaves ``repro.core.zoo.sample_directions(key, tree, q)``
    draws before masking and normalising: split(key, q), then per query
    split(k, n_leaves) over the leaves in flatten (sorted-key) order.
    Returns a torch tree of (q, *leaf) leaves shaped like ``template``."""
    shapes = _shapes(template)
    leaves = jax.tree.leaves(shapes)
    per_leaf = [[] for _ in leaves]
    for kq in jax.random.split(key, q):
        for i, (k, leaf) in enumerate(zip(jax.random.split(kq, len(leaves)),
                                          leaves)):
            per_leaf[i].append(np.asarray(
                jax.random.normal(k, leaf.shape, jnp.float32)))
    return tree_unflatten(shapes,
                          [torch.from_numpy(np.stack(p)) for p in per_leaf])


def _shapes(tree):
    """numpy zeros shaped like ``tree`` (torch or jax leaves)."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return np.zeros(tuple(tree.shape), np.float32)


class JaxReplayDraws:
    """The port's draw-source protocol, answered with the exact threefry
    draws ``repro.core.async_engine._session_run`` makes for ``seed``:
    ``split(key(seed), 3)`` into schedule / sample-index / ZOO keys,
    ``make_schedule``, ``randint`` and ``split(k_zoo, T)``; per round the
    block rows' keys (``_row_keys``), the zoo-vfl server's
    ``fold_in(k_t, 1)``, the syn-zoo global draw on ``k_t``, and the DP
    noise on ``fold_in(row_key, NOISE_SALT)``."""

    def __init__(self, seed: int) -> None:
        self.k_sched, self.k_idx, self.k_zoo = jax.random.split(
            jax.random.key(seed), 3)
        self.zoo_keys = None

    def schedule(self, steps, n_clients, probs, block_size):
        s = jax_make_schedule(self.k_sched, steps, n_clients, probs,
                              block_size)
        self.zoo_keys = jax.random.split(self.k_zoo, steps)
        return torch.from_numpy(
            np.asarray(s).reshape(steps, block_size).astype(np.int64))

    def sample_indices(self, steps, batch, n):
        idx = jax.random.randint(self.k_idx, (steps, batch), 0, n)
        return torch.from_numpy(np.asarray(idx).astype(np.int64))

    def _rows(self, t, n_rows):
        return _row_keys(self.zoo_keys[t], jnp.arange(n_rows))

    def client_directions(self, t, template, n_rows, q):
        rows = [raw_normals(k, template, q) for k in self._rows(t, n_rows)]
        return jax.tree.map(lambda *xs: torch.stack(xs), *rows)

    def server_directions(self, t, template, q):
        return raw_normals(jax.random.fold_in(self.zoo_keys[t], 1),
                           template, q)

    def global_directions(self, t, template, q):
        return raw_normals(self.zoo_keys[t], template, q)

    def noise(self, t, n_rows, n):
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.normal(jax.random.fold_in(k, NOISE_SALT),
                                         (n,), jnp.float32))
            for k in self._rows(t, n_rows)]))


# ------------------------------------------------------ engine harness --

ENGINE_MLP = dict(n_features=32, n_classes=4, n_clients=4, client_embed=16,
                  server_embed=32)


# per-method learning rates of the reference benchmark
# (benchmarks/run.py::LRS): ZOO servers need the much smaller step
LRS = {"cascaded": 0.05, "vafl": 0.05, "split": 0.05, "zoo-vfl": 0.001,
       "syn-zoo": 0.001}


def engine_case(method, *, q=1, block=1, dist="sphere", use_lanes=False,
                steps=1, batch=16, n=64, seed=0, noise=None, unrolled=False,
                pallas_lanes=False, kernel_lanes=None, mu=1e-2,
                row_mask=False):
    """Run ``steps`` rounds of one protocol through both packages from the
    same JAX-initialised params, with the port fed the JAX engine's draws.

    ``row_mask=True`` gives both adapters a row-mask hook that perturbs
    only the client's feature rows with a positive batch sum.
    ``mu`` defaults to 1e-2 rather than the engine's 1e-3: the same code,
    with a loss difference ĥ − h ten times further above the f32 rounding
    of the losses that the estimator divides by μ.

    Returns ``(j, t)`` dicts with the public ``run`` result (``res``) and
    the round loop's final ``params``, ``table``, ``delays``, ``losses``
    and per-round ``maxd`` from each package's runner."""
    from repro.configs.base import VFLConfig as JVFLConfig
    from repro.configs.paper_mlp import PaperMLPConfig as JPaperMLPConfig
    from repro.core import async_engine as j_engine
    from repro.core.adapters import tabular_adapter as j_tabular_adapter
    from repro.core.privacy import GaussianLossChannel as JChannel
    from repro.data import make_classification, vertical_partition
    from repro.federation import Federation as JFederation
    from repro.models import common as j_common
    from repro.models import tabular as j_tabular
    from repro_torch.configs.base import VFLConfig
    from repro_torch.configs.paper_mlp import PaperMLPConfig
    from repro_torch.core import async_engine
    from repro_torch.core.adapters import tabular_adapter
    from repro_torch.core.privacy import GaussianLossChannel
    from repro_torch.federation import Federation

    jcfg, cfg = JPaperMLPConfig(**ENGINE_MLP), PaperMLPConfig(**ENGINE_MLP)
    X, y = make_classification(0, n, jcfg.n_features, jcfg.n_classes)
    Xp = vertical_partition(X, jcfg.n_clients)
    jparams = j_common.materialize(j_tabular.param_specs(jcfg),
                                   jax.random.key(seed))
    vkw = dict(mu=mu, lr_server=LRS[method], lr_client=LRS[method],
               zoo_queries=q,
               zoo_dist=dist, zoo_unrolled_oracle=unrolled)
    ekw = dict(method=method, steps=steps, batch_size=batch,
               block_size=block, use_lanes=use_lanes, seed=seed)
    jvfl, vfl = JVFLConfig(**vkw), VFLConfig(**vkw)
    jad = j_tabular_adapter(jcfg, use_pallas_lanes=pallas_lanes)
    ad = tabular_adapter(cfg, use_kernel_lanes=(
        pallas_lanes if kernel_lanes is None else kernel_lanes))
    if row_mask:
        jad = dataclasses.replace(jad, row_mask=lambda cm, x: {
            "b": jnp.ones_like(cm["b"]),
            "w": (x.sum(0) > 0).astype(jnp.float32)})
        ad = dataclasses.replace(ad, row_mask=lambda cb, x: {
            "b": torch.ones_like(cb["b"]), "w": (x.sum(1) > 0).float()})
    jfed = JFederation.build(jad, jvfl, j_engine.EngineConfig(**ekw),
                             noise=None if noise is None else JChannel(**noise))
    fed = Federation.build(ad, vfl, async_engine.EngineConfig(**ekw),
                           noise=(None if noise is None
                                  else GaussianLossChannel(**noise)),
                           device="cpu")
    jx, jy = jnp.asarray(Xp), jnp.asarray(y)
    tx, ty = torch.from_numpy(Xp), torch.from_numpy(y).long()

    j = {"res": jfed.run(jparams, jx, jy), "params0": jparams}
    t = {"res": fed.run(to_torch(jparams), Xp, y,
                        draws=JaxReplayDraws(seed))}

    # the round loops themselves, for the table and delay counters the
    # results do not carry (the JAX runner is the one run() compiled)
    M, sync = jcfg.n_clients, method in ("split", "syn-zoo")
    blk = 1 if sync else block
    k_sched, k_idx, k_zoo = jax.random.split(jax.random.key(seed), 3)
    sched = jax_make_schedule(k_sched, steps, M, None, blk)
    sched = sched.reshape(steps, blk)
    idx = jax.random.randint(k_idx, (steps, batch), 0, n)
    runner = j_engine._make_runner(jad, jfed.transport, jvfl, sync, blk,
                                   use_lanes, None, None)
    (p, tab, dl), (ls, md) = runner(
        jparams, jax.vmap(jad.client_forward)(jparams["clients"], jx),
        jnp.zeros((M, n), jnp.int32), sched, idx,
        jax.random.split(k_zoo, steps), jx, jy)
    j.update(params=p, table=tab, delays=dl, losses=ls, maxd=md)

    draws = JaxReplayDraws(seed)
    trun = async_engine._make_runner(ad, fed.transport, vfl, sync, blk,
                                     use_lanes)
    params0 = to_torch(jparams)
    (p, tab, dl), (ls, md) = trun(
        params0, ad.client_forward(params0["clients"], tx),
        torch.zeros((M, n), dtype=torch.int32),
        draws.schedule(steps, M, None, blk),
        draws.sample_indices(steps, batch, n), draws, tx, ty)
    t.update(params=p, table=tab, delays=dl, losses=ls, maxd=md)
    return j, t


def ledger_tuples(ledger):
    return [(m.sender, m.kind, tuple(m.shape), m.dtype, m.wired)
            for m in ledger.messages]


# Which parameter leaves a method updates by ZOO (the rest by FOO).
ZOO_PARTS = {"cascaded": ("clients",), "vafl": (), "split": (),
             "zoo-vfl": ("clients", "server"),
             "syn-zoo": ("clients", "server")}


def assert_round_parity(method, j, t):
    """One round (or a few) of both engines from the same state and draws.

    FOO-updated params, losses and the embedding table agree to f32
    rounding. A ZOO-updated leaf moves by lr·φ/μ·(ĥ − h)·u, and the two
    frameworks round each lane loss differently (|f|·2^-23 ≈ 2e-7 here)
    before the difference ĥ − h is taken (as small as ~1e-4 at μ = 1e-2
    for the 2212-dim ZOO server), so those leaves are held to 1% of the
    round's own update: measured at most 0.12% (zoo-vfl, q = 1) at
    μ = 1e-2, 1.3% at μ = 1e-3."""
    jr, tr = j["res"], t["res"]
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_numpy(t["losses"]), to_numpy(j["losses"]),
                               rtol=1e-6, atol=1e-6)
    assert tr.max_delay_seen == jr.max_delay_seen
    assert tr.mean_delay == pytest.approx(jr.mean_delay, rel=1e-12)
    np.testing.assert_array_equal(to_numpy(t["maxd"]), to_numpy(j["maxd"]))
    np.testing.assert_array_equal(to_numpy(t["delays"]), to_numpy(j["delays"]))
    np.testing.assert_allclose(to_numpy(t["table"]), to_numpy(j["table"]),
                               rtol=1e-6, atol=2e-6)
    assert ledger_tuples(tr.ledger) == ledger_tuples(jr.ledger)
    assert (tr.wire_bytes, tr.transmits_gradients) == (
        jr.wire_bytes, jr.transmits_gradients)
    assert (tr.epsilon, tr.delta) == (jr.epsilon, jr.delta)
    p0 = _flat(j["params0"])
    for params in (t["params"], tr.params):
        got, want = _flat(params), _flat(j["params"])
        assert sorted(got) == sorted(want)
        for k in want:
            if k.split("/")[0] in ZOO_PARTS[method]:
                step = float(np.abs(want[k] - p0[k]).max())
                tol = dict(atol=1e-2 * step + 1e-6, rtol=0)
            else:
                tol = dict(atol=1e-6, rtol=1e-5)
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
    # the harness's replay of the JAX round loop is the run() it checks
    np.testing.assert_array_equal(_flat(jr.params)["server/w1"],
                                  _flat(j["params"])["server/w1"])


class JaxPopulationDraws(JaxReplayDraws):
    """:class:`JaxReplayDraws` as a population draw source: the act
    frame's ``key`` payload is the threefry key data of block row r's key
    (``_row_keys``), as ``repro``'s ``run_population`` sends it, and
    ``directions`` turns key data back into that key's raw normals — the
    draws ``repro``'s ``ClientWorker`` makes from the same frame."""

    def row_key(self, t, r):
        return np.asarray(jax.random.key_data(self._rows(t, r + 1)[r]))

    @staticmethod
    def directions(key, template, q):
        kd = jnp.asarray(np.asarray(key, np.uint32))
        raw = raw_normals(jax.random.wrap_key_data(kd), template, q)
        return tree_map(lambda r, leaf: r.to(leaf.device), raw, template)
