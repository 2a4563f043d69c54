"""The port keeps its own copies of the JAX package's numpy/pure-Python
modules (data generators, method tables, configs, tags, the wire ledger
and the DP accountant). These tests hold each copy equal to the
original: byte-equal data, field-equal configs, message-equal ledgers."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import tags as j_tags
from repro import configs as j_configs
from repro.configs.base import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.base import VFLConfig as JVFLConfig
from repro.configs.paper_mlp import PaperMLPConfig as JPaperMLPConfig
from repro.core import methods as j_methods
from repro.core import privacy as j_privacy
from repro.data import pipeline as j_pipeline
from repro.data import synthetic as j_synthetic
from repro.federation.transport import Transport as JTransport
from repro_torch import configs
from repro_torch.analysis import tags
from repro_torch.configs.base import (INPUT_SHAPES, ModelConfig,
                                      ShapeConfig, TrainConfig, VFLConfig)
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core import methods, privacy
from repro_torch.data import pipeline, synthetic
from repro_torch.federation.transport import Transport

METHODS = ("cascaded", "vafl", "split", "zoo-vfl", "syn-zoo")


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n,f,c,m", [(257, 64, 10, 4), (96, 784, 10, 4),
                                     (50, 30, 3, 3)])
def test_synthetic_data_byte_equal(seed, n, f, c, m):
    X, y = synthetic.make_classification(seed, n, f, c)
    jX, jy = j_synthetic.make_classification(seed, n, f, c)
    assert X.dtype == jX.dtype and y.dtype == jy.dtype
    assert X.tobytes() == jX.tobytes() and y.tobytes() == jy.tobytes()
    parts = synthetic.vertical_partition(X, m)
    j_parts = j_synthetic.vertical_partition(jX, m)
    assert parts.shape == j_parts.shape
    assert parts.tobytes() == j_parts.tobytes()


def test_method_tables_equal():
    assert methods.METHOD_ALIASES == j_methods.METHOD_ALIASES
    for name in ("SYNC_METHODS", "ZOO_WIRE_METHODS", "FOO_WIRE_METHODS",
                 "CASCADED", "VAFL", "SPLIT", "ZOO_VFL", "SYN_ZOO"):
        assert getattr(methods, name) == getattr(j_methods, name), name
    for spelling in j_methods.METHOD_ALIASES:
        assert (methods.canonical_method(spelling)
                == j_methods.canonical_method(spelling))
    with pytest.raises(ValueError, match="unknown method"):
        methods.canonical_method("sgd")


@pytest.mark.parametrize("ours,theirs", [(VFLConfig, JVFLConfig),
                                         (PaperMLPConfig, JPaperMLPConfig),
                                         (ModelConfig, JModelConfig),
                                         (TrainConfig, JTrainConfig)])
def test_config_fields_and_defaults_equal(ours, theirs):
    def fields(cls):
        return [(f.name, str(f.type), f.default)
                for f in dataclasses.fields(cls)]
    assert fields(ours) == fields(theirs)
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    assert ours.__dataclass_params__.frozen


def test_input_shapes_equal():
    assert ({k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in J_INPUT_SHAPES.items()})
    for name, shape in INPUT_SHAPES.items():
        assert shape.is_decode == J_INPUT_SHAPES[name].is_decode
    assert ([f.name for f in dataclasses.fields(ShapeConfig)]
            == [f.name for f in dataclasses.fields(JShapeConfig)])
    assert TrainConfig().shape == INPUT_SHAPES["train_4k"]


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_lm_token_batches_byte_equal(seed):
    """The same token stream for a seed (the train driver's data)."""
    for vocab, batch, seq in ((512, 4, 32), (32064, 8, 128)):
        ours = synthetic.lm_token_batches(seed, vocab, batch, seq,
                                          n_batches=3)
        theirs = j_synthetic.lm_token_batches(seed, vocab, batch, seq,
                                              n_batches=3)
        n = 0
        for a, b in zip(ours, theirs, strict=True):
            assert sorted(a) == sorted(b) == ["labels", "tokens"]
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                assert a[k].tobytes() == b[k].tobytes()
            n += 1
        assert n == 3


def test_epoch_minibatches_equal():
    ours = list(pipeline.epoch_minibatches(np.random.default_rng(3), 50, 8))
    theirs = list(j_pipeline.epoch_minibatches(np.random.default_rng(3), 50,
                                               8))
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    it = pipeline.BatchIterator(iter([{"tokens": np.arange(4)}]),
                                device="cpu")
    batch = next(it)
    assert torch.equal(batch["tokens"], torch.arange(4))
    with pytest.raises(StopIteration):
        next(it)


def _model_cfg_view(cfg):
    """Every field and every derived size of a ModelConfig."""
    return (dataclasses.asdict(cfg), cfg.resolved_head_dim, cfg.padded_vocab,
            cfg.is_attention_free, cfg.supports_long_decode,
            cfg.n_ssm_heads, cfg.n_rwkv_heads, cfg.param_count(),
            cfg.active_param_count())


def test_arch_registry_equal():
    assert configs.list_archs() == j_configs.list_archs()
    assert configs.PAPER_MLP == PaperMLPConfig()
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


@pytest.mark.parametrize("arch", sorted(j_configs.ARCH_REGISTRY))
def test_model_configs_and_reduced_equal(arch):
    """Each registry entry, its reduced() variant and a reduced() with
    overrides, field for field and in every derived size."""
    ours, theirs = configs.get_config(arch), j_configs.get_config(arch)
    assert _model_cfg_view(ours) == _model_cfg_view(theirs)
    assert (_model_cfg_view(configs.reduced(ours))
            == _model_cfg_view(j_configs.reduced(theirs)))
    kw = dict(d_model=64, n_heads=2, n_kv_heads=1, d_ff=128, vocab_size=256,
              remat=False, param_dtype="float32")
    assert (_model_cfg_view(configs.reduced(ours, **kw))
            == _model_cfg_view(j_configs.reduced(theirs, **kw)))


def test_paper_mlp_config_properties_equal():
    for kw in ({}, {"n_features": 64, "client_embed": 32},
               {"n_features": 30, "n_clients": 3}):
        assert (PaperMLPConfig(**kw).features_per_client
                == JPaperMLPConfig(**kw).features_per_client)


def test_tags_constants_and_decorators_equal():
    names = [n for n in dir(j_tags) if n.isupper() and n[0] != "_"]
    assert names == [n for n in dir(tags) if n.isupper() and n[0] != "_"]
    for n in names:
        assert getattr(tags, n) == getattr(j_tags, n), n

    @tags.wire("up", accounted_by="Transport.account", kind="embedding")
    @tags.party("client")
    def f():
        pass
    assert f.__vfl_party__ == "client"
    assert f.__vfl_wire__[0]["direction"] == "up"
    with pytest.raises(ValueError):
        tags.party("nobody")
    with pytest.raises(ValueError):
        tags.host_boundary("")


def _msgs(messages):
    return [(m.sender, m.kind, tuple(m.shape), m.dtype, m.wired)
            for m in messages]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("q", [1, 4])
def test_round_messages_and_ledger_equal(method, q):
    assert (_msgs(privacy.round_messages(method, 64, 128, q))
            == _msgs(j_privacy.round_messages(method, 64, 128, q)))
    led, j_led = privacy.Ledger(), j_privacy.Ledger()
    for lg in (led, j_led):
        lg.log_round(method, 16, 32, zoo_queries=q, n_clients=3, n_rounds=5)
    assert _msgs(led.messages) == _msgs(j_led.messages)
    assert led.total_bytes == j_led.total_bytes
    assert led.transmits_gradients == j_led.transmits_gradients
    assert led.bytes_by_kind() == j_led.bytes_by_kind()
    assert led.to_counts() == j_led.to_counts()
    assert (_msgs(privacy.Ledger.from_counts(j_led.to_counts()).messages)
            == _msgs(j_privacy.Ledger.from_counts(led.to_counts()).messages))
    # the Transport owns the q-gating of the ledger and the release count
    tr, j_tr = Transport(method), JTransport(method)
    kw = dict(batch=16, embed=32, zoo_queries=q, n_clients=2, n_rounds=3)
    assert _msgs(tr.account(**kw).messages) == _msgs(
        j_tr.account(**kw).messages)
    assert (tr.releases(n_rounds=3, n_clients=2, zoo_queries=q)
            == j_tr.releases(n_rounds=3, n_clients=2, zoo_queries=q))


def test_serve_messages_equal():
    for with_token in (True, False):
        assert (_msgs(privacy.serve_messages(4, 8, with_token))
                == _msgs(j_privacy.serve_messages(4, 8, with_token)))


@pytest.mark.parametrize("accountant", ["basic", "rdp"])
@pytest.mark.parametrize("subsample", [1.0, 0.25])
def test_gaussian_channel_accounting_equal(accountant, subsample):
    kw = dict(clip=5.0, epsilon=0.5, delta=1e-5, accountant=accountant,
              subsample=subsample)
    ch, j_ch = privacy.GaussianLossChannel(**kw), j_privacy.GaussianLossChannel(**kw)
    assert ch.sigma == j_ch.sigma
    assert ch.per_release() == j_ch.per_release()
    for k in (0, 1, 10, 1000, 100000):
        assert ch.spent(k) == j_ch.spent(k), k
    tr = Transport("cascaded", noise=ch)
    j_tr = JTransport("cascaded", noise=j_ch)
    assert tr.privacy_spent(120) == j_tr.privacy_spent(120)
    assert Transport("cascaded").privacy_spent(120) == (float("inf"), 0.0)


def test_gaussian_channel_rejects_what_the_reference_rejects():
    for kw in (dict(clip=0.0), dict(epsilon=-1.0), dict(delta=1.5),
               dict(accountant="moments"), dict(subsample=0.0)):
        with pytest.raises(ValueError):
            j_privacy.GaussianLossChannel(**kw)
        with pytest.raises(ValueError):
            privacy.GaussianLossChannel(**kw)
    for method in ("vafl", "split", "syn-zoo"):
        with pytest.raises(ValueError):
            Transport(method, noise=privacy.GaussianLossChannel())


def test_gaussian_channel_apply_equal_on_the_same_normals():
    """The port's noise takes its normals from the draw source; fed the
    normals the JAX channel draws from its key, both release the same
    values (clip to [0, clip], then add σ·N(0, 1))."""
    ch = privacy.GaussianLossChannel(clip=2.0, epsilon=1.0, delta=1e-5)
    j_ch = j_privacy.GaussianLossChannel(clip=2.0, epsilon=1.0, delta=1e-5)
    losses = np.array([-0.5, 0.3, 1.7, 4.0], np.float32)
    key = jax.random.key(3)
    normals = np.asarray(jax.random.normal(key, (4,), jnp.float32))
    out = ch.apply(torch.from_numpy(losses), torch.from_numpy(normals))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(j_ch.apply(jnp.asarray(losses),
                                                     key)),
                               atol=1e-5, rtol=1e-6)
    tr = Transport("cascaded", noise=ch)
    np.testing.assert_array_equal(
        tr.downlink(torch.from_numpy(losses), torch.from_numpy(normals)),
        out)
    with pytest.raises(ValueError, match="N\\(0, 1\\)"):
        tr.downlink(torch.from_numpy(losses))
    same = Transport("cascaded").downlink(torch.from_numpy(losses))
    np.testing.assert_array_equal(same.numpy(), losses)


def test_analysis_findings_module_equal():
    """``analysis/findings.py`` (the finding record and the suppression
    scanner the port's passes share) is a byte copy of ``repro``'s, and
    behaves the same on a suppression corpus."""
    import inspect

    from repro.analysis import findings as j_findings
    from repro_torch.analysis import findings
    assert inspect.getsource(findings) == inspect.getsource(j_findings)
    src = ("x = 1  # analysis: ignore[PB101] documented\n"
           "# analysis: ignore[TH201, PB999]\n"
           "y = 2\n")
    known = frozenset({"PB101", "TH201"})
    raw = [findings.Finding("PB101", "f.py", 1, "m"),
           findings.Finding("TH201", "f.py", 3, "m")]
    j_raw = [j_findings.Finding(f.rule, f.path, f.line, f.message)
             for f in raw]
    ours = findings.apply_suppressions(
        raw, findings.scan_suppressions(src), "f.py", known)
    theirs = j_findings.apply_suppressions(
        j_raw, j_findings.scan_suppressions(src), "f.py", known)
    assert [dataclasses.astuple(f) for f in ours] == [
        dataclasses.astuple(f) for f in theirs]
    assert {f.rule for f in ours} == {"BA001", "BA003", "TH201"}
