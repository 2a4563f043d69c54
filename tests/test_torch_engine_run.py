"""The port's engine over whole runs: a 25-round trajectory through the
fused kernel lanes against ``repro``'s Pallas lanes, and the entry
points' contracts."""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import VFLConfig
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core import async_engine
from repro_torch.core.adapters import ModelAdapter, tabular_adapter
from repro_torch.core.draws import TorchDraws, make_schedule
from repro_torch.core.privacy import GaussianLossChannel
from repro_torch.data import make_classification, vertical_partition
from repro_torch.federation import Federation, Transport
from repro_torch.models import tabular
from test_torch_support import (ENGINE_MLP, engine_case, ledger_tuples,
                                torch_threads)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with torch_threads(1):
        yield


def test_kernel_lanes_trajectory_matches_pallas_lanes():
    """25 cascaded rounds, use_lanes, through the port's fused-epilogue
    kernel path against repro's Pallas-lanes run, at repro's own atol=1e-3
    (tests/test_zoo_vectorized.py:291; the engine's μ = 1e-3 lets φ/μ
    carry float-order gaps across the trajectory)."""
    j, t = engine_case("cascaded", q=2, use_lanes=True, pallas_lanes=True,
                       steps=25, n=512, mu=1e-3)
    jr, tr = j["res"], t["res"]
    assert tr.losses.shape == (25,) and np.isfinite(tr.losses).all()
    np.testing.assert_allclose(tr.losses, jr.losses, atol=1e-3)
    assert tr.max_delay_seen == jr.max_delay_seen
    assert tr.mean_delay == pytest.approx(jr.mean_delay, rel=1e-12)
    assert ledger_tuples(tr.ledger) == ledger_tuples(jr.ledger)


def test_run_wrapper_and_draws_are_deterministic():
    cfg = PaperMLPConfig(**ENGINE_MLP)
    X, y = make_classification(1, 128, cfg.n_features, cfg.n_classes)
    xp = vertical_partition(X, cfg.n_clients)
    vfl = VFLConfig(mu=1e-3, lr_server=0.05, lr_client=0.05, zoo_queries=2)
    ec = async_engine.EngineConfig(method="cascaded", steps=6,
                                   batch_size=8, block_size=2, seed=3)
    params = tabular_adapter(cfg).init_params(
        torch.Generator().manual_seed(1))
    a = async_engine.run(ec, vfl, params, xp, y, adapter=tabular_adapter(cfg),
                         device="cpu")
    b = Federation.build(tabular_adapter(cfg), vfl, ec, device="cpu").run(
        params, xp, y)
    np.testing.assert_array_equal(a.losses, b.losses)
    for k in ("w", "b"):
        assert torch.equal(a.params["clients"][k], b.params["clients"][k])
    # the caller's params are not updated in place
    assert torch.equal(params["clients"]["b"],
                       torch.zeros_like(params["clients"]["b"]))
    c = Federation.build(tabular_adapter(cfg), vfl,
                         async_engine.EngineConfig(
                             method="cascaded", steps=6, batch_size=8,
                             block_size=2, seed=4), device="cpu").run(
        params, xp, y)
    assert not np.array_equal(a.losses, c.losses)
    assert a.ledger.total_bytes == 6 * 2 * (3 * 8 * 16 + 3 * 8) * 4


def test_torch_draws_shapes_and_distinct_block_rows():
    d = TorchDraws(0, "cpu")
    s = d.schedule(200, 5, None, 3)
    assert s.shape == (200, 3) and s.dtype == torch.int64
    assert all(len(set(row.tolist())) == 3 for row in s)
    assert d.schedule(7, 4, (0.0, 1.0, 0.0, 0.0), 1).eq(1).all()
    idx = d.sample_indices(4, 16, 10)
    assert idx.shape == (4, 16) and int(idx.max()) < 10
    tmpl = {"w": torch.zeros(3, 2), "b": torch.zeros(2)}
    raw = d.client_directions(0, tmpl, 2, 4)
    assert raw["w"].shape == (2, 4, 3, 2) and raw["b"].shape == (2, 4, 2)
    assert d.global_directions(0, tmpl, 3)["w"].shape == (3, 3, 2)
    assert d.noise(0, 2, 5).shape == (2, 5)
    g = torch.Generator().manual_seed(0)
    assert make_schedule(g, 9, 3).shape == (9,)


def test_engine_rejects_what_the_reference_rejects():
    cfg = PaperMLPConfig(**ENGINE_MLP)
    X, y = make_classification(0, 64, cfg.n_features, cfg.n_classes)
    xp = vertical_partition(X, cfg.n_clients)
    params = tabular_adapter(cfg).init_params(torch.Generator().manual_seed(0))
    for kw in (dict(method="split", use_lanes=True),
               dict(method="syn-zoo", block_size=3)):
        fed = Federation.build(cfg, VFLConfig(),
                               async_engine.EngineConfig(steps=1, **kw),
                               device="cpu")
        with pytest.raises(ValueError):
            fed.run(params, xp, y)
    bare = ModelAdapter(name="bare", client_forward=tabular.client_forward,
                        server_loss=tabular_adapter(cfg).server_loss,
                        param_specs=lambda: tabular.param_specs(cfg))
    with pytest.raises(ValueError, match="client_lanes"):
        Federation.build(bare, VFLConfig(), async_engine.EngineConfig(
            steps=1, use_lanes=True), device="cpu").run(params, xp, y)
    with pytest.raises(ValueError, match="stacked lane path"):
        Federation.build(cfg, VFLConfig(zoo_unrolled_oracle=True),
                         async_engine.EngineConfig(steps=1),
                         noise=GaussianLossChannel(),
                         device="cpu").run(params, xp, y)
    with pytest.raises(ValueError, match="not both"):
        Federation.build(cfg, noise=GaussianLossChannel(),
                         transport=Transport(), device="cpu")
    with pytest.raises(ValueError, match="disagree"):
        Federation.build(cfg, engine_cfg=async_engine.EngineConfig(
            method="vafl"), transport=Transport("cascaded"), device="cpu")
    with pytest.raises(TypeError):
        Federation.build("paper-mlp", device="cpu")
