"""Async engine beyond the paper's tabular MLP, through the one
federation API: ``Federation.build(model_cfg, vfl_cfg, engine_cfg)``, on
the card. The PyTorch counterpart of ``examples/async_adapters.py``: the
same four runs, steps, printed lines and checks; weights from generators
seeded 0 and 1, as the JAX example's keys are.

Four runs over the same vertically partitioned data:
  1. the paper's tabular model, one client per round (baseline protocol)
  2. the SAME protocol driving a SwiGLU-MLP client/server pair — the
     session only sees the ModelAdapter, not the model family
  3. tabular again with block_size=3 — three concurrent client
     activations per round, the many-client scaling mode — and the client
     fan-out computed as stacked lanes (``use_lanes``; the session's
     tabular adapter composes them from plain ops, as the JAX example's
     does)
  4. tabular with the DP loss channel plugged into the Transport:
     calibrated Gaussian noise on every scalar loss crossing the
     downlink, and a finite spent (ε, δ) on the EngineResult.

    PYTHONPATH=src python examples_torch/async_adapters.py
    PYTHONPATH=src python examples_torch/async_adapters.py --device cpu
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import VFLConfig
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core.adapters import mlp_adapter
from repro_torch.core.async_engine import EngineConfig
from repro_torch.data import make_classification, vertical_partition
from repro_torch.device import resolve_device
from repro_torch.federation import Federation, GaussianLossChannel
from repro_torch.models import common, tabular


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    dev = resolve_device(ap.parse_args(argv).device)

    M, f, c = 4, 64, 10
    cfg = PaperMLPConfig(n_features=f, n_classes=c, n_clients=M,
                         client_embed=32, server_embed=128)
    X, y = make_classification(seed=0, n=2048, n_features=f, n_classes=c)
    Xp = torch.from_numpy(vertical_partition(X, M)).to(dev)
    y = torch.from_numpy(y).long().to(dev)
    vfl = VFLConfig(mu=1e-3, lr_server=0.05, lr_client=0.05, zoo_queries=4)

    # 1 — paper tabular, one activation per round (session from the
    #     paper's config; the adapter is derived inside build)
    fed = Federation.build(cfg, vfl,
                           EngineConfig(method="cascaded", steps=600,
                                        batch_size=64), device=dev)
    params = common.materialize(tabular.param_specs(cfg),
                                torch.Generator(dev).manual_seed(0),
                                device=dev)
    res = fed.run(params, Xp, y)
    acc = float(tabular.accuracy(res.params, Xp, y))
    print(f"tabular  block=1 : loss {res.losses[-25:].mean():.4f} "
          f"acc {acc:.3f}  mean_delay {res.mean_delay:.1f}")

    # 2 — same protocol, SwiGLU-MLP client/server pair via its adapter
    ad = mlp_adapter(n_clients=M, features=f, client_embed=32, d_ff=64,
                     server_embed=128, n_classes=c)
    fed_m = Federation.build(ad, vfl,
                             EngineConfig(method="cascaded", steps=600,
                                          batch_size=64), device=dev)
    res_m = fed_m.run(fed_m.init_params(torch.Generator(dev).manual_seed(1)),
                      Xp, y)
    print(f"swiglu   block=1 : loss {res_m.losses[-25:].mean():.4f} "
          f"(first {res_m.losses[:25].mean():.4f})")

    # 3 — block activation + stacked lanes (the ZOO fan-out)
    fed_b = Federation.build(cfg, vfl,
                             EngineConfig(method="cascaded", steps=200,
                                          batch_size=64, block_size=3,
                                          use_lanes=True), device=dev)
    res_b = fed_b.run(params, Xp, y)
    acc_b = float(tabular.accuracy(res_b.params, Xp, y))
    print(f"tabular  block=3 : loss {res_b.losses[-25:].mean():.4f} "
          f"acc {acc_b:.3f}  mean_delay {res_b.mean_delay:.1f}")

    # 4 — DP loss channel on the Transport's downlink. The ZOO client
    # multiplies (ĥ−h) by φ/μ, so downlink noise is amplified ~φ/μ-fold
    # into its update: under a tight per-release ε the client lr must be
    # tiny — and training STILL converges, because the server's FOO step
    # is local and noise-free (the paper's server-does-the-heavy-lifting
    # claim, surfaced in a DP light).
    vfl_dp = dataclasses.replace(vfl, lr_client=1e-7)
    fed_dp = Federation.build(
        cfg, vfl_dp, EngineConfig(method="cascaded", steps=400,
                                  batch_size=64),
        noise=GaussianLossChannel(clip=5.0, epsilon=1.0, delta=1e-5),
        device=dev)
    res_dp = fed_dp.run(params, Xp, y)
    print(f"tabular  dp      : loss {res_dp.losses[-25:].mean():.4f} "
          f"spent (eps={res_dp.epsilon:.1f}, delta={res_dp.delta:.1e})  "
          f"grads_on_wire={res_dp.transmits_gradients}")

    assert np.isfinite(res.losses).all() and np.isfinite(res_m.losses).all()
    assert res_b.mean_delay < res.mean_delay  # 3/4 clients fresh per round
    assert np.isfinite(res_dp.epsilon) and not res_dp.transmits_gradients


if __name__ == "__main__":
    main()
