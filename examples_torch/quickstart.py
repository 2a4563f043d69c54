"""Quickstart: cascaded hybrid VFL (ZOO clients + FOO server), on the card.

Four banks (clients) hold disjoint feature slices of each customer; the
agency (server) holds the labels. Nothing but embeddings and scalar losses
ever crosses the wire. The PyTorch counterpart of ``examples/
quickstart.py``: the same configuration, steps, printed lines and check;
the weights come from a ``torch.Generator`` seeded with 0.

    PYTHONPATH=src python examples_torch/quickstart.py
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import VFLConfig
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core import async_engine
from repro_torch.core.privacy import Ledger
from repro_torch.data import make_classification, vertical_partition
from repro_torch.device import resolve_device
from repro_torch.models import common, tabular


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = PaperMLPConfig(n_features=64, n_classes=10, n_clients=4,
                         client_embed=32, server_embed=128)
    X, y = make_classification(seed=0, n=2048, n_features=cfg.n_features,
                               n_classes=cfg.n_classes)
    x_parts = torch.from_numpy(vertical_partition(X, cfg.n_clients)).to(dev)
    y = torch.from_numpy(y).long().to(dev)
    params = common.materialize(tabular.param_specs(cfg),
                                torch.Generator(dev).manual_seed(0),
                                device=dev)

    vfl = VFLConfig(mu=1e-3, lr_server=0.05, lr_client=0.05)
    res = async_engine.run(
        async_engine.EngineConfig(method="cascaded", steps=800,
                                  batch_size=64),
        vfl, params, x_parts, y, device=dev)

    acc = float(tabular.accuracy(res.params, x_parts, y))
    ledger = Ledger()
    for _ in range(800):
        ledger.log_round("cascaded", 64, cfg.client_embed)
    print(f"final loss        : {res.losses[-25:].mean():.4f}")
    print(f"train accuracy    : {acc:.3f}")
    print(f"wire bytes total  : {ledger.total_bytes:,}")
    print(f"gradients on wire : {ledger.transmits_gradients}")
    assert acc > 0.9 and not ledger.transmits_gradients


if __name__ == "__main__":
    main()
