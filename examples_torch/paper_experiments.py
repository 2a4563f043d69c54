"""The paper's base experiments (Figs 3-5a, Table II) at laptop scale, on
the card.

Compares all five frameworks over (a) client counts {4,6,8} and (b) server
widths {128,256,512}, writing convergence curves + final accuracies to CSV.
The PyTorch counterpart of ``examples/paper_experiments.py``: the same
cells, learning rates, printed lines and CSV headers and rows, written to
``experiments_torch/`` (``OUT``) where the JAX example writes
``experiments/``; the weights come from a generator seeded with 0.

    PYTHONPATH=src python examples_torch/paper_experiments.py [--steps 1500]
    PYTHONPATH=src python examples_torch/paper_experiments.py --device cpu
"""
import argparse
import csv
import os

import torch

from repro_torch.configs import VFLConfig
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core import async_engine
from repro_torch.data import make_classification, vertical_partition
from repro_torch.device import resolve_device
from repro_torch.models import common, tabular

LRS = {"split": 0.05, "vafl": 0.05, "cascaded": 0.05,
       "zoo-vfl": 0.001, "syn-zoo": 0.001}
OUT = os.path.join(os.path.dirname(__file__), "..", "experiments_torch")


def run_cell(n_clients, server_embed, method, steps, device):
    cfg = PaperMLPConfig(n_features=64, n_classes=10, n_clients=n_clients,
                         client_embed=32, server_embed=server_embed)
    X, y = make_classification(0, 2048, cfg.n_features, cfg.n_classes)
    Xp = torch.from_numpy(vertical_partition(X, n_clients)).to(device)
    y = torch.from_numpy(y).long().to(device)
    params = common.materialize(tabular.param_specs(cfg),
                                torch.Generator(device).manual_seed(0),
                                device=device)
    vfl = VFLConfig(mu=1e-3, lr_server=LRS[method], lr_client=LRS[method])
    res = async_engine.run(
        async_engine.EngineConfig(method=method, steps=steps, batch_size=64),
        vfl, params, Xp, y, device=device)
    acc = float(tabular.accuracy(res.params, Xp, y))
    return res.losses, acc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(OUT, exist_ok=True)

    rows = []
    curves = {}
    for m_clients in (4, 6, 8):
        for method in LRS:
            losses, acc = run_cell(m_clients, 128, method, args.steps, dev)
            rows.append(("clients", m_clients, method, acc))
            curves[f"clients{m_clients}_{method}"] = losses
            print(f"M={m_clients} {method:9s} acc={acc:.3f}", flush=True)
    for width in (128, 256, 512):
        for method in ("vafl", "zoo-vfl", "cascaded"):
            losses, acc = run_cell(4, width, method, args.steps, dev)
            rows.append(("width", width, method, acc))
            curves[f"width{width}_{method}"] = losses
            print(f"W={width} {method:9s} acc={acc:.3f}", flush=True)

    with open(os.path.join(OUT, "paper_table2_accuracy.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(["sweep", "value", "method", "train_acc"])
        w.writerows(rows)
    with open(os.path.join(OUT, "paper_fig3_curves.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(["cell", "step", "loss"])
        for cell, losses in curves.items():
            for i in range(0, len(losses), 10):
                w.writerow([cell, i, float(losses[i])])
    print("wrote", os.path.join(OUT, "paper_table2_accuracy.csv"))


if __name__ == "__main__":
    main()
