"""The paper's quickstart (examples/quickstart.py) run by the port on the
CPU with its own generator draws: it must reach the reference's outcome."""
import numpy as np
import torch

from repro_torch.configs.base import VFLConfig
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core import async_engine
from repro_torch.core.adapters import tabular_adapter
from repro_torch.data import make_classification, vertical_partition
from repro_torch.federation import Federation
from repro_torch.models import tabular
from test_torch_support import torch_threads


def _quickstart():
    cfg = PaperMLPConfig(n_features=64, n_classes=10, n_clients=4,
                         client_embed=32, server_embed=128)
    X, y = make_classification(seed=0, n=2048, n_features=cfg.n_features,
                               n_classes=cfg.n_classes)
    return cfg, vertical_partition(X, cfg.n_clients), y


def test_quickstart_reaches_accuracy_with_torch_draws():
    """examples/quickstart.py's configuration, run by the port with its
    own generator draws, through the kernel lanes' CPU path: acc > 0.9,
    no gradient on the wire."""
    cfg, x_parts, y = _quickstart()
    fed = Federation.build(
        tabular_adapter(cfg, use_kernel_lanes=True),
        VFLConfig(mu=1e-3, lr_server=0.05, lr_client=0.05),
        async_engine.EngineConfig(method="cascaded", steps=800,
                                  batch_size=64, use_lanes=True),
        device="cpu")
    with torch_threads(1):
        res = fed.run(fed.init_params(torch.Generator().manual_seed(0)),
                      x_parts, y)
    acc = float(tabular.accuracy(res.params, torch.from_numpy(x_parts),
                                 torch.from_numpy(y).long()))
    assert np.isfinite(res.losses).all()
    assert acc > 0.9, acc
    assert not res.transmits_gradients
    assert res.wire_bytes == 800 * (2 * 64 * 32 + 2 * 64) * 4
