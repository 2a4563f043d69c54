"""Worker process for the port's socket tests: one client party of the
wire tests' tabular protocol, as a ``repro_torch`` :class:`ClientWorker`
served over a :class:`SocketBackend` until the engine says stop.

It rebuilds the same party row the parent's run uses, so no parameters
cross out of band: for a port engine the port's init from a
``torch.Generator`` seeded 0, for the JAX package's engine that
package's init from key 0, carried into torch (only that mode imports
JAX).

Usage: python _torch_wire_socket_child.py <port> <party>
           [--engine repro|port] [--die-after-frames N]

``--engine repro`` serves the JAX package's engine: its ``act`` frames
carry threefry key data, and the worker's direction source replays the
draws that key stands for. ``--engine port`` (the default) serves the
port's engine with the default (seed, t, row) source. ``--die-after-frames
N`` wraps the backend in a :class:`ChaosBackend` that ``kill -9``'s this
process as it sends its Nth frame.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from repro_torch.configs import VFLConfig  # noqa: E402
from repro_torch.configs.paper_mlp import PaperMLPConfig  # noqa: E402
from repro_torch.core.adapters import tabular_adapter  # noqa: E402
from repro_torch.data import make_classification, vertical_partition  # noqa: E402,E501
from repro_torch.tree import tree_map  # noqa: E402
from repro_torch.wire import (ChaosBackend, ChaosPlan, ClientWorker,  # noqa: E402,E501
                              SocketBackend)

CFG = dict(n_features=32, n_classes=4, n_clients=4, client_embed=16,
           server_embed=32)
VFL = dict(mu=1e-2, lr_server=0.05, lr_client=0.05, zoo_queries=2,
           zoo_dist="normal")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("port", type=int)
    ap.add_argument("party", type=int)
    ap.add_argument("--engine", choices=("repro", "port"), default="port")
    ap.add_argument("--die-after-frames", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(1)
    X, _ = make_classification(0, 256, CFG["n_features"], CFG["n_classes"])
    Xp = vertical_partition(X, CFG["n_clients"])
    adapter = tabular_adapter(PaperMLPConfig(**CFG))
    directions = None
    if args.engine == "repro":
        import jax
        from repro.configs.paper_mlp import PaperMLPConfig as JConfig
        from repro.models import common, tabular
        from test_torch_support import JaxPopulationDraws, to_torch
        clients = to_torch(common.materialize(
            tabular.param_specs(JConfig(**CFG)),
            jax.random.key(0)))["clients"]
        directions = JaxPopulationDraws.directions
    else:
        clients = adapter.init_params(torch.Generator().manual_seed(0),
                                      device="cpu")["clients"]
    row = tree_map(lambda a: a[args.party], clients)
    backend = SocketBackend.connect("127.0.0.1", args.port)
    if args.die_after_frames:
        backend = ChaosBackend(
            backend, ChaosPlan(kill_at_frame=args.die_after_frames))
    worker = ClientWorker(adapter, VFLConfig(**VFL), row, Xp[args.party],
                          args.party, backend, directions=directions)
    worker.serve()
    print("CHILD_OK", flush=True)


if __name__ == "__main__":
    main()
