"""One rank of the port's sharded async engine on the CPU, for
``tests/test_torch_engine_sharded.py``.

    python _torch_sharded_child.py RANK WORLD STORE OUT CASES

Every rank joins a gloo group of WORLD ranks through the ``FileStore`` at
STORE (no TCP port, no group in the parent's process), runs each case of
the JSON file CASES with ``EngineConfig(mesh_shards=WORLD)`` on the CPU,
and rank 0 writes the results to OUT (``torch.save``). The parent runs
the same cases unsharded in its own process through :func:`run_case` and
compares. A case is a dict of :data:`DEFAULTS`' keys; its ``kind``:

* ``run``: ``Federation.run`` plus the round loop itself
  (``async_engine._rounds``: the table, gathered from every shard, and the
  delays the result does not carry), on ``TorchDraws`` or, with
  ``draws="jax"``, on ``repro``'s threefry draws from ``repro``'s params;
  a sharded run also runs the loop with ``graph=False`` (``graph_off``);
* ``resume``: a run, ``fed.save`` (rank 0), ``Federation.restore`` on
  every rank (the mesh from the manifest's ``mesh_shards``), a second run
  of the restored session, and the same second run without the break;
* ``restore``: restore the session saved at ``path`` and run it;
* ``error``: the ``ValueError`` a run raises;
* ``mesh``: ``launch.mesh``'s meshes and refusals on this group.
"""
import json
import os
import sys

import torch
import torch.distributed as dist

DEFAULTS = dict(kind="run", method="cascaded", M=8, block=4, steps=8, q=2,
                dist="sphere", lanes=False, noise=False, draws="torch",
                mu=1e-3, n=256, batch=8, seed=0, path="")

# per-method learning rates, as the engine tests use them
LRS = {"cascaded": 0.05, "vafl": 0.05, "zoo-vfl": 0.001}


def setup(case, mesh_shards):
    """(session, params, x_parts, y) of a case on the CPU."""
    from repro_torch.configs.base import VFLConfig
    from repro_torch.configs.paper_mlp import PaperMLPConfig
    from repro_torch.core.async_engine import EngineConfig
    from repro_torch.core.adapters import tabular_adapter
    from repro_torch.core.privacy import GaussianLossChannel
    from repro_torch.data import make_classification, vertical_partition
    from repro_torch.federation import Federation
    c = dict(DEFAULTS, **case)
    cfg = PaperMLPConfig(n_features=32, n_classes=4, n_clients=c["M"],
                         client_embed=16, server_embed=32)
    X, y = make_classification(0, c["n"], cfg.n_features, cfg.n_classes)
    xp = vertical_partition(X, cfg.n_clients)
    lr = LRS[c["method"]]
    vfl = VFLConfig(mu=c["mu"], lr_server=lr, lr_client=lr,
                    zoo_queries=c["q"], zoo_dist=c["dist"])
    ec = EngineConfig(method=c["method"], steps=c["steps"],
                      batch_size=c["batch"], block_size=c["block"],
                      use_lanes=c["lanes"], seed=c["seed"],
                      mesh_shards=mesh_shards)
    adapter = tabular_adapter(cfg, use_kernel_lanes=c["lanes"])
    noise = (GaussianLossChannel(clip=5.0, epsilon=1.0, delta=1e-5)
             if c["noise"] else None)
    fed = Federation.build(adapter, vfl, ec, noise=noise,
                           n_clients=c["M"], device="cpu")
    if c["draws"] == "jax":
        import jax
        from repro.configs.paper_mlp import PaperMLPConfig as JPaperMLPConfig
        from repro.models import common as j_common
        from repro.models import tabular as j_tabular
        from test_torch_support import to_torch
        jcfg = JPaperMLPConfig(n_features=32, n_classes=4, n_clients=c["M"],
                               client_embed=16, server_embed=32)
        params = to_torch(j_common.materialize(j_tabular.param_specs(jcfg),
                                               jax.random.key(c["seed"])))
    else:
        params = adapter.init_params(
            torch.Generator().manual_seed(c["seed"]))
    return fed, params, xp, y


def make_draws(case):
    from repro_torch.core.draws import TorchDraws
    c = dict(DEFAULTS, **case)
    if c["draws"] == "jax":
        from test_torch_support import JaxReplayDraws
        return JaxReplayDraws(c["seed"])
    return TorchDraws(c["seed"], "cpu")


def _gather_table(fed, table):
    """The whole (M, n, e) table from every shard's rows."""
    if fed.mesh is None or fed.mesh.size(0) == 1:
        return table
    parts = [torch.empty_like(table) for _ in range(fed.mesh.size(0))]
    dist.all_gather(parts, table, group=fed.mesh.get_group("data"))
    return torch.cat(parts)


def round_loop(fed, params, xp, y, draws, graph=True):
    """The run's rounds through the engine's round loop
    (``async_engine._rounds``; ``graph=False`` is its internal switch to
    the eager loop): the params, the whole table, the delays, losses and
    per-round max delays."""
    from repro_torch.core import async_engine
    p, x, yt = fed._engine_inputs(params, xp, y)
    (pp, table, delays), (losses, maxd) = async_engine._rounds(
        fed.adapter, fed.transport, fed.vfl, fed.engine, p, x, yt,
        draws=draws, mesh=fed.mesh, graph=graph)
    return {"params": pp, "table": _gather_table(fed, table),
            "delays": delays, "losses": losses, "maxd": maxd}


def rounds(fed, params, xp, y, draws):
    """``Federation.run`` and the same rounds through the round loop:
    the dict ``test_torch_support.assert_round_parity`` reads."""
    res = fed.run(params, xp, y, draws=draws())
    return dict(round_loop(fed, params, xp, y, draws()), res=res)


def run_case(case, mesh_shards=0):
    """One case's results; ``mesh_shards=0`` runs it unsharded."""
    from repro_torch.federation import Federation
    from repro_torch.launch.mesh import make_client_mesh
    c = dict(DEFAULTS, **case)
    if c["kind"] == "mesh":
        from repro_torch.launch.mesh import (make_host_mesh,
                                             make_production_mesh)
        out = {"all": make_client_mesh(device="cpu").size(0),
               "host": make_host_mesh().mesh_dim_names}
        for n in (0, dist.get_world_size() + 1):
            try:
                make_client_mesh(n, device="cpu")
            except ValueError as e:
                out[n] = str(e)
        for multi_pod in (False, True):
            try:
                make_production_mesh(multi_pod=multi_pod)
            except ValueError as e:
                out[("production", multi_pod)] = str(e)
        try:
            make_client_mesh(1, device="cuda")
        except ValueError as e:
            out["cuda_on_gloo"] = str(e)
        return out
    if c["kind"] == "restore":
        fed, params, _ = Federation.restore(c["path"], device="cpu")
        _, _, xp, y = setup(case, 0)
        out = rounds(fed, params, xp, y, lambda: make_draws(case))
        out.update(vfl=fed.vfl, engine=fed.engine, params0=params)
        return out
    fed, params, xp, y = setup(case, mesh_shards)
    if c["kind"] == "error":
        try:
            fed.run(params, xp, y)
        except ValueError as e:
            return {"error": str(e)}
        return {"error": None}
    if c["kind"] == "resume":
        first = fed.run(params, xp, y)
        unbroken = fed.run(first.params, xp, y)
        path = c["path"]
        if not dist.is_initialized() or dist.get_rank() == 0:
            fed.save(path, first.params, step=c["steps"])
        if dist.is_initialized():
            dist.barrier()
        fed2, params2, state = Federation.restore(path, device="cpu")
        resumed = fed2.run(params2, xp, y)
        return {"unbroken": unbroken, "resumed": resumed,
                "step": state.step, "mesh_shards": fed2.engine.mesh_shards,
                "mesh_size": None if fed2.mesh is None else
                fed2.mesh.size(0)}
    out = rounds(fed, params, xp, y, lambda: make_draws(case))
    if mesh_shards:
        # the runner's loop form whatever the graph switch says (gloo:
        # nothing is captured on the CPU)
        out["graph_off"] = round_loop(fed, params, xp, y, make_draws(case),
                                      graph=False)
    return out


def main(argv):
    rank, world, store, out, cases = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world)
    try:
        with open(cases) as f:
            todo = json.load(f)
        results = {case["name"]: run_case(case, mesh_shards=world)
                   for case in todo}
        if rank == 0:
            torch.save(results, out + ".tmp")
            os.replace(out + ".tmp", out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
