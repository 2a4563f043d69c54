"""Does the tabular main path diverge at block 4 and lr 0.05 without
sharding? The paper-width configuration (``PaperMLPConfig()``: 784
features over 4 clients, embeddings 128, 60000 rows, batch 64, μ = 1e-3,
the fused lanes) at ``block_size=4`` and lr 0.05, on the CPU, three ways:

* ``repro``'s engine (``repro.federation.Federation.run``, its own
  threefry draws and parameters; its lanes through the plain jnp fan-out,
  which computes what the Pallas kernel does: in interpret mode on the
  CPU the kernel would take minutes);
* the port's unsharded engine (``TorchDraws``, parameters from
  ``torch.Generator().manual_seed(0)``);
* the port's sharded engine on a gloo group of 4 ranks
  (``mesh_shards=4``, one process a rank, joined through a ``FileStore``),
  on the same draws and parameters as the unsharded run.

    PYTHONPATH=src python tests/_torch_block4_probe.py [--rounds 500]

Prints one JSON object: for each run the first round whose loss is not
finite (None if every loss is), the largest finite loss and its round,
and the mean loss of the first and the last 50 rounds. Takes about a
minute (the gloo ranks run in child processes:
``_torch_block4_probe.py rank RANK STORE OUT ROUNDS``).

On a CUDA card, the same question for the port's unsharded main path
there (imports nothing of JAX):

    PYTHONPATH=src python tests/_torch_block4_probe.py --card \
        [--rounds 500] [--seeds 0,1,2]

runs, for each seed s (the parameters from ``torch.Generator("cuda")``
seeded s, the engine's draws seeded s), the captured run twice, each on
a session of its own, and the eager loop (``use_graph=False``) once, and
prints the same summary for each, whether the two captured runs' losses
are bitwise equal, and whether the eager loop's are the captured run's.
"""
import json
import math
import os
import subprocess
import sys
import tempfile

import numpy as np

BLOCK, LR, MU, BATCH, WORLD = 4, 0.05, 1e-3, 64, 4


def summary(losses) -> dict:
    losses = np.asarray(losses, np.float64)
    bad = np.flatnonzero(~np.isfinite(losses))
    finite = np.where(np.isfinite(losses), losses, -np.inf)
    k = min(50, len(losses))
    return {"first_nonfinite_round": int(bad[0]) if len(bad) else None,
            "max_loss": float(finite.max()),
            "max_loss_round": int(finite.argmax()),
            "mean_first_50": float(np.nanmean(losses[:k])),
            "mean_last_50": float(np.nanmean(losses[-k:]))}


def data():
    from repro_torch.configs.paper_mlp import PaperMLPConfig
    from repro_torch.data import make_classification, vertical_partition
    cfg = PaperMLPConfig()
    X, y = make_classification(seed=0, n=60000, n_features=cfg.n_features,
                               n_classes=cfg.n_classes)
    return cfg, vertical_partition(X, cfg.n_clients), y


def port_losses(rounds: int, shards: int, device: str = "cpu",
                seed: int = 0, inputs=None, use_graph: bool = True):
    import torch
    from repro_torch.configs.base import VFLConfig
    from repro_torch.core.adapters import tabular_adapter
    from repro_torch.core.async_engine import EngineConfig
    from repro_torch.federation import Federation
    cfg, xp, y = inputs or data()
    ad = tabular_adapter(cfg, use_kernel_lanes=True)
    fed = Federation.build(
        ad, VFLConfig(mu=MU, lr_server=LR, lr_client=LR),
        EngineConfig(method="cascaded", steps=rounds, batch_size=BATCH,
                     use_lanes=True, block_size=BLOCK, mesh_shards=shards,
                     seed=seed),
        n_clients=cfg.n_clients, device=device)
    params = fed.init_params(torch.Generator(fed.device).manual_seed(seed))
    return np.asarray(fed.run(params, xp, y, use_graph=use_graph).losses)


def port_run(rounds: int, shards: int) -> dict:
    return summary(port_losses(rounds, shards))


def card_main(rounds: int, seeds) -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("--card needs a CUDA card")
    inputs = data()
    out = {"config": dict(block=BLOCK, lr=LR, mu=MU, batch=BATCH,
                          rounds=rounds, device=torch.cuda.get_device_name(0))}
    for s in seeds:
        runs = [port_losses(rounds, 0, "cuda", s, inputs) for _ in range(2)]
        eager = port_losses(rounds, 0, "cuda", s, inputs, use_graph=False)
        out[f"seed_{s}"] = {
            "captured": [summary(r) for r in runs],
            "eager": summary(eager),
            "captured_runs_bitwise": bool(np.array_equal(
                runs[0], runs[1], equal_nan=True)),
            "eager_bitwise_captured": bool(np.array_equal(
                runs[0], eager, equal_nan=True)),
            "diverged": [diverged(summary(r)) for r in runs + [eager]]}
    return out


def diverged(v: dict) -> bool:
    return (v["first_nonfinite_round"] is not None
            or not math.isfinite(v["mean_last_50"])
            or v["mean_last_50"] > v["mean_first_50"])


def repro_run(rounds: int) -> dict:
    import jax
    from repro.configs.base import VFLConfig
    from repro.configs.paper_mlp import PaperMLPConfig
    from repro.core.adapters import tabular_adapter
    from repro.core.async_engine import EngineConfig
    from repro.federation import Federation
    cfg = PaperMLPConfig()
    _, xp, y = data()
    ad = tabular_adapter(cfg)
    fed = Federation.build(
        ad, VFLConfig(mu=MU, lr_server=LR, lr_client=LR),
        EngineConfig(method="cascaded", steps=rounds, batch_size=BATCH,
                     use_lanes=True, block_size=BLOCK),
        n_clients=cfg.n_clients)
    params = fed.init_params(jax.random.key(0))
    return summary(fed.run(params, xp, y).losses)


def rank_main(rank: int, store: str, out: str, rounds: int) -> None:
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    torch.set_num_threads(1)
    try:
        res = port_run(rounds, WORLD)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def sharded(rounds: int) -> dict:
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out.json")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "rank", str(r),
             os.path.join(d, "store"), out, str(rounds)])
            for r in range(WORLD)]
        codes = [p.wait(timeout=1800) for p in procs]
        if any(codes):
            raise RuntimeError(f"gloo ranks exited with {codes}")
        with open(out) as f:
            return json.load(f)


def main(argv) -> int:
    if argv[:1] == ["rank"]:
        rank_main(int(argv[1]), argv[2], argv[3], int(argv[4]))
        return 0
    rounds = int(argv[argv.index("--rounds") + 1]) if "--rounds" in argv \
        else 500
    if "--card" in argv:
        seeds = ([int(x) for x in argv[argv.index("--seeds") + 1].split(",")]
                 if "--seeds" in argv else [0, 1, 2])
        print(json.dumps(card_main(rounds, seeds)))
        return 0
    res = {"config": dict(block=BLOCK, lr=LR, mu=MU, batch=BATCH,
                          rounds=rounds, gloo_ranks=WORLD),
           "repro": repro_run(rounds), "port": port_run(rounds, 0),
           f"port_gloo_{WORLD}": sharded(rounds)}
    res["diverged"] = {k: diverged(v) for k, v in res.items()
                       if k not in ("config",)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
