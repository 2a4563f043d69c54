"""End-to-end cascaded VFL training driver, on the card.

Trains any architecture of the registry (the dense, multimodal, MoE —
DeepSeek-V3's MLA, dense leading layers and MTP head included — ssm,
hybrid and encoder-decoder families) with the paper's cascaded hybrid
optimization (ZOO client / FOO
server) — or any baseline method — on synthetic LM data. ``--reduced``
(the default) runs the smoke-size config; ``--full`` the published
width; ``--layers N`` cuts the depth to N layers at either width (a
``first_k_dense`` config keeps at most N dense layers first). As in the
JAX driver, every batch of a VLM carries zero ``patch_embeds`` and every
batch of an encoder-decoder zero ``frames`` (the stub frontends' inputs;
bf16, on the run's device), and the client partition holds the modality
projector ``proj`` beside the embedding.

Training is constructed through the ``repro_torch.federation`` session
API: ``Federation.build(cfg, vfl, engine_cfg)`` resolves the model plane,
the canonical method name and the wire (ledger + optional DP noise
channel), and this driver pumps batches through ``fed.sync_step(...)``.
The CLI accepts every spelling in ``repro_torch.core.methods.
METHOD_ALIASES`` and canonicalizes at the boundary — step factories and
the ledger only ever see canonical names.

Checkpointing goes through the session lifecycle: ``--checkpoint`` calls
``fed.save`` (per-party directories + step + optimizer/schedule state +
ledger totals + spent DP budget) and ``--resume PATH`` continues from a
saved session — the restored run re-derives the same batches, per-step
draws and the ORIGINAL schedule horizon from the saved state, so it
matches an uninterrupted run allclose with ledger and (ε, δ) totals
exactly continued (exactly equivalent for step-stationary schedules;
decaying schedules keep their saved total_steps rather than silently
re-stretching, running at the tail lr past the original horizon).

``--engine population`` trains through the population engine over the
wire plane instead (:func:`train_population`, ``fed.run_population``):
``--clients`` client parties, each behind a loopback wire endpoint,
with deterministic fault injection (``--fault-*``), straggler admission
(``--admission-ms``) and bounded-staleness forcing
(``--staleness-bound``); ``--until k --checkpoint DIR`` stops after round
k with the async plane saved, and ``--resume DIR`` finishes the same
horizon bitwise.

The step is compiled as the JAX driver's ``jax.jit(step_fn,
donate_argnums=(0, 1))`` is: ``fed.sync_step(opt, graph=True)`` updates
the parameters and optimizer state in place, and on the card runs the
first step eagerly, captures the step as a CUDA graph and replays it
every later step (the result's ``step_graph`` holds its capture seconds,
nodes and replays); on the CPU the same step loops on its static
buffers. A placed run (``mesh``, ``--production-mesh``) is compiled the
same way, as the JAX driver jits its step under the mesh's shardings:
its parameters, optimizer state, batch and draws are DTensors, the
graph is keyed by their placements, and DTensor's sharding propagation
and Python dispatch run at step 0 and at the capture only.

Ported from the JAX package's ``launch/train.py``. Step t's ZOO
directions and DP noise come from ``StepDraws(seed)``, seeded by
(seed, t), where the JAX driver folds t into its key; the population
engine's come from ``RowDraws(seed)``, seeded by (seed, t, row).
``--device`` chooses where it runs: the card by default, ``cpu`` when
asked.

``--production-mesh`` trains on the production mesh, as the JAX driver
does: (16, 16) ``("data", "model")`` over every rank of the process group
(``launch.mesh.make_production_mesh``; 256 ranks, one a device), the
parameters DTensors placed by ``PARAM_RULES`` and every step run inside
``use_mesh``, so the models' ``shard_constraint`` sites redistribute the
activations. Without it the run builds no mesh and keeps plain tensors:
that is all the JAX driver's (1, 1) host mesh amounts to.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --steps 8 --batch 4 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --full --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch qwen3-moe-30b-a3b --steps 8 --batch 4 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --full \
        --arch rwkv6-7b --layers 8 --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch deepseek-v3-671b --steps 8 --batch 4 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --full \
        --arch whisper-medium --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --full \
        --arch internvl2-26b --layers 8 --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --resume ck/ \\
        --steps 200 --checkpoint ck2/
    PYTHONPATH=src python -m repro_torch.launch.train --engine population \\
        --device cpu --steps 40 --seq 32 --until 20 --checkpoint ck/
    PYTHONPATH=src python -m repro_torch.launch.train --engine population \\
        --full --steps 40 --seq 32
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs import (ModelConfig, VFLConfig, cut_depth,
                                 get_config, list_archs, reduced)
from repro_torch.core.async_engine import EngineConfig, PopulationConfig
from repro_torch.core.draws import PlacedDraws, StepDraws
from repro_torch.core.methods import METHOD_ALIASES, canonical_method
from repro_torch.core.partition import split_params
from repro_torch.core.privacy import GaussianLossChannel
from repro_torch.data import (BatchIterator, lm_token_batches,
                              vertical_partition)
from repro_torch.device import DeviceLike
from repro_torch.federation import Federation, SessionState
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import common
from repro_torch.optim import make_schedule, sgd
from repro_torch.sharding.rules import (ACT_RULES, PARAM_RULES,
                                        named_sharding, use_mesh)
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.wire.faults import FaultPlan


def train(arch: Union[str, ModelConfig] = "", *, steps: int = 100,
          batch: int = 8,
          seq: int = 128, method: str = "cascaded", lr: float = 0.01,
          mu: float = 1e-3, lr_client: float = 0.0,
          use_reduced: bool = True, seed: int = 0,
          log_every: int = 10, zoo_queries: int = 1,
          active_rows: bool = False, production_mesh: bool = False,
          checkpoint_path: str = "", schedule: str = "constant",
          noise: Optional[GaussianLossChannel] = None,
          resume: str = "", device: DeviceLike = None,
          n_layers: int = 0, mesh=None, keep_params: bool = False) -> dict:
    """``arch`` is an arch id of the registry, or a ``ModelConfig`` (a
    registry entry with, say, its experts cut; ``use_reduced`` and
    ``n_layers`` apply to it as to an id's). ``device=None`` runs on the
    card and raises without one; pass ``device="cpu"`` for the CPU. A
    resumed run restores onto ``device``. ``n_layers`` > 0 cuts the
    model's depth to that many layers, ``first_k_dense`` to at most that
    (``configs.cut_depth``; a new run only: a resumed one keeps its saved
    config).

    ``production_mesh`` places the run on ``make_production_mesh()``,
    which needs a process group of 256 ranks. ``mesh`` (a ``DeviceMesh``
    with ``("data", "model")`` axes, keyword only) runs the same placed
    loop on a mesh the caller's group holds: torch cannot give real values
    for 256 ranks in one process, so this is how the placed path is run
    and checked at a size a machine has (a (2, 2) gloo mesh on the CPU, a
    (1, 1) NCCL mesh on one card). A placed run draws every batch,
    direction and noise whole on each rank, then places it, so its draws
    are bitwise the unplaced run's. Its step is the unplaced run's
    compiled step: on the card step 0 runs eagerly through DTensor and
    the step is then captured and replayed (the result's
    ``step_graph``); on the CPU (gloo) it loops. It checkpoints and
    resumes as the unplaced run does, in the same on-disk format: every
    rank restores the saved (whole) trees and places them; at the save
    every rank gathers each placed leaf (``full_tensor()``, a
    collective), the mesh's first rank writes the directory and every
    rank waits at a barrier until it is complete.
    ``keep_params`` puts the final parameters (DTensors on a mesh) in the
    result under ``"params"``, for a caller that compares two runs."""
    if production_mesh and mesh is None:
        mesh = make_production_mesh(device=device)
    start = 0
    state = SessionState()
    sched_total = steps
    if resume:
        # the saved session is the source of truth for everything that
        # must match the original run (model/vfl/engine/noise configs and
        # the driver knobs stashed in the metadata); ``steps`` stays a
        # TOTAL step count, so resume at step k with steps=2k runs k more
        fed, params, state = Federation.restore(resume, device=device)
        meta = _driver_metadata(resume, state.metadata)
        arch, method = meta["arch"], fed.transport.method
        batch, seq, seed = meta["batch"], meta["seq"], meta["seed"]
        lr, schedule = meta["lr"], meta["schedule"]
        # rebuild the EXACT schedule the saved run trained under — a
        # decaying schedule must not silently re-stretch to the new total
        sched_total = meta.get("schedule_total_steps", steps)
        zoo_queries = fed.vfl.zoo_queries
        cfg = fed.model_cfg
        noise = fed.transport.noise
        start = state.step
        if steps <= start:
            raise ValueError(
                f"--steps {steps} is a total step count; the resumed "
                f"session is already at step {start}")
    else:
        cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
        arch = cfg.arch_id
        if use_reduced:
            cfg = reduced(cfg)
        cfg = cut_depth(cfg, n_layers)
        method = canonical_method(method)
        vfl = VFLConfig(mu=mu, lr_server=lr, lr_client=lr_client or lr,
                        zoo_queries=zoo_queries, active_rows_only=active_rows)
        fed = Federation.build(cfg, vfl,
                               EngineConfig(method=method, steps=steps,
                                            batch_size=batch),
                               seq_len=seq, noise=noise, device=device)
        if not lr_client:
            lr_client = _normalized_lr_client(fed, lr)
            fed.vfl = dataclasses.replace(vfl, lr_client=lr_client)

    dev = fed.device
    model = fed.model
    opt = sgd(make_schedule(schedule, lr, total_steps=sched_total))
    # the compiled step (jax.jit(step_fn, donate_argnums=(0, 1)) in the
    # JAX driver): captured on the card after its first call, placed or
    # not; the in-place update writes placed parameters where they are
    step_fn = fed.sync_step(opt, graph=True)
    if not resume:
        params = common.materialize(
            model.param_specs, torch.Generator(dev).manual_seed(seed),
            device=dev)
    if mesh is not None:
        params = common.place(params, model.param_specs, mesh, PARAM_RULES)
    opt_state = (state.opt_state if state.opt_state is not None
                 else opt.init(params))
    draws = StepDraws(seed, dev)
    if mesh is not None:
        opt_state = _place_state(opt_state, params, mesh)
        draws = PlacedDraws(draws, mesh)

    # deterministic batch stream: a resumed run skips the first ``start``
    # draws, so step i consumes the exact batch the uninterrupted run did
    data = BatchIterator(itertools.islice(
        lm_token_batches(seed + 1, cfg.vocab_size, batch, seq),
        start, steps), dev)

    modality = modality_inputs(cfg, batch, dev)
    losses, t0 = [], time.time()
    with _placed(mesh):
        for i, b in enumerate(data, start=start):
            b.update(modality)
            if mesh is not None:
                b = _place_batch(b, mesh)
            params, opt_state, out = step_fn(params, opt_state, b, i, draws)
            losses.append(_scalar(out.loss))
            if i % log_every == 0:
                print(f"step {i:5d} loss {losses[-1]:.4f} "
                      f"|g_c|={_scalar(out.grad_client_norm):.3e} "
                      f"|g_s|={_scalar(out.grad_server_norm):.3e}",
                      flush=True)

    wall = time.time() - t0
    n_new = steps - start
    # the Transport owns the wire: one ledger call covers this segment
    # (one activated client party — the embedding owner — per sync round),
    # EXTENDING the restored ledger so lifetime totals continue exactly
    ledger = fed.transport.account(batch=batch, embed=cfg.d_model,
                                   zoo_queries=zoo_queries, n_rounds=n_new,
                                   ledger=state.ledger)
    dp_releases = state.dp_releases
    if noise is not None:
        dp_releases += fed.transport.releases(n_rounds=n_new,
                                              zoo_queries=zoo_queries)
    result = {
        "arch": arch, "method": method, "steps": steps,
        "device": str(dev),
        "loss_first": losses[0], "loss_last": float(np.mean(losses[-5:])),
        "wall_s": round(wall, 1),
        "steps_per_s": round(n_new / wall, 2),
        "wire_bytes_per_round": ledger.total_bytes // max(steps, 1),
        "wire_has_gradients": ledger.transmits_gradients,
    }
    if resume:
        result["resumed_from"], result["start_step"] = resume, start
    if noise is not None:
        eps, delta = fed.transport.privacy_spent(dp_releases)
        result["dp_epsilon"], result["dp_delta"] = eps, delta
    if dev.type == "cuda" and hasattr(step_fn, "stats"):
        result["step_graph"] = step_fn.stats()
    if keep_params:
        result["params"] = params
    if checkpoint_path:
        _save_placed(mesh, lambda p, o: fed.save(
            checkpoint_path, p, step=steps, opt_state=o, ledger=ledger,
            dp_releases=dp_releases,
            metadata={"arch": arch, "batch": batch, "seq": seq,
                      "seed": seed, "lr": lr, "schedule": schedule,
                      "schedule_total_steps": sched_total}),
            params, opt_state)
        result["checkpoint"] = checkpoint_path
    return result


def _save_placed(mesh, save, params, opt_state) -> None:
    """``save(params, opt_state)`` with whole trees. With no mesh that is
    the trees as they are. On a mesh every rank gathers each DTensor leaf
    (``full_tensor()``: a collective, so every rank calls it), the mesh's
    first rank saves, and every rank waits at a barrier after it, so no
    rank goes on to read a directory still being written."""
    if mesh is None:
        save(params, opt_state)
        return
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    def whole(x):
        return x.full_tensor() if isinstance(x, DTensor) else x
    params, opt_state = tree_map(whole, (params, opt_state))
    if dist.get_rank() == int(mesh.mesh.flatten()[0]):
        save(params, opt_state)
    dist.barrier()


def _placed(mesh):
    """The step's context on a mesh: ``use_mesh`` (the models' constraint
    sites redistribute) and DTensor's implicit replication, under which a
    plain tensor the step makes itself (positions, masks, a zero) is
    taken as replicated on the mesh; with no mesh, nothing."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    stack = contextlib.ExitStack()
    stack.enter_context(use_mesh(mesh))
    stack.enter_context(implicit_replication())
    return stack


def _place_batch(b: dict, mesh) -> dict:
    """A batch's tensors placed on ``mesh``: the batch dim by
    ``ACT_RULES`` ("batch"), the rest replicated."""
    from torch.distributed.tensor import distribute_tensor

    def one(t):
        mesh_, pl = named_sharding(mesh, t.shape,
                                   ("batch",) + (None,) * (t.ndim - 1),
                                   ACT_RULES)
        return distribute_tensor(t, mesh_, pl, src_data_rank=None)
    return {k: one(v) for k, v in b.items()}


def _place_state(opt_state: dict, params, mesh) -> dict:
    """The optimizer state on ``mesh``: a tree shaped as ``params``
    (momentum, moments) placed as the parameters are, a scalar (the step
    count) replicated."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.core.draws import place_like

    def one(v):
        if isinstance(v, torch.Tensor):
            return distribute_tensor(v, mesh, [Replicate()] * mesh.ndim,
                                     src_data_rank=None)
        return place_like(v, params)
    return {k: one(v) for k, v in opt_state.items()}


def _scalar(x) -> float:
    """A step output as a Python float (a DTensor's full value)."""
    full = getattr(x, "full_tensor", None)
    return float(full() if full is not None else x)


def modality_inputs(cfg, batch: int, device) -> dict:
    """The stub frontends' inputs of a training batch, as the JAX driver
    feeds them: zero ``patch_embeds`` (B, n_vision_tokens, frontend_dim)
    for a VLM, zero ``frames`` (B, encoder_seq, frontend_dim) for an
    encoder-decoder, in bf16; nothing for the other families."""
    if cfg.family == "vlm":
        shape = (batch, cfg.n_vision_tokens, cfg.frontend_dim)
        return {"patch_embeds": torch.zeros(shape, dtype=torch.bfloat16,
                                            device=device)}
    if cfg.is_encoder_decoder:
        shape = (batch, cfg.encoder_seq, cfg.frontend_dim)
        return {"frames": torch.zeros(shape, dtype=torch.bfloat16,
                                      device=device)}
    return {}


def _normalized_lr_client(fed: Federation, lr: float) -> float:
    """Per-party lr (paper §VI-A-d tunes them separately): the sphere
    two-point estimator's norm scales ~√d·|∇|, so normalize the client lr
    by √d_client to keep update magnitudes FOO-comparable."""
    model = fed.model
    client_spec, _ = split_params(model.param_specs, model.client_keys)
    d_client = sum(math.prod(s.shape) for s in tree_leaves(client_spec))
    return lr / max(np.sqrt(d_client), 1.0)


def train_population(arch: str = "", *, steps: int = 60, batch: int = 8,
                     seq: int = 32, method: str = "cascaded",
                     n_clients: int = 4, rows: int = 128, lr: float = 0.05,
                     mu: float = 1e-3, lr_client: float = 0.0,
                     use_reduced: bool = True, seed: int = 0,
                     zoo_queries: int = 1, fault_drop: float = 0.0,
                     fault_latency_ms: float = 0.0,
                     fault_jitter_ms: float = 0.0, fault_seed: int = 0,
                     admission_ms: Optional[float] = None,
                     staleness_bound: Optional[int] = None,
                     until: int = 0, checkpoint_path: str = "",
                     noise: Optional[GaussianLossChannel] = None,
                     resume: str = "", device: DeviceLike = None) -> dict:
    """The population engine over the wire plane (``fed.run_population``).

    Unlike the sync driver, the round horizon is FIXED at first build
    (``steps`` = total rounds T; the activation schedule and fault stream
    are drawn over T once). ``until=k`` stops after round k and — with
    ``checkpoint_path`` — saves the full async-plane state, so a later
    ``resume`` continues the SAME horizon bitwise; ``steps`` is ignored
    on resume. ``device=None`` runs on the card and raises without one;
    pass ``device="cpu"`` for the CPU.
    """
    if resume:
        fed, params, state = Federation.restore(resume, device=device)
        meta = state.metadata
        if state.async_state is None or meta.get("engine") != "population":
            raise ValueError(
                f"checkpoint {resume!r} has no async plane — it was not "
                "written by the population driver")
        arch, rows, seq = meta["arch"], meta["rows"], meta["seq"]
        seed, n_clients = meta["seed"], fed.n_clients
        cfg = fed.model_cfg
        # the saved run's fault stream and admission policy, NOT the
        # caller's — resume-equivalence requires replaying the same plan
        fault = (FaultPlan(**meta["fault_plan"]) if meta.get("fault_plan")
                 else FaultPlan.none())
        population = (PopulationConfig(**meta["population"])
                      if meta.get("population") else None)
        noise = fed.transport.noise
    else:
        cfg = get_config(arch)
        if use_reduced:
            cfg = reduced(cfg)
        method = canonical_method(method)
        vfl = VFLConfig(mu=mu, lr_server=lr, lr_client=lr_client,
                        zoo_queries=zoo_queries)
        fed = Federation.build(cfg, vfl,
                               EngineConfig(method=method, steps=steps,
                                            batch_size=batch, seed=seed),
                               n_clients=n_clients, seq_len=seq,
                               noise=noise, device=device)
        if not lr_client:
            fed.vfl = dataclasses.replace(
                vfl, lr_client=_normalized_lr_client(fed, lr))
        params = fed.init_params(torch.Generator(fed.device).manual_seed(seed))
        state = SessionState()
        fault = FaultPlan(seed=fault_seed, drop=fault_drop,
                          latency_ms=fault_latency_ms,
                          jitter_ms=fault_jitter_ms)
        population = (PopulationConfig(admission_ms=admission_ms,
                                       staleness_bound=staleness_bound)
                      if (admission_ms or staleness_bound) else None)

    horizon = fed.engine.steps
    stop_at = min(until, horizon) if until else horizon
    # deterministic dataset: the resumed run regenerates the exact rows
    # the original drew, so every round samples identical batches
    toks = next(lm_token_batches(seed + 1, cfg.vocab_size, rows,
                                 seq))["tokens"]
    x_parts = vertical_partition(toks, n_clients)

    t0 = time.time()
    res = fed.run_population(
        params, x_parts, toks, fault_plan=fault, population=population,
        state=state.async_state, ledger=state.ledger,
        dp_releases=state.dp_releases,
        until=stop_at if stop_at < horizon else None)
    wall = time.time() - t0

    stats = res.stats
    executed = stats["rounds_executed"]
    result = {
        "arch": arch, "method": fed.transport.method,
        "engine": "population", "clients": n_clients,
        "device": str(fed.device),
        "rounds": int(res.state.step), "horizon": horizon,
        "loss_first": float(res.losses[0]),
        "loss_last": float(np.mean(res.losses[-5:])),
        "wall_s": round(wall, 1),
        "rounds_per_s": round(executed / max(wall, 1e-9), 2),
        "virtual_ms": stats["virtual_ms"],
        "participation": stats["participation"],
        "max_delay_seen": int(res.max_delay_seen),
        # the §V wire, measured (serialized frames) vs the formula
        "serialized_bytes": int(res.serialized_bytes),
        "formula_bytes": int(stats["formula_bytes"]),
        "control_bytes": int(res.control_bytes),
        "wire_has_gradients": res.transmits_gradients,
        "faults": {
            "drop": fault.drop, "latency_ms": fault.latency_ms,
            "jitter_ms": fault.jitter_ms,
            "uplink_drops": stats["uplink_drops"],
            "downlink_drops": stats["downlink_drops"],
            "stragglers": stats["stragglers"],
            "forced": stats["forced"],
            "degraded_rounds": stats["degraded_rounds"],
        },
    }
    if "graphs" in stats:
        result["graphs"] = stats["graphs"]
    if resume:
        result["resumed_from"] = resume
        result["start_step"] = int(state.async_state.step)
    if noise is not None:
        result["dp_epsilon"], result["dp_delta"] = res.epsilon, res.delta
    if checkpoint_path:
        fed.save(checkpoint_path, res.params, step=res.state.step,
                 ledger=res.ledger, dp_releases=res.dp_releases,
                 async_state=res.state,
                 metadata={"engine": "population", "arch": arch,
                           "rows": rows, "seq": seq, "seed": seed,
                           "fault_plan": {
                               "seed": fault.seed, "drop": fault.drop,
                               "latency_ms": fault.latency_ms,
                               "jitter_ms": fault.jitter_ms},
                           "population": (
                               None if population is None else
                               {"admission_ms": population.admission_ms,
                                "staleness_bound":
                                    population.staleness_bound})})
        result["checkpoint"] = checkpoint_path
    return result


def _driver_metadata(path: str, meta: dict) -> dict:
    """Validate the driver knobs ``fed.save`` stashed in the session."""
    missing = {"arch", "batch", "seq", "seed", "lr", "schedule"} - set(meta)
    if missing:
        raise ValueError(
            f"checkpoint {path!r} was not written by the train driver "
            f"(metadata missing {sorted(missing)})")
    return meta


def build_parser() -> argparse.ArgumentParser:
    """CLI (factored out so tests can assert the alias surface)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b",
                    choices=list_archs())
    # every spelling in the shared alias table is accepted; only the
    # canonical name travels past this boundary
    ap.add_argument("--method", default="cascaded",
                    choices=sorted(METHOD_ALIASES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--mu", type=float, default=1e-3)
    ap.add_argument("--zoo-queries", type=int, default=1)
    ap.add_argument("--active-rows", action="store_true")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = the "
                         "config's)")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--checkpoint", default="")
    # continue a saved session; --steps then means TOTAL steps (the run
    # does steps - saved_step more). Model/method/data knobs come from
    # the checkpoint, not the CLI.
    ap.add_argument("--resume", default="")
    ap.add_argument("--schedule", default="constant")
    ap.add_argument("--seed", type=int, default=0)
    # DP loss channel (0 = off): clip + per-release (ε, δ) target
    ap.add_argument("--dp-epsilon", type=float, default=0.0)
    ap.add_argument("--dp-delta", type=float, default=1e-5)
    ap.add_argument("--dp-clip", type=float, default=10.0)
    # --- population engine (the wire plane) ---------------------------
    # sync: the lockstep driver (default). population: N client parties
    # behind repro_torch.wire endpoints with fault injection and a
    # durable async plane (--until k + --checkpoint, then --resume).
    ap.add_argument("--engine", choices=("sync", "population"),
                    default="sync")
    ap.add_argument("--clients", type=int, default=4,
                    help="population: number of client parties")
    ap.add_argument("--rows", type=int, default=128,
                    help="population: dataset rows each round samples")
    ap.add_argument("--until", type=int, default=0,
                    help="population: stop after this round (0 = run the "
                         "full --steps horizon); pair with --checkpoint")
    ap.add_argument("--fault-drop", type=float, default=0.0)
    ap.add_argument("--fault-latency-ms", type=float, default=0.0)
    ap.add_argument("--fault-jitter-ms", type=float, default=0.0)
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--admission-ms", type=float, default=0.0,
                    help="population: straggler budget in virtual ms")
    ap.add_argument("--staleness-bound", type=int, default=0,
                    help="population: force-activate clients staler than "
                         "this many rounds")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    noise = (GaussianLossChannel(clip=args.dp_clip, epsilon=args.dp_epsilon,
                                 delta=args.dp_delta)
             if args.dp_epsilon > 0 else None)
    if args.engine == "population":
        res = train_population(
            args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
            method=canonical_method(args.method), n_clients=args.clients,
            rows=args.rows, lr=args.lr, mu=args.mu, seed=args.seed,
            use_reduced=args.reduced, zoo_queries=args.zoo_queries,
            fault_drop=args.fault_drop,
            fault_latency_ms=args.fault_latency_ms,
            fault_jitter_ms=args.fault_jitter_ms,
            fault_seed=args.fault_seed,
            admission_ms=args.admission_ms or None,
            staleness_bound=args.staleness_bound or None,
            until=args.until, checkpoint_path=args.checkpoint,
            noise=noise, resume=args.resume, device=args.device)
    else:
        res = train(args.arch, steps=args.steps, batch=args.batch,
                    seq=args.seq, method=canonical_method(args.method),
                    lr=args.lr, mu=args.mu, use_reduced=args.reduced,
                    seed=args.seed, zoo_queries=args.zoo_queries,
                    active_rows=args.active_rows,
                    production_mesh=args.production_mesh,
                    checkpoint_path=args.checkpoint,
                    schedule=args.schedule, noise=noise,
                    resume=args.resume, device=args.device,
                    n_layers=args.layers)
    print(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
