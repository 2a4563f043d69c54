"""Asynchronous VFL engine (paper §III-C / Alg. 1) — host-level protocol
simulation with exact staleness semantics.

Per global round t (matching Fig. 2):
  * a block of clients {m_t} is activated (schedule drawn from p_m,
    assumption IV.6; ``block_size=1`` recovers the paper's one-client
    rounds, larger blocks run several concurrent activations per round as
    one batched update)
  * each picks a sample batch i_t, computes c/ĉ and "uploads" them
  * the server evaluates h/ĥ against its *embedding table* — the latest
    (stale, delay τ_{i,m}) embeddings of all other clients (assumption IV.7)
  * the server does one local FOO step (ours/VAFL) or ZOO step (ZOO-VFL)
  * each activated client does one ZOO step (ours/ZOO-VFL) or FOO step
    (VAFL); concurrent clients see each other's STALE embeddings only
  * table rows (m, i_t) refresh; delay counters update per §III-C

The model plane is a :class:`repro_torch.core.adapters.ModelAdapter`; the
wire is a :class:`repro_torch.federation.Transport` (ledger, canonical
method names, DP noise hook on the loss downlink). Every random number
comes from a draw source (:mod:`repro_torch.core.draws`).

Where the JAX engine compiles the rounds into one ``lax.scan``, the port
captures ONE round as a CUDA graph on static buffers and replays it once
a round (on the CPU the same round body runs in a Python loop; see
:func:`_make_runner`): the block is a leading batch dim (no ``vmap``),
the round index, the losses and the per-round max delays stay on the
device and are read once at the end, and nothing syncs the host inside a
round. The run updates its own copies of the parameters, table and delay
counters in place (the caller's tensors are untouched).

Synchronous baselines (Split-Learning, Syn-ZOO-VFL) activate *all* clients
every round with fresh embeddings (no table staleness).

:func:`run` is the back-compat entry; it wraps a
``repro_torch.federation.Federation`` session.

Sharded client block (``mesh=`` path)
-------------------------------------
With ``EngineConfig.mesh_shards = D`` the session builds a 1-D
``("data",)`` ``DeviceMesh`` over D ranks of a ``torch.distributed``
group (:func:`repro_torch.launch.mesh.make_client_mesh`), one process per
shard: NCCL on the card (each rank on ``cuda:{local_rank}``), gloo on the
CPU. Every rank runs the same program on its shard, as ``shard_map``'s
body runs once per device in the JAX engine: it holds the replicated
client and server parameters, its ``M / D`` rows of the (M, n, e)
embedding table (partitioned through the "clients" logical axis of
:mod:`repro_torch.sharding.rules`) and its ``R / D`` rows of the round's
activated block. Per round the only collectives are

  * two ``all_gather``s at the server-loss boundary (the wire of Fig.
    2): the shards' stale table slices and the block's fresh embeddings,
    each in global row order, and
  * one ``all_reduce(SUM)`` a client leaf, replicating the block's sparse
    client-parameter updates: activated clients are distinct, so each row
    is one shard's value plus zeros and the sum is float-exact.

The block's client ids are replicated (every rank holds the round's
schedule row), so the ids and the rows' mask are built on every rank
with no collective, where the JAX engine gathers the ids and psums the
mask.

The server update runs identically on every rank. Every rank draws the
WHOLE block's directions and noise from its draw source and keeps its own
rows, so each rank consumes the source as the single-device engine does
and the sharded run draws what the unsharded one draws: D = 1 is bitwise
the unsharded engine, and a larger D could differ only where a batched
product's rounding depends on how many block rows it covers (on the CPU
none does: D = 2 and 4 are bitwise too).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import graphs
from repro_torch.analysis import marks, tags
from repro_torch.configs.base import VFLConfig
from repro_torch.core import zoo
from repro_torch.core.adapters import ModelAdapter, tabular_adapter
from repro_torch.core.draws import RoundDraws, copy_into, make_schedule
from repro_torch.core.methods import SYNC_METHODS
from repro_torch.core.partition import (tree_leaves, tree_map,
                                        tree_unflatten)
from repro_torch.core.privacy import Ledger
from repro_torch.sharding.rules import PARAM_RULES, mesh_axes, resolve_spec

__all__ = ["CLIENT_AXIS", "AsyncPlaneState", "EngineConfig", "EngineResult",
           "PopulationConfig", "PopulationResult", "make_schedule", "run",
           "run_population"]

CLIENT_AXIS = "data"        # mesh axis the client block shards over


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    method: str = "cascaded"   # any spelling in repro_torch.core.methods
    steps: int = 1000
    batch_size: int = 64
    seed: int = 0
    # >1 activates several clients per round (drawn without replacement)
    # and runs their updates as one batched block
    block_size: int = 1
    # route the client's clean+perturbed fan-out through the adapter's
    # fused lanes hook (e.g. the zoo_dual_matmul CUDA kernel)
    use_lanes: bool = False
    # >0 shards the client block + table rows over that many ranks of a
    # torch.distributed group (Federation builds the ("data",) mesh via
    # launch.mesh.make_client_mesh; must divide both block_size and the
    # client count)
    mesh_shards: int = 0


@dataclasses.dataclass
class EngineResult:
    params: dict
    losses: np.ndarray          # (T,)
    max_delay_seen: int
    mean_delay: float
    # wire accounting (q-aware privacy ledger owned by the Transport)
    wire_bytes: int = 0
    transmits_gradients: bool = False
    ledger: Optional[Ledger] = None
    # DP budget spent on the loss downlink ((inf, 0) without a noise
    # channel: structurally safe wire, no formal guarantee)
    epsilon: float = math.inf
    delta: float = 0.0
    # the captured round's CUDA graph (a run on the card): capture_s,
    # nodes, kernel_nodes, node_kinds, kernels (its kernel nodes by
    # name), replays, replay_s (the replays' host time, synchronised) and
    # launches_a_replay; None where the rounds looped
    round_graph: Optional[dict] = None


def _validate_mesh(mesh, sync: bool, method: str, block: int, M: int):
    """``mesh``: a ``DeviceMesh`` or a ``{axis: size}`` mapping."""
    if sync:
        raise ValueError(
            f"mesh sharding only applies to asynchronous methods, not "
            f"{method!r} (sync rounds have no client block to shard)")
    shape = mesh_axes(mesh)
    if CLIENT_AXIS not in shape:
        raise ValueError(
            f"engine mesh needs a {CLIENT_AXIS!r} axis, got "
            f"{shape} (use repro_torch.launch.mesh.make_client_mesh)")
    D = shape[CLIENT_AXIS]
    if block % D:
        raise ValueError(
            f"block_size={block} not divisible by the mesh "
            f"{CLIENT_AXIS!r} axis ({D} shards)")
    if M % D:
        raise ValueError(
            f"n_clients={M} not divisible by the mesh {CLIENT_AXIS!r} "
            f"axis ({D} shards): the embedding table rows cannot split")


def run(cfg_engine: EngineConfig, vfl: VFLConfig, params, x_parts, y,
        *, probs=None, adapter: Optional[ModelAdapter] = None,
        device=None, draws=None, mesh=None) -> EngineResult:
    """Back-compat wrapper over the ``repro_torch.federation`` session.

    x_parts: (M, n, f) vertically partitioned features; y: (n,) labels.
    Runs on the card unless ``device="cpu"``; ``draws`` overrides the
    session's default :class:`~repro_torch.core.draws.TorchDraws`.
    ``mesh``: optional ``("data",)`` mesh — new callers set
    ``EngineConfig.mesh_shards`` instead and let the session build it."""
    from repro_torch.federation import Federation
    fed = Federation.build(
        adapter if adapter is not None else tabular_adapter(),
        vfl, cfg_engine, device=device, mesh=mesh)
    return fed.run(params, x_parts, y, probs=probs, draws=draws)


def _shard_rows(mesh, M: int, table_spec) -> tuple:
    """(this rank's shard index, the rows of the (M, n, e) table it
    holds, the global index of its first row) under ``table_spec``."""
    shard = mesh.get_local_rank(CLIENT_AXIS)
    if table_spec[:1] == (CLIENT_AXIS,):
        rows = M // mesh.size(0)
        return shard, rows, shard * rows
    return shard, M, 0


def _session_run(adapter: ModelAdapter, transport, vfl: VFLConfig,
                 cfg_engine: EngineConfig, params, x_parts, y, *,
                 draws, probs=None, mesh=None,
                 graph: bool = True, kept=None) -> EngineResult:
    """The engine proper, driven by a ``Federation`` session, with the
    params and data already on the session's device. ``graph=False``
    loops the round body on the card too; ``kept`` keeps the round graph
    across calls (see :func:`_make_runner`)."""
    M = x_parts.shape[0]
    T, bs = cfg_engine.steps, cfg_engine.batch_size
    sync = transport.method in SYNC_METHODS
    block = 1 if sync else cfg_engine.block_size
    stats: dict = {}
    (params, table, delays), (losses, maxd) = _rounds(
        adapter, transport, vfl, cfg_engine, params, x_parts, y,
        draws=draws, probs=probs, mesh=mesh, graph=graph, stats=stats,
        kept=kept)

    # the Transport owns the q-gating (queries only fan out on ZOO wires)
    ledger = transport.account(batch=bs, embed=int(table.shape[-1]),
                               zoo_queries=vfl.zoo_queries,
                               n_clients=M if sync else block, n_rounds=T)
    eps, delta = transport.privacy_spent(transport.releases(
        n_rounds=T, n_clients=M if sync else block,
        zoo_queries=vfl.zoo_queries))

    # the run's only device->host reads
    return EngineResult(params=params, losses=losses.cpu().numpy(),
                        max_delay_seen=int(maxd.max()),
                        mean_delay=float(delays.double().mean()),
                        wire_bytes=ledger.total_bytes,
                        transmits_gradients=ledger.transmits_gradients,
                        ledger=ledger, epsilon=eps, delta=delta,
                        round_graph=stats or None)


def _rounds(adapter: ModelAdapter, transport, vfl: VFLConfig,
            cfg_engine: EngineConfig, params, x_parts, y, *, draws,
            probs=None, mesh=None, graph: bool = True, stats=None,
            kept=None):
    """The run's draws, initial table and round loop: ``((params, table,
    delays), (losses, max_delays))`` on the device. With a ``mesh`` the
    table is this rank's rows of it; everything else is replicated.
    ``graph``, ``stats`` and ``kept``: see :func:`_make_runner`."""
    method = transport.method
    M, n, _ = x_parts.shape
    T, bs = cfg_engine.steps, cfg_engine.batch_size
    sync = method in SYNC_METHODS
    if sync and cfg_engine.use_lanes:
        raise ValueError(
            f"use_lanes only applies to asynchronous ZOO-client methods, "
            f"not {method!r} (the sync step has no per-client "
            "fan-out to route through the fused kernel)")
    if sync and cfg_engine.block_size != 1:
        raise ValueError(
            f"block_size={cfg_engine.block_size} has no meaning for the "
            f"synchronous method {method!r} (every client is "
            "activated every round)")
    block = 1 if sync else cfg_engine.block_size
    if mesh is not None:
        _validate_mesh(mesh, sync, method, block, M)
        if mesh.device_type != x_parts.device.type:
            raise ValueError(
                f"a {mesh.device_type} mesh cannot shard tensors on "
                f"{x_parts.device} (NCCL on the card, gloo on the CPU)")

    schedule = draws.schedule(T, M, probs, block)            # (T, block)
    sample_idx = draws.sample_indices(T, bs, n)              # (T, bs)
    # server-side table of latest client embeddings per sample (Fig. 2)
    table0 = adapter.client_forward(params["clients"], x_parts)  # (M, n, e)
    delays0 = torch.zeros((M, n), dtype=torch.int32, device=x_parts.device)
    table_spec = None
    if mesh is not None:
        # partition the table rows via the "clients" logical axis rule
        table_spec = resolve_spec(mesh, table0.shape, adapter.table_logical,
                                  PARAM_RULES)
        _, rows, lo = _shard_rows(mesh, M, table_spec)
        table0 = table0[lo:lo + rows]

    runner = _make_runner(adapter, transport, vfl, sync, block,
                          cfg_engine.use_lanes, mesh, table_spec)
    return runner(params, table0, delays0, schedule, sample_idx, draws,
                  x_parts, y, graph=graph, stats=stats, kept=kept)


# ------------------------------------------------------------------------

def _make_runner(adapter: ModelAdapter, transport, vfl: VFLConfig,
                 sync: bool, block: int, use_lanes: bool, mesh=None,
                 table_spec=None):
    """The round loop for one (adapter, transport, vfl, block, mesh)
    protocol: ``run_rounds(params, table0, delays0, schedule, sample_idx,
    draws, x_parts, y, *, graph=True, stats=None, kept=None) -> ((params,
    table, delays), (losses, max_delays))``. With a ``mesh``, ``table0``
    and the returned table are this rank's rows (see
    :func:`_make_sharded_step`).

    The counterpart of the JAX engine's ``lax.scan`` under ``jax.jit``:
    ONE round body on static buffers (the params tree, the table, the
    delays, the round index t as a (1,) int64 device tensor, and (T,)
    buffers for the losses and the per-round max delays). The body reads
    its schedule and sample rows at the device t, draws through a
    :class:`~repro_torch.core.draws.RoundDraws` over ``draws``, runs the
    step, copies the server's new leaves into the captured parameters,
    keeps the delay bookkeeping, writes the loss and ``delays.max()`` at
    t and advances t. On a CUDA device round 0 runs eagerly, the body is
    captured as a CUDA graph (:class:`repro_torch.graphs.StepGraph`; a
    failed capture raises) and replayed T - 1 times, each replay after
    :meth:`RoundDraws.fill` has put round t's draws into its buffers;
    ``stats`` (a dict) then takes the graph's capture seconds, nodes (by
    kind, and its kernels by name), replays and the replays' host time.
    On the CPU (gloo included), under the certifier's trace and with
    ``graph=False`` (an internal switch: no config field, flag or entry
    point sets it) the same body runs in a Python loop. Either form runs
    the same kernels in the same order on the same draws, so the results
    are bitwise equal.

    The sharded round (``mesh``, NCCL on the card) is captured as the
    unsharded one is, as the JAX engine's ``lax.scan`` compiles its
    ``shard_map``ped body: its two all-gathers and its all-reduce a
    client leaf are recorded in the graph with the kernels around them
    and replayed with them. Round 0 runs eagerly first, so the NCCL
    communicator exists before the capture (a lazy first collective
    would create it inside one). The body's collectives are the
    synchronous ``torch.distributed`` calls, and the card's torch (2.11)
    captures them in its default (global) capture mode with nothing set
    on the process group. At one rank NCCL records no kernel: it copies
    an out-of-place gather and does nothing for an in-place all-reduce.
    The body reads nothing to the host: the shard index and rows are host
    arithmetic on the mesh (:func:`_shard_rows`), and its device fills
    take no host constant (a capture refuses copies from pageable host
    memory).

    ``kept`` (a :class:`repro_torch.graphs.Kept`) keeps the round body,
    its static buffers, its recorded draws and its graph across calls, as
    the JAX engine's cached runner keeps its compiled scan: keyed by the
    signature of (params, table0, delays0, schedule, sample_idx, x_parts,
    y), the mesh, the protocol and whether the round is captured. A call
    of a kept key copies its inputs into the key's buffers, resets t,
    points the recorded draws at its ``draws`` and replays all T rounds
    (on the CPU loops them): nothing is captured, and ``stats`` reads
    ``kept`` True, ``capture_s`` 0.0 and this call's replays. The key
    owns its inputs (cloned at its first call), and what the call
    returns is a copy of the key's buffers."""
    # what a kept key's graph depends on beside its inputs' signature
    # (the adapter and the transport by identity: the kept body holds them)
    protocol = (id(adapter), id(transport), vfl, sync, block, use_lanes,
                repr(table_spec))
    if sync:
        step_fn = _make_sync_step(adapter, transport, vfl)
    elif mesh is not None:
        step_fn = _make_sharded_step(adapter, transport, vfl, use_lanes,
                                     mesh, block, table_spec)
    else:
        step_fn = _make_async_step(adapter, transport, vfl, use_lanes)

    def build(params, table0, delays0, inputs, draws) -> dict:
        """The round body on static buffers: ``st`` (the params tree, the
        table, the delays, t, the losses and max delays), the draws ``rd``
        and ``body``, which closes over these and ``inputs`` (schedule,
        sample_idx, x_parts, y)."""
        schedule, sample_idx, x_parts, y = inputs
        T = schedule.shape[0]
        rd = RoundDraws(draws)
        st = {"params": tree_map(torch.clone, params),
              "table": table0.clone(), "delays": delays0.clone(),
              "t": torch.zeros((1,), dtype=torch.int64,
                               device=x_parts.device),
              "losses": None, "maxd": None}
        if mesh is not None:
            # one spare row past the owned ones takes the refresh writes
            # of block rows another shard owns (no host sync to drop them)
            table = st["table"]
            st["table"] = torch.cat(
                [table, table.new_zeros((1,) + table.shape[1:])])

        def body():
            """One round on the static buffers ``st``: its schedule and
            sample rows read at the device round index, its draws from
            ``rd``, its results written in place."""
            t = st["t"]
            m_blk = schedule.index_select(0, t)[0]
            idx = sample_idx.index_select(0, t)[0]
            new, table, loss = step_fn(st["params"], st["table"], m_blk,
                                       idx, rd.t, rd, x_parts, y)
            rd.done()
            if table is not st["table"]:
                raise RuntimeError("the round step must update the table "
                                   "in place")
            # the new leaves into the captured parameters; those a round
            # updated in place (an async round's server, the unsharded
            # one's clients) stay as they are
            tree_map(lambda old, nw: None if nw is old else old.copy_(nw),
                     st["params"], new)
            # delay bookkeeping (§III-C): activated (m,i) resets, others +1
            delays = st["delays"]
            if sync:
                delays.zero_()
            else:
                delays += 1
                # a device zero (a Python 0 would be a host copy, which a
                # capture refuses)
                delays.index_put_((m_blk[:, None], idx[None, :]),
                                  delays.new_zeros(()))
            if st["losses"] is None:        # the first round, never captured
                st["losses"] = loss.new_empty((T,))
                st["maxd"] = delays.new_empty((T,))
            st["losses"].index_copy_(0, t, loss.reshape(1))
            st["maxd"].index_copy_(0, t, delays.max().reshape(1))
            t.add_(1)
        return {"st": st, "rd": rd, "body": body, "graph": None,
                "inputs": inputs}

    def refill(k: dict, params, table0, delays0, inputs, draws) -> None:
        """A kept key's buffers set for a new call: its inputs copied in,
        the round index and the spare table row zeroed, the draws pointed
        at the call's source."""
        st = k["st"]
        for dst, src in zip(tree_leaves((st["params"], k["inputs"])),
                            tree_leaves((params, inputs))):
            if src is not dst:
                copy_into(dst, src)
        table = st["table"]
        copy_into(table[:table0.shape[0]], table0)
        table[table0.shape[0]:].zero_()
        copy_into(st["delays"], delays0)
        st["t"].zero_()
        k["rd"].source = draws

    def run_rounds(params, table0, delays0, schedule, sample_idx, draws,
                   x_parts, y, *, graph: bool = True, stats=None,
                   kept=None):
        T = schedule.shape[0]
        inputs = (schedule, sample_idx, x_parts, y)
        captured = (graph and T > 1 and x_parts.device.type == "cuda"
                    and not marks.tracing())
        key = k = None
        if kept is not None and not marks.tracing():
            key = (graphs.signature((params, table0, delays0) + inputs),
                   mesh, protocol, captured)
            k = kept.get(key)
        if k is not None:
            refill(k, params, table0, delays0, inputs, draws)
        else:
            if key is not None:
                # the key owns its inputs: a later call copies into them
                inputs = tree_map(torch.clone, inputs)
            k = build(params, table0, delays0, inputs, draws)
            if key is not None:
                kept.put(key, k)
        rd, g = k["rd"], k["graph"]
        if g is not None:           # a kept key's graph: all T replayed
            spent = g.timed_replays(T, rd.fill)
            if stats is not None:
                stats.update(g.stats(), kernels=g.kernel_names(),
                             capture_s=0.0, replays=T, replay_s=spent,
                             kept=True)
        elif captured:
            rd.fill(0)
            g = k["graph"] = graphs.StepGraph(k["body"], x_parts.device)
            g.timed_replays(T - 1, lambda i: rd.fill(i + 1))
            if stats is not None:
                stats.update(g.stats(), kernels=g.kernel_names(),
                             kept=False)
        else:
            for t in range(T):
                rd.fill(t)
                k["body"]()
        st = k["st"]
        table = st["table"]
        if mesh is not None:
            table = table[:-1]
        out = (st["params"], table, st["delays"]), (st["losses"], st["maxd"])
        if key is not None:
            # the key's buffers take the next call's rounds
            out = tree_map(torch.clone, out)
        return out

    return run_rounds


def _replace_rows(c_stale, m_blk, c_lanes):
    """c_stale (M, bs, e) with row m_blk[r] replaced by c_lanes[r, l] ->
    (R, L, M, bs, e): each block row sees only its own fresh lanes."""
    M = c_stale.shape[0]
    onehot = torch.arange(M, device=m_blk.device)[None, :] == m_blk[:, None]
    return torch.where(onehot[:, None, :, None, None],
                       c_lanes[:, :, None], c_stale)


def _make_client_grad_fns(adapter: ModelAdapter, transport,
                          vfl: VFLConfig, use_lanes: bool):
    """Gradient closures for the activated client block (R rows at once).

    Every scalar loss the client consumes passes through
    ``transport.downlink`` — the identity for a bare wire, clip+noise under
    a DP channel. Adapters with a ``row_mask`` hook restrict the ZOO
    perturbation to the rows the batch touches."""
    if use_lanes and adapter.client_lanes is None:
        raise ValueError(
            f"adapter {adapter.name!r} has no client_lanes hook; "
            "run with use_lanes=False")
    if transport.noise is not None and vfl.zoo_unrolled_oracle:
        raise ValueError(
            "the DP loss channel requires the stacked lane path "
            "(vfl.zoo_unrolled_oracle=False); the unrolled per-query loop "
            "is a noise-free numerical test oracle")
    q = vfl.zoo_queries

    @tags.wire("up", accounted_by="Transport.account", kind="embedding",
               reason="the unrolled ZOO oracle: the same clean + q "
                      "perturbed embeddings as the stacked lanes, one "
                      "query at a time (noise-free test oracle)")
    def _unrolled(server, c_stale, m_blk, client_blk, x_blk, yb, raw, mask):
        rows = []
        for r in range(m_blk.shape[0]):
            def c_loss(cm, r=r):
                cf = adapter.client_forward(cm, x_blk[r])
                return adapter.server_loss(
                    server, c_stale.index_put((m_blk[r:r + 1],), cf[None]),
                    yb)
            g, _, _ = zoo.zoo_gradient(
                tree_map(lambda a: a[r], raw), c_loss,
                tree_map(lambda a: a[r], client_blk), vfl.mu, vfl.zoo_dist,
                q, row_mask=(None if mask is None
                             else tree_map(lambda a: a[r, 0], mask)),
                unrolled=True)
            rows.append(g)
        return tree_map(lambda *gs: torch.stack(gs), *rows)

    @tags.wire("up", accounted_by="Transport.account", kind="embedding",
               reason="ZOO uplink: clean + q perturbed embeddings; the "
                      "loss downlink is sanitized via transport.downlink")
    def client_zoo_grad(server, c_stale, m_blk, client_blk, x_blk, yb, t,
                        draws):
        """ZOO (ours / zoo-vfl): only losses cross the wire."""
        R = m_blk.shape[0]
        row = tree_map(lambda a: a[0], client_blk)        # one row's shapes
        raw = draws.client_directions(t, row, R, q)       # (R, q, ...)
        mask = None
        if adapter.row_mask is not None:
            mask = tree_map(lambda m: m.unsqueeze(1),
                            adapter.row_mask(client_blk, x_blk))
        if vfl.zoo_unrolled_oracle:
            return _unrolled(server, c_stale, m_blk, client_blk, x_blk, yb,
                             raw, mask)
        u_stack, d_eff = zoo.sample_directions(raw, row, q, vfl.zoo_dist,
                                               mask)
        phi = zoo.phi_factor(vfl.zoo_dist, d_eff)
        if use_lanes:
            # stacked fan-out through the adapter's fused dual pass (the
            # zoo_dual_matmul CUDA kernel for the tabular client)
            c_lanes = adapter.client_lanes(client_blk, u_stack, vfl.mu,
                                           x_blk)
        else:
            lanes = zoo.stack_lanes(client_blk, u_stack, vfl.mu,
                                    batch_dims=1)
            c_lanes = adapter.client_forward(lanes, x_blk.unsqueeze(1))
        c_lanes = marks.wire_boundary(c_lanes, kind="emb", direction="up")
        losses = adapter.server_loss(
            server, _replace_rows(c_stale, m_blk, c_lanes), yb)  # (R, 1+q)
        losses = transport.downlink(
            losses,
            None if transport.noise is None else draws.noise(t, R, 1 + q))
        return zoo.grad_from_losses(u_stack, losses[:, 1:], losses[:, 0],
                                    vfl.mu, phi)

    @tags.wire("up", accounted_by="Transport.account", kind="embedding",
               reason="FOO uplink: one clean embedding per round")
    @tags.wire("down", accounted_by="Transport.account",
               kind="partial_derivative",
               reason="VAFL baseline is DECLARED leaky: the server returns "
                      "dL/dc_m and the ledger reports "
                      "transmits_gradients=True for it (paper §V contrast)")
    def client_foo_grad(server, c_stale, m_blk, client_blk, x_blk, yb):
        """VAFL (privacy-leaky): server sends ∂L/∂c_m; client backprops.
        Rows are independent, so the gradient of the summed row losses is
        each row's own gradient."""
        def loss_sum(cb):
            cf = adapter.client_forward(cb, x_blk)            # (R, bs, e)
            return adapter.server_loss(
                server, _replace_rows(c_stale, m_blk, cf[:, None]),
                yb).sum()
        # grad_mark: these ARE first-order cotangents crossing client-ward;
        # certifying vafl must fail IF301 (the negative control)
        return marks.grad_mark(_value_and_grad(loss_sum, client_blk)[1])

    return client_zoo_grad, client_foo_grad


def _value_and_grad(loss_fn, tree, *args):
    """(loss, grad tree) of ``loss_fn(tree, *args)`` over ``tree``'s
    leaves, by autograd: the LM server's kernels are autograd Functions
    whose backward runs through their plain versions, which
    ``torch.func`` transforms do not take. A leaf the loss does not
    reach gets a zero gradient, as ``jax.grad`` gives."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tree)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(tree, leaves), *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(tree, grads)


def _server_update(adapter: ModelAdapter, method: str, vfl: VFLConfig,
                   server, c_batch, yb, t, draws):
    """One server step on the round's (stale + fresh-block) embeddings.

    The new leaves are written into ``server``'s, one at a time
    (``copy_`` rounds to the leaf's type), so no second server tree is
    alive. Returns (server, h); see :func:`_server_grad`."""
    g_server, h = _server_grad(adapter, method, vfl, server, c_batch, yb, t,
                               draws)
    for w, g in zip(tree_leaves(server), tree_leaves(g_server)):
        w.copy_(w - vfl.lr_server * g)
    return server, h


def _server_grad(adapter: ModelAdapter, method: str, vfl: VFLConfig,
                 server, c_batch, yb, t, draws):
    """The server's gradient and loss h on the round's embeddings. FOO
    methods backprop locally (Eq. 4); zoo-vfl estimates with the same
    q-point two-point oracle the client uses (vfl.zoo_queries — the
    server is a ZOO party too)."""
    if method in ("cascaded", "vafl"):
        h, g_server = _value_and_grad(adapter.server_loss, server,
                                      c_batch.detach(), yb)
        # the engine's one sanctioned server-FOO point: mark the
        # cotangents so the certifier (IF301) can prove nothing derived
        # from them reaches a client-bound output except through the
        # scalar-loss bottleneck
        g_server = marks.grad_mark(g_server)
    else:  # zoo-vfl: server trains itself with ZOO too
        def s_loss(s):
            return adapter.server_loss(s, c_batch, yb)
        g_server, h, _ = zoo.zoo_gradient(
            draws.server_directions(t, server, vfl.zoo_queries), s_loss,
            server, vfl.mu, vfl.zoo_dist, vfl.zoo_queries,
            unrolled=vfl.zoo_unrolled_oracle)
    return g_server, h


def _make_async_step(adapter: ModelAdapter, transport, vfl: VFLConfig,
                     use_lanes: bool):
    """One asynchronous round for the activated client block {m_t}."""
    method = transport.method
    client_zoo_grad, client_foo_grad = _make_client_grad_fns(
        adapter, transport, vfl, use_lanes)

    def step(params, table, m_blk, idx, t, draws, x_parts, y):
        clients, server = params["clients"], params["server"]
        yb = y[idx]
        client_blk = tree_map(lambda a: a[m_blk], clients)       # (R, ...)
        x_blk = x_parts[m_blk[:, None], idx[None, :]]            # (R, bs, f)

        # stale embeddings of all clients for this batch; fresh per block
        c_stale = table[:, idx]                                  # (M, bs, e)
        c_fresh = adapter.client_forward(client_blk, x_blk)     # (R, bs, e)
        c_batch = c_stale.index_put((m_blk,), c_fresh)

        # ---- server update (sees every activated client fresh) ----------
        server, h = _server_update(adapter, method, vfl, server, c_batch,
                                   yb, t, draws)

        # ---- client updates (concurrent: each sees others STALE) --------
        if method == "vafl":
            g_blk = client_foo_grad(server, c_stale, m_blk, client_blk,
                                    x_blk, yb)
        else:
            g_blk = client_zoo_grad(server, c_stale, m_blk, client_blk,
                                    x_blk, yb, t, draws)
        new_blk = tree_map(
            lambda cm, g: (cm - vfl.lr_client * g).to(cm.dtype), client_blk,
            g_blk)
        tree_map(lambda all_, new: all_.index_put_((m_blk,), new), clients,
                 new_blk)

        # refresh the table with the block's (pre-update) fresh embeddings
        table[m_blk[:, None], idx[None, :]] = c_fresh
        return {"clients": clients, "server": server}, table, h

    return step


class _ShardRows:
    """One shard's view of a round's draw source: every rank draws the
    WHOLE block's client directions and noise (so every rank consumes the
    source as the single-device engine does) and keeps rows [lo, hi)."""

    def __init__(self, draws, block: int, lo: int, hi: int) -> None:
        self.draws, self.block, self.lo, self.hi = draws, block, lo, hi

    def client_directions(self, t, template, n_rows, q):
        full = self.draws.client_directions(t, template, self.block, q)
        return tree_map(lambda a: a[self.lo:self.hi], full)

    def noise(self, t, n_rows, n):
        return self.draws.noise(t, self.block, n)[self.lo:self.hi]


def _gather_rows(x: torch.Tensor, D: int, group) -> torch.Tensor:
    """All-gather ``x`` (rows, ...) from the D shards along dim 0, in
    shard order."""
    out = x.new_empty((x.shape[0] * D,) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _make_sharded_step(adapter: ModelAdapter, transport, vfl: VFLConfig,
                       use_lanes: bool, mesh, block: int, table_spec):
    """Sharded asynchronous round, run by every rank of ``mesh``: the
    block's R activated clients split R/D per rank, the (M, n, e) table
    splits M/D rows per rank, and cross-rank traffic happens only at the
    server-loss boundary (two all-gathers) plus the all-reduces that
    replicate the sparse client updates. The step's ``table`` carries one
    spare row past this rank's own (see :func:`_make_runner`). See the
    module docstring for the equivalence guarantees."""
    method = transport.method
    client_zoo_grad, client_foo_grad = _make_client_grad_fns(
        adapter, transport, vfl, use_lanes)
    D = mesh.size(0)
    group = mesh.get_group(CLIENT_AXIS)
    rows_local = block // D

    def step(params, table_l, m_blk, idx, t, draws, x_parts, y):
        clients, server = params["clients"], params["server"]
        M = _stack_rows(clients)
        shard, rows_table, offset = _shard_rows(mesh, M, table_spec)
        lo = shard * rows_local
        m_blk_l = m_blk[lo:lo + rows_local]
        yb = y[idx]
        # local block rows gather from the REPLICATED client param stack
        client_blk = tree_map(lambda a: a[m_blk_l], clients)
        x_blk = x_parts[m_blk_l[:, None], idx[None, :]]  # (R/D, bs, f)

        # ---- server-loss boundary: the only gathers of the round --------
        # each shard contributes its table rows' stale embeddings and its
        # block rows' fresh embeddings; shard order == global row order,
        # so the gathered fresh rows line up with the replicated m_blk
        c_stale = _gather_rows(table_l[:rows_table, idx], D, group)
        c_fresh = adapter.client_forward(client_blk, x_blk)  # (R/D, bs, e)
        c_fresh_all = _gather_rows(c_fresh, D, group)        # (R, bs, e)
        c_batch = c_stale.index_put((m_blk,), c_fresh_all)

        # ---- server update: replicated compute, identical per shard -----
        server, h = _server_update(adapter, method, vfl, server, c_batch,
                                   yb, t, draws)

        # ---- client updates: each shard fans out ONLY its block rows ----
        if method == "vafl":
            g_blk = client_foo_grad(server, c_stale, m_blk_l, client_blk,
                                    x_blk, yb)
        else:
            g_blk = client_zoo_grad(
                server, c_stale, m_blk_l, client_blk, x_blk, yb, t,
                _ShardRows(draws, block, lo, lo + rows_local))
        new_blk = tree_map(
            lambda cm, g: (cm - vfl.lr_client * g).to(cm.dtype), client_blk,
            g_blk)

        # replicate the sparse update: activated clients are DISTINCT, so
        # each global row is written by exactly one shard and the sum of
        # one value plus zeros is float-exact (== index_put_); every rank
        # holds the whole block, so the rows' mask needs no collective
        # (a fill, not ``mask[m_blk] = True``: that copies a host scalar,
        # which a capture refuses)
        mask = torch.zeros(M, dtype=torch.bool, device=x_parts.device)
        mask.index_fill_(0, m_blk, True)

        def replicate_rows(all_, new):
            buf = torch.zeros_like(all_)
            buf[m_blk_l] = new
            dist.all_reduce(buf, group=group)
            m = mask.view((-1,) + (1,) * (all_.ndim - 1))
            return torch.where(m, buf, all_)

        clients = tree_map(replicate_rows, clients, new_blk)

        # ---- local table refresh: keep only the rows this shard owns ----
        # (another shard's rows land in the spare row past this shard's)
        local_m = m_blk - offset
        safe_m = torch.where((local_m >= 0) & (local_m < rows_table),
                             local_m, rows_table)
        table_l[safe_m[:, None], idx[None, :]] = c_fresh_all
        return {"clients": clients, "server": server}, table_l, h

    return step


def _stack_rows(clients) -> int:
    """Leading (M) axis of the stacked client parameter tree."""
    return tree_leaves(clients)[0].shape[0]


def _make_sync_step(adapter: ModelAdapter, transport, vfl: VFLConfig):
    """Synchronous rounds: Split-Learning (FOO) / Syn-ZOO-VFL."""
    method = transport.method

    def step(params, table, m_blk, idx, t, draws, x_parts, y):
        xb = x_parts[:, idx, :]                          # (M, bs, f)
        yb = y[idx]

        if method == "split":
            grads, h = torch.func.grad_and_value(adapter.global_loss)(
                params, xb, yb)
            # Split-Learning backprops THROUGH the boundary: its client
            # grads are cotangents (declared leaky; certifying it must
            # fail IF301, the first-order negative control)
            grads = marks.grad_mark(grads)
        else:  # syn-zoo: every party (server + each client) does ZOO
            grads, h, _ = zoo.zoo_gradient(
                draws.global_directions(t, params, vfl.zoo_queries),
                lambda p: adapter.global_loss(p, xb, yb), params,
                vfl.mu, vfl.zoo_dist, vfl.zoo_queries,
                unrolled=vfl.zoo_unrolled_oracle,
                loss_transform=(None if vfl.zoo_unrolled_oracle
                                else transport.downlink))
        params = tree_map(lambda w, g: (w - vfl.lr_server * g).to(w.dtype),
                          params, grads)
        return params, table, h

    return step


# ===================================================== population plane ====

@dataclasses.dataclass(frozen=True)
class PopulationConfig:
    """Population-scale knobs on top of the sampled activation schedule.

    ``admission_ms``: a delivered uplink slower than this virtual budget
    is a straggler — the round proceeds without that client (its stale
    table row serves instead; it retries at its next activation).
    ``staleness_bound``: a registered client whose table rows are older
    than this many rounds is force-activated, replacing sampled block
    members from the end (VAFL's bounded-delay assumption, enforced by
    admission instead of assumed)."""
    admission_ms: Optional[float] = None
    staleness_bound: Optional[int] = None


@dataclasses.dataclass
class AsyncPlaneState:
    """The population engine's FULL mutable state between rounds —
    everything a checkpoint must carry for a killed run to resume
    bitwise: the embedding table, the delay counters, the per-client
    activity clock for bounded-staleness forcing, the virtual wall clock,
    and the fault counters. The draws need no state: every stream
    (schedule, batches, directions, noise, faults) is a pure function of
    (seed, round). ``table`` is a CPU tensor (bfloat16 for a bf16 model);
    the on-disk format is the JAX package's, so either package loads a
    plane the other saved."""
    step: int
    table: torch.Tensor
    delays: np.ndarray
    last_active: np.ndarray
    clock_ms: float = 0.0
    max_delay_seen: int = 0
    counters: dict = dataclasses.field(default_factory=dict)
    seed: int = 0

    def save(self, path: str) -> None:
        from repro_torch.checkpoint.io import save_checkpoint
        save_checkpoint(path, {
            "table": torch.as_tensor(self.table).cpu(),
            "delays": torch.from_numpy(np.asarray(self.delays, np.int32)),
            "last_active": torch.from_numpy(
                np.asarray(self.last_active, np.int32))},
            step=self.step,
            metadata={"clock_ms": float(self.clock_ms),
                      "max_delay_seen": int(self.max_delay_seen),
                      "counters": dict(self.counters),
                      "seed": int(self.seed)})

    @classmethod
    def load(cls, path: str) -> "AsyncPlaneState":
        from repro_torch.checkpoint.io import load_tree
        tree, step, meta = load_tree(path)
        return cls(step=int(step), table=tree["table"],
                   delays=tree["delays"].numpy().astype(np.int32),
                   last_active=tree["last_active"].numpy().astype(np.int32),
                   clock_ms=float(meta["clock_ms"]),
                   max_delay_seen=int(meta["max_delay_seen"]),
                   counters=dict(meta["counters"]),
                   seed=int(meta["seed"]))


@dataclasses.dataclass
class PopulationResult(EngineResult):
    """:class:`EngineResult` plus the wire plane's measurements."""
    state: Optional[AsyncPlaneState] = None
    serialized_bytes: int = 0      # measured frame bytes (§V data plane)
    overhead_bytes: int = 0        # serialization overhead over payloads
    control_bytes: int = 0         # act/skip/collect/params frames
    dp_releases: int = 0
    stats: dict = dataclasses.field(default_factory=dict)


def _population_fns(adapter: ModelAdapter, transport, vfl: VFLConfig,
                    device, *, graph: bool = True):
    """The server-side compute of the population engine (the worker side
    lives in ``repro_torch.wire.worker``): the in-process round's ops,
    split at the wire — the server consumes UPLOADED embedding lanes
    instead of running ``client_forward``. Each takes the round index
    ``t`` and the run's draw source last.

    The counterpart of the JAX engine's ``jax.jit(server_update),
    jax.jit(losses_fn)``: with ``graph`` each is a
    :class:`repro_torch.graphs.GraphedFn` on ``device`` (one memory pool
    for both), captured as a CUDA graph for each new key — the admitted
    block's length for ``server_update`` (a degraded round's 0
    included); ``losses_fn`` takes the client ``m`` and block row ``r``
    as (1,) int64 device indices, so one key serves every row — and
    replayed for a key seen before; on the CPU the same bodies loop on
    their static buffers. ``server_update`` writes the new server leaves
    into the tree it is given (donated: the run passes its own tree every
    round). ``graph=False`` returns the bodies themselves (the eager
    comparison and the certifier's trace)."""
    method = transport.method
    q = vfl.zoo_queries

    @tags.party("server")
    def server_update(server, c_stale, c_fresh, m_adm, yb, t, draws):
        c_batch = c_stale.index_put((m_adm,), c_fresh)
        return _server_update(adapter, method, vfl, server, c_batch, yb, t,
                              draws)

    @tags.party("server")
    @tags.wire("down", accounted_by="Transport.account_wire", kind="loss",
               reason="the (1+q) scalar losses of one admitted client, "
                      "sanitized by transport.downlink before they leave")
    @torch.no_grad()
    def losses_fn(server, c_stale, m, emb_lanes, yb, r, n_rows, t, draws):
        """The (1+q) lanes' server losses for block row r (client m), both
        (1,) int64 device indices: the server loss over a (1+q, M, bs, e)
        stack, one forward a lane for the LM adapter (its kernels cannot
        be vmapped)."""
        # the lanes arrived as "emb" wire frames: anchor the uplink
        emb_lanes = marks.wire_boundary(emb_lanes, kind="emb",
                                        direction="up")
        lanes = c_stale.unsqueeze(0).repeat(1 + q, 1, 1, 1)
        lanes.index_copy_(1, m, emb_lanes.unsqueeze(1))
        losses = adapter.server_loss(server, lanes, yb)
        noise = (None if transport.noise is None
                 else draws.noise(t, n_rows, 1 + q).index_select(0, r)[0])
        return transport.downlink(losses, noise)

    if not graph:
        return server_update, losses_fn
    pool = (torch.cuda.graph_pool_handle()
            if torch.device(device).type == "cuda" else None)
    return (graphs.GraphedFn(server_update, device, donate=(0,), pool=pool),
            graphs.GraphedFn(losses_fn, device, donate=(0,), pool=pool))


def _fresh_counters() -> dict:
    return {"rounds": 0, "activations": 0, "admitted": 0,
            "uplink_drops": 0, "stragglers": 0, "downlink_drops": 0,
            "forced": 0, "degraded_rounds": 0, "retransmit_frames": 0,
            "dead_parties": 0}


def _dtype_name(t: torch.Tensor) -> str:
    """The numpy-style name of a tensor's dtype ("float32", "bfloat16"),
    as the ledger records a measured frame's payload."""
    return str(t.dtype).replace("torch.", "")


def run_population(adapter: ModelAdapter, transport, vfl: VFLConfig,
                   cfg_engine: EngineConfig, params, x_parts, y, *,
                   draws, probs=None, fault_plan=None,
                   population: Optional[PopulationConfig] = None,
                   channels: Optional[dict] = None,
                   state: Optional[AsyncPlaneState] = None,
                   ledger: Optional[Ledger] = None, dp_releases: int = 0,
                   until: Optional[int] = None,
                   stop_workers: bool = True,
                   wire_timeout_s: Optional[float] = None,
                   graph: bool = True) -> PopulationResult:
    """The asynchronous protocol over a REAL wire with fault injection.

    ``params``, ``x_parts`` and ``y`` are on the engine's device (the
    ``Federation`` session puts them there). ``draws`` is a population
    draw source (``repro_torch.core.draws``: the protocol plus
    ``row_key`` and ``directions``).

    Every registered client (M = ``x_parts.shape[0]``) sits behind a
    ``repro_torch.wire`` endpoint — in-proc :class:`LoopbackBackend`
    workers on the engine's device by default; pass ``channels={m:
    backend}`` to place party m behind an already-connected endpoint
    (e.g. a :class:`SocketBackend` whose worker process runs
    ``ClientWorker.serve`` with the matching ``directions``). Per round
    the sampled block is activated over the wire (act -> 1+q embedding
    frames up -> 1+q loss frames down), the ledger meters each frame's
    ACTUAL serialized bytes (``Message.wired``; the payload formula kept
    as the cross-check), and ``fault_plan`` decides drops/latency/retries
    in deterministic virtual time. Graceful degradation: a dropped or
    straggling client simply misses the round (its stale embeddings
    serve; the server still steps).

    ``state``/``until`` make the plane durable: ``until=k`` stops after
    round k and returns the full :class:`AsyncPlaneState`; passing that
    state back (with the SAME configs/seed and the collected params)
    continues bitwise. ``ledger``/``dp_releases`` extend a restored run's
    accounting the same way.

    With ``FaultPlan.none()``, no population knobs and the same
    :class:`~repro_torch.core.draws.RowDraws` the result is bitwise equal
    to ``Federation.run`` (losses, params, table, delays).

    CRASH SEMANTICS for remote (``channels``-placed) parties: a party
    whose wire dies mid-round — the process was ``kill -9``'d, the frame
    stream corrupted, or ``wire_timeout_s`` elapsed without a frame — is
    DECLARED DEAD. It then misses every later activation (its stale
    embeddings keep serving), the round never hangs, and at collect time
    its parameter row falls back to the initial params the engine holds.
    ``counters["dead_parties"]`` reports the toll. Loopback parties never
    take this path — their failures are real bugs and stay fail-fast.

    The server's two functions run through :func:`_population_fns`, and
    each loopback worker's uplink and update through graphs of its own
    (``ClientWorker``): on the card from CUDA graphs keyed by shape
    (``stats["graphs"]`` holds their readings, the workers' under
    ``"workers"`` by party), on the CPU in a loop; ``graph=False`` (an
    internal switch: no config field, flag or entry point sets it) runs
    them all eagerly. Either form runs the same kernels on the same
    draws, so the results are bitwise equal.
    """
    from repro_torch.core.privacy import Message
    from repro_torch.wire import codec
    from repro_torch.wire.backend import (LoopbackBackend, WireClosed,
                                          WireTimeout)
    from repro_torch.wire.codec import FrameCorruption
    from repro_torch.wire.faults import FaultPlan
    from repro_torch.wire.worker import ClientWorker

    method = transport.method
    if method in SYNC_METHODS or method == "vafl":
        raise ValueError(
            f"run_population drives the asynchronous ZOO wire; {method!r} "
            "is synchronous or sends gradients down (use run())")
    if cfg_engine.use_lanes:
        raise ValueError(
            "use_lanes routes the fan-out through a fused server-side "
            "kernel; the wire worker computes its own lanes")
    if cfg_engine.mesh_shards:
        raise ValueError("the population engine shards by PROCESS, not by "
                         "device mesh; set mesh_shards=0")
    if vfl.zoo_unrolled_oracle:
        raise ValueError("the wire protocol speaks the stacked lane path; "
                         "zoo_unrolled_oracle is the in-process test oracle")
    if not hasattr(draws, "row_key"):
        raise ValueError(
            f"{type(draws).__name__} is not a population draw source (it "
            "has no row_key/directions); use core.draws.RowDraws")

    plan = fault_plan if fault_plan is not None else FaultPlan.none()
    pop = population if population is not None else PopulationConfig()
    M, n = x_parts.shape[:2]
    T, bs = cfg_engine.steps, cfg_engine.batch_size
    block = cfg_engine.block_size
    q = vfl.zoo_queries
    dev = x_parts.device

    schedule_h = draws.schedule(T, M, probs, block).cpu().numpy()
    idx_all = draws.sample_indices(T, bs, n).to(dev)
    idx_h = idx_all.cpu().numpy()

    # the run's own server tree, updated in place every round
    server = tree_map(torch.clone, params["server"])
    if state is None:
        table = adapter.client_forward(params["clients"], x_parts)
        delays = np.zeros((M, n), np.int32)
        last_active = np.zeros((M,), np.int32)
        clock_ms, maxd, start = 0.0, 0, 0
        counters = _fresh_counters()
    else:
        if state.seed != cfg_engine.seed:
            raise ValueError(
                f"resume state was produced under seed {state.seed}, "
                f"engine runs seed {cfg_engine.seed} — the schedule/RNG "
                "streams would diverge from the saved run")
        table = state.table.to(dev).clone()
        delays = np.array(state.delays, np.int32)
        last_active = np.array(state.last_active, np.int32)
        clock_ms, maxd = float(state.clock_ms), int(state.max_delay_seen)
        counters = {**_fresh_counters(), **state.counters}
        start = int(state.step)
    stop_at = T if until is None else min(int(until), T)
    if not start <= stop_at:
        raise ValueError(f"resume step {start} is past until={stop_at}")
    ledger = ledger if ledger is not None else Ledger()
    control_bytes = int(counters.pop("control_bytes", 0))
    noise_on = transport.noise is not None

    # ---- wire up the population: loopback workers for unplaced parties --
    channels = dict(channels or {})
    remote = frozenset(channels)    # parties that can actually die
    dead: set = set()
    local_workers: dict = {}
    for m in range(M):
        if m not in channels:
            eng_end, wk_end = LoopbackBackend.pair()
            local_workers[m] = ClientWorker(
                adapter, vfl, tree_map(lambda a: a[m], params["clients"]),
                x_parts[m], m, wk_end, directions=draws.directions,
                graph=graph)
            # the worker's graphs captured before the rounds, not in them
            local_workers[m].warm(bs, draws.row_key(0, 0))
            channels[m] = eng_end

    # failures a dying REMOTE party can surface through its channel;
    # anything else (protocol bugs, engine errors) stays fail-fast
    _WIRE_DEATH = (WireClosed, WireTimeout, FrameCorruption,
                   ConnectionError, OSError)

    def _mark_dead(m):
        dead.add(m)
        counters["dead_parties"] += 1

    def _pump(m):
        if m in local_workers:
            local_workers[m].pump()

    def _send_control(m, msg):
        nonlocal control_bytes
        control_bytes += channels[m].send(msg)
        _pump(m)

    def _recv(m):
        if m in remote and wire_timeout_s is not None:
            return channels[m].recv(timeout=wire_timeout_s)
        return channels[m].recv()

    server_update, losses_fn = _population_fns(adapter, transport, vfl,
                                               dev, graph=graph)
    # losses_fn's device indices: client m is rows[m:m + 1]
    rows_d = torch.arange(max(M, block), device=dev)
    losses_out = []

    for t in range(start, stop_at):
        m_blk = [int(m) for m in schedule_h[t]]
        idx = idx_h[t]
        idx_d = idx_all[t]
        yb = y[idx_d]
        counters["rounds"] += 1

        # ---- bounded-staleness forcing: overdue clients preempt the ----
        # ---- sampled block (most-stale first, replacing from the end) --
        if pop.staleness_bound is not None:
            in_blk = set(m_blk)
            overdue = sorted(
                ((t - int(last_active[m]), m) for m in range(M)
                 if m not in in_blk
                 and t - int(last_active[m]) > pop.staleness_bound),
                key=lambda sm: (-sm[0], sm[1]))
            for i, (_, m) in enumerate(overdue[:len(m_blk)]):
                m_blk[len(m_blk) - 1 - i] = m
            counters["forced"] += min(len(overdue), len(m_blk))

        # ---- phase 1: activate the block, collect uplinked lanes --------
        admitted = []               # (r, m, emb lanes as CPU tensors)
        emb_meter: list = [[] for _ in m_blk]   # (Message, copies)
        loss_meter: list = [[] for _ in m_blk]
        round_ms = 0.0
        for r, m in enumerate(m_blk):
            counters["activations"] += 1
            if m in dead:
                # declared dropout: the party misses the round outright —
                # no frames, no metering, stale embeddings keep serving
                counters["uplink_drops"] += 1
                continue
            lanes = []
            try:
                _send_control(m, codec.WireMessage(
                    "act", "server", t, {"party": m},
                    {"idx": idx.astype(np.int32),
                     "key": draws.row_key(t, r)}))
                for _ in range(1 + q):
                    msg, nb = _recv(m)
                    if msg.tag != "emb":  # pragma: no cover - protocol
                        raise ValueError(
                            f"expected emb frame, got {msg.tag!r}")
                    arr = msg.payload["c"]
                    lanes.append(arr)
                    up = plan.delivery(t, m, "up")
                    emb_meter[r].append((Message(
                        "client", "embedding", tuple(arr.shape),
                        _dtype_name(arr), wired=nb), up.attempts))
            except _WIRE_DEATH:
                if m not in remote:
                    raise       # loopback failures are bugs, not churn
                _mark_dead(m)
                counters["uplink_drops"] += 1
                emb_meter[r] = []   # nothing usable arrived — meter none
                continue
            counters["retransmit_frames"] += (up.attempts - 1) * (1 + q)
            if not up.ok:
                counters["uplink_drops"] += 1
                _send_control(m, codec.WireMessage(
                    "skip", "server", t, {"reason": "drop"}))
            elif (pop.admission_ms is not None
                  and up.elapsed_ms > pop.admission_ms):
                counters["stragglers"] += 1
                _send_control(m, codec.WireMessage(
                    "skip", "server", t, {"reason": "straggler"}))
            else:
                admitted.append((r, m, lanes))
            round_ms = max(round_ms, up.elapsed_ms)

        # ---- phase 2: server step on stale table + admitted fresh -------
        c_stale = table[:, idx_d]
        if admitted:
            m_adm = torch.tensor([m for _, m, _ in admitted], device=dev)
            c_fresh = torch.stack([l[0] for _, _, l in admitted]).to(dev)
        else:
            counters["degraded_rounds"] += 1
            m_adm = torch.zeros((0,), dtype=torch.int64, device=dev)
            c_fresh = table.new_zeros((0, bs, table.shape[-1]))
        server, h = server_update(server, c_stale, c_fresh, m_adm, yb, t,
                                  draws)
        # a graph's output holds until the next replay: keep a copy
        losses_out.append(h.clone())

        # ---- phase 3: loss downlinks to admitted clients ----------------
        for r, m, lanes in admitted:
            emb_lanes = torch.stack(lanes).to(dev)
            losses_h = losses_fn(server, c_stale, rows_d[m:m + 1],
                                 emb_lanes, yb, rows_d[r:r + 1], len(m_blk),
                                 t, draws).cpu()
            down = plan.delivery(t, m, "down")
            try:
                for lane in range(1 + q):
                    nb = channels[m].send(codec.WireMessage(
                        "loss", "server", t,
                        {"lane": lane, "delivered": bool(down.ok)},
                        {"h": losses_h[lane]}))
                    loss_meter[r].append((Message(
                        "server", "loss", (), _dtype_name(losses_h),
                        wired=nb), down.attempts))
            except _WIRE_DEATH:
                # died between uplink and downlink: the server already
                # consumed its fresh embeddings (they were real), the
                # client just never gets this round's losses
                if m not in remote:
                    raise
                _mark_dead(m)
                counters["downlink_drops"] += 1
                continue
            _pump(m)
            counters["retransmit_frames"] += (down.attempts - 1) * (1 + q)
            if noise_on:
                dp_releases += 1 + q
            if not down.ok:
                counters["downlink_drops"] += 1
            round_ms = max(round_ms, plan.delivery(t, m, "up").elapsed_ms
                           + down.elapsed_ms)

        # ---- ledger: per client in block order, uplinks then downlinks --
        for r in range(len(m_blk)):
            for msg_rec, copies in emb_meter[r] + loss_meter[r]:
                transport.account_wire(msg_rec, copies=copies,
                                       ledger=ledger)
        counters["admitted"] += len(admitted)

        # ---- phase 4: table/delay/clock bookkeeping ---------------------
        delays += 1
        if admitted:
            adm_rows = np.asarray([m for _, m, _ in admitted])
            table[m_adm[:, None], idx_d[None, :]] = c_fresh
            delays[adm_rows[:, None], idx[None, :]] = 0
            last_active[adm_rows] = t
        maxd = max(maxd, int(delays.max()))
        clock_ms += round_ms

    # ---- collect the population's parameters back over the wire --------
    rows = []
    for m in range(M):
        fallback = tree_map(lambda a: a[m], params["clients"])
        if m in dead:
            rows.append(fallback)   # best knowledge: the initial row
            continue
        try:
            _send_control(m, codec.WireMessage("collect", "server",
                                               stop_at))
            msg, nb = _recv(m)
            if msg.tag != "params":  # pragma: no cover - protocol error
                raise ValueError(f"expected params frame, got {msg.tag!r}")
            control_bytes += nb
            rows.append(tree_map(lambda t: t.to(dev),
                                 codec.unflatten_tree(msg.payload)))
        except _WIRE_DEATH:
            if m not in remote:
                raise
            _mark_dead(m)
            rows.append(fallback)
    clients = tree_map(lambda *rs: torch.stack(rs), *rows)
    if stop_workers:
        for m in range(M):
            if m in dead:
                continue
            try:
                _send_control(m, codec.WireMessage("stop", "server",
                                                   stop_at))
            except _WIRE_DEATH:
                if m not in remote:
                    raise
                _mark_dead(m)

    counters["control_bytes"] = control_bytes
    out_state = AsyncPlaneState(
        step=stop_at, table=table.cpu(), delays=delays,
        last_active=last_active, clock_ms=clock_ms, max_delay_seen=maxd,
        counters=counters, seed=cfg_engine.seed)
    eps, delta = transport.privacy_spent(dp_releases)
    executed = stop_at - start
    formula = transport.account(batch=bs, embed=int(table.shape[-1]),
                                zoo_queries=q, n_clients=block,
                                n_rounds=executed)
    stats = {
        "rounds_executed": executed,
        "virtual_ms": clock_ms,
        "formula_bytes": formula.total_bytes,
        "participation": (counters["admitted"]
                          / max(counters["activations"], 1)),
        **{k: counters[k] for k in ("uplink_drops", "stragglers",
                                    "downlink_drops", "forced",
                                    "degraded_rounds",
                                    "retransmit_frames",
                                    "dead_parties")},
    }
    if dev.type == "cuda" and hasattr(server_update, "stats"):
        stats["graphs"] = {"server_update": server_update.stats(),
                           "losses_fn": losses_fn.stats(),
                           "workers": {m: w.stats()
                                       for m, w in local_workers.items()}}
    losses = (torch.stack(losses_out).cpu().numpy() if losses_out
              else np.zeros((0,), np.float32))
    return PopulationResult(
        params={"clients": clients, "server": server},
        losses=losses, max_delay_seen=maxd,
        mean_delay=float(torch.from_numpy(delays).double().mean()),
        wire_bytes=ledger.total_bytes,
        transmits_gradients=ledger.transmits_gradients, ledger=ledger,
        epsilon=eps, delta=delta, state=out_state,
        serialized_bytes=ledger.serialized_bytes,
        overhead_bytes=ledger.overhead_bytes, control_bytes=control_bytes,
        dp_releases=dp_releases, stats=stats)
