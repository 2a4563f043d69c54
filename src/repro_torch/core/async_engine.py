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

Where the JAX engine compiled the rounds into one ``lax.scan``, the port
runs a Python loop of eager device work: the block is a leading batch dim
(no ``vmap``), the losses and per-round max delays stay on the device and
are read once at the end, and nothing syncs the host inside a round. The
run updates its own copies of the parameters, table and delay counters in
place (the caller's tensors are untouched).

Synchronous baselines (Split-Learning, Syn-ZOO-VFL) activate *all* clients
every round with fresh embeddings (no table staleness).

:func:`run` is the back-compat entry; it wraps a
``repro_torch.federation.Federation`` session.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis import tags
from repro_torch.configs.base import VFLConfig
from repro_torch.core import zoo
from repro_torch.core.adapters import ModelAdapter, tabular_adapter
from repro_torch.core.draws import make_schedule
from repro_torch.core.methods import SYNC_METHODS
from repro_torch.core.partition import tree_map
from repro_torch.core.privacy import Ledger

__all__ = ["EngineConfig", "EngineResult", "make_schedule", "run"]


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


def run(cfg_engine: EngineConfig, vfl: VFLConfig, params, x_parts, y,
        *, probs=None, adapter: Optional[ModelAdapter] = None,
        device=None, draws=None) -> EngineResult:
    """Back-compat wrapper over the ``repro_torch.federation`` session.

    x_parts: (M, n, f) vertically partitioned features; y: (n,) labels.
    Runs on the card unless ``device="cpu"``; ``draws`` overrides the
    session's default :class:`~repro_torch.core.draws.TorchDraws`."""
    from repro_torch.federation import Federation
    fed = Federation.build(
        adapter if adapter is not None else tabular_adapter(),
        vfl, cfg_engine, device=device)
    return fed.run(params, x_parts, y, probs=probs, draws=draws)


def _session_run(adapter: ModelAdapter, transport, vfl: VFLConfig,
                 cfg_engine: EngineConfig, params, x_parts, y, *,
                 draws, probs=None) -> EngineResult:
    """The engine proper, driven by a ``Federation`` session, with the
    params and data already on the session's device."""
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

    schedule = draws.schedule(T, M, probs, block)            # (T, block)
    sample_idx = draws.sample_indices(T, bs, n)              # (T, bs)
    # server-side table of latest client embeddings per sample (Fig. 2)
    table0 = adapter.client_forward(params["clients"], x_parts)  # (M, n, e)
    delays0 = torch.zeros((M, n), dtype=torch.int32, device=x_parts.device)

    runner = _make_runner(adapter, transport, vfl, sync, block,
                          cfg_engine.use_lanes)
    (params, _, delays), (losses, maxd) = runner(
        params, table0, delays0, schedule, sample_idx, draws, x_parts, y)

    # the Transport owns the q-gating (queries only fan out on ZOO wires)
    ledger = transport.account(batch=bs, embed=int(table0.shape[-1]),
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
                        ledger=ledger, epsilon=eps, delta=delta)


# ------------------------------------------------------------------------

def _make_runner(adapter: ModelAdapter, transport, vfl: VFLConfig,
                 sync: bool, block: int, use_lanes: bool):
    """The round loop for one (adapter, transport, vfl, block) protocol:
    ``run_rounds(params, table0, delays0, schedule, sample_idx, draws,
    x_parts, y) -> ((params, table, delays), (losses, max_delays))``."""
    if sync:
        step_fn = _make_sync_step(adapter, transport, vfl)
    else:
        step_fn = _make_async_step(adapter, transport, vfl, use_lanes)

    def run_rounds(params, table0, delays0, schedule, sample_idx, draws,
                   x_parts, y):
        params = tree_map(torch.clone, params)
        table, delays = table0.clone(), delays0.clone()
        losses, maxd = [], []
        for t in range(schedule.shape[0]):
            m_blk, idx = schedule[t], sample_idx[t]
            params, table, loss = step_fn(params, table, m_blk, idx, t,
                                          draws, x_parts, y)
            # delay bookkeeping (§III-C): activated (m,i) resets, others +1
            if sync:
                delays.zero_()
            else:
                delays += 1
                delays[m_blk[:, None], idx[None, :]] = 0
            losses.append(loss)
            maxd.append(delays.max())
        return (params, table, delays), (torch.stack(losses),
                                         torch.stack(maxd))

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
        return torch.func.grad(loss_sum)(client_blk)

    return client_zoo_grad, client_foo_grad


def _server_update(adapter: ModelAdapter, method: str, vfl: VFLConfig,
                   server, c_batch, yb, t, draws):
    """One server step on the round's (stale + fresh-block) embeddings.

    Returns (new_server, h). FOO methods backprop locally (Eq. 4);
    zoo-vfl estimates with the same q-point two-point oracle the client
    uses (vfl.zoo_queries — the server is a ZOO party too)."""
    if method in ("cascaded", "vafl"):
        g_server, h = torch.func.grad_and_value(adapter.server_loss)(
            server, c_batch.detach(), yb)
    else:  # zoo-vfl: server trains itself with ZOO too
        def s_loss(s):
            return adapter.server_loss(s, c_batch, yb)
        g_server, h, _ = zoo.zoo_gradient(
            draws.server_directions(t, server, vfl.zoo_queries), s_loss,
            server, vfl.mu, vfl.zoo_dist, vfl.zoo_queries,
            unrolled=vfl.zoo_unrolled_oracle)
    server = tree_map(lambda w, g: (w - vfl.lr_server * g).to(w.dtype),
                      server, g_server)
    return server, h


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
        for k, cm in client_blk.items():
            clients[k][m_blk] = (cm - vfl.lr_client * g_blk[k]).to(cm.dtype)

        # refresh the table with the block's (pre-update) fresh embeddings
        table[m_blk[:, None], idx[None, :]] = c_fresh
        return {"clients": clients, "server": server}, table, h

    return step


def _make_sync_step(adapter: ModelAdapter, transport, vfl: VFLConfig):
    """Synchronous rounds: Split-Learning (FOO) / Syn-ZOO-VFL."""
    method = transport.method

    def step(params, table, m_blk, idx, t, draws, x_parts, y):
        xb = x_parts[:, idx, :]                          # (M, bs, f)
        yb = y[idx]

        if method == "split":
            grads, h = torch.func.grad_and_value(adapter.global_loss)(
                params, xb, yb)
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
