"""The client party's side of the wire protocol.

A :class:`ClientWorker` owns ONE client's parameters and feature slice
and speaks the population engine's message protocol over any
:class:`~repro_torch.wire.backend.WireBackend`:

    act      engine -> client   batch indices + this round's row key
    emb      client -> engine   1 clean + q perturbed embeddings (§V uplink)
    loss     engine -> client   1 clean + q perturbed scalar losses
    skip     engine -> client   round aborted (drop / straggler) — clear state
    collect  engine -> client   request the parameter tree
    params   client -> engine   the flattened parameter tree
    ping     engine -> client   liveness probe (heartbeat)
    pong     client -> engine   liveness reply (echoes the ping's nonce)
    stop     engine -> client   exit the serve loop

A crashed worker restarts from the last party-scoped checkpoint:
:meth:`ClientWorker.from_checkpoint` re-materializes its parameter row
from the ``client_XX/`` directory a ``fed.save`` wrote.

The compute path is the in-process engine's lane decomposition
(``zoo.sample_directions`` → ``stack_lanes`` → ``client_forward`` over
the lanes → ``grad_from_losses``), split at the party boundary: the
worker evaluates the (1+q) client forwards, the engine the (1+q) server
losses. Both sides make the same ops on the same draws, which is what
makes a zero-fault wire run bitwise equal to ``Federation.run``.

The draw seam: the ``act`` frame's ``key`` payload stands for this
round's (q, ...) direction stack, and ``directions(key, template, q)``
turns it into that stack. The default, :func:`repro_torch.core.draws.
seed_directions`, reads the (seed, t, row) words the port's engine sends
(:class:`~repro_torch.core.draws.RowDraws`); a worker serving the JAX
package's engine, which sends threefry key data, is given a source that
draws what that engine expects.

The worker never sees the server's parameters, any other client's
embeddings, or a gradient — its only inputs from the wire are batch
indices, a row key, and (1+q) scalar losses that already passed
``Transport.downlink`` on the server side.

Ported from the JAX package's ``wire/worker.py``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import graphs
from repro_torch.analysis import tags
from repro_torch.checkpoint.io import load_tree
from repro_torch.configs.base import VFLConfig
from repro_torch.core import zoo
from repro_torch.core.adapters import ModelAdapter
from repro_torch.core.draws import seed_directions
from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.wire import codec
from repro_torch.wire.backend import WireBackend, WireClosed, WireTimeout
from repro_torch.wire.codec import WireMessage

Directions = Callable[[Any, Any, int], Any]


def _client_fns(adapter: ModelAdapter,
                vfl: VFLConfig) -> Tuple[Callable, Callable]:
    """The client compute of one (adapter, vfl): the uplink fan-out and
    the ZOO update — the in-process engine's ops on one block row."""
    q = vfl.zoo_queries

    @tags.party("client")
    @torch.no_grad()
    def uplink(client_m, xb, raw):
        """(1+q)-lane embedding fan-out for one round from the round's raw
        N(0, 1) draws ``raw`` ((q, *leaf) leaves); lane 0 is the clean
        forward — the embedding the engine's table refresh stores."""
        mask = (adapter.row_mask(client_m, xb)
                if adapter.row_mask is not None else None)
        u_stack, d_eff = zoo.sample_directions(raw, client_m, q,
                                               vfl.zoo_dist, mask)
        phi = zoo.phi_factor(vfl.zoo_dist, d_eff)
        lanes = zoo.stack_lanes(client_m, u_stack, vfl.mu)
        emb_lanes = adapter.client_forward(lanes, xb)
        return u_stack, phi, emb_lanes

    @tags.party("client")
    @torch.no_grad()
    def update(client_m, u_stack, phi, losses):
        """One ZOO step from the downlinked (1+q) scalar losses."""
        g = zoo.grad_from_losses(u_stack, losses[1:], losses[0], vfl.mu,
                                 phi)
        return tree_map(lambda w, gg: (w - vfl.lr_client * gg).to(w.dtype),
                        client_m, g)

    return uplink, update


def _worker_fns(uplink: Callable, update: Callable, device: torch.device,
                graph: bool) -> Tuple[Callable, Callable]:
    """One worker's compiled uplink and update, the counterparts of the
    JAX worker's ``jax.jit(uplink)`` and jitted SGD apply:
    ``uplink(client_m, x_m, idx, raw, t, draws)`` gathers the batch rows
    ``idx`` (a device index) of the feature slice ``x_m`` and fans the
    row out from the raw draws ``raw``; ``update(client_m, u_stack, phi,
    losses, t, draws)`` writes the ZOO step into ``client_m`` in place
    and returns it. ``t`` and ``draws`` are the ``GraphedFn`` protocol's:
    the draws enter as ``raw``, a copied input. With ``graph`` each is a
    :class:`repro_torch.graphs.GraphedFn` of this worker alone on
    ``device`` (``client_m`` and ``x_m`` donated: the worker passes its
    own trees every call, and a tree donated to two workers' graphs
    would be copied across them; the update's ``u_stack`` donated too:
    once warmed, the worker passes the uplink's replayed output, the
    same tensors every round, which the update's graph then reads where
    they are): on the card a CUDA graph replayed from
    the second call on, on the CPU the same bodies in a loop. The two
    share one memory pool: the worker runs them in turn, and the uplink
    is captured first, so the update's temporaries never take the
    uplink's outputs, which the update reads. Without ``graph``, the
    bodies themselves (the eager comparison). Either form runs the same
    kernels, so the worker's row is bitwise the same."""
    def uplink_(client_m, x_m, idx, raw, t, draws):
        return uplink(client_m, x_m[idx], raw)

    def update_(client_m, u_stack, phi, losses, t, draws):
        new = update(client_m, u_stack, phi, losses)
        for old, nw in zip(tree_leaves(client_m), tree_leaves(new)):
            old.copy_(nw)
        return client_m

    if not graph:
        return uplink_, update_
    pool = (torch.cuda.graph_pool_handle() if device.type == "cuda"
            else None)
    return (graphs.GraphedFn(uplink_, device, donate=(0, 1), pool=pool),
            graphs.GraphedFn(update_, device, donate=(0, 1), pool=pool))


@dataclasses.dataclass
class _Pending:
    """One in-flight round: the direction stack the update needs, plus
    the loss lanes as they arrive."""
    round: int
    u_stack: Any
    phi: Any
    losses: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    delivered: bool = True


class ClientWorker:
    """One client party behind a wire endpoint.

    ``client_params`` is this client's UNstacked parameter tree (one row
    of the engine layout), on the device the worker computes on; ``x_m``
    its full vertical feature slice (moved to that device).
    ``directions`` is the draw seam (default
    :func:`~repro_torch.core.draws.seed_directions`). Drive it with
    :meth:`pump` (loopback, engine-pumped) or :meth:`serve` (blocking
    loop for a worker process).

    The worker owns a copy of its row and updates it in place. Its uplink
    and update run through :func:`_worker_fns`: with ``graph`` (the
    default) from CUDA graphs of its own on the card, captured by
    :meth:`warm` or else at its first activation and first update
    (:meth:`stats`); ``graph=False`` runs them eagerly."""

    def __init__(self, adapter: ModelAdapter, vfl: VFLConfig,
                 client_params: Any, x_m: Any, index: int,
                 backend: WireBackend, *,
                 directions: Optional[Directions] = None,
                 graph: bool = True) -> None:
        self.adapter = adapter
        self.vfl = vfl
        self.client_params = tree_map(torch.clone, client_params)
        self.device = tree_leaves(client_params)[0].device
        self.x_m = torch.as_tensor(x_m).to(self.device)
        self.index = index
        self.backend = backend
        self.directions = (directions if directions is not None
                           else seed_directions)
        self._uplink, self._update = _worker_fns(
            *_client_fns(adapter, vfl), self.device, graph)
        self._pending: Optional[_Pending] = None
        self._stopped = False

    @classmethod
    def from_checkpoint(cls, adapter: ModelAdapter, vfl: VFLConfig,
                        ckpt_path: str, index: int, x_m: Any,
                        backend: WireBackend, *, device=None,
                        directions: Optional[Directions] = None
                        ) -> "ClientWorker":
        """Restart a crashed worker from a party-scoped ``fed.save``
        directory: load ONLY this party's row (``client_XX/``), onto
        ``device`` (the CUDA card when None: raises without one), and
        rejoin the wire on ``backend``."""
        dev = resolve_device(device)
        tree, _, _ = load_tree(os.path.join(ckpt_path,
                                            f"client_{index:02d}"), dev)
        return cls(adapter, vfl, tree, x_m, index, backend,
                   directions=directions)

    def warm(self, batch: int, key) -> None:
        """Capture the uplink's and the update's graphs before the run's
        rounds, from a stand-in round of ``batch`` rows (row 0 of the
        feature slice, the directions of the draw key ``key``, in the
        form the engine's ``act`` frames carry, equal losses), and put
        the row back as it was: every later activation and update then
        replays. The update is captured on the uplink's replayed
        direction stack (the uplink runs twice), so it reads it where
        every later replay writes it. Eager functions (``graph=False``) are left
        as they are."""
        if not isinstance(self._uplink, graphs.GraphedFn):
            return
        row = tree_map(torch.clone, self.client_params)
        raw = self.directions(key, self.client_params, self.vfl.zoo_queries)
        idx = torch.zeros((batch,), dtype=torch.int64, device=self.device)
        for _ in range(2):
            u_stack, phi, _ = self._uplink(self.client_params, self.x_m,
                                           idx, raw, 0, None)
        losses = torch.zeros((1 + self.vfl.zoo_queries,),
                             dtype=torch.float32, device=self.device)
        self._update(self.client_params, u_stack, phi, losses, 0, None)
        for dst, src in zip(tree_leaves(self.client_params),
                            tree_leaves(row)):
            dst.copy_(src)

    def stats(self) -> dict:
        """The compiled uplink's and update's readings
        (``GraphedFn.stats``); empty when they run eagerly."""
        return {name: fn.stats() for name, fn in
                (("uplink", self._uplink), ("update", self._update))
                if isinstance(fn, graphs.GraphedFn)}

    # ------------------------------------------------------------ driving --
    def pump(self) -> int:
        """Process every queued message (loopback mode); returns how many
        were handled."""
        handled = 0
        while not self._stopped:
            try:
                msg, _ = self.backend.recv(timeout=0.0)
            except WireTimeout:
                break
            self._handle(msg)
            handled += 1
        return handled

    def serve(self, timeout: Optional[float] = None) -> None:
        """Blocking message loop (socket mode, worker process): run until
        the engine sends ``stop`` or the wire dies."""
        while not self._stopped:
            msg, _ = self.backend.recv(timeout=timeout)
            self._handle(msg)

    # ----------------------------------------------------------- protocol --
    def _handle(self, msg: WireMessage) -> None:
        if msg.tag == "act":
            self._on_act(msg)
        elif msg.tag == "loss":
            self._on_loss(msg)
        elif msg.tag == "skip":
            self._pending = None
        elif msg.tag == "collect":
            self.backend.send(WireMessage(
                "params", "client", msg.round, {"party": self.index},
                codec.flatten_tree(self.client_params)))
        elif msg.tag == "ping":
            self.backend.send(WireMessage(
                "pong", "client", msg.round,
                {"party": self.index, "nonce": msg.meta.get("nonce", 0)}))
        elif msg.tag == "stop":
            self._stopped = True
        else:  # pragma: no cover - protocol error
            raise ValueError(f"client worker got unexpected {msg.tag!r}")

    @tags.wire("up", accounted_by="Transport.account_wire", kind="embedding",
               reason="the §V uplink: 1 clean + q perturbed embeddings per "
                      "activated round, each frame metered at its "
                      "serialized size by the engine")
    def _on_act(self, msg: WireMessage) -> None:
        raw = self.directions(msg.payload["key"], self.client_params,
                              self.vfl.zoo_queries)
        idx = msg.payload["idx"].long().to(self.device)
        u_stack, phi, emb_lanes = self._uplink(self.client_params, self.x_m,
                                               idx, raw, msg.round, None)
        del raw
        # a replay's outputs hold until the uplink's next replay, which
        # only the next act makes, and an act replaces the pending round
        # (the update, in the same pool, never writes them: they were
        # held when it was captured)
        self._pending = _Pending(round=msg.round, u_stack=u_stack, phi=phi)
        emb_h = emb_lanes.cpu()
        for lane in range(emb_h.shape[0]):
            self.backend.send(WireMessage(
                "emb", "client", msg.round,
                {"party": self.index, "lane": lane},
                {"c": emb_h[lane]}))

    def _on_loss(self, msg: WireMessage) -> None:
        pend = self._pending
        if pend is None or msg.round != pend.round:
            # losses for a round the engine already skipped — drop them
            return
        pend.losses[int(msg.meta["lane"])] = msg.payload["h"]
        pend.delivered = pend.delivered and bool(
            msg.meta.get("delivered", True))
        if len(pend.losses) < 1 + self.vfl.zoo_queries:
            return
        self._pending = None    # frees the direction stack after the update
        if not pend.delivered:
            return  # downlink lost after retries: no update this round
        losses = torch.stack([pend.losses[i]
                              for i in range(len(pend.losses))]).to(
            self.device)
        self._update(self.client_params, pend.u_stack, pend.phi, losses,
                     msg.round, None)


# ------------------------------------------------------------ liveness ----

def heartbeat(backend: WireBackend, *, nonce: int = 0,
              timeout: Optional[float] = 1.0) -> bool:
    """Engine-side liveness probe: send ``ping``, wait for the matching
    ``pong``. Returns False — never raises — on a dead, hung, or
    desynchronized peer, so callers can poll it from a recovery path.

    Only safe BETWEEN protocol rounds (an in-flight round's frames would
    be eaten as non-pong replies and dropped)."""
    try:
        backend.send(WireMessage("ping", "server", 0, {"nonce": nonce}))
        msg, _ = backend.recv(timeout=timeout)
        return bool(msg.tag == "pong"
                    and msg.meta.get("nonce", None) == nonce)
    except (WireClosed, WireTimeout, OSError, ValueError):
        return False
