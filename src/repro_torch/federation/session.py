"""The ``Federation`` session: the port's entry point for training and
serving.

``Federation.build(model_cfg, vfl_cfg, engine_cfg, device=None)`` resolves
the choices every entry point wires together —

* the MODEL plane: a :class:`repro_torch.core.adapters.ModelAdapter`
  (given directly, derived from the paper's ``PaperMLPConfig``, or derived
  lazily from a registered decoder-only ``ModelConfig`` through
  ``adapters.from_model_config``),
* the WIRE: a :class:`repro_torch.federation.Transport` (canonical method
  name, ledger ownership, optional DP noise channel on the loss downlink),
* the DEVICE: the CUDA card unless the caller passes ``device="cpu"``,

and the session runs:

* TRAIN — :meth:`Federation.run` drives the asynchronous engine
  (staleness, blocks, all five methods) on that device,
  :meth:`Federation.run_population` drives the same protocol over the
  wire plane (``repro_torch.wire``: every client party behind a real
  endpoint, fault injection, a durable async plane), and
  :meth:`Federation.sync_step` builds the cascade/baseline step over the
  global model's loss that the ``launch/train.py`` driver pumps batches
  through;
* CHECKPOINT/RESUME — :meth:`Federation.save` writes one directory per
  PARTY (``fed.parties``: the server's directory contains zero client
  leaves and vice versa) plus the session state (step, optimizer state,
  wire ledger totals, spent DP budget); :meth:`Federation.restore`
  rebuilds the session and state on a device, so a resumed run continues
  allclose to an uninterrupted one with ledger and (ε, δ) totals exactly
  continued. The on-disk format is the JAX package's: a session saved by
  either package restores in the other;
* SERVE — :meth:`Federation.serve_step` / :meth:`Federation.decode` run
  split inference with the SAME party split as training (clients embed
  their token spans, the server owns backbone + head + caches), routed
  through the ``Transport`` so serve-time wire traffic lands in the
  ledger; :meth:`Federation.serve` returns the continuous-batching
  :class:`repro_torch.federation.scheduler.ServeScheduler` over paged
  caches, whose mid-drain snapshot ``save(serve_state=)`` persists.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import graphs
from repro_torch.checkpoint.io import atomic_write, load_tree, save_checkpoint
from repro_torch.configs.base import ModelConfig, VFLConfig
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core import async_engine, cascade
from repro_torch.core.adapters import (ModelAdapter, from_model_config,
                                       tabular_adapter)
from repro_torch.core.draws import DrawSource, RowDraws, TorchDraws
from repro_torch.core.methods import canonical_method
from repro_torch.core.partition import (lm_engine_params, merge_params,
                                        split_params, tree_leaves, tree_map)
from repro_torch.core.privacy import GaussianLossChannel, Ledger
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federation import serving
from repro_torch.federation.parties import (ClientParty, Parties, ServerParty,
                                            is_engine_layout)
from repro_torch.federation.transport import Transport
from repro_torch.launch.mesh import make_client_mesh
from repro_torch.models import model_api
from repro_torch.optim import in_place, placed_like_params
from repro_torch.sharding.rules import PARAM_RULES, resolve_spec

ModelLike = Union[ModelAdapter, ModelConfig, PaperMLPConfig]

SESSION_MANIFEST = "session.json"
# keys of kept decode graphs (each holds its KV caches) and of kept round
# graphs a session holds at once
KEPT_DECODES = 2
KEPT_ROUNDS = 4
CHECKPOINT_VERSION = 1


def _with_draws(fn, draws, *args):
    return fn(*args, draws)


def _to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype)


@dataclasses.dataclass
class SessionState:
    """The non-parameter state a checkpoint carries: everything a resumed
    run needs to continue EXACTLY (not just approximately) — the step
    clock, the optimizer/schedule state, the Transport ledger totals, and
    the DP accountant's release count — and, for a checkpoint taken
    mid-``run_population``, the population engine's plane
    (``async_state``, an ``async_engine.AsyncPlaneState``: the resumed
    wire run replays the remaining rounds bitwise), or for a mid-drain
    serve checkpoint the serve scheduler's plane (``serve_state``, a
    ``scheduler.SchedulerState``)."""
    step: int = 0
    opt_state: Optional[Any] = None
    ledger: Ledger = dataclasses.field(default_factory=Ledger)
    dp_releases: int = 0
    async_state: Optional[async_engine.AsyncPlaneState] = None
    serve_state: Optional[Any] = None
    # the free-form metadata the saver passed to ``fed.save`` (driver
    # knobs like batch/seed/schedule live here, not in the session)
    metadata: dict = dataclasses.field(default_factory=dict)

    def dp_spent(self, transport: Transport) -> Tuple[float, float]:
        return transport.privacy_spent(self.dp_releases)


@dataclasses.dataclass
class Federation:
    """A built session; construct via :meth:`build`."""
    vfl: VFLConfig
    engine: async_engine.EngineConfig
    transport: Transport
    device: torch.device
    # the ("data",) client mesh of a sharded session (one rank a shard)
    mesh: Optional[Any] = None
    # set for ModelConfig-built sessions (the serve plane)
    model_cfg: Optional[ModelConfig] = None
    n_clients: int = 2
    seq_len: int = 32
    _adapter: Optional[ModelAdapter] = None
    _model: Optional[model_api.Model] = None
    # a ModelConfig session's derived adapters, by vfl.active_rows_only
    _lm_adapters: dict = dataclasses.field(default_factory=dict)
    # the decode graphs and the round graphs kept across calls of one key
    # (freed with the session), as the JAX package's caches of compiled
    # functions keep theirs
    _kept_decodes: graphs.Kept = dataclasses.field(
        default_factory=lambda: graphs.Kept(KEPT_DECODES), repr=False,
        compare=False)
    _kept_rounds: graphs.Kept = dataclasses.field(
        default_factory=lambda: graphs.Kept(KEPT_ROUNDS), repr=False,
        compare=False)

    @classmethod
    def build(cls, model_cfg: ModelLike,
              vfl_cfg: Optional[VFLConfig] = None,
              engine_cfg: Optional[async_engine.EngineConfig] = None, *,
              noise: Optional[GaussianLossChannel] = None,
              transport: Optional[Transport] = None,
              mesh: Optional[Any] = None,
              n_clients: int = 2, seq_len: int = 32,
              device: DeviceLike = None) -> "Federation":
        """One constructor for the entry points.

        ``model_cfg`` may be a ready :class:`ModelAdapter`, the paper's
        ``PaperMLPConfig`` (tabular protocol), or a registered decoder-only
        ``ModelConfig`` (clients own the embedding, the server the
        backbone; ``n_clients``/``seq_len`` size the vertical token
        split). ``noise`` plugs a DP channel into the transport's loss
        downlink. ``device=None`` means the CUDA card and raises without
        one; pass ``device="cpu"`` for the CPU. ``mesh`` is normally
        derived from ``engine_cfg.mesh_shards`` (a ``("data",)``
        ``DeviceMesh`` over that many ranks of the initialized
        ``torch.distributed`` group, one process a shard, each with its
        own ``device``); passing an explicit mesh is the escape hatch
        ``async_engine.run`` uses."""
        vfl = vfl_cfg if vfl_cfg is not None else VFLConfig()
        engine = (engine_cfg if engine_cfg is not None
                  else async_engine.EngineConfig())
        if transport is None:
            transport = Transport(engine.method, noise=noise)
        elif noise is not None:
            raise ValueError("pass noise= or a full transport=, not both")
        if canonical_method(engine.method) != transport.method:
            raise ValueError(
                f"engine_cfg.method {engine.method!r} and transport method "
                f"{transport.method!r} disagree")
        if mesh is not None and engine.mesh_shards:
            raise ValueError(
                f"both an explicit mesh= and engine_cfg.mesh_shards="
                f"{engine.mesh_shards} were given; set one (mesh_shards is "
                "the session-native spelling)")
        device = resolve_device(device)
        if mesh is None and engine.mesh_shards:
            mesh = make_client_mesh(engine.mesh_shards, device=device)
        adapter = cfg = None
        if isinstance(model_cfg, ModelAdapter):
            adapter = model_cfg
        elif isinstance(model_cfg, PaperMLPConfig):
            adapter = tabular_adapter(model_cfg)
            n_clients = model_cfg.n_clients
        elif isinstance(model_cfg, ModelConfig):
            cfg = model_cfg
        else:
            raise TypeError(
                f"model_cfg must be a ModelAdapter, PaperMLPConfig or "
                f"ModelConfig, got {type(model_cfg).__name__}")
        return cls(vfl=vfl, engine=engine, transport=transport,
                   device=device, mesh=mesh, model_cfg=cfg,
                   n_clients=n_clients, seq_len=seq_len, _adapter=adapter)

    # ------------------------------------------------------- model plane --
    @property
    def adapter(self) -> ModelAdapter:
        """The session's ModelAdapter. A ModelConfig session derives it
        (at first use) with the active-row ZOO mask that
        ``vfl.active_rows_only`` selects, the flag the sync cascade's row
        mask is gated on too, read at each access: a driver may replace
        ``fed.vfl`` after the build."""
        if self._adapter is not None:
            return self._adapter
        rows = bool(self.vfl.active_rows_only)
        if rows not in self._lm_adapters:
            self._lm_adapters[rows] = from_model_config(
                self.model_cfg, n_clients=self.n_clients,
                seq_len=self.seq_len, active_rows=rows)
        return self._lm_adapters[rows]

    @property
    def model(self) -> Optional[model_api.Model]:
        """The global model of a ModelConfig session (None otherwise),
        built at first use."""
        if self._model is None and self.model_cfg is not None:
            self._model = model_api.build_model(self.model_cfg,
                                                max_seq=self.seq_len)
        return self._model

    def init_params(self, generator: torch.Generator):
        """Engine-layout params ({"clients": (M, ...), "server": ...}) on
        the session's device, drawn from ``generator``."""
        return self.adapter.init_params(generator, device=self.device)

    def run(self, params, x_parts, y, *, probs=None,
            draws: Optional[DrawSource] = None, use_graph: bool = True
            ) -> async_engine.EngineResult:
        """Asynchronous protocol simulation (staleness, blocks, sharding).

        ``x_parts``: (M, n, f) vertically partitioned features; ``y``: (n,)
        labels — numpy arrays or tensors, moved to the session's device.
        ``params`` leaves may be numpy arrays or tensors too. ``draws``
        defaults to :class:`TorchDraws` seeded with ``engine.seed`` on the
        session's device. A sharded session's ranks each call ``run`` with
        the same arguments; every rank returns the replicated result.

        On the card an unsharded run captures one round as a CUDA graph
        and replays it (the result's ``round_graph`` holds its capture
        seconds, nodes and replays); on the CPU the same round body runs
        in a Python loop. ``use_graph=False`` loops it on the card too:
        the eager comparison the smoke run holds the graph to (no entry
        point passes it).

        The session keeps the round graph, its buffers and its recorded
        draws across calls (at most :data:`KEPT_ROUNDS` keys): a later
        call whose params, data, schedule and sample indices have the
        same shapes replays all its rounds from the kept graph, capturing
        nothing (``round_graph["kept"]``)."""
        params, x_parts, y = self._engine_inputs(params, x_parts, y)
        if draws is None:
            draws = TorchDraws(self.engine.seed, self.device)
        return async_engine._session_run(
            self.adapter, self.transport, self.vfl, self.engine, params,
            x_parts, y, draws=draws, probs=probs, mesh=self.mesh,
            graph=use_graph, kept=self._kept_rounds)

    def _engine_inputs(self, params, x_parts, y):
        """The engine's params and data on the session's device: float
        features as f32, token spans (an LM session's ``x_parts``) and
        labels as int64."""
        dev = self.device
        params = tree_map(lambda a: _to_device(a, dev), params)
        xt = (x_parts if isinstance(x_parts, torch.Tensor)
              else torch.from_numpy(np.asarray(x_parts)))
        x_parts = xt.to(dev, torch.float32 if xt.is_floating_point()
                        else torch.int64)
        return params, x_parts, _to_device(y, dev, torch.int64)

    def run_population(self, params, x_parts, y, *, probs=None,
                       fault_plan=None, population=None, channels=None,
                       state=None, ledger: Optional[Ledger] = None,
                       dp_releases: int = 0, until: Optional[int] = None,
                       stop_workers: bool = True, draws=None,
                       wire_timeout_s: Optional[float] = None,
                       use_graph: bool = True
                       ) -> async_engine.PopulationResult:
        """The asynchronous protocol over the REAL wire
        (``repro_torch.wire``).

        Same schedule/draw/staleness semantics as :meth:`run` — with
        ``FaultPlan.none()`` and the same :class:`~repro_torch.core.draws.
        RowDraws` the two are bitwise equal — but every client sits behind
        a wire backend (in-proc loopback on the session's device by
        default; ``channels={m: backend}`` places party m behind e.g. a
        connected socket whose worker process runs
        ``ClientWorker.serve``), frames are genuinely serialized and
        metered at their actual byte size, and ``fault_plan`` injects
        deterministic drops/latency. ``state``/``until``/``ledger``/
        ``dp_releases`` continue a checkpointed run exactly (see
        :meth:`save`'s ``async_state``). ``draws`` defaults to
        ``RowDraws(engine.seed)`` on the session's device.

        On the card the server's two functions and each loopback
        worker's uplink and update run from CUDA graphs, one captured for
        each new input shape (``stats["graphs"]`` counts them); on the
        CPU the same bodies run in a loop.
        ``use_graph=False`` runs them eagerly: the comparison the smoke
        run holds the graphs to (no entry point passes it)."""
        params, x_parts, y = self._engine_inputs(params, x_parts, y)
        if draws is None:
            draws = RowDraws(self.engine.seed, self.device)
        return async_engine.run_population(
            self.adapter, self.transport, self.vfl, self.engine,
            params, x_parts, y, draws=draws, probs=probs,
            fault_plan=fault_plan, population=population, channels=channels,
            state=state, ledger=ledger, dp_releases=dp_releases,
            until=until, stop_workers=stop_workers,
            wire_timeout_s=wire_timeout_s, graph=use_graph)

    def params_from_global(self, global_params):
        """Replicate a global ``build_model`` param tree into the engine
        layout (each client party gets the same embedding table)."""
        if self.model_cfg is None:
            raise ValueError("params_from_global needs a ModelConfig-built "
                             "session (tabular/adapter sessions already use "
                             "the engine layout)")
        return lm_engine_params(global_params, self.n_clients)

    # ------------------------------------------------------- sync driver --
    def sync_step(self, optimizer, *, vocab: Optional[int] = None,
                  graph: bool = False):
        """Cascade/baseline step over the GLOBAL model's loss — the
        ``launch/train.py`` plane: ``step(params, opt_state, batch, t,
        draws) -> (params, opt_state, StepOutput)`` (see
        :mod:`repro_torch.core.cascade`). Requires a ModelConfig
        session; params and batches live on the session's device.

        ``graph=True`` gives the compiled form, the counterpart of the
        JAX driver's ``jax.jit(step_fn, donate_argnums=(0, 1))``: a
        :class:`repro_torch.graphs.GraphedFn` over the step with the
        optimizer's in-place update, which writes the new parameters and
        state into the ``params`` and ``opt_state`` it is given (donated:
        pass the returned trees back). On the card its first call runs
        eagerly and the step is then captured as a CUDA graph and
        replayed; on the CPU the same step runs on its static buffers in
        a loop. The StepOutput of a replay holds until the next call.

        On a mesh (DTensor parameters) each gradient is brought to its
        parameter's placement before the update
        (:func:`repro_torch.optim.placed_like_params`), so both forms
        return every leaf placed as it came in, with the same bits."""
        if self.model_cfg is None:
            raise ValueError(
                "sync_step drives a global-model loss; build the session "
                "from a ModelConfig (tabular/adapter sessions train through "
                "Federation.run)")
        vocab = self.model_cfg.padded_vocab if vocab is None else vocab
        # a placed run's mesh is its parameters' (``train(mesh=)``), not
        # the session's client mesh: the wrap looks at each leaf, and a
        # plain tensor passes as it is
        optimizer = placed_like_params(optimizer)
        step = cascade.make_step_for_method(
            self.transport.method, self.model.loss_fn,
            self.model.client_keys, self.vfl,
            in_place(optimizer) if graph else optimizer, vocab=vocab,
            transport=self.transport)
        if not graph:
            return step
        return graphs.GraphedFn(step, self.device, donate=(0, 1))

    # -------------------------------------------------- certifier plane ---
    def boundary_meta(self) -> dict:
        """Boundary metadata for the graph certifier
        (``repro_torch.analysis.certify``): everything the information-flow
        rules need to size the legal bottleneck — method, q, block,
        whether a DP channel is configured — read off the session instead
        of asserted by the caller."""
        return {
            "method": self.transport.method,
            "sync": self.transport.sync,
            "zoo_wire": self.transport.zoo_wire,
            "dp": self.transport.noise is not None,
            "zoo_queries": self.vfl.zoo_queries,
            "block": 1 if self.transport.sync else self.engine.block_size,
            "batch": self.engine.batch_size,
            "n_clients": self.n_clients,
            "use_lanes": self.engine.use_lanes,
            "mesh_shards": self.engine.mesh_shards,
        }

    def traceable_train_step(self, *, table_shape=None):
        """The EXACT step closure the engine's round loop runs — sync,
        async, or device-sharded per the engine config — for the
        certifier to trace. Signature: ``step(params, table, m_blk, idx,
        t, draws, x_parts, y) -> (params, table, h)``; it updates
        ``table`` in place; an asynchronous step also writes the server's
        new leaves into ``params``, and the unsharded one the clients'. The sharded variant
        needs ``table_shape`` (the (M, n, e) embedding-table shape) to
        resolve the table's partition spec the same way ``run`` does,
        and its ``table`` carries one spare row past this rank's own
        (``async_engine._make_runner``)."""
        if self.transport.sync:
            return async_engine._make_sync_step(
                self.adapter, self.transport, self.vfl)
        if self.mesh is not None:
            if table_shape is None:
                raise ValueError("the sharded step needs table_shape= to "
                                 "resolve the table partition spec")
            table_spec = resolve_spec(self.mesh, tuple(table_shape),
                                      self.adapter.table_logical,
                                      PARAM_RULES)
            return async_engine._make_sharded_step(
                self.adapter, self.transport, self.vfl,
                self.engine.use_lanes, self.mesh, self.engine.block_size,
                table_spec)
        return async_engine._make_async_step(
            self.adapter, self.transport, self.vfl, self.engine.use_lanes)

    def traceable_population_fns(self, draws=None):
        """The population engine's server-side pair ``(server_update,
        losses_fn)`` (see ``async_engine._population_fns``) over
        ``draws`` (default: ``RowDraws(engine.seed)`` on the session's
        device, as :meth:`run_population` draws) — ``losses_fn`` is the
        server->client downlink closure the certifier traces: its whole
        output is client-bound. Both run eagerly, ``draws`` bound as
        their last argument."""
        if draws is None:
            draws = RowDraws(self.engine.seed, self.device)
        fns = async_engine._population_fns(self.adapter, self.transport,
                                           self.vfl, self.device,
                                           graph=False)
        return tuple(functools.partial(_with_draws, fn, draws)
                     for fn in fns)

    # ------------------------------------------------------ party plane ---
    @property
    def client_keys(self) -> Tuple[str, ...]:
        """Top-level GLOBAL-layout keys forming the client partition."""
        if self.model_cfg is not None:
            return self.model.client_keys
        return ("clients",)

    @property
    def parties(self) -> Parties:
        """Typed party handles — the one way any plane addresses state.

        ``parties.server`` owns the backbone/head partition,
        ``parties.clients[m]`` owns client m's slice; both resolve against
        either param layout (engine ``{"clients", "server"}`` or the
        global ``build_model`` tree)."""
        keys = self.client_keys
        return Parties(
            server=ServerParty(client_keys=keys),
            clients=tuple(ClientParty(index=m, client_keys=keys)
                          for m in range(self.n_clients)))

    # ------------------------------------------------------ serve plane ---
    def serve_step(self):
        """One-token split-inference step (see
        :func:`repro_torch.federation.serving.make_serve_step`): the
        client owning the current position embeds the token, the server
        decodes against its caches. Requires a ModelConfig session."""
        return serving.make_serve_step(self.adapter, self.n_clients,
                                       self.seq_len)

    def decode(self, params, prompts, *, gen_len: int,
               temperature: float = 0.0, seed: int = 0,
               draws: Optional[serving.GumbelSource] = None,
               ledger: Optional[Ledger] = None, use_scan: bool = True,
               chunked_prefill: bool = True) -> serving.ServeResult:
        """Split inference with the training party split.

        ``params`` may be the engine layout or a global ``build_model``
        tree (replicated into the engine layout via
        :meth:`params_from_global`), on the session's device. ``prompts``:
        (B, prompt_len) ints; ``prompt_len + gen_len`` must fit the session
        ``seq_len``. Serve-time wire traffic is logged through the
        Transport — pass ``ledger`` to extend a training run's totals.

        At ``temperature`` > 0 the Gumbel noise comes from ``draws``
        (default: :class:`serving.TorchGumbel` seeded with ``seed``); a
        B = 1 decode given ``serving.PositionGumbel(s)`` samples the tokens
        the continuous scheduler gives a request submitted with ``seed=s``.
        ``chunked_prefill=False`` prefills token by token (the oracle).
        ``use_scan`` (the default) decodes as the JAX package's compiled
        scan does, with no host work per token: on the card one generated
        token is captured as a CUDA graph and replayed (its capture time
        lands in ``compile_s``; a failed capture raises); on the CPU the
        same step body runs in a loop. ``use_scan=False`` is the eager loop
        of one-token steps; both give the same tokens and logits.

        The session keeps the decode graph and its buffers across calls
        (at most :data:`KEPT_DECODES` keys): a later call with prompts of
        the same shapes, the same ``gen_len`` and temperature and the
        same params tree (the same leaf objects) prefills into the kept
        caches and replays the kept graph, capturing nothing (the
        result's ``kept``). A key holds its KV caches and buffers, not
        the params tree: it goes when a leaf of the tree dies."""
        if self.model_cfg is None:
            raise ValueError(
                "decode needs a ModelConfig-built session (tabular/adapter "
                "sessions have no serve plane)")
        kept = self._kept_decodes
        if not is_engine_layout(params):
            # a tree made anew each call: its leaves are never a kept key's
            params, kept = self.params_from_global(params), None
        if draws is None and temperature > 0:
            draws = serving.TorchGumbel(seed, self.device)
        return serving.run_decode(
            self.adapter, self.transport, n_clients=self.n_clients,
            seq_len=self.seq_len, embed_dim=self.model_cfg.d_model,
            vocab_size=self.model_cfg.vocab_size, params=params,
            prompts=prompts, gen_len=gen_len, device=self.device,
            temperature=temperature, draws=draws, ledger=ledger,
            use_scan=use_scan, chunked_prefill=chunked_prefill,
            kept=kept)

    def serve(self, params, *, max_batch: int = 4,
              temperature: float = 0.0, page_size: Optional[int] = None,
              n_pages: Optional[int] = None,
              max_queue: Optional[int] = None, preempt: bool = False,
              state: Optional[Any] = None, use_scan: bool = True):
        """A continuous-batching serve session over the split plane, on the
        session's device.

        Returns a :class:`repro_torch.federation.scheduler.ServeScheduler`:
        ``submit(prompt, gen_len=...)`` queues requests, ``run()`` drains
        them through ``max_batch`` fixed slots — new requests are admitted
        as slots free up mid-flight, K-step decode blocks serve the
        churning mix, and each request gets its own exact wire ledger.
        Slot caches live in a shared page pool (``page_size`` must divide
        ``seq_len``; ``n_pages`` caps pool memory and gates admission on
        free pages when set below the ``max_batch`` worst case).

        Failure policy: ``max_queue`` bounds admission (``submit`` raises
        ``QueueFull`` past it) and ``preempt=True`` lets a page-starved
        queue head evict the in-flight request with the fewest tokens
        remaining. Pass a restored ``SessionState.serve_state`` as
        ``state`` to resume a mid-drain snapshot — the scheduler's shape
        and pool config then come from the snapshot, not from the
        keyword defaults. ``use_scan`` (the port's addition, named as in
        :meth:`decode`): on the card the decode block and the resume
        replay run as CUDA graphs; ``use_scan=False`` runs them as eager
        steps, with the same results."""
        from repro_torch.federation.scheduler import ServeScheduler
        if self.model_cfg is None:
            raise ValueError(
                "serve needs a ModelConfig-built session (tabular/adapter "
                "sessions have no serve plane)")
        if not is_engine_layout(params):
            params = self.params_from_global(params)
        if state is not None:
            cfg = state.meta["config"]
            max_batch = int(cfg["max_batch"])
            temperature = float(cfg["temperature"])
            page_size = int(cfg["page_size"])
            n_pages = int(cfg["n_pages"])
            max_queue = cfg["max_queue"]
            preempt = bool(cfg["preempt"])
        srv = ServeScheduler(
            self.adapter, self.transport, params=params,
            n_clients=self.n_clients, seq_len=self.seq_len,
            embed_dim=self.model_cfg.d_model,
            vocab_size=self.model_cfg.vocab_size, device=self.device,
            max_batch=max_batch, temperature=temperature,
            page_size=page_size, n_pages=n_pages, max_queue=max_queue,
            preempt=preempt, use_scan=use_scan)
        if state is not None:
            srv._load_state(state)
        return srv

    # ------------------------------------------------- checkpoint plane ---
    def save(self, path: str, params, *, step: int = 0,
             opt_state: Optional[Any] = None,
             ledger: Optional[Ledger] = None, dp_releases: int = 0,
             async_state: Optional[async_engine.AsyncPlaneState] = None,
             serve_state: Optional[Any] = None,
             metadata: Optional[dict] = None) -> str:
        """Party-scoped checkpoint: one directory per party + session state.

        Layout::

            path/
              session.json     step, configs, ledger totals, DP releases
              server/          server party's leaves ONLY
              client_00/ ...   per-client slices   (engine layout), or
              clients/         the client partition (global layout)
              opt_server/, opt_clients/   optimizer state, split on the
                                          same party boundary (optional)
              async_plane/     the population engine's table/delay/clock
                               state (optional — mid-``run_population``
                               checkpoints resume bitwise)
              serve_plane/     the serve scheduler's full state (optional
                               — a mid-drain ``srv.snapshot()``; the
                               resumed drain's tokens and ledgers equal
                               an unbroken one's)

        The isolation is structural (:mod:`repro_torch.federation.parties`):
        the server handle cannot address a client leaf, so its directory
        provably contains none — and vice versa. Returns ``path`` (the
        token ``Federation.restore`` consumes)."""
        os.makedirs(path, exist_ok=True)
        parties = self.parties
        engine_layout = is_engine_layout(params)
        if engine_layout:
            rows = tree_leaves(params["clients"])[0].shape[0]
            if rows != len(parties.clients):
                raise ValueError(
                    f"params stack {rows} client parties but the session "
                    f"was built with n_clients={len(parties.clients)} — a "
                    "per-party save would silently drop rows; pass "
                    f"n_clients={rows} to Federation.build")
            save_checkpoint(os.path.join(path, parties.server.name),
                            parties.server.owned(params), step=step)
            for party in parties.clients:
                save_checkpoint(os.path.join(path, party.name),
                                party.owned(params), step=step)
        else:
            save_checkpoint(os.path.join(path, "server"),
                            parties.server.owned(params), step=step)
            save_checkpoint(os.path.join(path, "clients"),
                            parties.clients[0].owned(params), step=step)
        if opt_state is not None:
            opt_c, opt_s = self._split_opt_state(opt_state, engine_layout)
            save_checkpoint(os.path.join(path, "opt_server"), opt_s,
                            step=step)
            save_checkpoint(os.path.join(path, "opt_clients"), opt_c,
                            step=step)
        if async_state is not None:
            async_state.save(os.path.join(path, "async_plane"))
        if serve_state is not None:
            serve_state.save(os.path.join(path, "serve_plane"))

        ledger = ledger if ledger is not None else Ledger()
        eps, delta = self.transport.privacy_spent(dp_releases)
        manifest = {
            "version": CHECKPOINT_VERSION,
            "step": int(step),
            "layout": "engine" if engine_layout else "global",
            "has_opt_state": opt_state is not None,
            "model": self._model_manifest(),
            "vfl": dataclasses.asdict(self.vfl),
            "engine": dataclasses.asdict(self.engine),
            "noise": (None if self.transport.noise is None
                      else dataclasses.asdict(self.transport.noise)),
            "n_clients": self.n_clients,
            "seq_len": self.seq_len,
            "ledger_counts": ledger.to_counts(),
            "dp_releases": int(dp_releases),
            "dp_spent": [eps if math.isfinite(eps) else None, delta],
            "async_plane": async_state is not None,
            "serve_plane": serve_state is not None,
            "metadata": metadata or {},
        }
        # atomic + last: a session.json on disk always certifies complete
        # party and plane directories next to it
        atomic_write(os.path.join(path, SESSION_MANIFEST),
                     lambda f: json.dump(manifest, f, indent=2), mode="w")
        return path

    @classmethod
    def restore(cls, path: str, model_cfg: Optional[ModelLike] = None, *,
                device: DeviceLike = None
                ) -> Tuple["Federation", Any, SessionState]:
        """Rebuild (session, params, state) from a :meth:`save` directory
        (written by either package), with the params and optimizer state
        on ``device`` — the card unless the caller asks for the CPU.

        The session's configs (model, vfl, engine, DP channel) come from
        ``session.json``; only adapter-built sessions — whose model plane
        is an arbitrary callable bundle — need the caller to pass the
        ``model_cfg`` (the adapter) back in. ``state.step``/``opt_state``/
        ``ledger``/``dp_releases`` continue a training run exactly:
        re-drive the same batches from ``state.step`` and the trajectory
        is allclose to one that never stopped."""
        with open(os.path.join(path, SESSION_MANIFEST)) as f:
            manifest = json.load(f)
        if manifest["version"] != CHECKPOINT_VERSION:
            raise ValueError(
                f"checkpoint version {manifest['version']} != "
                f"{CHECKPOINT_VERSION}")

        model = cls._model_from_manifest(manifest["model"], model_cfg)
        vfl_d = dict(manifest["vfl"])
        if vfl_d.get("activation_probs") is not None:
            vfl_d["activation_probs"] = tuple(vfl_d["activation_probs"])
        engine_d = dict(manifest["engine"])
        noise_d = manifest["noise"]
        fed = cls.build(
            model, VFLConfig(**vfl_d), async_engine.EngineConfig(**engine_d),
            noise=None if noise_d is None else GaussianLossChannel(**noise_d),
            n_clients=manifest["n_clients"], seq_len=manifest["seq_len"],
            device=device)
        dev = fed.device

        server_tree, _, _ = load_tree(os.path.join(path, "server"), dev)
        if manifest["layout"] == "engine":
            client_trees = [
                load_tree(os.path.join(path, party.name), dev)[0]
                for party in fed.parties.clients]
            params = fed.parties.assemble(server_tree, client_trees)
        else:
            client_tree, _, _ = load_tree(os.path.join(path, "clients"), dev)
            params = fed.parties.merge_global(server_tree, client_tree)

        opt_state = None
        if manifest["has_opt_state"]:
            opt_s, _, _ = load_tree(os.path.join(path, "opt_server"), dev)
            opt_c, _, _ = load_tree(os.path.join(path, "opt_clients"), dev)
            opt_state = fed._merge_opt_state(
                opt_c, opt_s, manifest["layout"] == "engine")

        async_state = None
        if manifest.get("async_plane"):
            async_state = async_engine.AsyncPlaneState.load(
                os.path.join(path, "async_plane"))

        serve_state = None
        if manifest.get("serve_plane"):
            from repro_torch.federation.scheduler import SchedulerState
            serve_state = SchedulerState.load(
                os.path.join(path, "serve_plane"))

        state = SessionState(
            step=manifest["step"], opt_state=opt_state,
            ledger=Ledger.from_counts(manifest["ledger_counts"]),
            dp_releases=manifest["dp_releases"], async_state=async_state,
            serve_state=serve_state,
            metadata=manifest.get("metadata", {}))
        return fed, params, state

    # ----------------------------------------------- checkpoint helpers ---
    def _model_manifest(self) -> dict:
        if self.model_cfg is not None:
            return {"kind": "model_config",
                    "data": dataclasses.asdict(self.model_cfg)}
        if (self._adapter is not None
                and self._adapter.name.startswith("tabular")):
            # a tabular adapter is fully determined by its PaperMLPConfig;
            # reconstruct it from the stacked client/server spec shapes
            spec = self._adapter.param_specs()
            M, f, e = spec["clients"]["w"].shape
            se, C = spec["server"]["w2"].shape
            return {"kind": "paper_mlp",
                    "data": dataclasses.asdict(PaperMLPConfig(
                        n_features=M * f, n_classes=C, n_clients=M,
                        client_embed=e, server_embed=se))}
        return {"kind": "adapter", "data": self.adapter.name}

    @staticmethod
    def _model_from_manifest(m: dict, model_cfg: Optional[ModelLike]):
        if model_cfg is not None:
            return model_cfg
        if m["kind"] == "model_config":
            return ModelConfig(**m["data"])
        if m["kind"] == "paper_mlp":
            return PaperMLPConfig(**m["data"])
        raise ValueError(
            f"checkpoint was saved from an adapter-built session "
            f"({m['data']!r}); pass the adapter back via "
            "Federation.restore(path, model_cfg=adapter)")

    def _split_opt_state(self, opt_state, engine_layout: bool):
        """Split optimizer state on the party boundary: per-parameter
        trees (momentum, adam moments) mirror the param layout and split
        like params; the step clock lives with the server (the session's
        round counter is server-side in the protocol)."""
        opt_c, opt_s = {}, {}
        for k, v in opt_state.items():
            if k == "step":
                opt_s[k] = v
            elif engine_layout:
                opt_c[k] = v["clients"]
                opt_s[k] = v["server"]
            else:
                opt_c[k], opt_s[k] = split_params(v, self.client_keys)
        return opt_c, opt_s

    def _merge_opt_state(self, opt_c, opt_s, engine_layout: bool):
        out = {}
        for k, v in opt_s.items():
            if k == "step":
                out[k] = v
            elif engine_layout:
                out[k] = {"clients": opt_c[k], "server": v}
            else:
                out[k] = merge_params(opt_c.get(k, {}), v)
        return out
