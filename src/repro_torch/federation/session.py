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
  (staleness, blocks, all five methods) on that device;
* SERVE — :meth:`Federation.serve_step` / :meth:`Federation.decode` run
  split inference with the SAME party split as training (clients embed
  their token spans, the server owns backbone + head + caches), routed
  through the ``Transport`` so serve-time wire traffic lands in the
  ledger.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, VFLConfig
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core import async_engine
from repro_torch.core.adapters import (ModelAdapter, from_model_config,
                                       tabular_adapter)
from repro_torch.core.draws import DrawSource, TorchDraws
from repro_torch.core.methods import canonical_method
from repro_torch.core.partition import lm_engine_params, tree_map
from repro_torch.core.privacy import GaussianLossChannel, Ledger
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federation import serving
from repro_torch.federation.transport import Transport
from repro_torch.models import model_api

ModelLike = Union[ModelAdapter, ModelConfig, PaperMLPConfig]


def _to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype)


def is_engine_layout(params: Any) -> bool:
    """True for the async engine's {"clients", "server"} param layout."""
    return isinstance(params, dict) and set(params) == {"clients", "server"}


@dataclasses.dataclass
class Federation:
    """A built session; construct via :meth:`build`."""
    vfl: VFLConfig
    engine: async_engine.EngineConfig
    transport: Transport
    device: torch.device
    # set for ModelConfig-built sessions (the serve plane)
    model_cfg: Optional[ModelConfig] = None
    n_clients: int = 2
    seq_len: int = 32
    _adapter: Optional[ModelAdapter] = None
    _model: Optional[model_api.Model] = None

    @classmethod
    def build(cls, model_cfg: ModelLike,
              vfl_cfg: Optional[VFLConfig] = None,
              engine_cfg: Optional[async_engine.EngineConfig] = None, *,
              noise: Optional[GaussianLossChannel] = None,
              transport: Optional[Transport] = None,
              n_clients: int = 2, seq_len: int = 32,
              device: DeviceLike = None) -> "Federation":
        """One constructor for the entry points.

        ``model_cfg`` may be a ready :class:`ModelAdapter`, the paper's
        ``PaperMLPConfig`` (tabular protocol), or a registered decoder-only
        ``ModelConfig`` (clients own the embedding, the server the
        backbone; ``n_clients``/``seq_len`` size the vertical token
        split). ``noise`` plugs a DP channel into the transport's loss
        downlink. ``device=None`` means the CUDA card and raises without
        one; pass ``device="cpu"`` for the CPU."""
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
                   device=resolve_device(device), model_cfg=cfg,
                   n_clients=n_clients, seq_len=seq_len, _adapter=adapter)

    # ------------------------------------------------------- model plane --
    @property
    def adapter(self) -> ModelAdapter:
        """The session's ModelAdapter, derived at first use for a
        ModelConfig session."""
        if self._adapter is None:
            self._adapter = from_model_config(
                self.model_cfg, n_clients=self.n_clients,
                seq_len=self.seq_len)
        return self._adapter

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
            draws: Optional[DrawSource] = None
            ) -> async_engine.EngineResult:
        """Asynchronous protocol simulation (staleness, blocks).

        ``x_parts``: (M, n, f) vertically partitioned features; ``y``: (n,)
        labels — numpy arrays or tensors, moved to the session's device.
        ``params`` leaves may be numpy arrays or tensors too. ``draws``
        defaults to :class:`TorchDraws` seeded with ``engine.seed`` on the
        session's device."""
        dev = self.device
        params = tree_map(lambda a: _to_device(a, dev), params)
        x_parts = _to_device(x_parts, dev, torch.float32)
        y = _to_device(y, dev, torch.int64)
        if draws is None:
            draws = TorchDraws(self.engine.seed, dev)
        return async_engine._session_run(
            self.adapter, self.transport, self.vfl, self.engine, params,
            x_parts, y, draws=draws, probs=probs)

    def params_from_global(self, global_params):
        """Replicate a global ``build_model`` param tree into the engine
        layout (each client party gets the same embedding table)."""
        if self.model_cfg is None:
            raise ValueError("params_from_global needs a ModelConfig-built "
                             "session (tabular/adapter sessions already use "
                             "the engine layout)")
        return lm_engine_params(global_params, self.n_clients)

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
        (default: :class:`serving.TorchGumbel` seeded with ``seed``).
        ``chunked_prefill=False`` prefills token by token (the oracle).
        ``use_scan`` is the JAX package's choice between its compiled scan
        and its step loop; the port has one device-resident decode loop
        and runs it for either value."""
        if self.model_cfg is None:
            raise ValueError(
                "decode needs a ModelConfig-built session (tabular/adapter "
                "sessions have no serve plane)")
        if not is_engine_layout(params):
            params = self.params_from_global(params)
        if draws is None and temperature > 0:
            draws = serving.TorchGumbel(seed, self.device)
        return serving.run_decode(
            self.adapter, self.transport, n_clients=self.n_clients,
            seq_len=self.seq_len, embed_dim=self.model_cfg.d_model,
            vocab_size=self.model_cfg.vocab_size, params=params,
            prompts=prompts, gen_len=gen_len, device=self.device,
            temperature=temperature, draws=draws, ledger=ledger,
            chunked_prefill=chunked_prefill)

    def serve(self, params, **_kwargs):
        """Continuous batching (the JAX package's ``ServeScheduler``)
        belongs to the scheduler slice."""
        raise NotImplementedError(
            "continuous batching (Federation.serve, the paged scheduler) is "
            "not ported yet (ROADMAP.md, Queue 1 item 6); use "
            "Federation.decode")
