"""The ``Federation`` session: the port's entry point for training.

``Federation.build(model_cfg, vfl_cfg, engine_cfg, device=None)`` resolves
the choices every entry point wires together —

* the MODEL plane: a :class:`repro_torch.core.adapters.ModelAdapter`
  (given directly, or derived from the paper's ``PaperMLPConfig``),
* the WIRE: a :class:`repro_torch.federation.Transport` (canonical method
  name, ledger ownership, optional DP noise channel on the loss downlink),
* the DEVICE: the CUDA card unless the caller passes ``device="cpu"``,

and :meth:`Federation.run` drives the asynchronous engine (staleness,
blocks, all five methods) on that device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import VFLConfig
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core import async_engine
from repro_torch.core.adapters import ModelAdapter, tabular_adapter
from repro_torch.core.draws import DrawSource, TorchDraws
from repro_torch.core.methods import canonical_method
from repro_torch.core.partition import tree_map
from repro_torch.core.privacy import GaussianLossChannel
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federation.transport import Transport

ModelLike = Union[ModelAdapter, PaperMLPConfig]


def _to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype)


@dataclasses.dataclass
class Federation:
    """A built training session; construct via :meth:`build`."""
    vfl: VFLConfig
    engine: async_engine.EngineConfig
    transport: Transport
    device: torch.device
    adapter: ModelAdapter

    @classmethod
    def build(cls, model_cfg: ModelLike,
              vfl_cfg: Optional[VFLConfig] = None,
              engine_cfg: Optional[async_engine.EngineConfig] = None, *,
              noise: Optional[GaussianLossChannel] = None,
              transport: Optional[Transport] = None,
              device: DeviceLike = None) -> "Federation":
        """One constructor for the training entry points.

        ``model_cfg`` may be a ready :class:`ModelAdapter` or the paper's
        ``PaperMLPConfig`` (tabular protocol). ``noise`` plugs a DP channel
        into the transport's loss downlink. ``device=None`` means the CUDA
        card and raises without one; pass ``device="cpu"`` for the CPU."""
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
        if isinstance(model_cfg, ModelAdapter):
            adapter = model_cfg
        elif isinstance(model_cfg, PaperMLPConfig):
            adapter = tabular_adapter(model_cfg)
        else:
            raise TypeError(
                f"model_cfg must be a ModelAdapter or PaperMLPConfig, got "
                f"{type(model_cfg).__name__}")
        return cls(vfl=vfl, engine=engine, transport=transport,
                   device=resolve_device(device), adapter=adapter)

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
