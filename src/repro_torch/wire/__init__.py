"""``repro_torch.wire`` — the wire plane: real transport backends under
the ``federation.Transport`` accounting interface, ported from the JAX
package's ``repro.wire`` with the same frames byte for byte.

* :mod:`repro_torch.wire.codec` — tagged, versioned messages and their
  byte encoding (the checkpoint plane's uint-view codec, so bf16 payloads
  round-trip losslessly); v2 frames carry a CRC32 and damaged bytes raise
  :class:`FrameCorruption`.
* :mod:`repro_torch.wire.backend` — :class:`WireBackend` protocol with
  :class:`LoopbackBackend` (in-proc queue, the default) and
  :class:`SocketBackend` (length-prefixed TCP frames with optional
  reconnect-with-backoff self-healing, so a client party can run in
  another process and survive a flapping connection).
* :mod:`repro_torch.wire.faults` — :class:`FaultPlan`: deterministic
  per-party drop/latency/retry injection in virtual time (typed
  :class:`DeliveryFailed` on budget exhaustion), plus the process-level
  :class:`ChaosPlan`/:class:`ChaosBackend` layer (kill at frame n,
  corrupt/truncate/stall real frames).
* :mod:`repro_torch.wire.worker` — :class:`ClientWorker`: one client
  party behind a wire endpoint, restartable from a party-scoped
  checkpoint, answering :func:`heartbeat` liveness probes.
"""
from repro_torch.wire.backend import (LoopbackBackend, SocketBackend,
                                      WireBackend, WireClosed, WireTimeout,
                                      accept, listen)
from repro_torch.wire.codec import (WIRE_VERSION, FrameCorruption,
                                    WireMessage, decode, encode, frame)
from repro_torch.wire.faults import (Attempt, ChaosBackend, ChaosPlan,
                                     Delivery, DeliveryFailed, FaultPlan)
from repro_torch.wire.worker import ClientWorker, heartbeat

__all__ = [
    "WIRE_VERSION", "WireMessage", "encode", "decode", "frame",
    "FrameCorruption",
    "WireBackend", "LoopbackBackend", "SocketBackend", "WireClosed",
    "WireTimeout", "listen", "accept",
    "FaultPlan", "Delivery", "Attempt", "DeliveryFailed",
    "ChaosPlan", "ChaosBackend",
    "ClientWorker", "heartbeat",
]
