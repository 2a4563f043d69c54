"""Deterministic fault injection for the wire plane.

A :class:`FaultPlan` is a pure function from ``(seed, round, party,
direction, attempt)`` to delivery outcomes: every decision draws from
``np.random.default_rng`` seeded with exactly that tuple, so the plan
carries NO mutable state — replaying round t after a checkpoint restore
reproduces the straight-through run's drops, latencies and retries
bit-for-bit, which is what makes the durable async plane exact.

Time here is *virtual*: latencies, jitter and retry backoff accumulate
into millisecond accounting (straggler admission, the engine's clock)
without ever sleeping the host. The plan is an accounting and scheduling
overlay on the real backend — a "dropped" frame still crosses the actual
wire once (so remote workers stay in lockstep with the engine), but it
costs the retried bytes and the timeout budget, and the engine treats the
payload as undelivered.

:class:`ChaosPlan` / :class:`ChaosBackend` are the PROCESS-level layer on
top: where :class:`FaultPlan` models faults in virtual time, the chaos
backend inflicts them for real — it wraps a concrete backend and kills
the process at frame n (``kill -9`` semantics), corrupts or truncates a
frame's bytes on the wire (the far side raises
:class:`~repro_torch.wire.codec.FrameCorruption`), or stalls a send. The
kill/recovery tests drive it.

Ported from the JAX package's ``wire/faults.py`` unchanged: the plan is
numpy, so both packages draw the same drops, latencies and retries.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.wire import codec
from repro_torch.wire.codec import WireMessage

# seed-tuple salt keeping the fault stream disjoint from anything else
# seeded from small integers
_SALT = 0x57495245  # "WIRE"
_DIR = {"up": 0, "down": 1}


class Attempt(NamedTuple):
    """One transmission attempt inside a delivery (audit trail)."""
    attempt: int        # 0-based attempt index
    dropped: bool
    elapsed_ms: float   # this attempt's virtual cost (timeout or latency)


class Delivery(NamedTuple):
    """Outcome of delivering one logical payload over a faulty wire."""
    ok: bool            # delivered within the retry budget
    attempts: int       # frames actually transmitted (1 = clean)
    elapsed_ms: float   # virtual wall time: timeouts + final latency
    history: Tuple[Attempt, ...] = ()   # per-attempt audit trail


class DeliveryFailed(ConnectionError):
    """Retry budget exhausted on a faulty wire.

    Carries the full delivery context — which (seed, round, party,
    direction) stream failed and every attempt's outcome — so the caller
    logs a reproducible failure instead of a bare timeout."""

    def __init__(self, *, seed: int, rnd: int, party: int, direction: str,
                 delivery: "Delivery") -> None:
        self.seed = seed
        self.round = rnd
        self.party = party
        self.direction = direction
        self.delivery = delivery
        trail = ", ".join(
            f"#{a.attempt}: {'drop' if a.dropped else 'ok'} "
            f"(+{a.elapsed_ms:.1f}ms)" for a in delivery.history)
        super().__init__(
            f"delivery failed after {delivery.attempts} attempts "
            f"(seed={seed}, round={rnd}, party={party}, "
            f"direction={direction!r}): {trail}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Per-party drop/latency/retry model, deterministic from ``seed``.

    ``drop`` / ``latency_ms`` / ``jitter_ms`` are the population-wide
    defaults; ``party_drop`` / ``party_latency_ms`` override single
    parties as ``((party, value), ...)`` pairs (tuples, not dicts — the
    plan is hashable and frozen like every other protocol value object).
    A failed attempt costs ``timeout_ms * backoff**attempt`` virtual ms;
    after ``max_retries`` retries the payload is undelivered and the
    engine degrades (skips the party's round) instead of hanging."""
    seed: int = 0
    drop: float = 0.0
    latency_ms: float = 0.0
    jitter_ms: float = 0.0
    timeout_ms: float = 100.0
    max_retries: int = 3
    backoff: float = 2.0
    party_drop: Tuple[Tuple[int, float], ...] = ()
    party_latency_ms: Tuple[Tuple[int, float], ...] = ()

    def __post_init__(self) -> None:
        if not 0.0 <= self.drop < 1.0:
            raise ValueError(f"drop must be in [0, 1), got {self.drop}")
        if self.max_retries < 0 or self.timeout_ms < 0:
            raise ValueError(
                f"need max_retries >= 0 and timeout_ms >= 0, got "
                f"{self.max_retries}, {self.timeout_ms}")
        for party, p in self.party_drop:
            if not 0.0 <= p <= 1.0:
                raise ValueError(
                    f"party_drop[{party}] must be in [0, 1], got {p}")

    @classmethod
    def none(cls) -> "FaultPlan":
        """The clean wire: every delivery succeeds in one attempt at zero
        virtual latency (the bitwise-parity configuration)."""
        return cls()

    @property
    def active(self) -> bool:
        return bool(self.drop or self.latency_ms or self.jitter_ms
                    or self.party_drop or self.party_latency_ms)

    # ------------------------------------------------------------ knobs --
    def drop_for(self, party: int) -> float:
        for m, p in self.party_drop:
            if m == party:
                return p
        return self.drop

    def latency_for(self, party: int) -> float:
        for m, l in self.party_latency_ms:
            if m == party:
                return l
        return self.latency_ms

    # ---------------------------------------------------------- sampling --
    def _rng(self, rnd: int, party: int, direction: str,
             attempt: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed, _SALT, rnd, party, _DIR[direction], attempt))

    def delivery(self, rnd: int, party: int, direction: str) -> Delivery:
        """Deliver one payload, retrying dropped attempts with exponential
        backoff. Pure in (seed, rnd, party, direction)."""
        if not self.active:
            return Delivery(True, 1, 0.0, (Attempt(0, False, 0.0),))
        p_drop = self.drop_for(party)
        latency = self.latency_for(party)
        elapsed = 0.0
        trail = []
        for attempt in range(self.max_retries + 1):
            rng = self._rng(rnd, party, direction, attempt)
            if rng.uniform() < p_drop:
                cost = self.timeout_ms * self.backoff ** attempt
                trail.append(Attempt(attempt, True, cost))
                elapsed += cost
                continue
            lat = (rng.normal(latency, self.jitter_ms) if self.jitter_ms
                   else latency)
            trail.append(Attempt(attempt, False, max(0.0, lat)))
            return Delivery(True, attempt + 1, elapsed + max(0.0, lat),
                            tuple(trail))
        return Delivery(False, self.max_retries + 1, elapsed, tuple(trail))

    def require(self, rnd: int, party: int, direction: str) -> Delivery:
        """Like :meth:`delivery`, but retry-budget exhaustion raises a
        typed :class:`DeliveryFailed` carrying the attempt history instead
        of returning ``ok=False`` — for callers that treat an undelivered
        payload as an error rather than a degradation."""
        d = self.delivery(rnd, party, direction)
        if not d.ok:
            raise DeliveryFailed(seed=self.seed, rnd=rnd, party=party,
                                 direction=direction, delivery=d)
        return d


# ====================================================== process chaos ======

@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """Real (not virtual) fault injection at the transport layer.

    Frames are counted as they pass through the wrapping
    :class:`ChaosBackend`'s ``send`` (1-based). At the configured frame:

    * ``kill_at_frame`` — ``os._exit(9)`` BEFORE the frame leaves: the
      process vanishes mid-protocol exactly like ``kill -9``.
    * ``corrupt_at_frame`` — one payload bit is flipped; the peer's
      decode raises :class:`~repro_torch.wire.codec.FrameCorruption`.
    * ``truncate_at_frame`` — the frame is cut to ``truncate_to`` bytes
      after the length prefix (the peer sees a short/broken frame).
    * ``stall_at_frame`` — ``time.sleep(stall_s)`` before sending (a
      real straggler, for timeout paths).
    """
    kill_at_frame: Optional[int] = None
    corrupt_at_frame: Optional[int] = None
    truncate_at_frame: Optional[int] = None
    truncate_to: int = 8
    stall_at_frame: Optional[int] = None
    stall_s: float = 0.0


class ChaosBackend:
    """A :class:`~repro_torch.wire.backend.WireBackend` wrapper that inflicts a
    :class:`ChaosPlan` on the frames it sends. The inner backend must
    expose ``send_bytes`` (both :class:`LoopbackBackend` and
    :class:`SocketBackend` do) so corruption happens on the actual wire
    bytes, after encoding."""

    def __init__(self, inner: Any, plan: ChaosPlan) -> None:
        self.inner = inner
        self.plan = plan
        self.frames_sent = 0

    def send(self, msg: WireMessage) -> int:
        self.frames_sent += 1
        n, plan = self.frames_sent, self.plan
        if plan.stall_at_frame == n and plan.stall_s > 0:
            time.sleep(plan.stall_s)
        if plan.kill_at_frame == n:
            os._exit(9)     # the whole point: no cleanup, no goodbyes
        buf = codec.frame(codec.encode(msg))
        if plan.corrupt_at_frame == n:
            flip = bytearray(buf)
            flip[-1] ^= 0x01            # last payload byte: a real bit flip
            buf = bytes(flip)
        elif plan.truncate_at_frame == n:
            body = buf[codec.FRAME_OVERHEAD:]
            cut = body[:max(0, plan.truncate_to)]
            # keep the length prefix honest so the peer reads a complete
            # (but short) frame and fails in decode, not in framing
            buf = codec.frame(cut)
        self.inner.send_bytes(buf)
        return len(buf)

    def recv(self, timeout: Optional[float] = None
             ) -> Tuple[WireMessage, int]:
        out: Tuple[WireMessage, int] = self.inner.recv(timeout=timeout)
        return out

    def close(self) -> None:
        self.inner.close()
