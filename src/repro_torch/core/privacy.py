"""Communication & privacy ledger, plus the DP loss channel.

Static, per-round accounting of *what crosses the wire* under each
framework — the paper's security argument (§V) is structural: ZOO modes
transmit embeddings up and scalar losses down, never gradients or model
internals. The ledger makes that checkable in tests and reportable in
benchmarks (per-round bytes for the communication-efficiency comparison).

The accounting is q-aware: with ``zoo_queries = q`` the client uploads
the clean embedding plus q perturbed embeddings ĉ_i, and the server
returns the clean loss h plus q perturbed losses ĥ_i — so the perturbed
traffic scales exactly linearly in q while the clean messages do not.
Method spellings are normalized through :mod:`repro_torch.core.methods`, so
every name accepted by ``cascade``/``async_engine`` is accepted here.

:class:`GaussianLossChannel` upgrades the structural argument to a formal
(ε, δ) one (DPZV-style): the only server→client payload under a ZOO wire
is a handful of scalar losses, so clipping each scalar and adding
calibrated Gaussian noise makes every downlink a release of the Gaussian
mechanism. ``repro_torch.federation.Transport`` plugs the channel into the
engine; the channel itself is pure config + math. Its noise comes from
the run's draw source (``repro_torch.core.draws``), so a test can hand
both packages the same normals.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import tags
from repro_torch.core.methods import (FOO_WIRE_METHODS, ZOO_WIRE_METHODS,
                                      canonical_method)

GRADIENT_KINDS = frozenset({"partial_derivative", "gradient", "jacobian"})


# dtype names numpy knows only through an extension package (the wire
# codec's true-dtype names of bfloat16/float8 payloads)
_EXTENSION_ITEMSIZE = {"bfloat16": 2, "float8_e4m3fn": 1, "float8_e5m2": 1}


def _itemsize(dtype: str) -> int:
    size = _EXTENSION_ITEMSIZE.get(dtype)
    return np.dtype(dtype).itemsize if size is None else size


@dataclasses.dataclass(frozen=True)
class Message:
    sender: str        # "client" | "server"
    kind: str          # "embedding" | "loss" | "partial_derivative"
    shape: Tuple[int, ...]
    dtype: str = "float32"
    # MEASURED bytes on the wire (the serialized frame, length prefix and
    # header included) when this message crossed a real wire
    # backend; None for formula-only accounting. ``nbytes`` stays the
    # payload formula either way, so the formula count survives as a
    # cross-check against the measurement.
    wired: Optional[int] = None

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * _itemsize(self.dtype)

    @property
    def bytes_on_wire(self) -> int:
        """Measured frame size when available, formula count otherwise."""
        return self.nbytes if self.wired is None else self.wired

    @property
    def overhead(self) -> int:
        """Serialization overhead over the payload formula (0 when the
        message never crossed a measuring backend)."""
        return 0 if self.wired is None else self.wired - self.nbytes


def serve_messages(batch: int, embed: int,
                   with_token: bool = True) -> List[Message]:
    """Wire contents of ONE split-inference step.

    The owning client party embeds the current token and uploads the
    (batch, d_model) embedding; on GENERATION steps (``with_token``) the
    server additionally returns the sampled token ids — during prefill
    the clients already hold the prompt, so nothing crosses back down.
    Logits, caches and every internal activation stay server-side, so the
    serve wire is as structurally safe as the training wire (§V)."""
    up = [Message("client", "embedding", (batch, embed))]
    if with_token:
        up.append(Message("server", "token", (batch,), "int32"))
    return up


def round_messages(method: str, batch: int, embed: int,
                   zoo_queries: int = 1) -> List[Message]:
    """Wire contents of ONE activated client's round.

    ZOO-wire methods carry 1 clean + q perturbed embeddings up and
    1 clean + q perturbed scalar-loss vectors down (q = ``zoo_queries``);
    FOO-wire methods carry one embedding up and one ∂L/∂c down — q never
    enters (there is no query fan-out on a first-order wire)."""
    if zoo_queries < 1:
        raise ValueError(f"zoo_queries must be >= 1, got {zoo_queries}")
    method = canonical_method(method)
    up_clean = Message("client", "embedding", (batch, embed))
    if method in ZOO_WIRE_METHODS:
        q = zoo_queries
        return (
            [up_clean]
            + [Message("client", "embedding", (batch, embed))] * q  # ĉ_i
            + [Message("server", "loss", (batch,))]                 # h
            + [Message("server", "loss", (batch,))] * q             # ĥ_i
        )
    assert method in FOO_WIRE_METHODS, method
    return [
        up_clean,
        Message("server", "partial_derivative", (batch, embed)),    # ∂L/∂c
    ]


@dataclasses.dataclass
class Ledger:
    messages: List[Message] = dataclasses.field(default_factory=list)

    @tags.accounting
    def log_round(self, method: str, batch: int, embed: int, *,
                  zoo_queries: int = 1, n_clients: int = 1,
                  n_rounds: int = 1):
        """Log ``n_rounds`` identical global rounds of ``n_clients``
        concurrently activated clients (the async engine's block, or all
        M for sync methods), each exchanging the q-aware per-client
        message set. Messages are frozen, so the repeated entries share
        the same instances — O(1) constructions however many rounds."""
        self.messages.extend(
            round_messages(method, batch, embed, zoo_queries)
            * (n_clients * n_rounds))

    @property
    def total_bytes(self) -> int:
        return sum(m.nbytes for m in self.messages)

    @property
    def serialized_bytes(self) -> int:
        """Actual bytes on the wire: the measured frame size for messages
        that crossed a wire backend, the payload formula for the
        rest. ≥ :attr:`total_bytes` whenever every measurement carries its
        framing/header overhead."""
        return sum(m.bytes_on_wire for m in self.messages)

    @property
    def overhead_bytes(self) -> int:
        """Total measured serialization overhead (headers, length
        prefixes) — ``serialized_bytes - total_bytes`` restricted to the
        measured messages."""
        return sum(m.overhead for m in self.messages)

    @property
    def transmits_gradients(self) -> bool:
        """True iff any internal information leaves a party (§V violated)."""
        return any(m.kind in GRADIENT_KINDS for m in self.messages)

    def bytes_by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for m in self.messages:
            out[m.kind] = out.get(m.kind, 0) + m.nbytes
        return out

    # ------------------------------------------------- serialization ------
    # Checkpoint/resume needs the ledger totals to survive a process
    # restart. Messages are frozen value objects, so the whole history
    # aggregates losslessly into (message, count) pairs — a resumed run
    # extends the restored ledger and the totals continue exactly.

    def to_counts(self) -> List[list]:
        order: List[Message] = []
        counts: Dict[Message, int] = {}
        for m in self.messages:
            if m not in counts:
                order.append(m)
            counts[m] = counts.get(m, 0) + 1
        return [[m.sender, m.kind, list(m.shape), m.dtype, counts[m]]
                + ([] if m.wired is None else [m.wired])
                for m in order]

    @classmethod
    def from_counts(cls, counts: List[list]) -> "Ledger":
        # rows are [sender, kind, shape, dtype, count] with an optional
        # trailing measured-bytes entry — checkpoints written before the
        # wire plane carry 5-element rows and still load
        led = cls()
        for row in counts:
            sender, kind, shape, dtype, n = row[:5]
            wired = int(row[5]) if len(row) > 5 else None
            led.messages.extend([Message(sender, kind, tuple(shape),
                                         dtype, wired=wired)] * int(n))
        return led


# ==================================================== DP loss channel ======

@dataclasses.dataclass(frozen=True)
class GaussianLossChannel:
    """Calibrated Gaussian noise on the scalar-loss downlink.

    Every scalar loss the server sends down is clamped to ``[0, clip]``
    (CE/hinge losses are non-negative; the clamp bounds one release's
    sensitivity by ``clip``) and perturbed with ``N(0, σ²)``, where σ is
    calibrated so ONE release satisfies (``epsilon``, ``delta``)-DP by the
    classic Gaussian-mechanism bound

        σ = clip · √(2 ln(1.25/δ)) / ε          (Dwork & Roth, Thm A.1).

    :meth:`spent` composes the per-release budget over a run's k releases.
    ``accountant="basic"`` (default) takes the better of basic composition
    (kε, kδ) and advanced composition
    (ε√(2k ln(1/δ)) + kε(eᵉ−1),  (k+1)δ) — exact enough to report an
    honest finite budget without an external DP library.
    ``accountant="rdp"`` tracks the Gaussian mechanism in Rényi-DP
    instead: one release with sensitivity Δ=clip and noise σ satisfies
    (α, αΔ²/(2σ²))-RDP for every order α; RDP composes by plain addition,
    and the composed guarantee converts back with
    ε(δ) = min_α [ k·αΔ²/(2σ²) + ln(1/δ)/(α−1) ] at total δ = ``delta`` —
    the moments-accountant bound, asymptotically √k vs advanced
    composition's √(k·ln) and strictly tighter δ (δ, not (k+1)δ).

    ``subsample`` < 1 adds privacy amplification by subsampling for the
    engine's batch draw: each round only touches a Poisson/uniform
    fraction q of the records, so one release's effective budget shrinks
    to the classic amplified bound

        (ε_q, δ_q) = (ln(1 + q·(e^ε − 1)),  q·δ)

    (≈ (qε, qδ) for small ε), and :meth:`spent` composes the AMPLIFIED
    per-release values. σ is unchanged — amplification is a property of
    the sampling, not the noise. With ``accountant="rdp"`` the exact
    subsampled-Gaussian RDP curve is out of scope (needs the
    Mironov/Wang integral); we take the min of the UNamplified RDP bound
    and the amplified basic/advanced bound — both are valid upper bounds,
    so the min is too.

    The channel is deliberately a frozen value object, and ``apply`` is
    pure: the standard normals arrive from the caller's draw source.
    """
    clip: float = 10.0
    epsilon: float = 1.0          # per-release ε target
    delta: float = 1e-5           # per-release δ target
    accountant: str = "basic"     # basic (min of basic/advanced) | rdp
    subsample: float = 1.0        # batch-draw sampling rate q (1 = off)

    # RDP orders swept by the moments accountant (standard grid: dense at
    # small α where few-release budgets convert best, log-spaced beyond)
    RDP_ORDERS = (1.25, 1.5, 1.75, 2.0, 2.5, 3.0, 4.0, 6.0, 8.0, 16.0,
                  32.0, 64.0, 128.0, 256.0, 512.0)

    def __post_init__(self):
        if self.clip <= 0 or self.epsilon <= 0 or not 0 < self.delta < 1:
            raise ValueError(
                f"need clip > 0, epsilon > 0, 0 < delta < 1; got "
                f"clip={self.clip}, epsilon={self.epsilon}, "
                f"delta={self.delta}")
        if self.accountant not in ("basic", "rdp"):
            raise ValueError(
                f"accountant must be 'basic' or 'rdp', "
                f"got {self.accountant!r}")
        if not 0.0 < self.subsample <= 1.0:
            raise ValueError(
                f"subsample must be a sampling rate in (0, 1], got "
                f"{self.subsample}")

    @property
    def sigma(self) -> float:
        """Noise stddev calibrated to the per-release (ε, δ) target."""
        return (self.clip * math.sqrt(2.0 * math.log(1.25 / self.delta))
                / self.epsilon)

    @tags.party("server")
    def apply(self, losses, normals):
        """Clip + noise a (vector of) scalar loss(es) crossing the wire;
        ``normals`` are N(0, 1) draws shaped like ``losses``."""
        clipped = torch.clamp(losses, 0.0, self.clip)
        return clipped + self.sigma * normals

    def per_release(self) -> Tuple[float, float]:
        """One release's effective (ε, δ): the configured target, shrunk
        by subsampling amplification when ``subsample`` < 1."""
        if self.subsample >= 1.0:
            return self.epsilon, self.delta
        q = self.subsample
        return (math.log1p(q * (math.expm1(self.epsilon))),
                q * self.delta)

    @staticmethod
    def _compose_basic(k: int, eps: float, delta: float
                       ) -> Tuple[float, float]:
        """min(basic, advanced) composition of k (eps, delta) releases."""
        basic = (k * eps, k * delta)
        advanced = (
            eps * math.sqrt(2.0 * k * math.log(1.0 / delta))
            + k * eps * (math.exp(eps) - 1.0),
            (k + 1) * delta,
        )
        return min(basic, advanced, key=lambda ed: ed[0])

    def spent(self, n_releases: int) -> Tuple[float, float]:
        """Total (ε, δ) after ``n_releases`` downlink scalars."""
        k = int(n_releases)
        if k <= 0:
            return 0.0, 0.0
        if self.accountant == "rdp":
            rdp = self._spent_rdp(k)
            if self.subsample >= 1.0:
                return rdp
            # no exact subsampled-Gaussian RDP curve here: both the
            # unamplified RDP bound and the amplified basic/advanced
            # bound hold, so report whichever is tighter
            amplified = self._compose_basic(k, *self.per_release())
            return min(rdp, amplified, key=lambda ed: ed[0])
        return self._compose_basic(k, *self.per_release())

    def _spent_rdp(self, k: int) -> Tuple[float, float]:
        """Moments accountant: compose k Gaussian releases in RDP, convert
        back at the fixed total δ = ``self.delta``."""
        # per-release RDP coefficient: ε_RDP(α) = α · Δ²/(2σ²)
        rho = (self.clip / self.sigma) ** 2 / 2.0
        log_inv_delta = math.log(1.0 / self.delta)
        eps = min(k * a * rho + log_inv_delta / (a - 1.0)
                  for a in self.RDP_ORDERS)
        return eps, self.delta
