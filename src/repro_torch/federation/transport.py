"""The wire as a first-class object.

Every byte that crosses the party boundary — embeddings up, scalar losses
(or, for the leaky FOO baselines, partial derivatives) down, and at serve
time embeddings up and sampled token ids down — is owned by
a :class:`Transport`: it resolves the protocol's canonical method name
once (``repro_torch.core.methods``), builds the q-aware
:class:`privacy.Ledger` for a run, and exposes the ONE mutation point the
protocol allows on the downlink: a pluggable noise hook on the
scalar-loss channel (:class:`repro_torch.core.privacy.GaussianLossChannel`).

``Transport`` is a frozen value object and :meth:`downlink` is pure
(identity when no channel is configured); its noise normals come from
the run's draw source.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.analysis import marks, tags
from repro_torch.core.methods import (SYNC_METHODS, ZOO_WIRE_METHODS,
                                      canonical_method)
from repro_torch.core.privacy import (GaussianLossChannel, Ledger,
                                      Message, serve_messages)


@dataclasses.dataclass(frozen=True)
class Transport:
    """Wire protocol of one federation: canonical method + noise hook."""
    method: str = "cascaded"
    noise: Optional[GaussianLossChannel] = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "method", canonical_method(self.method))
        if self.noise is not None:
            if self.method not in ZOO_WIRE_METHODS:
                raise ValueError(
                    f"the DP loss channel applies to the scalar-loss "
                    f"downlink of ZOO-wire methods; {self.method!r} sends "
                    "partial derivatives down (nothing to clip+noise)")
            if self.method in SYNC_METHODS:
                raise ValueError(
                    f"the sync simulation of {self.method!r} shares one "
                    "global ZOO draw across parties — per-client downlink "
                    "noise is only meaningful for the asynchronous methods")

    # ------------------------------------------------------- wire shape --
    @property
    def sync(self) -> bool:
        return self.method in SYNC_METHODS

    @property
    def zoo_wire(self) -> bool:
        return self.method in ZOO_WIRE_METHODS

    # ---------------------------------------------------------- downlink --
    @tags.wire("down", accounted_by="Transport.account", kind="loss",
               reason="the one legal downlink: scalar losses, DP-noised "
                      "when a channel is configured")
    def downlink(self, losses: torch.Tensor,
                 normals: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The scalar-loss downlink hook (server -> client).

        Identity when no noise channel is configured; otherwise clips +
        noises every scalar crossing down, with ``normals`` (N(0, 1),
        shaped like ``losses``) from the run's draw source.

        Every return path factors through ``marks.wire_boundary`` (and,
        under a channel, ``marks.dp_noise``): identities outside the
        certifier's trace, they anchor this, the ONE legal loss downlink,
        in the traced graph so ``repro_torch.analysis.ifc`` can certify
        the scalar bottleneck (IF302) and noise-before-wire (IF303)."""
        if self.noise is None:
            return marks.wire_boundary(losses, kind="loss",
                                       direction="down")
        if normals is None:
            raise ValueError("a noised downlink needs its N(0, 1) draws")
        noised = marks.dp_noise(self.noise.apply(losses, normals))
        return marks.wire_boundary(noised, kind="loss", direction="down")

    # --------------------------------------------------------- accounting --
    @tags.accounting
    def account(self, *, batch: int, embed: int, zoo_queries: int = 1,
                n_clients: int = 1, n_rounds: int = 1,
                ledger: Optional[Ledger] = None) -> Ledger:
        """Build (or extend) the run's wire ledger — the Transport owns
        accounting."""
        ledger = Ledger() if ledger is None else ledger
        ledger.log_round(self.method, batch, embed,
                         zoo_queries=zoo_queries if self.zoo_wire else 1,
                         n_clients=n_clients, n_rounds=n_rounds)
        return ledger

    @tags.accounting
    def account_serve(self, *, batch: int, embed: int, n_steps: int = 1,
                      n_gen: Optional[int] = None,
                      ledger: Optional[Ledger] = None) -> Ledger:
        """Log ``n_steps`` split-inference steps: per step the owning
        client uploads one (batch, d_model) embedding, and on the
        ``n_gen`` generation steps (all of them if not given) the server
        returns the sampled token ids — prefill steps carry no downlink
        (the clients already own the prompt). Serve traffic lands in the
        same ledger as training, so a session's lifetime wire is one
        total."""
        n_gen = n_steps if n_gen is None else n_gen
        if not 0 <= n_gen <= n_steps:
            raise ValueError(f"n_gen={n_gen} outside [0, n_steps={n_steps}]")
        ledger = Ledger() if ledger is None else ledger
        ledger.messages.extend(
            serve_messages(batch, embed, with_token=False)
            * (n_steps - n_gen))
        ledger.messages.extend(serve_messages(batch, embed) * n_gen)
        return ledger

    @tags.accounting
    def account_serve_step(self, *, batch: int, embed: int,
                           gen: bool = True,
                           ledger: Optional[Ledger] = None) -> Ledger:
        """One split-inference step for one request: the continuous
        scheduler's metering grain, so a request's total equals what a
        solo decode of the same request logs."""
        return self.account_serve(batch=batch, embed=embed, n_steps=1,
                                  n_gen=1 if gen else 0, ledger=ledger)

    @tags.accounting
    def account_wire(self, message: Message, *, copies: int = 1,
                     ledger: Optional[Ledger] = None) -> Ledger:
        """Meter one MEASURED wire frame from a ``repro_torch.wire``
        backend.

        ``message.wired`` carries the actual serialized byte count (frame
        header + length prefix included), while ``message.nbytes`` stays
        the per-round formula — so the ledger's ``serialized_bytes`` is a
        measurement and ``total_bytes`` survives as its cross-check.
        ``copies > 1`` logs retransmissions of the same frame (a
        ``FaultPlan`` retry resends identical bytes)."""
        if message.wired is None:
            raise ValueError(
                "account_wire meters measured frames; build the Message "
                "with wired=<serialized byte count> (use account()/"
                "log_round for formula-only accounting)")
        ledger = Ledger() if ledger is None else ledger
        ledger.messages.extend([message] * copies)
        return ledger

    def releases(self, *, n_rounds: int, n_clients: int = 1,
                 zoo_queries: int = 1) -> int:
        """Gaussian-mechanism releases in a run: each activated client
        receives (1 clean + q perturbed) noised scalars per round. The
        single source of truth for the accountant's composition count."""
        if not self.zoo_wire:
            return 0
        return n_rounds * n_clients * (1 + zoo_queries)

    def privacy_spent(self, n_releases: int) -> Tuple[float, float]:
        """Total (ε, δ) after ``n_releases`` noised downlink scalars.

        (inf, 0) without a channel: the wire is structurally safe (§V)
        but carries no formal DP guarantee."""
        if self.noise is None:
            return math.inf, 0.0
        return self.noise.spent(n_releases)
