"""Configuration dataclasses for the port's VFL protocol.

``VFLConfig`` describes the party plane (number of clients, optimization
method per party, ZOO hyper-parameters): the same fields and defaults as
the JAX package's, so a run is configured identically in both.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class VFLConfig:
    """Party-plane configuration (the paper's protocol)."""
    n_clients: int = 1
    client_opt: str = "zoo"        # zoo | foo  (paper: zoo)
    server_opt: str = "foo"        # foo | zoo  (paper: foo; zoo-vfl: zoo)
    asynchronous: bool = True
    # ZOO hyper-parameters (paper §III-B, §VI-A)
    mu: float = 1e-3               # smoothing parameter μ
    zoo_dist: str = "sphere"       # sphere (φ=d) | normal (φ=1)
    zoo_queries: int = 1           # q-point averaging (beyond-paper)
    active_rows_only: bool = False # perturb only touched embedding rows
    # async simulation
    max_delay: int = 16            # τ bound (assumption IV.7)
    activation_probs: Optional[Tuple[float, ...]] = None  # p_m; None=uniform
    # learning rates (paper tunes server/client separately)
    lr_server: float = 0.01
    lr_client: float = 0.01
    # §Perf: the clean + q perturbed forwards run as ONE vmapped server
    # pass over stacked lanes (FSDP weight all-gathers happen once instead
    # of 1+q times; compile time constant in q). False selects the unrolled
    # per-query oracle — test-only numerical reference, never production.
    fused_dual: bool = True
    # test-only: route zoo_gradient through the original per-query Python
    # loop instead of the vectorized lane stack (oracle for equality tests)
    zoo_unrolled_oracle: bool = False

