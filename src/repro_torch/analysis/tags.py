"""Annotation registry for the party-boundary and trace-hygiene analyzers.

The decorators here are runtime-inert: they attach metadata attributes to
the decorated function and return it unchanged. The static passes in
``analysis.boundary`` and ``analysis.jitlint`` read the *decorator syntax*
from the AST (they never import the analyzed modules), so the single source
of truth for what a decorator means lives in this module, next to the
name-based registries the passes fall back on for adapter hooks that are
built dynamically (closures stored on ``ModelAdapter`` fields).

Annotation contract
-------------------
``@tags.party("client"|"server")``
    The function body executes on that party. Client-tagged code may touch
    raw features and client leaves; server-tagged code may not.

``@tags.wire(direction, accounted_by=..., kind=..., reason=...)``
    The function intentionally moves a value across the party boundary
    ("up" = client->server, "down" = server->client). ``accounted_by`` must
    name a ``Transport`` accounting method (``Transport.account_serve``,
    ...) — rule PB104 verifies the target exists and is itself tagged
    ``@tags.accounting``. ``kind`` describes the payload (e.g. "embedding",
    "loss", "partial_derivative") and is what makes deliberately-leaky
    baselines (VAFL's FOO downlink) *declared* rather than silent.

``@tags.accounting``
    A ``Transport``/``Ledger`` method that meters a wire crossing. Only
    methods carrying this tag are legal ``accounted_by`` targets.

``@tags.hot_loop``
    The function is a steady-state serve-plane step: host syncs and
    host->device uploads are flagged *anywhere* in its body, not just
    inside ``for``/``while`` statements.

``@tags.host_boundary(reason)``
    The function is a sanctioned host<->device crossing point (e.g. the
    once-per-wave retirement fetch). Host-sync rules skip its body; the
    mandatory reason documents why the crossing is amortized.

Suppressions
------------
A finding on line N is suppressed by ``# analysis: ignore[RULE] reason``
on line N or N-1. An empty reason is itself an error (BA001): every
suppression must say *why* the flow/sync is acceptable.
"""

from __future__ import annotations

import typing

_F = typing.TypeVar("_F", bound=typing.Callable[..., typing.Any])

PARTIES = ("client", "server")
WIRE_DIRECTIONS = ("up", "down")


def party(name: str) -> typing.Callable[[_F], _F]:
    """Mark a function as executing on one party ("client" or "server")."""
    if name not in PARTIES:
        raise ValueError(f"unknown party {name!r}; expected one of {PARTIES}")

    def deco(fn: _F) -> _F:
        fn.__vfl_party__ = name  # type: ignore[attr-defined]
        return fn

    return deco


def wire(
    direction: str,
    *,
    accounted_by: str,
    kind: str = "embedding",
    reason: str = "",
) -> typing.Callable[[_F], _F]:
    """Declare a legal cross-party value flow inside the decorated function."""
    if direction not in WIRE_DIRECTIONS:
        raise ValueError(
            f"unknown wire direction {direction!r}; expected one of {WIRE_DIRECTIONS}"
        )

    def deco(fn: _F) -> _F:
        # stacked @wire decorators accumulate (a function may declare both
        # an "up" and a "down" channel, e.g. the VAFL partial-derivative
        # baseline) — mirror the AST pass, which reads every decorator
        wires = list(getattr(fn, "__vfl_wire__", []))
        wires.append(
            {
                "direction": direction,
                "accounted_by": accounted_by,
                "kind": kind,
                "reason": reason,
            }
        )
        fn.__vfl_wire__ = wires  # type: ignore[attr-defined]
        return fn

    return deco


def accounting(fn: _F) -> _F:
    """Mark a Transport/Ledger method as a wire-accounting point."""
    fn.__vfl_accounting__ = True  # type: ignore[attr-defined]
    return fn


def hot_loop(fn: _F) -> _F:
    """Mark a function as a steady-state serve step (strict host-sync rules)."""
    fn.__vfl_hot_loop__ = True  # type: ignore[attr-defined]
    return fn


def host_boundary(reason: str) -> typing.Callable[[_F], _F]:
    """Mark a function as a sanctioned, amortized host<->device crossing."""
    if not reason:
        raise ValueError("host_boundary requires a non-empty reason")

    def deco(fn: _F) -> _F:
        fn.__vfl_host_boundary__ = reason  # type: ignore[attr-defined]
        return fn

    return deco


# ---------------------------------------------------------------------------
# Name-based registries. Adapter hooks are plain closures stored on
# ``ModelAdapter`` dataclass fields, so call sites look like
# ``adapter.client_embed(...)``; the static pass resolves party ownership
# from the *attribute name* via these tables. Keep them in sync with
# ``core/adapters.py``.
# ---------------------------------------------------------------------------

# Attribute names whose call RESULT is client-owned data (embeddings/raw
# feature projections computed from client leaves).
CLIENT_SOURCE_ATTRS: frozenset[str] = frozenset(
    {"client_forward", "client_embed", "client_lanes"}
)

# Attribute names that execute on the server: passing client-sourced values
# into them is a boundary crossing (PB101) unless wire-declared.
SERVER_SINK_ATTRS: frozenset[str] = frozenset(
    {"server_loss", "server_decode", "server_prefill", "server_decode_paged"}
)

# Subscript keys that select party-owned parameter subtrees:
# ``params["clients"]`` / ``params["server"]``.
CLIENT_PARAM_KEYS: frozenset[str] = frozenset({"clients"})
SERVER_PARAM_KEYS: frozenset[str] = frozenset({"server"})

# jax transforms whose result is gradient-typed (PB102 sources).
GRADIENT_SOURCES: frozenset[str] = frozenset(
    {"grad", "value_and_grad", "vjp", "jacrev", "jacfwd", "jacobian"}
)

# Attribute/function names that sanitize a server->client loss downlink
# (DP noise + ledger metering happen inside).
DOWNLINK_SANITIZERS: frozenset[str] = frozenset({"downlink"})

# ZOO consumers of downlinked losses: feeding them *raw* server losses
# (bypassing Transport.downlink) is PB105.
DOWNLINK_CONSUMERS: frozenset[str] = frozenset({"grad_from_losses", "two_point_grad"})

# Names that denote server-side loss evaluation; values derived from them
# are "losses computed on the server" for PB105 purposes.
SERVER_LOSS_NAMES: frozenset[str] = frozenset({"server_loss"})

# Parameter names that denote raw (pre-embedding) client features. Their
# appearance inside server-tagged code is PB103.
RAW_FEATURE_PARAMS: frozenset[str] = frozenset({"x_parts", "x_m", "x_blk", "x_raw"})

# Modules whose *every* function is treated as serve-plane hot code: host
# syncs inside for/while loops are flagged even without @tags.hot_loop.
HOT_MODULES: tuple[str, ...] = (
    "federation/scheduler.py",
    "federation/serving.py",
    "launch/serve.py",
    # the wire plane's steady-state loops: the worker's serve loop and the
    # transport backends it drains frames through
    "wire/worker.py",
    "wire/backend.py",
)

# Modules (relative to the ``repro`` package root) that define the
# ``@tags.accounting`` targets wire declarations may name. The CLI seeds
# its accounting set from these even on a PARTIAL scan (e.g.
# ``python -m repro.analysis src/repro/wire``) — otherwise every
# ``accounted_by="Transport.account_wire"`` in an out-of-scan module would
# be a spurious PB104.
ACCOUNTING_MODULES: tuple[str, ...] = (
    "federation/transport.py",
    "core/privacy.py",
)

# Host-sync call forms (device->host) recognized by TH201.
HOST_SYNC_FUNCS: frozenset[str] = frozenset(
    {"np.asarray", "np.array", "numpy.asarray", "numpy.array", "jax.device_get"}
)
HOST_SYNC_METHODS: frozenset[str] = frozenset({"item", "tolist", "block_until_ready"})
HOST_SYNC_BUILTINS: frozenset[str] = frozenset({"float", "int", "bool"})

# Device-upload call forms (host->device) — flagged by TH201 only inside
# @tags.hot_loop bodies, where a per-step upload defeats the device-resident
# scheduler design.
DEVICE_PUT_FUNCS: frozenset[str] = frozenset(
    {"jnp.asarray", "jnp.array", "jax.device_put"}
)
