"""Typed party handles: every plane addresses state through a party.

The paper's security argument is a statement about the PARTY boundary —
clients never expose internal state, the server never learns client
parameters. :class:`ServerParty` / :class:`ClientParty` make that boundary
an object: each handle knows which slice of a parameter tree it owns, in
both layouts the session trains in —

* the ENGINE layout ``{"clients": (M, ...), "server": ...}`` the async
  protocol runs on (client m owns row m of the stacked client tree), and
* the GLOBAL layout of ``model_api.build_model`` the sync cascade trains
  (the client partition is the ``client_keys`` subtree — the replicated
  bottom layer every client party holds a copy of).

``Federation.save`` writes one checkpoint directory per party through
these handles, so the isolation property is structural: the server's
directory cannot contain a client leaf because the server handle cannot
even address one. Ported from the JAX package's ``federation/parties.py``
over trees of tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Tuple, Union

import torch

from repro_torch.analysis import tags
from repro_torch.core.partition import merge_params, split_params
from repro_torch.tree import tree_map


def is_engine_layout(params: Any) -> bool:
    """True for the async engine's {"clients", "server"} param layout."""
    return isinstance(params, dict) and set(params) == {"clients", "server"}


@dataclasses.dataclass(frozen=True)
class ServerParty:
    """The label/backbone owner: everything outside ``client_keys``."""
    client_keys: Tuple[str, ...]
    name: str = "server"

    @tags.party("server")
    def owned(self, params: Any) -> Any:
        """The server's slice of ``params`` (either layout)."""
        if is_engine_layout(params):
            return params["server"]
        _, server = split_params(params, self.client_keys)
        return server


@dataclasses.dataclass(frozen=True)
class ClientParty:
    """Feature-owner m: its stacked row (engine layout) or its copy of the
    replicated bottom layer (global layout — shared across parties)."""
    index: int
    client_keys: Tuple[str, ...]

    @property
    def name(self) -> str:
        return f"client_{self.index:02d}"

    @tags.party("client")
    def owned(self, params: Any) -> Any:
        if is_engine_layout(params):
            return tree_map(lambda a: a[self.index], params["clients"])
        client, _ = split_params(params, self.client_keys)
        return client


@dataclasses.dataclass(frozen=True)
class Parties:
    """All handles of one federation: ``fed.parties.server`` plus
    ``fed.parties.clients[m]``; iterable server-first."""
    server: ServerParty
    clients: Tuple[ClientParty, ...]

    def __iter__(self) -> Iterator[Union[ServerParty, ClientParty]]:
        yield self.server
        yield from self.clients

    def __len__(self) -> int:
        return 1 + len(self.clients)

    def assemble(self, server_tree: Any, client_trees: Any) -> Any:
        """Inverse of the per-party split: stack the client slices back
        into the engine layout (the canonical party-scoped layout)."""
        clients = tree_map(lambda *rows: torch.stack(rows), *client_trees)
        return {"clients": clients, "server": server_tree}

    def merge_global(self, server_tree: Any, client_tree: Any) -> Any:
        """Rebuild a GLOBAL-layout tree from its two party partitions."""
        return merge_params(client_tree, server_tree)
