"""Canonical framework/method names — ONE alias table for every module.

``cascade.py`` (step factories), ``async_engine.py`` (protocol
simulation) and ``privacy.py`` (wire ledger) all dispatch on a method
string, and they historically each kept their own accepted spellings
("split" vs "split-learning", "syn-zoo" vs "syn-zoo-vfl"), which let them
drift until ``round_messages("syn-zoo", ...)`` raised on a name the
engine itself produces. Every module now normalizes through
:func:`canonical_method` so a spelling accepted anywhere is accepted
everywhere.

Canonical names (the paper's five frameworks):
  * ``cascaded`` — ZOO client / FOO server (ours, Alg. 1)
  * ``vafl``     — FOO client / FOO server, asynchronous (leaky wire)
  * ``split``    — FOO both, synchronous Split-Learning (leaky wire)
  * ``zoo-vfl``  — ZOO client / ZOO server, asynchronous
  * ``syn-zoo``  — ZOO everywhere, synchronous
"""
from __future__ import annotations

from typing import Tuple

CASCADED = "cascaded"
VAFL = "vafl"
SPLIT = "split"
ZOO_VFL = "zoo-vfl"
SYN_ZOO = "syn-zoo"

METHOD_ALIASES = {
    "cascaded": CASCADED, "ours": CASCADED,
    "vafl": VAFL,
    "split": SPLIT, "split-learning": SPLIT, "foo": SPLIT,
    "zoo-vfl": ZOO_VFL, "zoo": ZOO_VFL,
    "syn-zoo": SYN_ZOO, "syn-zoo-vfl": SYN_ZOO,
}

# every-client-every-round, fresh embeddings (no table staleness)
SYNC_METHODS: Tuple[str, ...] = (SPLIT, SYN_ZOO)

# wire shape per activated client: embeddings up, scalar losses down —
# the structurally safe protocols of the paper's §V argument
ZOO_WIRE_METHODS: Tuple[str, ...] = (CASCADED, ZOO_VFL, SYN_ZOO)

# wire shape: embedding up, partial derivative ∂L/∂c down (leaky)
FOO_WIRE_METHODS: Tuple[str, ...] = (VAFL, SPLIT)


def canonical_method(method: str) -> str:
    """Map any accepted spelling to its canonical name (ValueError else)."""
    try:
        return METHOD_ALIASES[method]
    except KeyError:
        raise ValueError(
            f"unknown method {method!r}; accepted spellings: "
            f"{sorted(METHOD_ALIASES)}") from None
