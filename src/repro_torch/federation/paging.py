"""Paged slot storage for the continuous-batching serve plane.

Ported from the JAX package's ``federation/paging.py``; the bookkeeping
is the same numpy code, over the port's own :class:`ParamSpec`.

* Sequence-indexed cache leaves (attention K/V: any leaf whose spec
  carries a ``"cache_seq"`` logical axis) move into ONE shared page pool
  of shape ``(layers, n_pages, page_size, *tail)``. A request of total
  length L holds ``ceil(L / page_size)`` pages, so peak pool usage tracks
  the lengths actually in flight.
* Recurrent state leaves (the SSM state and conv tail: ``"cache_batch"``
  but no ``"cache_seq"``) stay slot-stacked: their size does not depend
  on the sequence, so there is nothing to page.

Two pool pages are reserved:

* page ``0`` (``ZERO_PAGE``) is read-only zeros. Block-table entries of
  positions a request never reached point here, so a gather over a
  slot's full table reads exact ``0.0`` beyond its allocation (masked
  positions contribute exactly ``exp(NEG_INF - max) = 0.0`` to attention;
  see ``attention.decode_attend``).
* page ``1`` (``TRASH_PAGE``) absorbs the writes of INACTIVE slots: the
  batched decode step writes a k/v row for every slot, and routing the
  retired slots' rows here means a freed page can be handed to the next
  request without re-zeroing. Its stale contents sit beyond the new
  request's position and are masked exactly.

The host-side :class:`PageAllocator` is a plain free list; block tables
live on the host as ``(max_batch, seq_len // page_size)`` int32 rows and
are uploaded to the device once per change.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Iterable

import numpy as np

from repro_torch.models.common import ParamSpec, is_spec
from repro_torch.tree import tree_map

ZERO_PAGE = 0
TRASH_PAGE = 1
N_RESERVED = 2


def default_page_size(seq_len: int, cap: int = 8) -> int:
    """Largest page size <= ``cap`` that divides ``seq_len`` exactly, so a
    full block table gathers exactly ``seq_len`` positions."""
    for p in range(min(cap, seq_len), 0, -1):
        if seq_len % p == 0:
            return p
    return 1


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How one dense cache leaf maps onto paged storage.

    ``pooled`` leaves drop their ``cache_batch`` axis and split their
    ``cache_seq`` axis into ``(n_pages, page_size)``; state leaves keep
    their layout with the batch axis widened to the slot count."""
    pooled: bool
    batch_axis: int
    seq_axis: int = -1


def leaf_plans(dense_specs: Any) -> Any:
    """LeafPlan tree matching ``cache_specs(1, seq_len)`` leaf for leaf."""

    def one(s: ParamSpec) -> LeafPlan:
        if not is_spec(s):
            raise TypeError(f"expected a ParamSpec leaf, got {type(s)}")
        logical = s.logical if s.logical else (None,) * len(s.shape)
        if "cache_batch" not in logical:
            raise ValueError(
                f"cache spec leaf {s.shape} has no 'cache_batch' logical "
                f"axis ({logical}) — cannot slot-stack it")
        b = logical.index("cache_batch")
        if "cache_seq" in logical:
            q = logical.index("cache_seq")
            if q != b + 1:
                raise ValueError(
                    f"pooled leaf expects cache_seq right after "
                    f"cache_batch, got axes ({b}, {q}) in {logical}")
            return LeafPlan(pooled=True, batch_axis=b, seq_axis=q)
        return LeafPlan(pooled=False, batch_axis=b)

    return tree_map(one, dense_specs)


def paged_specs(dense_specs: Any, *, n_slots: int, n_pages: int,
                page_size: int) -> Any:
    """Transform ``cache_specs(1, seq_len)`` into the paged layout."""
    plans = leaf_plans(dense_specs)

    def one(s: ParamSpec, plan: LeafPlan) -> ParamSpec:
        logical = s.logical if s.logical else (None,) * len(s.shape)
        if plan.pooled:
            b, q = plan.batch_axis, plan.seq_axis
            shape = (s.shape[:b] + (n_pages, page_size) + s.shape[q + 1:])
            log = (logical[:b] + ("cache_pages", None) + logical[q + 1:])
        else:
            b = plan.batch_axis
            shape = s.shape[:b] + (n_slots,) + s.shape[b + 1:]
            log = logical
        return ParamSpec(shape, s.dtype, log, s.init, s.scale)

    return tree_map(one, dense_specs, plans)


def install_rows(page_ids: np.ndarray, n_tokens: int,
                 page_size: int) -> np.ndarray:
    """Flat pool-row indices for positions ``0 .. n_tokens-1`` of a
    request holding ``page_ids`` (the prefill scatter's targets)."""
    pos = np.arange(n_tokens)
    return (page_ids[pos // page_size].astype(np.int64) * page_size
            + pos % page_size).astype(np.int32)


class PageAllocator:
    """Host-side page free list (pages ``N_RESERVED..n_pages-1``).

    Tracks ``peak_in_use`` so a run can show that slot cache memory scales
    with the lengths actually in flight rather than
    ``max_batch × seq_len``."""

    def __init__(self, n_pages: int) -> None:
        if n_pages <= N_RESERVED:
            raise ValueError(
                f"need more than {N_RESERVED} pages (zero + trash are "
                f"reserved), got n_pages={n_pages}")
        self.n_pages = n_pages
        self._free = deque(range(N_RESERVED, n_pages))
        self.in_use = 0
        self.peak_in_use = 0

    @property
    def capacity(self) -> int:
        return self.n_pages - N_RESERVED

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> np.ndarray:
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: need {n}, have {len(self._free)}")
        ids = np.array([self._free.popleft() for _ in range(n)], np.int32)
        self.in_use += n
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return ids

    def free_(self, ids: Iterable[int]) -> None:
        ids = list(int(i) for i in ids)
        for i in ids:
            if not N_RESERVED <= i < self.n_pages:
                raise ValueError(f"freeing invalid page id {i}")
        self._free.extend(ids)
        self.in_use -= len(ids)

    # ------------------------------------------------ durability hooks ----
    def snapshot(self) -> dict:
        """JSON-able state, free-list ORDER included, so a restored
        allocator hands out the same page ids in the same order."""
        return {"n_pages": self.n_pages, "free": [int(i) for i in self._free],
                "in_use": self.in_use, "peak_in_use": self.peak_in_use}

    @classmethod
    def restore(cls, snap: dict) -> "PageAllocator":
        alloc = cls(int(snap["n_pages"]))
        alloc._free = deque(int(i) for i in snap["free"])
        alloc.in_use = int(snap["in_use"])
        alloc.peak_in_use = int(snap["peak_in_use"])
        return alloc
