"""Parameter machinery: abstract param specs, init, and carrying weights
across from numpy.

A model is described by a tree of :class:`ParamSpec` leaves, the same
specs as the JAX package's, so both packages agree on every shape, dtype
and key path. Weights keep the ``(in, out)`` layout used as ``x @ w``;
weights from the JAX package load with :func:`params_from_numpy` and no
transposes. :class:`PageContext` and :func:`freeze_state` carry the
continuous scheduler's batched paged decode step through the models.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: str = "bfloat16"
    logical: Tuple[Optional[str], ...] = ()
    init: str = "normal"          # normal | zeros | ones | scaled
    scale: float = 0.02

    def __post_init__(self):
        if len(self.logical) not in (0, len(self.shape)):
            raise ValueError(f"logical axes {self.logical} do not match "
                             f"shape {self.shape}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# a leaf of more elements than this is drawn one slice of its leading
# axis at a time, and a slice still above it one slice of its own leading
# axis at a time (``materialize``)
SLICED_DRAW_ELEMENTS = 1 << 31


def materialize(tree, generator: torch.Generator, *,
                device=None, dtype_override: Optional[str] = None):
    """Concrete init, drawn from ``generator`` leaf by leaf in sorted-key
    order (it need not match the JAX package's threefry draws; tests that
    compare the two carry weights across with :func:`params_from_numpy`).
    The draws happen on the generator's device and land on ``device``.

    A leaf is drawn whole in f32 and then cast, unless it has more than
    ``SLICED_DRAW_ELEMENTS`` elements: such a leaf (Qwen3-30B-A3B's
    stacked experts, 9.7e9 values, would be a 38.7 GB f32 draw) is drawn
    one slice of its leading axis at a time, each slice cast straight into
    the leaf, so no f32 copy of the whole leaf exists. A slice still above
    the threshold (one layer of DeepSeek-V3's stacked experts, 256 x 7168
    x 2048 = 3.76e9 values) is drawn one slice of its own leading axis at
    a time, and so on down; a slice under it is drawn whole, so the leaves
    that were drawn whole or slice by slice before draw the same values."""
    def draw(shape, fan_in, s: ParamSpec):
        out = torch.randn(shape, generator=generator,
                          device=generator.device, dtype=torch.float32)
        if s.init == "scaled":          # fan-in scaled
            return out * (1.0 / math.sqrt(max(fan_in, 1)))
        return out * s.scale

    def init_one(s: ParamSpec):
        dt = torch_dtype(dtype_override or s.dtype)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=device)
        fan_in = s.shape[0] if s.shape else 1
        if math.prod(s.shape) <= SLICED_DRAW_ELEMENTS:
            return draw(s.shape, fan_in, s).to(device=device, dtype=dt)

        def fill(out):
            for i in range(out.shape[0]):
                if out[i].numel() <= SLICED_DRAW_ELEMENTS:
                    out[i] = draw(out.shape[1:], fan_in, s)
                else:
                    fill(out[i])
        out = torch.empty(s.shape, dtype=dt, device=device)
        fill(out)
        return out

    return tree_map(init_one, tree)


def _logical(s: ParamSpec):
    return s.logical if s.logical else (None,) * len(s.shape)


def shardings(tree, mesh, rules=None):
    """``(mesh, placements)`` of every spec leaf under ``rules``
    (``PARAM_RULES`` by default): the counterpart of the JAX package's
    ``NamedSharding`` tree."""
    from repro_torch.sharding.rules import PARAM_RULES, named_sharding
    rules = rules or PARAM_RULES
    return tree_map(lambda s: named_sharding(mesh, s.shape, _logical(s),
                                             rules), tree)


def place(params, specs, mesh, rules=None):
    """Each leaf of ``params`` as a DTensor on ``mesh``, placed by its
    spec's logical axes under ``rules`` (``PARAM_RULES`` by default).
    Every rank holds the same full leaf (drawn from the same generator),
    so each keeps its own shard of it and nothing is sent: the placed
    tree is bitwise the unplaced one."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, sh):
        return distribute_tensor(t.detach(), sh[0], sh[1],
                                 src_data_rank=None)
    return tree_map(one, params, shardings(specs, mesh, rules))


def param_count(tree) -> int:
    return int(sum(math.prod(s.shape) for s in tree_leaves(tree)))


def param_bytes(tree) -> int:
    return int(sum(math.prod(s.shape) * torch_dtype(s.dtype).itemsize
                   for s in tree_leaves(tree)))


# ---------------------------------------------------------------------------
# paged decode context
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PageContext:
    """Batched paged-decode context threaded through ``backbone_apply``.

    Present only on the continuous scheduler's batched decode step:
    sequence-indexed cache leaves arrive as shared page pools
    ``(n_pages, page_size, *tail)`` per layer instead of slot-stacked
    ``(B, S, *tail)`` slices. The context holds where each slot's rows
    live and where this step's row lands (inactive slots write to the
    reserved trash page), as device tensors: no host sync. One context
    serves one step: :meth:`for_step` computes its row maps once and every
    attention layer of the step reads them (the JAX package recomputes
    them per layer inside one compiled program, where they cost
    nothing)."""
    active: torch.Tensor       # (B,) int32 — 0 routes writes to TRASH_PAGE
    gather_rows: torch.Tensor  # (B, pages_per_seq * page_size) pool rows
    dest_page: torch.Tensor    # (B,) the page this step's row lands in
    in_page: torch.Tensor      # (B,) its row within that page

    @classmethod
    def for_step(cls, tables: torch.Tensor, active: torch.Tensor,
                 cur_pos: torch.Tensor, page_size: int,
                 trash_page: int = 1) -> "PageContext":
        """The context of one step. ``tables`` (B, pages_per_seq) int32
        page ids; ``cur_pos`` (B,) each slot's position. ``gather_rows``
        covers each slot's full (masked) sequence extent. A retired slot's
        position may sit one past its table (a request that filled
        ``seq_len``); its page index is clamped, as JAX clamps a gather,
        and its write goes to the trash page all the same."""
        B, npt = tables.shape
        pages = tables.long()
        rows = (pages[:, :, None] * page_size
                + torch.arange(page_size, device=tables.device)[None, None])
        cur = cur_pos.long()
        page_of = (cur // page_size).clamp(max=npt - 1)
        dest = torch.gather(pages, 1, page_of[:, None])[:, 0]
        dest = torch.where(active > 0, dest, torch.full_like(dest,
                                                             trash_page))
        return cls(active=active, gather_rows=rows.reshape(B, npt * page_size),
                   dest_page=dest, in_page=cur % page_size)


def freeze_state(active, new, old):
    """``where(active, new, old)`` with (B,)-active broadcast to any rank:
    inactive slots' recurrent state stays EXACTLY frozen under the batched
    decode step (their inputs are zeroed, but decay would still drift the
    state). The result keeps the carried state's dtype: an f32 conv tail
    stays f32 after a bf16 step."""
    a = active.reshape(active.shape + (1,) * (new.ndim - 1))
    return torch.where(a > 0, new.to(old.dtype), old)


def stack_layer_specs(layer_tree, n_layers: int, axis_name: str = "layers"):
    """Prepend a stacked leading dim to every leaf of a single-layer tree.

    ``axis_name`` is the logical name of the new axis: "layers" for the
    transformer stack, "clients" for the VFL party plane. A stacked
    ``scaled`` leaf takes its fan-in from the new leading dim, as in the
    JAX package (``materialize`` reads ``shape[0]``)."""
    def one(s: ParamSpec):
        logical = s.logical if s.logical else (None,) * len(s.shape)
        return ParamSpec((n_layers,) + tuple(s.shape), s.dtype,
                         (axis_name,) + tuple(logical), s.init, s.scale)
    return tree_map(one, layer_tree)


def chunk_divisor(seq: int, cap: int) -> int:
    """Largest chunk length <= ``cap`` that divides ``seq`` exactly.

    The chunked recurrent forms (wkv6 / SSD) scan over fixed-size chunks
    and require the sequence to tile evenly; prefill chunks arrive at
    arbitrary span lengths, so pick the best even tiling (worst case 1,
    which degenerates to the exact per-token recurrence)."""
    for c in range(min(cap, seq), 1, -1):
        if seq % c == 0:
            return c
    return 1


def params_from_numpy(tree, device=None):
    """numpy (or any ``np.asarray``-able) leaves -> tensors on ``device``.
    bfloat16 arrays (``ml_dtypes``, as ``np.asarray`` of a JAX bf16 array
    gives) cross as their 16-bit pattern: numpy's view as int16, torch's
    view back as bfloat16. The check reads the dtype's name, so it needs
    no ``ml_dtypes`` import."""
    def one(a):
        a = np.asarray(a)
        if str(a.dtype) == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device)
    return tree_map(one, tree)


def params_to_numpy(tree):
    """Tensors -> numpy arrays on the host (same dtype, same layout)."""
    def one(t):
        if t.dtype == torch.bfloat16:
            raise ValueError("numpy has no bfloat16; cast the tree to "
                             "float32 before params_to_numpy")
        return t.detach().cpu().numpy()
    return tree_map(one, tree)
