"""Collective-byte accounting for the dry run's roofline: the counterpart
of the JAX package's ``utils/hlo.py``, which parses the collectives out of
XLA's compiled HLO text. The port has no compiled program to parse: its
dry run runs the step eagerly on fake tensors, and the collectives are
the functional collectives that DTensor issues, which
:class:`CommRecorder` (a ``torch.distributed.tensor.debug.CommDebugMode``)
sees one by one with their local operands and process group.

The per-op byte conventions (per participating device) are ``hlo.py``'s:

  all-gather        : output_bytes (data received)
  all-reduce        : 2 x operand_bytes (ring: reduce-scatter + all-gather)
  reduce-scatter    : operand_bytes
  all-to-all        : operand_bytes
  collective-permute: operand_bytes

and a broadcast counts its operand bytes. DTensor's Shard(i) -> Shard(j)
redistribute is its own op, ``_dtensor.shard_dim_alltoall``, an
all-to-all; on a CPU mesh DTensor sends it down an all-gather and a
chunk instead, unless :func:`nccl_alltoall` routes it as the card does.
:func:`collective_bytes` sums them by kind with a ``"total"``, as
``hlo.collective_bytes`` does;
:func:`bytes_by_axis` sums them by the mesh axis whose group carried them,
:func:`bytes_by_site` by axis, kind and the line of the port's code
that issued them (HLO has no such line to give),
:func:`by_axis_kind` counts them and sums their bytes by axis and kind
(what a run on a real group is held to against the dry run's trace), and
:func:`shapes_by_site` lists the local operand shapes each site issued.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from typing import Dict, Iterable, List, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode

# the functional collectives DTensor issues, by the kind hlo.py names
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast",
}


@dataclasses.dataclass(frozen=True)
class CommRecord:
    kind: str                  # hlo.py's name: "all-gather", ...
    operand_bytes: int         # the local operand
    output_bytes: int          # the local result
    axis: str                  # the mesh axis of the group ("?" unknown)
    site: str = ""             # the port's line that issued it (_site)
    shape: Tuple[int, ...] = ()  # the local operand's shape


def op_bytes(rec: CommRecord) -> int:
    """The bytes one device moves for ``rec`` (the conventions above)."""
    if rec.kind == "all-gather":
        return rec.output_bytes
    if rec.kind == "all-reduce":
        return 2 * rec.operand_bytes
    return rec.operand_bytes


def collective_bytes(records: Iterable[CommRecord]) -> Dict[str, int]:
    """Per-device collective traffic by kind, and ``"total"``."""
    agg: Dict[str, int] = {}
    total = 0
    for rec in records:
        n = op_bytes(rec)
        agg[rec.kind] = agg.get(rec.kind, 0) + n
        total += n
    agg["total"] = total
    return agg


def bytes_by_axis(records: Iterable[CommRecord]) -> Dict[str, int]:
    """Per-device collective traffic by the mesh axis that carried it."""
    agg: Dict[str, int] = {}
    for rec in records:
        agg[rec.axis] = agg.get(rec.axis, 0) + op_bytes(rec)
    return agg


def bytes_by_site(records: Iterable[CommRecord]) -> Dict[str, int]:
    """Per-device collective traffic by ``"axis kind site"``."""
    agg: Dict[str, int] = {}
    for rec in records:
        key = f"{rec.axis} {rec.kind} {rec.site}"
        agg[key] = agg.get(key, 0) + op_bytes(rec)
    return agg


def by_axis_kind(records: Iterable[CommRecord]) -> Dict[str, List[int]]:
    """``{"axis kind": [collectives, per-device bytes]}``."""
    agg: Dict[str, List[int]] = {}
    for rec in records:
        n = agg.setdefault(f"{rec.axis} {rec.kind}", [0, 0])
        n[0] += 1
        n[1] += op_bytes(rec)
    return agg


def shapes_by_site(records: Iterable[CommRecord]) -> Dict[str,
                                                           List[List[int]]]:
    """``{"axis kind site": the distinct local operand shapes, sorted}``
    (lists, as JSON keeps them)."""
    agg: Dict[str, set] = {}
    for rec in records:
        agg.setdefault(f"{rec.axis} {rec.kind} {rec.site}",
                       set()).add(tuple(rec.shape))
    return {k: [list(s) for s in sorted(v)] for k, v in agg.items()}


def summary(records: List[CommRecord]) -> dict:
    """A step's collectives as a run on a real group is held to the dry
    run's trace: ``by_axis_kind`` (count and bytes), the bytes
    ``by_kind``, ``by_axis`` and ``by_site``, and ``shapes_by_site``."""
    return {"by_axis_kind": by_axis_kind(records),
            "by_kind": collective_bytes(records),
            "by_axis": bytes_by_axis(records),
            "by_site": bytes_by_site(records),
            "shapes_by_site": shapes_by_site(records)}


@contextlib.contextmanager
def nccl_alltoall():
    """DTensor's Shard(i) -> Shard(j) redistribute as one all-to-all
    (``_dtensor.shard_dim_alltoall``) on any mesh, as NCCL runs it. On a
    CPU mesh DTensor falls back to an all-gather and a chunk ("Gloo does
    not support alltoall", ``tensor/_collective_utils.py``), which moves
    the group's size times the bytes; gloo runs the all-to-all all the
    same. The dry run's trace, on the CPU's fake mesh, counts under this
    the collectives the card runs."""
    from torch.distributed.tensor import placement_types
    inner = placement_types.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = inner


_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the recorders' own frames
_OWN = (os.path.join("utils", "comms.py"), os.path.join("launch",
                                                        "roofline.py"))


def _site() -> str:
    """The innermost frame of the port's code on the stack, outside the
    recorders, as ``"path:line function"`` (path under the package);
    prefixed ``"backward"`` while autograd runs a backward pass (the
    remat recompute's frames are the forward's)."""
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PKG) and not path.endswith(_OWN):
            where = (f"{os.path.relpath(path, _PKG)}:{f.f_lineno} "
                     f"{f.f_code.co_name}")
            break
        f = f.f_back
    else:
        where = "?"
    if torch._C._current_graph_task_id() != -1:
        return f"backward {where}"
    return where


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class CommRecorder(CommDebugMode):
    """``CommDebugMode`` that also keeps a :class:`CommRecord` of every
    collective: its kind, local operand and result bytes and, through
    ``mesh``, the axis of its group, and its site (:func:`_site`; one stack
    walk a collective). DTensor ops pass through to DTensor
    (``CommDebugMode`` returns ``NotImplemented`` for them), so this mode
    sees the local ops DTensor runs, the collectives among them."""

    def __init__(self, mesh):
        super().__init__()
        self.records: List[CommRecord] = []
        self._axes: Dict[str, str] = {
            mesh.get_group(i).group_name: name
            for i, name in enumerate(mesh.mesh_dim_names)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or any(t == DTensor for t in types):
            return out
        kind = _KINDS.get(getattr(func, "_overloadpacket",
                                  func).__name__.split(".")[-1])
        if kind is not None:
            group = args[-1] if args and isinstance(args[-1], str) else None
            operand = args[0] if args else None
            self.records.append(CommRecord(
                kind, _nbytes(operand),
                sum(_nbytes(t) for t in torch.utils._pytree.tree_leaves(out)),
                self._axes.get(group, "?"), _site(),
                tuple(operand.shape) if isinstance(operand, torch.Tensor)
                else ()))
        return out
