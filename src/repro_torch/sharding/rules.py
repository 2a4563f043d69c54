"""Logical-axis sharding rules with divisibility fallback.

Every tensor in the framework carries a tuple of *logical axis names*
(one per dim, ``None`` = replicated). A :class:`Rules` table maps each
logical name to an ordered list of candidate mesh-axis groups. For a given
mesh, the first candidate whose (available) axes all divide the dim size
and are not already taken by another dim wins; otherwise the dim is
replicated. The one mechanism lets all 10 registry architectures — with
their different head counts, vocab sizes and expert counts — resolve a
layout on the production mesh without per-architecture cases.

:func:`resolve_spec` reads only the mesh's axis names and sizes: a
``torch.distributed.device_mesh.DeviceMesh`` (its ``mesh_dim_names`` and
shape) or a plain ``{name: size}`` mapping, so a layout can be resolved
for a mesh larger than the processes at hand. It returns the tuple
counterpart of a ``PartitionSpec``: one entry per dim up to the last
sharded one, each ``None``, an axis name, or a tuple of axis names.

On a ``DeviceMesh`` a spec becomes DTensor placements (:func:`placements`,
:func:`named_sharding`): parameters are placed by ``PARAM_RULES``
(``models.common.place``), and the models call :func:`shard_constraint`
at the JAX package's sites with ``ACT_RULES``, which redistributes a
DTensor activation while a mesh is current (``with use_mesh(mesh):``, the
counterpart of ``with mesh:``). With no mesh current it returns its
operand: one global read, so the single-device paths pay nothing for it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from torch.distributed.tensor import DTensor, Replicate, Shard

AxisGroup = Union[str, Tuple[str, ...]]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


@dataclasses.dataclass(frozen=True)
class Rules:
    table: dict

    def candidates(self, logical: str) -> Tuple[AxisGroup, ...]:
        return tuple(self.table.get(logical, ()))


# Parameter sharding: tensor-parallel over "model", FSDP over "data",
# vocab over "model" (padded to 256 so it always divides).
PARAM_RULES = Rules({
    "vocab":      ("model",),
    "embed":      ("data",),             # FSDP
    "heads_out":  ("model", "data"),     # fused (H*hd) projection outputs
    "kv_out":     ("model", "data"),
    "ffn":        ("model",),
    "ffn_in":     ("data",),
    "experts":    ("model",),
    "expert_d":   ("data",),
    "latent":     ("model", "data"),     # MLA lora ranks
    "ssm_inner":  ("model",),
    "ssm_state":  (),
    "pos":        (),
    "layers":     (),
    "frontend":   ("data",),
    # VFL party plane: the async engine's stacked per-client leading axis
    # (client params (M, ...) and the server's embedding table (M, n, e)).
    # Rows partition over "data" — one rank hosts M/D clients — and the
    # divisibility fallback replicates on meshes that don't divide M.
    "clients":    ("data",),
})

# Tensor/expert-parallel only — no FSDP over "data": weights are
# replicated across the data axis, which removes every per-layer weight
# all-gather for models whose (params / model axis) fits device memory.
PARAM_RULES_NO_FSDP = Rules({
    **{k: tuple(a for a in v if a != "data")
       for k, v in PARAM_RULES.table.items()},
    "embed": (),
    "ffn_in": (),
    "expert_d": (),
    "frontend": (),
})

# Activation sharding: batch over (pod, data), heads/ffn over "model".
ACT_RULES = Rules({
    "batch":      (("pod", "data"), "data"),
    "seq":        (),
    # sequence-parallel residual boundaries: the saved block inputs shard
    # over "model" along seq; decode (S=1) falls back to replicated
    # through the divisibility rule.
    "seq_act":    ("model",),
    "embed_act":  (),
    "heads_act":  ("model",),
    "kv_heads":   ("model",),
    "ffn_act":    ("model",),
    "experts":    ("model",),
    "vocab_act":  ("model",),
    # decode caches: batch -> (pod, data); the cache sequence dim takes
    # whatever remains ("model"; for a batch of 1 it takes
    # ("data", "model")).
    "cache_batch":   (("pod", "data"), "data"),
    "cache_seq":     (("pod", "data", "model"), ("data", "model"), "model"),
    "cache_heads":   ("model",),
})

MeshLike = Union[Mapping[str, int], object]


def mesh_axes(mesh: MeshLike) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a plain mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError("a mesh for resolve_spec needs named axes "
                         "(DeviceMesh(..., mesh_dim_names=...) or a "
                         "{name: size} mapping)")
    return {name: int(size) for name, size in zip(names, mesh.shape)}


def _group_axes(group: AxisGroup) -> Tuple[str, ...]:
    return (group,) if isinstance(group, str) else tuple(group)


def _available(group: AxisGroup, axes: Mapping[str, int]) -> Tuple[str, ...]:
    """Filter a candidate group down to axes present in the mesh
    (a ("pod","data") candidate degrades to ("data",) on single-pod)."""
    return tuple(a for a in _group_axes(group) if a in axes)


def resolve_spec(
    mesh: MeshLike,
    shape: Sequence[int],
    logical: Sequence[Optional[str]],
    rules: Rules,
) -> Spec:
    """The spec for ``shape`` given per-dim logical names."""
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} and logical axes "
                         f"{tuple(logical)} differ in rank")
    axes = mesh_axes(mesh)
    taken: set = set()
    entries = []
    for size, name in zip(shape, logical):
        if name is None:
            entries.append(None)
            continue
        chosen = None
        for cand in rules.candidates(name):
            avail = _available(cand, axes)
            if not avail or any(a in taken for a in avail):
                continue
            prod = 1
            for a in avail:
                prod *= axes[a]
            if size % prod == 0 and prod > 1:
                chosen = avail
                break
        if chosen is None:
            entries.append(None)
        else:
            taken.update(chosen)
            entries.append(chosen if len(chosen) > 1 else chosen[0])
    # trim trailing Nones for a tidy spec
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


# ------------------------------------------------------- DTensor placement --

def placements(mesh, spec: Spec) -> List:
    """The ``Shard``/``Replicate`` list (one per mesh dim) that ``spec``
    means on ``mesh``. A dim sharded over a tuple of axes is ``Shard(dim)``
    on each of them; DTensor splits such a dim over its mesh dims in mesh
    order (row-major), as ``P(("data", "model"))`` does, so a tuple out
    of mesh order is refused."""
    names = tuple(mesh.mesh_dim_names)
    out: List = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in _group_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"axes {entry} of dim {dim} are out of the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def named_sharding(mesh, shape: Sequence[int],
                   logical: Sequence[Optional[str]],
                   rules: Rules = None) -> Tuple[object, List]:
    """``(mesh, placements)`` of ``shape`` under ``rules`` (``ACT_RULES``
    by default, as in the JAX package)."""
    spec = resolve_spec(mesh, shape, logical, rules or ACT_RULES)
    return mesh, placements(mesh, spec)


_MESH = None                     # the current mesh (``use_mesh``)
calls: Dict[str, int] = {"shard_constraint": 0}


def reset_calls() -> None:
    calls["shard_constraint"] = 0


def current_mesh():
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` current for :func:`shard_constraint` (nests; the
    previous mesh comes back on exit)."""
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def shard_constraint(x, logical: Sequence[Optional[str]],
                     rules: Rules = None):
    """``x`` redistributed to its ``rules`` placements (``ACT_RULES`` by
    default) when a mesh is current and ``x`` is a DTensor on it, else
    ``x`` itself. Each redistributing call counts one in ``calls``."""
    mesh = _MESH
    if mesh is None or not isinstance(x, DTensor):
        return x
    calls["shard_constraint"] += 1
    want = placements(mesh, resolve_spec(mesh, x.shape, logical,
                                         rules or ACT_RULES))
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(mesh, want)
