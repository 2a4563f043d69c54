"""Device meshes over ``torch.distributed`` process groups.

Functions, not module constants: importing this module touches no
process group, so the CPU tests import it freely. Every mesh needs an
initialized default group with one process per device (NCCL on the card,
gloo on the CPU); nothing here falls back to a single device when there
is none. The mesh's device type follows the group's backend unless the
caller names it, and a CUDA mesh over a group without NCCL (or a CPU mesh
without gloo) is refused: CUDA tensors never go through gloo. The dry
run's ``"fake"`` group (``launch/dryrun.py``) takes a mesh of either
type: its collectives move nothing.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a device mesh needs an initialized torch.distributed process "
            "group, one process per shard (init_process_group with NCCL "
            "on the card, gloo on the CPU); the engine does not fall back "
            "to one device")
    return dist.get_world_size()


def _device_type(device) -> str:
    """The mesh's device type: ``device``'s, or the backend's (NCCL:
    cuda, else cpu), checked against the group's backend."""
    backend = str(dist.get_backend()).lower()
    kind = (torch.device(device).type if device is not None
            else "cuda" if "nccl" in backend else "cpu")
    if "fake" in backend:
        # the dry run's group (launch/dryrun.py): no collective runs, so
        # a mesh of either device type may sit on it
        return kind
    need = {"cuda": "nccl", "cpu": "gloo"}.get(kind)
    if need is None or need not in backend:
        raise ValueError(
            f"a {kind} mesh needs a process group with the {need} backend, "
            f"got {backend!r} (NCCL on the card, gloo on the CPU)")
    return kind


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") multi-pod, over every rank of the default group; the world
    size must equal the mesh's size."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    world = _world()
    if world != math.prod(shape):
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs "
            f"{math.prod(shape)} ranks, the group has {world}")
    return DeviceMesh(_device_type(device),
                      torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(device=None) -> DeviceMesh:
    """A (1, 1) ("data", "model") mesh on rank 0 (axes exist, size 1)."""
    _world()
    return DeviceMesh(_device_type(device), torch.zeros((1, 1), dtype=int),
                      mesh_dim_names=("data", "model"))


def make_client_mesh(n_shards: Optional[int] = None,
                     device=None) -> DeviceMesh:
    """1-D ``("data",)`` mesh over the first ``n_shards`` ranks of the
    default group.

    This is the axis the async engine splits the activated client block
    over (the ``"clients"`` logical rows of the embedding table partition
    along it). ``n_shards=None`` takes every rank."""
    world = _world()
    n = world if n_shards is None else int(n_shards)
    if not 1 <= n <= world:
        raise ValueError(
            f"n_shards={n_shards} out of range for {world} devices "
            "(one rank each)")
    return DeviceMesh(_device_type(device), torch.arange(n),
                      mesh_dim_names=("data",))
