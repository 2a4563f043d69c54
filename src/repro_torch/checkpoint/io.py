"""Checkpointing: flat-key npz + json manifest, the JAX package's format.

A checkpoint directory holds ``arrays.npz`` (one array per leaf, under the
leaf's ``"::"``-joined key path: a dict key as itself, a sequence index as
``[i]``) and ``manifest.json`` (step, sorted keys, shapes, dtypes,
metadata). The format is the JAX package's (the same keys, stored arrays,
dtype names and manifest fields), so a checkpoint written by either
package loads in the other. Tensors are copied to the
host on save; on restore each leaf lands on the requested device.

Writes are ATOMIC per file: every npz/manifest is written to a temp file
in the target directory, fsync'd, then ``os.replace``'d into place — a
process killed mid-``save_checkpoint`` (or mid-``fed.save``) leaves
either the previous complete checkpoint or the new complete one on disk,
never a torn npz or a half-written ``session.json``. The manifest is
replaced LAST, so its presence always certifies arrays it can decode.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.tree import tree_map

_SEP = "::"

# numpy has no bfloat16/float8 (the JAX package's npz stores such leaves as
# a same-width uint view and restores the true dtype from the manifest):
# these torch dtypes cross as uint views, named as numpy's ml_dtypes names
# them
_EXTENSION = {torch.bfloat16: "bfloat16",
              torch.float8_e4m3fn: "float8_e4m3fn",
              torch.float8_e5m2: "float8_e5m2"}
_EXTENSION_BY_NAME = {v: k for k, v in _EXTENSION.items()}
_UINT_FOR_SIZE = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
_INT_FOR_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


def encode_tensor(t: torch.Tensor):
    """(stored array, true dtype name) of a tensor: an extension dtype
    becomes a same-width uint view, everything else its numpy array."""
    t = t.detach().cpu().contiguous()
    if t.dtype in _EXTENSION:
        size = t.element_size()
        arr = t.view(_INT_FOR_SIZE[size]).numpy().view(_UINT_FOR_SIZE[size])
        return arr, _EXTENSION[t.dtype]
    arr = t.numpy()
    return arr, str(arr.dtype)


def decode_tensor(arr: np.ndarray, dtype_str: str,
                  device: DeviceLike = None) -> torch.Tensor:
    """Inverse of :func:`encode_tensor` given the recorded true dtype."""
    dt = _EXTENSION_BY_NAME.get(dtype_str)
    if dt is not None:
        size = arr.dtype.itemsize
        t = torch.from_numpy(np.ascontiguousarray(arr).view(
            np.dtype(f"int{8 * size}"))).view(dt)
    else:
        t = torch.from_numpy(np.array(arr, dtype=np.dtype(dtype_str)))
    return t.to(device) if device is not None else t


def _flatten_with_path(tree, prefix=()):
    """[(path parts, leaf)] in the JAX package's flatten order: dict keys
    sorted, sequences by position."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten_with_path(tree[k], prefix + (str(k),))]
    if isinstance(tree, (tuple, list)):
        return [item for i, child in enumerate(tree)
                for item in _flatten_with_path(child, prefix + (f"[{i}]",))]
    return [(prefix, tree)]


def _flatten(tree) -> dict:
    return {_SEP.join(path): leaf for path, leaf in _flatten_with_path(tree)}


def atomic_write(path: str, write_fn: Callable[[Any], None],
                 mode: str = "wb") -> None:
    """Write ``path`` atomically: ``write_fn(file)`` runs against a temp
    file in the same directory, which is fsync'd and ``os.replace``'d
    over ``path`` only after the write completed. A crash at any point
    leaves the previous ``path`` (or nothing) — never a torn file."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save_checkpoint(path: str, params, *, step: int = 0,
                    metadata: Optional[dict] = None) -> None:
    os.makedirs(path, exist_ok=True)
    flat = {k: encode_tensor(v) for k, v in _flatten(params).items()}
    # arrays first, manifest last: a manifest on disk always describes a
    # complete arrays file (each file individually atomic)
    atomic_write(os.path.join(path, "arrays.npz"),
                 lambda f: np.savez(f, **{k: a
                                          for k, (a, _) in flat.items()}))
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "shapes": {k: list(a.shape) for k, (a, _) in flat.items()},
        "dtypes": {k: dt for k, (_, dt) in flat.items()},
        "metadata": metadata or {},
    }
    atomic_write(os.path.join(path, "manifest.json"),
                 lambda f: json.dump(manifest, f, indent=2), mode="w")


def load_tree(path: str, device: DeviceLike = None):
    """Self-describing restore: rebuild the nested-dict tree purely from
    the manifest's flat keys (no ``like`` structure needed — what the
    party-scoped ``Federation.restore`` uses). Leaves land on ``device``
    (the CPU when None).

    Only string-keyed dict nesting round-trips this way; trees with
    list/tuple internal nodes must go through :func:`load_checkpoint`.
    Returns (tree, step, metadata)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    tree: dict = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key in manifest["keys"]:
            parts = key.split(_SEP) if key else []
            if any(p.startswith("[") for p in parts):
                raise ValueError(
                    f"load_tree only rebuilds dict-nested trees; key "
                    f"{key!r} has a sequence index — restore via "
                    "load_checkpoint(like)")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = decode_tensor(data[key],
                                            manifest["dtypes"][key], device)
    return tree, manifest["step"], manifest.get("metadata", {})


def load_checkpoint(path: str, like, *, device: DeviceLike = None):
    """Restore into the structure of ``like`` (a params tree or spec tree),
    on ``device`` (the CPU when None). Returns (params, step)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    keys = iter(_SEP.join(p) for p, _ in _flatten_with_path(like))
    with np.load(os.path.join(path, "arrays.npz")) as data:
        def one(_leaf):
            key = next(keys)
            return decode_tensor(data[key], manifest["dtypes"][key], device)
        params = tree_map(one, like)
    return params, manifest["step"]
