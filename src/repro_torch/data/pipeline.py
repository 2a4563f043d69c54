"""Batch feeding: numpy batches onto the session's device."""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map


class BatchIterator:
    """Wraps a numpy batch iterator; moves each batch to ``device`` (the
    card unless the caller asks for the CPU). The JAX package's version
    also places batches by a sharding; the port runs on one device."""

    def __init__(self, it: Iterator[dict], device: DeviceLike = None):
        self._it = it
        self._device = resolve_device(device)

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._it)
        return tree_map(
            lambda x: torch.from_numpy(np.asarray(x)).to(self._device),
            batch)


def epoch_minibatches(rng: np.random.Generator, n: int, batch_size: int):
    """Shuffled index minibatches covering one epoch."""
    idx = rng.permutation(n)
    for s in range(0, n - batch_size + 1, batch_size):
        yield idx[s:s + batch_size]
