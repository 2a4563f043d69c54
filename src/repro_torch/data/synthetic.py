"""Synthetic data generators (the machines are offline).

* ``make_classification`` — class-prototype Gaussians with distractor
  dimensions; shape/statistics-matched stand-in for flattened MNIST in the
  paper's base experiments (n_features=784, 10 classes).
* ``vertical_partition`` — the VFL feature split: each of M clients gets an
  equal, disjoint feature slice of every sample (paper §VI-A-a).
* ``lm_token_batches`` — Zipf-distributed token streams with local n-gram
  structure for the LM-scale configs (so CE actually decreases when the
  model learns).

numpy only, so a seed gives the same bytes as the JAX package's copy.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def make_classification(seed: int, n: int, n_features: int, n_classes: int,
                        *, sep: float = 2.0, noise: float = 1.0,
                        informative_frac: float = 0.5
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X (n, n_features) float32, y (n,) int32)."""
    rng = np.random.default_rng(seed)
    n_inf = max(int(n_features * informative_frac), n_classes)
    protos = rng.normal(0, sep, (n_classes, n_inf)).astype(np.float32)
    y = rng.integers(0, n_classes, n).astype(np.int32)
    X_inf = protos[y] + rng.normal(0, noise, (n, n_inf)).astype(np.float32)
    X_noise = rng.normal(0, noise, (n, n_features - n_inf)).astype(np.float32)
    X = np.concatenate([X_inf, X_noise], axis=1)
    perm = rng.permutation(n_features)          # spread info across clients
    return X[:, perm], y


def vertical_partition(X: np.ndarray, n_clients: int) -> np.ndarray:
    """X (n, f) -> (M, n, f//M): disjoint per-client feature slices."""
    n, f = X.shape
    per = f // n_clients
    return np.stack([X[:, m * per:(m + 1) * per] for m in range(n_clients)])


def lm_token_batches(seed: int, vocab: int, batch: int, seq: int,
                     *, n_batches: int = 0) -> Iterator[dict]:
    """Zipfian unigram + first-order chain structure — learnable synthetic
    text. Yields {"tokens", "labels"} int32 (labels == tokens; the loss
    shifts)."""
    rng = np.random.default_rng(seed)
    # sparse bigram transition structure over a Zipf unigram base
    base = 1.0 / np.arange(1, vocab + 1) ** 1.1
    base /= base.sum()
    n_modes = min(64, vocab)
    jump = rng.integers(0, vocab, n_modes)

    i = 0
    while n_batches == 0 or i < n_batches:
        toks = rng.choice(vocab, size=(batch, seq), p=base).astype(np.int32)
        # inject deterministic bigrams: after token t, with p=.5, emit
        # jump[t % n_modes] — gives the model something to learn
        mask = rng.random((batch, seq - 1)) < 0.5
        nxt = jump[toks[:, :-1] % n_modes]
        toks[:, 1:] = np.where(mask, nxt, toks[:, 1:])
        yield {"tokens": toks, "labels": toks.copy()}
        i += 1
