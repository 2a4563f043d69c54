"""Draw sources: every random number the engine consumes, behind one seam.

The JAX package draws with threefry keys (schedule and batch indices at
the start of a run, then per round: directions for each activated block
row, the ZOO server's or the synchronous global directions, and the DP
noise on the loss downlink). PyTorch cannot reproduce those streams, so
the port's engine asks a draw source for each of them instead:

* ``schedule(steps, n_clients, probs, block_size)`` -> (T, block) int64
* ``sample_indices(steps, batch, n)``               -> (T, batch) int64
* ``client_directions(t, template, n_rows, q)``     -> tree of raw N(0, 1)
  leaves (n_rows, q, *leaf) for round t's block rows
* ``server_directions(t, template, q)``             -> (q, *leaf) leaves,
  the zoo-vfl server's own ZOO draw
* ``global_directions(t, template, q)``             -> (q, *leaf) leaves,
  the synchronous syn-zoo draw over every party's parameters
* ``noise(t, n_rows, n)``                           -> (n_rows, n) N(0, 1)
  for the DP channel on round t's loss downlinks

``template`` is a parameter tree; its leaves give the shapes, in sorted
key order. :class:`TorchDraws` serves a run from one ``torch.Generator``
on the run's device; the parity tests inject a source that replays the
JAX package's threefry draws through the same methods.

The sync training step (:mod:`repro_torch.core.cascade`) asks for the
directions and the noise of step t through the same methods (one block
row). :class:`StepDraws` answers them from a generator seeded by
(seed, t, stream) alone, as the JAX driver's ``fold_in(key, t)`` does, so
a run resumed at step k draws what an unbroken run draws from step k on.

The population engine (``async_engine.run_population``) splits a round
at the wire: each activated client party draws its own directions from a
``key`` payload the engine sends in its ``act`` frame. A population draw
source adds two methods to the protocol:

* ``row_key(t, r)``                       -> the act frame's ``key``
  payload for block row r of round t (a numpy array)
* ``directions(key, template, q)``        -> the (q, *leaf) raw N(0, 1)
  leaves that payload stands for, on the template's device

:class:`RowDraws` is the addressable source: every draw is a pure
function of (seed, stream, t, row), so its ``client_directions`` stacks
the rows' ``directions`` and an in-process run (``Federation.run``) and a
population run over the wire draw the same numbers, and a resumed run
draws what an unbroken one draws.

A captured engine round (a CUDA graph) cannot call a draw source: it
reads its draws from buffers that outlive the graph. :class:`RoundDraws`
wraps any source for it, recording the calls the first round makes and
refilling their buffers in the same order before each later round.
"""
from __future__ import annotations

import math
from typing import Optional, Protocol, Sequence

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.profiler import record_function

from repro_torch.core.partition import tree_leaves, tree_map, tree_unflatten


class DrawSource(Protocol):
    def schedule(self, steps: int, n_clients: int,
                 probs: Optional[Sequence[float]],
                 block_size: int) -> torch.Tensor: ...

    def sample_indices(self, steps: int, batch: int,
                       n: int) -> torch.Tensor: ...

    def client_directions(self, t: int, template, n_rows: int,
                          q: int): ...

    def server_directions(self, t: int, template, q: int): ...

    def global_directions(self, t: int, template, q: int): ...

    def noise(self, t: int, n_rows: int, n: int) -> torch.Tensor: ...


def make_schedule(generator: torch.Generator, steps: int, n_clients: int,
                  probs: Optional[Sequence[float]] = None,
                  block_size: int = 1) -> torch.Tensor:
    """Activation sequence m_t — independent draws (assumption IV.6).

    block_size > 1 draws that many DISTINCT clients per round; returns
    (steps,) for block_size == 1, else (steps, block_size)."""
    device = generator.device
    p = (torch.full((n_clients,), 1.0 / n_clients, device=device)
         if probs is None
         else torch.as_tensor(probs, dtype=torch.float32, device=device))
    if block_size == 1:
        return torch.multinomial(p, steps, replacement=True,
                                 generator=generator)
    return torch.multinomial(p.expand(steps, n_clients).contiguous(),
                             block_size, replacement=False,
                             generator=generator)


def _normals(generator: torch.Generator, template, lead):
    """One randn for every leaf of ``template``, each (*lead, *leaf), on
    the generator's device."""
    leaves = tree_leaves(template)
    sizes = [math.prod(lead) * leaf.numel() for leaf in leaves]
    flat = torch.randn(sum(sizes), generator=generator,
                       device=generator.device)
    return tree_unflatten(template, [
        part.view(*lead, *leaf.shape)
        for part, leaf in zip(flat.split(sizes), leaves)])


class TorchDraws:
    """A run's draws from one ``torch.Generator(device)`` seeded with
    ``seed``. Draws are taken in call order, and the engine calls in a
    fixed order, so one seed fixes a run (on one device type)."""

    def __init__(self, seed: int, device) -> None:
        self.device = torch.device(device)
        self.generator = torch.Generator(self.device)
        self.generator.manual_seed(int(seed))

    def schedule(self, steps, n_clients, probs=None, block_size=1):
        s = make_schedule(self.generator, steps, n_clients, probs,
                          block_size)
        return s.reshape(steps, block_size)

    def sample_indices(self, steps, batch, n):
        return torch.randint(0, n, (steps, batch), generator=self.generator,
                             device=self.device)

    def _normals(self, template, lead):
        return _normals(self.generator, template, lead)

    def client_directions(self, t, template, n_rows, q):
        return self._normals(template, (n_rows, q))

    def server_directions(self, t, template, q):
        return self._normals(template, (q,))

    def global_directions(self, t, template, q):
        return self._normals(template, (q,))

    def noise(self, t, n_rows, n):
        return torch.randn((n_rows, n), generator=self.generator,
                           device=self.device)


def _seeded(words, device) -> torch.Generator:
    """A ``torch.Generator(device)`` seeded from the integer ``words``
    through numpy's ``SeedSequence``."""
    state = np.random.SeedSequence([int(w) for w in words])
    g = torch.Generator(torch.device(device))
    g.manual_seed(int(state.generate_state(1, np.uint64)[0]))
    return g


class StepDraws:
    """The sync training step's draws: step t's client directions, server
    directions and DP noise each come from a ``torch.Generator(device)``
    seeded from (seed, t, stream) through numpy's ``SeedSequence``, never
    from what earlier steps drew. Each draw runs in a profiler range
    ("direction draws")."""

    CLIENT, SERVER, NOISE = 0, 1, 2

    def __init__(self, seed: int, device) -> None:
        self.seed = int(seed)
        self.device = torch.device(device)

    def _generator(self, t: int, stream: int) -> torch.Generator:
        return _seeded((self.seed, t, stream), self.device)

    def client_directions(self, t, template, n_rows, q):
        with record_function("direction draws"):
            return _normals(self._generator(t, self.CLIENT), template,
                            (n_rows, q))

    def server_directions(self, t, template, q):
        with record_function("direction draws"):
            return _normals(self._generator(t, self.SERVER), template, (q,))

    def noise(self, t, n_rows, n):
        with record_function("direction draws"):
            return torch.randn((n_rows, n), generator=self._generator(
                t, self.NOISE), device=self.device)


def place_like(raw, template, lead: int = 0):
    """``raw`` (a tree of plain tensors, each ``lead`` dims longer than
    its ``template`` leaf) with each leaf placed as its template leaf is,
    when that is a DTensor: the lead dims replicated, each sharded dim
    shifted by ``lead``. Every rank drew the same full leaf, so each keeps
    its own shard and nothing is sent. Leaves of a plain template stay as
    they are."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    def one(r, tm):
        if not isinstance(tm, DTensor) or isinstance(r, DTensor):
            return r
        pl = [Shard(p.dim + lead) if p.is_shard() else Replicate()
              for p in tm.placements]
        return distribute_tensor(r, tm.device_mesh, pl, src_data_rank=None)
    return tree_map(one, raw, template)


class PlacedDraws:
    """A draw source for a placed run (``launch.train(mesh=)``): each
    draw of ``inner`` (taken whole, so bitwise the unplaced run's), then
    placed like the parameters it perturbs (:func:`place_like`); the DP
    noise replicated on ``mesh``."""

    def __init__(self, inner, mesh) -> None:
        self.inner, self.mesh = inner, mesh

    def client_directions(self, t, template, n_rows, q):
        return place_like(self.inner.client_directions(t, template, n_rows,
                                                       q), template, 2)

    def server_directions(self, t, template, q):
        return place_like(self.inner.server_directions(t, template, q),
                          template, 1)

    def noise(self, t, n_rows, n):
        from torch.distributed.tensor import Replicate, distribute_tensor
        return distribute_tensor(
            self.inner.noise(t, n_rows, n), self.mesh,
            [Replicate()] * self.mesh.ndim, src_data_rank=None)


# RowDraws' streams: every address is (seed, stream, t, row), four words
_SCHEDULE, _INDICES, _CLIENT, _SERVER, _GLOBAL, _NOISE = range(6)


def seed_directions(key, template, q: int):
    """The default ``directions`` of a population party: ``key`` is the
    (seed, t, row) words :meth:`RowDraws.row_key` sends; the (q, *leaf)
    N(0, 1) leaves come from a generator on the template's device seeded
    by those words alone, so a party in another process draws what the
    engine's :class:`RowDraws` expects."""
    seed, t, row = (int(w) for w in np.asarray(key).reshape(-1))
    device = tree_leaves(template)[0].device
    with record_function("direction draws"):
        return _normals(_seeded((seed, _CLIENT, t, row), device), template,
                        (q,))


class RowDraws:
    """The addressable draw source: the schedule, the sample indices, each
    block row's client directions, the zoo-vfl server's and the
    synchronous global directions, and each row's DP noise, every one
    from a ``torch.Generator(device)`` seeded by (seed, stream, t, row)
    alone. So draws do not depend on call order: the in-process engine
    (which asks for a round's rows at once) and the population engine
    over the wire (whose parties draw their own row) agree, and a resumed
    run draws what an unbroken run draws."""

    def __init__(self, seed: int, device) -> None:
        self.seed = int(seed)
        self.device = torch.device(device)

    def _g(self, stream: int, t: int = 0, row: int = 0) -> torch.Generator:
        return _seeded((self.seed, stream, t, row), self.device)

    def schedule(self, steps, n_clients, probs=None, block_size=1):
        s = make_schedule(self._g(_SCHEDULE), steps, n_clients, probs,
                          block_size)
        return s.reshape(steps, block_size)

    def sample_indices(self, steps, batch, n):
        return torch.randint(0, n, (steps, batch),
                             generator=self._g(_INDICES), device=self.device)

    def row_key(self, t: int, r: int) -> np.ndarray:
        return np.asarray([self.seed, t, r], np.int64)

    @staticmethod
    def directions(key, template, q):
        return seed_directions(key, template, q)

    def client_directions(self, t, template, n_rows, q):
        rows = [self.directions(self.row_key(t, r), template, q)
                for r in range(n_rows)]
        return tree_map(lambda *xs: torch.stack(xs), *rows)

    def server_directions(self, t, template, q):
        with record_function("direction draws"):
            return _normals(self._g(_SERVER, t), template, (q,))

    def global_directions(self, t, template, q):
        with record_function("direction draws"):
            return _normals(self._g(_GLOBAL, t), template, (q,))

    def noise(self, t, n_rows, n):
        with record_function("direction draws"):
            return torch.stack([
                torch.randn((n,), generator=self._g(_NOISE, t, r),
                            device=self.device) for r in range(n_rows)])


def copy_into(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``src``'s values written into ``dst``, a static buffer. Two
    DTensors copy their local shards (``to_local()``): the buffer's mesh
    and placements are ``src``'s, so nothing moves between ranks and
    DTensor's dispatch is not entered; a DTensor placed otherwise is
    refused."""
    if isinstance(dst, DTensor) or isinstance(src, DTensor):
        if not (isinstance(dst, DTensor) and isinstance(src, DTensor)
                and dst.device_mesh == src.device_mesh
                and dst.placements == src.placements):
            raise ValueError(
                f"cannot refill a buffer placed "
                f"{getattr(dst, 'placements', None)} from one placed "
                f"{getattr(src, 'placements', None)}")
        dst, src = dst.to_local(), src.to_local()
    return dst.copy_(src)


def _counts(args) -> tuple:
    """The integer arguments of a draw call (rows, lanes, lengths)."""
    return tuple(a for a in args if isinstance(a, int))


class RoundDraws:
    """A round's draws on static buffers: the draw source a captured
    round (``async_engine._make_runner``) reads, so its random numbers
    outlive the CUDA graph that replays it.

    The first round a step runs over it is recorded: each call is passed
    to ``source`` as the step made it, the answer is copied into a buffer
    and the step reads the buffer. From then on a step's calls are
    answered from those buffers, in the recorded order (each call checks
    it asks what was recorded), and :meth:`fill` refills them for round
    ``t`` in place before the round runs: it asks ``source`` for exactly
    the recorded calls, in the recorded order, with ``t``. So a
    ``TorchDraws`` generator advances as the eager step advances it, and
    any source (``RowDraws``, ``StepDraws``, an injected replay) answers
    what it would answer the eager step. :meth:`done` closes a round.
    ``t`` is the round :meth:`fill` last set. The draws of a placed run
    (:class:`PlacedDraws`) are DTensors: their buffers are DTensors placed
    as the draws are, refilled shard by shard (:func:`copy_into`).

    The certifier traces over :class:`FilledDraws` instead, and cannot
    take this class: its tree walk (``analysis.ifc._flatten`` and
    ``_rebuild``) finds a step's draws as graph inputs only in a dict
    keyed by kind, and rebuilds that dict over the trace's proxies,
    whereas these buffers sit in a call record with a cursor, known only
    after an eager round has run. The certifier runs no round before it
    traces, and the population trace fills the noise alone."""

    def __init__(self, source) -> None:
        self.source = source
        self.t = 0
        self.calls: list = []          # (method, args) in the step's order
        self.buffers: list = []
        self.recorded = False
        self._next = 0

    def fill(self, t: int) -> None:
        """Round ``t``'s draws into the buffers (the first round records
        instead, as its step asks)."""
        self.t = int(t)
        if not self.recorded:
            return
        for (name, args), buf in zip(self.calls, self.buffers):
            tree_map(copy_into, buf,
                     getattr(self.source, name)(self.t, *args))

    def done(self) -> None:
        """Close a round: after the first it seals the record; after
        every other it checks the step asked for every buffer."""
        if self.recorded and self._next != len(self.calls):
            raise RuntimeError(f"the round asked for {self._next} of its "
                               f"{len(self.calls)} recorded draws")
        self.recorded, self._next = True, 0

    def _ask(self, name: str, t, *args):
        if not self.recorded:
            out = getattr(self.source, name)(self.t, *args)
            buf = tree_map(torch.clone, out)
            self.calls.append((name, args))
            self.buffers.append(buf)
            return buf
        i = self._next
        want = self.calls[i] if i < len(self.calls) else ("nothing", ())
        if (want[0] != name
                or _counts(want[1]) != _counts(args)):
            raise RuntimeError(f"draw {i} of the round asks {name}"
                               f"{_counts(args)}, the record has "
                               f"{want[0]}{_counts(want[1])}")
        self._next += 1
        return self.buffers[i]

    def client_directions(self, t, template, n_rows, q):
        return self._ask("client_directions", t, template, n_rows, q)

    def server_directions(self, t, template, q):
        return self._ask("server_directions", t, template, q)

    def global_directions(self, t, template, q):
        return self._ask("global_directions", t, template, q)

    def noise(self, t, n_rows, n):
        return self._ask("noise", t, n_rows, n)


class FilledDraws(dict):
    """One round's draws taken ahead of time, answered from tensors: the
    draw source a traced step takes, so its random numbers are graph
    inputs (the certifier, ``repro_torch.analysis.certify``, traces a step
    over one). A ``dict`` subclass, so a tree walk sees its tensors:
    ``"client"`` (n_rows, q, *leaf) leaves, ``"server"`` and ``"global"``
    (q, *leaf) leaves, ``"noise"`` (n_rows, 1+q). Each call checks it asks
    for what was filled."""

    @classmethod
    def fill(cls, source, t: int, *, client, server, params, n_rows: int,
             q: int) -> "FilledDraws":
        """Round ``t``'s draws from ``source`` for a block of ``n_rows``
        rows: ``client`` is one row's client parameters, ``server`` the
        server's, ``params`` the whole tree."""
        return cls(client=source.client_directions(t, client, n_rows, q),
                   server=source.server_directions(t, server, q),
                   noise=source.noise(t, n_rows, 1 + q),
                   **{"global": source.global_directions(t, params, q)})

    def _take(self, name: str, lead):
        tree = self[name]
        got = tuple(tree_leaves(tree)[0].shape[:len(lead)])
        if got != tuple(lead):
            raise ValueError(f"filled {name} draws lead with {got}, the step "
                             f"asks for {tuple(lead)}")
        return tree

    def client_directions(self, t, template, n_rows, q):
        return self._take("client", (n_rows, q))

    def server_directions(self, t, template, q):
        return self._take("server", (q,))

    def global_directions(self, t, template, q):
        return self._take("global", (q,))

    def noise(self, t, n_rows, n):
        return self._take("noise", (n_rows, n))
