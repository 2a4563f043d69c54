"""CUDA graphs of the port's per-step device programs.

The JAX package compiles its decode loop, the continuous scheduler's
K-step block and the resume replay each as one ``lax.scan``, so the host
does no work per step. The port's counterpart captures ONE step as a
``torch.cuda.CUDAGraph`` on static buffers and replays it once a step: a
replay costs the host microseconds where the eager step spends tens of
milliseconds dispatching its launches. A :class:`StepGraph` is built
from a ``body`` callable that reads and writes only tensors that outlive
it (the buffers it is replayed on):

* **warm-up** — the body runs once eagerly on a side stream, for real:
  that is the program's first step, and it keeps first-use work (library
  loads, cuBLAS handles, the kernels' attribute calls) out of the
  capture;
* **capture** — the body runs again under ``torch.cuda.graph``; nothing
  executes, every launch is recorded with its arguments (the addresses
  of the buffers included), and the body's temporaries come from the
  graph's memory pool;
* **replay** — ``replay(n)`` launches the recorded step n times.

A graph must only ever replay on the buffers it was captured on. That
holds doubly where a kernel's launcher encodes host-side descriptors of
its operands: the bf16 flash-attention launcher passes TMA tensor maps
(which hold the operands' addresses) by value as kernel parameters, and
a replay passes them as they were captured. Captured steps do reach
flash attention: Whisper's cross-attention in the captured global decode
step (``launch/serve.py``), the LM adapter's server loss in a captured
engine round (``core/async_engine.py``), and every forward of a captured
training step and of the population server's graphed functions
(:class:`GraphedFn`), the step's q, k, v and o graph-pool temporaries.
Such a launch is valid
only because its operands keep their addresses across replays: q, k, v
and o are either static buffers or temporaries of the graph's own pool,
which every replay re-creates at the addresses of the capture. The
launch path keeps that true: ``kernels/flash_attention/ops.py`` takes
the output from the caching allocator (the pool, under capture), reads
no tensor to the host, and ``kernel.py`` passes the captured pointers on
the current (capturing) stream; the C launcher encodes the tensor maps
from those pointers and sets the kernel's shared-memory attribute, host
calls that a capture allows and that record nothing.

**Launch accounting.** The kernels' Python wrappers count launches
(``ops.launches``); a replay never runs them. So a capture moves what its
wrappers counted out of the counters (those launches were recorded, not
run) into :attr:`StepGraph.captured`, and every replay adds them back,
once a replay. The counters then read the launches that ran on the card,
eager and replayed alike, and :data:`replayed` keeps the replayed share.
There is no eager fallback: a capture that fails raises.

**Graphs keyed by shape.** The JAX package also compiles functions that
run once a call on inputs whose shapes vary: the LM training step
(``jax.jit(step_fn, donate_argnums=(0, 1))``) and the population
server's two functions, which ``jax.jit`` retraces for each new input
shape. :class:`GraphedFn` is the counterpart of that cache: a function
``fn(*args, t, draws)`` captured once per key (the inputs' tree
structure, shapes and dtypes, and any other value among them, such as a
Python index), each capture a :class:`StepGraph` on static input
buffers, its draws recorded through a
:class:`~repro_torch.core.draws.RoundDraws` and refilled for each call's
``t``. The arguments it is told are donated are read and written where
they are, as ``donate_argnums`` lets XLA do: the caller passes the same
trees every call and ``fn`` updates them in place.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import gc
import time
import weakref
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.profiler import record_function

from repro_torch.analysis import marks
from repro_torch.core.draws import RoundDraws, copy_into
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.zoo_dual_matmul import ops as zoo_ops
from repro_torch.tree import tree_leaves, tree_map

# every launch counter of the kernel wrappers, by a name for each
COUNTERS: Dict[str, Dict[str, int]] = {
    "flash_attention": flash_ops.launches, "rmsnorm": rms_ops.launches,
    "rmsnorm_routes": rms_ops.route_launches, "ssd_chunk": ssd_ops.launches,
    "zoo_dual_matmul": zoo_ops.launches}
# launches added to COUNTERS by graph replays, counter by counter
replayed: Dict[str, Dict[str, int]] = {
    group: {name: 0 for name in counts} for group, counts in COUNTERS.items()}


def reset_replayed() -> None:
    for counts in replayed.values():
        for name in counts:
            counts[name] = 0


def _snapshot() -> Dict[str, Dict[str, int]]:
    return {group: dict(counts) for group, counts in COUNTERS.items()}


def _add(delta: Dict[str, Dict[str, int]], times: int, *targets) -> None:
    for group, counts in delta.items():
        for name, n in counts.items():
            for target in targets:
                target[group][name] += n * times


# the zero-length profiler range :meth:`StepGraph.timed_replays` opens
# where its replays start
REPLAYS_START = "graph replays start"

# CUgraphNodeType (the CUDA driver API), by value
_NODE_KINDS = ("kernel", "memcpy", "memset", "host", "graph", "empty",
               "wait_event", "event_record", "ext_semas_signal",
               "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
               "conditional")


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of ``cuda.h`` (CUDA 12)."""
    _fields_ = [("func", ctypes.c_void_p)] + [
        (f, ctypes.c_uint) for f in (
            "gridDimX", "gridDimY", "gridDimZ", "blockDimX", "blockDimY",
            "blockDimZ", "sharedMemBytes")] + [
        (f, ctypes.c_void_p) for f in ("kernelParams", "extra", "kern",
                                       "ctx")]


@functools.cache
def _driver():
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int)]
    return lib


def _check(err: int, call: str) -> None:
    if err:
        raise RuntimeError(f"{call} failed with CUDA error {err}")


def _nodes(raw_graph: int) -> list:
    """The nodes of a captured ``cudaGraph_t`` with their kinds (an index
    of :data:`_NODE_KINDS`), from the driver's ``cuGraphGetNodes``."""
    lib = _driver()
    n = ctypes.c_size_t(0)
    _check(lib.cuGraphGetNodes(raw_graph, None, ctypes.byref(n)),
           "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(lib.cuGraphGetNodes(raw_graph, nodes, ctypes.byref(n)),
           "cuGraphGetNodes")
    kind = ctypes.c_int(0)
    out = []
    for node in nodes:
        _check(lib.cuGraphNodeGetType(node, ctypes.byref(kind)),
               "cuGraphNodeGetType")
        out.append((node, kind.value))
    return out


def node_kinds(raw_graph: int) -> Dict[str, int]:
    """A captured graph's nodes counted by kind ("kernel", "memcpy",
    "memset", ...)."""
    counts: Dict[str, int] = {}
    for _, k in _nodes(raw_graph):
        name = _NODE_KINDS[k] if k < len(_NODE_KINDS) else str(k)
        counts[name] = counts.get(name, 0) + 1
    return counts


def kernel_names(raw_graph: int) -> Dict[str, int]:
    """A captured graph's kernel nodes counted by their function's
    (mangled) name, from ``cuGraphKernelNodeGetParams_v2`` and
    ``cuFuncGetName`` (``cuKernelGetName`` for a node that names its
    kernel by a ``CUkernel`` handle alone; CUDA 12.3 and later)."""
    lib = _driver()
    params, name = _KernelNodeParams(), ctypes.c_char_p()
    counts: Dict[str, int] = {}
    for node, k in _nodes(raw_graph):
        if k != 0:
            continue
        _check(lib.cuGraphKernelNodeGetParams_v2(
            ctypes.c_void_p(node), ctypes.byref(params)),
            "cuGraphKernelNodeGetParams_v2")
        if params.func:
            _check(lib.cuFuncGetName(ctypes.byref(name),
                                     ctypes.c_void_p(params.func)),
                   "cuFuncGetName")
        else:
            _check(lib.cuKernelGetName(ctypes.byref(name),
                                       ctypes.c_void_p(params.kern)),
                   "cuKernelGetName")
        key = name.value.decode()
        counts[key] = counts.get(key, 0) + 1
    return counts


@contextlib.contextmanager
def _no_collection():
    """Python's cyclic garbage collector off inside: a collection that
    frees a dead graph during a capture (one left in a reference cycle)
    destroys a CUDA graph, which a capture forbids, and the capture
    fails. The garbage waits for the next collection after the
    capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class StepGraph:
    """``body`` run once eagerly (the first step), then captured as a CUDA
    graph on ``device`` in memory ``pool`` (a
    ``torch.cuda.graph_pool_handle()`` shared by graphs that never run
    concurrently; None: a pool of its own). :meth:`replay` runs it.

    ``capture_s`` is the capture and instantiation's host time (the
    warm-up step is not in it); ``replay_s`` the host time of
    :meth:`timed_replays`; ``nodes``, ``kernel_nodes`` and ``node_kinds``
    count the captured graph (:meth:`kernel_names` names its kernels);
    ``captured`` is the kernel launches one replay makes,
    counter by counter. The graph keeps ``body``, and so every tensor it
    closes over, alive: a replay reads them where they were captured.
    The capture runs with Python's cyclic garbage collector off
    (:func:`_no_collection`).
    ``free_cache`` hands the warm-up's freed temporaries back to the card
    (``torch.cuda.empty_cache()``) before the capture, so the graph's
    pool can take their memory (a training step's graph, whose warm-up
    frees a whole step's activations)."""

    def __init__(self, body: Callable[[], None], device: torch.device,
                 pool=None, *, free_cache: bool = False):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        if free_cache:
            torch.cuda.empty_cache()

        tic = time.perf_counter()
        before = _snapshot()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with _no_collection(), torch.cuda.graph(self.graph, pool=pool):
            body()
        after = _snapshot()
        self.captured = {
            group: {name: after[group][name] - before[group][name]
                    for name in counts}
            for group, counts in after.items()}
        _add(self.captured, -1, COUNTERS)       # recorded, not run
        self.node_kinds = node_kinds(self.graph.raw_cuda_graph())
        self.nodes = sum(self.node_kinds.values())
        self.kernel_nodes = self.node_kinds.get("kernel", 0)
        self.graph.instantiate()
        self.capture_s = time.perf_counter() - tic
        self.replays = 0
        self.replay_s = 0.0
        self.device = device
        self.body = body

    def replay(self, n: int = 1) -> None:
        """Launch the captured step ``n`` times on the current stream."""
        for _ in range(n):
            self.graph.replay()
        self.replays += n
        _add(self.captured, n, COUNTERS, replayed)

    def timed_replays(self, n: int,
                      before: Optional[Callable[[int], None]] = None
                      ) -> float:
        """``n`` replays between two synchronisations of the device, each
        after ``before(i)`` (i = 0 .. n - 1) where given (a step's refill
        of its input buffers); returns their host seconds and adds them
        to :attr:`replay_s`. A zero-length profiler range
        :data:`REPLAYS_START` marks where they start, so a profile's
        window over the replays alone starts there and lasts the
        returned seconds."""
        torch.cuda.synchronize(self.device)
        with record_function(REPLAYS_START):
            pass
        tic = time.perf_counter()
        for i in range(n):
            if before is not None:
                before(i)
            self.replay()
        torch.cuda.synchronize(self.device)
        spent = time.perf_counter() - tic
        self.replay_s += spent
        return spent

    def release(self) -> None:
        """Stop keeping ``body`` and what it closes over alive: for an
        owner that keeps the tensors a replay reads alive itself and drops
        the graph before they die (a session's kept decode graph, whose
        parameters are the caller's)."""
        self.body = None

    def stats(self) -> dict:
        """The graph's readings as a result dict carries them."""
        return {"capture_s": self.capture_s, "nodes": self.nodes,
                "kernel_nodes": self.kernel_nodes,
                "node_kinds": self.node_kinds, "replays": self.replays,
                "replay_s": self.replay_s,
                "launches_a_replay": self.launches()}

    def kernel_names(self) -> Dict[str, int]:
        """The captured graph's kernel nodes counted by function name
        (:func:`kernel_names`)."""
        return kernel_names(self.graph.raw_cuda_graph())

    def launches(self) -> Dict[str, int]:
        """One replay's kernel launches, by kernel (routes left out)."""
        return {name: n for group, counts in self.captured.items()
                if group != "rmsnorm_routes" for name, n in counts.items()
                if n}


class Kept:
    """Graphs kept across calls, with their static buffers: a map from a
    call's key to what its first call built, bounded at ``maxsize`` keys,
    the least recently used evicted (its graph and buffers freed with
    it), as ``functools.lru_cache(maxsize=)`` bounds the JAX package's
    compiled functions. The owner (a ``Federation``) frees them all when
    it goes.

    A key put with ``owners`` is also dropped when any of them dies
    (``weakref.finalize``): the tensors a kept graph reads where they are
    but does not keep alive (a decode graph's parameters), so a caller's
    tree that goes frees its key's graph and buffers with it, and a
    key of their ids never outlives them."""

    def __init__(self, maxsize: int) -> None:
        self.maxsize = maxsize
        # key -> (item, the finalizers of its owners)
        self._items: "collections.OrderedDict" = collections.OrderedDict()

    def get(self, key):
        entry = self._items.get(key)
        if entry is None:
            return None
        self._items.move_to_end(key)
        return entry[0]

    def put(self, key, item, owners=()) -> None:
        self.drop(key)
        ref = weakref.ref(self)
        self._items[key] = (item, [weakref.finalize(o, _drop_kept, ref, key)
                                   for o in owners])
        while len(self._items) > self.maxsize:
            self.drop(next(iter(self._items)))

    def drop(self, key) -> None:
        """Forget ``key`` (and stop watching its owners)."""
        _, finalizers = self._items.pop(key, (None, ()))
        for f in finalizers:
            f.detach()

    def keys(self) -> list:
        return list(self._items)

    def __len__(self) -> int:
        return len(self._items)


def _drop_kept(ref, key) -> None:
    kept = ref()
    if kept is not None:
        kept.drop(key)


def signature(tree):
    """The key of a call's arguments: the tree's structure, each tensor
    leaf's shape, dtype and device, each DTensor leaf's global shape,
    dtype, device mesh and placements (``jax.jit``'s cache keys on
    shardings), and every other leaf as it is (a Python int, a string,
    None)."""
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, signature(tree[k])) for k in sorted(tree))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,) + tuple(signature(x) for x in tree)
    if isinstance(tree, DTensor):
        return ("dtensor", tuple(tree.shape), tree.dtype, tree.device_mesh,
                tuple(tree.placements))
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    return ("value", tree)


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class GraphedFn:
    """``fn(*args, t, draws)`` compiled once per key of ``args``
    (:func:`signature`): the counterpart of ``jax.jit``'s cache. ``t``
    indexes the draws of the call and ``draws`` is its draw source; ``fn``
    uses ``t`` only to ask ``draws``. Arguments at the positions in
    ``donate`` are the caller's own trees, read and written where they
    are (the caller passes the same trees every call; a tree passed anew
    is copied into the captured one); every other argument is copied into
    a static buffer of the key before the call (a DTensor's local shard
    into the buffer's: the key fixed its mesh and placements).

    The first call of a key runs ``fn`` eagerly on those buffers, its
    draws recorded through a :class:`RoundDraws` over ``draws``, and
    returns what it returns. On a CUDA ``device`` that call is the warm-up
    of a :class:`StepGraph` capturing ``fn`` on the same buffers (every
    graph of the object in one memory pool: they never run at once), and
    every later call of the key copies its inputs in, refills the draws
    for its ``t`` and replays, returning the captured outputs: they hold
    until the next replay of any graph of the object, so a caller reads
    or copies them before it calls again. A capture that fails raises.
    On the CPU every later call runs ``fn`` eagerly on the key's buffers
    and refilled draws, the captured program's loop form; under the
    certifier's trace ``fn`` runs on the arguments as they are.

    ``graphs`` holds each key's :class:`StepGraph` (None on the CPU)."""

    def __init__(self, fn: Callable, device, *, donate: Tuple[int, ...] = (),
                 pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.donate = frozenset(donate)
        self.capture = self.device.type == "cuda"
        if self.capture and pool is None:
            pool = torch.cuda.graph_pool_handle()
        self.pool = pool
        self._keys: Dict[tuple, "_Keyed"] = {}

    @property
    def graphs(self) -> Dict[tuple, Optional[StepGraph]]:
        return {key: keyed.graph for key, keyed in self._keys.items()}

    def __call__(self, *args):
        *args, t, draws = args
        if marks.tracing():
            return self.fn(*args, t, draws)
        key = signature(args)
        keyed = self._keys.get(key)
        if keyed is None:
            keyed = self._keys[key] = _Keyed(self, args, t, draws)
            # the first outputs are the caller's: the key keeps no copy
            first, keyed.first = keyed.first, None
            return first
        return keyed(args, t, draws)

    def stats(self) -> dict:
        """The captured graphs' readings: how many, their capture seconds,
        nodes, kernel nodes and replays, each in capture order."""
        gs = [g for g in self.graphs.values() if g is not None]
        return {"graphs": len(gs),
                "capture_s": [g.capture_s for g in gs],
                "nodes": [g.nodes for g in gs],
                "kernel_nodes": [g.kernel_nodes for g in gs],
                "replays": [g.replays for g in gs]}


class _Keyed:
    """One key of a :class:`GraphedFn`: its static inputs, recorded
    draws and, on the card, its graph."""

    def __init__(self, owner: GraphedFn, args, t: int, draws):
        self.inputs = [a if i in owner.donate else tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x, a)
            for i, a in enumerate(args)]
        self.leaves = _tensors(self.inputs)
        self.draws = RoundDraws(draws)
        self.draws.fill(t)
        # the body closes over neither the key nor its owner, so a graph
        # is freed with its GraphedFn, not at a later garbage collection
        fn, inputs, rd, outs = owner.fn, self.inputs, self.draws, []

        def body():
            outs.append(fn(*inputs, rd.t, rd))
            rd.done()
        self.body, self.outs = body, outs
        self.graph = None
        if owner.capture:
            self.graph = StepGraph(body, owner.device, owner.pool,
                                   free_cache=True)
            self.first, self.out = outs
            outs.clear()
        else:
            body()
            self.first = outs.pop()

    def __call__(self, args, t: int, draws):
        for dst, src in zip(self.leaves, _tensors(args)):
            if src is not dst:
                copy_into(dst, src)
        self.draws.source = draws
        self.draws.fill(t)
        if self.graph is None:
            self.body()
            return self.outs.pop()
        self.graph.replay()
        return self.out
