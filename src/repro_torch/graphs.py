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
step (``launch/serve.py``) and the LM adapter's server loss in a
captured engine round (``core/async_engine.py``). Such a launch is valid
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
"""
from __future__ import annotations

import ctypes
import functools
import time
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.zoo_dual_matmul import ops as zoo_ops

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

# CUgraphNodeType of a kernel node (the CUDA driver API)
_KERNEL_NODE = 0


@functools.cache
def _driver():
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int)]
    return lib


def node_counts(raw_graph: int) -> Tuple[int, int]:
    """(nodes, kernel nodes) of a captured ``cudaGraph_t``, from the
    driver's ``cuGraphGetNodes``."""
    lib = _driver()
    n = ctypes.c_size_t(0)
    err = lib.cuGraphGetNodes(raw_graph, None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed with CUDA error {err}")
    nodes = (ctypes.c_void_p * n.value)()
    err = lib.cuGraphGetNodes(raw_graph, nodes, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed with CUDA error {err}")
    kinds = ctypes.c_int(0)
    kernels = 0
    for node in nodes:
        err = lib.cuGraphNodeGetType(node, ctypes.byref(kinds))
        if err:
            raise RuntimeError(f"cuGraphNodeGetType failed with CUDA error "
                               f"{err}")
        kernels += kinds.value == _KERNEL_NODE
    return n.value, kernels


class StepGraph:
    """``body`` run once eagerly (the first step), then captured as a CUDA
    graph on ``device`` in memory ``pool`` (a
    ``torch.cuda.graph_pool_handle()`` shared by graphs that never run
    concurrently; None: a pool of its own). :meth:`replay` runs it.

    ``capture_s`` is the capture and instantiation's host time (the
    warm-up step is not in it); ``replay_s`` the host time of
    :meth:`timed_replays`; ``nodes`` and ``kernel_nodes`` count the
    captured graph; ``captured`` is the kernel launches one replay makes,
    counter by counter. The graph keeps ``body``, and so every tensor it
    closes over, alive: a replay reads them where they were captured."""

    def __init__(self, body: Callable[[], None], device: torch.device,
                 pool=None):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)

        tic = time.perf_counter()
        before = _snapshot()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.graph, pool=pool):
            body()
        after = _snapshot()
        self.captured = {
            group: {name: after[group][name] - before[group][name]
                    for name in counts}
            for group, counts in after.items()}
        _add(self.captured, -1, COUNTERS)       # recorded, not run
        self.nodes, self.kernel_nodes = node_counts(
            self.graph.raw_cuda_graph())
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

    def stats(self) -> dict:
        """The graph's readings as a result dict carries them."""
        return {"capture_s": self.capture_s, "nodes": self.nodes,
                "kernel_nodes": self.kernel_nodes, "replays": self.replays,
                "replay_s": self.replay_s,
                "launches_a_replay": self.launches()}

    def launches(self) -> Dict[str, int]:
        """One replay's kernel launches, by kernel (routes left out)."""
        return {name: n for group, counts in self.captured.items()
                if group != "rmsnorm_routes" for name, n in counts.items()
                if n}

