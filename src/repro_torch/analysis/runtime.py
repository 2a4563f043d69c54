"""Runtime sanitizers: the host-read sentinel and the recompile sentinel.

The static passes prove what the source *says*; these prove what a run
*does*. ``strict()`` wraps a steady-state region (e.g. the paged-decode
block loop) and asserts zero host reads and zero fresh compiles inside
it, which turns the scheduler's self-reported ``host_transfers`` counter
into an externally enforced property.

**Host reads.** PyTorch reads a tensor's value on the host through a few
Python-level entry points, and the sentinel patches each of them on
``torch.Tensor`` for the region: ``item``, ``tolist``, ``numpy``,
``__array__`` (``np.asarray``), ``__bool__``, ``__float__``, ``__int__``
and ``__index__``, and a CUDA tensor's ``.cpu()`` / ``.to("cpu")``. Each
read counts once, under the call site outside torch and this module: a
call nested in another counted one (``__array__`` calling ``numpy``) is
not counted again, and the CPU copy a counted ``.cpu()`` made reads free
afterwards (``.cpu().numpy()`` is one transfer). On the CPU every tensor
is the device's, so its reads count too (``.cpu()`` of a CPU tensor
moves nothing and is free).

**Sync debug mode.** On the card ``strict(sync_debug="error")`` also sets
``torch.cuda.set_sync_debug_mode("error")`` for the region (as the JAX
package engages its transfer guard), lifting it around the reads the
sentinel counts: then every synchronizing operation in the region is
either counted and named, or raises (a ``nonzero``, a boolean-mask index,
a copy from pageable host memory: syncs no Python entry point shows).

**Fresh compiles.** What compiles in the port is a CUDA graph capture
(:class:`repro_torch.graphs.StepGraph`) and an ``nvcc`` build of a kernel
library (``repro_torch.kernels._build.build_all`` for a source with no
library yet); the recompile sentinel counts both, by name.

Regions nest: every read or compile is recorded in each open region's
report.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
import typing

import torch

_READS = ("item", "tolist", "numpy", "__array__", "__bool__", "__float__",
          "__int__", "__index__")
_MOVES = ("cpu", "to")
# set on the CPU tensor a counted device->host move returned
_HOST_COPY = "_analysis_host_copy"

_tls = threading.local()
_lock = threading.Lock()


def _caller_site() -> str:
    """First stack frame outside torch and this module."""
    frame = sys._getframe(2)
    while frame is not None:
        fname = frame.f_code.co_filename
        if "/torch/" not in fname and not fname.endswith("analysis/runtime.py"):
            return f"{fname}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>"


@dataclasses.dataclass
class SanitizerReport:
    """Mutable tally filled in while a ``strict()`` region runs."""

    d2h: int = 0
    compiles: int = 0
    d2h_sites: dict[str, int] = dataclasses.field(default_factory=dict)
    compiled_names: list[str] = dataclasses.field(default_factory=list)

    def record_d2h(self, site: str) -> None:
        self.d2h += 1
        self.d2h_sites[site] = self.d2h_sites.get(site, 0) + 1

    def record_compile(self, name: str) -> None:
        self.compiles += 1
        self.compiled_names.append(name)

    def violations(self, *, max_d2h: int = 0, max_compiles: int = 0) -> list[str]:
        out = []
        if self.d2h > max_d2h:
            sites = ", ".join(
                f"{site} x{n}" for site, n in sorted(self.d2h_sites.items())
            )
            out.append(
                f"{self.d2h} host read(s) (allowed {max_d2h}): {sites}"
            )
        if self.compiles > max_compiles:
            names = ", ".join(self.compiled_names)
            out.append(
                f"{self.compiles} fresh compile(s) (allowed {max_compiles}): {names}"
            )
        return out


class StrictModeViolation(AssertionError):
    """Raised when a strict() region broke its host-read/compile budget."""


class _Patches:
    """One layer of patches shared by every open region of a kind:
    installed when the first region opens, removed when the last closes;
    each event is recorded in every open region's report."""

    def __init__(self, install: typing.Callable[[], typing.Callable[[], None]]):
        self._install = install
        self._undo: typing.Callable[[], None] | None = None
        self.reports: list[SanitizerReport] = []

    @contextlib.contextmanager
    def open(self, report: SanitizerReport) -> typing.Iterator[SanitizerReport]:
        with _lock:
            if not self.reports:
                self._undo = self._install()
            self.reports.append(report)
        try:
            yield report
        finally:
            with _lock:
                self.reports = [r for r in self.reports if r is not report]
                if not self.reports and self._undo is not None:
                    self._undo()
                    self._undo = None


# ---------------------------------------------------------------------------
# host-read sentinel
# ---------------------------------------------------------------------------


def _counted(t: torch.Tensor, op: typing.Callable[[], typing.Any]) -> typing.Any:
    """Run ``op`` (a read of ``t``) at depth + 1, with the sync debug mode
    lifted for a CUDA tensor: the sentinel counts and names this sync."""
    depth = getattr(_tls, "depth", 0)
    _tls.depth = depth + 1
    lift = getattr(_tls, "sync_debug", False) and t.is_cuda
    prev = torch.cuda.get_sync_debug_mode() if lift else 0
    if lift:
        torch.cuda.set_sync_debug_mode(0)
    try:
        return op()
    finally:
        if lift:
            torch.cuda.set_sync_debug_mode(prev)
        _tls.depth = depth


def _install_reads() -> typing.Callable[[], None]:
    cls = torch.Tensor
    saved = {name: cls.__dict__.get(name) for name in _READS + _MOVES}

    def read(name: str) -> typing.Any:
        orig = getattr(cls, name)

        def patched(self: torch.Tensor, *args: typing.Any, **kw: typing.Any) -> typing.Any:
            if getattr(_tls, "depth", 0) == 0 and not getattr(self, _HOST_COPY, False):
                site = _caller_site()
                for rep in list(_HOST.reports):
                    rep.record_d2h(site)
            return _counted(self, lambda: orig(self, *args, **kw))

        patched.__name__ = name
        return patched

    def move(name: str) -> typing.Any:
        orig = getattr(cls, name)

        def patched(self: torch.Tensor, *args: typing.Any, **kw: typing.Any) -> typing.Any:
            top = getattr(_tls, "depth", 0) == 0
            out = _counted(self, lambda: orig(self, *args, **kw))
            if (
                top
                and self.is_cuda
                and isinstance(out, torch.Tensor)
                and out.device.type == "cpu"
            ):
                site = _caller_site()
                for rep in list(_HOST.reports):
                    rep.record_d2h(site)
                setattr(out, _HOST_COPY, True)
            return out

        patched.__name__ = name
        return patched

    for name in _READS:
        setattr(cls, name, read(name))
    for name in _MOVES:
        setattr(cls, name, move(name))

    def undo() -> None:
        for name, orig in saved.items():
            if orig is None:
                delattr(cls, name)
            else:
                setattr(cls, name, orig)

    return undo


_HOST = _Patches(_install_reads)


def host_transfer_sentinel(
    report: SanitizerReport,
) -> typing.ContextManager[SanitizerReport]:
    """Count host reads of tensors inside the block."""
    return _HOST.open(report)


# ---------------------------------------------------------------------------
# recompile sentinel
# ---------------------------------------------------------------------------


def _install_compiles() -> typing.Callable[[], None]:
    from repro_torch import graphs
    from repro_torch.kernels import _build

    init0, build0 = graphs.StepGraph.__init__, _build.build_all

    def init(self: typing.Any, body: typing.Any, *args: typing.Any, **kw: typing.Any) -> None:
        init0(self, body, *args, **kw)
        name = getattr(body, "__qualname__", type(body).__name__)
        for rep in list(_COMPILES.reports):
            rep.record_compile(f"CUDA graph capture of {name}")

    def build_all(names: typing.Any = None) -> typing.Any:
        names = list(_build.SOURCES) if names is None else list(names)
        fresh = [n for n in names if not _build.library_path(n).exists()]
        out = build0(names)
        for n in fresh:
            for rep in list(_COMPILES.reports):
                rep.record_compile(f"nvcc build of {n}")
        return out

    graphs.StepGraph.__init__ = init
    _build.build_all = build_all

    def undo() -> None:
        graphs.StepGraph.__init__ = init0
        _build.build_all = build0

    return undo


_COMPILES = _Patches(_install_compiles)


def recompile_sentinel(
    report: SanitizerReport,
) -> typing.ContextManager[SanitizerReport]:
    """Count CUDA graph captures and ``nvcc`` builds inside the block."""
    return _COMPILES.open(report)


# ---------------------------------------------------------------------------
# strict mode
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _sync_debug(mode: str) -> typing.Iterator[None]:
    """``torch.cuda.set_sync_debug_mode(mode)`` for the block (nothing on
    a machine without CUDA: the CPU has no device to sync with)."""
    if not torch.cuda.is_available():
        yield
        return
    prev, engaged = torch.cuda.get_sync_debug_mode(), getattr(_tls, "sync_debug", False)
    torch.cuda.set_sync_debug_mode(mode)
    _tls.sync_debug = True
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
        _tls.sync_debug = engaged


@contextlib.contextmanager
def strict(
    *,
    max_host_transfers: int = 0,
    max_compiles: int = 0,
    check: bool = True,
    sync_debug: str | None = None,
) -> typing.Iterator[SanitizerReport]:
    """Assert a region performs no host reads and no fresh compiles.

    Yields a :class:`SanitizerReport`; on exit raises
    :class:`StrictModeViolation` listing offending call sites if any
    budget was exceeded (set ``check=False`` to only count). Pass
    ``sync_debug="error"`` to also raise at the first synchronizing CUDA
    operation the sentinel does not count (see the module docstring).
    """
    report = SanitizerReport()
    with contextlib.ExitStack() as stack:
        if sync_debug is not None:
            stack.enter_context(_sync_debug(sync_debug))
        stack.enter_context(host_transfer_sentinel(report))
        stack.enter_context(recompile_sentinel(report))
        yield report
    if check:
        problems = report.violations(
            max_d2h=max_host_transfers, max_compiles=max_compiles
        )
        if problems:
            raise StrictModeViolation("; ".join(problems))
