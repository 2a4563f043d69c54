"""Continuous batching for the split serve plane, on paged caches.

Ported from the JAX package's ``federation/scheduler.py``. A
:class:`ServeScheduler` owns ``max_batch`` fixed SLOTS whose
sequence-indexed cache state lives in a shared page pool
(:mod:`repro_torch.federation.paging`) addressed through per-slot block
tables, admits queued requests into free slots mid-flight, and drives the
churning mix in K-step decode blocks. The VFL party split stays intact:
each slot's owning client embeds its token, the server decodes every slot
in one batched step, and each request keeps its own exact wire ledger.

The host stays out of the loop:

* **block stepping** — the slot state (positions ``t``, generation
  cursors, ``remaining`` counters, the generation buffer, the carried
  logits, the noise table) is device tensors updated in place, whose
  shapes change only between blocks (the noise table grows at
  admission). The active mask derives on the device from ``remaining >
  0``, so a block of K steps makes no host sync: nothing in it reads a
  device value on the host or branches on one. K is the largest power of two no
  larger than the host mirror's smallest ``remaining``, so a block never
  overshoots a retirement. The JAX package compiles the block as one
  ``lax.scan``; on the card the port captures ONE batched step as a CUDA
  graph on the slot tensors and replays it K times (the block tables are
  one device tensor of fixed shape that a change is copied into; the
  graph is captured again only when the noise table grows or a restore
  replaces the slot tensors: ``graph_captures`` counts them). On the CPU,
  and with ``use_scan=False``, a block is a Python loop of K eager steps
  of the same step function.
* **wave retirement** — after a block, every slot whose host-mirrored
  ``remaining`` hit zero retires together: ONE device-to-host fetch per
  wave (``host_transfers`` counts it) carries the tokens, the final
  logits and their finiteness.
* **deferred accounting** — prefill uploads are logged at admission
  (``n_steps=prompt_len, n_gen=0``) and generation at retirement
  (``n_steps=gen_len, n_gen=gen_len``): together the same ordered Message
  list a solo ``fed.decode`` logs in one ``account_serve`` call.
* **wave admission** — the queue's head run of equal-length prompts is
  admitted as ONE wave: one batched chunked prefill and one install
  scatter cover it (a width-1 wave reuses a persistent dense
  ``(1, seq_len)`` buffer whose recurrent state leaves are re-zeroed;
  stale KV rows beyond the prompt are masked exactly). Admission is
  page-gated FIFO: a small pool makes requests wait for pages, never
  reorder.

**Sampling.** The JAX package samples request r at position t on
``fold_in(key_r, 100 + t)``. The port gives each request a draw source
whose noise is a pure function of (its seed, t)
(:class:`repro_torch.federation.serving.PositionGumbel`). When the
temperature is above 0, admission draws a request's rows for the
positions it will generate into its slot's row of a ``(slots,
longest generation, vocab)`` f32 table, indexed on the device by the
slot's generation cursor (about 16 MB a request at Phi-3's vocabulary
and 128 tokens). So a request's
tokens do not depend on what shares its batch, when it was admitted or a
preemption, and equal a solo ``fed.decode`` given the same source. A
request may also carry any source with ``rows(t0, n, vocab, device)``
(the tests inject the JAX package's noise that way).

**Failure policy**, as the JAX package's:

* **bounded queue** — ``submit`` past ``max_queue`` raises
  :class:`QueueFull`;
* **deadlines** — ``submit(deadline=D)`` gives the request D scheduler
  steps to retire; a queued request that can no longer make it fails with
  ``status="deadline"`` (an admitted one always retires in time);
* **cancellation** — :meth:`cancel` removes a queued request or evicts an
  in-flight one between blocks (``status="cancelled"``), its ledger
  metering exactly the steps it ran;
* **preemption** — with ``preempt=True`` a page-starved queue head may
  evict the in-flight request with the fewest tokens remaining (only
  slots that progressed since admission: livelock-free) and re-queue it.
  On re-admission it re-prefills its prompt, replays its generated tokens
  through the per-token serve step and resumes at the same position, so
  its tokens equal the unpreempted run's (on the card the replay is the
  B = 1 serve step captured as a CUDA graph on the persistent width-1
  prefill buffer, fed from a static token buffer and replayed once a
  token, sharing the block graph's memory pool). The overhead is metered: the
  evicted tenancy's generation at eviction, the whole re-prefill (prompt
  and replayed tokens) at re-admission;
* **poison isolation** — a request whose logits go non-finite fails with
  ``status="poisoned"`` at its next fetch (retirement or eviction), never
  the engine, and its pages are zeroed before reuse: NaN, unlike stale
  bytes, survives the causal mask (``0·NaN = NaN``);
* **durability** — :meth:`snapshot` captures the whole serve plane (queue,
  slot tables, the allocator's free-list order, the device state, the
  ledgers, the seeds) as a :class:`SchedulerState` that saves through
  ``fed.save(serve_state=...)``; ``fed.serve(params, state=...)``
  continues it with equal tokens and byte-identical ledgers.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import graphs
from repro_torch.analysis import tags
from repro_torch.checkpoint.io import (_flatten_with_path, load_tree,
                                       save_checkpoint)
from repro_torch.core.adapters import ModelAdapter
from repro_torch.core.privacy import Ledger, Message
from repro_torch.federation import paging, serving
from repro_torch.kernels import _build
from repro_torch.models.common import torch_dtype
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class QueueFull(RuntimeError):
    """Typed backpressure: the admission queue is at ``max_queue`` — shed
    load upstream instead of queueing unboundedly."""


@dataclasses.dataclass
class ServeRequest:
    """A queued generation request (one sequence; batch=1 on the wire)."""
    rid: int
    prompt: np.ndarray              # (prompt_len,) int32
    gen_len: int
    seed: Optional[int] = None      # the PositionGumbel seed; None when
                                    # the request carries its own source
    draws: Optional[Any] = None     # rows(t0, n, vocab, device) noise
    ledger: Ledger = dataclasses.field(default_factory=Ledger)
    deadline: Optional[int] = None  # absolute scheduler step to retire by
    # tokens generated before a preemption (replayed at re-admission)
    generated: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    preemptions: int = 0
    first_admitted: int = -1        # -1 = never admitted


@dataclasses.dataclass
class RequestResult:
    """One drained request: its tokens and its exact wire ledger.

    ``status`` is ``"ok"`` for a full retirement; ``"cancelled"`` /
    ``"deadline"`` / ``"poisoned"`` results carry the tokens generated up
    to the failure and a ledger metering exactly the steps that ran.
    ``logits`` (a port addition) is the slot's last-step logits, (1,
    vocab) f32, from the fetch that ended its tenancy (None for a request
    that failed in the queue, and for results restored from a
    snapshot)."""
    rid: int
    tokens: np.ndarray              # (gen_len,) sampled token ids
    ledger: Ledger
    prompt_len: int
    admitted_at: int                # scheduler step index at admission
    finished_at: int                # scheduler step index at retirement
    status: str = "ok"
    preemptions: int = 0
    logits: Optional[np.ndarray] = None

    @property
    def wire_bytes(self) -> int:
        return self.ledger.total_bytes

    @property
    def transmits_gradients(self) -> bool:
        return self.ledger.transmits_gradients


# -------------------------------------------------- ledger (de)serialize --
# a snapshot needs each request's ledger byte-identical across a save and
# restore, message ORDER included (Ledger.to_counts aggregates), so the
# serve plane keeps its own exact row codec

def _ledger_rows(led: Ledger) -> List[list]:
    return [[m.sender, m.kind, list(m.shape), m.dtype, m.wired]
            for m in led.messages]


def _ledger_from_rows(rows: List[list]) -> Ledger:
    led = Ledger()
    led.messages.extend(
        Message(sender, kind, tuple(shape), dtype,
                wired=None if wired is None else int(wired))
        for sender, kind, shape, dtype, wired in rows)
    return led


def _leafkey(group: str, parts) -> str:
    """The JAX package's snapshot key of a leaf: ``x['group']`` and the
    leaf's ``keystr`` (``['name']`` for a dict key, ``[i]`` for a sequence
    index)."""
    return f"x['{group}']" + "".join(
        p if p.startswith("[") else f"['{p}']" for p in parts)


@dataclasses.dataclass
class SchedulerState:
    """A complete serve-plane snapshot: every device tensor (page pool,
    slot state, generation buffer, logits; on the host) and the host
    bookkeeping (queue, slot tables, allocator free-list ORDER, ledgers,
    seeds, results, counters, config). ``fed.save(serve_state=)`` persists
    it; ``fed.serve(params, state=...)`` resumes it."""
    flat: Dict[str, torch.Tensor]   # tensor leaves, keystr-addressed
    meta: dict                      # JSON-able bookkeeping + config

    def save(self, path: str) -> str:
        save_checkpoint(path, self.flat, metadata=self.meta)
        return path

    @classmethod
    def load(cls, path: str) -> "SchedulerState":
        """A snapshot written by either package. A greedy one (temperature
        0) draws nothing, so the JAX package's loads here as it is; a
        sampling one of the JAX package is refused: its requests sample
        from threefry key data."""
        flat, _, meta = load_tree(path)
        if "slot_keydata" in flat and float(meta["config"]["temperature"]):
            raise ValueError(
                f"the serve state at {path} was written by the JAX package "
                "for a sampling scheduler (temperature "
                f"{meta['config']['temperature']}): its requests sample "
                "from threefry key data (slot_keydata), which the port "
                "cannot draw from — the port's requests carry a seed for "
                "serving.PositionGumbel instead; restore it with the JAX "
                "package, or re-submit its requests (a greedy snapshot "
                "draws nothing and crosses)")
        return cls(flat=flat, meta=meta)


# ================================================== the device programs ==

def make_paged_decode_step(adapter: ModelAdapter, n_clients: int,
                           seq_len: int, temperature: float,
                           vocab_size: int, page_size: int):
    """One continuous-batching decode step over all slots.

    ``step(params, tables, noise_st, logits_st, caches_st, t_st,
    gen_pos_st, rem_st, gen_buf_st, sl)`` updates the slot state in place
    (``sl`` is ``arange(n_slots)``). Every slot samples from its carried
    logits on its own noise rows, the owning client embeds the token, and
    the server runs ONE batched paged decode over all slots
    (``server_decode_paged``). The active mask derives on the device from
    ``rem > 0``, so the host never reads the step's state: a slot that
    hits zero freezes (its uplink embedding is zeroed, its recurrent state
    held, its KV row routed to the trash page). Inactive slots still pay
    their row of the backbone's work, as in the JAX package. It reads and
    writes only its arguments, so it can be captured as a CUDA graph on
    them.
    """
    serving._require_serve_plane(adapter)
    if adapter.server_decode_paged is None:
        raise ValueError(
            f"adapter {adapter.name!r} has no server_decode_paged hook; "
            "the paged continuous scheduler needs it")
    span = seq_len // n_clients

    @tags.wire("up", accounted_by="Transport.account_serve",
               kind="embedding",
               reason="continuous-batching decode step: each active slot's "
                      "client embeds its sampled token and the embedding "
                      "crosses to server_decode_paged; the traffic is "
                      "metered deferred — prompt uploads at admission, "
                      "generation at retirement (see the module docstring)")
    def step(params, tables, noise_st, logits_st, caches_st, t_st,
             gen_pos_st, rem_st, gen_buf_st, sl):
        active = rem_st > 0
        act = active.to(t_st.dtype)
        lg = logits_st[:, -1].float()
        if temperature > 0:
            lg = lg / temperature + noise_st[
                sl, gen_pos_st.clamp(max=noise_st.shape[1] - 1)]
        nxt = torch.clamp(torch.argmax(lg, dim=-1),
                          max=vocab_size - 1).to(torch.int32)
        idx = gen_pos_st.clamp(0, seq_len - 1)
        gen_buf_st[sl, idx] = torch.where(active, nxt, gen_buf_st[sl, idx])
        owner = torch.where(active, t_st, 0) // span
        e = serving.slot_embed(params, owner, nxt)
        e = e * active.to(e.dtype)[:, None, None]
        logits, _ = adapter.server_decode_paged(
            params["server"], e, caches_st, tables, t_st, act, page_size)
        logits_st.copy_(logits)
        t_st.add_(act)
        gen_pos_st.add_(act)
        rem_st.sub_(act)

    return step


def make_paged_decode_block(adapter: ModelAdapter, n_clients: int,
                            seq_len: int, temperature: float,
                            vocab_size: int, page_size: int, n_slots: int,
                            n_steps: int):
    """A block of ``n_steps`` eager decode steps
    (:func:`make_paged_decode_step`): ``block(params, tables, noise_st,
    logits_st, caches_st, t_st, gen_pos_st, rem_st, gen_buf_st)``. The
    scheduler's block on the CPU and with ``use_scan=False``; on the card
    it replays the step's CUDA graph instead."""
    step = make_paged_decode_step(adapter, n_clients, seq_len, temperature,
                                  vocab_size, page_size)

    def block(params, tables, noise_st, logits_st, caches_st, t_st,
              gen_pos_st, rem_st, gen_buf_st):
        sl = torch.arange(n_slots, device=t_st.device)
        for _ in range(n_steps):
            step(params, tables, noise_st, logits_st, caches_st, t_st,
                 gen_pos_st, rem_st, gen_buf_st, sl)

    return block


def make_install_prog(adapter: ModelAdapter, seq_len: int):
    """The slot install: move a wave of freshly prefilled requests from
    the dense prefill caches into their pages (pooled leaves) and their
    slot rows (state leaves), and set the wave's logits, positions,
    remaining counters, generation buffers and noise rows — in place.

    ``gen_rows``/``gen_pos0s`` seed the generation buffer: zeros for a
    fresh request, the already-generated prefix (its length the write
    cursor) for a preempted request being resumed. ``noise`` lists
    ``(slot, g0, rows)``: a slot's noise from generation index ``g0`` on
    (empty when greedy)."""
    plans = paging.leaf_plans(adapter.cache_specs(1, seq_len))

    def install(caches_st, logits_st, t_st, gen_pos_st, rem_st, noise_st,
                gen_buf_st, dense_caches, logits, rows, slots, t0s, rem0s,
                noise, gen_rows, gen_pos0s):
        for st, dense, plan in zip(tree_leaves(caches_st),
                                   tree_leaves(dense_caches),
                                   tree_leaves(plans)):
            if plan.pooled:
                # pooled leaves are (layers, B, S, *tail) densely: scatter
                # each wave row's first rows.shape[1] positions to its pages
                b = plan.batch_axis
                flat = st.view(st.shape[:b] + (st.shape[b] * st.shape[b + 1],)
                               + st.shape[b + 2:])
                lead = (slice(None),) * b
                flat[lead + (rows,)] = dense[lead + (slice(None),
                                                     slice(0, rows.shape[1]))
                                             ].to(st.dtype)
            else:
                st[(slice(None),) * plan.batch_axis + (slots,)] = \
                    dense.to(st.dtype)
        logits_st[slots] = logits.to(logits_st.dtype)
        t_st[slots] = t0s
        gen_pos_st[slots] = gen_pos0s
        rem_st[slots] = rem0s
        gen_buf_st[slots] = gen_rows
        for slot, g0, table in noise:
            noise_st[slot, g0:g0 + table.shape[0]] = table

    return install


# ============================================================ scheduler ==

class ServeScheduler:
    """Continuous-batching engine over the split serve plane.

    ``submit()`` queues requests; ``run()`` drains the queue through the
    fixed slots and returns a :class:`RequestResult` per request (rid
    order). Construct via :meth:`repro_torch.federation.Federation.serve`.

    ``page_size`` must divide ``seq_len`` (default: the largest divisor
    <= 8); ``n_pages`` sizes the shared pool (default: the worst case,
    ``max_batch`` full-length sequences + the two reserved pages). A
    smaller pool gates admission on free pages, so peak cache memory
    tracks the lengths in flight. With ``preempt=True`` a page-starved
    queue head may evict the in-flight request with the fewest tokens
    remaining (see the module docstring). ``max_queue`` bounds the
    admission queue (``submit`` raises :class:`QueueFull` past it).
    ``use_scan`` runs the decode blocks and the resume replay as CUDA
    graphs on the card (``use_scan=False``: eager steps, the same
    results).
    """

    def __init__(self, adapter: ModelAdapter, transport, *, params,
                 n_clients: int, seq_len: int, embed_dim: int,
                 vocab_size: int, device: torch.device, max_batch: int = 4,
                 temperature: float = 0.0,
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 preempt: bool = False, use_scan: bool = True):
        serving._require_serve_plane(adapter)
        if adapter.server_decode_paged is None or \
                adapter.server_prefill is None:
            raise ValueError(
                f"adapter {adapter.name!r} has no server_decode_paged or "
                "server_prefill hook; build the session from a ModelConfig "
                "to serve")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.adapter = adapter
        self.transport = transport
        self.params = params
        self.device = torch.device(device)
        self.n_clients = n_clients
        self.seq_len = seq_len
        self.span = seq_len // n_clients
        self.embed_dim = embed_dim
        self.vocab_size = vocab_size
        self.max_batch = max_batch
        self.temperature = float(temperature)
        self.max_queue = max_queue
        self.preempt = bool(preempt)
        self.use_scan = bool(use_scan)
        self._graphs = self.use_scan and self.device.type == "cuda"

        self.page_size = (paging.default_page_size(seq_len)
                          if page_size is None else int(page_size))
        if self.page_size < 1 or seq_len % self.page_size:
            raise ValueError(
                f"page_size={self.page_size} must divide seq_len={seq_len}")
        self.pages_per_seq = seq_len // self.page_size
        self.n_pages = (max_batch * self.pages_per_seq + paging.N_RESERVED
                        if n_pages is None else int(n_pages))
        self.allocator = paging.PageAllocator(self.n_pages)

        self._queue: List[ServeRequest] = []
        self._next_rid = 0
        self._slot_req: List[Optional[ServeRequest]] = [None] * max_batch
        self._slot_pages: List[Optional[np.ndarray]] = [None] * max_batch
        self._remaining = np.zeros(max_batch, np.int64)   # host mirror
        self._admitted_at = np.zeros(max_batch, np.int64)
        self._tables = np.full((max_batch, self.pages_per_seq),
                               paging.ZERO_PAGE, np.int32)
        # its device mirror: one tensor (the block graph reads it where it
        # was captured) that a changed host table is copied into
        self._tables_dev = torch.from_numpy(self._tables.copy()).to(
            self.device)
        self._tables_dirty = False
        self._results: Dict[int, RequestResult] = {}

        # device-side slot state. Sequence cache leaves live in the shared
        # page pool; recurrent state leaves are slot-stacked. The logits
        # are sized at the first prefill, which gives their dtype and
        # padded vocabulary; when sampling, the noise table grows at
        # admission to the longest generation admitted.
        dense_specs = adapter.cache_specs(1, seq_len)
        self._plans = paging.leaf_plans(dense_specs)
        specs = paging.paged_specs(
            dense_specs, n_slots=max_batch, n_pages=self.n_pages,
            page_size=self.page_size)
        dev = self.device
        self._caches_st = tree_map(
            lambda s: torch.zeros(s.shape, dtype=torch_dtype(s.dtype),
                                  device=dev), specs)
        self._logits_st: Optional[torch.Tensor] = None  # (slots, 1, vocab)
        self._noise_st: Optional[torch.Tensor] = None   # (slots, G, vocab)
        self._t_st = torch.zeros(max_batch, dtype=torch.int64, device=dev)
        self._gen_pos_st = torch.zeros(max_batch, dtype=torch.int64,
                                       device=dev)
        self._rem_st = torch.zeros(max_batch, dtype=torch.int64, device=dev)
        self._gen_buf_st = torch.zeros((max_batch, seq_len),
                                       dtype=torch.int32, device=dev)

        # persistent dense (1, seq_len) prefill buffer — only its small
        # recurrent-state leaves are re-zeroed per admission
        self._prefill_caches = None
        self._blocks: Dict[int, Any] = {}     # block functions by length
        self._install = make_install_prog(adapter, seq_len)
        # the CUDA graphs (use_scan on the card): the block's step on the
        # slot tensors, the replay's B = 1 step on the prefill buffer, in
        # one memory pool; the replay's static buffers
        self._graph_pool = None
        self._step_graph: Optional[graphs.StepGraph] = None
        self._replay_graph: Optional[graphs.StepGraph] = None
        self._replay_st: Optional[Dict[str, torch.Tensor]] = None

        # perf + failure counters
        self.steps = 0
        self.compile_s = 0.0        # first-use kernel build and the
                                    # graphs' captures on the card
        self.graph_captures = 0     # CUDA graphs captured
        self.generated_tokens = 0
        self.last_run_s = 0.0
        self.host_transfers = 0     # device->host fetches (one per wave)
        self.preemptions = 0
        self.deadline_misses = 0
        self.poisoned = 0
        # forward passes outside the decode blocks (a launch count's
        # derivation reads them): chunk calls through server_prefill, and
        # per-token serve steps replaying a resumed request's tokens
        self.prefill_chunks = 0
        self.replay_steps = 0

    # ------------------------------------------------------- queueing ----
    def submit(self, prompt, gen_len: int, *, seed: Optional[int] = None,
               draws=None, deadline: Optional[int] = None) -> int:
        """Queue one request; returns its rid. ``seed`` names the
        request's sampling stream (``serving.PositionGumbel(seed)``: the
        same source given to a solo ``fed.decode`` yields the same
        tokens); ``draws`` hands it any source with ``rows(t0, n, vocab,
        device)`` instead. Without either, each request draws from its
        rid as its seed, so concurrent sampled requests are never
        correlated. ``deadline`` gives the request that many SCHEDULER
        STEPS (from now) to retire; raises :class:`QueueFull` when the
        admission queue is at ``max_queue``."""
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            raise QueueFull(
                f"admission queue full ({len(self._queue)}/"
                f"{self.max_queue}); retry after a drain")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1 or gen_len < 1:
            raise ValueError(
                f"need a non-empty prompt and gen_len >= 1, got "
                f"prompt_len={prompt.size}, gen_len={gen_len}")
        if prompt.size + gen_len > self.seq_len:
            raise ValueError(
                f"prompt_len + gen_len = {prompt.size + gen_len} exceeds "
                f"the session seq_len {self.seq_len}")
        need = paging.pages_needed(prompt.size + gen_len, self.page_size)
        if need > self.allocator.capacity:
            raise ValueError(
                f"request needs {need} pages but the pool holds "
                f"{self.allocator.capacity} (n_pages={self.n_pages}, "
                f"page_size={self.page_size})")
        if deadline is not None and deadline < 1:
            raise ValueError(f"deadline must be >= 1 steps, got {deadline}")
        if draws is not None and seed is not None:
            raise ValueError("pass seed= or draws=, not both")
        rid = self._next_rid
        if draws is None:
            seed = rid if seed is None else int(seed)
            draws = serving.PositionGumbel(seed)
        self._next_rid += 1
        self._queue.append(ServeRequest(
            rid=rid, prompt=prompt, gen_len=gen_len, seed=seed, draws=draws,
            deadline=None if deadline is None else self.steps + deadline))
        return rid

    def cancel(self, rid: int) -> Optional[RequestResult]:
        """Explicitly cancel a request. Queued: removed outright.
        In-flight: evicted between blocks — its tokens so far come back
        and its ledger meters exactly the steps it ran. Returns the
        terminal ``status="cancelled"`` result, or None if ``rid`` is
        unknown or already finished."""
        if rid in self._results:
            return None
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                self._queue.pop(i)
                return self._fail_request(req, "cancelled")
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.rid == rid:
                return self._evict_slot(slot, "cancelled")
        return None

    # ------------------------------------------------------ admission ----
    def _prefill_wave(self, reqs: List[ServeRequest]):
        """Chunk-prefill a wave of equal-length prompts as ONE batch.

        A width-1 wave reuses the persistent dense buffer (recurrent state
        leaves re-zeroed; stale KV rows from the previous tenant sit beyond
        the causal mask of every prefill query and contribute exactly
        0.0). Wider waves prefill through one (w, prompt_len) batch into
        fresh zero caches: w prompts pay ONE chain of chunk calls."""
        w = len(reqs)
        prompt_len = reqs[0].prompt.size
        if w == 1:
            if self._prefill_caches is None:
                self._prefill_caches = serving.zero_caches(
                    self.adapter, 1, self.seq_len, self.device)
            else:
                for leaf, plan in zip(tree_leaves(self._prefill_caches),
                                      tree_leaves(self._plans)):
                    if not plan.pooled:
                        leaf.zero_()
            caches = self._prefill_caches
        else:
            caches = serving.zero_caches(self.adapter, w, self.seq_len,
                                         self.device)
        toks = torch.from_numpy(np.stack([r.prompt for r in reqs])).to(
            self.device)
        for t0, t1, m in serving.prefill_plan(prompt_len, self.span):
            logits, caches = serving.prefill_chunk(
                self.adapter, self.params, toks[:, t0:t1], caches, t0, m)
            self.prefill_chunks += 1
        return logits, caches

    @tags.host_boundary("preemption-resume replay: feeds the victim's "
                        "already-fetched host tokens back one position at a "
                        "time — one host->device upload on a cold path, "
                        "never the steady-state decode loop")
    def _replay_generated(self, req: ServeRequest, logits, caches):
        """Re-derive a preempted request's device state: feed its
        already-generated tokens through the per-token serve step, one
        position at a time — the computation the solo decode loop runs,
        so the carried logits and cache rows come back as they were and
        the resumed stream continues where the evicted one stopped."""
        step = serving.make_serve_step(self.adapter, self.n_clients,
                                       self.seq_len)
        pl = req.prompt.size
        gen = torch.from_numpy(np.asarray(req.generated, np.int32)).to(
            self.device)
        if not self.use_scan:
            for i in range(gen.shape[0]):
                logits, caches = step(self.params, gen[i:i + 1][None],
                                      caches, pl + i)
                self.replay_steps += 1
            return logits, caches
        # the same step at a device position, fed from a static token
        # buffer: captured once on the persistent width-1 prefill buffer
        # (a replay wave is one request) and replayed once a token
        if caches is not self._prefill_caches:
            raise RuntimeError("a replay runs on the width-1 prefill buffer")
        st = self._replay_st
        if st is None:
            st = self._replay_st = {
                "toks": torch.zeros((1, self.seq_len), dtype=torch.int32,
                                    device=self.device),
                "pos": torch.zeros(1, dtype=torch.int64, device=self.device),
                "logits": torch.zeros_like(logits)}
        st["toks"][0, pl:pl + gen.shape[0]] = gen
        st["pos"].fill_(pl)

        def body():
            lg, _ = step(self.params, st["toks"].index_select(1, st["pos"]),
                         caches, st["pos"])
            st["logits"].copy_(lg)
            st["pos"].add_(1)
        n = gen.shape[0]
        with torch.no_grad():
            if not self._graphs:
                for _ in range(n):
                    body()
            elif self._replay_graph is None:
                self._replay_graph = self._capture(body)
                self._replay_graph.replay(n - 1)
            else:
                self._replay_graph.replay(n)
        self.replay_steps += n
        return st["logits"], caches

    def _capture(self, body) -> graphs.StepGraph:
        """Capture ``body`` (its warm-up is a real step) in the scheduler's
        graph pool; the capture's seconds go to ``compile_s``."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = graphs.StepGraph(body, self.device, self._graph_pool)
        self.graph_captures += 1
        self.compile_s += graph.capture_s
        return graph

    def _admit_wave(self, slots: List[int], reqs: List[ServeRequest]):
        """Prefill a wave of requests, allocate their pages, and install
        all their slot state in one call. Prefill wire traffic is logged
        here per request: one embedding upload per prefilled position
        (the prompt for a fresh request; prompt + replayed tokens for a
        resumed one), no downlink."""
        w = len(reqs)
        prompt_len = reqs[0].prompt.size
        gens = [int(r.generated.size) for r in reqs]
        if any(g != gens[0] for g in gens):
            raise RuntimeError("a wave mixes replay lengths")
        eff_len = prompt_len + gens[0]
        pages = [self.allocator.alloc(paging.pages_needed(
            r.prompt.size + r.gen_len, self.page_size)) for r in reqs]

        logits, caches = self._prefill_wave(reqs)
        if gens[0]:
            logits, caches = self._replay_generated(reqs[0], logits, caches)
        if self._logits_st is None:
            self._logits_st = torch.zeros(
                (self.max_batch, 1, logits.shape[-1]), dtype=logits.dtype,
                device=self.device)

        dev = self.device
        rows = torch.from_numpy(np.stack([
            paging.install_rows(p, eff_len, self.page_size)
            for p in pages]).astype(np.int64)).to(dev)
        noise = []
        if self.temperature > 0:
            self._size_noise(max(r.gen_len for r in reqs))
            vocab = self._noise_st.shape[-1]
            noise = [(slot, g,
                      r.draws.rows(eff_len, r.gen_len - g, vocab, dev))
                     for slot, r, g in zip(slots, reqs, gens)]
        gen_rows = np.zeros((w, self.seq_len), np.int32)
        for i, r in enumerate(reqs):
            gen_rows[i, :r.generated.size] = r.generated

        def put(a, dtype):
            return torch.from_numpy(np.asarray(a, dtype)).to(dev)
        self._install(
            self._caches_st, self._logits_st, self._t_st, self._gen_pos_st,
            self._rem_st, self._noise_st, self._gen_buf_st, caches, logits,
            rows, put(slots, np.int64), put([eff_len] * w, np.int64),
            put([r.gen_len - g for r, g in zip(reqs, gens)], np.int64),
            noise, put(gen_rows, np.int32), put(gens, np.int64))

        for slot, req, page_ids in zip(slots, reqs, pages):
            self._tables[slot, :] = paging.ZERO_PAGE
            self._tables[slot, :len(page_ids)] = page_ids
            self._tables_dirty = True
            self._slot_pages[slot] = page_ids
            self._slot_req[slot] = req
            self._remaining[slot] = req.gen_len - req.generated.size
            self._admitted_at[slot] = self.steps
            if req.first_admitted < 0:
                req.first_admitted = self.steps
            self.transport.account_serve(
                batch=1, embed=self.embed_dim,
                n_steps=req.prompt.size + req.generated.size, n_gen=0,
                ledger=req.ledger)

    def _size_noise(self, gen_len: int) -> None:
        """Give the noise table at least ``gen_len`` rows a slot. It grows
        to the longest generation admitted so far (between blocks, at
        admission or restore), keeping the rows of the slots in flight."""
        have = 0 if self._noise_st is None else self._noise_st.shape[1]
        if gen_len <= have:
            return
        grown = torch.zeros(
            (self.max_batch, gen_len, self._logits_st.shape[-1]),
            dtype=torch.float32, device=self.device)
        if have:
            grown[:, :have] = self._noise_st
        self._noise_st = grown
        self._step_graph = None     # it was captured on the old table

    def _expire_queue(self):
        """Fail queued requests that can no longer meet their deadline (an
        admitted request retires in exactly ``remaining`` scheduler steps,
        so feasibility is checkable before admission)."""
        i = 0
        while i < len(self._queue):
            req = self._queue[i]
            needed = req.gen_len - req.generated.size
            if (req.deadline is not None
                    and self.steps + needed > req.deadline):
                self._queue.pop(i)
                self.deadline_misses += 1
                self._fail_request(req, "deadline")
            else:
                i += 1

    def _pick_victim(self) -> Optional[int]:
        """Preemption victim: the occupied slot with the FEWEST tokens
        remaining, among slots that produced at least one token since
        (re-)admission — requiring progress makes preemption ping-pong
        terminate."""
        best, best_rem = None, None
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            ran = (req.gen_len - req.generated.size) - self._remaining[slot]
            if ran <= 0:
                continue
            if best_rem is None or self._remaining[slot] < best_rem:
                best, best_rem = slot, self._remaining[slot]
        return best

    def _admit_free_slots(self):
        """FIFO wave admission: take the queue's head run of equal-length
        prompts that fits the free slots AND the page pool, prefill it as
        one batch and install it in one call. The queue is never
        reordered. With ``preempt=True`` a page-starved head may evict a
        victim (see :meth:`_pick_victim`) instead of waiting."""
        while self._queue:
            self._expire_queue()
            if not self._queue:
                return
            free = [s for s in range(self.max_batch)
                    if self._slot_req[s] is None]
            if not free:
                return
            avail = self.allocator.available
            pl = self._queue[0].prompt.size
            g0 = int(self._queue[0].generated.size)
            wave = []
            for req in self._queue:
                need = paging.pages_needed(req.prompt.size + req.gen_len,
                                           self.page_size)
                if (len(wave) == len(free) or req.prompt.size != pl
                        or need > avail
                        or int(req.generated.size) != g0
                        or (g0 and wave)):
                    break
                wave.append(req)
                avail -= need
            if not wave:
                # page-gated: preempt a victim to unblock the head, or wait
                # for a retirement wave to free pages
                if self.preempt:
                    victim = self._pick_victim()
                    if victim is not None:
                        self._preempt_slot(victim)
                        continue
                return
            del self._queue[:len(wave)]
            self._admit_wave(free[:len(wave)], wave)

    # ----------------------------------------------------- the engine ----
    def _block_len(self, budget: Optional[int] = None) -> int:
        occ = [s for s, r in enumerate(self._slot_req) if r is not None]
        m = int(min(self._remaining[s] for s in occ))
        if budget is not None:
            m = min(m, max(int(budget), 1))
        return 1 << (max(m, 1).bit_length() - 1)    # pow2 floor <= min rem

    def _device_tables(self):
        """Device mirror of the block tables, copied from the host table
        once per change (admission / retirement) instead of once per
        block. On the card the copy goes from pinned memory without
        blocking the host (the caching host allocator keeps the staging
        buffer until the copy has run), so the block loop never syncs."""
        if self._tables_dirty:
            host = torch.from_numpy(self._tables)
            if self._tables_dev.is_cuda:
                host = host.pin_memory()
            self._tables_dev.copy_(host, non_blocking=True)
            self._tables_dirty = False
        return self._tables_dev

    @tags.hot_loop
    def _block_step(self, budget: Optional[int] = None):
        """Run one K-step decode block over all slots: K batched steps
        and no host sync."""
        n_occ = self.active
        if n_occ == 0:
            return
        k = self._block_len(budget)
        tables = self._device_tables()
        if self._graphs:
            self._graph_block(tables, k)
        else:
            block = self._blocks.get(k)
            if block is None:
                block = make_paged_decode_block(
                    self.adapter, self.n_clients, self.seq_len,
                    self.temperature, self.vocab_size, self.page_size,
                    self.max_batch, k)
                self._blocks[k] = block
            block(self.params, tables, self._noise_st, self._logits_st,
                  self._caches_st, self._t_st, self._gen_pos_st,
                  self._rem_st, self._gen_buf_st)
        self.steps += k
        self.generated_tokens += k * n_occ
        for slot, req in enumerate(self._slot_req):
            if req is not None:
                self._remaining[slot] -= k

    def _graph_block(self, tables, k: int) -> None:
        """K steps through the step's CUDA graph, captured on first use
        (its warm-up is the block's first step) and kept while the slot
        tensors and the noise table stay the same tensors."""
        if self._step_graph is None:
            step = make_paged_decode_step(
                self.adapter, self.n_clients, self.seq_len, self.temperature,
                self.vocab_size, self.page_size)
            args = (self.params, tables, self._noise_st, self._logits_st,
                    self._caches_st, self._t_st, self._gen_pos_st,
                    self._rem_st, self._gen_buf_st,
                    torch.arange(self.max_batch, device=self.device))
            with torch.no_grad():
                self._step_graph = self._capture(lambda: step(*args))
            k -= 1
        self._step_graph.replay(k)

    # ---------------------------------------------------- slot teardown --
    @tags.host_boundary("eviction fetch: one device->host transfer pulls "
                        "the slot's generated-so-far tokens and its "
                        "last-step logits — preempt/cancel/poison paths "
                        "only, never the hot loop")
    def _fetch_slot(self, slot: int):
        """(tokens generated so far, last-step logits (1, vocab) f32) of
        one slot, in one transfer."""
        req = self._slot_req[slot]
        total = (req.gen_len - req.generated.size) - self._remaining[slot]
        total = int(total + req.generated.size)
        packed = torch.cat([
            self._gen_buf_st[slot, :total],
            self._logits_st[slot, -1].float().view(torch.int32)]).cpu()
        self.host_transfers += 1
        packed = packed.numpy()
        return packed[:total].astype(np.int32), \
            packed[total:].view(np.float32)[None].copy()

    def _scrub_pages(self, page_ids) -> None:
        """Zero a poisoned request's pages (and the trash page) in every
        pooled leaf before they can be reallocated. Ordinary stale bytes
        sit behind the causal mask and contribute exactly 0.0; NaN does
        not (0·NaN = NaN), so poison must not outlive its tenancy."""
        pages = torch.from_numpy(np.concatenate(
            [np.asarray(page_ids, np.int64),
             np.asarray([paging.TRASH_PAGE], np.int64)])).to(self.device)
        for leaf, plan in zip(tree_leaves(self._caches_st),
                              tree_leaves(self._plans)):
            if plan.pooled:
                leaf[(slice(None),) * plan.batch_axis + (pages,)] = 0

    def _release_slot(self, slot: int, *, scrub: bool) -> None:
        """Return a slot's pages to the pool and deactivate its device row
        (``rem=0`` — otherwise the freed slot would keep decoding and
        write the ZERO page through its reset table)."""
        if scrub:
            self._scrub_pages(self._slot_pages[slot])
        self.allocator.free_(self._slot_pages[slot])
        self._slot_pages[slot] = None
        self._tables[slot, :] = paging.ZERO_PAGE
        self._tables_dirty = True
        self._slot_req[slot] = None
        self._remaining[slot] = 0
        self._rem_st[slot] = 0

    def _fail_request(self, req: ServeRequest, status: str,
                      logits: Optional[np.ndarray] = None) -> RequestResult:
        res = RequestResult(
            rid=req.rid, tokens=np.asarray(req.generated, np.int32),
            ledger=req.ledger, prompt_len=int(req.prompt.size),
            admitted_at=int(req.first_admitted), finished_at=self.steps,
            status=status, preemptions=req.preemptions, logits=logits)
        self._results[req.rid] = res
        return res

    def _evict_slot(self, slot: int, status: str) -> RequestResult:
        """Terminally evict an in-flight request (cancel / poison): meter
        the generation steps that actually ran, free (and if poisoned,
        scrub) its pages, record the partial result."""
        req = self._slot_req[slot]
        toks, logits = self._fetch_slot(slot)
        finite = bool(np.isfinite(logits).all())
        ran = len(toks) - req.generated.size
        if ran > 0:
            self.transport.account_serve(batch=1, embed=self.embed_dim,
                                         n_steps=ran, n_gen=ran,
                                         ledger=req.ledger)
        if not finite:
            status = "poisoned"
            self.poisoned += 1
        self._release_slot(slot, scrub=not finite)
        req.generated = toks
        return self._fail_request(req, status, logits)

    def _preempt_slot(self, slot: int) -> None:
        """Evict a victim to free pages for the queue's head: fetch its
        tokens so far, meter the evicted tenancy, and re-queue it (tail)
        to re-prefill and replay later. A poisoned victim fails here
        instead of being resumed."""
        req = self._slot_req[slot]
        toks, logits = self._fetch_slot(slot)
        ran = len(toks) - req.generated.size
        if ran > 0:
            self.transport.account_serve(batch=1, embed=self.embed_dim,
                                         n_steps=ran, n_gen=ran,
                                         ledger=req.ledger)
        if not np.isfinite(logits).all():
            self.poisoned += 1
            self._release_slot(slot, scrub=True)
            req.generated = toks
            self._fail_request(req, "poisoned", logits)
            return
        self._release_slot(slot, scrub=False)
        req.generated = toks
        req.preemptions += 1
        self.preemptions += 1
        self._queue.append(req)

    @tags.host_boundary("once-per-wave retirement fetch: one batched "
                        "device->host transfer covers every slot that "
                        "finished in the last block — O(requests) syncs, "
                        "not O(steps)")
    def _retire_wave(self):
        """Retire every slot that finished in the last block: ONE batched
        device-to-host fetch for all of them (tokens and last-step logits,
        the logits' bits carried in the same int32 tensor), generation
        wire accounted in one deferred call per request. A non-finite slot
        fails as ``status="poisoned"`` and its pages are scrubbed."""
        done = [s for s, r in enumerate(self._slot_req)
                if r is not None and self._remaining[s] <= 0]
        if not done:
            return
        idx = torch.tensor(done, dtype=torch.int64, device=self.device)
        packed = torch.cat([
            self._gen_buf_st[idx],
            self._logits_st[idx, -1].float().view(torch.int32)],
            dim=1).cpu().numpy()
        self.host_transfers += 1
        toks_all = packed[:, :self.seq_len]
        lg_all = packed[:, self.seq_len:].view(np.float32)
        for row, slot in enumerate(done):
            req = self._slot_req[slot]
            ran = req.gen_len - req.generated.size
            self.transport.account_serve(batch=1, embed=self.embed_dim,
                                         n_steps=ran, n_gen=ran,
                                         ledger=req.ledger)
            finite = bool(np.isfinite(lg_all[row]).all())
            if not finite:
                self.poisoned += 1
            self._results[req.rid] = RequestResult(
                rid=req.rid, tokens=toks_all[row, :req.gen_len].copy(),
                ledger=req.ledger, prompt_len=req.prompt.size,
                admitted_at=int(self._admitted_at[slot]),
                finished_at=self.steps,
                status="ok" if finite else "poisoned",
                preemptions=req.preemptions,
                logits=lg_all[row][None].copy())
            self._release_slot(slot, scrub=not finite)

    # ----------------------------------------------------------- drive ----
    @property
    def active(self) -> int:
        return sum(r is not None for r in self._slot_req)

    @property
    def pending(self) -> int:
        return len(self._queue)

    def run(self, max_steps: Optional[int] = None) -> List[RequestResult]:
        """Drain the queue: admit into free slots (and free pages) as they
        open up mid-flight, run decode blocks until every submitted
        request is done. Returns the requests that reached a terminal
        state DURING this call, in rid order (earlier drains stay
        retrievable via ``results``); the wall time minus a first-use
        kernel build is ``last_run_s``.

        ``max_steps`` bounds the scheduler steps executed this call
        (blocks are shortened to land exactly on the bound) and returns
        with work still in flight — the partial drain that
        :meth:`snapshot`, :meth:`cancel` and kill/resume tests interleave
        with."""
        before = set(self._results)
        tic = time.perf_counter()
        compile0 = self.compile_s
        if self.device.type == "cuda":
            self.compile_s += _build.ensure_loaded(serving.SERVE_KERNELS)
        start = self.steps
        while self._queue or self.active:
            budget = (None if max_steps is None
                      else max_steps - (self.steps - start))
            if budget is not None and budget <= 0:
                break
            self._admit_free_slots()
            self._block_step(budget)
            self._retire_wave()
        serving._sync(self.device)
        self.last_run_s = (time.perf_counter() - tic
                           - (self.compile_s - compile0))
        return [self._results[rid]
                for rid in sorted(set(self._results) - before)]

    @property
    def results(self) -> Dict[int, RequestResult]:
        """Every request this scheduler has ever drained, by rid."""
        return dict(self._results)

    # ------------------------------------------------------ durability ----
    def _req_meta(self, req: ServeRequest, *, remaining: int,
                  admitted_at: int) -> dict:
        if req.seed is None and self.temperature > 0:
            raise ValueError(
                f"request {req.rid} samples from an injected draw source, "
                "which a snapshot cannot record; submit it with seed= to "
                "snapshot a sampling scheduler")
        greedy = {} if self.temperature > 0 else {"key_data": [0, 0]}
        return {
            **greedy,
            "rid": req.rid, "prompt": np.asarray(req.prompt).tolist(),
            "gen_len": int(req.gen_len), "seed": req.seed,
            "deadline": req.deadline,
            "generated": np.asarray(req.generated).tolist(),
            "preemptions": int(req.preemptions),
            "first_admitted": int(req.first_admitted),
            "ledger": _ledger_rows(req.ledger),
            "remaining": int(remaining),
            "admitted_at": int(admitted_at),
        }

    @staticmethod
    def _req_from_meta(d: dict) -> ServeRequest:
        seed = d.get("seed")        # a JAX package greedy snapshot has none
        return ServeRequest(
            rid=int(d["rid"]),
            prompt=np.asarray(d["prompt"], np.int32),
            gen_len=int(d["gen_len"]), seed=seed,
            draws=None if seed is None else serving.PositionGumbel(seed),
            ledger=_ledger_from_rows(d["ledger"]),
            deadline=d["deadline"],
            generated=np.asarray(d["generated"], np.int32),
            preemptions=int(d["preemptions"]),
            first_admitted=int(d["first_admitted"]))

    @tags.host_boundary("snapshot fetch: pulls the whole serve-plane "
                        "device state (page pool, slot rows, generation "
                        "buffers, logits) to the host for a durable "
                        "checkpoint — a stop-the-world operation, never the "
                        "hot loop")
    def snapshot(self) -> SchedulerState:
        """Capture the complete serve plane between blocks. Restored via
        ``fed.serve(params, state=...)`` the scheduler continues the drain
        with equal token streams and byte-identical per-request ledgers.
        The noise tables are not stored: each in-flight request's rows are
        drawn again from its seed at restore.

        A greedy snapshot (temperature 0) is written in the JAX package's
        layout — int32 slot counters, (slots, 1, 1, vocab) logits and an
        all-zero key table its requests never draw from — so the JAX
        package restores it too."""
        serving._sync(self.device)
        flat: Dict[str, torch.Tensor] = {}
        for parts, leaf in _flatten_with_path(self._caches_st):
            flat[_leafkey("caches", parts)] = leaf.cpu()
        slot_arrays = {
            "t": self._t_st, "gen_pos": self._gen_pos_st,
            "rem": self._rem_st, "gen_buf": self._gen_buf_st,
            "tables": torch.from_numpy(self._tables.copy()),
        }
        if self._logits_st is not None:
            slot_arrays["logits"] = self._logits_st
        if not self.temperature > 0:
            for name in ("t", "gen_pos", "rem"):
                slot_arrays[name] = slot_arrays[name].to(torch.int32)
            slot_arrays["keydata"] = torch.zeros((self.max_batch, 2),
                                                 dtype=torch.uint32)
            if self._logits_st is not None:
                slot_arrays["logits"] = self._logits_st.unsqueeze(1)
        for name, arr in slot_arrays.items():
            flat[f"slot_{name}"] = arr.cpu()
        meta = {
            "config": {
                "max_batch": self.max_batch, "seq_len": self.seq_len,
                "n_clients": self.n_clients, "embed_dim": self.embed_dim,
                "vocab_size": self.vocab_size,
                "temperature": self.temperature,
                "page_size": self.page_size, "n_pages": self.n_pages,
                "max_queue": self.max_queue, "preempt": self.preempt,
                "has_logits": self._logits_st is not None,
            },
            "allocator": self.allocator.snapshot(),
            "slots": [None if req is None else self._req_meta(
                req, remaining=int(self._remaining[s]),
                admitted_at=int(self._admitted_at[s]))
                for s, req in enumerate(self._slot_req)],
            "slot_pages": [None if p is None else
                           np.asarray(p).tolist()
                           for p in self._slot_pages],
            "queue": [self._req_meta(r, remaining=0, admitted_at=-1)
                      for r in self._queue],
            "results": [{
                "rid": r.rid, "tokens": np.asarray(r.tokens).tolist(),
                "ledger": _ledger_rows(r.ledger),
                "prompt_len": int(r.prompt_len),
                "admitted_at": int(r.admitted_at),
                "finished_at": int(r.finished_at), "status": r.status,
                "preemptions": int(r.preemptions),
            } for r in self._results.values()],
            "counters": {
                "steps": self.steps, "next_rid": self._next_rid,
                "generated_tokens": self.generated_tokens,
                "host_transfers": self.host_transfers,
                "preemptions": self.preemptions,
                "deadline_misses": self.deadline_misses,
                "poisoned": self.poisoned,
                "prefill_chunks": self.prefill_chunks,
                "replay_steps": self.replay_steps,
            },
        }
        return SchedulerState(flat=flat, meta=meta)

    @tags.host_boundary("checkpoint restore: rehydrates the host-side "
                        "queue/slot/result metadata and uploads the pooled "
                        "caches once — runs before the first decode block, "
                        "never inside it")
    def _load_state(self, state: SchedulerState) -> None:
        cfg = state.meta["config"]
        for k in ("max_batch", "seq_len", "n_clients", "page_size",
                  "n_pages"):
            if int(cfg[k]) != int(getattr(self, k)):
                raise ValueError(
                    f"serve state was captured with {k}={cfg[k]}, this "
                    f"scheduler has {getattr(self, k)} — construct via "
                    "fed.serve(params, state=...) so the config matches")
        dev = self.device
        flat = state.flat
        leaves = [flat[_leafkey("caches", parts)].to(device=dev,
                                                     dtype=leaf.dtype)
                  for parts, leaf in _flatten_with_path(self._caches_st)]
        self._caches_st = tree_unflatten(self._caches_st, leaves)
        self._t_st = flat["slot_t"].to(dev, torch.int64)
        self._gen_pos_st = flat["slot_gen_pos"].to(dev, torch.int64)
        self._rem_st = flat["slot_rem"].to(dev, torch.int64)
        self._gen_buf_st = flat["slot_gen_buf"].to(dev, torch.int32)
        # copy: the table is mutated in place
        self._tables = np.array(flat["slot_tables"].numpy(), np.int32)
        self._tables_dirty = True
        # the graphs were captured on the slot tensors this replaces
        self._step_graph = self._replay_graph = None
        if cfg["has_logits"]:
            # (slots, 1, vocab); a greedy snapshot stores (slots, 1, 1,
            # vocab), the JAX package's layout
            self._logits_st = flat["slot_logits"].to(dev).reshape(
                self.max_batch, 1, -1)
        self.allocator = paging.PageAllocator.restore(
            state.meta["allocator"])
        self._slot_req = [None if d is None else self._req_from_meta(d)
                          for d in state.meta["slots"]]
        self._slot_pages = [None if p is None else
                            np.asarray(p, np.int32)
                            for p in state.meta["slot_pages"]]
        self._remaining = np.zeros(self.max_batch, np.int64)
        self._admitted_at = np.zeros(self.max_batch, np.int64)
        for s, d in enumerate(state.meta["slots"]):
            if d is not None:
                self._remaining[s] = int(d["remaining"])
                self._admitted_at[s] = int(d["admitted_at"])
        self._noise_st = None
        if self.temperature > 0 and self._logits_st is not None:
            vocab = self._logits_st.shape[-1]
            for s, req in enumerate(self._slot_req):
                if req is not None:
                    self._size_noise(req.gen_len)
                    g0 = req.generated.size
                    self._noise_st[s, g0:req.gen_len] = req.draws.rows(
                        req.prompt.size + g0, req.gen_len - g0, vocab, dev)
        self._queue = [self._req_from_meta(d)
                       for d in state.meta["queue"]]
        self._results = {}
        for d in state.meta["results"]:
            self._results[int(d["rid"])] = RequestResult(
                rid=int(d["rid"]),
                tokens=np.asarray(d["tokens"], np.int32),
                ledger=_ledger_from_rows(d["ledger"]),
                prompt_len=int(d["prompt_len"]),
                admitted_at=int(d["admitted_at"]),
                finished_at=int(d["finished_at"]),
                status=d["status"], preemptions=int(d["preemptions"]))
        c = state.meta["counters"]
        self.steps = int(c["steps"])
        self._next_rid = int(c["next_rid"])
        self.generated_tokens = int(c["generated_tokens"])
        self.host_transfers = int(c["host_transfers"])
        self.preemptions = int(c["preemptions"])
        self.deadline_misses = int(c["deadline_misses"])
        self.poisoned = int(c["poisoned"])
        # the port's own counters (a JAX package snapshot has none)
        self.prefill_chunks = int(c.get("prefill_chunks", 0))
        self.replay_steps = int(c.get("replay_steps", 0))
