"""The serve plane: split inference with the training party split.

Training never merges the parties — and neither does serving. The OWNING
client party (position ``t`` belongs to client ``t // span``, the same
span split the training adapter uses) embeds tokens on its own
parameters and uploads embeddings; the server holds the backbone, head
and every KV cache, and returns only sampled token ids. Logits, caches
and activations never cross the wire, and every step's uplink/downlink
lands in the session's :class:`repro_torch.core.privacy.Ledger` through
the ``Transport``.

Ported from the JAX package's ``federation/serving.py``:

* **decode scan** — the JAX package's one compiled ``lax.scan``
  (:func:`make_decode_scan`) becomes one generated token captured as a
  CUDA graph on static buffers (the carried logits, the caches, a device
  position, the token buffer, the noise table) and replayed once a token,
  with no host work between replays (``repro_torch/graphs.py``); on the
  CPU the same step body runs in a Python loop. ``use_scan=False`` is the
  eager loop of one-token steps at a Python-int position, as in the JAX
  package. Both sample on the device, keep the tokens there and transfer
  them to the host once at the end;
* **chunked prefill** — each owning client embeds its WHOLE span of the
  prompt in one ``client_embed`` call and the server consumes the
  ``(B, chunk, d_model)`` upload through the adapter's ``server_prefill``
  hook; on the card each chunk runs the flash-attention kernel once per
  attention layer and, for the hybrid family, the SSD kernel once per
  Mamba2 layer;
* the caches (KV; the ssm family's wkv and token-shift states; the
  hybrid family's SSM and conv states) are updated in place (the JAX
  package donates them).

The JAX package's ahead-of-time compilation cache has no counterpart:
``compile_s`` reports the first-use build of the card's kernels that fell
inside the call (0.0 when they were built earlier, or on the CPU) plus
the decode graph's capture and instantiation (kept out of ``decode_s``,
as the JAX package keeps compile time out of its decode time), and
``prefill_s``/``decode_s`` are host-clock times that end in a
``torch.cuda.synchronize()``.

Sampling at temperature > 0 is ``argmax(logits / T + g)`` with Gumbel
noise ``g`` — what ``jax.random.categorical`` computes — taken from a
draw source (:class:`TorchGumbel` by default), so tests can hand the port
the JAX package's own noise. Greedy decoding draws nothing.
:class:`PositionGumbel` is one request's noise as a pure function of its
seed and the absolute position, the source the continuous scheduler
draws a request's table from at admission (the JAX package's
``fold_in(key, 100 + t)`` stream plays that part there); ``fed.decode``
takes it too, so a request decodes alike solo and in a batch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Protocol, Tuple

import numpy as np
import torch

from repro_torch import graphs
from repro_torch.analysis import marks, tags
from repro_torch.core.adapters import ModelAdapter
from repro_torch.core.privacy import Ledger
from repro_torch.kernels import _build
from repro_torch.models.common import torch_dtype
from repro_torch.tree import tree_leaves, tree_map

# the kernels the serve plane's models launch on the card
SERVE_KERNELS = ("flash_attention", "rmsnorm", "ssd_chunk")


@dataclasses.dataclass
class ServeResult:
    """One ``Federation.decode`` call: generated tokens + wire totals."""
    tokens: np.ndarray              # (B, gen_len) sampled token ids
    logits: torch.Tensor            # final-step logits (B, 1, vocab) —
                                    # server-side state, exposed for tests
    ledger: Ledger
    prefill_s: float = 0.0          # host clock, ends in a synchronize
    decode_s: float = 0.0           # host clock, ends in the token fetch
    compile_s: float = 0.0          # first-use kernel build and the decode
                                    # graph's capture in this call
    graph: Optional[graphs.StepGraph] = None   # the captured decode step
                                    # (a session's kept one reads the params
                                    # where they are: replay it while the
                                    # tree lives)
    kept: bool = False              # the decode replayed a kept graph
                                    # (or, on the CPU, its kept buffers)

    @property
    def wire_bytes(self) -> int:
        return self.ledger.total_bytes

    @property
    def transmits_gradients(self) -> bool:
        return self.ledger.transmits_gradients


class GumbelSource(Protocol):
    def gumbel(self, t: int, shape: Tuple[int, ...],
               device: torch.device) -> torch.Tensor:
        """Standard Gumbel noise (f32) for the token sampled at position
        ``t``."""


class TorchGumbel:
    """Gumbel noise from a seeded ``torch.Generator`` on the run's
    device: ``-log(-log(u))``, u uniform on [tiny, 1) as JAX draws it."""

    def __init__(self, seed: int, device) -> None:
        self.generator = torch.Generator(device).manual_seed(seed)

    def gumbel(self, t, shape, device):
        u = torch.rand(shape, generator=self.generator, device=device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))


def _position_seed(seed: int, t: int) -> int:
    """A 32-bit key for (seed, position t): the splitmix64 finaliser of
    ``seed * 2**32 + 100 + t``, cut to 32 bits."""
    z = (seed * 2 ** 32 + 100 + t) & 0xFFFFFFFFFFFFFFFF
    z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant, with no int64 overflow: x's high half meets only c's low 16
    bits."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * (c & 0xFFFF)) & 0xFFFF) << 16)) & 0xFFFFFFFF


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on int64 tensors of 32-bit values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


class PositionGumbel:
    """One request's Gumbel noise as a pure function of (``seed``,
    position ``t``): entry v of position t's row is a counter-based hash
    of (``_position_seed(seed, t)``, v), the same integers on any device.
    So a request's tokens do not depend on what shares its batch, on when
    it was admitted or on a preemption. :meth:`rows` draws a whole table
    in one pass of elementwise device work (the scheduler's admission);
    :meth:`gumbel` is the :class:`GumbelSource` of a B = 1
    ``fed.decode``."""

    def __init__(self, seed: int) -> None:
        if not 0 <= int(seed) < 2 ** 31:
            raise ValueError(f"seed must lie in [0, 2**31), got {seed}")
        self.seed = int(seed)

    def rows(self, t0: int, n: int, vocab: int,
             device: torch.device) -> torch.Tensor:
        """(n, vocab) f32 noise for positions ``t0 .. t0 + n - 1``."""
        keys = torch.tensor([_position_seed(self.seed, t0 + i)
                             for i in range(n)], dtype=torch.int64,
                            device=device)
        cols = _fmix32(_mul32(torch.arange(vocab, dtype=torch.int64,
                                           device=device), 0x9E3779B9))
        h = _fmix32(keys[:, None] ^ cols[None, :])
        # 23 bits as an odd multiple of 2**-24: u in (0, 1), exact in f32
        u = ((h >> 9) * 2 + 1).to(torch.float32) * 2.0 ** -24
        return -torch.log(-torch.log(u))

    def gumbel(self, t, shape, device):
        if len(shape) != 2 or shape[0] != 1:
            raise ValueError(f"PositionGumbel is one request's noise: shape "
                             f"(1, vocab), got {tuple(shape)}")
        return self.rows(int(t), 1, shape[1], device)


def _require_serve_plane(adapter: ModelAdapter):
    if adapter.client_embed is None or adapter.server_decode is None:
        raise ValueError(
            f"adapter {adapter.name!r} has no serve plane (client_embed/"
            "server_decode hooks); build the session from a ModelConfig "
            "to serve split inference")


def _client(params, m: int):
    return tree_map(lambda a: a[m], params["clients"])


def slot_embed(params, owner, tok):
    """(n, 1, d) uplink embeddings: row i's owning client ``owner[i]``
    looks up ``tok[i]`` in its own table, the owner picked on the device.
    One gather from the stacked (M, vocab, d) tables — no copy of a
    client's table (one is 32064 x 3072 bf16 at Phi-3 width), as ``a[m]``
    with a tensor ``m`` would make. It gives the rows ``client_embed``
    gives (the one-hot form of ``iota_embed`` picks the same rows)."""
    table = params["clients"]["embed"]["table"]
    return table[owner, tok.long()][:, None]


# ===================================================== one-token step ======

def make_serve_step(adapter: ModelAdapter, n_clients: int, seq_len: int):
    """One-token split-inference step.

    ``step(params, tok, caches, t)``: the client owning position ``t``
    embeds ``tok`` (the other parties' tables are never read), the server
    decodes against its caches (updated in place). ``t`` is a Python int
    (the eager loop) or a 0-d or (1,) int64 device tensor (the captured
    step: the owner is picked and the cache row written on the device);
    both compute the same."""
    _require_serve_plane(adapter)
    span = seq_len // n_clients

    @tags.wire("up", accounted_by="Transport.account_serve", kind="embedding",
               reason="split-inference uplink: the owning client's one-token "
                      "embedding; logits and caches stay server-side")
    def step(params, tok, caches, t):
        if isinstance(t, torch.Tensor):
            owner = (t.reshape(1) // span).expand(tok.shape[0])
            e = slot_embed(params, owner, tok[:, 0])
        else:
            e = adapter.client_embed(_client(params, t // span), tok)
        e = marks.wire_boundary(e, kind="emb", direction="up")
        return adapter.server_decode(params["server"], e, caches, t)

    return step


def make_decode_scan(adapter: ModelAdapter, n_clients: int, seq_len: int,
                     prompt_len: int, gen_len: int, temperature: float,
                     vocab_size: int):
    """The whole generation as one device program: the counterpart of the
    JAX package's compiled ``lax.scan``.

    ``scan(params, st)`` generates ``gen_len`` tokens on the static
    buffers ``st`` (:func:`decode_buffers`): ``logits`` (B, 1, vocab) the
    carried logits, ``caches``, ``pos`` (1,) int64 the device position,
    ``out`` (B, gen_len) int32 the tokens, ``noise`` (gen_len, B, vocab)
    f32 or None. Per token the body samples from the carried logits (the
    eager loop's sampler, its noise read at the device position), writes
    the token, has the owning client embed it (:func:`slot_embed`), steps
    the server and advances the position. On a CUDA device the first
    token runs eagerly, the body is captured as a CUDA graph and replayed
    for the rest (the :class:`repro_torch.graphs.StepGraph` is returned;
    a failed capture raises); on the CPU the body runs in a Python loop
    (None is returned). Either way the result equals the eager loop's:
    the same kernels in the same order, the same draws. A later call of
    the same ``scan`` (a kept scan, seeded again through
    :func:`decode_buffers` ``into=``, on the same params tree) replays the
    graph for all ``gen_len`` tokens and captures nothing, as a second
    call of a compiled function does."""
    step = make_serve_step(adapter, n_clients, seq_len)
    captured: list = []          # the graph, once captured

    @tags.wire("up", accounted_by="Transport.account_serve", kind="embedding",
               reason="scan-form decode: per step one-token uplink; the "
                      "token ids stay on the device until the one fetch "
                      "after the scan")
    def body(params, st):
        i = st["pos"] - prompt_len
        lg = st["logits"][:, -1].float()
        if temperature > 0:
            lg = lg / temperature + st["noise"].index_select(0, i)[0]
        nxt = torch.clamp(torch.argmax(lg, dim=-1),
                          max=vocab_size - 1).to(torch.int32)
        nxt = marks.wire_boundary(nxt, kind="token", direction="down")
        st["out"].index_copy_(1, i, nxt[:, None])
        logits, _ = step(params, nxt[:, None], st["caches"], st["pos"])
        st["logits"].copy_(logits)
        st["pos"].add_(1)

    def scan(params, st) -> Optional[graphs.StepGraph]:
        if gen_len < 1:
            return None
        with torch.no_grad():
            # the certifier traces the body's loop (a capture records
            # no graph nodes)
            if st["pos"].device.type != "cuda" or marks.tracing():
                for _ in range(gen_len):
                    body(params, st)
                return None
            if captured:
                captured[0].replay(gen_len)
            else:
                captured.append(graphs.StepGraph(lambda: body(params, st),
                                                 st["pos"].device))
                captured[0].replay(gen_len - 1)
        return captured[0]

    return scan


def decode_buffers(logits, caches, prompt_len: int, gen_len: int,
                   noise: Optional[torch.Tensor] = None,
                   into: Optional[dict] = None) -> dict:
    """:func:`make_decode_scan`'s static buffers, seeded from the
    prefill's last logits (copied) and the caches (taken as they are).
    ``into``: buffers of a kept scan, seeded in place instead (a cache
    the prefill made anew copied into the kept one) and returned."""
    if into is not None:
        tree_map(lambda old, new: None if new is old else old.copy_(new),
                 into["caches"], caches)
        into["logits"].copy_(logits)
        into["pos"].fill_(prompt_len)
        if noise is not None:
            into["noise"].copy_(noise)
        return into
    B, device = logits.shape[0], logits.device
    return {"logits": logits.clone(), "caches": caches,
            "pos": torch.full((1,), prompt_len, dtype=torch.int64,
                              device=device),
            "out": torch.zeros((B, gen_len), dtype=torch.int32,
                               device=device),
            "noise": noise}


def noise_table(draws: "GumbelSource", prompt_len: int, gen_len: int,
                batch: int, vocab: int, device) -> torch.Tensor:
    """The whole generation's Gumbel noise, (gen_len, B, vocab) f32, as
    the eager loop draws it: a source with ``rows`` (one request's noise,
    :class:`PositionGumbel`) fills it in one call; any other source is
    called once a position, in position order, so a seeded generator's
    stream advances as it does in the loop."""
    if hasattr(draws, "rows"):
        if batch != 1:
            raise ValueError(f"{type(draws).__name__} is one request's "
                             f"noise: batch 1, got {batch}")
        return draws.rows(prompt_len, gen_len, vocab, device)[:, None]
    return torch.stack([draws.gumbel(t, (batch, vocab), device)
                        for t in range(prompt_len, prompt_len + gen_len)])


@tags.wire("up", accounted_by="Transport.account_serve", kind="embedding",
           reason="chunked-prefill uplink: one whole span embedding per "
                  "chunk; prefill carries no downlink")
def prefill_chunk(adapter: ModelAdapter, params, toks, caches, t0: int,
                  m: int):
    """Client ``m`` embeds its whole ``(B, chunk)`` span slice in ONE call
    and the server consumes the upload through ``server_prefill``.
    Returns only the last position's logits (the decode seed)."""
    if adapter.server_prefill is None:
        raise ValueError(
            f"adapter {adapter.name!r} has no server_prefill hook; use the "
            "per-token step loop")
    e = marks.wire_boundary(adapter.client_embed(_client(params, m), toks),
                            kind="emb", direction="up")
    logits, caches = adapter.server_prefill(params["server"], e, caches, t0)
    return logits[:, -1:], caches


def prefill_plan(prompt_len: int, span: int) -> List[Tuple[int, int, int]]:
    """Span-aligned chunk schedule ``[(t0, t1, owner_m)]`` covering the
    prompt: each chunk lies inside exactly one client party's span, so
    one party embeds it in one call."""
    plan = []
    t0 = 0
    while t0 < prompt_len:
        m = t0 // span
        t1 = min((m + 1) * span, prompt_len)
        plan.append((t0, t1, m))
        t0 = t1
    return plan


def zero_caches(adapter: ModelAdapter, batch: int, max_seq: int, device):
    return tree_map(
        lambda s: torch.zeros(s.shape, dtype=torch_dtype(s.dtype),
                              device=device),
        adapter.cache_specs(batch, max_seq))


def sample_token(logits, t: int, temperature: float, vocab_size: int,
                 draws: Optional[GumbelSource] = None):
    """THE serve-plane sampler: greedy, or categorical as
    ``argmax(logits / T + gumbel)`` with the noise for position ``t`` from
    ``draws``. Token ids are clamped into the unpadded vocabulary."""
    lg = logits[:, -1].float()
    if temperature > 0:
        if draws is None:
            raise ValueError("sampling at temperature > 0 needs a Gumbel "
                             "draw source")
        nxt = torch.argmax(
            lg / temperature + draws.gumbel(t, tuple(lg.shape), lg.device),
            dim=-1)
    else:
        nxt = torch.argmax(lg, dim=-1)
    return torch.clamp(nxt, max=vocab_size - 1).to(torch.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ============================================================ run_decode ===

def run_decode(adapter: ModelAdapter, transport, *, n_clients: int,
               seq_len: int, embed_dim: int, vocab_size: int, params,
               prompts, gen_len: int, device: torch.device,
               temperature: float = 0.0,
               draws: Optional[GumbelSource] = None,
               ledger: Optional[Ledger] = None, use_scan: bool = True,
               chunked_prefill: bool = True,
               kept: Optional[graphs.Kept] = None) -> ServeResult:
    """Prefill + decode through the split serve plane (the
    ``Federation.decode`` engine). ``use_scan`` decodes through
    :func:`make_decode_scan` (a CUDA graph on the card); ``use_scan=False``
    runs the eager loop of one-token steps. ``chunked_prefill=False``
    prefills with the per-token step loop (the equivalence oracle).

    ``kept`` keeps the decode scan (its graph) and its static buffers
    across calls, as the JAX package's cache of compiled scans does:
    keyed by the prompts' :func:`graphs.signature`, ``gen_len``, the
    temperature and the identity of the params tree's leaves (the graph
    reads the parameters where they are; a key of shapes alone would need
    a copy of them). The key does not keep the parameters alive: it is
    dropped when any leaf of the tree dies. What it keeps is its buffers
    (the KV caches at B x (prompt + gen_len) slots, the logits, the
    tokens, the noise table) and its graph's memory pool. A call of a
    kept key zeroes the key's caches, prefills into them, and replays
    all ``gen_len`` tokens: nothing is captured, ``compile_s`` holds no
    capture and ``graph`` is the kept graph, its replays counted. On the
    CPU the key keeps the buffers its loop runs on."""
    if not isinstance(prompts, torch.Tensor):
        prompts = torch.from_numpy(np.array(prompts))
    prompts = prompts.to(device=device, dtype=torch.int32)
    B, prompt_len = prompts.shape
    max_seq = prompt_len + gen_len
    if max_seq > seq_len:
        raise ValueError(
            f"prompt_len + gen_len = {max_seq} exceeds the session "
            f"seq_len {seq_len} (the party span split is sized to it)")
    compile_s = (_build.ensure_loaded(SERVE_KERNELS)
                 if device.type == "cuda" else 0.0)
    span = seq_len // n_clients
    step = make_serve_step(adapter, n_clients, seq_len)
    key = hit = None
    if use_scan and kept is not None and gen_len >= 1:
        key = (graphs.signature(prompts), gen_len, float(temperature),
               tuple(id(x) for x in tree_leaves(params)))
        hit = kept.get(key)
    if hit is None:
        caches = zero_caches(adapter, B, max_seq, device)
    else:
        caches = hit["st"]["caches"]
        for c in tree_leaves(caches):
            c.zero_()

    # ------------------------------------------------------- prefill ----
    tic = time.perf_counter()
    logits = None
    if chunked_prefill and adapter.server_prefill is not None:
        for t0, t1, m in prefill_plan(prompt_len, span):
            logits, caches = prefill_chunk(adapter, params,
                                           prompts[:, t0:t1], caches, t0, m)
    else:
        for t in range(prompt_len):
            logits, caches = step(params, prompts[:, t:t + 1], caches, t)
    _sync(device)
    prefill_s = time.perf_counter() - tic

    # -------------------------------------------------------- decode ----
    # the serve plane's only downlink: one sampled token id per step to
    # the owning client (never the logits); tokens stay on the device
    # until the one fetch after the loop
    tic = time.perf_counter()
    graph = None
    if use_scan:
        noise = None
        if temperature > 0:
            if draws is None:
                raise ValueError("sampling at temperature > 0 needs a "
                                 "Gumbel draw source")
            noise = noise_table(draws, prompt_len, gen_len, B,
                                logits.shape[-1], device)
        entry = hit or {"st": None, "scan": make_decode_scan(
            adapter, n_clients, seq_len, prompt_len, gen_len,
            float(temperature), vocab_size)}
        st = entry["st"] = decode_buffers(logits, caches, prompt_len,
                                          gen_len, noise, into=entry["st"])
        graph = entry["scan"](params, st)
        if key is not None and hit is None:
            if graph is not None:
                graph.release()     # the caller's tree is the key's owner
            kept.put(key, entry, owners=tree_leaves(params))
        out, logits = st["out"], st["logits"]
        if key is not None:
            # the key's buffers take the next call's decode (on the CPU
            # the fetched tokens would share the buffer's memory)
            out, logits = out.clone(), logits.clone()
    else:
        out = torch.empty((B, gen_len), dtype=torch.int32, device=device)
        for i, t in enumerate(range(prompt_len, max_seq)):
            nxt = sample_token(logits, t, temperature, vocab_size, draws)
            out[:, i] = nxt
            logits, caches = step(params, nxt[:, None], caches, t)
    out_tokens = out.cpu().numpy()
    _sync(device)
    decode_s = time.perf_counter() - tic
    if graph is not None and hit is None:
        compile_s += graph.capture_s
        decode_s -= graph.capture_s

    # every step uploads one embedding; only the gen_len sampled tokens
    # cross back down (the clients already hold the prompt)
    ledger = transport.account_serve(batch=B, embed=embed_dim,
                                     n_steps=max_seq, n_gen=gen_len,
                                     ledger=ledger)
    return ServeResult(tokens=out_tokens, logits=logits, ledger=ledger,
                       prefill_s=prefill_s, decode_s=decode_s,
                       compile_s=compile_s, graph=graph,
                       kept=hit is not None)
