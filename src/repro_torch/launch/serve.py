"""Serving driver: batched prefill + decode with KV caches, on the card.

Decoder-only archs serve SPLIT by default — the ``Federation`` session's
serve plane (``fed.decode``) keeps the training party split at inference:
client parties embed their token spans, the server owns backbone + head +
caches, and every step's wire traffic (one embedding up, token ids down)
lands in the Transport's ledger. ``n_clients=0`` is the global path (one
party, prefill token by token through the decode step), the oracle the
split path equals on replicated client tables, and the fallback for the
families that cannot cross the VFL wire (encoder-decoder and VLM need a
modality frontend on it): with ``n_clients >= 1`` they serve global and
the result carries a ``fallback`` note. Whisper's encoder runs once,
on zero frames, before the prefill; the VLM serves text only.

``--continuous`` serves ``--batch`` independent requests through the
continuous-batching scheduler (``fed.serve``) over ``--max-batch`` slots
instead of one fused batch, with the failure policy exposed:
``--max-queue`` bounds admission (the driver drains a step on
``QueueFull`` and retries), ``--preempt``/``--n-pages`` enable page-pool
preemption under memory pressure, and ``--deadline`` gives every request
that many scheduler steps to retire.

Ported from the JAX package's ``launch/serve.py`` for every family of
the registry. ``--reduced`` /
``--no-reduced`` picks the smoke-size variant or the full published width
(the JAX package's flag cannot turn reduction off); ``--layers N`` cuts
the depth to N layers at either width, as ``launch/train.py``'s does
(DeepSeek-V3 at 5 layers: its 3 dense and 2 MoE layers).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
        --batch 8 --prompt-len 1024 --gen-len 128 --no-reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --batch 8 --prompt-len 1024 --gen-len 128 --no-reduced
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-30b-a3b --batch 8 --prompt-len 1024 --gen-len 128 \
        --no-reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --batch 8 --prompt-len 1024 --gen-len 128 --no-reduced
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v3-671b --batch 8 --prompt-len 1024 --gen-len 128 \
        --no-reduced --layers 5
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \
        --batch 8 --prompt-len 224 --gen-len 224 --no-reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b \
        --batch 8 --prompt-len 256 --gen-len 128 --no-reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v3-671b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous \
        --batch 16 --max-batch 8 --prompt-len 1024 --gen-len 128 --no-reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from repro_torch.configs import cut_depth, get_config, list_archs, reduced
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federation import serving
from repro_torch.models import common, encdec
from repro_torch.models.model_api import build_cache_specs, build_model
from repro_torch.tree import tree_map


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _prompts(cfg, batch: int, prompt_len: int, seed: int, device):
    gen = torch.Generator(device).manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen, device=device, dtype=torch.int32)


def _zero_caches(cfg, batch: int, seq: int, device):
    return tree_map(lambda s: torch.zeros(s.shape, device=device,
                                          dtype=common.torch_dtype(s.dtype)),
                    build_cache_specs(cfg, batch, seq))


def _check_logits(logits) -> float:
    """Raise unless the final logits are finite; returns their max |.|."""
    if not bool(torch.isfinite(logits.float()).all()):
        raise RuntimeError("the served model's final logits are not finite")
    return float(logits.float().abs().max())


def _splittable(cfg) -> bool:
    return not (cfg.is_encoder_decoder or cfg.family == "vlm")


def serve(arch: str, *, batch: int = 4, prompt_len: int = 16,
          gen_len: int = 16, use_reduced: bool = True, seed: int = 0,
          temperature: float = 0.0, n_clients: int = 0,
          continuous: bool = False, max_batch: int = 4,
          max_queue: Optional[int] = None, preempt: bool = False,
          n_pages: Optional[int] = None, deadline: Optional[int] = None,
          n_layers: int = 0, device: DeviceLike = None) -> dict:
    """``n_clients >= 1`` routes through the session's split serve plane
    (falling back to the global path, with a ``fallback`` note, for the
    families that cannot split); ``n_clients=0`` is the global decode,
    equal to the split path on replicated client tables.
    ``continuous=True`` serves ``batch``
    independent requests through the continuous-batching scheduler
    (``fed.serve``) over ``max_batch`` slots, with ``max_queue``,
    ``preempt``, ``n_pages`` and ``deadline`` as the scheduler takes them.
    ``n_layers`` > 0 cuts the depth (``configs.cut_depth``: a
    ``first_k_dense`` config keeps at most that many dense layers first).
    Weights are random, drawn from ``seed`` on the run's device (the card
    unless ``device="cpu"``)."""
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg, remat=False)
    cfg = cut_depth(cfg, n_layers)
    device = resolve_device(device)
    if continuous and not n_clients:
        raise ValueError("continuous batching serves the split plane: "
                         "pass n_clients >= 1")
    if n_clients and _splittable(cfg):
        if continuous:
            return _serve_continuous(arch, cfg, batch=batch,
                                     prompt_len=prompt_len, gen_len=gen_len,
                                     seed=seed, temperature=temperature,
                                     n_clients=n_clients,
                                     max_batch=max_batch,
                                     max_queue=max_queue, preempt=preempt,
                                     n_pages=n_pages, deadline=deadline,
                                     device=device)
        return _serve_federated(arch, cfg, batch=batch,
                                prompt_len=prompt_len, gen_len=gen_len,
                                seed=seed, temperature=temperature,
                                n_clients=n_clients, device=device)
    res = _serve_global(arch, cfg, batch=batch, prompt_len=prompt_len,
                        gen_len=gen_len, seed=seed, temperature=temperature,
                        device=device)
    if n_clients:
        res["fallback"] = (f"{cfg.family}/encdec family needs a modality "
                           "frontend on the wire; served global")
    return res


# ------------------------------------------------- split (session) path ---

def build_session(cfg, *, n_clients: int, prompt_len: int, gen_len: int,
                  seed: int, device: DeviceLike = None):
    """(fed, params) for a serving run — the party span split is rounded
    up to cover the full served window; global params drawn from
    ``seed``."""
    from repro_torch.federation import Federation
    max_seq = prompt_len + gen_len
    seq_len = -(-max_seq // n_clients) * n_clients
    fed = Federation.build(cfg, n_clients=n_clients, seq_len=seq_len,
                           device=device)
    params = common.materialize(
        fed.model.param_specs,
        torch.Generator(fed.device).manual_seed(seed), device=fed.device)
    return fed, params


def _serve_federated(arch: str, cfg, *, batch: int, prompt_len: int,
                     gen_len: int, seed: int, temperature: float,
                     n_clients: int, device: torch.device) -> dict:
    fed, params = build_session(cfg, n_clients=n_clients,
                                prompt_len=prompt_len, gen_len=gen_len,
                                seed=seed, device=device)
    toks = _prompts(cfg, batch, prompt_len, seed, fed.device)
    res = fed.decode(params, toks, gen_len=gen_len, temperature=temperature,
                     seed=seed)
    if res.tokens.shape != (batch, gen_len):
        raise RuntimeError(f"generated {res.tokens.shape}, want "
                           f"{(batch, gen_len)}")
    absmax = _check_logits(res.logits)
    return {
        "arch": arch, "batch": batch, "mode": "federated",
        "clients": n_clients, "seq_len": fed.seq_len,
        "prompt_len": prompt_len, "gen_len": gen_len,
        "device": str(fed.device),
        "prefill_s": res.prefill_s, "decode_s": res.decode_s,
        "compile_s": res.compile_s,
        "decode_tok_per_s": batch * gen_len / max(res.decode_s, 1e-9),
        "wire_bytes": res.wire_bytes,
        "wire_has_gradients": res.transmits_gradients,
        "final_logits_absmax": absmax,
        "sample_output": res.tokens[0, :8].tolist(),
        "decode_graph": None if res.graph is None else res.graph.stats(),
    }


# ------------------------------------------- continuous-batching path ---

def _serve_continuous(arch: str, cfg, *, batch: int, prompt_len: int,
                      gen_len: int, seed: int, temperature: float,
                      n_clients: int, max_batch: int,
                      max_queue: Optional[int], preempt: bool,
                      n_pages: Optional[int], deadline: Optional[int],
                      device: torch.device) -> dict:
    from repro_torch.federation import QueueFull
    fed, params = build_session(cfg, n_clients=n_clients,
                                prompt_len=prompt_len, gen_len=gen_len,
                                seed=seed, device=device)
    srv = fed.serve(params, max_batch=max_batch, temperature=temperature,
                    max_queue=max_queue, preempt=preempt, n_pages=n_pages)
    # every request's prompt in one draw on the device, fetched in one
    # transfer; request i samples from seed + i
    prompts = _prompts(cfg, batch, prompt_len, seed, fed.device).cpu().numpy()
    queue_retries = 0
    for i in range(batch):
        while True:
            try:
                srv.submit(prompts[i], gen_len, seed=seed + i,
                           deadline=deadline)
                break
            except QueueFull:
                # bounded admission is recoverable by design: drain a
                # step, then offer the request again
                queue_retries += 1
                srv.run(max_steps=1)
    srv.run()
    results = [srv.results[rid] for rid in sorted(srv.results)]
    if len(results) != batch:
        raise RuntimeError(f"drained {len(results)} requests of {batch}")
    ok = [r for r in results if r.status == "ok"]
    total_tokens = sum(r.tokens.size for r in ok)
    statuses = {}
    for r in results:
        statuses[r.status] = statuses.get(r.status, 0) + 1
    return {
        "arch": arch, "batch": batch, "mode": "continuous",
        "clients": n_clients, "slots": max_batch, "seq_len": fed.seq_len,
        "prompt_len": prompt_len, "gen_len": gen_len,
        "device": str(fed.device),
        "steps": srv.steps,
        "compile_s": srv.compile_s,
        "decode_tok_per_s": total_tokens / max(srv.last_run_s, 1e-9),
        "statuses": statuses,
        "preemptions": srv.preemptions,
        "deadline_misses": srv.deadline_misses,
        "queue_retries": queue_retries,
        "wire_bytes": sum(r.wire_bytes for r in results),
        "wire_has_gradients": any(r.transmits_gradients for r in results),
        "sample_output": (ok[0] if ok else results[0]).tokens[:8].tolist(),
    }


# ------------------------------------------------------------ global path ---

def make_global_steps(model, params, toks, caches, extra: dict, *,
                      gen_len: int, temperature: float, vocab_size: int):
    """The global decode's two step bodies on static buffers: the
    counterpart of the JAX package's ``jax.jit(model.decode_fn)`` with the
    caches donated. Returns ``(prefill, decode, st)``: ``st`` holds
    ``pos`` (1,) int64 the device position, ``logits`` (B, 1, vocab) the
    carried logits (made by the first step), ``out`` (B, gen_len) int32
    the tokens, ``caches`` (updated in place; a step's new leaves are
    copied into them) and ``noise``, which the caller sets before the
    first decode step when temperature > 0.

    ``prefill()`` feeds the prompt's column at the device position
    through ``model.decode_fn`` and carries its logits (it samples
    nothing). ``decode()`` samples from the carried logits as
    :func:`serving.sample_token` does (greedy, or ``argmax(logits / T +
    gumbel)`` with the noise read from ``st["noise"]``, the (gen_len, B,
    vocab) table :func:`serving.noise_table` fills, at the device
    position), writes the token into ``out``, steps, and carries the
    logits. Both advance the position. ``toks``, ``params`` and ``extra`` (Whisper's
    ``enc_out``) are static inputs: nothing rebinds them."""
    B, prompt_len = toks.shape
    st = {"pos": torch.zeros((1,), dtype=torch.int64, device=toks.device),
          "logits": None, "caches": caches, "noise": None,
          "out": torch.zeros((B, gen_len), dtype=torch.int32,
                             device=toks.device)}

    def step(tok):
        logits, new = model.decode_fn(params, {"tokens": tok, **extra},
                                      st["caches"], st["pos"])
        tree_map(lambda old, nw: None if nw is old else old.copy_(nw),
                 st["caches"], new)
        if st["logits"] is None:            # the first step, never captured
            st["logits"] = torch.empty_like(logits)
        st["logits"].copy_(logits)
        st["pos"].add_(1)

    def prefill():
        step(toks.index_select(1, st["pos"]))

    def decode():
        i = st["pos"] - prompt_len
        lg = st["logits"][:, -1].float()
        if temperature > 0:
            lg = lg / temperature + st["noise"].index_select(0, i)[0]
        nxt = torch.clamp(torch.argmax(lg, dim=-1),
                          max=vocab_size - 1).to(torch.int32)
        st["out"].index_copy_(1, i, nxt[:, None])
        step(nxt[:, None])

    return prefill, decode, st


@torch.no_grad()
def global_decode(model, params, toks, caches, extra: dict, *, gen_len: int,
                  temperature: float, vocab_size: int, draws=None) -> dict:
    """Prefill ``toks`` (B, P) token by token through ``model.decode_fn``
    and generate ``gen_len`` tokens: ``{"tokens": (B, gen_len) int32 on
    the device, "logits": the last step's, "prefill_s", "decode_s",
    "prefill_graph", "decode_graph"}``.

    On the card the prompt and the generation replay two captured steps
    (:func:`make_global_steps`, in one graph pool; the first prefill and
    the first decode step are the graphs' warm-ups, run eagerly; a failed
    capture raises): the counterpart of the JAX package's
    ``jax.jit(model.decode_fn)``. On the CPU the same step bodies run in
    loops. The seconds leave out the captures, which ``prefill_graph``
    and ``decode_graph`` carry (None where nothing was captured)."""
    from repro_torch import graphs
    device = toks.device
    B, prompt_len = toks.shape
    res = {"prefill_graph": None, "decode_graph": None}
    prefill, decode, st = make_global_steps(
        model, params, toks, caches, extra, gen_len=gen_len,
        temperature=float(temperature), vocab_size=vocab_size)
    on_card = device.type == "cuda"
    pool = torch.cuda.graph_pool_handle() if on_card else None
    for body, n, name in ((prefill, prompt_len, "prefill"),
                          (decode, gen_len, "decode")):
        t0 = time.perf_counter()
        if name == "decode" and temperature > 0:
            # the eager loop's draws, one position at a time, in order
            st["noise"] = serving.noise_table(
                draws, prompt_len, gen_len, B, st["logits"].shape[-1],
                device)
        capture_s = 0.0
        if on_card and n > 1:
            graph = graphs.StepGraph(body, device, pool=pool)
            graph.timed_replays(n - 1)
            res[f"{name}_graph"] = graph.stats()
            capture_s = graph.capture_s
            del graph
        else:
            for _ in range(n):
                body()
        _sync(device)
        res[f"{name}_s"] = time.perf_counter() - t0 - capture_s
    return dict(res, tokens=st["out"], logits=st["logits"])


def _serve_global(arch: str, cfg, *, batch: int, prompt_len: int,
                  gen_len: int, seed: int, temperature: float,
                  device: torch.device) -> dict:
    """The global decode (one party) of random weights drawn from
    ``seed``: :func:`global_decode`, CUDA graphs on the card, loops on the
    CPU. Whisper's encoder runs once before the prefill."""
    max_seq = prompt_len + gen_len
    model = build_model(cfg, max_seq=max_seq)
    with torch.no_grad():
        params = common.materialize(
            model.param_specs, torch.Generator(device).manual_seed(seed),
            device=device)
    toks = _prompts(cfg, batch, prompt_len, seed, device)
    caches = _zero_caches(cfg, batch, max_seq, device)
    draws = serving.TorchGumbel(seed, device) if temperature > 0 else None

    # the encoder runs once, on the stub frontend's zero frames, and every
    # decode step attends over its output
    extra, timed = {}, {}
    if cfg.is_encoder_decoder:
        t0 = time.perf_counter()
        frames = torch.zeros((batch, cfg.encoder_seq, cfg.frontend_dim),
                             dtype=torch.bfloat16, device=device)
        with torch.no_grad():
            extra["enc_out"] = encdec.encode(cfg, params, frames)
        _sync(device)
        timed["encode_s"] = time.perf_counter() - t0

    res = global_decode(model, params, toks, caches, extra, gen_len=gen_len,
                        temperature=temperature, vocab_size=cfg.vocab_size,
                        draws=draws)
    gen = res["tokens"].cpu().numpy()
    absmax = _check_logits(res["logits"])
    return {
        "arch": arch, "batch": batch, "mode": "global",
        "prompt_len": prompt_len, "gen_len": gen_len,
        "device": str(device),
        "prefill_s": res["prefill_s"], "decode_s": res["decode_s"], **timed,
        "decode_tok_per_s": batch * gen_len / max(res["decode_s"], 1e-9),
        "final_logits_absmax": absmax,
        "sample_output": gen[0, :8].tolist(),
        "prefill_graph": res["prefill_graph"],
        "decode_graph": res["decode_graph"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = the "
                         "config's)")
    # 0 = the global path; >= 1 serves split via fed.decode
    ap.add_argument("--clients", type=int, default=2)
    # continuous batching: drain --batch requests through --max-batch slots
    ap.add_argument("--continuous", action="store_true")
    ap.add_argument("--max-batch", type=int, default=4)
    # failure policy (continuous path only): bounded admission, page-pool
    # preemption, and a per-request step deadline
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--preempt", action="store_true")
    ap.add_argument("--n-pages", type=int, default=None)
    ap.add_argument("--deadline", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    print(json.dumps(serve(args.arch, batch=args.batch,
                           prompt_len=args.prompt_len, gen_len=args.gen_len,
                           temperature=args.temperature, seed=args.seed,
                           use_reduced=args.reduced, n_clients=args.clients,
                           continuous=args.continuous,
                           max_batch=args.max_batch,
                           max_queue=args.max_queue, preempt=args.preempt,
                           n_pages=args.n_pages, deadline=args.deadline,
                           n_layers=args.layers, device=args.device),
                     indent=2))


if __name__ == "__main__":
    main()
