"""Boundary certification driver (``python -m repro_torch.analysis
certify``).

Builds a real :class:`~repro_torch.federation.session.Federation` for
every shipped method configuration, traces the EXACT step closure its
engine runs (``Federation.traceable_train_step`` / the population server
pair / the serve plane's decode body, one node a kernel launch on the
card), runs the :mod:`repro_torch.analysis.ifc` taint pass over the
graph, and evaluates:

* **IF301–IF303** — :func:`ifc.check_flows` on each report;
* **IF304** — the traced crossing inventory must match what the wire
  plane actually serializes: payload kinds against
  :data:`repro_torch.wire.codec.DATA_TAGS` (+ the serve plane's token
  frame), per-round element counts against the
  :func:`privacy.round_messages` / :func:`privacy.serve_messages` ledger
  formulas, no :data:`privacy.GRADIENT_KINDS` message on a certified
  wire, and — for the sharded engine — every collective in the traced
  graph restricted to intra-server kinds (``all-gather``/``all-reduce``,
  as many a round as the step's derivation says: collectives move data
  between *server* shards, never across the party boundary).

``vafl`` and ``split`` are certified as NEGATIVE CONTROLS: their wire is
declared leaky (FOO downlink), so the certifier must trip IF301 on them
— if it does not, the gradient anchor is broken and certification of the
safe methods is vacuous, which is itself reported as a finding.

The result is a certificate JSON (``--out``, by default under
``build/``): per-method crossing inventories and the rule verdicts, in
the JAX package's ``CERT_boundary.json`` layout, regenerated on every
run. The serve plane's decode body runs ``gen_len`` times in the trace
(the loop the CPU runs; the card's CUDA graph replays the same body), so
its inventory is ``gen_len`` steps of crossings; the certificate keeps
one step's (``per_step``) beside them. Exit status is non-zero iff any
finding survives. Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis import ifc
from repro_torch.analysis.findings import Finding
from repro_torch.configs import get_config
from repro_torch.configs.base import VFLConfig, reduced
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core import adapters, async_engine, privacy
from repro_torch.core.draws import FilledDraws, RowDraws
from repro_torch.core.methods import CASCADED, SPLIT, SYN_ZOO, VAFL, ZOO_VFL
from repro_torch.core.privacy import GaussianLossChannel
from repro_torch.device import resolve_device
from repro_torch.federation import serving
from repro_torch.federation.session import Federation
from repro_torch.models.common import torch_dtype
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.wire import codec

DEFAULT_OUT = os.path.join("build", "CERT_boundary.json")

#: crossing kind -> the privacy-ledger Message.kind it serializes as
KIND_TO_MESSAGE = {"emb": "embedding", "loss": "loss", "token": "token"}

#: collective kinds the sharded server step may emit (server-internal
#: resharding; anything else would be a new cross-device channel)
SERVER_COLLECTIVES = frozenset({"all-gather", "all-reduce"})
#: c10d ops of a traced graph by collective kind
C10D_KINDS = {"_allgather_base_": "all-gather", "allgather_": "all-gather",
              "allgather_into_tensor_coalesced_": "all-gather",
              "allreduce_": "all-reduce",
              "allreduce_coalesced_": "all-reduce"}

# ---- toy trace geometry (the JAX package's certificate's) ---------------
_Q = 2           # zoo_queries: 1 clean + 2 perturbed lanes
_BLOCK = 2       # async block rows per round
_BATCH = 4
_ROWS = 16
_TOY = PaperMLPConfig(n_features=8, n_classes=3, n_clients=2,
                      client_embed=4, server_embed=6)
# the serve trace: reduced phi3 at d_model 32, B 2, prompt 8, 4 tokens
_SERVE = dict(batch=2, prompt_len=8, gen_len=4, seq_len=16, n_clients=2)


def _cert_path(name: str) -> str:
    return f"<certify:{name}>"


def _is_float(dtype: str) -> bool:
    return torch_dtype(dtype).is_floating_point


# ======================================================== IF304 checks ====

def _crossing_kind_findings(name: str, report: ifc.IFCReport,
                            allowed_tags: Sequence[str]) -> List[Finding]:
    path = _cert_path(name)
    return [Finding(
        "IF304", path, 0,
        f"{name}: traced boundary crossing kind {c.kind!r} has no wire "
        f"serialization (allowed frame tags: {sorted(allowed_tags)})")
        for c in report.crossings if c.kind not in allowed_tags]


def train_if304(name: str, report: ifc.IFCReport, meta: Dict[str, Any],
                *, embed: int, rounds_per_trace: int) -> List[Finding]:
    """Crossing inventory vs the wire plane for one training method."""
    path = _cert_path(name)
    out: List[Finding] = []
    lanes = 1 + meta["zoo_queries"]

    # (a) every crossing kind must be a codec DATA_TAG — the training
    # wire only serializes "emb" and "loss" frames
    out += _crossing_kind_findings(name, report, codec.DATA_TAGS)

    # (b) the ledger formula for one activated client's round
    msgs = privacy.round_messages(meta["method"], meta["batch"], embed,
                                  zoo_queries=meta["zoo_queries"])
    grad_msgs = [m.kind for m in msgs if m.kind in privacy.GRADIENT_KINDS]
    if grad_msgs:
        out.append(Finding(
            "IF304", path, 0,
            f"{name}: the privacy ledger says this method wires "
            f"{sorted(set(grad_msgs))} frames — a gradient on the wire "
            "cannot be certified"))
        return out
    n_loss = sum(1 for m in msgs if m.kind == "loss")
    n_emb = sum(1 for m in msgs if m.kind == "embedding")

    # (c) downlink: total scalars per trace == ledger losses * rounds (one
    # ledger loss Message is one scalar a lane)
    down = report.down("loss")
    if not down:
        out.append(Finding(
            "IF304", path, 0,
            f"{name}: the ledger bills {n_loss} loss frames per round but "
            "the traced step has NO loss downlink crossing — the wire "
            "accounting and the program disagree"))
    got = sum(c.size for c in down)
    want = n_loss * rounds_per_trace
    if down and got != want:
        out.append(Finding(
            "IF304", path, 0,
            f"{name}: traced loss downlink carries {got} scalars per "
            f"trace; the ledger formula bills {n_loss} loss frames x 1 "
            f"scalar x {rounds_per_trace} activated client(s) = {want}"))
    for c in down:
        if not _is_float(c.dtype):
            out.append(Finding(
                "IF304", path, 0,
                f"{name}: loss downlink dtype {c.dtype} is not a float "
                "loss scalar"))

    # (d) uplink: the lane fan-out axis must match the ledger's 1 clean +
    # q perturbed embedding frames
    ups = [c for c in report.up() if c.kind == "emb"]
    if not ups:
        out.append(Finding(
            "IF304", path, 0,
            f"{name}: the ledger bills {n_emb} embedding frames per round "
            "but the traced step has NO embedding uplink crossing"))
    for c in ups:
        if c.shape[-1] != embed:
            out.append(Finding(
                "IF304", path, 0,
                f"{name}: embedding uplink trailing dim {c.shape[-1]} != "
                f"client embed width {embed}"))
        if n_emb > 1 and n_emb not in c.shape[:-2]:
            out.append(Finding(
                "IF304", path, 0,
                f"{name}: embedding uplink shape {list(c.shape)} has no "
                f"lane axis of size {n_emb} (= 1 clean + q={lanes - 1} "
                "perturbed frames the ledger bills)"))
    return out


def serve_if304(name: str, steps: List[List[ifc.Crossing]], *, batch: int,
                d_model: int) -> List[Finding]:
    """Each decode step's crossings vs the serve ledger's one step."""
    path = _cert_path(name)
    out: List[Finding] = []
    msgs = privacy.serve_messages(batch, d_model, with_token=True)
    allowed = sorted({k for k, v in KIND_TO_MESSAGE.items()
                      if v in {m.kind for m in msgs}})
    for i, step in enumerate(steps):
        where = f"{name} step {i}"
        out += [Finding(
            "IF304", path, 0,
            f"{where}: traced boundary crossing kind {c.kind!r} has no "
            f"wire serialization (allowed frame tags: {allowed})")
            for c in step if c.kind not in allowed]
        toks = [c for c in step if c.direction == "down"
                and c.kind == "token"]
        if len(toks) != 1:
            out.append(Finding(
                "IF304", path, 0,
                f"{where}: the serve ledger bills one token frame per "
                f"generation step; the decode step traced {len(toks)} "
                "token downlinks"))
        for c in toks:
            if _is_float(c.dtype):
                out.append(Finding(
                    "IF304", path, 0,
                    f"{where}: token downlink dtype {c.dtype} is not an "
                    "integer id — the serve wire must carry token ids, "
                    "never logits"))
            if c.size != batch:
                out.append(Finding(
                    "IF304", path, 0,
                    f"{where}: token downlink carries {c.size} elements; "
                    f"the ledger bills one id per sequence ({batch})"))
        ups = [c for c in step if c.direction == "up" and c.kind == "emb"]
        if len(ups) != 1:
            out.append(Finding(
                "IF304", path, 0,
                f"{where}: the serve ledger bills one embedding uplink per "
                f"step; the decode step traced {len(ups)}"))
        for c in ups:
            if c.shape[-1] != d_model or c.shape[0] != batch:
                out.append(Finding(
                    "IF304", path, 0,
                    f"{where}: serve uplink shape {list(c.shape)} does not "
                    f"match the (batch={batch}, 1, d_model={d_model}) "
                    "one-token embedding the ledger bills"))
    return out


# ================================================== per-method drivers ====

def toy_session(method: str, *, block: int = 1, use_lanes: bool = False,
                dp: bool = False, mesh_shards: int = 0, q: int = _Q,
                device=None) -> Federation:
    noise = GaussianLossChannel() if dp else None
    return Federation.build(
        _TOY, VFLConfig(n_clients=_TOY.n_clients, zoo_queries=q),
        async_engine.EngineConfig(method=method, batch_size=_BATCH,
                                  block_size=block, use_lanes=use_lanes,
                                  mesh_shards=mesh_shards),
        noise=noise, device=device)


def trace_train(fed: Federation, cfg: PaperMLPConfig = _TOY, *,
                n_rows: int = _ROWS, args=None
                ) -> Tuple[ifc.IFCReport, Dict[str, Any]]:
    """Trace the session's step closure; client-bound outputs only.
    ``args`` (``adapters.example_engine_args``' tuple) defaults to
    zero-filled ones at ``cfg``; the step updates them in place."""
    meta = fed.boundary_meta()
    if args is None:
        args = adapters.example_engine_args(
            fed.adapter, cfg, n_rows=n_rows, batch=meta["batch"],
            block=meta["block"], q=meta["zoo_queries"], device=fed.device)
    step = fed.traceable_train_step(table_shape=tuple(args[1].shape))
    if fed.mesh is not None:
        # the sharded step's table carries one spare row past its own
        table = args[1]
        args = (args[0], torch.cat([table, table.new_zeros(
            (1,) + tuple(table.shape[1:]))])) + tuple(args[2:])

    def client_view(params, table, m_blk, idx, t, draws, x_parts, y):
        new_params, _table, _h = step(params, table, m_blk, idx, t, draws,
                                      x_parts, y)
        return new_params["clients"]

    def is_server(path: str) -> bool:
        # params["server"] (the filled draws' "server" directions are the
        # engine's own random numbers, not server-held values)
        return path.startswith("[0]['server']")

    return ifc.trace_and_analyze(client_view, args, is_server=is_server), meta


def _trace_population(fed: Federation) -> Tuple[ifc.IFCReport,
                                                Dict[str, Any]]:
    """Trace ``losses_fn`` — the population engine's whole downlink.

    Args are ``(server, c_stale, m, emb_lanes, yb, r, n_rows, t)``; the
    server party owns positions 0 (its parameters) and 1 (the stale
    embedding table it caches), so the SERVER seed is by position, not
    by key name."""
    meta = fed.boundary_meta()
    q, dev = meta["zoo_queries"], fed.device
    # the DP noise of the traced call, drawn before the trace from the
    # session's default source (a generator inside a traced graph is
    # not portable across torch versions)
    noise = RowDraws(fed.engine.seed, dev).noise(0, 1, 1 + q)
    _update, losses_fn = fed.traceable_population_fns(
        draws=FilledDraws(noise=noise))

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)
    server = tree_map(lambda s: zeros(s.shape, torch_dtype(s.dtype)),
                      fed.adapter.param_specs()["server"])
    c_stale = zeros((_TOY.n_clients, _BATCH, _TOY.client_embed))
    emb_lanes = zeros((1 + q, _BATCH, _TOY.client_embed))
    yb = zeros((_BATCH,), torch.int64)
    row = zeros((1,), torch.int64)         # client m = block row r = 0
    args = (server, c_stale, row, emb_lanes, yb, row.clone(), 1, 0)

    def is_server(path: str) -> bool:
        return path.startswith("[0]") or path.startswith("[1]")

    return ifc.trace_and_analyze(losses_fn, args, is_server=is_server), meta


def trace_serve(fed: Federation, params, *, batch: int, prompt_len: int,
                gen_len: int, temperature: float = 0.7, seed: int = 0
                ) -> Tuple[ifc.IFCReport, List[List[ifc.Crossing]]]:
    """Trace the decode body ``gen_len`` times from a zero cache and zero
    carried logits — the serve plane's only server->client channel.
    ``params`` (engine layout), the carried logits and the caches seed
    SERVER where they are server-held; the traced output is the sampled
    tokens the clients receive. Returns the report and its crossings
    split by decode step (a step's token downlink opens it)."""
    cfg, dev = fed.model_cfg, fed.device
    caches = serving.zero_caches(fed.adapter, batch, prompt_len + gen_len,
                                 dev)
    logits = torch.zeros((batch, 1, cfg.padded_vocab),
                         dtype=torch_dtype(cfg.dtype), device=dev)
    noise = None
    if temperature > 0:
        noise = serving.noise_table(serving.TorchGumbel(seed, dev),
                                    prompt_len, gen_len, batch,
                                    cfg.padded_vocab, dev)
    st = serving.decode_buffers(logits, caches, prompt_len, gen_len, noise)
    scan = serving.make_decode_scan(fed.adapter, fed.n_clients, fed.seq_len,
                                    prompt_len, gen_len, temperature,
                                    cfg.vocab_size)

    def run(p, buffers):
        scan(p, buffers)
        return buffers["out"]

    def is_server(path: str) -> bool:
        # params["server"], the carried logits and the KV caches
        return ("server" in path.lower()
                or path.startswith(("[1]['logits']", "[1]['caches']")))

    report = ifc.trace_and_analyze(run, (params, st), is_server=is_server)
    steps: List[List[ifc.Crossing]] = []
    for c in report.crossings:
        if (c.kind, c.direction) == ("token", "down") or not steps:
            steps.append([])
        steps[-1].append(c)
    return report, steps


def _toy_serve(device) -> Tuple[Federation, Any]:
    cfg = reduced(get_config("phi3-mini-3.8b"), d_model=32, n_heads=2,
                  n_kv_heads=1, d_ff=64, vocab_size=64)
    fed = Federation.build(cfg, VFLConfig(), async_engine.EngineConfig(),
                           n_clients=_SERVE["n_clients"],
                           seq_len=_SERVE["seq_len"], device=device)
    params = tree_map(
        lambda s: torch.zeros(s.shape, dtype=torch_dtype(s.dtype),
                              device=fed.device),
        fed.adapter.param_specs())
    return fed, params


def _down_limits(meta: Dict[str, Any]) -> Dict[str, int]:
    return {"loss": (1 + meta["zoo_queries"]) * meta["block"]}


def _entry(report: ifc.IFCReport, meta: Dict[str, Any],
           f: List[Finding]) -> Dict[str, Any]:
    return {"status": "violated" if f else "certified", "meta": meta,
            "report": report.to_json(), "findings": [fi.rule for fi in f]}


def certify_train(name: str, report: ifc.IFCReport,
                  meta: Dict[str, Any], embed: int) -> List[Finding]:
    """IF301–IF304 on one training trace."""
    f = ifc.check_flows(report, name=name, dp_configured=meta["dp"],
                        down_limits=_down_limits(meta),
                        path=_cert_path(name))
    if report.stopped is None:
        f += train_if304(name, report, meta, embed=embed,
                         rounds_per_trace=meta["block"])
    if meta["dp"] and report.n_dp_eqns < 1:
        f.append(Finding(
            "IF303", _cert_path(name), 0,
            f"{name}: DP channel configured but the traced step contains "
            "no noise application"))
    return f


# ============================================================== driver ====

def build_certificate(device=None) -> Tuple[List[Finding], Dict[str, Any]]:
    """Certify every shipped configuration; returns (findings, cert). The
    sharded configuration needs a process group: where none exists, a
    one-rank group on an in-process store is brought up for it and torn
    down after (gloo on the CPU, NCCL on the card)."""
    device = resolve_device(device)
    findings: List[Finding] = []
    methods: Dict[str, Any] = {}

    train_variants = [
        ("cascaded", dict(method=CASCADED, block=_BLOCK)),
        ("cascaded-lanes", dict(method=CASCADED, block=_BLOCK,
                                use_lanes=True)),
        ("cascaded-dp", dict(method=CASCADED, block=_BLOCK, dp=True)),
        ("cascaded-sharded", dict(method=CASCADED, block=_BLOCK,
                                  mesh_shards=1)),
        ("zoo-vfl", dict(method=ZOO_VFL, block=_BLOCK)),
        ("syn-zoo", dict(method=SYN_ZOO)),
    ]
    for name, kw in train_variants:
        with (one_rank_group(device) if kw.get("mesh_shards")
              else contextlib.nullcontext()):
            fed = toy_session(**kw, device=device)
            report, meta = trace_train(fed)
        f = certify_train(name, report, meta, _TOY.client_embed)
        entry = _entry(report, meta, f)
        if kw.get("mesh_shards"):
            entry["collectives"] = sharded_collectives(
                name, report, n_client_leaves=len(tree_leaves(
                    fed.adapter.param_specs()["clients"])), findings=f)
            entry["status"] = "violated" if f else "certified"
            entry["findings"] = [fi.rule for fi in f]
        methods[name] = entry
        findings += f

    # -- population engine (the real-wire server pair) ---------------------
    for name, dp in (("population", False), ("population-dp", True)):
        fed = toy_session(CASCADED, dp=dp, device=device)
        report, meta = _trace_population(fed)
        limits = {"loss": 1 + meta["zoo_queries"]}   # per-client call
        f = ifc.check_flows(report, name=name, dp_configured=dp,
                            down_limits=limits, path=_cert_path(name))
        if report.stopped is None:
            f += train_if304(name, report, meta, embed=_TOY.client_embed,
                             rounds_per_trace=1)
        methods[name] = _entry(report, dict(meta, plane="wire"), f)
        findings += f

    # -- serve plane -------------------------------------------------------
    name = "split-serve"
    fed, params = _toy_serve(device)
    batch = _SERVE["batch"]
    report, steps = trace_serve(fed, params, batch=batch,
                                prompt_len=_SERVE["prompt_len"],
                                gen_len=_SERVE["gen_len"])
    f = ifc.check_flows(report, name=name, dp_configured=False,
                        down_limits={"token": batch}, path=_cert_path(name))
    if report.stopped is None:
        f += serve_if304(name, steps, batch=batch,
                         d_model=fed.model_cfg.d_model)
        if len(steps) != _SERVE["gen_len"]:
            f.append(Finding(
                "IF304", _cert_path(name), 0,
                f"{name}: {len(steps)} decode steps traced, "
                f"{_SERVE['gen_len']} generated"))
    meta = {"method": SPLIT, "plane": "serve", "batch": batch,
            "d_model": fed.model_cfg.d_model,
            "prompt_len": _SERVE["prompt_len"],
            "gen_len": _SERVE["gen_len"], "n_clients": fed.n_clients}
    entry = _entry(report, meta, f)
    entry["per_step"] = [[c.to_json() for c in s] for s in steps]
    methods[name] = entry
    findings += f

    # -- negative controls: the leaky FOO wires MUST trip IF301 ------------
    for name, method in (("vafl", VAFL), ("split", SPLIT)):
        fed = toy_session(method, device=device)
        report, meta = trace_train(fed)
        f = ifc.check_flows(report, name=name, dp_configured=False,
                            down_limits=_down_limits(meta),
                            path=_cert_path(name))
        tripped = any(fi.rule == "IF301" for fi in f)
        methods[name] = {
            "status": "declared-leaky",
            "expected_failure": "IF301",
            "tripped": tripped,
            "meta": meta, "report": report.to_json(),
            "findings": sorted({fi.rule for fi in f}),
        }
        if not tripped:
            findings.append(Finding(
                "IF301", _cert_path(name), 0,
                f"{name}: negative control did NOT trip IF301 — the "
                "certifier has lost its gradient anchor (grad_mark no "
                "longer reaches the client outputs), so certifying the "
                "safe methods proves nothing"))

    cert = {
        "version": 1,
        "tool": "repro_torch.analysis.certify",
        "device": str(device),
        "claim": ("every server->client flow in the shipped methods "
                  "factors through the (1+q)-scalar loss bottleneck "
                  "(training) or the sampled-token ids (serving); no "
                  "server-parameter cotangent reaches a client"),
        "rules": ["IF301", "IF302", "IF303", "IF304"],
        "wire": {"codec_data_tags": list(codec.DATA_TAGS),
                 "wire_version": codec.WIRE_VERSION},
        "methods": methods,
        "clean": not findings,
    }
    return findings, cert


@contextlib.contextmanager
def one_rank_group(device):
    """A one-rank process group on an in-process ``HashStore`` (no port,
    so concurrent runs cannot collide) when none is initialized, torn
    down on exit: gloo on the CPU, NCCL on the card."""
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def sharded_collectives(name: str, report: ifc.IFCReport, *,
                        n_client_leaves: int,
                        findings: List[Finding]) -> Dict[str, Any]:
    """Audit the sharded step's collectives, read off its traced c10d
    nodes: bytes and count by kind. A kind beyond the server-internal
    all-gather/all-reduce resharding, or a count other than the step's
    derivation (two all-gathers at the server-loss boundary, one
    all-reduce a client leaf), is IF304."""
    nbytes: Dict[str, int] = {}
    count: Dict[str, int] = {}
    for n in report.graph.graph.nodes:
        schema = getattr(n.target, "_schema", None)
        if n.op != "call_function" or schema is None \
                or not schema.name.startswith("c10d::"):
            continue
        op = schema.name.split("::", 1)[1]
        kind = C10D_KINDS.get(op, f"c10d::{op}")
        buf = n.args[0] if isinstance(n.args[0], (list, tuple)) \
            else [n.args[0]]
        size = sum(b.meta["val"].numel() * b.meta["val"].element_size()
                   for b in buf)
        nbytes[kind] = nbytes.get(kind, 0) + size
        count[kind] = count.get(kind, 0) + 1
    bad = sorted(set(count) - SERVER_COLLECTIVES)
    if bad:
        findings.append(Finding(
            "IF304", _cert_path(name), 0,
            f"{name}: sharded step emits collective kinds {bad} beyond "
            "the server-internal all-gather/all-reduce resharding — a "
            "new cross-device channel must be re-certified"))
    want = {"all-gather": 2, "all-reduce": n_client_leaves}
    if {k: count.get(k, 0) for k in want} != want:
        findings.append(Finding(
            "IF304", _cert_path(name), 0,
            f"{name}: the sharded round runs collectives {count}; its "
            f"derivation is {want}"))
    return {**nbytes, "total": sum(nbytes.values()), "count": count}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis certify",
        description="prove the party boundary on the traced graphs")
    ap.add_argument("--strict", action="store_true",
                    help="CI mode (identical verdict; documents the gate)")
    ap.add_argument("--json", action="store_true",
                    help="print the certificate JSON to stdout")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"certificate path (default {DEFAULT_OUT})")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for "
                         "the CPU)")
    ns = ap.parse_args(argv)

    findings, cert = build_certificate(ns.device)

    out_dir = os.path.dirname(ns.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(ns.out, "w") as fh:
        json.dump(cert, fh, indent=2, sort_keys=True)
        fh.write("\n")

    if ns.json:
        print(json.dumps(cert, indent=2, sort_keys=True))
    else:
        for f in findings:
            print(f.render())
        coll = cert["methods"]["cascaded-sharded"].get("collectives", {})
        print(f"cascaded-sharded collectives a round: {coll.get('count')}, "
              f"bytes all-gather {coll.get('all-gather')} and all-reduce "
              f"{coll.get('all-reduce')} (the JAX package's compiled "
              "step: 264 and 336)")
        certified = sum(1 for m in cert["methods"].values()
                        if m["status"] == "certified")
        controls = sum(1 for m in cert["methods"].values()
                       if m["status"] == "declared-leaky"
                       and m.get("tripped"))
        print(f"{certified} configuration(s) certified, {controls} "
              f"negative control(s) tripped as declared, "
              f"{len(findings)} finding(s) on {cert['device']} -> {ns.out}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
