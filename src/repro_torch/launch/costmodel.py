"""Dry-run costs at full depth from probes of 1 and 2 instances of each
repeated segment (2 and 3 for the peak).

The JAX package's ``launch/costmodel.py`` fits ``cost(counts) = base +
Σ_seg slope_seg · counts[seg]`` to unrolled probe programs because XLA's
``cost_analysis()`` counts a scanned layer loop's body once. The port's
dry run counts an eager step op by op (:class:`roofline.StepCounter`), so
a traced count is exact at any depth; the same fit serves here to keep the
dry run cheap at full depth: DeepSeek-V3's 61 layers are never traced,
only probes of 1, 2 and 3 of each segment are. The probes differ by whole
segments of identical ops, so the fit is exact (integer arithmetic): at a
depth that is traced, it equals the traced count.

The peak of the live tensors is the exception: it is a maximum over the
step's moments, so it grows by whole segments only once one moment holds
it at every depth. At reduced width the 1-layer probe peaks at another
moment (reduced phi3 at ``train_4k``: +64 MiB from 1 to 2 layers, then
+32 MiB a layer). So the peak is fitted from probes of 2 and 3 of each
segment, and at a depth not traced it is an extrapolation: exact where
the deepest probes' moment stays the peak, which the tests and the chip
check hold against a traced 4-layer count.

Segments per family (the JAX package's):
  dense/vlm/ssm : layers
  moe           : moe layers (+ leading dense layers for deepseek)
  hybrid        : super-blocks (attn_every mambas + shared attn)
  enc-dec       : encoder layers, decoder layers

:func:`measure` traces one configuration on the mesh: its parameters and
inputs fake ``cuda`` tensors (``FakeTensorMode``: shapes, no storage)
placed as DTensors by the rules, the step run once under ``use_mesh``,
DTensor's implicit replication, ``marks.trace_context()`` and
``marks.card_route()`` (every kernel call a custom-op node with a fake
implementation: no launch, no ``data_ptr``), counted by
:class:`roofline.StepCounter`. The fake tensors and the mesh are the
CPU's: a CPU build of torch refuses to index a ``cuda`` tensor, a fake
one too, and ``card_route`` sends them down the card's kernel route all
the same, as ``utils.comms.nccl_alltoall`` sends DTensor's Shard(i) ->
Shard(j) redistributes down the card's all-to-all.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch

from repro_torch.analysis import marks
from repro_torch.configs.base import ModelConfig, ShapeConfig, VFLConfig
from repro_torch.core.cascade import make_step_for_method
from repro_torch.core.draws import PlacedDraws
from repro_torch.launch.roofline import StepCounter
from repro_torch.models import common
from repro_torch.models.model_api import (build_cache_specs,
                                          build_input_specs, build_model)
from repro_torch.optim import placed_like_params, sgd
from repro_torch.sharding.rules import ACT_RULES, PARAM_RULES, use_mesh
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.utils.comms import by_axis_kind, bytes_by_axis, \
    bytes_by_site, collective_bytes, nccl_alltoall, shapes_by_site

# the counts a probe measures, each fitted on its own
METRICS = ("flops", "bytes", "coll_bytes", "peak_bytes", "output_bytes")


def _segment_counts(cfg: ModelConfig) -> Dict[str, int]:
    if cfg.is_encoder_decoder:
        return {"enc": cfg.n_encoder_layers, "dec": cfg.n_layers}
    if cfg.family == "hybrid":
        return {"super": cfg.n_layers // cfg.attn_every}
    if cfg.n_experts and cfg.first_k_dense:
        return {"dense": cfg.first_k_dense,
                "moe": cfg.n_layers - cfg.first_k_dense}
    return {"layers": cfg.n_layers}


def _probe_cfg(cfg: ModelConfig, counts: Dict[str, int]) -> ModelConfig:
    kw = {}
    if cfg.is_encoder_decoder:
        kw.update(n_encoder_layers=counts["enc"], n_layers=counts["dec"])
    elif cfg.family == "hybrid":
        kw.update(n_layers=counts["super"] * cfg.attn_every)
    elif cfg.n_experts and cfg.first_k_dense:
        kw.update(first_k_dense=counts["dense"],
                  n_layers=counts["dense"] + counts["moe"])
    else:
        kw.update(n_layers=counts["layers"])
    return dataclasses.replace(cfg, **kw)


def _probe_points(cfg: ModelConfig, base: int = 1) -> List[Dict[str, int]]:
    """``base`` of every segment, then each segment at ``base`` + 1."""
    segs = sorted(_segment_counts(cfg))
    pts = [{s: base for s in segs}]
    for s in segs:
        p = {t: base for t in segs}
        p[s] = base + 1
        pts.append(p)
    return pts


class FakeDraws:
    """The step's draws as fake tensors of ``fake`` (a
    ``FakeTensorMode``): shapes only."""

    def __init__(self, fake, device) -> None:
        self.fake, self.device = fake, device

    def _randn(self, shape):
        with self.fake:
            return torch.randn(shape, device=self.device)

    def _normals(self, template, lead):
        return tree_map(lambda w: self._randn(tuple(lead) + tuple(w.shape)),
                        template)

    def client_directions(self, t, template, n_rows, q):
        return self._normals(template, (n_rows, q))

    def server_directions(self, t, template, q):
        return self._normals(template, (q,))

    def noise(self, t, n_rows, n):
        return self._randn((n_rows, n))


def _fake_tree(fake, specs, device):
    with fake:
        return tree_map(lambda s: torch.empty(
            s.shape, dtype=common.torch_dtype(s.dtype), device=device),
            specs)


def local_bytes(specs, mesh, rules) -> int:
    """The bytes of one rank's shards of a spec tree placed by ``rules``
    (the shards ``resolve_spec`` gives: each sharded dim divided by its
    axes' sizes)."""
    from repro_torch.sharding.rules import mesh_axes, resolve_spec
    axes = mesh_axes(mesh)
    total = 0
    for s in tree_leaves(specs):
        logical = s.logical if s.logical else (None,) * len(s.shape)
        n = 1
        for size, entry in zip(s.shape, resolve_spec(mesh, s.shape, logical,
                                                     rules)
                               + (None,) * len(s.shape)):
            div = 1
            if entry is not None:
                for a in ((entry,) if isinstance(entry, str) else entry):
                    div *= axes[a]
            n *= size // div
        total += n * common.torch_dtype(s.dtype).itemsize
    return total


def measure(cfg: ModelConfig, shape: ShapeConfig, mesh, *, window: int = 0,
            gather_experts: bool = False, zoo_queries: int = 1,
            param_rules=None, fused_dual: bool = False,
            method: str = "cascaded") -> Dict[str, float]:
    """Trace one step of ``cfg`` at ``shape`` on ``mesh`` (a CPU mesh on
    the dry run's fake group); returns one
    rank's {flops, bytes, coll_bytes, peak_bytes, output_bytes,
    coll_by_kind, coll_by_axis, coll_by_site, coll_by_axis_kind,
    coll_shapes_by_site, trace_s} (``coll_by_axis_kind``:
    :func:`utils.comms.by_axis_kind`, the collectives' count and bytes;
    ``coll_shapes_by_site``: :func:`utils.comms.shapes_by_site`, the
    local operand shapes each site issued). A train step updates through
    ``placed_like_params(sgd(0.01))``, the optimizer as
    ``Federation.sync_step`` wraps it. ``peak_bytes`` is
    ``MemTracker``'s peak of the tensors the step makes beside its
    arguments, on one rank."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    rules = param_rules or PARAM_RULES
    model = build_model(cfg, max_seq=shape.seq_len, window=window,
                        gather_experts=gather_experts)
    dev = torch.device(mesh.device_type)
    t0 = time.perf_counter()
    # the fake mode makes the leaves and the draws and is not entered for
    # the step: a fake tensor computes in its own mode, and DTensor's
    # layout arithmetic (index tensors of a strided shard) stays real
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    params = common.place(_fake_tree(fake, model.param_specs, dev),
                          model.param_specs, mesh, rules)
    d_specs = build_input_specs(cfg, shape)
    data = common.place(_fake_tree(fake, d_specs, dev), d_specs, mesh,
                        ACT_RULES)
    args = (params, data)
    if shape.kind == "decode":
        c_specs = build_cache_specs(cfg, shape.global_batch, shape.seq_len)
        args += (common.place(_fake_tree(fake, c_specs, dev), c_specs, mesh,
                              ACT_RULES),)
    counter = StepCounter(mesh, fake)
    mem = MemTracker()
    with use_mesh(mesh), implicit_replication(), marks.trace_context(), \
            marks.card_route(), nccl_alltoall():
        if shape.kind == "train":
            # wrapped as ``Federation.sync_step`` wraps it: each gradient
            # brought to its parameter's placement before the update (a
            # replicated parameter's partial-sum gradient all-reduced, as
            # the JAX package's compiled step does and its HLO counts)
            opt = placed_like_params(sgd(0.01))
            step = make_step_for_method(
                method, model.loss_fn, model.client_keys,
                VFLConfig(zoo_queries=zoo_queries, fused_dual=fused_dual),
                opt, vocab=cfg.padded_vocab)
            opt_state = opt.init(params)
            draws = PlacedDraws(FakeDraws(fake, dev), mesh)
            with mem, counter:
                new_params, new_state, stats = step(params, opt_state, data,
                                                    0, draws)
            out = (new_params, new_state,
                   [getattr(stats, f.name)
                    for f in dataclasses.fields(stats)])
        elif shape.kind == "prefill":
            with mem, counter:
                out = model.forward_fn(params, data)
        else:
            # the last position: the step attends over the whole cache
            with mem, counter:
                out = model.decode_fn(*args, shape.seq_len - 1)
    out_bytes = sum(_local(t).numel() * t.element_size()
                    for t in tree_leaves(out) if isinstance(t, torch.Tensor))
    peak = sum(v["Total"] for v in mem.get_tracker_snapshot("peak").values())
    trace_s = time.perf_counter() - t0
    coll = collective_bytes(counter.records)
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "coll_bytes": float(coll["total"]), "peak_bytes": float(peak),
            "output_bytes": float(out_bytes), "coll_by_kind": coll,
            "coll_by_axis": bytes_by_axis(counter.records),
            "coll_by_site": bytes_by_site(counter.records),
            "coll_by_axis_kind": by_axis_kind(counter.records),
            "coll_shapes_by_site": shapes_by_site(counter.records),
            "trace_s": trace_s}


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _fit(ys: List[Dict], segs: List[str], counts: Dict[str, int],
         key: str, base: int = 1) -> Dict[str, float]:
    """y0 + Σ slope·(count - base) from the probes (the first at ``base``
    of every segment, then each segment at ``base`` + 1), evaluated at
    ``counts``; per-key maps (coll_by_kind, coll_by_axis, coll_by_site)
    fitted entry by entry."""
    def val(y, k):
        return y[key].get(k, 0.0) if k is not None else y[key]

    def one(k):
        y0 = val(ys[0], k)
        return y0 + sum((val(ys[1 + i], k) - y0) * (counts[s] - base)
                        for i, s in enumerate(segs))
    if isinstance(ys[0][key], dict):
        names = sorted({k for y in ys for k in y[key]})
        return {k: one(k) for k in names}
    return one(None)


def corrected_costs(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                    window: int = 0, gather_experts: bool = False,
                    zoo_queries: int = 1, param_rules=None,
                    fused_dual: bool = False, method: str = "cascaded"
                    ) -> Dict[str, float]:
    """Probe, solve, extrapolate. Returns one rank's {flops, bytes,
    coll_bytes, peak_bytes, output_bytes, coll_by_kind, coll_by_axis,
    coll_by_site} at the FULL segment counts, the per-segment slopes and
    the probes' trace seconds."""
    if shape.is_decode:
        cfg = dataclasses.replace(cfg, remat=False)
    segs = sorted(_segment_counts(cfg))
    full = _segment_counts(cfg)
    kw = dict(window=window, gather_experts=gather_experts,
              zoo_queries=zoo_queries, param_rules=param_rules,
              fused_dual=fused_dual, method=method)
    probes: Dict[tuple, Dict] = {}

    def probe(pt):
        key = tuple(sorted(pt.items()))
        if key not in probes:
            probes[key] = measure(_probe_cfg(cfg, pt), shape, mesh, **kw)
        return probes[key]
    pts = _probe_points(cfg)
    # a warm-up trace first: DTensor fills its sharding caches on an op's
    # first call, and on some torch versions MemTracker counts the
    # propagation's tensors then, which would inflate the first probe
    warm = measure(_probe_cfg(cfg, pts[0]), shape, mesh, **kw)
    ys = [probe(pt) for pt in pts]
    deep = [probe(pt) for pt in _probe_points(cfg, base=2)]
    out = {k: _fit(ys, segs, full, k) for k in METRICS if k != "peak_bytes"}
    out["peak_bytes"] = _fit(deep, segs, full, "peak_bytes", base=2)
    for k in ("coll_by_kind", "coll_by_axis", "coll_by_site"):
        out[k] = _fit(ys, segs, full, k)
    out["segments"] = full
    out["per_segment"] = {}
    for i, s in enumerate(segs):
        seg = {k: ys[1 + i][k] - ys[0][k] for k in METRICS}
        seg["peak_bytes"] = deep[1 + i]["peak_bytes"] - deep[0]["peak_bytes"]
        out["per_segment"][s] = seg
    out["trace_s"] = warm["trace_s"] + sum(y["trace_s"]
                                           for y in probes.values())
    return out
