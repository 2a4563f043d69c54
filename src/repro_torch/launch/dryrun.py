"""Production-mesh dry run: trace every (arch x input-shape x mesh)
combination on a fake process group of 256 (or 512) ranks, and derive the
roofline terms of one H100 from what one rank runs.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch phi3-mini-3.8b --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]

The port of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each program for 512 placeholder host devices and reads XLA's
artifact. Here the process joins a ``"fake"`` process group
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once) of the mesh's size as rank 0, builds the production mesh
on it (``launch.mesh.make_production_mesh``), places every parameter and
input as a fake DTensor by the rules (``PARAM_RULES``, or
``PARAM_RULES_NO_FSDP`` for ``--no-fsdp``; ``ACT_RULES`` for the data),
and runs one step eagerly under ``FakeTensorMode``: the cascaded
``sync_step`` factory's step for ``train_*`` shapes, ``forward_fn`` for
prefill, ``decode_fn`` at the last position for decode. No card is
needed, and none is touched: the fake tensors are the CPU's (a CPU build
of torch refuses to index a ``cuda`` tensor, a fake one too) and
``marks.card_route()`` sends them down the card's route. Every kernel
call goes through its custom-op node (``marks.trace_context()``), whose
fake implementation gives the
output's shape and whose FLOP formula (``launch/roofline.py``) counts its
work; ``data_ptr`` is never read. ``launch/roofline.py``'s
``StepCounter`` counts the rank's FLOPs, bytes and collectives
(``utils/comms.py``), and ``launch/costmodel.py`` fits them from probes of
1 and 2 of each repeated segment, so a full-depth model is never traced.

The result JSON keeps the JAX package's fields, with two changes: its
``lower_s`` and ``compile_s`` become one ``trace_s`` (the probes' eager
trace: there is nothing to compile), and ``roofline_raw_scanned`` (XLA's
uncorrected scan count) has no counterpart and is left out. One field is
the port's own: ``coll_by_site``, the collective bytes by mesh axis, kind
and the line of the port's code that issued them (``utils/comms.py``).
The memory
fields are one rank's: ``argument_bytes_per_dev`` its parameter, input
(and cache) shards (``param_bytes_per_dev`` the parameters' alone),
``output_bytes_per_dev`` the step's results,
``temp_bytes_per_dev`` the peak of the live tensors the step makes beside
its arguments (the tracer's peak: the counterpart of
``memory_analysis()``; fitted from probes of 2 and 3 layers, see
``costmodel.py``), and ``peak_hbm_estimate_per_dev`` their sum.

Run it in a process of its own (``python -m``): it joins a fake group,
which a process with a real group must not.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch.distributed as dist

from repro_torch.configs import INPUT_SHAPES, ModelConfig, get_config, \
    list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.methods import METHOD_ALIASES, canonical_method
from repro_torch.launch import costmodel
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_production_mesh
from repro_torch.models.model_api import build_cache_specs, \
    build_input_specs, build_model
from repro_torch.sharding.rules import ACT_RULES, PARAM_RULES, \
    PARAM_RULES_NO_FSDP

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments_torch", "dryrun")
# the sliding window the attention archs take at 500k-token decode
LONG_WINDOW = 4096


def get_shape(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]


def skip_reason(cfg, shape) -> str:
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        return "enc-dec arch: 500k-token decode not meaningful (DESIGN.md)"
    return ""


UNPORTED_VARIANTS = ("--window-gather and a --remat-policy other than "
                     "'full' have no counterpart in the port: its models "
                     "read no gathered decode window, and its remat "
                     "recomputes the whole block under either policy")


@dataclasses.dataclass
class Variant:
    """Hillclimb switches. Defaults = paper-faithful baseline. The JAX
    package's ``window_gather`` and ``remat_policy`` are not among them:
    the CLI keeps their flags and refuses them
    (:data:`UNPORTED_VARIANTS`)."""
    name: str = "baseline"
    gather_experts: bool = False    # tiny-batch MoE expert weight gather
    remat: bool = True              # activation checkpointing in train
    zoo_queries: int = 1
    iota_embed: bool = False        # one-hot-matmul embedding lookup
    rs_outputs: bool = False        # reduce-scatter TP output projections
    mla_absorb: bool = False        # latent-space MLA decode
    no_fsdp: bool = False           # TP/EP only: no weight gathers
    fused_dual: bool = False        # one stacked clean+perturbed pass
    capacity_factor: float = 0.0    # >0 overrides the MoE capacity factor


def fake_group(world: int) -> None:
    """Join a fake process group of ``world`` ranks as rank 0 (replacing
    a fake group of another size); refuse a real group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if "fake" not in str(dist.get_backend()).lower():
            raise RuntimeError("the dry run joins a fake process group; "
                               "this process already has a real one")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_one(arch, shape_name: str, *, multi_pod: bool = False,
            variant: Variant = Variant(), method: str = "cascaded",
            verbose: bool = True, trace_full: bool = False) -> dict:
    """One dry run. ``arch`` is a registry id or a ``ModelConfig`` (a
    reduced one, in the tests). ``trace_full`` also traces the step at
    the config's full depth and puts its counts beside the fit's under
    ``"traced"`` (the fit's check; never on a production depth)."""
    method = canonical_method(method)
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    arch = cfg.arch_id
    shape = get_shape(shape_name)
    reason = skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape_name, "skipped": reason}

    window = 0
    if shape.name == "long_500k" and cfg.family not in ("ssm",):
        # attention archs need sub-quadratic attention at 500k: SWA variant
        window = LONG_WINDOW
    if variant.remat is False:
        cfg = dataclasses.replace(cfg, remat=False)
    if shape.is_decode:
        cfg = dataclasses.replace(cfg, remat=False)   # no backward pass
    if variant.iota_embed or variant.rs_outputs or variant.mla_absorb:
        cfg = dataclasses.replace(cfg, iota_embed=variant.iota_embed,
                                  rs_outputs=variant.rs_outputs,
                                  mla_absorb=variant.mla_absorb)
    if variant.capacity_factor:
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=variant.capacity_factor)

    n_dev = math.prod(PRODUCTION_SHAPES[bool(multi_pod)][0])
    fake_group(n_dev)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    param_rules = PARAM_RULES_NO_FSDP if variant.no_fsdp else PARAM_RULES
    backward = shape.kind == "train"
    kw = dict(window=window, gather_experts=variant.gather_experts,
              zoo_queries=variant.zoo_queries, param_rules=param_rules,
              fused_dual=variant.fused_dual, method=method)

    t0 = time.perf_counter()
    corr = costmodel.corrected_costs(cfg, shape, mesh, **kw)
    traced = costmodel.measure(cfg, shape, mesh, **kw) if trace_full \
        else None
    t_trace = time.perf_counter() - t0

    model = build_model(cfg, max_seq=shape.seq_len, window=window)
    param_bytes = costmodel.local_bytes(model.param_specs, mesh, param_rules)
    args = param_bytes + costmodel.local_bytes(build_input_specs(cfg, shape),
                                               mesh, ACT_RULES)
    if shape.is_decode:
        args += costmodel.local_bytes(
            build_cache_specs(cfg, shape.global_batch, shape.seq_len),
            mesh, ACT_RULES)
    roof = rl.Roofline(
        flops=corr["flops"], bytes_accessed=corr["bytes"],
        coll_bytes=corr["coll_bytes"], coll_by_kind=corr["coll_by_kind"],
        n_devices=n_dev,
        model_flops=rl.model_flops_for(cfg, shape, backward=backward),
        coll_by_axis=corr["coll_by_axis"],
        mesh_shape=dict(zip(mesh.mesh_dim_names, mesh.shape)))

    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "method": method,
        "variant": variant.name,
        "window": window,
        "kind": shape.kind,
        "trace_s": round(t_trace, 1),
        "memory": {
            "argument_bytes_per_dev": int(args),
            "param_bytes_per_dev": int(param_bytes),
            "output_bytes_per_dev": int(corr["output_bytes"]),
            "temp_bytes_per_dev": int(corr["peak_bytes"]),
            "peak_hbm_estimate_per_dev": int(args + corr["output_bytes"]
                                             + corr["peak_bytes"]),
        },
        "roofline": roof.as_dict(),
        "cost_segments": corr.get("per_segment"),
        "coll_by_site": corr["coll_by_site"],
    }
    if traced is not None:
        result["traced"] = {k: traced[k] for k in costmodel.METRICS
                            + ("coll_by_site",)}
    if verbose:
        r = result["roofline"]
        hbm_gb = result["memory"]["peak_hbm_estimate_per_dev"] / 2**30
        print(f"[dryrun] {arch:22s} {shape_name:12s} "
              f"{result['mesh']:8s} {variant.name:14s} "
              f"compute={r['compute_s']*1e3:9.3f}ms "
              f"memory={r['memory_s']*1e3:9.3f}ms "
              f"coll={r['collective_s']*1e3:9.3f}ms "
              f"bound={r['bottleneck']:10s} hbm={hbm_gb:6.2f}GiB "
              f"(trace {t_trace:.0f}s)", flush=True)
    return result


def save_result(res: dict, out_dir: str = OUT_DIR):
    os.makedirs(out_dir, exist_ok=True)
    suffix = ("" if res.get("method", "cascaded") == "cascaded"
              else f"_{res['method']}")
    name = f"{res['arch']}_{res['shape']}_{res.get('mesh','skip')}" \
           f"_{res.get('variant','baseline')}{suffix}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(res, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--method", default="cascaded",
                    choices=sorted(METHOD_ALIASES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--window-gather", action="store_true")
    ap.add_argument("--gather-experts", action="store_true")
    ap.add_argument("--iota-embed", action="store_true")
    ap.add_argument("--rs-outputs", action="store_true")
    ap.add_argument("--mla-absorb", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--fused-dual", action="store_true")
    ap.add_argument("--remat-policy", default="full")
    ap.add_argument("--capacity-factor", type=float, default=0.0)
    ap.add_argument("--variant-name", default=None)
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    if args.window_gather or args.remat_policy != "full":
        ap.error(UNPORTED_VARIANTS)
    any_opt = (args.gather_experts or args.iota_embed or args.rs_outputs
               or args.mla_absorb or args.no_fsdp or args.fused_dual
               or args.capacity_factor)
    variant = Variant(
        name=args.variant_name or ("baseline" if not any_opt else "opt"),
        gather_experts=args.gather_experts,
        iota_embed=args.iota_embed,
        rs_outputs=args.rs_outputs,
        mla_absorb=args.mla_absorb,
        no_fsdp=args.no_fsdp,
        fused_dual=args.fused_dual,
        capacity_factor=args.capacity_factor)

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    res = run_one(arch, shape, multi_pod=mp, variant=variant,
                                  method=args.method)
                    save_result(res, args.out)
                    if "skipped" in res:
                        print(f"[dryrun] {arch:22s} {shape:12s} SKIP: "
                              f"{res['skipped']}", flush=True)
                    else:
                        print(json.dumps(res), flush=True)
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    failures.append((arch, shape, mp, repr(e)))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nall dry-runs traced OK")


if __name__ == "__main__":
    main()
