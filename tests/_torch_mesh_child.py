"""Child processes of ``tests/test_torch_production_mesh.py`` and
``tests/test_torch_dryrun.py``: anything that joins a process group runs
here, never in a pytest worker.

    python _torch_mesh_child.py train RANK WORLD STORE OUT
    python _torch_mesh_child.py fake KIND OUT

``train``: one rank of a gloo group of WORLD = 4 ranks at a (2, 2)
``("data", "model")`` mesh, joined through the ``FileStore`` at STORE. For
each case of :data:`CASES` it runs ``launch.train.train(cfg, mesh=)`` for
1 and for 2 cascaded steps on the CPU, counts the ``shard_constraint``
calls, and keeps each step's ``StepOutput`` (losses, logged gradient
norms), every leaf's local shape and its full value (``full_tensor()``);
then 2 steps of each case and of the DP case (:data:`DP_CASE`) through
the compiled step ``train`` builds (a ``graphs.GraphedFn``: its loop
form on the CPU) and through that step's body called bare on the run's
own trees; 2 steps of each case through
the functional eager step (``fed.sync_step(opt)``), with every leaf's
placement beside the one ``PARAM_RULES`` gives; and for
:data:`RESUME_CASES` a run saved at step :data:`RESUME_AT` (its
checkpoint in the directory OUT sits in, ``ck_<case>``), the run
resumed from it to twice that and the straight-through placed run, each
with its step losses and each saved at its end (``ck_<case>_resumed``,
``ck_<case>_straight``). It keeps one eager placed step of the phi3
case's collectives as ``utils.comms.CommRecorder`` sees them
(``comms.summary``). It also keeps
``make_production_mesh``'s refusal on this group and ``graphs.signature``
of DTensors placed ``Shard(0)``, ``Replicate()`` and ``Shard(0)`` again,
and what ``copy_into`` says to a buffer refilled from another placement.
Rank 0 writes all of it to OUT (``torch.save``).

``fake``: joins a fake process group (one process standing for 256, 512
or 4 ranks) and writes to OUT (JSON): with KIND ``placements``, the
placements of every parameter leaf of every registry architecture under
both parameter rule sets on the (16, 16), (2, 16, 16) and (2, 2) meshes;
with ``comms``, ``utils.comms``' records of known redistributes; with
``measure``, ``costmodel.measure``'s collectives (``comms.summary``'s
keys) of the phi3 case's step at TRAIN's batch and sequence on a (2, 2)
mesh of 4 fake ranks, of its bf16 step traced with and without
``placed_like_params``, and of its FOO step (``method="vafl"``); with
``dryrun``, ``launch.dryrun.run_one`` of reduced phi3 at ``train_4k``
with the full depth traced beside the fit.
"""
import contextlib
import dataclasses
import json
import os
import sys

import torch
import torch.distributed as dist

# (name, arch, reduced() overrides): f32 so that the placed and the
# unplaced runs differ only by the order of sharded sums; qwen3 with one
# KV head, so that the (2, 2) mesh shards its four query heads but not its
# KV head (the GQA fallback)
CASES = (("phi3", "phi3-mini-3.8b", {}),
         ("qwen3_gqa", "qwen3-moe-30b-a3b", {"n_kv_heads": 1}))
# the dry run's traced depth: beyond the probes of the fit (1 and 2
# layers; 2 and 3 for the peak)
DRYRUN_LAYERS = 4
TRAIN = dict(batch=4, seq=32, use_reduced=False, device="cpu",
             log_every=100, keep_params=True)
# the DP loss channel on phi3 (σ ≈ 0.48: the clean and perturbed losses
# stay inside the clip)
DP_CASE = ("phi3_dp", "phi3-mini-3.8b", {})
DP_NOISE = dict(clip=10.0, epsilon=100.0, delta=1e-5)
# the placed checkpoint's cases: saved after RESUME_AT steps, resumed to
# 2 x RESUME_AT, against the straight-through placed run
RESUME_CASES = (CASES[0], DP_CASE)
RESUME_AT = 2


def case_noise(name):
    from repro_torch.core.privacy import GaussianLossChannel
    return GaussianLossChannel(**DP_NOISE) if name == DP_CASE[0] else None


@contextlib.contextmanager
def built_steps(bare=False, functional=False):
    """Every step ``Federation.sync_step`` builds inside, recorded in the
    yielded list; ``bare=True`` hands out the compiled step's body (the
    step with the in-place optimizer, called on the caller's trees)
    instead of the ``graphs.GraphedFn`` over it; ``functional=True`` the
    functional eager step (``fed.sync_step(opt)``), which returns new
    trees."""
    from repro_torch import graphs
    from repro_torch.federation import session
    inner, graphed, built = (session.Federation.sync_step, graphs.GraphedFn,
                             [])

    def sync_step(fed, optimizer, **kw):
        if functional:
            kw["graph"] = False
        built.append(inner(fed, optimizer, **kw))
        return built[-1]
    session.Federation.sync_step = sync_step
    if bare:
        graphs.GraphedFn = lambda fn, device, **kw: fn
    try:
        yield built
    finally:
        session.Federation.sync_step, graphs.GraphedFn = inner, graphed


def case_cfg(arch, overrides):
    from repro_torch.configs import get_config, reduced
    return reduced(get_config(arch), param_dtype="float32", **overrides)


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def train_rank(rank, world, store, out):
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.train import train
    from repro_torch.sharding import rules
    from repro_torch.utils import comms
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    torch.set_num_threads(1)
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(2, world // 2),
                      mesh_dim_names=("data", "model"))
    res = {}
    for name, arch, over in CASES:
        cfg = case_cfg(arch, over)
        for steps in (1, 2):
            rules.reset_calls()
            outputs = []
            with recorded_losses(outputs):
                r = train(cfg, steps=steps, mesh=mesh, **TRAIN)
            leaves = dict(_paths(r.pop("params")))
            r["outputs"] = outputs
            r["calls"] = rules.calls["shard_constraint"]
            r["local_shapes"] = {p: tuple(t.to_local().shape)
                                 for p, t in leaves.items()}
            r["params"] = {p: t.full_tensor() for p, t in leaves.items()}
            res[f"{name}/{steps}"] = r
    for name, arch, over in CASES + (DP_CASE,):
        for form in ("graphed", "bare"):
            with built_steps(bare=form == "bare") as built:
                r = train(case_cfg(arch, over), steps=2, mesh=mesh,
                          noise=case_noise(name), **TRAIN)
            r["step_type"] = [type(s).__name__ for s in built]
            r["params"] = {p: t.full_tensor()
                           for p, t in _paths(r.pop("params"))}
            res[f"{name}/{form}"] = r
    for name, arch, over in CASES:
        cfg = case_cfg(arch, over)
        with built_steps(functional=True) as built:
            r = train(cfg, steps=2, mesh=mesh, **TRAIN)
        leaves = dict(_paths(r.pop("params")))
        r["step_type"] = [type(s).__name__ for s in built]
        r["placements"] = {p: _placement(t) for p, t in leaves.items()}
        r["rule_placements"] = _rule_placements(cfg, mesh)
        r["params"] = {p: t.full_tensor() for p, t in leaves.items()}
        res[f"{name}/functional"] = r
    ck = os.path.join(os.path.dirname(out), "ck")
    for name, arch, over in RESUME_CASES:
        for part, kw in (("saved", dict(steps=RESUME_AT)),
                         ("resumed", dict(steps=2 * RESUME_AT))):
            with recorded_losses() as losses:
                if part == "saved":
                    r = train(case_cfg(arch, over), mesh=mesh,
                              noise=case_noise(name),
                              checkpoint_path=f"{ck}_{name}", **kw, **TRAIN)
                else:
                    r = train(mesh=mesh, resume=f"{ck}_{name}",
                              checkpoint_path=f"{ck}_{name}_resumed", **kw,
                              **TRAIN)
            leaves = dict(_paths(r.pop("params")))
            r["losses"] = losses
            r["placements"] = {p: _placement(t) for p, t in leaves.items()}
            r["params"] = {p: t.full_tensor() for p, t in leaves.items()}
            res[f"{name}/{part}"] = r
        with recorded_losses() as losses:
            r = train(case_cfg(arch, over), steps=2 * RESUME_AT, mesh=mesh,
                      noise=case_noise(name),
                      checkpoint_path=f"{ck}_{name}_straight", **TRAIN)
        r["losses"] = losses
        r["params"] = {p: t.full_tensor() for p, t in _paths(r.pop("params"))}
        res[f"{name}/straight"] = r
    with recorded_comms(mesh) as recs:
        train(case_cfg(*CASES[0][1:]), steps=1, mesh=mesh, **TRAIN)
    res["comms"] = comms.summary(recs[0])
    res["signature"] = _signatures(mesh)
    try:
        make_production_mesh(device="cpu")
        res["production_mesh"] = "built"
    except ValueError as e:
        res["production_mesh"] = str(e)
    if rank == 0:
        torch.save(res, out)
    dist.barrier()
    dist.destroy_process_group()


def _placement(t):
    return tuple(repr(p) for p in t.placements)


def _rule_placements(cfg, mesh):
    """Each parameter's placement by ``PARAM_RULES`` on ``mesh``."""
    from repro_torch.models import model_api
    from repro_torch.sharding import rules
    specs = model_api.build_model(cfg, max_seq=TRAIN["seq"]).param_specs
    out = {}
    for path, s in _paths(specs):
        logical = s.logical or (None,) * len(s.shape)
        _, pl = rules.named_sharding(mesh, s.shape, logical, rules.PARAM_RULES)
        out[path] = tuple(repr(p) for p in pl)
    return out


@contextlib.contextmanager
def recorded_losses(outputs=None):
    """Each step's loss (a float) of the steps ``Federation.sync_step``
    builds inside, in order, in the yielded list; with ``outputs`` (a
    list), each step's ``StepOutput`` (its losses and logged gradient
    norms) appended to it as well, as floats by field."""
    from repro_torch.federation import session
    from repro_torch.launch.train import _scalar
    inner, losses = session.Federation.sync_step, []

    def sync_step(fed, optimizer, **kw):
        step = inner(fed, optimizer, **kw)

        def recorded(*args):
            out = step(*args)
            losses.append(_scalar(out[2].loss))
            if outputs is not None:
                outputs.append({f.name: _scalar(getattr(out[2], f.name))
                                for f in dataclasses.fields(out[2])})
            return out
        return recorded
    session.Federation.sync_step = sync_step
    try:
        yield losses
    finally:
        session.Federation.sync_step = inner


@contextlib.contextmanager
def recorded_comms(mesh):
    """The collectives of each functional eager step (``fed.sync_step(opt)``)
    that ``Federation.sync_step`` builds inside, each step's
    ``CommRecorder`` records a list in the yielded list; DTensor's
    Shard(i) -> Shard(j) redistributes run as NCCL runs them, one
    all-to-all (``nccl_alltoall``: gloo has it; DTensor's CPU fallback is
    an all-gather)."""
    from repro_torch.federation import session
    from repro_torch.utils.comms import CommRecorder, nccl_alltoall
    recs = []
    with built_steps(functional=True):
        inner = session.Federation.sync_step

        def sync_step(fed, optimizer, **kw):
            step = inner(fed, optimizer, **kw)

            def recorded(*args):
                with CommRecorder(mesh) as rec, nccl_alltoall():
                    out = step(*args)
                recs.append(rec.records)
                return out
            return recorded
        session.Federation.sync_step = sync_step
        try:
            yield recs
        finally:
            session.Federation.sync_step = inner


def _signatures(mesh):
    """``graphs.signature`` of (8, 4) f32 DTensors placed Shard(0),
    Replicate() and Shard(0) on ``mesh`` (their reprs, and whether the
    first equals each other), ``copy_into``'s refusal of a Shard(0)
    buffer refilled from a replicated one, and a zeroed Shard(0) buffer
    refilled from a Shard(0) tensor (its full value)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch import graphs
    from repro_torch.core.draws import copy_into
    x = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    placed = [distribute_tensor(x, mesh, [pl, Replicate()],
                                src_data_rank=None)
              for pl in (Shard(0), Replicate(), Shard(0))]
    keys = [graphs.signature({"batch": t}) for t in placed]
    out = {"keys": [repr(k) for k in keys],
           "shard_vs_replicate": keys[0] == keys[1],
           "shard_vs_shard": keys[0] == keys[2]}
    try:
        copy_into(placed[0], placed[1])
    except ValueError as e:
        out["refused"] = str(e)
    buf = placed[2].clone()
    buf.zero_()
    copy_into(buf, placed[0])
    out["copied"] = buf.full_tensor()
    return out


def _join_fake(world):
    from repro_torch.launch.dryrun import fake_group
    fake_group(world)


def placements_dump():
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch import configs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model_api
    from repro_torch.sharding import rules
    out = {}
    for label, world in (("16x16", 256), ("2x16x16", 512), ("2x2", 4)):
        _join_fake(world)
        if world == 4:
            mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                              mesh_dim_names=("data", "model"))
        else:
            mesh = make_production_mesh(multi_pod=world == 512,
                                        device="cpu")
        for arch in configs.list_archs():
            specs = model_api.build_model(configs.get_config(arch),
                                          max_seq=64).param_specs
            for rule_name in ("PARAM_RULES", "PARAM_RULES_NO_FSDP"):
                rule = getattr(rules, rule_name)
                for path, s in _paths(specs):
                    logical = s.logical or (None,) * len(s.shape)
                    m, pl = rules.named_sharding(mesh, s.shape, logical,
                                                 rule)
                    assert m is mesh
                    got = rules.placements(
                        mesh, rules.resolve_spec(mesh, s.shape, logical,
                                                 rule))
                    assert got == pl
                    out[f"{label}|{arch}|{rule_name}|{path}"] = [
                        repr(p) for p in pl]
    return out


def comms_dump():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.utils import comms
    _join_fake(256)
    mesh = make_production_mesh(device="cpu")
    fake = FakeTensorMode()
    with fake:
        x = torch.empty(64, 128, dtype=torch.bfloat16)
    cases = {
        # (from, to): 64 x 128 bf16 = 16384 bytes whole
        "gather_model": ([Replicate(), Shard(1)], [Replicate(), Replicate()]),
        "reduce_data": ([Partial(), Replicate()], [Replicate(), Replicate()]),
        "scatter_model": ([Replicate(), Partial()], [Replicate(), Shard(0)]),
    }
    out = {}
    for name, (src, dst) in cases.items():
        d = distribute_tensor(x, mesh, [Replicate(), Replicate()],
                              src_data_rank=None)
        with implicit_replication():
            d = d.redistribute(mesh, src) if "Partial" not in repr(src) \
                else type(d).from_local(d.to_local(), mesh, src)
        rec = comms.CommRecorder(mesh)
        with rec:
            d.redistribute(mesh, dst)
        out[name] = {"records": [[r.kind, r.operand_bytes, r.output_bytes,
                                  r.axis] for r in rec.records],
                     "by_kind": comms.collective_bytes(rec.records),
                     "by_axis": comms.bytes_by_axis(rec.records)}
    return out


def measure_dump():
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import costmodel
    _join_fake(4)
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    from repro_torch.configs import get_config, reduced
    shape = ShapeConfig("train", TRAIN["seq"], TRAIN["batch"], "train")
    # the training CLI's cascaded step: the fused lanes
    res = costmodel.measure(case_cfg(*CASES[0][1:]), shape, mesh,
                            fused_dual=True)
    out = {"by_axis_kind": res["coll_by_axis_kind"],
           "by_kind": res["coll_by_kind"], "by_axis": res["coll_by_axis"],
           "by_site": res["coll_by_site"],
           "shapes": res["coll_shapes_by_site"]}
    # the same step in the model's own bf16, traced as measure steps
    # (placed_like_params over sgd) and through bare sgd: the bytes and
    # the operand shapes by site of each
    inner = costmodel.placed_like_params
    for name, wrap in (("bf16", inner), ("bf16_bare", lambda opt: opt)):
        costmodel.placed_like_params = wrap
        try:
            r = costmodel.measure(
                reduced(get_config(CASES[0][1]), **CASES[0][2]), shape, mesh,
                fused_dual=True)
        finally:
            costmodel.placed_like_params = inner
        out[name] = r["coll_by_site"]
        out[f"{name}_shapes"] = r["coll_shapes_by_site"]
    # the FOO step (vafl) of the f32 case
    r = costmodel.measure(case_cfg(*CASES[0][1:]), shape, mesh,
                          method="vafl")
    out["vafl"] = {"by_kind": r["coll_by_kind"], "by_site": r["coll_by_site"],
                   "shapes": r["coll_shapes_by_site"]}
    return out


def dryrun_dump():
    from repro_torch.launch import dryrun
    cfg = case_cfg("phi3-mini-3.8b", {"n_layers": DRYRUN_LAYERS})
    res = dryrun.run_one(cfg, "train_4k", trace_full=True, verbose=False)
    res["param_bytes_per_dev"] = _param_bytes()
    return res


def _param_bytes():
    """One rank's parameter bytes, summed over the local shards of the
    parameters placed as DTensors (fake tensors: shapes only)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import common, model_api
    from repro_torch.tree import tree_leaves, tree_map
    cfg = case_cfg("phi3-mini-3.8b", {"n_layers": DRYRUN_LAYERS})
    mesh = make_production_mesh(device="cpu")
    specs = model_api.build_model(
        cfg, max_seq=dryrun.get_shape("train_4k").seq_len).param_specs
    with FakeTensorMode():
        full = tree_map(lambda s: torch.empty(
            s.shape, dtype=common.torch_dtype(s.dtype)), specs)
    placed = common.place(full, specs, mesh)
    return sum(t.to_local().numel() * t.element_size()
               for t in tree_leaves(placed))


def main():
    mode = sys.argv[1]
    if mode == "train":
        rank, world, store, out = sys.argv[2:6]
        train_rank(int(rank), int(world), store, out)
        return
    kind, out = sys.argv[2:4]
    res = {"placements": placements_dump, "comms": comms_dump,
           "measure": measure_dump, "dryrun": dryrun_dump}[kind]()
    with open(out, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
