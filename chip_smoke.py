"""Smoke run of the PyTorch port (``repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. device and build: the card's name and power limit, and the hand-written
   kernels built from ``src/repro_torch/kernels/*/csrc`` by ``nvcc`` (their
   ``-Xptxas -v`` register/spill report);
2. every kernel entry point against its plain PyTorch version on the card,
   at the main path's shapes and a ragged one, f32 (TF32 off, 1e-4) and
   bf16 (1.5e-1), then its time (CUDA graph of many launches), the plain
   version's, one PyTorch library call's, and the bound from its bytes and
   operations;
3. the main path at the paper's width: cascaded hybrid VFL (ZOO clients
   through the fused kernel, FOO server) over an MNIST-sized stand-in, 500
   rounds, with the kernel's launch count read around the run; a profile
   of 50 rounds; agreement with the plain lanes on the CPU on the same
   draws; the other four methods and a q = 4, block = 3 cascaded run; the
   quickstart's accuracy;
4. a ``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.

It needs one card, and builds into ``build/`` at first use.
"""
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"

# published peaks of one H100 SXM (dense): f32 on the CUDA cores, bf16 on
# the tensor cores, HBM3 bandwidth
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 1.5e-1}
MU = 1e-3
# the main path's fan-out shapes: one activated client (R), a batch of 64
# rows (M), 784 / 4 features (K), client_embed 128 (N), q lanes
MAIN = dict(R=1, M=64, K=196, N=128, q=1)
CHECK_SHAPES = [dict(R=1, M=64, K=196, N=128, q=1),
                dict(R=3, M=64, K=196, N=128, q=1),
                dict(R=1, M=64, K=196, N=128, q=4),
                dict(R=3, M=64, K=196, N=128, q=4),
                dict(R=2, M=50, K=33, N=70, q=3)]
# per-method learning rates: benchmarks/run.py's for the first-order
# servers; its 1e-3 for the ZOO servers (zoo-vfl, syn-zoo) is tuned for a
# 64-feature model and diverges at 784 features, where 1e-4 trains
LRS = {"cascaded": 0.05, "vafl": 0.05, "split": 0.05, "zoo-vfl": 1e-4,
       "syn-zoo": 1e-4}
KERNELS = {
    "zoo_dual_matmul_stacked_bias_relu":
        "src/repro/kernels/zoo_dual_matmul/kernel.py:121",
    "zoo_dual_matmul_stacked":
        "src/repro/kernels/zoo_dual_matmul/kernel.py:165",
    "zoo_dual_matmul": "src/repro/kernels/zoo_dual_matmul/kernel.py:38",
}
SOURCE = "src/repro_torch/kernels/zoo_dual_matmul/csrc/zoo_dual_matmul.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, n: int = 200) -> float:
    """Device time per call: ``n`` calls captured in one CUDA graph,
    replayed between CUDA events (no host launch cost in the reading)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(5):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


def eager_ms(fn, n: int = 200) -> float:
    """Time per call issued from Python (host launch cost included)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def kernel_inputs(R, M, K, N, q, dtype, seed=0):
    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(R, M, K, device="cuda", generator=g).to(dtype)
    w = (torch.randn(R, K, N, device="cuda", generator=g)
         / K ** 0.5).to(dtype)
    us = torch.randn(R, q, K, N, device="cuda", generator=g).to(dtype)
    us = us / us.float().square().sum((2, 3), keepdim=True).sqrt().to(dtype)
    b = torch.randn(R, N, device="cuda", generator=g) * 0.1
    ub = torch.randn(R, q, N, device="cuda", generator=g) * 0.1
    return x, w, us, b, ub


def entry_calls(ops, ref, x, w, us, b, ub):
    """name -> (kernel call, plain call) for the three entry points."""
    return {
        "zoo_dual_matmul_stacked_bias_relu": (
            lambda: ops.zoo_dual_matmul_stacked(x, w, us, MU, b=b, ub=ub),
            lambda: ref.zoo_dual_matmul_stacked_bias_relu_ref(x, w, us, b,
                                                              ub, MU)),
        "zoo_dual_matmul_stacked": (
            lambda: ops.zoo_dual_matmul_stacked(x, w, us, MU),
            lambda: ref.zoo_dual_matmul_stacked_ref(x, w, us, MU)),
        "zoo_dual_matmul": (
            lambda: ops.zoo_dual_matmul(x[0], w[0], us[0, 0], MU),
            lambda: ref.zoo_dual_matmul_ref(x[0], w[0], us[0, 0], MU)),
    }


def library_call(name, x, w, us, b, ub):
    """One PyTorch call computing the same function, its operands (the
    weight stack [W, W + μU_1..q]) formed outside the timed region."""
    if name == "zoo_dual_matmul":
        x, w, us, b, ub = x[:1], w[:1], us[:1, :1], b[:1], ub[:1, :1]
    R, M, K = x.shape
    q, N = us.shape[1], w.shape[-1]
    w_stack = torch.cat([w[:, None], w[:, None] + MU * us], 1)
    w_stack = w_stack.reshape(R * (1 + q), K, N).contiguous()
    x_rep = x[:, None].expand(R, 1 + q, M, K).reshape(R * (1 + q), M, K)
    x_rep = x_rep.contiguous()
    if name == "zoo_dual_matmul_stacked_bias_relu":
        bias = torch.cat([b[:, None], b[:, None] + MU * ub], 1)
        bias = bias.reshape(R * (1 + q), 1, N).to(x.dtype).contiguous()
        return lambda: torch.relu(torch.baddbmm(bias, x_rep, w_stack))
    return lambda: torch.bmm(x_rep, w_stack)


def bound(name, x, w, us, b, ub):
    """Least time for the work (ms): each input read once, each output
    written once, against the f32 (CUDA core) or bf16 (tensor core) peak."""
    if name == "zoo_dual_matmul":
        x, w, us = x[:1], w[:1], us[:1, :1]
    R, M, K = x.shape
    q, N = us.shape[1], w.shape[-1]
    epi = name == "zoo_dual_matmul_stacked_bias_relu"
    ins = [x, w, us] + ([b, ub] if epi else [])
    nbytes = (sum(t.numel() * t.element_size() for t in ins)
              + R * (1 + q) * M * N * x.element_size())
    ops = 2 * R * M * K * N * (1 + q) + 2 * R * q * M * N
    if epi:
        ops += 2 * R * M * N * (1 + q) + 2 * R * q * M * N
    t_ops = ops / PEAK_OPS[x.dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def check_kernels(ops, ref):
    """Phase 2: every entry point against its plain version, then times."""
    errs = {name: 0.0 for name in KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in CHECK_SHAPES:
            args = kernel_inputs(**shape, dtype=dtype)
            for name, (kern, plain) in entry_calls(ops, ref, *args).items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                err = max(float((g.float() - wn.float()).abs().max())
                          for g, wn in zip(got, want))
                ok = all(torch.allclose(g.float(), wn.float(),
                                        atol=TOL[dtype], rtol=TOL[dtype])
                         for g, wn in zip(got, want))
                log(f"check {name} {str(dtype)[6:]} {shape}: max_abs_err "
                    f"{err:.3e} (tol {TOL[dtype]}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain "
                                         f"version at {shape}, {dtype}")
                if dtype == torch.float32:
                    errs[name] = max(errs[name], err)
    args = kernel_inputs(**MAIN, dtype=torch.float32, seed=1)
    rows = {}
    for name, (kern, plain) in entry_calls(ops, ref, *args).items():
        b_ms, b_by = bound(name, *args)
        rows[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": KERNELS[name], "launches": 0,
            "max_abs_err": errs[name], "ms": graph_ms(kern),
            "plain_ms": graph_ms(plain), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": graph_ms(library_call(name, *args)),
        }
        log(f"time {name} at {MAIN} f32: kernel {rows[name]['ms']:.5f} ms "
            f"(per Python call {eager_ms(kern):.5f} ms), plain "
            f"{rows[name]['plain_ms']:.5f} ms, library "
            f"{rows[name]['library_ms']:.5f} ms, bound {b_ms:.6f} ms "
            f"({b_by})")
    return rows


def profile_rounds(fed, params, x_parts, y) -> None:
    """Where a main-path round's time goes: torch.profiler over a 50-round
    run (its set-up included), the device's busy share and its kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fed.run(params, x_parts, y)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_us(e) for e in kernels)
    if not busy:
        log("profile: the profiler saw no CUDA kernel time; device busy "
            "share not measured")
        return
    steps = fed.engine.steps
    log(f"profile, {steps} main-path rounds under torch.profiler: wall "
        f"{wall_us / steps:.1f} us per round, device busy "
        f"{busy / steps:.1f} us per round ({busy / wall_us:.2%} of wall), "
        f"{sum(e.count for e in kernels) / steps:.1f} kernel launches "
        f"per round")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        log(f"  {dev_us(e) / steps:8.2f} us/round  x{e.count / steps:5.2f}"
            f"  {e.key[:90]}")


class CpuDrawsOn:
    """A CPU ``TorchDraws`` stream handed to a run on another device, so a
    card run and a CPU run consume the same random numbers."""

    def __init__(self, seed, device):
        from repro_torch.core.draws import TorchDraws
        self.cpu, self.device = TorchDraws(seed, "cpu"), device

    def __getattr__(self, name):
        fn = getattr(self.cpu, name)

        def moved(*args):
            out = fn(*args)
            if isinstance(out, dict):
                return {k: v.to(self.device) for k, v in out.items()}
            return out.to(self.device)
        return moved


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.base import VFLConfig
    from repro_torch.configs.paper_mlp import PaperMLPConfig
    from repro_torch.core.adapters import tabular_adapter
    from repro_torch.core.async_engine import EngineConfig
    from repro_torch.data import make_classification, vertical_partition
    from repro_torch.federation import Federation
    from repro_torch.kernels import _build
    from repro_torch.kernels.zoo_dual_matmul import ops, ref
    from repro_torch.models import tabular

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    log(f"device: {kind} (count {torch.cuda.device_count()}); nvidia-smi: "
        f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"allow_tf32 = False (matmul and cuDNN)")

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if re.search(r"Compiling entry|registers|spill", line):
                log(f"  {name}: {line.strip()}")

    # ---- phase 2: kernels against their plain versions -----------------
    rows = check_kernels(ops, ref)

    # ---- phase 3: the main path at the paper's width -------------------
    cfg = PaperMLPConfig()
    X, y = make_classification(seed=0, n=60000, n_features=cfg.n_features,
                               n_classes=cfg.n_classes)
    x_parts = torch.from_numpy(vertical_partition(X, cfg.n_clients)).cuda()
    y_dev = torch.from_numpy(y).long().cuda()
    vfl = VFLConfig(mu=MU, lr_server=0.05, lr_client=0.05)
    kernel_ad = tabular_adapter(cfg, use_kernel_lanes=True)

    def build(method, steps, vfl=vfl, **kw):
        return Federation.build(
            kernel_ad if kw.get("use_lanes") else cfg, vfl,
            EngineConfig(method=method, steps=steps, batch_size=64, **kw))

    fed = build("cascaded", 500, use_lanes=True)
    params = fed.init_params(torch.Generator().manual_seed(0))
    fed_warm = build("cascaded", 20, use_lanes=True)
    fed_warm.run(params, x_parts, y_dev)               # cuBLAS/allocator warm-up

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fed.run(params, x_parts, y_dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    log(f"main path: cascaded, {cfg}, n = 60000, 500 rounds of batch 64: "
        f"{wall * 1e3 / 500:.4f} ms per round on {kind} ({card}); "
        f"kernel launches {launches}")
    losses = res.losses
    if losses.shape != (500,) or not np.isfinite(losses).all():
        raise AssertionError(f"main path losses not finite: {losses}")
    first, last = float(losses[:50].mean()), float(losses[-50:].mean())
    log(f"main path loss: first 50 mean {first:.4f}, last 50 mean "
        f"{last:.4f}; max delay {res.max_delay_seen}, mean delay "
        f"{res.mean_delay:.3f}, wire {res.wire_bytes} B")
    if not last < first:
        raise AssertionError("main path loss did not fall")
    if launches != {"zoo_dual_matmul_stacked_bias_relu": 500,
                    "zoo_dual_matmul_stacked": 0, "zoo_dual_matmul": 0}:
        raise AssertionError(f"kernel launches {launches} != one per round")
    for name in rows:
        rows[name]["launches"] = launches[name]
    profile_rounds(build("cascaded", 50, use_lanes=True), params, x_parts,
                   y_dev)

    # the same rounds on the card (kernel lanes) and on the CPU (plain
    # lanes), from the same params on one CPU draw stream. φ/μ (d/μ =
    # 2.5e7 for a sphere client here) carries f32 rounding into every
    # client step: f32 against f64 on the CPU drifts 9e-3 over 25 sphere
    # rounds but 1.2e-5 over 25 normal (φ = 1) rounds and 2e-6 over 3
    # sphere rounds. So: 25 normal rounds at repro's trajectory atol 1e-3,
    # and 3 sphere rounds at 1e-4.
    cpu_params = {k: {n: t.cpu() for n, t in v.items()}
                  for k, v in params.items()}
    sub = slice(0, 4096)
    for dist, steps, atol in (("normal", 25, 1e-3), ("sphere", 3, 1e-4)):
        v = VFLConfig(mu=MU, lr_server=0.05, lr_client=0.05, zoo_dist=dist)
        ec = EngineConfig(method="cascaded", steps=steps, batch_size=64,
                          use_lanes=True)
        gpu = Federation.build(kernel_ad, v, ec).run(
            params, x_parts[:, sub], y_dev[sub], draws=CpuDrawsOn(0, "cuda"))
        cpu = Federation.build(tabular_adapter(cfg), v, ec,
                               device="cpu").run(
            cpu_params, x_parts[:, sub].cpu(), y_dev[sub].cpu(),
            draws=CpuDrawsOn(0, "cpu"))
        gap = float(np.abs(gpu.losses - cpu.losses).max())
        log(f"card (kernel lanes) vs CPU (plain lanes), {dist}, {steps} "
            f"rounds at paper width: max loss gap {gap:.3e} (atol {atol})")
        if not gap <= atol:
            raise AssertionError(f"card and CPU trajectories differ by {gap}")

    for method in ("vafl", "zoo-vfl", "split", "syn-zoo"):
        lr = LRS[method]
        r = build(method, 50, VFLConfig(mu=MU, lr_server=lr,
                                        lr_client=lr)).run(
            params, x_parts, y_dev)
        log(f"{method}: 50 rounds, loss {r.losses[0]:.4f} -> "
            f"{r.losses[-1]:.4f}, gradients on the wire: "
            f"{r.transmits_gradients}")
        if not np.isfinite(r.losses).all():
            raise AssertionError(f"{method} losses not finite")
    before = ops.launches["zoo_dual_matmul_stacked_bias_relu"]
    r = build("cascaded", 50, VFLConfig(mu=MU, lr_server=0.05,
                                        lr_client=0.05, zoo_queries=4),
              block_size=3, use_lanes=True).run(params, x_parts, y_dev)
    blk = ops.launches["zoo_dual_matmul_stacked_bias_relu"] - before
    log(f"cascaded q=4 block=3: 50 rounds, loss {r.losses[0]:.4f} -> "
        f"{r.losses[-1]:.4f}, kernel launches {blk}")
    if not np.isfinite(r.losses).all() or blk != 50:
        raise AssertionError("q=4 block=3 run failed")

    # the quickstart's width and outcome (examples/quickstart.py)
    qcfg = PaperMLPConfig(n_features=64, n_classes=10, n_clients=4,
                          client_embed=32, server_embed=128)
    Xq, yq = make_classification(seed=0, n=2048, n_features=64,
                                 n_classes=10)
    xq = torch.from_numpy(vertical_partition(Xq, 4)).cuda()
    yq = torch.from_numpy(yq).long().cuda()
    qfed = Federation.build(tabular_adapter(qcfg, use_kernel_lanes=True),
                            vfl, EngineConfig(method="cascaded", steps=800,
                                              batch_size=64, use_lanes=True))
    qres = qfed.run(qfed.init_params(torch.Generator().manual_seed(0)), xq,
                    yq)
    acc = float(tabular.accuracy(qres.params, xq, yq))
    log(f"quickstart through the kernel lanes: acc {acc:.4f}, final loss "
        f"{qres.losses[-25:].mean():.4f}")
    if not acc > 0.9:
        raise AssertionError(f"quickstart accuracy {acc} <= 0.9")

    # ---- phase 4: the record -------------------------------------------
    log(card)
    log(json.dumps({"kernels": list(rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
