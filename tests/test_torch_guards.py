"""Guards of the port's package rules: it imports neither JAX nor the JAX
package, its modules import on a machine without CUDA, ``nvcc`` or
``triton``, and its entry points run on the card unless asked for the
CPU."""
import ast
import contextlib
import os
import pathlib
import shutil
import subprocess
import sys

import types

import pytest
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm import ref as rms_ref
from repro_torch.kernels.ssd_chunk import kernel as ssd_kernel
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk import ref as ssd_ref
from repro_torch.kernels.zoo_dual_matmul import kernel as zoo_kernel
from repro_torch.kernels.zoo_dual_matmul import ops as zoo_ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "repro"}
# modules of each slice that the import checks must reach
SLICE_MODULES = ("repro_torch.kernels.zoo_dual_matmul.ops",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.rmsnorm.ops",
                 "repro_torch.kernels.ssd_chunk.ops",
                 "repro_torch.kernels.ssd_chunk.kernel",
                 "repro_torch.kernels.ssd_chunk.ref",
                 "repro_torch.models.ssm", "repro_torch.models.transformer",
                 "repro_torch.launch.serve",
                 "repro_torch.kernels._plain_grad",
                 "repro_torch.optim.optimizers", "repro_torch.optim.schedule",
                 "repro_torch.data.pipeline", "repro_torch.core.cascade",
                 "repro_torch.checkpoint.io",
                 "repro_torch.federation.parties",
                 "repro_torch.launch.train",
                 "repro_torch.federation.paging",
                 "repro_torch.federation.scheduler",
                 "repro_torch.graphs",
                 "repro_torch.models.rwkv", "repro_torch.models.moe",
                 "repro_torch.core.attacks",
                 "repro_torch.sharding.rules", "repro_torch.launch.mesh",
                 "repro_torch.analysis.findings",
                 "repro_torch.analysis.astutil",
                 "repro_torch.analysis.boundary",
                 "repro_torch.analysis.jitlint",
                 "repro_torch.analysis.runtime", "repro_torch.analysis.cli")


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples_torch").glob("*.py")))


def test_every_module_imports_with_jax_and_repro_blocked():
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(k == "triton" or k.startswith("triton.") for k in sys.modules)
from repro_torch.kernels import _build
assert not _build._LIBS          # importing builds and loads no kernel
print(" ".join(names))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 20 and set(SLICE_MODULES) <= set(names)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_nothing_of_repro(path):
    src = path.read_text()
    assert "import jax" not in src
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            roots = {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots = {(node.module or "").split(".")[0]}
        else:
            continue
        assert not roots & FORBIDDEN_ROOTS, (path, ast.dump(node))


def test_entry_point_runs_on_the_card_unless_asked_for_the_cpu():
    from repro_torch.configs.paper_mlp import PaperMLPConfig
    from repro_torch.federation import Federation
    assert resolve_device("cpu") == torch.device("cpu")
    fed = Federation.build(PaperMLPConfig(), device="cpu")
    assert fed.device.type == "cpu"
    if torch.cuda.is_available():
        assert Federation.build(PaperMLPConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Federation.build(PaperMLPConfig())
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")


def test_worker_restart_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """A client party restarted from its checkpoint loads its row onto the
    card by default (raising without one) and onto the CPU only when
    asked."""
    from repro_torch.checkpoint.io import save_checkpoint
    from repro_torch.configs.base import VFLConfig
    from repro_torch.configs.paper_mlp import PaperMLPConfig
    from repro_torch.core.adapters import tabular_adapter
    from repro_torch.models.common import materialize
    from repro_torch.models.tabular import param_specs
    from repro_torch.wire import ClientWorker, LoopbackBackend
    cfg = PaperMLPConfig(n_features=8, n_classes=2, n_clients=2,
                         client_embed=4, server_embed=8)
    params = materialize(param_specs(cfg), torch.Generator().manual_seed(0))
    row = {k: v[1] for k, v in params["clients"].items()}
    save_checkpoint(str(tmp_path / "client_01"), row)
    args = (tabular_adapter(cfg), VFLConfig(zoo_queries=1), str(tmp_path), 1,
            torch.zeros((16, 4)), LoopbackBackend.pair()[1])
    worker = ClientWorker.from_checkpoint(*args, device="cpu")
    assert worker.device.type == "cpu"
    if torch.cuda.is_available():
        assert ClientWorker.from_checkpoint(*args).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ClientWorker.from_checkpoint(*args)


def test_kernel_build_location_and_nvcc():
    """The build goes to the git-ignored build/ directory under a name
    that changes with the source, and needs the CUDA toolkit's nvcc."""
    lib = _build.library_path("zoo_dual_matmul")
    assert lib.parent == ROOT / "build" / "repro_torch_kernels"
    assert lib.name.startswith("libzoo_dual_matmul-")
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        assert _build.nvcc_path().endswith("nvcc")
    else:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.nvcc_path()


def test_every_module_imports_first_in_a_fresh_process():
    """Each module imports as the first module of the package (no import
    cycle: ``import repro_torch.models.common`` on its own used to fail
    through core/__init__ -> adapters -> models.common)."""
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    for k in [k for k in sys.modules if k.startswith("repro_torch")]:
        del sys.modules[k]
    importlib.import_module(name)
print(" ".join(names))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 40 and set(SLICE_MODULES) <= set(names)


def _fake_card(monkeypatch, tmp_path, ops, kernel):
    """Make a wrapper take its CUDA branch with the kernel library missing
    and ``nvcc`` absent: it must raise, never fall back to plain."""
    monkeypatch.setattr(ops, "_validate", lambda *a: True)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: types.SimpleNamespace(
                            multi_processor_count=132))

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    kernel._launcher.cache_clear()


@pytest.mark.parametrize("which", ["flash_attention", "flash_bh", "rmsnorm",
                                   "zoo_dual_matmul", "ssd_chunk",
                                   "ssd_chunk_bshp"])
def test_wrappers_raise_on_the_card_without_their_build(monkeypatch,
                                                        tmp_path, which):
    x = torch.ones(2, 4, 2, 16)
    calls = {
        "flash_attention": (flash_ops, flash_kernel,
                            lambda: flash_ops.flash_attention_bshd(x, x, x)),
        "flash_bh": (flash_ops, flash_kernel,
                     lambda: flash_ops.flash_attention(x[0], x[0], x[0])),
        "rmsnorm": (rms_ops, rms_kernel,
                    lambda: rms_ops.rmsnorm(x[0, 0], torch.ones(16))),
        "zoo_dual_matmul": (zoo_ops, zoo_kernel,
                            lambda: zoo_ops.zoo_dual_matmul_stacked(
                                x[0], x[0, :, :, :4], x[:1, :, :, :4], 1e-3)),
        "ssd_chunk": (ssd_ops, ssd_kernel,
                      lambda: ssd_ops.ssd_chunk(
                          x[0], x[0, ..., 0], x[0, ..., 0], x[0], x[0],
                          chunk=2)),
        "ssd_chunk_bshp": (ssd_ops, ssd_kernel,
                           lambda: ssd_ops.ssd_chunk_bshp(
                               x, x[..., 0], x[..., 0], x[:, :, 0],
                               x[:, :, 0], chunk=2, state0=x)),
    }
    ops, kernel, call = calls[which]
    before = dict(ops.launches)
    _fake_card(monkeypatch, tmp_path, ops, kernel)
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            call()
    finally:
        kernel._launcher.cache_clear()
    assert ops.launches == before


def test_serve_runs_on_the_card_unless_asked_for_the_cpu():
    from repro_torch.launch.serve import serve
    if torch.cuda.is_available():
        pytest.skip("a card is present: serve() would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve("phi3-mini-3.8b", n_clients=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve("phi3-mini-3.8b", n_clients=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve("phi3-mini-3.8b", n_clients=2, continuous=True)


def test_continuous_scheduler_lives_on_the_sessions_device():
    """``Federation.serve`` puts every tensor of the serve plane on the
    session's device: the card unless the session was built for the CPU."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.federation import Federation
    from repro_torch.tree import tree_leaves
    cfg = reduced(get_config("phi3-mini-3.8b"), n_layers=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Federation.build(cfg, seq_len=8)
    fed = Federation.build(cfg, seq_len=8, device="cpu")
    params = fed.init_params(torch.Generator().manual_seed(0))
    srv = fed.serve(params, max_batch=2)
    state = [srv._t_st, srv._gen_pos_st, srv._rem_st, srv._gen_buf_st,
             *tree_leaves(srv._caches_st)]
    assert srv.device == fed.device == torch.device("cpu")
    assert {t.device for t in state} == {fed.device}


# ------------------------------------------------------ differentiability --

def _fake_launches(monkeypatch):
    """Every wrapper takes its CUDA branch on CPU tensors, and each kernel
    launch writes its plain version's output instead."""
    def flash(q, k, v, o, *, causal, window, q_offset):
        o.copy_(flash_ref.flash_attention_bshd_ref(
            q, k, v, causal=causal, window=window, q_offset=q_offset))

    def rms(x, scale, y, eps, way, shape=(0, 0, 0)):
        y.copy_(rms_ref.rmsnorm_ref(x, scale, eps))

    def ssd(xh, a, dt, bm, cm, state0, y, state_out, scratch, chunk):
        y_ref, s_ref = ssd_ref.ssd_states_ref(xh, a, dt, bm, cm, state0)
        y.copy_(y_ref.to(y.dtype) if y.ndim == 4 else y_ref[:, :, 0])
        if state_out is not None:
            state_out.copy_(s_ref)

    for ops in (flash_ops, rms_ops, ssd_ops):
        monkeypatch.setattr(ops, "_validate", lambda *a: True)
    monkeypatch.setattr(flash_kernel, "launch", flash)
    monkeypatch.setattr(rms_kernel, "launch", rms)
    monkeypatch.setattr(rms_ops, "route", lambda x, scale=None: "general")
    monkeypatch.setattr(ssd_kernel, "launch", ssd)
    monkeypatch.setattr(ssd_kernel, "scratch_bytes", lambda *a: 0)


def _operands(which, g):
    """(wrapper call, plain call, operands) of each differentiable kernel,
    at small shapes in f32."""
    def rnd(*shape):
        return torch.randn(*shape, generator=g)
    if which == "flash_attention":
        q, k, v = rnd(2, 8, 4, 16), rnd(2, 8, 2, 16), rnd(2, 8, 2, 16)
        kw = dict(causal=True, window=5)
        return (lambda q, k, v: flash_ops.flash_attention_bshd(q, k, v, **kw),
                lambda q, k, v: flash_ref.flash_attention_bshd_ref(
                    q, k, v, **kw), [q, k, v])
    if which == "rmsnorm":
        x, scale = rnd(6, 32), 1.0 + 0.1 * rnd(32)
        return (lambda x, s: rms_ops.rmsnorm(x, s),
                lambda x, s: rms_ref.rmsnorm_ref(x, s), [x, scale])
    B, S, H, P, N = 2, 8, 3, 4, 5
    ops_args = [rnd(B, S, H, P), torch.sigmoid(rnd(B, S, H)),
                torch.nn.functional.softplus(rnd(B, S, H)), rnd(B, S, N),
                rnd(B, S, N)]
    return (lambda *t: ssd_ops.ssd_chunk_bshp(*t, chunk=4),
            lambda *t: ssd_ref.ssd_chunked_ref(*t, 4), ops_args)


def _first(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("which", ["flash_attention", "rmsnorm",
                                   "ssd_chunk"])
def test_wrappers_differentiate_through_their_plain_version(monkeypatch,
                                                            which):
    """On the card a wrapper whose operand requires grad returns an output
    with a grad_fn (the kernel's forward, the plain version's autograd
    backward), and its gradients equal autograd through the plain
    version; with grad off it launches the kernel outside the Function."""
    _fake_launches(monkeypatch)
    ops = {"flash_attention": flash_ops, "rmsnorm": rms_ops,
           "ssd_chunk": ssd_ops}[which]
    call, plain, operands = _operands(which, torch.Generator().manual_seed(0))
    fn = {"flash_attention": flash_ops.FlashAttentionFn,
          "rmsnorm": rms_ops.RMSNormFn, "ssd_chunk": ssd_ops.SSDChunkFn}[which]
    entered = []
    apply = fn.apply
    monkeypatch.setattr(fn, "apply", lambda *a: entered.append(1) or apply(*a))

    name = next(iter(ops.launches))
    before = ops.launches[name]
    with torch.no_grad():
        out = _first(call(*[t.requires_grad_(True) for t in operands]))
    assert out.grad_fn is None and not entered
    assert ops.launches[name] == before + 1
    torch.testing.assert_close(out, _first(plain(*operands)).detach())

    leaves = [t.detach().requires_grad_(True) for t in operands]
    got = _first(call(*leaves))
    assert got.grad_fn is not None and entered == [1]
    assert ops.launches[name] == before + 2
    weight = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
    grads = torch.autograd.grad((got * weight).sum(), leaves)
    ref_leaves = [t.detach().requires_grad_(True) for t in operands]
    want = torch.autograd.grad((_first(plain(*ref_leaves)) * weight).sum(),
                               ref_leaves)
    for g_got, g_want in zip(grads, want):
        torch.testing.assert_close(g_got, g_want, rtol=1e-5, atol=1e-6)

    # only the operands that require grad get a gradient
    part = [t.detach().requires_grad_(i == 0) for i, t in enumerate(operands)]
    (g0,) = torch.autograd.grad((_first(call(*part)) * weight).sum(),
                                part[:1])
    torch.testing.assert_close(g0, want[0], rtol=1e-5, atol=1e-6)


def test_zoo_kernel_refuses_operands_that_require_grad(monkeypatch,
                                                       tmp_path):
    """The ZOO fan-out has no backward: on the card, an operand requiring
    grad raises before any launch instead of losing its gradient."""
    x = torch.ones(2, 4, 8)
    w = torch.ones(2, 8, 4, requires_grad=True)
    us = torch.ones(2, 1, 8, 4)
    before = dict(zoo_ops.launches)
    _fake_card(monkeypatch, tmp_path, zoo_ops, zoo_kernel)
    try:
        with pytest.raises(ValueError, match="no backward"):
            zoo_ops.zoo_dual_matmul_stacked(x, w, us, 1e-3)
        with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc"):
            zoo_ops.zoo_dual_matmul_stacked(x, w, us, 1e-3)
    finally:
        zoo_kernel._launcher.cache_clear()
    assert zoo_ops.launches == before
