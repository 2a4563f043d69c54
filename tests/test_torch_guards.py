"""Guards of the port's package rules: it imports neither JAX nor the JAX
package, its modules import on a machine without CUDA, ``nvcc`` or
``triton``, and its entry points run on the card unless asked for the
CPU."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "repro"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


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
