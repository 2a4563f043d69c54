"""The port's examples (``examples_torch/``) on the CPU, each at the JAX
example's own settings and held to the JAX example's own outcome checks:
the quickstart's accuracy and gradient-free wire, the adapters' finite
losses, block staleness and spent ε, the attack demo's FOO/ZOO split,
and the paper experiments' CSVs (at 20 steps a cell, into a temporary
directory) with the JAX example's headers and cells. The LM examples and
the no-card refusal are ``test_torch_examples_lm.py``."""
import csv
import importlib.util
import pathlib

import numpy as np

from test_torch_support import torch_threads

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load(name, root="examples_torch"):
    """An example file as a module (its ``main`` not run)."""
    path = ROOT / root / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{root}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_prints_the_four_lines_and_passes(capsys):
    with torch_threads(1):
        load("quickstart").main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0].strip() for ln in lines] == [
        "final loss", "train accuracy", "wire bytes total",
        "gradients on wire"]
    assert float(lines[1].split(":")[1]) > 0.9
    assert lines[3].split(":")[1].strip() == "False"


def test_async_adapters_passes_its_checks(capsys):
    with torch_threads(1):
        load("async_adapters").main(["--device", "cpu"])
    out = capsys.readouterr().out
    for label in ("tabular  block=1", "swiglu   block=1",
                  "tabular  block=3", "tabular  dp"):
        assert label in out


def test_attack_demo_reads_labels_off_foo_and_not_off_zoo():
    with torch_threads(1):
        labels, feat = load("attack_demo").main(["--device", "cpu"])
    assert labels["foo"].curious_client_acc == 1.0
    assert labels["zoo"].eavesdropper_acc < 0.15
    assert np.isfinite(feat.mse_black_box)
    assert feat.mse_with_model_access < feat.mse_black_box


def test_paper_experiments_write_the_jax_examples_csvs(tmp_path):
    mod = load("paper_experiments")
    mod.OUT = str(tmp_path)
    with torch_threads(1):
        mod.main(["--steps", "20", "--device", "cpu"])
    jax_lrs = {"split": 0.05, "vafl": 0.05, "cascaded": 0.05,
               "zoo-vfl": 0.001, "syn-zoo": 0.001}
    assert mod.LRS == jax_lrs
    want = ([("clients", str(m), meth) for m in (4, 6, 8)
             for meth in jax_lrs]
            + [("width", str(w), meth) for w in (128, 256, 512)
               for meth in ("vafl", "zoo-vfl", "cascaded")])
    with open(tmp_path / "paper_table2_accuracy.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["sweep", "value", "method", "train_acc"]
    assert [tuple(r[:3]) for r in rows[1:]] == want
    assert all(0.0 <= float(r[3]) <= 1.0 for r in rows[1:])
    with open(tmp_path / "paper_fig3_curves.csv") as f:
        curves = list(csv.reader(f))
    assert curves[0] == ["cell", "step", "loss"]
    # 24 cells, steps 0 and 10 of each 20-step curve
    assert len(curves) == 1 + 24 * 2
    assert all(np.isfinite(float(r[2])) for r in curves[1:])
