"""The port's sharding rules on DTensor meshes: ``placements`` and
``named_sharding`` against ``repro``'s ``resolve_spec`` for every
parameter leaf of every registry arch under both parameter rule sets on
the (16, 16), (2, 16, 16) and (2, 2) meshes (a fake process group in a
child process, ``tests/_torch_mesh_child.py fake placements``), and
``shard_constraint``'s identity with no mesh."""
import json
import os
import pathlib
import subprocess
import sys
import types

import pytest
import torch

from repro import configs as j_configs
from repro.models import model_api as j_model_api
from repro.sharding import rules as j_rules
from repro_torch.sharding import rules

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHILD = pathlib.Path(__file__).with_name("_torch_mesh_child.py")
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join(
    [str(ROOT / "src"), str(ROOT / "tests")]))
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}}


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def test_without_a_mesh_shard_constraint_returns_its_operand():
    x = torch.ones(4, 8, 16)
    rules.reset_calls()
    assert rules.current_mesh() is None
    assert rules.shard_constraint(x, ("batch", None, "embed_act")) is x
    with rules.use_mesh(object()):
        # a plain tensor under a mesh is not placed: returned as it is
        assert rules.shard_constraint(x, ("batch", None, None)) is x
    assert rules.current_mesh() is None
    assert rules.calls["shard_constraint"] == 0


@pytest.fixture(scope="module")
def fake_placements(tmp_path_factory):
    out = tmp_path_factory.mktemp("fake") / "placements.json"
    r = subprocess.run([sys.executable, str(CHILD), "fake", "placements",
                        str(out)], env=ENV, capture_output=True, text=True,
                       timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("label", list(MESHES))
def test_placements_are_repros_specs_on_every_mesh(fake_placements, label):
    axes = MESHES[label]
    mesh = types.SimpleNamespace(shape=axes)
    n = 0
    for arch in j_configs.list_archs():
        specs = dict(_paths(j_model_api.build_model(
            j_configs.get_config(arch), max_seq=64).param_specs))
        for rule_name in ("PARAM_RULES", "PARAM_RULES_NO_FSDP"):
            for path, s in specs.items():
                logical = s.logical if s.logical else (None,) * len(s.shape)
                spec = j_rules.resolve_spec(mesh, s.shape, logical,
                                            getattr(j_rules, rule_name))
                want = []
                for a in axes:
                    dims = [d for d, e in enumerate(tuple(spec))
                            if e == a or (isinstance(e, tuple) and a in e)]
                    want.append(f"Shard(dim={dims[0]})" if dims
                                else "Replicate()")
                got = fake_placements[f"{label}|{arch}|{rule_name}|{path}"]
                assert got == want, (label, arch, rule_name, path)
                n += 1
    assert n > 400
