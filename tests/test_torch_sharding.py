"""The port's sharding rules (``repro_torch.sharding.rules``) against
``repro``'s: the same spec for every parameter leaf of all 10 registry
architectures under ``PARAM_RULES`` and ``PARAM_RULES_NO_FSDP``, and for
every decode-cache leaf under ``ACT_RULES``, on the production meshes'
axis sizes ((16, 16) and (2, 16, 16)), read from a ``{name: size}``
mapping rather than 256 processes; and ``repro``'s own rule cases
(``tests/test_sharding.py``) as one parametrised test."""
import types

import pytest

from repro import configs as j_configs
from repro.models import model_api as j_model_api
from repro.sharding import rules as j_rules
from repro_torch import configs
from repro_torch.models import model_api
from repro_torch.models.common import ParamSpec
from repro_torch.sharding import rules

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
RULE_SETS = ("PARAM_RULES", "PARAM_RULES_NO_FSDP")


def _specs(tree, path=""):
    """(path, leaf) of every ParamSpec-like leaf, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _specs(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _specs(v, f"{path}/{i}")
    else:
        yield path, tree


def _logical(spec):
    return spec.logical if spec.logical else (None,) * len(spec.shape)


def _check(ours, theirs, rule_names):
    ours, theirs = list(_specs(ours)), list(_specs(theirs))
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    n = 0
    for (path, a), (_, b) in zip(ours, theirs):
        assert isinstance(a, ParamSpec)
        assert (tuple(a.shape), _logical(a)) == (tuple(b.shape),
                                                  _logical(b)), path
        for mesh in MESHES.values():
            fake = types.SimpleNamespace(shape=mesh)
            for name in rule_names:
                got = rules.resolve_spec(mesh, a.shape, _logical(a),
                                         getattr(rules, name))
                want = j_rules.resolve_spec(fake, b.shape, _logical(b),
                                            getattr(j_rules, name))
                assert got == tuple(want), (path, name, mesh)
                n += 1
    return n


@pytest.mark.parametrize("arch", sorted(j_configs.ARCH_REGISTRY))
def test_param_and_cache_specs_resolve_as_repro(arch):
    cfg, jcfg = configs.get_config(arch), j_configs.get_config(arch)
    n = _check(model_api.build_model(cfg, max_seq=256).param_specs,
               j_model_api.build_model(jcfg, max_seq=256).param_specs,
               RULE_SETS)
    assert n > 0
    # decode caches: a batch of 1 (the sequence dim takes the data axis
    # too) and of 256 (the batch takes it)
    for batch in (1, 256):
        assert _check(model_api.build_cache_specs(cfg, batch, 4096),
                      j_model_api.build_cache_specs(jcfg, batch, 4096),
                      ("ACT_RULES",)) > 0


def test_rule_tables_equal():
    for name in ("PARAM_RULES", "PARAM_RULES_NO_FSDP", "ACT_RULES"):
        assert getattr(rules, name).table == getattr(j_rules, name).table


R = rules.Rules
# repro's tests/test_sharding.py cases on its (2, 2) ("data", "model")
# mesh: (shape, logical names, rules, expected spec)
RULE_CASES = {
    "divisible_dims_shard": ((8, 6), ("batch", "ffn"), R({
        "batch": ("data",), "ffn": ("model",)}), ("data", "model")),
    "indivisible_dim_replicates": ((7, 6), ("batch", "ffn"), R({
        "batch": ("data",), "ffn": ("model",)}), (None, "model")),
    "taken_axis_not_reused": ((8, 6), ("heads", "ffn"), R({
        "heads": ("model",), "ffn": ("model",)}), ("model",)),
    "missing_pod_axis_degrades": ((8,), ("batch",), R({
        "batch": (("pod", "data"),)}), ("data",)),
    "candidate_priority_order": ((16,), ("cache_seq",), R({
        "cache_seq": (("data", "model"), "model")}), (("data", "model"),)),
    "candidate_priority_order_taken": ((16, 16), ("batch", "cache_seq"), R({
        "batch": ("data",), "cache_seq": (("data", "model"), "model")}),
        ("data", "model")),
    "unknown_name_replicates": ((8, 6), ("nope", None), R({}), ()),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES) + [
    "param_rules_cover_model_families", "act_rules_cache_names_known",
    "device_mesh_like"])
def test_rules_cases(case):
    mesh = {"data": 2, "model": 2}
    if case in RULE_CASES:
        shape, logical, table, want = RULE_CASES[case]
        assert rules.resolve_spec(mesh, shape, logical, table) == want
        fake = types.SimpleNamespace(shape=mesh)
        assert tuple(j_rules.resolve_spec(
            fake, shape, logical, j_rules.Rules(table.table))) == want
    elif case == "param_rules_cover_model_families":
        used = set()
        for arch in ("deepseek-v3-671b", "zamba2-2.7b", "rwkv6-7b",
                     "whisper-medium", "internvl2-26b"):
            m = model_api.build_model(configs.get_config(arch), max_seq=128)
            for _, leaf in _specs(m.param_specs):
                used.update(n for n in leaf.logical if n is not None)
        assert not {n for n in used if n not in rules.PARAM_RULES.table}
    elif case == "act_rules_cache_names_known":
        for name in ("batch", "seq_act", "cache_batch", "cache_seq",
                     "cache_heads", "heads_act", "ffn_act", "vocab_act"):
            assert name in rules.ACT_RULES.table
    else:
        # a DeviceMesh is read through its mesh_dim_names and shape
        dm = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                   shape=(2, 2))
        assert rules.mesh_axes(dm) == mesh
        with pytest.raises(ValueError, match="named axes"):
            rules.mesh_axes(types.SimpleNamespace(shape=(2,)))
        with pytest.raises(ValueError, match="rank"):
            rules.resolve_spec(mesh, (8, 6), ("batch",), rules.ACT_RULES)
