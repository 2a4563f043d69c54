"""The port's dry run (``launch/dryrun.py``, ``roofline.py``,
``costmodel.py``, ``utils/comms.py``) against the JAX package's:

* ``utils.comms``' byte conventions on ``test_substrate.py``'s HLO sample
  recast as collective records equal ``repro.utils.hlo.collective_bytes``,
  and on the records of known redistributes on a fake 256-rank group
  equal the bytes each one moves;
* ``Roofline``'s terms equal ``repro``'s once the TPU's peaks are swapped
  for the H100's (and ``repro``'s bf16 correction for 1);
* ``model_flops_for`` equals ``repro``'s for every arch and shape;
* ``run_one`` of reduced phi3 (4 layers) at ``train_4k`` on a fake
  256-rank group (a child process) returns every field of ``repro``'s
  result JSON, per-device argument bytes equal to the shards
  ``resolve_spec`` gives, and a cost fit equal to the traced 4-layer
  count: from 1 and 2 layers in FLOPs, bytes, collective bytes (by kind,
  axis and site) and output bytes, from 2 and 3 in the peak;
* the CLI refuses the JAX package's two variants the port has no
  counterpart of.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro import configs as j_configs
from repro.launch import roofline as j_rl
from repro.utils import hlo as j_hlo
from repro_torch import configs
from repro_torch.launch import roofline as rl
from repro_torch.utils import comms
from test_substrate import HLO_SAMPLE

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHILD = pathlib.Path(__file__).with_name("_torch_mesh_child.py")
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join(
    [str(ROOT / "src"), str(ROOT / "tests")]))


def _child(kind, tmp_path):
    out = tmp_path / f"{kind}.json"
    r = subprocess.run([sys.executable, str(CHILD), "fake", kind, str(out)],
                       env=ENV, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


def test_comms_conventions_equal_hlos_on_its_sample():
    records = [comms.CommRecord(kind, n, n, "data")
               for kind, n in j_hlo.parse_collectives(HLO_SAMPLE)]
    assert comms.collective_bytes(records) == j_hlo.collective_bytes(
        HLO_SAMPLE)
    assert comms.bytes_by_axis(records) == {
        "data": j_hlo.collective_bytes(HLO_SAMPLE)["total"]}


def test_comms_records_of_known_redistributes(tmp_path):
    whole = 64 * 128 * 2            # the bf16 (64, 128) tensor
    got = _child("comms", tmp_path)
    # Shard(1) over "model" (16) -> Replicate: one all-gather, received
    # bytes = the whole tensor
    assert got["gather_model"]["records"] == [
        ["all-gather", whole // 16, whole, "model"]]
    assert got["gather_model"]["by_kind"] == {"all-gather": whole,
                                              "total": whole}
    # Partial over "data" -> Replicate: one all-reduce, 2x its operand
    assert got["reduce_data"]["records"] == [
        ["all-reduce", whole, whole, "data"]]
    assert got["reduce_data"]["by_axis"] == {"data": 2 * whole}
    # Partial over "model" -> Shard(0): one reduce-scatter of the operand
    assert got["scatter_model"]["records"] == [
        ["reduce-scatter", whole, whole // 16, "model"]]
    assert got["scatter_model"]["by_kind"]["total"] == whole


@pytest.mark.parametrize("coll_s", [1e9, 3e12])
def test_roofline_terms_equal_repros_with_the_h100_peaks(monkeypatch,
                                                         coll_s):
    monkeypatch.setattr(j_rl, "PEAK_FLOPS", rl.PEAK_FLOPS)
    monkeypatch.setattr(j_rl, "HBM_BW", rl.HBM_BW)
    monkeypatch.setattr(j_rl, "ICI_BW", rl.NIC_BW)
    monkeypatch.setattr(j_rl, "BF16_LEGALIZATION_CORRECTION", 1.0)
    kw = dict(flops=3.1e15, bytes_accessed=2.7e12, coll_bytes=coll_s,
              coll_by_kind={"all-gather": int(coll_s), "total": int(coll_s)},
              n_devices=256, model_flops=5.5e17)
    ours, theirs = rl.Roofline(**kw).as_dict(), j_rl.Roofline(**kw).as_dict()
    # with no per-axis split the collective term takes the NIC's rate
    theirs["coll_by_axis"] = {}
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        assert ours[k] == pytest.approx(v, rel=1e-12) if isinstance(
            v, float) else ours[k] == v, k


def test_collective_term_takes_each_axis_its_link():
    r = rl.Roofline(flops=0.0, bytes_accessed=0.0, coll_bytes=3e9,
                    coll_by_kind={}, n_devices=512, model_flops=0.0,
                    coll_by_axis={"pod": 1e9, "data": 1e9, "model": 1e9},
                    mesh_shape={"pod": 2, "data": 16, "model": 4})
    # "model" (4 ranks, the minor axis) stays in one 8-GPU node
    assert r.collective_s == pytest.approx(
        1e9 / rl.NIC_BW + 1e9 / rl.NIC_BW + 1e9 / rl.NVLINK_BW)


def test_model_flops_equal_repros_for_every_arch_and_shape():
    for arch in j_configs.list_archs():
        for name, shape in configs.INPUT_SHAPES.items():
            j_shape = j_configs.INPUT_SHAPES[name]
            for backward in (False, True):
                assert rl.model_flops_for(
                    configs.get_config(arch), shape, backward=backward
                ) == j_rl.model_flops_for(j_configs.get_config(arch),
                                          j_shape, backward=backward)


# repro's result fields (launch/dryrun.py): lower_s and compile_s are one
# trace_s in the port, and roofline_raw_scanned has no counterpart
RESULT_FIELDS = {"arch", "shape", "mesh", "method", "variant", "window",
                 "kind", "trace_s", "memory", "roofline", "cost_segments"}
MEMORY_FIELDS = {"argument_bytes_per_dev", "output_bytes_per_dev",
                 "temp_bytes_per_dev", "peak_hbm_estimate_per_dev",
                 "param_bytes_per_dev"}


def test_run_one_fields_bytes_and_an_exact_fit(tmp_path):
    res = _child("dryrun", tmp_path)
    assert RESULT_FIELDS <= set(res)
    assert set(res["memory"]) == MEMORY_FIELDS
    assert set(j_rl.Roofline(1.0, 1.0, 1.0, {}, 1, 1.0).as_dict()) <= set(
        res["roofline"])
    assert (res["mesh"], res["kind"], res["method"]) == ("16x16", "train",
                                                         "cascaded")
    # the fit from probes of 1 and 2 layers (2 and 3 for the peak) is the
    # traced 4-layer count
    r, traced, mem = res["roofline"], res["traced"], res["memory"]
    assert r["flops_per_dev"] == traced["flops"]
    assert r["bytes_per_dev"] == traced["bytes"]
    assert r["coll_bytes_per_dev"] == traced["coll_bytes"]
    assert r["coll_bytes_per_dev"] == r["coll_by_kind"]["total"] > 0
    assert mem["temp_bytes_per_dev"] == traced["peak_bytes"] > 0
    assert mem["output_bytes_per_dev"] == traced["output_bytes"] > 0
    assert mem["peak_hbm_estimate_per_dev"] == (
        mem["argument_bytes_per_dev"] + traced["output_bytes"]
        + traced["peak_bytes"])
    # every collective byte has its site, and the sites' fit is exact too
    assert sum(res["coll_by_site"].values()) == r["coll_bytes_per_dev"]
    assert res["coll_by_site"] == traced["coll_by_site"]
    assert not any(k.endswith(" ?") for k in res["coll_by_site"])
    # tokens and labels (256, 4096) int32 over the 16-way data axis, beside
    # the parameter shards
    tokens = 2 * 256 * 4096 * 4 // 16
    assert res["memory"]["param_bytes_per_dev"] == res[
        "param_bytes_per_dev"]
    assert res["memory"]["argument_bytes_per_dev"] == (
        res["param_bytes_per_dev"] + tokens)
    # the step does at least 6·N·tokens (the backward, remat's second
    # forward, the perturbed lane and attention come on top)
    assert r["flops_per_dev"] * r["n_devices"] >= r["model_flops"]
    assert r["bottleneck"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("flags", [["--window-gather"],
                                   ["--remat-policy", "dots"]])
def test_cli_refuses_the_variants_it_has_no_counterpart_of(flags, capsys):
    from repro_torch.launch import dryrun
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "phi3-mini-3.8b", "--shape", "train_4k"]
                    + flags)
    assert e.value.code == 2
    assert dryrun.UNPORTED_VARIANTS in capsys.readouterr().err
