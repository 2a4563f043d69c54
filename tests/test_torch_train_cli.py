"""The port's training driver (``repro_torch.launch.train``) on the CPU:
a short run on reduced phi3 whose loss falls and whose wire ledger is
exact and gradient-free, the CLI's alias surface (the JAX package's
``tests/test_federation.py::test_cli_accepts_every_alias_spelling``), the
card by default, the later slices refused by name, and
``--engine population``: its flags against the JAX package's, and a run
that stops with ``--until`` and a ``--resume`` that finishes it equal to
an unbroken run."""
import json
import math

import pytest
import torch

from repro.core.methods import METHOD_ALIASES as J_METHOD_ALIASES
from repro_torch.configs import get_config, reduced
from repro_torch.core.methods import METHOD_ALIASES
from repro_torch.federation import Transport
from repro_torch.launch.train import (build_parser, main, train,
                                      train_population)
from test_torch_support import (MODALITY_ARCHS, split_plane_refusal,
                                torch_threads)


@pytest.fixture(autouse=True)
def _threads():
    with torch_threads(2):
        yield


@pytest.mark.parametrize("method", ["cascaded", "vafl"])
def test_train_loss_falls_and_wire_is_exact(method):
    """8 steps of batch 8 x 32 tokens. lr 1.0: at the CLI's 0.01 the
    reduced model moves less in 8 steps than the batches' loss varies."""
    steps, batch = 8, 8
    res = train("phi3-mini-3.8b", steps=steps, batch=batch, seq=32, lr=1.0,
                method=method, device="cpu", log_every=1000)
    assert res["device"] == "cpu" and res["method"] == method
    assert res["loss_last"] < res["loss_first"]
    cfg = reduced(get_config("phi3-mini-3.8b"))
    ledger = Transport(method).account(batch=batch, embed=cfg.d_model,
                                       n_rounds=steps)
    assert res["wire_bytes_per_round"] == ledger.total_bytes // steps
    assert res["wire_has_gradients"] == (method == "vafl")


def test_deepseek_train_matches_reference_driver():
    """``launch.train`` on reduced DeepSeek-V3 (MLA, a dense then an MoE
    layer; the MTP head in the global tree, none on the server) against
    ``repro``'s driver at the same settings: the same result keys, wire
    bytes a round and no gradient on the wire; both losses fall at lr 1.0
    (the weights are drawn by each package's own generator, so the losses
    themselves differ)."""
    from repro.launch.train import train as j_train
    kw = dict(steps=6, batch=4, seq=32, lr=1.0, log_every=1000)
    res = train("deepseek-v3-671b", device="cpu", **kw)
    jres = j_train("deepseek-v3-671b", **kw)
    assert set(res) - {"device"} == set(jres)
    assert res["wire_bytes_per_round"] == jres["wire_bytes_per_round"]
    assert res["wire_has_gradients"] is jres["wire_has_gradients"] is False
    for r in (res, jres):
        assert r["loss_last"] < r["loss_first"]
    cfg = reduced(get_config("deepseek-v3-671b"))
    ledger = Transport("cascaded").account(batch=4, embed=cfg.d_model,
                                           n_rounds=6)
    assert res["wire_bytes_per_round"] == ledger.total_bytes // 6


def test_cli_accepts_every_alias_spelling():
    parser = build_parser()
    choices = next(a.choices for a in parser._actions
                   if "--method" in a.option_strings)
    assert set(choices) == set(METHOD_ALIASES) == set(J_METHOD_ALIASES)
    for alias in METHOD_ALIASES:
        assert parser.parse_args(["--method", alias]).method == alias


def test_main_runs_on_the_cpu_when_asked(capsys):
    main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
          "--method", "split-learning"])
    res = json.loads(capsys.readouterr().out.split("\n", 1)[1])
    assert res["method"] == "split" and res["device"] == "cpu"
    assert res["steps"] == 2 and res["wire_has_gradients"]


def test_train_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: train() would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        train("phi3-mini-3.8b", steps=1, batch=1, seq=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--steps", "1"])


def test_later_slices_raise_with_their_roadmap_items():
    """The production mesh needs its 256 ranks: with no process group
    ``--production-mesh`` raises the mesh's ``RuntimeError`` (the placed
    run itself is ``test_torch_production_mesh.py``'s, on 4 gloo ranks);
    the multimodal and encoder-decoder families train through the sync
    cascade (as ``repro``'s driver trains them) and the population engine
    refuses them with ``repro``'s ``ValueError`` (``test_torch_encdec.py``
    and ``test_torch_vlm.py`` hold both drivers to ``repro``'s)."""
    with pytest.raises(RuntimeError, match="process group"):
        main(["--production-mesh", "--device", "cpu"])
    for arch in MODALITY_ARCHS:
        res = train(arch, steps=1, batch=2, seq=8, device="cpu",
                    log_every=1000)
        assert res["arch"] == arch and res["steps"] == 1
        assert math.isfinite(res["loss_first"])
        with pytest.raises(ValueError) as ours:
            train_population(arch, steps=2, seq=8, rows=8, device="cpu")
        assert str(ours.value) == split_plane_refusal(arch)


POP = ["--engine", "population", "--device", "cpu", "--steps", "10",
       "--seq", "16", "--batch", "4", "--rows", "32", "--clients", "2",
       "--lr", "0.05"]


def _cli(capsys, argv):
    main(argv)
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


def test_population_cli_flags_match_reference():
    """The population flags and their defaults are the JAX package's."""
    from repro.launch.train import build_parser as j_build_parser
    flags = ("--engine", "--clients", "--rows", "--until", "--fault-drop",
             "--fault-latency-ms", "--fault-jitter-ms", "--fault-seed",
             "--admission-ms", "--staleness-bound")
    ours = {a.option_strings[0]: (a.default, a.type, a.choices)
            for a in build_parser()._actions if a.option_strings}
    ref = {a.option_strings[0]: (a.default, a.type, a.choices)
           for a in j_build_parser()._actions if a.option_strings}
    assert {f: ours[f] for f in flags} == {f: ref[f] for f in flags}


def test_population_cli_until_resume_equals_unbroken(capsys, tmp_path):
    """``--until 4 --checkpoint`` then ``--resume`` finishes the 10-round
    horizon with the unbroken run's losses, wire bytes and fault counters,
    under drops, latency, admission and staleness forcing."""
    faults = ["--fault-drop", "0.2", "--fault-latency-ms", "3",
              "--fault-jitter-ms", "2", "--admission-ms", "6",
              "--staleness-bound", "3"]
    whole = _cli(capsys, POP + faults + ["--checkpoint",
                                         str(tmp_path / "w")])
    half = _cli(capsys, POP + faults + ["--until", "4", "--checkpoint",
                                        str(tmp_path / "a")])
    assert half["rounds"] == 4 and half["horizon"] == 10
    # --resume takes the plan and knobs from the checkpoint, not the CLI
    rest = _cli(capsys, ["--engine", "population", "--device", "cpu",
                         "--resume", str(tmp_path / "a"), "--checkpoint",
                         str(tmp_path / "b")])
    assert rest["start_step"] == 4 and rest["rounds"] == 10
    assert rest["loss_last"] == whole["loss_last"]
    assert rest["faults"] == whole["faults"]
    assert rest["virtual_ms"] == whole["virtual_ms"]
    assert rest["max_delay_seen"] == whole["max_delay_seen"]
    assert rest["serialized_bytes"] == whole["serialized_bytes"]
    assert not rest["wire_has_gradients"] and rest["device"] == "cpu"
    from repro_torch.checkpoint import load_tree
    from repro_torch.tree import tree_leaves
    for party in ("server", "client_00", "client_01", "async_plane"):
        a = load_tree(str(tmp_path / "w" / party))[0]
        b = load_tree(str(tmp_path / "b" / party))[0]
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))
    # a sync driver's checkpoint carries no async plane
    train("phi3-mini-3.8b", steps=1, batch=2, seq=16, device="cpu",
          checkpoint_path=str(tmp_path / "sync"))
    with pytest.raises(ValueError, match="no async plane"):
        train_population(resume=str(tmp_path / "sync"), device="cpu")


def test_population_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: train_population would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--engine", "population", "--steps", "1"])
