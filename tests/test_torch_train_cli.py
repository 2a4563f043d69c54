"""The port's training driver (``repro_torch.launch.train``) on the CPU:
a short run on reduced phi3 whose loss falls and whose wire ledger is
exact and gradient-free, the CLI's alias surface (the JAX package's
``tests/test_federation.py::test_cli_accepts_every_alias_spelling``), the
card by default, and the later slices refused by name."""
import json

import pytest
import torch

from repro.core.methods import METHOD_ALIASES as J_METHOD_ALIASES
from repro_torch.configs import get_config, reduced
from repro_torch.core.methods import METHOD_ALIASES
from repro_torch.federation import Transport
from repro_torch.launch.train import build_parser, main, train
from test_torch_support import torch_threads


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
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        main(["--engine", "population", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        main(["--production-mesh", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train("rwkv6-7b", steps=1, device="cpu")
