"""The port's LM examples (``examples_torch/train_lm_cascaded.py`` and
``serve_decode.py``) on the CPU at the JAX examples' settings, with their
own checks; and every example's refusal to run on the CPU unasked when
there is no card."""
import pytest
import torch

from test_torch_examples import load
from test_torch_support import torch_threads

EXAMPLES = ("quickstart", "async_adapters", "paper_experiments",
            "attack_demo", "train_lm_cascaded", "serve_decode")


def test_train_lm_cascaded_loss_falls(monkeypatch):
    # the example registers its config: in a copy of the registry, so no
    # later test of this process sees it
    from repro_torch import configs
    monkeypatch.setattr(configs, "ARCH_REGISTRY",
                        dict(configs.ARCH_REGISTRY))
    with torch_threads(1):
        res = load("train_lm_cascaded").main(["--device", "cpu"])
    assert res["loss_last"] < res["loss_first"]
    assert res["arch"] == "lm-ci" and res["steps"] == 60
    assert not res["wire_has_gradients"]


def test_serve_decode_modes_wire_and_fallback():
    with torch_threads(1):
        out = load("serve_decode").main(["--device", "cpu"])
    assert [r["mode"] for r in out] == ["federated"] * 3 + ["continuous",
                                                           "global"]
    assert [r["arch"] for r in out] == ["granite-20b", "rwkv6-7b",
                                        "zamba2-2.7b", "granite-20b",
                                        "whisper-medium"]
    assert all(r["wire_bytes"] > 0 for r in out[:4])
    assert "fallback" in out[4]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_a_card_raises_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the example would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        load(name).main([])
