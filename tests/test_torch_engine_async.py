"""One round of the port's asynchronous engine against the JAX engine,
from identical params with the JAX engine's draws injected: cascaded
through the plain (unfused) client path, and VAFL, over q, block size and
the direction distribution. Losses, params, the embedding table, delay
counters and the wire ledger are compared (tolerances in
``assert_round_parity``)."""
import pytest

from test_torch_support import assert_round_parity, engine_case, torch_threads


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with torch_threads(1):
        yield


CASCADED = [
    dict(q=1, block=1, dist="sphere"),
    dict(q=4, block=3, dist="normal"),
    dict(q=4, block=1, dist="sphere"),
]


@pytest.mark.parametrize("case", CASCADED,
                         ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_cascaded_round_matches_reference(case):
    j, t = engine_case("cascaded", **case)
    assert_round_parity("cascaded", j, t)


@pytest.mark.parametrize("block", [1, 3])
def test_vafl_round_matches_reference(block):
    j, t = engine_case("vafl", block=block)
    assert j["res"].transmits_gradients
    assert_round_parity("vafl", j, t)
