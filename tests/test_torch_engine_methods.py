"""One round of the port's engine against the JAX engine for the ZOO
server (zoo-vfl) and Split-Learning, from identical params with the JAX
engine's draws injected (tolerances in ``assert_round_parity``)."""
import pytest

from test_torch_support import assert_round_parity, engine_case, torch_threads


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.mark.parametrize("q,block,dist", [(1, 3, "sphere"), (4, 1, "normal"),
                                          (4, 3, "sphere")])
def test_zoo_vfl_round_matches_reference(q, block, dist):
    j, t = engine_case("zoo-vfl", q=q, block=block, dist=dist)
    assert_round_parity("zoo-vfl", j, t)


def test_split_round_matches_reference():
    j, t = engine_case("split")
    assert j["res"].transmits_gradients and j["res"].max_delay_seen == 0
    assert_round_parity("split", j, t)
