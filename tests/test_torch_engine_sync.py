"""One round of the port's engine against the JAX engine for the
synchronous all-ZOO baseline (syn-zoo) and the unrolled per-query oracle,
from identical params with the JAX engine's draws injected (tolerances in
``assert_round_parity``)."""
import pytest

from test_torch_support import assert_round_parity, engine_case, torch_threads


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.mark.parametrize("q,dist", [(1, "sphere"), (4, "normal")])
def test_syn_zoo_round_matches_reference(q, dist):
    j, t = engine_case("syn-zoo", q=q, dist=dist)
    assert_round_parity("syn-zoo", j, t)


def test_unrolled_oracle_round_matches_reference():
    """vfl.zoo_unrolled_oracle routes both engines through the per-query
    loop; the port's loop and repro's agree on one round."""
    j, t = engine_case("cascaded", q=4, block=3, unrolled=True)
    assert_round_parity("cascaded", j, t)
