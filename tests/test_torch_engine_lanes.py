"""One round of the port's cascaded engine with ``use_lanes`` (the fused
client fan-out) against the JAX engine, from identical params with the
JAX engine's draws injected: the port's plain lanes and its kernel lanes
against both of ``repro``'s lane paths (XLA and Pallas), and the DP loss
channel (tolerances in ``assert_round_parity``)."""
import pytest

from test_torch_support import assert_round_parity, engine_case, torch_threads


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with torch_threads(1):
        yield


# with the cases of test_torch_engine_async.py, a covering set of
# (q, block, dist): every value of each axis appears with and without the
# fused lanes
CASCADED_LANES = [
    dict(q=1, block=3, dist="normal", use_lanes=True, kernel_lanes=False),
    dict(q=4, block=3, dist="sphere", use_lanes=True, pallas_lanes=True),
    dict(q=1, block=1, dist="sphere", use_lanes=True, kernel_lanes=True),
]


@pytest.mark.parametrize("case", CASCADED_LANES,
                         ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_cascaded_lanes_round_matches_reference(case):
    j, t = engine_case("cascaded", **case)
    assert_round_parity("cascaded", j, t)


def test_cascaded_dp_round_matches_reference():
    """Under the DP loss channel the port takes the noise normals from the
    draw source; fed the JAX engine's per-row noise draws, the noised
    losses, the client update and the spent (ε, δ) agree."""
    noise = dict(clip=10.0, epsilon=1.0, delta=1e-5)
    j, t = engine_case("cascaded", q=2, block=3, noise=noise)
    assert_round_parity("cascaded", j, t)
    assert 0 < t["res"].epsilon < float("inf")
