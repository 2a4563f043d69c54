"""One round of the port's engine against the JAX engine for an adapter
with a row-mask hook (the ZOO perturbation restricted to the rows a batch
touches), from identical params with the JAX engine's draws injected
(tolerances in ``assert_round_parity``)."""
import pytest

from test_torch_support import assert_round_parity, engine_case, torch_threads


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.mark.parametrize("use_lanes,unrolled", [(False, False), (True, False),
                                                (False, True)])
def test_row_mask_round_matches_reference(use_lanes, unrolled):
    """An adapter's row-mask hook restricts each block row's directions to
    the rows its batch touches, on the stacked, lane and unrolled paths."""
    j, t = engine_case("cascaded", q=4, block=3, row_mask=True,
                       use_lanes=use_lanes, unrolled=unrolled)
    assert_round_parity("cascaded", j, t)
