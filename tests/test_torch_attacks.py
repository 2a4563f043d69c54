"""The port's privacy attacks (``repro_torch.core.attacks``, paper §VI-B
Table I and §V-B) against the JAX package's ``repro.core.attacks``, on the
CPU.

The JAX package draws with threefry keys; :class:`JaxAttackDraws` hands
the port those same draws (``split(key, 4)`` into labels, query, secret
and eavesdropper directions; ``split(key, 3)`` into features, weights and
bias), so both packages attack the same data. Accuracies and MSEs must
agree to f32's 1e-5. Then ``tests/test_async_attacks_privacy.py``'s three
assertions hold on the port's own generator draws."""
import jax
import numpy as np
import pytest
import torch

from repro.core import attacks as j_attacks
from repro_torch.core import attacks

TOL = 1e-5


class JaxAttackDraws:
    """The draws ``repro.core.attacks`` makes from ``key``."""

    def __init__(self, key) -> None:
        self.key = key

    def label_draws(self, n_samples, n_classes):
        k1, k2, k3, k4 = jax.random.split(self.key, 4)
        labels = jax.random.randint(k1, (n_samples,), 0, n_classes)
        normals = [jax.random.normal(k, (n_samples, n_classes))
                   for k in (k2, k3, k4)]
        return tuple(torch.from_numpy(np.asarray(a).copy())
                     for a in [labels] + normals)

    def feature_draws(self, n, f, e):
        k1, k2, k3 = jax.random.split(self.key, 3)
        arrs = (jax.random.normal(k1, (n, f)), jax.random.normal(k2, (f, e)),
                jax.random.normal(k3, (e,)))
        return tuple(torch.from_numpy(np.asarray(a).copy()) for a in arrs)


@pytest.mark.parametrize("framework,n", [("foo", 512), ("zoo", 2048),
                                         ("zoo", 300)])
@pytest.mark.parametrize("seed", [0, 3])
def test_label_inference_matches_reference(framework, n, seed):
    key = jax.random.key(seed)
    want = j_attacks.run_label_inference(key, 10, n, framework=framework)
    got = attacks.run_label_inference(10, n, framework=framework,
                                      draws=JaxAttackDraws(key))
    assert abs(got.curious_client_acc - want.curious_client_acc) <= TOL
    assert abs(got.eavesdropper_acc - want.eavesdropper_acc) <= TOL


@pytest.mark.parametrize("seed,shape", [(1, (512, 16, 32)),
                                        (5, (256, 8, 24))])
def test_feature_inference_matches_reference(seed, shape):
    """The minimum-norm inversion through the pseudo-inverse equals
    ``jnp.linalg.lstsq`` on the rank-deficient per-row systems."""
    key = jax.random.key(seed)
    n, f, e = shape
    want = j_attacks.run_feature_inference(key, n, f, e)
    got = attacks.run_feature_inference(n, f, e, draws=JaxAttackDraws(key))
    for name in ("mse_with_model_access", "mse_black_box", "mse_chance"):
        a, b = getattr(got, name), getattr(want, name)
        assert abs(a - b) <= TOL * max(1.0, abs(b)), (name, a, b)


def test_primitives_match_reference():
    rng = np.random.default_rng(0)
    c = rng.standard_normal((6, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 6)
    tc, tl = torch.from_numpy(c), torch.from_numpy(labels)
    jc, jl = jax.numpy.asarray(c), jax.numpy.asarray(labels)
    np.testing.assert_allclose(attacks._sum_server_loss(tc, tl).numpy(),
                               np.asarray(j_attacks._sum_server_loss(jc, jl)),
                               atol=1e-6)
    np.testing.assert_allclose(attacks.grad_wrt_output(tc, tl).numpy(),
                               np.asarray(j_attacks.grad_wrt_output(jc, jl)),
                               atol=1e-6)


# ---- tests/test_async_attacks_privacy.py's assertions, on the port's draws

def test_label_inference_foo_leaks():
    r = attacks.run_label_inference(10, 512, framework="foo", seed=0,
                                    device="cpu")
    assert r.curious_client_acc == 1.0
    assert r.eavesdropper_acc == 1.0


def test_label_inference_zoo_defends():
    r = attacks.run_label_inference(10, 2048, framework="zoo", seed=0,
                                    device="cpu")
    # paper Table I: curious client 11.7%, eavesdropper 10.0 (chance)
    assert r.curious_client_acc < 0.35
    assert abs(r.eavesdropper_acc - 0.10) < 0.05


def test_feature_inference_blackbox_defends():
    r = attacks.run_feature_inference(seed=1, device="cpu")
    assert r.mse_with_model_access < 0.2 * r.mse_black_box
    assert r.mse_black_box > 0.9 * r.mse_chance


def test_attacks_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        attacks.run_label_inference(10, 16)
