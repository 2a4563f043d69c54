"""The port's ZOO estimator (``repro_torch.core.zoo``): the stacked lanes
against the unrolled per-query oracle inside the port, and both against
``repro.core.zoo`` fed the same raw N(0, 1) draws — sphere and normal,
q in {1, 4}, with and without a row mask."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import zoo as j_zoo
from repro_torch.core import zoo
from test_torch_support import raw_normals, to_jax, to_torch, tree_allclose

MU = 1e-3


def quad_loss(w):
    return (0.5 * torch.sum(torch.square(w["a"]))
            + torch.sum(w["b"] * w["a"][:3, 0]), {"s": torch.sum(w["a"])})


def j_quad_loss(w):
    return (0.5 * jnp.sum(jnp.square(w["a"]))
            + jnp.sum(w["b"] * w["a"][:3, 0]), {"s": jnp.sum(w["a"])})


def _tree():
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal((6, 2)).astype(np.float32),
            "b": np.ones(3, np.float32)}


MASK = {"a": np.asarray([1., 0, 1, 1, 0, 1], np.float32),
        "b": np.ones(3, np.float32)}


@pytest.mark.parametrize("dist", ["sphere", "normal"])
@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_zoo_gradient_stacked_unrolled_and_reference(dist, q, masked):
    w = _tree()
    mask = MASK if masked else None
    key = jax.random.key(42 + q)
    raw = raw_normals(key, w, q)
    tw = to_torch(w)
    tmask = None if mask is None else to_torch(mask)
    g_s, l_s, a_s = zoo.zoo_gradient(raw, quad_loss, tw, MU, dist, q,
                                     row_mask=tmask)
    g_u, l_u, a_u = zoo.zoo_gradient(raw, quad_loss, tw, MU, dist, q,
                                     row_mask=tmask, unrolled=True)
    # the port's two paths share every op but the lane batching
    tree_allclose(g_s, g_u, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(float(l_s), float(l_u), rtol=1e-6)
    np.testing.assert_allclose(float(a_s["s"]), float(a_u["s"]), rtol=1e-5)

    if masked:
        assert np.all(g_s["a"].numpy()[[1, 4]] == 0)

    # against repro on the same draws, at the engine's μ and at a wide μ.
    # Both sides sum the losses in their own order, so each lane loss is
    # off by its f32 rounding (|f|·2^-23 ≈ 1e-6 here); the estimator
    # divides that by the μ-sized loss difference, so the gradient gap
    # scales as 1/μ: measured at most 1.2e-3 of the gradient's scale at
    # μ = 1e-3, hence a bound of 5e-6/μ of that scale.
    jw = to_jax(w)
    jmask = None if mask is None else to_jax(mask)
    for mu in (MU, 1e-1):
        g, l_clean, aux = zoo.zoo_gradient(raw, quad_loss, tw, mu, dist, q,
                                           row_mask=tmask)
        jg, jl, ja = j_zoo.zoo_gradient(key, j_quad_loss, jw, mu, dist, q,
                                        row_mask=jmask)
        scale = max(float(np.abs(np.asarray(v)).max())
                    for v in jax.tree.leaves(jg))
        tree_allclose(g, jg, atol=5e-6 / mu * scale)
        np.testing.assert_allclose(float(l_clean), float(jl), rtol=1e-6)
        np.testing.assert_allclose(float(aux["s"]), float(ja["s"]),
                                   rtol=1e-5)


@pytest.mark.parametrize("dist", ["sphere", "normal"])
@pytest.mark.parametrize("masked", [False, True])
def test_sample_directions_match_reference(dist, masked):
    w = _tree()
    key = jax.random.key(11)
    mask = MASK if masked else None
    u, d = zoo.sample_directions(raw_normals(key, w, 3), to_torch(w), 3,
                                 dist, None if mask is None
                                 else to_torch(mask))
    ju, jd = j_zoo.sample_directions(key, to_jax(w), 3, dist,
                                     None if mask is None else to_jax(mask))
    tree_allclose(u, ju, rtol=1e-5, atol=1e-7)
    assert d.shape == (3,)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd))
    # lane l of the stack == sample_direction on that lane's draws alone
    raw = raw_normals(key, w, 3)
    for lane in range(3):
        u_l, d_l = zoo.sample_direction({k: v[lane] for k, v in raw.items()},
                                        to_torch(w), dist,
                                        None if mask is None
                                        else to_torch(mask))
        tree_allclose({k: v[lane] for k, v in u.items()}, u_l, rtol=1e-6,
                      atol=0)


def test_batched_rows_match_row_by_row():
    """The engine's block layout: raw (R, q, ...) with a (R, 1, rows) mask
    gives each row what the unbatched call gives it."""
    w = to_torch(_tree())
    rng = np.random.default_rng(1)
    raw = {k: torch.from_numpy(rng.standard_normal((2, 4) + v.shape)
                               .astype(np.float32)) for k, v in w.items()}
    mask = {"a": torch.tensor([[1., 0, 1, 1, 0, 1], [0., 1, 1, 0, 0, 1]]),
            "b": torch.ones(2, 3)}
    u, d = zoo.sample_directions(raw, w, 4, "sphere",
                                 {k: m[:, None] for k, m in mask.items()})
    assert d.shape == (2, 4)
    for r in range(2):
        u_r, d_r = zoo.sample_directions({k: v[r] for k, v in raw.items()},
                                         w, 4, "sphere",
                                         {k: m[r] for k, m in mask.items()})
        tree_allclose({k: v[r] for k, v in u.items()}, u_r, rtol=1e-6,
                      atol=0)
        np.testing.assert_array_equal(d[r].numpy(), d_r.numpy())


def test_lane_helpers_match_reference():
    rng = np.random.default_rng(3)
    w = {"w": rng.standard_normal((4, 3)).astype(np.float32),
         "b": rng.standard_normal(3).astype(np.float32)}
    u = {k: rng.standard_normal((2,) + v.shape).astype(np.float32)
         for k, v in w.items()}
    tree_allclose(zoo.stack_lanes(to_torch(w), to_torch(u), MU),
                  j_zoo.stack_lanes(to_jax(w), to_jax(u), MU), atol=0)
    u1 = {k: v[0] for k, v in u.items()}
    tree_allclose(zoo.perturb(to_torch(w), to_torch(u1), MU),
                  j_zoo.perturb(to_jax(w), to_jax(u1), MU), atol=0)
    losses = np.asarray([0.7, 0.71, 0.69], np.float32)
    phi = np.float32(15.0)
    tree_allclose(
        zoo.grad_from_losses(to_torch(u), torch.from_numpy(losses[1:]),
                             torch.tensor(losses[0]), MU, 15.0),
        j_zoo.grad_from_losses(to_jax(u), jnp.asarray(losses[1:]),
                               jnp.asarray(losses[0]), MU, phi),
        rtol=1e-5, atol=1e-6)
    tree_allclose(
        zoo.two_point_grad(to_torch(u1), torch.tensor(losses[1]),
                           torch.tensor(losses[0]), MU, 15.0),
        j_zoo.two_point_grad(to_jax(u1), jnp.asarray(losses[1]),
                             jnp.asarray(losses[0]), MU, phi),
        rtol=1e-5, atol=1e-6)
    # batched lanes: the lane axis after one block axis
    wb = {k: torch.stack([torch.from_numpy(v)] * 2) for k, v in w.items()}
    ub = {k: torch.stack([torch.from_numpy(v)] * 2) for k, v in u.items()}
    lanes = zoo.stack_lanes(wb, ub, MU, batch_dims=1)
    assert lanes["w"].shape == (2, 3, 4, 3)
    tree_allclose({k: v[1] for k, v in lanes.items()},
                  zoo.stack_lanes(to_torch(w), to_torch(u), MU), atol=0)


def test_loss_transform_and_argument_checks():
    w = to_torch(_tree())
    raw = raw_normals(jax.random.key(0), _tree(), 2)
    g, l_clean, _ = zoo.zoo_gradient(raw, quad_loss, w, MU, "sphere", 2)
    g2, l2, _ = zoo.zoo_gradient(raw, quad_loss, w, MU, "sphere", 2,
                                 loss_transform=lambda losses: 2 * losses)
    tree_allclose({k: 2 * v for k, v in g.items()}, g2, rtol=1e-5, atol=1e-6)
    assert float(l2) == pytest.approx(2 * float(l_clean))
    with pytest.raises(ValueError, match="stacked lane path"):
        zoo.zoo_gradient(raw, quad_loss, w, MU, "sphere", 2, unrolled=True,
                         loss_transform=lambda losses: losses)
    with pytest.raises(ValueError, match="n_queries"):
        zoo.sample_directions(raw, w, 0)
    with pytest.raises(ValueError, match="leading dims"):
        zoo.sample_directions(raw, w, 3)
    with pytest.raises(ValueError, match="unknown ZOO distribution"):
        zoo.phi_factor("cauchy", 4.0)
