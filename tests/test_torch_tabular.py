"""The port's tabular MLP (``repro_torch.models.tabular``) and parameter
machinery (``repro_torch.models.common``) against the JAX package's, with
the JAX-initialised weights carried across by ``params_from_numpy``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_mlp import PaperMLPConfig as JPaperMLPConfig
from repro.core.adapters import tabular_adapter as j_tabular_adapter
from repro.core.partition import tree_dim as j_tree_dim
from repro.core.partition import tree_flat_norm as j_tree_flat_norm
from repro.models import common as j_common
from repro.models import tabular as j_tabular
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core.adapters import tabular_adapter
from repro_torch.core.partition import (merge_params, split_params, tree_dim,
                                        tree_flat_norm, tree_leaves)
from repro_torch.models import common, tabular
from test_torch_support import to_numpy, to_torch, tree_allclose

CFG = dict(n_features=32, n_classes=4, n_clients=4, client_embed=16,
           server_embed=32)


@pytest.fixture(scope="module")
def setup():
    jcfg = JPaperMLPConfig(**CFG)
    jparams = j_common.materialize(j_tabular.param_specs(jcfg),
                                   jax.random.key(0))
    rng = np.random.default_rng(0)
    x_parts = rng.standard_normal((4, 24, 8)).astype(np.float32)
    y = rng.integers(0, 4, 24).astype(np.int32)
    return jcfg, jparams, x_parts, y


def test_param_specs_equal_and_materialize():
    jspecs = j_tabular.param_specs(JPaperMLPConfig(**CFG))
    specs = tabular.param_specs(PaperMLPConfig(**CFG))
    assert (jax.tree.map(dataclasses.astuple, jspecs,
                         is_leaf=j_common.is_spec)
            == jax.tree.map(dataclasses.astuple, specs,
                            is_leaf=common.is_spec))
    assert common.param_count(specs) == j_common.param_count(jspecs)
    params = common.materialize(specs, torch.Generator().manual_seed(0))
    for p, s in zip(tree_leaves(params), tree_leaves(specs)):
        assert tuple(p.shape) == s.shape and p.dtype == torch.float32
    assert torch.all(params["clients"]["b"] == 0)
    # fan-in scaled init: std ≈ 1/sqrt(fan_in)
    assert 0.2 < float(params["server"]["w1"].std() * 8) < 5.0
    again = common.materialize(specs, torch.Generator().manual_seed(0))
    tree_allclose(params, again, atol=0)


def test_forward_loss_accuracy_match_reference(setup):
    jcfg, jparams, x_parts, y = setup
    params = to_torch(jparams)
    xt, yt = torch.from_numpy(x_parts), torch.from_numpy(y).long()
    jx, jy = jnp.asarray(x_parts), jnp.asarray(y)
    c = tabular.all_clients_forward(params["clients"], xt)
    jc = j_tabular.all_clients_forward(jparams["clients"], jx)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5,
                               rtol=1e-5)
    c0 = tabular.client_forward({k: v[0] for k, v in params["clients"].items()},
                                xt[0])
    np.testing.assert_allclose(c0.numpy(), np.asarray(jc[0]), atol=1e-5,
                               rtol=1e-5)
    logits = tabular.server_forward(params["server"], c)
    jlogits = j_tabular.server_forward(jparams["server"], jc)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(tabular.xent(logits, yt)),
                               float(j_tabular.xent(jlogits, jy)), atol=1e-5,
                               rtol=1e-5)
    loss, aux = tabular.global_loss(params, {"x_parts": xt, "y": yt})
    jloss, jaux = j_tabular.global_loss(jparams, {"x_parts": jx, "y": jy})
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(aux["logits"].numpy(),
                               np.asarray(jaux["logits"]), atol=1e-5,
                               rtol=1e-5)
    assert (float(tabular.accuracy(params, xt, yt))
            == float(j_tabular.accuracy(jparams, jx, jy)))
    # the adapter's global loss (Split-Learning view) and server loss
    ad, jad = tabular_adapter(PaperMLPConfig(**CFG)), j_tabular_adapter(jcfg)
    np.testing.assert_allclose(float(ad.global_loss(params, xt, yt)),
                               float(jad.global_loss(jparams, jx, jy)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(ad.server_loss(params["server"], c, yt)),
                               float(jad.server_loss(jparams["server"], jc,
                                                     jy)),
                               atol=1e-5, rtol=1e-5)


def test_leading_batch_dims_match_per_index(setup):
    """Every model function broadcasts over leading (block, lane) dims: a
    (2, 3, ...) stack gives, per index, the unbatched result."""
    _, jparams, x_parts, y = setup
    params = to_torch(jparams)
    rng = np.random.default_rng(1)
    c = torch.from_numpy(rng.standard_normal((2, 3, 4, 24, 16))
                         .astype(np.float32))
    yt = torch.from_numpy(y).long()
    ad = tabular_adapter(PaperMLPConfig(**CFG))
    losses = ad.server_loss(params["server"], c, yt)
    assert losses.shape == (2, 3)
    for i in range(2):
        for j in range(3):
            np.testing.assert_allclose(
                float(losses[i, j]),
                float(ad.server_loss(params["server"], c[i, j], yt)),
                rtol=1e-6)


def test_params_round_trip_and_partition_helpers(setup):
    _, jparams, _, _ = setup
    params = common.params_from_numpy(jax.tree.map(np.asarray, jparams))
    back = common.params_to_numpy(params)
    for k in ("clients", "server"):
        for name, a in jparams[k].items():
            assert back[k][name].dtype == np.asarray(a).dtype
            np.testing.assert_array_equal(back[k][name], np.asarray(a))
    bf = common.params_from_numpy(
        {"w": np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16))})
    assert bf["w"].dtype == torch.bfloat16
    assert bf["w"].float().tolist() == [1.5, -2.25]
    with pytest.raises(ValueError, match="bfloat16"):
        common.params_to_numpy(bf)
    assert tree_dim(params) == j_tree_dim(jparams)
    np.testing.assert_allclose(float(tree_flat_norm(params)),
                               float(j_tree_flat_norm(jparams)), rtol=1e-6)
    client, server = split_params(params, ("clients",))
    assert set(client) == {"clients"} and set(server) == {"server"}
    assert merge_params(client, server).keys() == params.keys()
    assert to_numpy(params["server"]["w1"]).shape == (64, 32)
