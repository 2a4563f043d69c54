"""bf16 whole-model parity of the port (``repro_torch``) with the JAX
package (``repro``), on the CPU: the forward logits of both packages at
``reduced()``'s default bf16 (params and activations), for the dense
family (reduced phi3) and the hybrid one (reduced zamba2 with 4 layers).

The two packages round to bf16 at other places (fused or separate ops,
the order of f32 sums before a cast), so their bf16 logits are not held
to an absolute tolerance. The bound, stated here: the max |Δ| between the
port's and ``repro``'s bf16 logits is at most ``repro``'s own distance
between its bf16 forward and its f32 forward on the same params (the bf16
leaves widened to f32) and the same tokens. A port that rounds no worse
than ``repro`` itself stays inside that; a fault in the port's bf16 path
(a wrong cast, a dropped term) does not."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import common as j_common
from repro.models import transformer as j_transformer
from repro.models.model_api import build_model as j_build_model
from repro_torch.configs import get_config, reduced
from repro_torch.models import common, transformer
from test_torch_support import to_numpy

BATCH, TOKENS = 2, 32
CASES = {"phi3": ("phi3-mini-3.8b", {}),
         "zamba2": ("zamba2-2.7b", {"n_layers": 4})}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_logits_within_repro_own_bf16_distance(case):
    arch, kw = CASES[case]
    jcfg, cfg = j_reduced(j_get_config(arch), **kw), reduced(get_config(arch),
                                                              **kw)
    assert jcfg.dtype == cfg.dtype == "bfloat16"
    assert jcfg.param_dtype == cfg.param_dtype == "bfloat16"
    jp = j_common.materialize(
        j_build_model(jcfg, max_seq=TOKENS).param_specs, jax.random.key(0))
    tp = common.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (BATCH, TOKENS)).astype(np.int32)

    ours, _, _ = transformer.forward(cfg, tp,
                                     {"tokens": torch.from_numpy(toks)})
    theirs, _, _ = j_transformer.forward(jcfg, jp,
                                         {"tokens": jnp.asarray(toks)})
    jcfg32 = j_reduced(j_get_config(arch), param_dtype="float32",
                       dtype="float32", **kw)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    theirs32, _, _ = j_transformer.forward(jcfg32, jp32,
                                           {"tokens": jnp.asarray(toks)})

    assert ours.dtype == torch.bfloat16
    ours, theirs, theirs32 = (to_numpy(ours), to_numpy(theirs),
                              to_numpy(theirs32))
    assert ours.shape == theirs.shape == (BATCH, TOKENS, cfg.padded_vocab)
    assert np.isfinite(ours).all()
    gap = float(np.abs(ours - theirs).max())
    bound = float(np.abs(theirs - theirs32).max())
    assert 0.0 < bound
    assert gap <= bound, (f"{case}: port vs repro at bf16 {gap:.4g} > "
                          f"repro's bf16 vs f32 {bound:.4g}")
