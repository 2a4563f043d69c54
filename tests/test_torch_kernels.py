"""The port's fused ZOO fan-out (``repro_torch.kernels.zoo_dual_matmul``)
against the JAX package's: its plain version and its CPU wrapper path
against ``repro``'s ``ref.py`` and against ``repro``'s ``ops.py`` (Pallas
in interpret mode), over the client block axis R, q lanes, a ragged K, f32
and bf16; the wrapper's argument checks; and, on a CUDA card only, the
hand-written kernel against the plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_mlp import PaperMLPConfig as JPaperMLPConfig
from repro.core import zoo as j_zoo
from repro.core.adapters import tabular_adapter as j_tabular_adapter
from repro.kernels.zoo_dual_matmul import ops as j_ops
from repro.kernels.zoo_dual_matmul import ref as j_ref
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core import zoo
from repro_torch.core.adapters import tabular_adapter
from repro_torch.kernels.zoo_dual_matmul import ops, ref
from test_torch_support import raw_normals, to_numpy, to_torch

# repro's own tolerances (tests/test_zoo_vectorized.py): f32 math both
# sides, bf16 rounding at different points of the two frameworks
TOL = {"float32": 1e-4, "bfloat16": 1.5e-1}
MU = 1e-2


def _inputs(seed, R, M, K, N, q, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, M, K)).astype(np.float32)
    w = (rng.standard_normal((R, K, N)) / np.sqrt(K)).astype(np.float32)
    us = rng.standard_normal((R, q, K, N)).astype(np.float32)
    b = rng.standard_normal((R, N)).astype(np.float32)
    ub = rng.standard_normal((R, q, N)).astype(np.float32)
    tdt = getattr(torch, dtype)
    t = [torch.from_numpy(a).to(tdt) for a in (x, w, us)]
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in (x, w, us)]
    return t + [torch.from_numpy(b), torch.from_numpy(ub)], \
        j + [jnp.asarray(b), jnp.asarray(ub)]


def _close(a, b, dtype):
    np.testing.assert_allclose(to_numpy(a), to_numpy(b), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("R,q", [(1, 1), (3, 3), (1, 4), (3, 4)])
def test_stacked_matches_reference(R, q, epilogue, dtype):
    """Batched over the block axis in one call, where repro vmaps; K = 33
    is ragged against any power-of-two tile."""
    (x, w, us, b, ub), (jx, jw, jus, jb, jub) = _inputs(R * 10 + q, R, 64,
                                                        33, 128, q, dtype)
    if epilogue:
        y, y_hat = ops.zoo_dual_matmul_stacked(x, w, us, MU, b=b, ub=ub)
        py, py_hat = ref.zoo_dual_matmul_stacked_bias_relu_ref(
            x, w, us, b, ub, MU)
        ry, ry_hat = jax.vmap(
            lambda *a: j_ref.zoo_dual_matmul_stacked_bias_relu_ref(*a, MU))(
            jx, jw, jus, jb, jub)
        ky, ky_hat = jax.vmap(lambda x_, w_, u_, b_, ub_:
                              j_ops.zoo_dual_matmul_stacked(
                                  x_, w_, u_, MU, b=b_, ub=ub_, bm=64,
                                  bn=64))(jx, jw, jus, jb, jub)
        assert float(y.float().min()) >= 0 and float(y_hat.float().min()) >= 0
    else:
        y, y_hat = ops.zoo_dual_matmul_stacked(x, w, us, MU)
        py, py_hat = ref.zoo_dual_matmul_stacked_ref(x, w, us, MU)
        ry, ry_hat = jax.vmap(
            lambda *a: j_ref.zoo_dual_matmul_stacked_ref(*a, MU))(jx, jw, jus)
        ky, ky_hat = jax.vmap(lambda x_, w_, u_: j_ops.zoo_dual_matmul_stacked(
            x_, w_, u_, MU, bm=64, bn=64))(jx, jw, jus)
    assert y.shape == (R, 64, 128) and y_hat.shape == (R, q, 64, 128)
    assert y.dtype == x.dtype and y_hat.dtype == x.dtype
    # on CPU tensors the wrapper IS the plain version
    np.testing.assert_array_equal(to_numpy(y), to_numpy(py))
    np.testing.assert_array_equal(to_numpy(y_hat), to_numpy(py_hat))
    for ours, theirs in ((y, ry), (y_hat, ry_hat), (y, ky), (y_hat, ky_hat)):
        _close(ours, theirs, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unbatched_and_single_lane_forms(dtype):
    """The unbatched stacked call and the single-lane ``zoo_dual_matmul``
    (the q = 1, R = 1 case) against repro's ref and Pallas ops."""
    (x, w, us, b, ub), (jx, jw, jus, jb, jub) = _inputs(5, 1, 64, 33, 128,
                                                        2, dtype)
    y, y_hat = ops.zoo_dual_matmul_stacked(x[0], w[0], us[0], MU, b=b[0],
                                           ub=ub[0])
    ky, ky_hat = j_ops.zoo_dual_matmul_stacked(jx[0], jw[0], jus[0], MU,
                                               b=jb[0], ub=jub[0], bm=64,
                                               bn=64)
    assert y.shape == (64, 128) and y_hat.shape == (2, 64, 128)
    _close(y, ky, dtype)
    _close(y_hat, ky_hat, dtype)
    s, s_hat = ops.zoo_dual_matmul(x[0], w[0], us[0, 0], MU)
    for theirs in (j_ref.zoo_dual_matmul_ref(jx[0], jw[0], jus[0, 0], MU),
                   j_ops.zoo_dual_matmul(jx[0], jw[0], jus[0, 0], MU,
                                         bm=64, bn=64)):
        _close(s, theirs[0], dtype)
        _close(s_hat, theirs[1], dtype)


def test_stacked_lane_directions():
    """(ŷ_l − y)/μ must equal x@u_l per lane — the estimator's signal."""
    (x, w, us, _, _), _ = _inputs(1, 2, 32, 20, 48, 4, "float32")
    y, y_hat = ops.zoo_dual_matmul_stacked(x, w, us, 1e-3)
    np.testing.assert_allclose(
        ((y_hat - y[:, None]) / 1e-3).numpy(),
        np.einsum("rmk,rqkn->rqmn", x.numpy(), us.numpy()),
        atol=1e-2, rtol=1e-2)


def test_cpu_path_launches_nothing():
    (x, w, us, b, ub), _ = _inputs(2, 1, 8, 5, 6, 1, "float32")
    before = dict(ops.launches)
    ops.zoo_dual_matmul_stacked(x, w, us, MU, b=b, ub=ub)
    ops.zoo_dual_matmul_stacked(x, w, us, MU)
    ops.zoo_dual_matmul(x[0], w[0], us[0, 0], MU)
    assert ops.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    (x, w, us, b, ub), _ = _inputs(3, 2, 8, 5, 6, 3, "float32")
    with pytest.raises(ValueError, match="both b and ub"):
        ops.zoo_dual_matmul_stacked(x, w, us, MU, b=b)
    with pytest.raises(ValueError, match="both b and ub"):
        ops.zoo_dual_matmul_stacked(x, w, us, MU, ub=ub)
    bad = [
        (x, w[:, :4], us, {}),                       # K mismatch
        (x, w, us[:, :, :, :5], {}),                 # N mismatch in us
        (x, w[:1], us, {}),                          # block axis mismatch
        (x[0], w, us, {}),                           # mixed ranks
        (x, w, us, {"b": b[:, :5], "ub": ub}),       # epilogue shapes
        (x, w, us, {"b": b, "ub": ub[:, :2]}),
        (x.double(), w.double(), us.double(), {}),   # dtype the kernel lacks
        (x, w.to(torch.bfloat16), us, {}),           # mixed dtypes
        (x, w, us, {"b": b.to(torch.bfloat16), "ub": ub}),
        (x.transpose(1, 2).contiguous().transpose(1, 2), w, us, {}),
        (x[:, :0], w, us, {}),                       # empty
    ]
    for xx, ww, uu, kw in bad:
        with pytest.raises(ValueError):
            ops.zoo_dual_matmul_stacked(xx, ww, uu, MU, **kw)
    with pytest.raises(ValueError):
        ops.zoo_dual_matmul(x[0], w[0], us[0, 0, :4], MU)
    with pytest.raises(ValueError):
        ops.zoo_dual_matmul(x, w, us[:, 0], MU)


@pytest.mark.parametrize("q", [1, 3])
def test_kernel_lanes_match_plain_and_pallas_lanes(q):
    """tabular_adapter(use_kernel_lanes=True) — the fused-epilogue path —
    gives the same (1+q) activation lanes as the plain lanes and as
    repro's tabular_adapter(use_pallas_lanes=True), per block row."""
    cfg = PaperMLPConfig(n_features=256, n_classes=4, n_clients=4,
                         client_embed=128, server_embed=64)
    jcfg = JPaperMLPConfig(n_features=256, n_classes=4, n_clients=4,
                           client_embed=128, server_embed=64)
    rng = np.random.default_rng(q)
    w = (rng.standard_normal((2, 64, 128)) / 8).astype(np.float32)
    b = rng.standard_normal((2, 128)).astype(np.float32)
    x = rng.standard_normal((2, 64, 64)).astype(np.float32)
    rows = [{"w": jnp.asarray(w[r]), "b": jnp.asarray(b[r])} for r in (0, 1)]
    keys = jax.random.split(jax.random.key(q), 2)
    raw = [raw_normals(k, rows[r], q) for r, k in enumerate(keys)]
    u_j = [j_zoo.sample_directions(k, rows[r], q)[0]
           for r, k in enumerate(keys)]
    u_t, _ = zoo.sample_directions(
        {k: torch.stack([raw[0][k], raw[1][k]]) for k in ("b", "w")},
        {"w": torch.from_numpy(w[0]), "b": torch.from_numpy(b[0])}, q)
    blk = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    lanes_k = tabular_adapter(cfg, use_kernel_lanes=True).client_lanes(
        blk, u_t, 1e-3, torch.from_numpy(x))
    lanes_p = tabular_adapter(cfg).client_lanes(blk, u_t, 1e-3,
                                                torch.from_numpy(x))
    assert lanes_k.shape == (2, 1 + q, 64, 128)
    np.testing.assert_allclose(lanes_k.numpy(), lanes_p.numpy(), atol=2e-5,
                               rtol=2e-5)
    ad = j_tabular_adapter(jcfg, use_pallas_lanes=True)
    for r in (0, 1):
        tree_close = to_torch(u_j[r])
        for k in ("b", "w"):
            np.testing.assert_allclose(u_t[k][r].numpy(),
                                       tree_close[k].numpy(), atol=1e-6)
        theirs = ad.client_lanes(rows[r], u_j[r], 1e-3, jnp.asarray(x[r]))
        np.testing.assert_allclose(lanes_k[r].numpy(), np.asarray(theirs),
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """The hand-written CUDA kernel against its plain version, on the card,
    at the main path's shapes, a ragged one (plain loads: rows that are not
    16-byte multiples), a K that takes several chunks of the two-stage ring
    and q lanes over several passes, f32 (TF32 off) and bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_launches()
    shapes = [(1, 64, 196, 128, 1), (3, 64, 196, 128, 4), (2, 50, 33, 70, 3),
              (1, 64, 1000, 128, 6), (2, 40, 196, 64, 9)]
    for dtype in ("float32", "bfloat16"):
        for R, M, K, N, q in shapes:
            (x, w, us, b, ub), _ = _inputs(R + q, R, M, K, N, q, dtype)
            x, w, us, b, ub = (t.cuda() for t in (x, w, us, b, ub))
            got = ops.zoo_dual_matmul_stacked(x, w, us, MU, b=b, ub=ub)
            want = ref.zoo_dual_matmul_stacked_bias_relu_ref(x, w, us, b,
                                                             ub, MU)
            got2 = ops.zoo_dual_matmul_stacked(x, w, us, MU)
            want2 = ref.zoo_dual_matmul_stacked_ref(x, w, us, MU)
            got3 = ops.zoo_dual_matmul(x[0], w[0], us[0, 0], MU)
            want3 = ref.zoo_dual_matmul_ref(x[0], w[0], us[0, 0], MU)
            torch.cuda.synchronize()
            for g, wn in zip((*got, *got2, *got3), (*want, *want2, *want3)):
                _close(g, wn, dtype)
    n = 2 * len(shapes)
    assert ops.launches == {"zoo_dual_matmul": n, "zoo_dual_matmul_stacked": n,
                            "zoo_dual_matmul_stacked_bias_relu": n}


# flash attention under capture: (B, Sq, Skv, Hq, Hkv, d, causal, dtype):
# Whisper-medium's cross-attention decode call, a causal prefill chunk at
# GQA and d = 96 in bf16 (wgmma, TMA maps), and f32 (the CUDA cores)
FLASH_CAPTURE_CASES = [
    (8, 1, 1500, 16, 16, 64, False, torch.bfloat16),
    (2, 64, 192, 8, 2, 96, True, torch.bfloat16),
    (2, 64, 128, 4, 4, 64, True, torch.float32),
]


@pytest.mark.gpu
def test_flash_captured_replays_on_fresh_buffer_contents():
    """Flash attention captured in a CUDA graph (``graphs.StepGraph``)
    and replayed after fresh contents are copied into the same q, k and v
    buffers equals its eager launch on those contents, bitwise: the bf16
    launch's TMA maps and the f32 launch's pointers, recorded at capture,
    still address the buffers. One launch a replay is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    from repro_torch import graphs
    from repro_torch.kernels.flash_attention import ops as flash_ops
    g = torch.Generator("cuda").manual_seed(0)
    for B, Sq, Skv, Hq, Hkv, d, causal, dtype in FLASH_CAPTURE_CASES:
        shapes = ((B, Sq, Hq, d), (B, Skv, Hkv, d), (B, Skv, Hkv, d))

        def fresh():
            return [torch.randn(s, generator=g, device="cuda").to(dtype)
                    for s in shapes]
        q, k, v = fresh()
        o = torch.empty((B, Sq, Hq, d), dtype=dtype, device="cuda")

        def body():
            o.copy_(flash_ops.flash_attention_bshd(q, k, v, causal=causal))
        graph = graphs.StepGraph(body, "cuda")
        assert graph.launches() == {"flash_attention": 1}
        for _ in range(3):
            for buf, new in zip((q, k, v), fresh()):
                buf.copy_(new)
            graph.replay()
            want = flash_ops.flash_attention_bshd(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert torch.equal(o, want)
