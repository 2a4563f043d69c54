"""The port's flash-attention and RMSNorm kernels
(``repro_torch.kernels.flash_attention`` / ``.rmsnorm``) against the JAX
package's: their plain versions (the wrappers' CPU path) against
``repro``'s ``ref.py`` oracles and ``repro``'s Pallas kernels in interpret
mode, at ``tests/test_kernels.py``'s shapes plus Phi-3's head dim 96,
Zamba2's 80, GQA, ragged lengths and the chunked-prefill ``q_offset`` (held
against ``mha_chunked(q_offset=)``); the wrappers' argument checks and
dispatch (f32 to the CUDA-core kernel, bf16 to the tensor-core kernel, which
needs 16-byte-aligned operands); and, on a CUDA card only, the hand-written
kernels against their plain versions.

Tolerances: f32 2e-5 (f32 math both sides, summed in other orders); bf16
2e-2 absolute (``tests/test_kernels.py``'s). On the card, bf16 adds a
relative 2e-2: the kernel and the plain version round their f32 results
to bf16 separately, and one bf16 step is 2^-8 of the value."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_flash_ops
from repro.kernels.flash_attention import ref as j_flash_ref
from repro.kernels.rmsnorm import ops as j_rms_ops
from repro.kernels.rmsnorm import ref as j_rms_ref
from repro.models.layers import apply_norm as j_apply_norm
from repro.models.attention import mha_chunked as j_mha_chunked
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm import ref as rms_ref
from test_torch_support import to_numpy

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (atol, rtol) of the kernels against their plain versions on the card
RMS_CARD_TOL = {"float32": (1e-5, 0.0), "bfloat16": (2e-2, 2e-2)}


def _arrays(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a, jdt) for a in arrs])


def _close(ours, theirs, dtype):
    np.testing.assert_allclose(to_numpy(ours), to_numpy(theirs),
                               atol=TOL[dtype], rtol=0)


# ------------------------------------------------------ flash attention --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,S,d", [(2, 128, 64), (4, 256, 64), (1, 256, 128),
                                    (2, 128, 96), (2, 128, 80)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_flash_plain_matches_reference(BH, S, d, dtype, causal, window):
    """The wrapper's CPU path (the plain version) against repro's oracle
    and its Pallas kernel in interpret mode, in the TPU layout."""
    (q, k, v), (jq, jk, jv) = _arrays(S + d + BH, [(BH, S, d)] * 3, dtype)
    ours = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ours.shape == q.shape and ours.dtype == q.dtype
    np.testing.assert_array_equal(
        to_numpy(ours), to_numpy(flash_ref.flash_attention_ref(
            q, k, v, causal=causal, window=window)))
    _close(ours, j_flash_ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                                 window=window), dtype)
    _close(ours, j_flash_ops.flash_attention(jq, jk, jv, causal=causal,
                                             window=window, bq=64, bk=64),
           dtype)


def test_flash_cross_lengths():
    """Sq != Skv, non-causal (tests/test_kernels.py's cross case)."""
    (q, k, v), (jq, jk, jv) = _arrays(0, [(2, 128, 64), (2, 256, 64),
                                          (2, 256, 64)], "float32")
    ours = flash_ops.flash_attention(q, k, v, causal=False)
    _close(ours, j_flash_ops.flash_attention(jq, jk, jv, causal=False,
                                             bq=64, bk=64), "float32")
    _close(ours, j_flash_ref.flash_attention_ref(jq, jk, jv, causal=False),
           "float32")


MODEL_LAYOUT_CASES = [
    (24, 48, 24, 0, 4, 4),      # the second prefill chunk of a 48-slot cache
    (18, 48, 24, 0, 4, 2),      # ragged chunk, GQA (G = 2)
    (24, 48, 0, 0, 2, 2),       # first chunk: zero cache slots past 24
    (50, 50, 0, 16, 4, 1),      # causal sliding window, MQA
    (7, 40, 30, 8, 2, 1),       # window with an offset
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,q_offset,window,Hq,Hkv", MODEL_LAYOUT_CASES)
def test_flash_model_layout_matches_mha_chunked(Sq, Skv, q_offset, window,
                                                Hq, Hkv, dtype):
    """The model-layout wrapper (GQA in place, ``q_offset``) against
    repro's ``mha_chunked(q_offset=)``, its chunked-prefill attention; the
    cache past q_offset + Sq is zero, as the serve plane leaves it. Phi-3's
    head dim 96."""
    _check_model_layout(Sq, Skv, q_offset, window, Hq, Hkv, dtype, d=96)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,q_offset,window,Hq,Hkv", MODEL_LAYOUT_CASES)
def test_flash_model_layout_head_dim_80(Sq, Skv, q_offset, window, Hq, Hkv,
                                        dtype):
    """As above at Zamba2's attention head dim 80."""
    _check_model_layout(Sq, Skv, q_offset, window, Hq, Hkv, dtype, d=80)


def _check_model_layout(Sq, Skv, q_offset, window, Hq, Hkv, dtype, d):
    (q, k, v), (jq, jk, jv) = _arrays(
        Sq + Skv + Hkv, [(2, Sq, Hq, d), (2, Skv, Hkv, d), (2, Skv, Hkv, d)],
        dtype)
    end = q_offset + Sq
    k[:, end:], v[:, end:] = 0, 0
    jk, jv = jk.at[:, end:].set(0), jv.at[:, end:].set(0)
    ours = flash_ops.flash_attention_bshd(q, k, v, causal=True, window=window,
                                          q_offset=q_offset)
    assert ours.shape == q.shape and ours.dtype == q.dtype
    _close(ours, j_mha_chunked(jq, jk, jv, causal=True, window=window,
                               q_offset=q_offset), dtype)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    (q, k, v), _ = _arrays(1, [(2, 8, 4, 32), (2, 8, 2, 32), (2, 8, 2, 32)],
                           "float32")
    bad = [
        (q, k, v[:, :4], {}),                        # k/v mismatch
        (q, k[:1], v[:1], {}),                       # batch mismatch
        (q[..., :16], k, v, {}),                     # head dim mismatch
        (q[:, :, :3], k, v, {}),                     # heads not a multiple
        (q.double(), k.double(), v.double(), {}),    # dtype the kernel lacks
        (q, k.to(torch.bfloat16), v, {}),            # mixed dtypes
        (q.transpose(1, 2).contiguous().transpose(1, 2), k, v, {}),
        (q[:, :0], k, v, {}),                        # empty
        (q, k, v, {"window": -1}),
        (q, k, v, {"q_offset": -1}),
        (q[..., 0], k[..., 0], v[..., 0], {}),       # wrong rank
    ]
    for qq, kk, vv, kw in bad:
        with pytest.raises(ValueError):
            flash_ops.flash_attention_bshd(qq, kk, vv, **kw)
    (q, k, v), _ = _arrays(2, [(2, 8, 4, 24)] * 3, "float32")
    with pytest.raises(ValueError, match="multiples of 16"):
        flash_ops.flash_attention_bshd(q, k, v)
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, k, v)           # 4-d in the TPU layout
    # one route a dtype on the card: code 0, f32 on the CUDA cores (to hold
    # the plain version to 1e-4); code 1, bf16 on the tensor cores
    assert flash_kernel._DTYPE_CODES == {torch.float32: 0,
                                         torch.bfloat16: 1}
    assert set(flash_kernel._DTYPE_CODES) == set(flash_ops.KERNEL_DTYPES)
    # the tensor-core route reads through TMA: a misaligned base raises
    shape = (2, 8, 4, 32)
    n = int(np.prod(shape))
    buf = torch.zeros(n + 1, dtype=torch.bfloat16)
    aligned = buf[:n].view(shape)
    shifted = buf[1:].view(shape)                  # 2 bytes off, contiguous
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    flash_ops.check_tma_alignment(aligned, aligned, aligned)
    for operands in [(shifted, aligned, aligned), (aligned, shifted, aligned),
                     (aligned, aligned, shifted)]:
        with pytest.raises(ValueError, match="16-byte-aligned"):
            flash_ops.check_tma_alignment(*operands)


# ----------------------------------------------------------------- RMSNorm --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,d", [(128, 256), (256, 512), (64, 1024), (8, 96),
                                 (50, 128), (8, 2560), (64, 3072)])
def test_rmsnorm_plain_matches_reference(M, d, dtype):
    """tests/test_kernels.py's shapes, the decode step's M = 8 (also at
    Zamba2's d_model 2560), Phi-3's d_model 3072 and a ragged M = 50
    (which the TPU kernel's row tiling rejects, so its Pallas form is
    checked at the tiled shapes only), against repro's oracle, its model
    function ``layers.apply_norm`` and its Pallas kernel."""
    (x, sc), (jx, jsc) = _arrays(M + d, [(M, d), (d,)], dtype)
    sc, jsc = sc.float(), jsc.astype(jnp.float32)
    ours = rms_ops.rmsnorm(x, sc)
    assert ours.shape == x.shape and ours.dtype == x.dtype
    np.testing.assert_array_equal(to_numpy(ours),
                                  to_numpy(rms_ref.rmsnorm_ref(x, sc)))
    _close(ours, j_rms_ref.rmsnorm_ref(jx, jsc), dtype)
    _close(ours, j_apply_norm(types.SimpleNamespace(norm="rmsnorm"),
                              {"scale": jsc}, jx), dtype)
    if M % 64 == 0:
        _close(ours, j_rms_ops.rmsnorm(jx, jsc, bm=64), dtype)


def test_rmsnorm_wrapper_rejects_what_the_kernel_does_not_take():
    (x, sc), _ = _arrays(3, [(4, 8), (8,)], "float32")
    bad = [(x[None], sc), (x, sc[:4]), (x, sc[None]), (x[:0], sc),
           (x.double(), sc), (x, sc.to(torch.bfloat16)), (x.t(), sc[:4]),
           (x[:, ::2], sc[:4]), (x.to("meta"), sc.to("meta"))]
    for xx, ss in bad:
        with pytest.raises(ValueError):
            rms_ops.rmsnorm(xx, ss)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [3072, 2560])
def test_rmsnorm_route_takes_vector_kernel_at_serve_widths(d, dtype):
    """Phi-3's and Zamba2's d_model from fresh allocations take the
    one-pass vector kernel, with scale or without."""
    (x, sc), _ = _arrays(d, [(8, d), (d,)], dtype)
    assert rms_ops.route(x) == "vector"
    assert rms_ops.route(x, sc.float()) == "vector"


def test_rmsnorm_route_takes_general_kernel_where_vectors_do_not_fit():
    """Ragged d (not a whole number of 16-byte vectors), d above the
    register path's 8192 and a misaligned x or scale take the general
    kernel; d = 100 is whole vectors in f32 (4 a vector), not in bf16."""
    def fresh(M, d, dtype):
        return torch.zeros(M, d, dtype=dtype)
    bf, f32 = torch.bfloat16, torch.float32
    for x in (fresh(4, 100, bf), fresh(4, 130, bf), fresh(4, 130, f32),
              fresh(2, 8200, bf), fresh(2, 8200, f32), fresh(2, 9000, bf)):
        assert rms_ops.route(x) == "general", (x.shape, x.dtype)
    assert rms_ops.route(fresh(4, 100, f32)) == "vector"
    assert rms_ops.route(fresh(2, 8192, f32)) == "vector"
    for dtype in (bf, f32):
        buf = torch.zeros(64 * 3072 + 1, dtype=dtype)
        shifted = buf[1:].view(64, 3072)          # one element off
        assert shifted.is_contiguous() and shifted.data_ptr() % 16
        assert rms_ops.route(buf[:-1].view(64, 3072)) == "vector"
        assert rms_ops.route(shifted) == "general"
    scale = torch.zeros(3073)[1:]
    assert rms_ops.route(fresh(4, 3072, bf), scale) == "general"


@pytest.mark.parametrize("few_rows", [False, True])
def test_rmsnorm_vector_shape_leaves_no_thread_idle(few_rows):
    """The vector kernel's launch shape, for prefill-sized calls and for
    calls of fewer rows than SMs (decode): at every registry d_model (the
    serve widths among them) whole warps of at least 128 threads, one row
    a block, each thread holding the same number of 16-byte vectors with
    none left over; for any d the route takes, a shape the C launcher
    accepts that covers the row."""
    from repro_torch.configs import ARCH_REGISTRY
    want = {(3072, 2): (384, 1, 1), (2560, 2): (320, 1, 1)} if few_rows \
        else {(3072, 2): (128, 3, 1), (2560, 2): (160, 2, 1)}
    for (d, es), shape in want.items():
        assert rms_ops.vector_shape(d, es, few_rows) == shape
    for arch, cfg in ARCH_REGISTRY.items():
        for es in (2, 4):
            threads, vecs, rows = rms_ops.vector_shape(cfg.d_model, es,
                                                       few_rows)
            assert threads % 32 == 0 and threads >= 128 and rows == 1
            assert threads * vecs * 16 == cfg.d_model * es, arch
    for es in (2, 4):
        for d in range(16 // es, rms_ops.MAX_VECTOR_D + 1, 16 // es):
            threads, vecs, rows = rms_ops.vector_shape(d, es, few_rows)
            assert threads % 32 == 0 and threads * rows <= 1024
            assert 1 <= vecs <= rms_ops.MAX_VECS
            assert threads * vecs * 16 >= d * es
            assert (threads - 32) * vecs * 16 < d * es    # no idle warp


def test_cpu_paths_launch_nothing():
    (q, k, v), _ = _arrays(4, [(2, 8, 4, 32), (2, 8, 2, 32), (2, 8, 2, 32)],
                           "float32")
    (x, sc), _ = _arrays(5, [(4, 32), (32,)], "float32")
    before = (dict(flash_ops.launches), dict(rms_ops.launches),
              dict(rms_ops.route_launches))
    flash_ops.flash_attention_bshd(q, k, v, q_offset=0)
    flash_ops.flash_attention(*(t[:, :, 0].contiguous() for t in (q, k, v)))
    rms_ops.rmsnorm(x, sc)
    assert (flash_ops.launches, rms_ops.launches,
            rms_ops.route_launches) == before


# ------------------------------------------------------------- on the card --

# RMSNorm on the card: (M, d, x's offset into its buffer in elements, the
# route f32 and bf16 take); chip_smoke.py's phase 2 runs these and more
RMS_CARD_CASES = [(8, 3072, 0, ("vector", "vector")),
                  (4608, 3072, 0, ("vector", "vector")),
                  (50, 128, 0, ("vector", "vector")),
                  (3584, 2560, 0, ("vector", "vector")),
                  (8, 2560, 0, ("vector", "vector")),
                  (64, 5120, 0, ("vector", "vector")),
                  (64, 7168, 0, ("vector", "vector")),
                  (50, 100, 0, ("vector", "general")),
                  (50, 130, 0, ("general", "general")),
                  (16, 9000, 0, ("general", "general")),
                  (1, 3072, 0, ("vector", "vector")),
                  (64, 3072, 1, ("general", "general"))]


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """The hand-written kernels against their plain versions on the card:
    head dims 64/96/128 and Zamba2's 80 (both prefill chunks), causal,
    window 64, non-causal with Sq != Skv, q_offset 0 and 576 over a
    1152-slot cache, ragged Sq, GQA, and the bf16 kernel's tile edges (Sq
    and Skv off its 128-row and 128-key tiles, three d panels at 112);
    MLA's (d_qk, d_v) = (192, 128), causal at q_offset 0 and 448 and a
    ragged Sq;
    RMSNorm at M = 8, 4608, 50 and 1, the serve widths and d_model up to
    7168 on the vector kernel, ragged d, d above 8192 and a misaligned x on
    the general one (each case held to its route); a misaligned bf16
    flash operand raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    flash_ops.reset_launches()
    rms_ops.reset_launches()
    tols = {"float32": (1e-4, 0.0), "bfloat16": (2e-2, 2e-2)}
    # (B, Sq, Skv, Hq, Hkv, d, d_v, causal, window, q_offset)
    cases = [(1, 128, 128, 2, 2, 64, 64, True, 0, 0),
             (1, 576, 1152, 2, 2, 96, 96, True, 0, 576),
             (1, 448, 1152, 4, 2, 96, 96, True, 0, 576),
             (1, 50, 50, 2, 2, 128, 128, True, 64, 0),
             (2, 128, 256, 2, 2, 64, 64, False, 0, 0),
             (1, 576, 1152, 2, 2, 80, 80, True, 0, 0),
             (1, 448, 1152, 2, 2, 80, 80, True, 0, 576),
             (1, 37, 1152, 2, 1, 80, 80, True, 0, 576),
             (1, 300, 300, 2, 2, 96, 96, True, 0, 0),
             (1, 200, 333, 4, 1, 112, 112, False, 0, 0),
             (1, 576, 1152, 2, 2, 192, 128, True, 0, 0),
             (1, 576, 1024, 2, 2, 192, 128, True, 0, 448),
             (1, 37, 1152, 2, 2, 192, 128, True, 0, 576)]
    n = 0
    for dtype, (atol, rtol) in tols.items():
        for B, Sq, Skv, Hq, Hkv, d, dv, causal, window, off in cases:
            (q, k, v), _ = _arrays(Sq + d, [(B, Sq, Hq, d), (B, Skv, Hkv, d),
                                            (B, Skv, Hkv, dv)], dtype)
            q, k, v = q.cuda(), k.cuda(), v.cuda()
            got = flash_ops.flash_attention_bshd(
                q, k, v, causal=causal, window=window, q_offset=off)
            want = flash_ref.flash_attention_bshd_ref(
                q, k, v, causal=causal, window=window, q_offset=off)
            torch.cuda.synchronize()
            np.testing.assert_allclose(to_numpy(got), to_numpy(want),
                                       atol=atol, rtol=rtol)
            n += 1
        for M, d, offset, routes in RMS_CARD_CASES:
            (flat, sc), _ = _arrays(M + d, [(offset + M * d,), (d,)], dtype)
            x = flat.cuda()[offset:].view(M, d)
            sc = sc.float().cuda()
            before = dict(rms_ops.route_launches)
            got = rms_ops.rmsnorm(x, sc)
            want = rms_ref.rmsnorm_ref(x, sc)
            torch.cuda.synchronize()
            took = [r for r, c in rms_ops.route_launches.items()
                    if c != before[r]]
            assert took == [routes[dtype == "bfloat16"]], (M, d, offset)
            ratol, rrtol = RMS_CARD_TOL[dtype]
            np.testing.assert_allclose(to_numpy(got), to_numpy(want),
                                       atol=ratol, rtol=rrtol)
    assert flash_ops.launches == {"flash_attention": n}
    assert rms_ops.launches == {"rmsnorm": 2 * len(RMS_CARD_CASES)}
    q = torch.zeros(2 * 8 * 4 * 32 + 1, dtype=torch.bfloat16, device="cuda")
    q = q[1:].view(2, 8, 4, 32)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        flash_ops.flash_attention_bshd(q, q, q)
    assert flash_ops.launches == {"flash_attention": n}
