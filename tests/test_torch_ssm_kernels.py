"""The port's SSD chunked-scan kernel (``repro_torch.kernels.ssd_chunk``)
against the JAX package's: its plain version (the wrappers' CPU path, the
per-token recurrence) against ``repro``'s ``ssd_chunk_ref`` oracle and
``repro``'s Pallas kernel in interpret mode at ``tests/test_kernels.py``'s
shapes; its initial-state / final-state form against ``repro``'s
``ssm._ssd_chunked(state0=)``; the wrappers' argument checks; and, on a
CUDA card only, the hand-written kernel against its plain version.

Tolerances: ``repro``'s own for this kernel (``tests/test_kernels.py``):
f32 1e-4, bf16 1.5e-1, absolute and relative. The chunked form and the
per-token recurrence sum in other orders, and a bf16 output rounds
separately on each side."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk import ops as j_ssd_ops
from repro.kernels.ssd_chunk import ref as j_ssd_ref
from repro.models import ssm as j_ssm
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk import ref as ssd_ref
from test_torch_support import to_numpy

TOL = {"float32": 1e-4, "bfloat16": 1.5e-1}
# repro's test shapes (BH, S, P, N, chunk)
TPU_SHAPES = [(2, 64, 32, 16, 16), (3, 128, 32, 16, 32),
              (1, 128, 64, 32, 64)]


def _inputs(seed, lead, S, P, N, dtype, *, heads=None):
    """numpy draws as repro's test makes them: x and B/C N(0, 0.25), a in
    (0.05, 0.95), dt softplus(N(0, 1)); ``lead`` is BH (TPU layout) or B
    (model layout, with ``heads`` H). Returns (torch, jax) tuples."""
    rng = np.random.default_rng(seed)
    hs = () if heads is None else (heads,)
    x = (rng.standard_normal((lead, S) + hs + (P,)) * 0.5).astype(np.float32)
    a = (1 / (1 + np.exp(-rng.standard_normal((lead, S) + hs))) * 0.9
         + 0.05).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((lead, S) + hs))).astype(
        np.float32)
    bm = (rng.standard_normal((lead, S, N)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((lead, S, N)) * 0.5).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ours = (torch.from_numpy(x).to(tdt), torch.from_numpy(a),
            torch.from_numpy(dt), torch.from_numpy(bm).to(tdt),
            torch.from_numpy(cm).to(tdt))
    theirs = (jnp.asarray(x, jdt), jnp.asarray(a), jnp.asarray(dt),
              jnp.asarray(bm, jdt), jnp.asarray(cm, jdt))
    return ours, theirs


def _close(ours, theirs, tol):
    np.testing.assert_allclose(to_numpy(ours), to_numpy(theirs), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,S,P,N,chunk", TPU_SHAPES)
def test_plain_matches_reference_and_pallas(BH, S, P, N, chunk, dtype):
    """The TPU-contract wrapper's CPU path against repro's oracle and its
    Pallas kernel in interpret mode (what repro's tests run on the CPU)."""
    ours, theirs = _inputs(S + P, BH, S, P, N, dtype)
    y = ssd_ops.ssd_chunk(*ours, chunk=chunk)
    assert y.shape == (BH, S, P) and y.dtype == ours[0].dtype
    np.testing.assert_array_equal(to_numpy(y),
                                  to_numpy(ssd_ref.ssd_chunk_ref(*ours)))
    _close(y, j_ssd_ref.ssd_chunk_ref(*theirs), TOL[dtype])
    _close(y, j_ssd_ops.ssd_chunk(*theirs, chunk=chunk), TOL[dtype])


@pytest.mark.parametrize("chunk", [8, 16, 7])
def test_state_form_matches_ssd_chunked(chunk):
    """The model-layout plain version with an initial state and the final
    state against repro's ``_ssd_chunked(state0=)`` (shared B/C across 3
    heads, a non-zero carried state)."""
    S = 56 if chunk == 7 else 48
    ours, theirs = _inputs(chunk, 2, S, 16, 8, "float32", heads=3)
    s0 = np.random.default_rng(5).standard_normal((2, 3, 16, 8)).astype(
        np.float32)
    y, s1 = ssd_ops.ssd_chunk_bshp(*ours, chunk=chunk,
                                   state0=torch.from_numpy(s0))
    jy, js1 = j_ssm._ssd_chunked(*theirs, chunk, state0=jnp.asarray(s0))
    assert y.dtype == torch.float32 and s1.shape == (2, 3, 16, 8)
    _close(y, jy, TOL["float32"])
    _close(s1, js1, TOL["float32"])
    # from zeros: the TPU contract's function, heads flattened
    y0, _ = ssd_ops.ssd_chunk_bshp(*ours, chunk=chunk)
    jy0, _ = j_ssm._ssd_chunked(*theirs, chunk)
    _close(y0, jy0, TOL["float32"])


def test_split_state_carry_equals_one_pass():
    """Two halves with the state handed on equal one pass, y and state."""
    (x, a, dt, bm, cm), _ = _inputs(9, 1, 32, 8, 4, "float32", heads=2)
    y, s = ssd_ops.ssd_chunk_bshp(x, a, dt, bm, cm, chunk=8)
    h = slice(0, 16), slice(16, 32)
    y1, s1 = ssd_ops.ssd_chunk_bshp(*(t[:, h[0]].contiguous()
                                      for t in (x, a, dt, bm, cm)), chunk=8)
    y2, s2 = ssd_ops.ssd_chunk_bshp(*(t[:, h[1]].contiguous()
                                      for t in (x, a, dt, bm, cm)), chunk=8,
                                    state0=s1)
    _close(torch.cat([y1, y2], 1), y, 1e-5)
    _close(s2, s, 1e-5)


def test_wrappers_reject_what_the_kernel_does_not_take():
    (x, a, dt, bm, cm), _ = _inputs(3, 2, 16, 8, 4, "float32", heads=2)
    s0 = torch.zeros(2, 2, 8, 4)
    bad = [
        ((x[..., 0], a, dt, bm, cm), {}),                   # wrong rank
        ((x, a[:, :8], dt, bm, cm), {}),                    # a's shape
        ((x, a, dt, bm[..., :2], cm), {}),                  # B/C mismatch
        ((x[:, :0], a[:, :0], dt[:, :0], bm[:, :0], cm[:, :0]), {}),
        ((x, a, dt, bm, cm), {"chunk": 5}),                 # 5 does not divide 16
        ((x, a, dt, bm, cm), {"chunk": 0}),
        ((x, a, dt, bm, cm), {"state0": s0[:1]}),
        ((x, a, dt, bm, cm), {"state0": s0.double()}),
        ((x.double(), a, dt, bm.double(), cm.double()), {}),
        ((x, a, dt, bm.to(torch.bfloat16), cm), {}),       # mixed dtypes
        ((x, a.to(torch.bfloat16), dt, bm, cm), {}),       # a not f32
        ((x, a, dt, bm.transpose(1, 2).contiguous().transpose(1, 2), cm),
         {}),                                               # not contiguous
        ((x.to("meta"), a.to("meta"), dt.to("meta"), bm.to("meta"),
          cm.to("meta")), {}),
    ]
    for args, kw in bad:
        with pytest.raises(ValueError):
            ssd_ops.ssd_chunk_bshp(*args, **{"chunk": 8, **kw})
    big, _ = _inputs(4, 1, 8, 72, 4, "float32", heads=1)
    with pytest.raises(ValueError, match="up to 64"):
        ssd_ops.ssd_chunk_bshp(*big, chunk=8)
    long, _ = _inputs(4, 1, 256, 8, 4, "float32", heads=1)
    with pytest.raises(ValueError, match="128"):
        ssd_ops.ssd_chunk_bshp(*long, chunk=256)
    with pytest.raises(ValueError):
        ssd_ops.ssd_chunk(x, a, dt, bm, cm)                 # model layout


def test_cpu_paths_launch_nothing():
    (x, a, dt, bm, cm), _ = _inputs(6, 2, 16, 8, 4, "float32")
    before = dict(ssd_ops.launches)
    ssd_ops.ssd_chunk(x, a, dt, bm, cm, chunk=8)
    ssd_ops.ssd_chunk_bshp(x[:, :, None], a[:, :, None], dt[:, :, None], bm,
                           cm, chunk=8)
    assert ssd_ops.launches == before


# ------------------------------------------------------------- on the card --

@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """The hand-written kernel against its plain version on the card: the
    TPU test's shapes in f32 and bf16, the serve path's head dims with a
    non-zero initial state at chunks 96 and 112, and a ragged chunk of 7;
    y and the final state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    ssd_ops.reset_launches()
    n = 0
    for dtype, tol in TOL.items():
        for BH, S, P, N, chunk in TPU_SHAPES:
            ours, _ = _inputs(S + P, BH, S, P, N, dtype)
            ours = [t.cuda() for t in ours]
            got = ssd_ops.ssd_chunk(*ours, chunk=chunk)
            want = ssd_ref.ssd_chunk_ref(*ours)
            torch.cuda.synchronize()
            _close(got, want, tol)
            n += 1
        for B, S, H, chunk in ((1, 192, 4, 96), (1, 224, 4, 112),
                               (2, 56, 3, 7)):
            ours, _ = _inputs(S, B, S, 64, 64, dtype, heads=H)
            ours = [t.cuda() for t in ours]
            s0 = torch.randn(B, H, 64, 64, device="cuda")
            y, s1 = ssd_ops.ssd_chunk_bshp(*ours, chunk=chunk, state0=s0)
            yr, sr = ssd_ref.ssd_states_ref(*ours, state0=s0)
            torch.cuda.synchronize()
            _close(y, yr, tol)
            _close(s1, sr, tol)
            n += 1
    assert ssd_ops.launches == {"ssd_chunk": n}
