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
from repro_torch.kernels.ssd_chunk import kernel as ssd_kernel
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


# the library's own count at the hybrid serve path's shapes (B = 8,
# H = 80; S = 576 at chunk 96, S = 448 at chunk 112), as the card reports
# it through ssd_chunk_scratch_bytes
SERVE_SCRATCH = {(576, 96): 6991872, (448, 112): 5545984}


class _StubLib:
    """Stands in for the built library: a scratch count (bf16 launches
    only), an occupancy report, and a refusal code on request."""

    def __init__(self, err=0):
        self.err = err

    def ssd_chunk_scratch_bytes(self, in_dtype, B, S, H, chunk):
        return 1000 + chunk if in_dtype == 1 else 0

    def ssd_chunk_occupancy(self, in_dtype, out_dtype, B, H, chunk, out):
        for i, v in enumerate((B * H, 32 * (-(-chunk // 16)), 97312, 2)):
            out[i] = v
        return self.err


@pytest.mark.parametrize("dtype,want", [("bfloat16", 1096),
                                        ("float32", None)])
def test_scratch_is_what_the_library_asks_for(monkeypatch, dtype, want):
    """The wrapper allocates a launch's device scratch as uint8 on x's
    device, as many bytes as the library counts (the layout lives only in
    ``csrc/ssd_chunk.cu``), and none when the library asks for none."""
    monkeypatch.setattr(ssd_kernel, "_launcher", lambda: _StubLib())
    x = torch.zeros(1, 576, 1, 4, dtype=getattr(torch, dtype))
    scratch = ssd_ops._scratch(x, 8, 576, 80, 96)
    if want is None:
        assert scratch is None
    else:
        assert scratch.dtype == torch.uint8 and scratch.numel() == want
        assert scratch.device == x.device


def test_binding_occupancy(monkeypatch):
    """The binding's host side of the occupancy query: the report's fields,
    and a refused query raising."""
    monkeypatch.setattr(ssd_kernel, "_launcher", lambda: _StubLib())
    assert ssd_kernel.occupancy(torch.bfloat16, 8, 80, 96) == {
        "grid": 640, "threads": 192, "smem_bytes": 97312,
        "blocks_per_sm": 2}
    monkeypatch.setattr(ssd_kernel, "_launcher", lambda: _StubLib(err=1))
    with pytest.raises(RuntimeError, match="occupancy"):
        ssd_kernel.occupancy(torch.bfloat16, 8, 80, 96)


# ------------------------------------------------------------- on the card --

# model-layout cases beyond the serve shapes: the largest chunk, P or N
# below 64 (padded by the tensor-core route; 20 x 12 at a chunk of 25 also
# takes plain loads); (B, S, H, P, N, chunk)
MODEL_CASES = [(2, 256, 4, 64, 64, 128), (2, 224, 4, 32, 64, 112),
               (2, 192, 4, 64, 16, 96), (1, 50, 3, 20, 12, 25)]
# bf16 at serve magnitudes (x x 16, B and C x 8, the state x 1e3: |y| to
# 1e5), held to the serve path's tolerance: 1e-4 of the largest |want|
# plus 1e-4 |want| (f32 sums in other orders differ by ~1e-2 there where
# y cancels to near 0); (B, S, H, P, N, chunk)
LARGE_CASES = [(2, 576, 8, 64, 64, 96), (2, 448, 8, 64, 64, 112)]


def _large_inputs(case, seed):
    """A LARGE_CASES draw: bf16 x, B and C scaled up, f32 state x 1e3."""
    B, S, H, P, N, _ = case
    (x, a, dt, bm, cm), _ = _inputs(seed, B, S, P, N, "bfloat16", heads=H)
    s0 = np.random.default_rng(seed).standard_normal((B, H, P, N))
    return (x * 16, a, dt, bm * 8, cm * 8,
            torch.from_numpy(s0.astype(np.float32)) * 1e3)


def _close_at_serve_tol(got, want):
    np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


def _tc_route_arithmetic(x, a, dt, bm, cm, s0, chunk, single=()):
    """The bf16 route's arithmetic, chunk by chunk, on the CPU in f32: C.B^T
    of the bf16 B and C; M = exp(cum_i - cum_j) C.B^T dt_j (lower
    triangle); y = M x + exp(cum) C S^T; S = exp(cum_last) S + (x w)^T B.
    The f32 operands M, S and x w enter as hi = bf16(v) plus
    lo = bf16(v - hi), or, for those named in ``single``, as hi alone."""
    def operand(v, name):
        hi = v.bfloat16().float()
        return hi if name in single else hi + (v - hi).bfloat16().float()
    S = x.shape[1]
    xf, bf, cf = x.float(), bm.float(), cm.float()
    la = torch.log(a.clamp_min(1e-20))
    tri = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    state, ys = s0.clone(), []
    for c0 in range(0, S, chunk):
        rows = slice(c0, c0 + chunk)
        cum = la[:, rows].cumsum(1).transpose(1, 2)            # (B, H, c)
        dtc = dt[:, rows].transpose(1, 2)
        cb = (cf[:, rows] @ bf[:, rows].transpose(1, 2))[:, None]
        seg = torch.where(tri, cum[..., :, None] - cum[..., None, :], 0.0)
        m = operand(torch.where(tri, torch.exp(seg), 0.0) * cb
                    * dtc[..., None, :], "M")
        xc = xf[:, rows].transpose(1, 2)                       # (B, H, c, P)
        cs = cf[:, rows][:, None] @ operand(state, "S").transpose(-1, -2)
        ys.append((m @ xc + torch.exp(cum)[..., None] * cs).transpose(1, 2))
        w = torch.exp(cum[..., -1:] - cum) * dtc
        xw = operand(xc * w[..., None], "xw")
        state = (torch.exp(cum[..., -1])[..., None, None] * state
                 + xw.transpose(-1, -2) @ bf[:, rows][:, None])
    return torch.cat(ys, 1), state


@pytest.mark.parametrize("single", [(), ("M",), ("S",), ("xw",)])
@pytest.mark.parametrize("case", LARGE_CASES)
def test_large_cases_need_split_operands(case, single):
    """LARGE_CASES separate the bf16 route's design from one that rounds
    an f32 operand to a single bf16: the route's arithmetic with every f32
    operand split into hi + lo holds the serve tolerance against the
    per-token recurrence; with M, S or x w rounded once, y or the state
    misses it."""
    x, a, dt, bm, cm, s0 = _large_inputs(case, case[1])
    y, s1 = _tc_route_arithmetic(x, a, dt, bm, cm, s0, case[-1], single)
    yr, sr = ssd_ref.ssd_states_ref(x, a, dt, bm, cm, state0=s0)
    if not single:
        _close_at_serve_tol(y, yr)
        _close_at_serve_tol(s1, sr)
        return
    with pytest.raises(AssertionError):
        _close_at_serve_tol(y, yr)
        _close_at_serve_tol(s1, sr)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """The hand-written kernel against its plain version on the card: the
    TPU test's shapes in f32 and bf16, the serve path's head dims with a
    non-zero initial state at chunks 96 and 112, a ragged chunk of 7,
    MODEL_CASES (y and the state at f32's tolerance whatever x's type) and,
    in bf16, LARGE_CASES; y and the final state, the launches, and the
    library's scratch count at the serve shapes."""
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
        for B, S, H, P, N, chunk in MODEL_CASES:
            ours, _ = _inputs(S + N, B, S, P, N, dtype, heads=H)
            ours = [t.cuda() for t in ours]
            s0 = torch.randn(B, H, P, N, device="cuda")
            y, s1 = ssd_ops.ssd_chunk_bshp(*ours, chunk=chunk, state0=s0)
            yr, sr = ssd_ref.ssd_states_ref(*ours, state0=s0)
            torch.cuda.synchronize()
            _close(y, yr, TOL["float32"])       # y and the state are f32
            _close(s1, sr, TOL["float32"])
            n += 1
    for case in LARGE_CASES:
        x, a, dt, bm, cm, s0 = (t.cuda() for t in _large_inputs(case,
                                                                  case[1]))
        y, s1 = ssd_ops.ssd_chunk_bshp(x, a, dt, bm, cm, chunk=case[-1],
                                       state0=s0)
        yr, sr = ssd_ref.ssd_states_ref(x, a, dt, bm, cm, state0=s0)
        torch.cuda.synchronize()
        _close_at_serve_tol(y, yr)
        _close_at_serve_tol(s1, sr)
        n += 1
    assert ssd_ops.launches == {"ssd_chunk": n}
    for (S, chunk), nbytes in SERVE_SCRATCH.items():
        assert ssd_kernel.scratch_bytes(torch.bfloat16, 8, S, 80,
                                        chunk) == nbytes
        assert ssd_kernel.scratch_bytes(torch.float32, 8, S, 80, chunk) == 0
