"""Plain PyTorch versions of the SSD scan: the per-token recurrence (the
JAX package's ``ssd_chunk/ref.py``), extended with an initial state and
the final state, is the CPU path of ``ops.py`` and the oracle the CUDA
kernel is held against on the card; the chunked form (the JAX package's
``models/ssm.py::_ssd_chunked``) is the models' CPU path and what the
kernel's backward differentiates (its autograd keeps a chunk's tensors,
not one state per token)."""
import torch


def ssd_states_ref(xh, a, dt, bm, cm, state0=None):
    """The model's layout: xh (B, S, H, P), a/dt (B, S, H), bm/cm (B, S, N)
    shared by the H heads, state0 (B, H, P, N) or None (zeros) ->
    (y (B, S, H, P) f32, final state (B, H, P, N) f32), all math f32:
    S_t = a_t S_{t-1} + dt_t x_t (x) B_t, y_t = S_t C_t."""
    B, S, H, P = xh.shape
    N = bm.shape[-1]
    state = (torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
             if state0 is None else state0.float())
    x, a, dt = xh.float(), a.float(), dt.float()
    bm, cm = bm.float(), cm.float()
    ys = []
    for t in range(S):
        upd = (x[:, t] * dt[:, t, :, None])[..., None] * bm[:, t, None, None]
        state = state * a[:, t, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, cm[:, t]))
    return torch.stack(ys, 1), state


def ssd_chunk_ref(xh, a, dt, bm, cm):
    """The TPU kernel's layout: xh (BH, S, P), a/dt (BH, S), bm/cm (BH, S,
    N) -> y (BH, S, P) in xh's dtype, from a zero state."""
    y, _ = ssd_states_ref(xh.unsqueeze(2), a.unsqueeze(2), dt.unsqueeze(2),
                          bm, cm)
    return y.squeeze(2).to(xh.dtype)


def ssd_chunked_ref(xh, a, dt, Bm, Cm, chunk, state0=None):
    """The chunked SSD form in the model's layout: xh (B,S,H,P), a (B,S,H)
    decay in (0,1], dt (B,S,H), Bm/Cm (B,S,N), state0 (B,H,P,N) f32 or
    None -> (y (B,S,H,P) f32, final state (B,H,P,N) f32); ``chunk`` is
    taken as min(chunk, S) and must divide S."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"chunk {c} does not divide the sequence {S}")
    nc = S // c

    xr = xh.reshape(B, nc, c, H, P).float()
    ar = a.reshape(B, nc, c, H)
    dtr = dt.reshape(B, nc, c, H)
    Br = Bm.reshape(B, nc, c, N).float()
    Cr = Cm.reshape(B, nc, c, N).float()

    la = torch.log(torch.clamp(ar, min=1e-20)).float()
    cum = torch.cumsum(la, dim=2)                          # log prod a_1..t

    state = (torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
             if state0 is None else state0)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=xh.device))[None, :, :, None]
    ys = []
    for k in range(nc):
        x_c, cum_c, dt_c = xr[:, k], cum[:, k], dtr[:, k]
        B_c, C_c = Br[:, k], Cr[:, k]
        # intra-chunk: y[i] += sum_{j<=i} exp(cum_i - cum_j) dt_j (C_i·B_j) x_j
        seg = cum_c[:, :, None, :] - cum_c[:, None, :, :]    # (B,i,j,H)
        # double-where: exp() never sees the +inf upper triangle
        seg = torch.where(mask, seg, 0.0)
        dec = torch.where(mask, torch.exp(seg), 0.0)
        cb = torch.einsum("bin,bjn->bij", C_c, B_c)          # (B,i,j)
        M = dec * cb[..., None] * dt_c[:, None, :, :]        # (B,i,j,H)
        y_intra = torch.einsum("bijh,bjhp->bihp", M, x_c)
        # inter-chunk: y[i] += exp(cum_i) * C_i @ state^T
        y_inter = (torch.einsum("bin,bhpn->bihp", C_c, state)
                   * torch.exp(cum_c)[..., None])
        # state update: S' = a_total*S + sum_j exp(cum_last-cum_j) dt_j x_j⊗B_j
        w_j = torch.exp(cum_c[:, -1:, :] - cum_c) * dt_c     # (B,c,H)
        ds = torch.einsum("bjhp,bjn,bjh->bhpn", x_c, B_c, w_j)
        state = state * torch.exp(cum_c[:, -1])[:, :, None, None] + ds
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B, S, H, P)
    return y, state
