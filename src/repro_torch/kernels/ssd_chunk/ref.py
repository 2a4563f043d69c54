"""Plain PyTorch version of the SSD scan: the per-token recurrence (the
JAX package's ``ssd_chunk/ref.py``), extended with an initial state and
the final state. It is the CPU path of ``ops.py`` and the oracle the CUDA
kernel is held against on the card."""
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
