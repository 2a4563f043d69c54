"""Plain PyTorch versions of flash attention (materialized scores): the
CPU path of ``ops.py`` and the oracle the CUDA kernel is held against on
the card. Scores, softmax and the weighted sum are f32; the output is in
q's dtype."""
import torch

NEG_INF = -1e30


def flash_attention_bshd_ref(q, k, v, *, causal: bool = True,
                             window: int = 0, q_offset: int = 0):
    """q (B, Sq, Hq, d), k (B, Skv, Hkv, d), v (B, Skv, Hkv, d_v) -> (B,
    Sq, Hq, d_v), scale d^-1/2 (q's head dim, never v's); GQA by head
    grouping (query head h reads KV head h // (Hq / Hkv)); query row i sits
    at position q_offset + i for the causal and window masks."""
    B, Sq, Hq, d = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, Sq, Hkv, G, d) * (d ** -0.5)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """The TPU kernel's layout: q (BH, Sq, d), k/v (BH, Skv, d), heads
    pre-flattened -> (BH, Sq, d)."""
    return flash_attention_bshd_ref(
        q[:, :, None], k[:, :, None], v[:, :, None], causal=causal,
        window=window, q_offset=q_offset)[:, :, 0]
