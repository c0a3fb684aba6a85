"""Plain PyTorch versions of the hand-written kernels (the ground truth).

Counterparts of ``repro/kernels/ref.py``: quadratic attention with explicit
masks and the elementwise norm. The CPU path of ``kernels.ops`` runs these,
and ``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

F32 = torch.float32
NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B,Hq,Sq,D]; k, v: [B,Hkv,Skv,D] -> [B,Hq,Sq,D] in q's dtype.

    Positions start at 0 on both sides. Scores, softmax and the PV product
    stay in f32 (as the TPU kernel keeps them)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32), k.to(F32))
    s = s * d ** -0.5
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(F32)).to(q.dtype)


def rmsnorm_ref(x, w, *, eps: float = 1e-5):
    """x: [..., d]; w: [d]. f32 mean of squares, result in x's dtype."""
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(F32)).to(x.dtype)
