"""Plain PyTorch versions of the hand-written kernels (the ground truth).

Counterparts of ``repro/kernels/ref.py``: quadratic attention with explicit
masks, the elementwise norm (alone, and after the residual add) and the
exact per-step SSM recurrence. The CPU path of ``kernels.ops`` runs these,
and ``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

F32 = torch.float32
NEG_INF = -1e30


def _masked_scores(q, k, causal, window):
    """The scaled f32 scores q k^T D^-1/2 of every (q head, key), masked
    to NEG_INF where causality or the window hides the key, and the mask."""
    _, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    k = k.repeat_interleave(hq // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32), k.to(F32))
    s = s * d ** -0.5
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    return torch.where(mask, s, NEG_INF), mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B,Hq,Sq,D]; k, v: [B,Hkv,Skv,D] -> [B,Hq,Sq,D] in q's dtype.

    Positions start at 0 on both sides. Scores, softmax and the PV product
    stay in f32 (as the TPU kernel keeps them)."""
    s, _ = _masked_scores(q, k, causal, window)
    v = v.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(F32)).to(q.dtype)


def flash_attention_lse_ref(q, k, *, causal: bool = True, window: int = 0):
    """The natural-log logsumexp of each row's scaled scores over the keys
    it sees, f32 [B,Hq,Sq] (what the forward kernels write when asked; +inf
    for a row that sees no key, whose output the kernels leave 0)."""
    s, mask = _masked_scores(q, k, causal, window)
    seen = torch.where(mask, s, -torch.inf)
    lse = torch.logsumexp(seen, dim=-1)
    return torch.where(mask.any(-1), lse, torch.inf)


def rmsnorm_ref(x, w, *, eps: float = 1e-5):
    """x: [..., d]; w: [d]. f32 mean of squares, result in x's dtype."""
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(F32)).to(x.dtype)


def add_rmsnorm_ref(x, r, w, *, eps: float = 1e-5):
    """The residual add, then the norm: (s = x + r in x's dtype,
    rmsnorm_ref(s, w))."""
    s = x + r
    return s, rmsnorm_ref(s, w, eps=eps)


def mamba_chunk_scan_ref(x, b, c, dt, da, *, out_dtype=None):
    """Exact per-timestep SSM recurrence, from h = 0.

    x: [B,S,H,P]; b, c: [B,S,N]; dt, da: [B,S,H] (da = dt * A).
    h_t = exp(da_t) h_{t-1} + dt_t x_t B_t^T;  y_t = C_t . h_t
    Returns (y [B,S,H,P] in ``out_dtype`` (x's dtype by default), the final
    h [B,H,P,N] in f32); all arithmetic in f32."""
    bsz, s, nh, p = x.shape
    n = b.shape[-1]
    xf, bf, cf = x.to(F32), b.to(F32), c.to(F32)
    dtf, dec = dt.to(F32), torch.exp(da.to(F32))
    hs = torch.zeros((bsz, nh, p, n), dtype=F32, device=x.device)
    ys = []
    for t in range(s):
        upd = (xf[:, t] * dtf[:, t, :, None])[..., None] * bf[:, t, None, None]
        hs = hs * dec[:, t, :, None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", cf[:, t], hs))
    y = torch.stack(ys, dim=1)
    return y.to(x.dtype if out_dtype is None else out_dtype), hs


# ---------------------------------------------------------------------------
# plain backward versions: autograd of the plain forwards above
# ---------------------------------------------------------------------------

def _grad(fn, inputs, outputs_grads):
    """Gradients of ``fn(*inputs)`` (a tensor or a tuple of tensors) with
    respect to every input, given the gradients of its outputs (None: no
    gradient reaches that output)."""
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    with torch.enable_grad():
        out = fn(*leaves)
        out = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(out, outputs_grads) if g is not None]
        return torch.autograd.grad([o for o, _ in pairs],
                                   leaves, [g for _, g in pairs])


def rmsnorm_bwd_ref(dy, x, w, *, eps: float = 1e-5):
    """(dx, dw) of ``rmsnorm_ref(x, w)`` given dy."""
    return _grad(lambda x_, w_: rmsnorm_ref(x_, w_, eps=eps), (x, w), (dy,))


def add_rmsnorm_bwd_ref(dy, ds, s, w, *, eps: float = 1e-5):
    """(dsum, dw) of ``add_rmsnorm_ref`` given the gradients of its outputs
    (ds of s, None for none; dy of y), from the sum s: dsum is the gradient
    of both x and r."""
    def fn(s_, w_):
        return s_, rmsnorm_ref(s_, w_, eps=eps)
    dsum, dw = _grad(fn, (s, w), (ds, dy))
    return dsum, dw


def flash_attention_bwd_ref(q, k, v, do, *, causal: bool = True,
                            window: int = 0):
    """(dq, dk, dv) of ``flash_attention_ref(q, k, v)`` given dO."""
    return _grad(lambda q_, k_, v_: flash_attention_ref(
        q_, k_, v_, causal=causal, window=window), (q, k, v), (do,))


def mamba_chunk_scan_bwd_ref(x, b, c, dt, da, dy, dh=None):
    """(dx, db, dc, ddt, dda) of ``mamba_chunk_scan_ref(x, b, c, dt, da)``
    given dy, the gradient of y (f32, or x's dtype for a y written in it),
    and dh, the gradient of the final h (None: the final h is unused)."""
    out_dtype = dy.dtype
    return _grad(lambda *a: mamba_chunk_scan_ref(*a, out_dtype=out_dtype),
                 (x, b, c, dt, da), (dy, dh))
