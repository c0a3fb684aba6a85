"""Plain PyTorch building blocks of the references, in float32.

Nothing here imports the program: each reference family
(``reference/<family>.py``) writes its model out of these blocks, under
the program's parameter names, and ``train`` runs the first steps of
training from the benchmark's weights and batches.

Every product goes through a ``Matmul``: ``F32`` computes it as it is
(TF32 is switched off by the harness), ``FP8`` is the control of the
output check: both operands rounded to float8 e4m3 with a per-tensor
scale, and in the backward the incoming gradient to e5m2, as an fp8
training path computes them.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32


# -- products ------------------------------------------------------------------

def _fp8(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` (float8) under a per-tensor scale that
    maps its largest magnitude to the format's largest, back in f32."""
    top = torch.finfo(dtype).max
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = top / amax
    return (t * scale).to(dtype).to(F32) / scale


class _Fp8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq, bq = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(aq, bq)
        return torch.matmul(aq, bq)

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _fp8(g, torch.float8_e5m2)
        da = torch.matmul(gq, bq.transpose(-1, -2))
        db = torch.matmul(aq.transpose(-1, -2), gq)
        # broadcast batch dims back to each operand's shape
        while da.dim() > aq.dim():
            da = da.sum(0)
        while db.dim() > bq.dim():
            db = db.sum(0)
        return da, db


def F32_MM(a, b):
    return torch.matmul(a, b)


def FP8_MM(a, b):
    return _Fp8Product.apply(a, b)


MATMULS = {"f32": F32_MM, "fp8": FP8_MM}


# -- layers --------------------------------------------------------------------

def rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """x [B, S, H, Dh]: rotate the two halves by position x frequency."""
    s, half = x.shape[1], x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=F32, device=x.device) / half)
    ang = torch.arange(s, dtype=F32, device=x.device)[:, None] * freqs
    sin, cos = torch.sin(ang)[None, :, None, :], torch.cos(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(mm, x, p, *, n_heads, n_kv, head_dim, theta, window=0):
    """Causal multi-head attention with RoPE (and, with ``window``, keys
    no further back than window - 1 positions). ``p`` holds wq, wk, wv
    [d, H, Dh] and wo [H, Dh, d]."""
    b, s, d = x.shape
    q = mm(x, p["wq"].reshape(d, -1)).view(b, s, n_heads, head_dim)
    k = mm(x, p["wk"].reshape(d, -1)).view(b, s, n_kv, head_dim)
    v = mm(x, p["wv"].reshape(d, -1)).view(b, s, n_kv, head_dim)
    q, k = rope(q, theta), rope(k, theta)
    rep = n_heads // n_kv
    q = q.transpose(1, 2)                                     # [B,H,S,Dh]
    k = k.transpose(1, 2).repeat_interleave(rep, dim=1)
    v = v.transpose(1, 2).repeat_interleave(rep, dim=1)
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(head_dim)
    pos = torch.arange(s, device=x.device)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask = mask & (pos[None, :] > pos[:, None] - window)
    scores = scores.masked_fill(~mask, float("-inf"))
    o = mm(torch.softmax(scores, dim=-1), v)                  # [B,H,S,Dh]
    o = o.transpose(1, 2).reshape(b, s, n_heads * head_dim)
    return mm(o, p["wo"].reshape(n_heads * head_dim, d))


def swiglu(mm, x, wi, wg, wo):
    return mm(mm(x, wi) * F.silu(mm(x, wg)), wo)


def lm_loss(mm, x, unembed, labels):
    """Mean cross-entropy of the logits x @ unembed over every token."""
    logits = mm(x, unembed)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


# -- training ------------------------------------------------------------------

def lr_at(opt: dict, step: int) -> float:
    """The learning rate at ``step`` (from 1): linear warm-up, then a
    cosine to ``min_lr_frac``, in f32."""
    f = np.float32
    s = f(step)
    warm = min(s / f(max(opt["warmup_steps"], 1)), f(1.0))
    prog = np.clip((s - f(opt["warmup_steps"]))
                   / f(max(opt["total_steps"] - opt["warmup_steps"], 1)),
                   f(0.0), f(1.0))
    cos = f(opt["min_lr_frac"]) + f((1 - opt["min_lr_frac"]) * 0.5) * (
        f(1.0) + np.cos(f(math.pi) * prog))
    return float(f(opt["lr"]) * f(warm) * f(cos))


def units(name: str, t: torch.Tensor):
    """The leaves of the published model in parameter ``name``: itself,
    or one a row for a stack of experts ([E, in, out] under ``.ffn.``,
    which the published model keeps as E matrices)."""
    if t.dim() == 3 and ".ffn." in name:
        return [(f"{name}[{e}]", t[e]) for e in range(t.shape[0])]
    return [(name, t)]


def leaf_norms(names, leaf: Callable,
               scale: float = 1.0) -> Dict[str, float]:
    """{unit: norm x scale} over the ``units`` of ``leaf(name)`` for each
    name, in one transfer; each leaf's tensor is freed before the next is
    made."""
    keys, vals = [], []
    for k in names:
        t = leaf(k)
        for unit, u in units(k, t):
            keys.append(unit)
            vals.append(torch.linalg.vector_norm(u.float()))
        del t
    return dict(zip(keys, (torch.stack(vals) * scale).tolist()))


def train(loss_fn: Callable, params: Dict[str, torch.Tensor],
          stored: Dict[str, torch.dtype], batches: List[dict], opt: dict,
          fault: Optional[str] = None) -> dict:
    """Train ``params`` (f32 leaves) for ``len(batches)`` AdamW steps and
    return the three readings the check compares: each step's loss, each
    leaf's gradient norm at the first step, and each leaf's change over
    all the steps.

    The update is AdamW with decoupled weight decay; a leaf stored in
    bf16 (``stored``) is rounded to bf16 after each update, as the
    configuration keeps its weights, and its moments stay f32.

    ``fault`` plants one of the check's faults in the reference put in the
    program's place: ``"unchanged"`` (the step leaves the state as it
    was), ``"half_batch"`` (the loss over the first half of the rows),
    ``"grad_altered"`` (the gradient of one leaf doubled where it is
    produced), ``"no_decay"`` (no weight decay), ``"betas_swapped"``
    (the two betas exchanged)."""
    start = {k: p.detach().clone() for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2, eps, wd = opt["beta1"], opt["beta2"], opt["eps"], \
        opt["weight_decay"]
    if fault == "no_decay":
        wd = 0.0
    if fault == "betas_swapped":
        b1, b2 = b2, b1
    losses, grad_norms = [], None
    for i, batch in enumerate(batches):
        if fault == "half_batch":
            half = max(1, batch["tokens"].shape[0] // 2)
            batch = {k: t[:half] for k, t in batch.items()}
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss = loss_fn(leaves, batch)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True,
            materialize_grads=True)))
        del leaves
        losses.append(float(loss.detach()))
        if fault == "grad_altered":
            name = max(grads, key=lambda k: grads[k].numel())
            grads[name] = grads[name] * 2
        if grad_norms is None:
            grad_norms = leaf_norms(list(grads), grads.__getitem__)
        if fault == "unchanged":
            continue
        step = i + 1
        lr = lr_at(opt, step)
        bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                delta = (m[k] / bc1) / ((v[k] / bc2).sqrt() + eps) + wd * p
                p.sub_(lr * delta)
                if stored[k] != F32:
                    p.copy_(p.to(stored[k]).to(F32))
        del grads
    change = leaf_norms(list(params), lambda k: params[k] - start[k])
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
