"""``torch.autograd.Function``s around the CUDA kernels, for training on
the card.

The forward of each calls the existing forward kernel and saves what the
backward kernel reads; the backward calls the hand-written backward kernel
(``rmsnorm_bwd``, ``add_rmsnorm_bwd``, ``flash_attention_bwd``,
``mamba_chunk_scan_bwd``). The JAX
package has no backward kernels (its model differentiates jnp code); these
exist so that no plain PyTorch version runs on the card's training path.
``kernels.ops`` routes a CUDA call here only when grad mode is on and an
input requires grad; otherwise it calls the forward kernel directly, so
inference launches nothing more. CPU tensors never come here: ``ops``
sends them to ``ref``, whose autograd gives the gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import rmsnorm as rn


class RMSNorm(torch.autograd.Function):
    """y = rmsnorm(x, w); saves x and w."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, w)
        return rn.rmsnorm(x, w, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rn.rmsnorm_bwd(dy, x, w, eps=ctx.eps)
        return dx, dw, None


class AddRMSNorm(torch.autograd.Function):
    """(s, y) = (x + r, rmsnorm(x + r, w)); saves s and w. The backward
    gets (ds, dy) and gives x and r the same gradient."""

    @staticmethod
    def forward(ctx, x, r, w, eps):
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        s, y = rn.add_rmsnorm(x, r, w, eps=eps)
        ctx.save_for_backward(s, w)
        return s, y

    @staticmethod
    def backward(ctx, ds, dy):
        s, w = ctx.saved_tensors
        if dy is None:                  # only s was used downstream
            return ds, ds, None, None
        dsum, dw = rn.add_rmsnorm_bwd(dy, ds, s, w, eps=ctx.eps)
        return dsum, dsum, dw, None


class FlashAttention(torch.autograd.Function):
    """o = flash_attention(q, k, v); saves q, k, v, o and the rows'
    logsumexp (the forward writes it when asked; the bf16 backward reads
    it in place of a sweep that recomputes it)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.causal, ctx.window = causal, window
        o, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                    return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        try:
            fa.check_layout(do.shape, do.stride(), do.dtype, do.data_ptr())
        except ValueError:
            # autograd handed dO in another layout: the kernel's own
            do = do.transpose(1, 2).contiguous().transpose(1, 2)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, do, lse,
                                            causal=ctx.causal,
                                            window=ctx.window)
        return dq, dk, dv, None, None


class MambaChunkScan(torch.autograd.Function):
    """(y, h) = mamba_chunk_scan(x, b, c, dt, da); saves x, b, c, dt and
    da (the backward recomputes the chunk states). A gradient that does not
    reach y or h arrives as None."""

    @staticmethod
    def forward(ctx, x, b, c, dt, da, chunk, out_dtype):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        y, h = ms.mamba_chunk_scan(x, b, c, dt, da, chunk=chunk,
                                   out_dtype=out_dtype)
        ctx.save_for_backward(x, b, c, dt, da)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, b, c, dt, da = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        elif dy.dtype not in (torch.float32, x.dtype):
            dy = dy.float()             # y was asked in a third dtype
        if dy.shape[-1] > 1 and dy.stride(-1) != 1:
            dy = dy.contiguous()        # the kernel's layout rule
        if dh is not None:
            dh = dh.contiguous()
        grads = ms.mamba_chunk_scan_bwd(x, b, c, dt, da, dy, dh,
                                        chunk=ctx.chunk)
        return (*grads, None, None)
