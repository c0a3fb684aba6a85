"""Dispatch between the CUDA kernels and their plain versions.

Counterpart of ``repro/kernels/ops.py``. A tensor on the CPU, or
``backend="ref"``, goes to the plain PyTorch version in ``ref``; a CUDA
tensor goes to the hand-written kernel, which raises on what it does not
take. There is no fallback from the kernel to the plain version: a build or
launch failure surfaces. A CUDA call that autograd must differentiate
(grad mode on and an input that requires grad) goes through the
``kernels.autograd`` Function, whose backward is a kernel too; any other
CUDA call launches the forward kernel alone. A ``meta`` tensor goes to
``kernels.meta``: one op a kernel call, the kernel's output shapes and
dtypes and its work from ``kernels/cost.py`` (for the dry run); the CPU and
CUDA routes never reach it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import autograd, meta, ref
from repro_torch.kernels.flash_attention import flash_attention as _flash_cuda
from repro_torch.kernels.mamba_scan import mamba_chunk_scan as _mamba_cuda
from repro_torch.kernels.rmsnorm import add_rmsnorm as _add_rmsnorm_cuda
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm_cuda

BACKENDS = ("auto", "ref")


_META = "meta"


def _use_kernel(x: torch.Tensor, backend: str):
    """True for the CUDA kernel, False for the plain version, ``_META``
    for the shape-only op of a meta tensor."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "ref" or x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    if x.device.type == "meta":
        return _META
    raise ValueError(f"no kernel for tensors on {x.device}")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              backend: str = "auto"):
    """Flash attention. q: [B,Hq,Sq,D]; k, v: [B,Hkv,Skv,D] (any strides;
    Skv may differ from Sq, as in the VLM's cross-attention over its image
    memory, non-causal). Positions start at 0 on both sides."""
    route = _use_kernel(q, backend)
    if route is _META:
        return meta.flash_attention(q, k, v, causal, window)[0]
    if route:
        if _needs_grad(q, k, v):
            return autograd.FlashAttention.apply(q, k, v, causal, window)
        return _flash_cuda(q, k, v, causal=causal, window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def rmsnorm(x, w, *, eps: float = 1e-5, backend: str = "auto"):
    """RMSNorm over the last dimension of x with weight w."""
    route = _use_kernel(x, backend)
    if route is _META:
        return meta.rmsnorm(x, w, eps)
    if route:
        if _needs_grad(x, w):
            return autograd.RMSNorm.apply(x, w, eps)
        return _rmsnorm_cuda(x, w, eps=eps)
    return ref.rmsnorm_ref(x, w, eps=eps)


def add_rmsnorm(x, r, w, *, eps: float = 1e-5, backend: str = "auto"):
    """The residual add and the RMSNorm after it: (s = x + r in x's dtype,
    rmsnorm(s, w)), one launch on the card."""
    route = _use_kernel(x, backend)
    if route is _META:
        return meta.add_rmsnorm(x, r, w, eps)
    if route:
        if _needs_grad(x, r, w):
            return autograd.AddRMSNorm.apply(x, r, w, eps)
        return _add_rmsnorm_cuda(x, r, w, eps=eps)
    return ref.add_rmsnorm_ref(x, r, w, eps=eps)


def mamba_chunk_scan(x, b, c, dt, da, *, chunk: int = 128, out_dtype=None,
                     backend: str = "auto"):
    """Mamba2 SSD scan from h = 0. x: [B,S,H,P]; b, c: [B,S,N]; dt, da:
    [B,S,H] -> (y [B,S,H,P] in ``out_dtype`` or x's dtype, h [B,H,P,N]
    f32). S must divide by ``chunk`` on both paths; the plain version's
    result does not depend on it."""
    if chunk <= 0 or x.shape[1] % chunk:
        raise ValueError(f"sequence length {x.shape[1]} must divide by "
                         f"chunk={chunk}")
    route = _use_kernel(x, backend)
    if route is _META:
        return meta.mamba_chunk_scan(
            x, b, c, dt, da, chunk, x.dtype if out_dtype is None else out_dtype)
    if route:
        if _needs_grad(x, b, c, dt, da):
            return autograd.MambaChunkScan.apply(x, b, c, dt, da, chunk,
                                                 out_dtype)
        return _mamba_cuda(x, b, c, dt, da, chunk=chunk, out_dtype=out_dtype)
    return ref.mamba_chunk_scan_ref(x, b, c, dt, da, out_dtype=out_dtype)
