"""Flash attention forward on the card: wrapper of the hand-written CUDA
kernels in ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` (causal, sliding
window, GQA; positions from 0). At the qwen3-8b prefill shape its least
time on the H100 is set by memory traffic (q, k, v read once, o written
once: ~42 MB, 12.5 us). bf16 goes to the tensor-core kernel (TMA loads into
a shared-memory ring, both products with ``wgmma``); f32 goes to the
f32-FMA kernel, whose full-f32 products the reduced card-vs-CPU checks rely
on. Both read q, k and v through their strides, so the model's
[B, S, H, D] projections go in without a transposed copy, and write the
output in [B, S, H, D] storage. ``ops.attention`` routes CUDA tensors here
and CPU tensors to ``ref.flash_attention_ref``.

``flash_attention(..., return_lse=True)`` also returns each row's
logsumexp (``ref.flash_attention_lse_ref``), which the bf16 backward reads.
``flash_attention_bwd`` wraps the backward kernels of
``csrc/flash_attention_bwd.cu``: bf16 on the tensor cores (a prep kernel,
a dq kernel and a dk/dv kernel, TMA and ``wgmma``), f32 on FMAs; no atomics.
``kernels.autograd`` calls it from the backward of its
``torch.autograd.Function``.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm import DTYPE_CODES

HEAD_DIMS = (32, 64, 112, 128)
ALIGN_BYTES = 16        # base addresses and (batch, seq, head) strides
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 21
             + [ctypes.c_float, ctypes.c_void_p])
_INT_MAX = 2 ** 31 - 1


def check_layout(shape: Sequence[int], stride: Sequence[int],
                 dtype: torch.dtype, data_ptr: int) -> None:
    """Raise ``ValueError`` unless the kernels can read a [B, H, S, D]
    operand of this shape, element strides, dtype and base address: a
    contiguous head dim, a 16-byte aligned base, and (batch, seq, head)
    strides that are whole multiples of 16 bytes (8 bf16 or 4 f32
    elements) and fit an int. The bf16 kernel's TMA tensor maps need the
    16 bytes; the f32 kernel's float4 loads need the same. The model's
    [B, S, H, D] views meet it (head stride 128 or 112 elements)."""
    itemsize = dtype.itemsize
    if len(shape) != 4 or len(stride) != 4:
        raise ValueError(f"want a [B, H, S, D] operand, got shape "
                         f"{tuple(shape)}")
    if stride[3] != 1 or data_ptr % ALIGN_BYTES or \
            any(s * itemsize % ALIGN_BYTES for s in stride[:3]) or \
            max(stride) > _INT_MAX:
        raise ValueError(
            f"flash attention kernel needs a contiguous head dim, a "
            f"{ALIGN_BYTES}-byte aligned base and (batch, head, seq) strides "
            f"that are multiples of {ALIGN_BYTES // itemsize} {dtype} "
            f"elements; got strides {tuple(stride)} at address "
            f"{data_ptr:#x}")


def _bsh_strides(t: torch.Tensor):
    """(batch, seq, head) strides of a [B, H, S, D] tensor."""
    return t.stride(0), t.stride(2), t.stride(1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] CUDA tensors of one dtype
    (bf16 or f32) laid out as ``check_layout`` requires. Returns o,
    [B, Hq, Sq, D] in q's dtype, a view of a new contiguous [B, Sq, Hq, D]
    tensor; with ``return_lse`` (o, lse), lse the natural-log logsumexp of
    each row's scaled, masked scores, f32 [B, Hq, Sq] (o is the same bits
    either way). Each launch adds one to ``flash_attention.launches`` and
    one to ``flash_attention.calls`` at its ``kernels.cost.attention``
    arguments (B, Hq, Hkv, Sq, Skv, D, dtype, causal, window)."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash attention kernel needs q, k, v on one CUDA "
                         "device")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel takes one dtype of "
                        f"{list(DTYPE_CODES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,Hq,Sq,D] and k, v [B,Hkv,Skv,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, skv, dk = k.shape
    if k.shape[0] != b or dk != d or d not in HEAD_DIMS or hq % hkv:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}: need equal B and D, D in "
                         f"{HEAD_DIMS}, Hq % Hkv == 0")
    for t in (q, k, v):
        check_layout(t.shape, t.stride(), t.dtype, t.data_ptr())
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=dev).transpose(1, 2)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    if b == 0 or sq == 0 or hq == 0:
        return (o, lse) if return_lse else o
    if skv == 0:
        raise ValueError("flash attention kernel needs at least one key")
    fn = build.load_function("flash_attention", "flash_attention_fwd",
                             _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             None if lse is None else lse.data_ptr(),
             DTYPE_CODES[q.dtype], b, hq, hkv, sq, skv, d,
             *_bsh_strides(q), *_bsh_strides(k), *_bsh_strides(v),
             *_bsh_strides(o), int(causal), int(window), d ** -0.5,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check("flash_attention", err)
    flash_attention.launches += 1
    flash_attention.calls[(b, hq, hkv, sq, skv, d, q.dtype, bool(causal),
                           int(window))] += 1
    return (o, lse) if return_lse else o


flash_attention.launches = 0
# launches by ``kernels.cost.attention``'s arguments
flash_attention.calls = collections.Counter()


# ---------------------------------------------------------------------------
# backward (csrc/flash_attention_bwd.cu)
# ---------------------------------------------------------------------------

_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 33
                 + [ctypes.c_float, ctypes.c_void_p])


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor,
                        lse: Optional[torch.Tensor] = None, *,
                        causal: bool = True, window: int = 0):
    """Gradient of ``flash_attention(q, k, v)`` = o given dO: (dq, dk, dv)
    in the inputs' dtype, each a [B, H, S, D] view of new [B, S, H, D]
    storage (the forward output's layout). q, o, dO: [B, Hq, Sq, D]; k, v:
    [B, Hkv, Skv, D]; every operand laid out as ``check_layout`` requires.
    ``lse``: the forward's logsumexp (``flash_attention(...,
    return_lse=True)``), f32 [B, Hq, Sq]; the bf16 kernels need it, the f32
    kernels recompute their own and ignore it. No atomics: the dk/dv
    kernels sum over the group's q heads and q tiles in a fixed order."""
    dev = q.device
    ops_ = (q, k, v, o, do)
    if dev.type != "cuda" or any(t.device != dev for t in ops_):
        raise ValueError("flash attention backward needs its tensors on one "
                         "CUDA device")
    if q.dtype not in DTYPE_CODES or any(t.dtype != q.dtype for t in ops_):
        raise TypeError(f"flash attention backward takes one dtype of "
                        f"{list(DTYPE_CODES)}, got "
                        f"{[t.dtype for t in ops_]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"want q, o, dO [B,Hq,Sq,D] and k, v [B,Hkv,Skv,D], "
                         f"got {[tuple(t.shape) for t in ops_]}")
    b, hq, sq, d = q.shape
    _, hkv, skv, dk_ = k.shape
    if k.shape[0] != b or dk_ != d or d not in HEAD_DIMS or hq % hkv:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}: need equal B and D, D in "
                         f"{HEAD_DIMS}, Hq % Hkv == 0")
    for t in ops_:
        check_layout(t.shape, t.stride(), t.dtype, t.data_ptr())
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and (lse is None or lse.shape != (b, hq, sq) or
                 lse.dtype != torch.float32 or lse.device != dev or
                 not lse.is_contiguous()):
        raise ValueError(f"the bf16 backward needs the forward's lse, a "
                         f"contiguous f32 [{b}, {hq}, {sq}] on {dev}; got "
                         f"{None if lse is None else (lse.shape, lse.dtype)}")
    dq = torch.empty((b, sq, hq, d), dtype=q.dtype, device=dev).transpose(1, 2)
    dk = torch.empty((b, skv, hkv, d), dtype=q.dtype,
                     device=dev).transpose(1, 2)
    dv = torch.empty_like(dk)
    if b == 0 or sq == 0 or hq == 0:
        return dq, dk.zero_(), dv.zero_()
    if skv == 0:
        raise ValueError("flash attention backward needs at least one key")
    scratch = torch.empty(bwd_scratch_floats(q.dtype, b, hq, sq),
                          dtype=torch.float32, device=dev)
    fn = build.load_function("flash_attention_bwd", "flash_attention_bwd",
                             _BWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr() if bf16 else None,
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             scratch.data_ptr(), DTYPE_CODES[q.dtype], b, hq, hkv, sq, skv,
             d, *(s for t in (q, k, v, o, do, dq, dk, dv)
                  for s in _bsh_strides(t)),
             int(causal), int(window), d ** -0.5,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check("flash_attention_bwd", err)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.calls[(b, hq, hkv, sq, skv, d, q.dtype, bool(causal),
                               int(window))] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.calls = collections.Counter()


def bwd_scratch_floats(dtype: torch.dtype, b: int, hq: int, sq: int) -> int:
    """f32 scratch of the backward: two [B, Hq, Sq] arrays (the f32
    kernels' lse and D_row), or for bf16 two [B, Hq, Sq rounded up to 64]
    (L = lse log2(e) and D_row, padded to whole 64-row tiles)."""
    rows = -(-sq // 64) * 64 if dtype == torch.bfloat16 else sq
    return 2 * b * hq * rows
