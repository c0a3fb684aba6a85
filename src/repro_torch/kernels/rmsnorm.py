"""RMSNorm on the card: wrapper of the hand-written CUDA kernel
``csrc/rmsnorm.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm``. It is
memory-bound on the H100 (about 3 flops per element against two accesses),
so its least time is 2 * rows * d * bytes / 3.35 TB/s; the kernel reads
each row once with 16-byte loads, reduces in f32 registers and writes once
(see the source for the design). ``ops.rmsnorm`` routes CUDA tensors here
and CPU tensors to ``ref.rmsnorm_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_INT_MAX = 2 ** 31 - 1


def row_view(x: torch.Tensor) -> Tuple[int, int, int, int]:
    """(rows, inner_n, outer_stride, inner_stride) addressing the rows of
    ``x`` ([..., d], last dimension contiguous) as the kernel does:
    row r starts at (r // inner_n) * outer_stride + (r % inner_n) *
    inner_stride. Raises for a view that needs more than two levels."""
    if x.dim() < 1 or (x.shape[-1] > 1 and x.stride(-1) != 1):
        raise ValueError("rmsnorm kernel needs a contiguous last dimension, "
                         f"got strides {x.stride()}")
    merged = []
    for n, s in zip(x.shape[:-1], x.stride()[:-1]):
        if n == 1:
            continue
        if merged and merged[-1][1] == n * s:
            merged[-1] = (merged[-1][0] * n, s)
        else:
            merged.append((n, s))
    if not merged:
        return 1, 1, 0, 0
    if len(merged) == 1:
        (n, s), = merged
        return n, n, 0, s
    if len(merged) == 2:
        (n_out, s_out), (n_in, s_in) = merged
        return n_out * n_in, n_in, s_out, s_in
    raise ValueError("rmsnorm kernel takes at most a two-level row view, "
                     f"got shape {tuple(x.shape)} strides {x.stride()}")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5
            ) -> torch.Tensor:
    """x: [..., d] CUDA tensor (bf16 or f32, last dimension contiguous);
    w: [d] of x's dtype. Returns a new contiguous tensor of x's shape."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("rmsnorm kernel needs x and w on one CUDA device")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel takes bf16 or f32 with w of x's "
                        f"dtype, got {x.dtype} and {w.dtype}")
    d = x.shape[-1]
    if w.shape != (d,) or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous [{d}], got "
                         f"{tuple(w.shape)}")
    rows, inner_n, outer_stride, inner_stride = row_view(x)
    if max(rows, d, outer_stride, inner_stride) > _INT_MAX:
        raise ValueError("rmsnorm kernel takes sizes and strides that fit "
                         "in 32 bits")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0 or d == 0:
        return y
    fn = build.load_function("rmsnorm", "rmsnorm_fwd", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), DTYPE_CODES[x.dtype],
             rows, d, inner_n, outer_stride, inner_stride, eps,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check("rmsnorm", err)
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
