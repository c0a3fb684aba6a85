"""RMSNorm on the card: wrappers of the hand-written CUDA kernel
``csrc/rmsnorm.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm``. It is
memory-bound on the H100 (about 4 flops per element against two accesses),
so its least time is (2 * rows * d + d) * bytes / 3.35 TB/s; the kernel
reads each row once with 16-byte loads into registers, reduces in f32 and
writes once, with threads per row and loads per thread fixed for each
served width: a block of 256 threads holds one row at d 3584-7168 and
8-16 rows at the narrow widths d 384 and 1024 (whisper-tiny, xlstm-350m),
so that enough rows are in flight (see the source for the design; other
aligned widths take the smallest generic layout that covers the row).
``add_rmsnorm`` is the same
kernel with the residual add before the norm fused in: s = x + r rounded
to x's dtype, y = rmsnorm(s), one launch. ``ops.rmsnorm`` and
``ops.add_rmsnorm`` route CUDA tensors here and CPU tensors to ``ref``.

``rmsnorm_bwd`` and ``add_rmsnorm_bwd`` wrap the backward kernels of
``csrc/rmsnorm_bwd.cu`` (a library of their own, so the tuned forward
library is untouched): one pass over the rows with 16-byte loads into
registers that writes dx and float64 dw partials, then a reduce of the
partials: two launches at the wide served widths, one cooperative launch
at the narrow ones (d 384 and 1024: many rows a block, the reduce after a
grid barrier); other widths and unaligned rows take a generic path of
three. The scratch holds the partials of whichever route runs
(``rmsnorm_bwd_scratch_bytes``); ``kernels.autograd`` calls them from the
backward of its ``torch.autograd.Function``s.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
_ADD_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                 ctypes.c_float, _P]
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


def _check(name: str, x: torch.Tensor, w: torch.Tensor, *others):
    """Raise unless x (and ``others``) and w are what the kernel takes;
    returns x's row view."""
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in (w, *others)):
        raise ValueError(f"{name} kernel needs its tensors on one CUDA "
                         f"device")
    if x.dtype not in DTYPE_CODES or any(t.dtype != x.dtype
                                         for t in (w, *others)):
        raise TypeError(f"{name} kernel takes bf16 or f32 with every "
                        f"tensor of x's dtype, got {x.dtype} and "
                        f"{[t.dtype for t in (w, *others)]}")
    d = x.shape[-1]
    if w.shape != (d,) or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous [{d}], got "
                         f"{tuple(w.shape)}")
    view = row_view(x)
    if max(*view, d) > _INT_MAX:
        raise ValueError(f"{name} kernel takes sizes and strides that fit "
                         "in 32 bits")
    return view


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5
            ) -> torch.Tensor:
    """x: [..., d] CUDA tensor (bf16 or f32, last dimension contiguous);
    w: [d] of x's dtype. Returns a new contiguous tensor of x's shape."""
    rows, inner_n, outer_stride, inner_stride = _check("rmsnorm", x, w)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0 or x.shape[-1] == 0:
        return y
    fn = build.load_function("rmsnorm", "rmsnorm_fwd", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), DTYPE_CODES[x.dtype],
             rows, x.shape[-1], inner_n, outer_stride, inner_stride, eps,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check("rmsnorm", err)
    rmsnorm.launches += 1
    rmsnorm.calls[(x.shape, x.dtype)] += 1
    return y


rmsnorm.launches = 0
# launches by ``kernels.cost.rmsnorm``'s arguments
rmsnorm.calls = collections.Counter()


def add_rmsnorm(x: torch.Tensor, r: torch.Tensor, w: torch.Tensor, *,
                eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the norm after it in one launch. x, r:
    [..., d] CUDA tensors of one shape and dtype (bf16 or f32, last
    dimension contiguous); w: [d]. Returns (s, y), new contiguous tensors:
    s = x + r rounded to x's dtype (bitwise what ``x + r`` gives) and
    y = rmsnorm(s, w)."""
    if r.shape != x.shape:
        raise ValueError(f"add_rmsnorm needs x and r of one shape, got "
                         f"{tuple(x.shape)} and {tuple(r.shape)}")
    rows, x_n, x_outer, x_inner = _check("add_rmsnorm", x, w, r)
    _, r_n, r_outer, r_inner = _check("add_rmsnorm", r, w)
    s = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    y = torch.empty_like(s)
    if rows == 0 or x.shape[-1] == 0:
        return s, y
    fn = build.load_function("rmsnorm", "add_rmsnorm_fwd", _ADD_ARGTYPES)
    err = fn(x.data_ptr(), r.data_ptr(), w.data_ptr(), s.data_ptr(),
             y.data_ptr(), DTYPE_CODES[x.dtype], rows, x.shape[-1], x_n,
             x_outer, x_inner, r_n, r_outer, r_inner, eps,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check("rmsnorm", err)
    add_rmsnorm.launches += 1
    add_rmsnorm.calls[(x.shape, x.dtype)] += 1
    return s, y


add_rmsnorm.launches = 0
add_rmsnorm.calls = collections.Counter()


# ---------------------------------------------------------------------------
# backward (csrc/rmsnorm_bwd.cu)
# ---------------------------------------------------------------------------

_BWD_ARGTYPES = [_P] * 7 + [_I] * 12 + [ctypes.c_float, _P]


def _bwd(name: str, dy, x, ds, w, eps: float):
    """Launch ``rmsnorm_bwd`` on the row views of dy, x (and ds). Returns
    (dx, dw): dx a new contiguous tensor of x's shape (ds added), dw [d]."""
    if dy.shape != x.shape or (ds is not None and ds.shape != x.shape):
        raise ValueError(f"{name} needs dy (and ds) of x's shape "
                         f"{tuple(x.shape)}")
    rows, x_n, x_outer, x_inner = _check(name, x, w, dy,
                                         *(() if ds is None else (ds,)))
    _, dy_n, dy_outer, dy_inner = row_view(dy)
    ds_view = (1, 0, 0) if ds is None else row_view(ds)[1:]
    if max(*ds_view, dy_n, dy_outer, dy_inner) > _INT_MAX:
        raise ValueError(f"{name} kernel takes sizes and strides that fit "
                         "in 32 bits")
    d = x.shape[-1]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0 or d == 0:
        return dx, torch.zeros_like(w)
    dw = torch.empty_like(w)
    size = build.load_function("rmsnorm_bwd", "rmsnorm_bwd_scratch_bytes",
                               [_I, _I], ctypes.c_longlong)
    # the float64 dw partials (and on the generic path, f32 rstd)
    scratch = torch.empty(size(rows, d), dtype=torch.uint8, device=x.device)
    fn = build.load_function("rmsnorm_bwd", "rmsnorm_bwd", _BWD_ARGTYPES)
    err = fn(dy.data_ptr(), x.data_ptr(),
             None if ds is None else ds.data_ptr(), w.data_ptr(),
             dx.data_ptr(), dw.data_ptr(), scratch.data_ptr(),
             DTYPE_CODES[x.dtype], rows, d, dy_n, dy_outer, dy_inner, x_n,
             x_outer, x_inner, *ds_view, eps,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check("rmsnorm_bwd", err)
    return dx, dw


def rmsnorm_bwd(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor, *,
                eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient of ``rmsnorm(x, w)`` given dy: (dx in x's dtype, dw in w's
    dtype), rstd recomputed per row in f32, dw reduced without atomics.
    dy and x: [..., d] CUDA tensors of one dtype with contiguous last
    dimensions (any two-level row view, as the forward takes)."""
    out = _bwd("rmsnorm_bwd", dy, x, None, w, eps)
    rmsnorm_bwd.launches += 1
    rmsnorm_bwd.calls[(x.shape, x.dtype)] += 1
    return out


rmsnorm_bwd.launches = 0
rmsnorm_bwd.calls = collections.Counter()


def add_rmsnorm_bwd(dy: torch.Tensor, ds: Optional[torch.Tensor],
                    s: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient of ``add_rmsnorm(x, r, w)`` = (s, y) given (ds, dy), from
    the saved sum s: (dsum, dw), where dsum, the gradient of both x and
    r, is ds plus the norm's input gradient, summed in f32 and rounded once
    to s's dtype. ``ds`` None
    means no gradient reaches s from elsewhere."""
    out = _bwd("add_rmsnorm_bwd", dy, s, ds, w, eps)
    add_rmsnorm_bwd.launches += 1
    add_rmsnorm_bwd.calls[(s.shape, s.dtype)] += 1
    return out


add_rmsnorm_bwd.launches = 0
add_rmsnorm_bwd.calls = collections.Counter()
