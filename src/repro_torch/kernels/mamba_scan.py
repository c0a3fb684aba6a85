"""Mamba2 SSD chunk scan on the card: wrapper of the hand-written CUDA
kernels ``csrc/mamba_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/mamba_scan.py::
mamba_chunk_scan``. At the zamba2-7b prefill shape its least time on the
H100 is set by memory traffic (x, B, C, dt, da read once, y and the final
state written once: ~98 MB, ~29 us). The C entry point routes by dtype:
bf16 x, B, C go to a tensor-core kernel (TMA copies, ``wgmma`` for all
four products, every f32 operand split into three bf16 terms), f32 to a
kernel of f32 FMAs (see the source for both designs). It reads its inputs
through their strides, so the model's split views of the conv output go in
without a copy; for bf16 the strides must suit the TMA
(:func:`tma_ready`), and an input that does not is first copied into a
layout that does. ``ops.mamba_chunk_scan`` routes CUDA tensors here and
CPU tensors to ``ref.mamba_chunk_scan_ref``.

``mamba_chunk_scan_bwd`` wraps the backward kernels ``csrc/mamba_scan_bwd.cu``
(no TPU counterpart: the JAX package differentiates its jnp model), which
``autograd.MambaChunkScan`` calls when a CUDA call needs a gradient. It
routes by dtype as the forward does: bf16 to the tensor-core kernels
(``scan_bwd_tc_states``, ``scan_bwd_tc_chunks``), f32 to the FMA kernels
(``scan_bwd_states``, ``scan_bwd_chunks``); both end with
``scan_bwd_reduce``.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm import DTYPE_CODES

MAX_CHUNK, MAX_P, MAX_N = 128, 64, 64
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 21
             + [ctypes.c_void_p])
_INT_MAX = 2 ** 31 - 1


def _check_last_dim(name: str, t: torch.Tensor) -> None:
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"mamba scan kernel needs a contiguous last "
                         f"dimension of {name}, got strides {t.stride()}")


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the tensor maps of the bf16 kernel address ``t`` in place:
    a 16-byte aligned base and, for every dimension but the last that has
    more than one entry, a stride of whole 16 bytes."""
    step = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        st % step == 0 for size, st in zip(t.shape[:-1], t.stride()[:-1])
        if size > 1)


def _tma_copy(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a new tensor whose rows are padded to whole 16
    bytes (the padding is never read), returned as a view of t's shape."""
    step = 16 // t.element_size()
    width = -(-t.shape[-1] // step) * step
    out = t.new_zeros((*t.shape[:-1], width))
    out[..., :t.shape[-1]] = t
    return out[..., :t.shape[-1]]


def _outer_strides(t: torch.Tensor):
    """The strides of all but the last dimension; a dimension of one entry
    is never stepped over, so its stride is given as 8 elements."""
    return [st if size > 1 else 8
            for size, st in zip(t.shape[:-1], t.stride()[:-1])]


def _check(what: str, x, b, c, dt, da, chunk: int):
    """Refuse what the kernels cannot take; returns (B, S, H, P, N)."""
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (b, c, dt, da)):
        raise ValueError(f"{what} needs x, b, c, dt, da on one CUDA device")
    if x.dtype not in DTYPE_CODES or b.dtype != x.dtype or \
            c.dtype != x.dtype:
        raise TypeError(f"{what} takes x, b, c of one dtype of "
                        f"{list(DTYPE_CODES)}, got {x.dtype}, {b.dtype}, "
                        f"{c.dtype}")
    if dt.dtype != torch.float32 or da.dtype != torch.float32:
        raise TypeError(f"dt and da must be float32, got {dt.dtype}, "
                        f"{da.dtype}")
    if x.dim() != 4 or b.dim() != 3 or c.shape != b.shape or \
            dt.shape != x.shape[:3] or da.shape != dt.shape:
        raise ValueError(f"want x [B,S,H,P], b, c [B,S,N], dt, da [B,S,H]; "
                         f"got {tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(da.shape)}")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if b.shape[:2] != (bsz, s):
        raise ValueError(f"b {tuple(b.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if not 0 < chunk <= MAX_CHUNK or s % chunk or p > MAX_P or n > MAX_N:
        raise ValueError(f"{what} takes chunk <= {MAX_CHUNK} dividing S, "
                         f"P <= {MAX_P}, N <= {MAX_N}; got chunk={chunk}, "
                         f"S={s}, P={p}, N={n}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        _check_last_dim(name, t)
    return bsz, s, h, p, n


def _fits_int32(strides) -> None:
    if max(strides) > _INT_MAX:
        raise ValueError("mamba scan kernel takes strides that fit in 32 "
                         "bits")


def mamba_chunk_scan(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                     dt: torch.Tensor, da: torch.Tensor, *, chunk: int = 128,
                     out_dtype: Optional[torch.dtype] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, H, P]; b, c: [B, S, N] (x, b, c one dtype, bf16 or f32,
    last dimension contiguous, any other strides); dt, da: [B, S, H] f32
    (da = dt * A, the log decay). S % chunk == 0, chunk <= 128, P <= 64,
    N <= 64. Returns (y [B, S, H, P] in ``out_dtype`` (x's dtype by
    default), h [B, H, P, N] f32), both new contiguous tensors; the scan
    starts from h = 0."""
    bsz, s, h, p, n = _check("mamba scan kernel", x, b, c, dt, da, chunk)
    dev = x.device
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"out_dtype must be one of {list(DTYPE_CODES)}, got "
                        f"{out_dtype}")
    if x.dtype == torch.bfloat16:
        x, b, c = (t if tma_ready(t) else _tma_copy(t) for t in (x, b, c))
    strides = (*_outer_strides(x), *_outer_strides(b), *_outer_strides(c),
               *dt.stride(), *da.stride())
    _fits_int32(strides)
    y = torch.empty((bsz, s, h, p), dtype=out_dtype, device=dev)
    h_out = torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev)
    fn = build.load_function("mamba_scan", "mamba_scan_fwd", _ARGTYPES)
    err = fn(x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
             da.data_ptr(), y.data_ptr(), h_out.data_ptr(),
             DTYPE_CODES[x.dtype], DTYPE_CODES[out_dtype], bsz, s, h, p, n,
             chunk, *strides, torch.cuda.current_stream(dev).cuda_stream)
    build.check("mamba_scan", err)
    mamba_chunk_scan.launches += 1
    mamba_chunk_scan.calls[(bsz, s, h, p, n, chunk, x.dtype, out_dtype)] += 1
    return y, h_out


mamba_chunk_scan.launches = 0
# launches by ``kernels.cost.mamba_scan``'s arguments
mamba_chunk_scan.calls = collections.Counter()


# ---------------------------------------------------------------------------
# backward (csrc/mamba_scan_bwd.cu)
# ---------------------------------------------------------------------------

_BWD_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 24
                 + [ctypes.c_void_p])


def mamba_chunk_scan_bwd(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                         dt: torch.Tensor, da: torch.Tensor, dy: torch.Tensor,
                         dh: Optional[torch.Tensor] = None, *,
                         chunk: int = 128):
    """Gradient of ``mamba_chunk_scan(x, b, c, dt, da, chunk=chunk)`` given
    dy, the gradient of y ([B, S, H, P], f32 or x's dtype, last dimension
    contiguous, any other strides), and dh, the gradient of the final h
    (f32 [B, H, P, N] contiguous; None: zero). x, b, c, dt, da as the
    forward takes them. Returns (dx in x's dtype, db and dc in b's dtype,
    ddt and dda in f32), new contiguous tensors; the chunk states are
    recomputed (three launches, no atomics, bitwise reruns). bf16 x, b, c
    go to the tensor-core kernels (every f32 operand split into two bf16
    terms), f32 to the FMA kernels; for bf16 the layout rule is the
    forward's (:func:`tma_ready`: the kernels read x, b, c 16 bytes at a
    time), and an input that fails it is first copied into one that
    meets it."""
    what = "mamba scan backward kernel"
    bsz, s, h, p, n = _check(what, x, b, c, dt, da, chunk)
    dev = x.device
    if dy.device != dev or dy.shape != x.shape or \
            dy.dtype not in (torch.float32, x.dtype):
        raise ValueError(f"{what} needs dy of x's shape {tuple(x.shape)} on "
                         f"{dev} in float32 or {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    _check_last_dim("dy", dy)
    if x.dtype == torch.bfloat16:
        x, b, c = (t if tma_ready(t) else _tma_copy(t) for t in (x, b, c))
    if dh is not None and (dh.device != dev or dh.dtype != torch.float32
                           or dh.shape != (bsz, h, p, n)
                           or not dh.is_contiguous()):
        raise ValueError(f"{what} needs dh f32 [{bsz}, {h}, {p}, {n}] "
                         f"contiguous on {dev}")
    strides = (*_outer_strides(x), *_outer_strides(b), *_outer_strides(c),
               *dt.stride(), *da.stride(), *_outer_strides(dy))
    _fits_int32(strides)
    dx = torch.empty((bsz, s, h, p), dtype=x.dtype, device=dev)
    db = torch.empty((bsz, s, n), dtype=b.dtype, device=dev)
    dc = torch.empty_like(db)
    ddt = torch.empty((bsz, s, h), dtype=torch.float32, device=dev)
    dda = torch.empty_like(ddt)
    size = build.load_function("mamba_scan_bwd",
                               "mamba_scan_bwd_scratch_bytes",
                               [ctypes.c_int] * 6, ctypes.c_longlong)
    # h_k and G_{k+1} per chunk, the per-head dB and dC partials (f32)
    scratch = torch.empty(size(bsz, s, h, p, n, chunk), dtype=torch.uint8,
                          device=dev)
    fn = build.load_function("mamba_scan_bwd", "mamba_scan_bwd",
                             _BWD_ARGTYPES)
    err = fn(x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
             da.data_ptr(), dy.data_ptr(),
             None if dh is None else dh.data_ptr(), dx.data_ptr(),
             db.data_ptr(), dc.data_ptr(), ddt.data_ptr(), dda.data_ptr(),
             scratch.data_ptr(), DTYPE_CODES[x.dtype], DTYPE_CODES[dy.dtype],
             bsz, s, h, p, n, chunk, *strides,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check("mamba_scan_bwd", err)
    mamba_chunk_scan_bwd.launches += 1
    mamba_chunk_scan_bwd.calls[(bsz, s, h, p, n, chunk, x.dtype,
                                dy.dtype)] += 1
    return dx, db, dc, ddt, dda


mamba_chunk_scan_bwd.launches = 0
mamba_chunk_scan_bwd.calls = collections.Counter()
