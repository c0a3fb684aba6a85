"""The kernels on ``meta`` tensors: outputs of the kernel's shapes and
dtypes, and the kernel's work charged from ``kernels/cost.py``.

``kernels.ops`` sends a meta tensor here, and only a meta tensor: a model
built on ``meta`` runs shape-only through the same layer code as on the
card, and a step traced that way (``launch/op_cost.py``, the dry run)
sees each kernel as one op, ``torch.ops.repro_torch.<kernel>``, whose
FLOPs are the kernel's (``torch.utils.flop_counter`` reads them through
``register_flop_formula``), never the plain version's step-by-step
arithmetic. Each forward op's autograd runs the backward op, as
``kernels.autograd`` runs the backward kernel on the card, with the same
choices (no backward launch for an add + norm whose norm output gets no
gradient; dy made f32 and contiguous for the scan).

The ops have no implementation for real tensors: calling one on a CPU or
CUDA tensor raises. ``register_sharding`` gives DTensor their placements
(batch or heads sharded, nothing else) for the dry run on a mesh.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from repro_torch.kernels import cost

_LIB = "repro_torch"


def _meta_only(name: str):
    raise NotImplementedError(f"{_LIB}::{name} runs on meta tensors only; "
                              f"kernels.ops routes real tensors elsewhere")


# -- K1 ----------------------------------------------------------------------

@torch.library.custom_op(f"{_LIB}::rmsnorm", mutates_args=())
def rmsnorm(x: Tensor, w: Tensor, eps: float) -> Tensor:
    _meta_only("rmsnorm")


@rmsnorm.register_fake
def _(x, w, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@torch.library.custom_op(f"{_LIB}::add_rmsnorm", mutates_args=())
def add_rmsnorm(x: Tensor, r: Tensor, w: Tensor,
                eps: float) -> Tuple[Tensor, Tensor]:
    _meta_only("add_rmsnorm")


@add_rmsnorm.register_fake
def _(x, r, w, eps):
    s = torch.empty_like(x, memory_format=torch.contiguous_format)
    return s, torch.empty_like(s)


@torch.library.custom_op(f"{_LIB}::rmsnorm_bwd", mutates_args=())
def rmsnorm_bwd(dy: Tensor, x: Tensor, w: Tensor,
                eps: float) -> Tuple[Tensor, Tensor]:
    _meta_only("rmsnorm_bwd")


@rmsnorm_bwd.register_fake
def _(dy, x, w, eps):
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            torch.empty_like(w))


@torch.library.custom_op(f"{_LIB}::add_rmsnorm_bwd", mutates_args=())
def add_rmsnorm_bwd(dy: Tensor, ds: Optional[Tensor], s: Tensor, w: Tensor,
                    eps: float) -> Tuple[Tensor, Tensor]:
    _meta_only("add_rmsnorm_bwd")


@add_rmsnorm_bwd.register_fake
def _(dy, ds, s, w, eps):
    return (torch.empty_like(s, memory_format=torch.contiguous_format),
            torch.empty_like(w))


def _rmsnorm_setup(ctx, inputs, output):
    x, w, eps = inputs
    ctx.eps = eps
    ctx.save_for_backward(x, w)


def _rmsnorm_backward(ctx, dy):
    x, w = ctx.saved_tensors
    dx, dw = rmsnorm_bwd(dy, x, w, ctx.eps)
    return dx, dw, None


def _add_rmsnorm_setup(ctx, inputs, output):
    _, _, w, eps = inputs
    ctx.eps = eps
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(output[0], w)


def _add_rmsnorm_backward(ctx, ds, dy):
    s, w = ctx.saved_tensors
    if dy is None:                      # only s was used downstream
        return ds, ds, None, None
    dsum, dw = add_rmsnorm_bwd(dy, ds, s, w, ctx.eps)
    return dsum, dsum, dw, None


rmsnorm.register_autograd(_rmsnorm_backward, setup_context=_rmsnorm_setup)
add_rmsnorm.register_autograd(_add_rmsnorm_backward,
                              setup_context=_add_rmsnorm_setup)


# -- K2 ----------------------------------------------------------------------

@torch.library.custom_op(f"{_LIB}::flash_attention", mutates_args=())
def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                    window: int) -> Tuple[Tensor, Tensor]:
    _meta_only("flash_attention")


@flash_attention.register_fake
def _(q, k, v, causal, window):
    # o: a [B, H, S, D] view of [B, S, H, D] storage, as the kernel's
    b, hq, sq, d = q.shape
    o = q.new_empty((b, sq, hq, d)).transpose(1, 2)
    return o, q.new_empty((b, hq, sq), dtype=torch.float32)


@torch.library.custom_op(f"{_LIB}::flash_attention_bwd", mutates_args=())
def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                        do: Tensor, lse: Tensor, causal: bool,
                        window: int) -> Tuple[Tensor, Tensor, Tensor]:
    _meta_only("flash_attention_bwd")


@flash_attention_bwd.register_fake
def _(q, k, v, o, do, lse, causal, window):
    def like(t):
        b, h, s, d = t.shape
        return t.new_empty((b, s, h, d)).transpose(1, 2)
    return like(q), like(k), like(v)


def _attention_setup(ctx, inputs, output):
    q, k, v, causal, window = inputs
    ctx.causal, ctx.window = causal, window
    ctx.save_for_backward(q, k, v, *output)


def _attention_backward(ctx, do, dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, ctx.causal,
                                     ctx.window)
    return dq, dk, dv, None, None


flash_attention.register_autograd(_attention_backward,
                                  setup_context=_attention_setup)


# -- K3 ----------------------------------------------------------------------

@torch.library.custom_op(f"{_LIB}::mamba_chunk_scan", mutates_args=())
def mamba_chunk_scan(x: Tensor, b: Tensor, c: Tensor, dt: Tensor,
                     da: Tensor, chunk: int,
                     out_dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
    _meta_only("mamba_chunk_scan")


@mamba_chunk_scan.register_fake
def _(x, b, c, dt, da, chunk, out_dtype):
    bsz, _, h, p = x.shape
    n = b.shape[-1]
    return (x.new_empty(x.shape, dtype=out_dtype),
            x.new_empty((bsz, h, p, n), dtype=torch.float32))


@torch.library.custom_op(f"{_LIB}::mamba_chunk_scan_bwd", mutates_args=())
def mamba_chunk_scan_bwd(x: Tensor, b: Tensor, c: Tensor, dt: Tensor,
                         da: Tensor, dy: Tensor, dh: Optional[Tensor],
                         chunk: int) -> Tuple[Tensor, Tensor, Tensor,
                                              Tensor, Tensor]:
    _meta_only("mamba_chunk_scan_bwd")


@mamba_chunk_scan_bwd.register_fake
def _(x, b, c, dt, da, dy, dh, chunk):
    return (x.new_empty(x.shape), b.new_empty(b.shape), c.new_empty(b.shape),
            dt.new_empty(dt.shape, dtype=torch.float32),
            dt.new_empty(dt.shape, dtype=torch.float32))


def _scan_setup(ctx, inputs, output):
    x, b, c, dt, da, chunk, _ = inputs
    ctx.chunk = chunk
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(x, b, c, dt, da)


def _scan_backward(ctx, dy, dh):
    x, b, c, dt, da = ctx.saved_tensors
    if dy is None:
        dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    elif dy.dtype not in (torch.float32, x.dtype):
        dy = dy.float()
    if dy.shape[-1] > 1 and dy.stride(-1) != 1:
        dy = dy.contiguous()
    if dh is not None:
        dh = dh.contiguous()
    grads = mamba_chunk_scan_bwd(x, b, c, dt, da, dy, dh, ctx.chunk)
    return (*grads, None, None)


mamba_chunk_scan.register_autograd(_scan_backward, setup_context=_scan_setup)


# -- the work each op is charged (kernels/cost.py) ---------------------------

def work(func, args, kwargs=None) -> Optional[cost.Work]:
    """The ``cost.Work`` of one call of a ``repro_torch`` op (the op's
    overload or packet and its arguments, at the shapes they carry), or
    None for any other op."""
    qualified = getattr(func, "_qualified_op_name", None) or \
        getattr(getattr(func, "_schema", None), "name", "")
    lib, _, name = qualified.partition("::")
    if lib != _LIB:
        return None
    a = list(args) + list((kwargs or {}).values())
    if name in ("rmsnorm", "add_rmsnorm"):
        return cost.KERNELS[name](tuple(a[0].shape), a[0].dtype)
    if name == "rmsnorm_bwd":
        return cost.rmsnorm_bwd(tuple(a[1].shape), a[1].dtype)
    if name == "add_rmsnorm_bwd":
        return cost.add_rmsnorm_bwd(tuple(a[2].shape), a[2].dtype)
    if name in ("flash_attention", "flash_attention_bwd"):
        q, k = a[0], a[1]
        causal, window = a[-2], a[-1]
        b, hq, sq, d = q.shape
        return cost.KERNELS[name](b, hq, k.shape[1], sq, k.shape[2], d,
                                  q.dtype, bool(causal), int(window))
    if name == "mamba_chunk_scan":
        x, bm = a[0], a[1]
        bsz, s, h, p = x.shape
        return cost.mamba_scan(bsz, s, h, p, bm.shape[-1], a[5], x.dtype,
                               a[6])
    if name == "mamba_chunk_scan_bwd":
        x, bm, dy = a[0], a[1], a[5]
        bsz, s, h, p = x.shape
        return cost.mamba_scan_bwd(bsz, s, h, p, bm.shape[-1], a[7],
                                   x.dtype, dy.dtype)
    return None


OPS = (rmsnorm, add_rmsnorm, rmsnorm_bwd, add_rmsnorm_bwd, flash_attention,
       flash_attention_bwd, mamba_chunk_scan, mamba_chunk_scan_bwd)


def _register_flops():
    from torch.utils.flop_counter import register_flop_formula

    def formula(packet):
        def count(*args, out_val=None, **kwargs):
            return work(packet, args, kwargs).flops
        return count
    for op in OPS:
        packet = getattr(torch.ops.repro_torch, op._name.split("::")[-1])
        register_flop_formula(packet, get_raw=True)(formula(packet))


_register_flops()


def register_sharding() -> None:
    """Tell DTensor how each op may be split across a mesh (once; the dry
    run calls it): every tensor replicated, or the batch (dim 0)
    sharded, or the heads (attention's dim 1, the scan's x, dt and da
    dim 2), or for the norms any row dim; the norms' dw and the scan's
    dB and dC, sums over the split rows or heads, come out ``Partial``."""
    if getattr(register_sharding, "done", False):
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import \
        register_sharding as register
    ops = torch.ops.repro_torch
    R = Replicate()

    @register(ops.rmsnorm.default)
    def _(x, w, eps):
        return [([R], [R, R, None])] + [
            ([Shard(d)], [Shard(d), R, None]) for d in range(x.ndim - 1)]

    @register(ops.add_rmsnorm.default)
    def _(x, r, w, eps):
        return [([R, R], [R, R, R, None])] + [
            ([Shard(d), Shard(d)], [Shard(d), Shard(d), R, None])
            for d in range(x.ndim - 1)]

    @register(ops.rmsnorm_bwd.default)
    def _(dy, x, w, eps):
        return [([R, R], [R, R, R, None])] + [
            ([Shard(d), Partial()], [Shard(d), Shard(d), R, None])
            for d in range(x.ndim - 1)]

    @register(ops.add_rmsnorm_bwd.default)
    def _(dy, ds, s, w, eps):
        o = None if ds is None else R
        out = [([R, R], [R, o, R, R, None])]
        for d in range(s.ndim - 1):
            o = None if ds is None else Shard(d)
            out.append(([Shard(d), Partial()],
                        [Shard(d), o, Shard(d), R, None]))
        return out

    # attention: batch or heads split on q, k and v alike; or, for GQA
    # whose KV heads do not split, q's heads split against whole k and v
    # (dk, dv then sums over the q heads: Partial)
    h1 = Shard(1)

    @register(ops.flash_attention.default)
    def _(q, k, v, causal, window):
        return [([p, p], [p, p, p, None, None])
                for p in (R, Shard(0), h1)] + [
            ([h1, h1], [h1, R, R, None, None])]

    @register(ops.flash_attention_bwd.default)
    def _(q, k, v, o, do, lse, causal, window):
        return [([p, p, p], [p, p, p, p, p, p, None, None])
                for p in (R, Shard(0), h1)] + [
            ([h1, Partial(), Partial()], [h1, R, R, h1, h1, h1, None, None])]

    @register(ops.mamba_chunk_scan.default)
    def _(x, b, c, dt, da, chunk, out_dtype):
        b0, h2 = Shard(0), Shard(2)
        return [([R, R], [R, R, R, R, R, None, None]),
                ([b0, b0], [b0, b0, b0, b0, b0, None, None]),
                ([h2, Shard(1)], [h2, R, R, h2, h2, None, None])]

    @register(ops.mamba_chunk_scan_bwd.default)
    def _(x, b, c, dt, da, dy, dh, chunk):
        b0, h2, p = Shard(0), Shard(2), Partial()

        def dh_(pl):
            return None if dh is None else pl
        return [([R] * 5, [R] * 6 + [dh_(R), None]),
                ([b0] * 5, [b0] * 6 + [dh_(b0), None]),
                ([h2, p, p, h2, h2],
                 [h2, R, R, h2, h2, h2, dh_(Shard(1)), None])]

    register_sharding.done = True
