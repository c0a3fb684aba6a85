"""A frozen copy of the port's ``kernels/cost.py``: the work of each
kernel (bytes moved, operations done) as a function of its arguments, and
the H100's data-sheet rates. The benchmark's rooflines and its MFU count
read this copy, so a change to the program cannot move the yardstick;
``perfbench/tests/test_perfbench_work.py`` holds it to the program's file
as it stood when it was copied.

The original's docstring follows.

The work of each kernel, in one place: bytes moved and operations done,
as functions of the kernel's arguments, and the H100's rates to turn work
into a least time.

Every count here is the kernel's *function*, not its implementation: each
input read once, each output written once, and the operations that the
function needs on these inputs (for attention and the scan only the
visible (query, key) or (t, s) pairs). A faster kernel never changes what
it is charged. ``chip_smoke.py`` prints its bounds from these functions,
the dry run (``launch/op_cost.py``) charges a kernel's meta call with
them, and the wrappers tally their launches by the same arguments
(``<wrapper>.calls``), so the card's count of a step can be held against
the dry run's.

The rates are NVIDIA's H100 SXM5 data sheet: 989 TFLOP/s dense bf16 on
the tensor cores, 67 TFLOP/s f32 outside them, 3.35 TB/s of HBM3, and
NVLink 4 at 900 GB/s a GPU (18 links, both directions together), which is
450 GB/s a direction: what one GPU's collective traffic can send.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

HBM_BYTES_PER_S = 3.35e12          # HBM3
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
F32_FLOPS = 67e12                  # f32 outside the tensor cores
NVLINK_BYTES_PER_S = 900e9         # NVLink 4, a GPU, both directions
NVLINK_SEND_BYTES_PER_S = NVLINK_BYTES_PER_S / 2   # one direction


@dataclass(frozen=True)
class Work:
    """Bytes a function must move and operations it must do, and the
    dtype whose peak rate the operations run at."""
    bytes: int
    flops: int
    dtype: torch.dtype = torch.bfloat16


def bound(work: Work) -> dict:
    """Least time (ms) for ``work`` on the H100 (bf16 operations on the
    tensor cores, any other dtype's on the FMA units), and which of bytes
    and operations sets it."""
    by_bytes = 1e3 * work.bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * work.flops / (BF16_FLOPS if work.dtype == torch.bfloat16
                                 else F32_FLOPS)
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _size(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# -- K1: rmsnorm (csrc/rmsnorm.cu, rmsnorm_bwd.cu) ---------------------------

def rmsnorm(shape, dtype) -> Work:
    """y = rmsnorm(x, w), x of ``shape``: x and w read once, y written
    once; ~4 operations an element."""
    n, d = _numel(shape), int(shape[-1])
    return Work((2 * n + d) * _size(dtype), 4 * n, dtype)


def add_rmsnorm(shape, dtype) -> Work:
    """(s, y) = (x + r, rmsnorm(x + r, w)): x, r and w read once, s and y
    written once; ~5 operations an element."""
    n, d = _numel(shape), int(shape[-1])
    return Work((4 * n + d) * _size(dtype), 5 * n, dtype)


def rmsnorm_bwd(shape, dtype) -> Work:
    """(dx, dw) of rmsnorm: x, dy and w read once, dx and dw written once;
    ~7 operations an element."""
    n, d = _numel(shape), int(shape[-1])
    return Work((3 * n + 2 * d) * _size(dtype), 7 * n, dtype)


def add_rmsnorm_bwd(shape, dtype) -> Work:
    """(dsum, dw) of add_rmsnorm: s, dy, ds and w read once, dsum and dw
    written once; ~8 operations an element."""
    n, d = _numel(shape), int(shape[-1])
    return Work((4 * n + 2 * d) * _size(dtype), 8 * n, dtype)


# -- K2: flash attention (csrc/flash_attention.cu, flash_attention_bwd.cu) ---

@functools.lru_cache(maxsize=None)
def visible_pairs(sq: int, skv: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs that one head attends, positions from 0 on both
    sides: query i sees key j < skv when, if causal, j <= i and, with a
    window, j > i - window (the plain version's mask)."""
    if not window:
        if not causal:
            return sq * skv
        if sq <= skv:
            return sq * (sq + 1) // 2
    total = 0
    for i in range(sq):
        hi = min(i + 1, skv) if causal else skv
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def attention(b, hq, hkv, sq, skv, d, dtype, causal=True, window=0) -> Work:
    """o = attention(q [b, hq, sq, d], k, v [b, hkv, skv, d]): q, k, v read
    once, o written once; QK and PV, 4 d operations a visible pair."""
    pairs = b * hq * visible_pairs(sq, skv, causal, window)
    q_n, kv_n = b * hq * sq * d, b * hkv * skv * d
    return Work((2 * q_n + 2 * kv_n) * _size(dtype), 4 * d * pairs, dtype)


def attention_bwd(b, hq, hkv, sq, skv, d, dtype, causal=True,
                  window=0) -> Work:
    """(dq, dk, dv): q, o, dO, k, v read once, dq, dk, dv written once;
    S, dP, dV, dQ and dK, five products of 2 d operations a visible
    pair."""
    pairs = b * hq * visible_pairs(sq, skv, causal, window)
    q_n, kv_n = b * hq * sq * d, b * hkv * skv * d
    size = _size(dtype)
    return Work((3 * q_n + 2 * kv_n) * size + (q_n + 2 * kv_n) * size,
                10 * d * pairs, dtype)


# -- K3: the Mamba2 SSD chunk scan (csrc/mamba_scan.cu, mamba_scan_bwd.cu) ---

def mamba_scan(b, s, h, p, n, chunk, dtype, out_dtype) -> Work:
    """(y, h) = scan(x [b, s, h, p], B, C [b, s, n], dt, da [b, s, h] f32):
    the inputs read once, y (``out_dtype``) and the f32 final state
    written once; per chunk and head the causal products C B^T and
    (scores) x over the chunk's (t, s) pairs and the state's two T x P x N
    products, 2 operations a multiply-add."""
    pairs = chunk * (chunk + 1) // 2
    per_chunk = 2 * (pairs * n + pairs * p + 2 * chunk * p * n)
    x_n, bc_n, g_n = b * s * h * p, b * s * n, b * s * h
    n_bytes = (x_n * _size(dtype) + 2 * bc_n * _size(dtype)
               + 2 * g_n * 4 + x_n * _size(out_dtype) + b * h * p * n * 4)
    return Work(n_bytes, per_chunk * (s // chunk) * b * h, dtype)


def mamba_scan_bwd(b, s, h, p, n, chunk, dtype, dy_dtype) -> Work:
    """(dx, dB, dC, ddt, dda): x, B, C, dt, da and dy read once, the five
    gradients written once; per chunk and head the causal products C B^T,
    dy x^T, SE^T dy, K^T C and K B (3 N + 2 P a pair) and five T x P x N
    ones, 2 operations a multiply-add."""
    pairs = chunk * (chunk + 1) // 2
    per_chunk = 2 * (pairs * (3 * n + 2 * p) + 5 * chunk * p * n)
    x_n, bc_n, g_n = b * s * h * p, b * s * n, b * s * h
    n_bytes = (2 * x_n * _size(dtype) + 2 * 2 * bc_n * _size(dtype)
               + 4 * g_n * 4 + x_n * _size(dy_dtype))
    return Work(n_bytes, per_chunk * (s // chunk) * b * h, dtype)


# each wrapper's ``calls`` tally key -> its work
KERNELS = {
    "rmsnorm": rmsnorm, "add_rmsnorm": add_rmsnorm,
    "rmsnorm_bwd": rmsnorm_bwd, "add_rmsnorm_bwd": add_rmsnorm_bwd,
    "flash_attention": attention, "flash_attention_bwd": attention_bwd,
    "mamba_scan": mamba_scan, "mamba_scan_bwd": mamba_scan_bwd,
}


def tally_work(name: str, calls) -> Work:
    """The summed work of a wrapper's ``calls`` tally (arguments ->
    launches)."""
    fn = KERNELS[name]
    n_bytes = flops = 0
    for args, count in calls.items():
        w = fn(*args)
        n_bytes += count * w.bytes
        flops += count * w.flops
    return Work(n_bytes, flops)
