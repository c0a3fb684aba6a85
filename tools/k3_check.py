#!/usr/bin/env python3
"""Check the Mamba2 SSD scan kernel (K3) on the card, alone.

    python3 tools/k3_check.py

Builds ``kernels/csrc/mamba_scan.cu``, prints what ptxas reported for each
entry function, then for a sweep of bf16 shapes holds y (f32) and the final
h against the exact recurrence: the largest error, the share of the
tolerance ``3e-4 + 3e-4 |want|`` that the worst point uses (<= 1 passes),
bitwise reruns and the bf16 y as one rounding of the f32 y. At the serve
shape (x [4, 512, 112, 64], N 64, chunk 128) it also measures the kernel
and the plain recurrence against the chunked scan computed in float64, on
the inputs that ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` draw,
and times the kernel as ``chip_smoke.py`` does. One JSON object a line.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_chunk_scan  # noqa: E402

BF, F32, F64 = torch.bfloat16, torch.float32, torch.float64
SERVE = (4, 512, 112, 64, 64, 128)        # b, s, h, p, n, chunk
SWEEP = [(1, 128, 2, 64, 64, 128), (1, 256, 2, 64, 64, 128),
         (2, 40, 4, 64, 16, 40), (1, 64, 2, 8, 4, 16), (2, 128, 3, 16, 8, 32),
         (1, 96, 1, 8, 16, 32), (2, 256, 3, 32, 16, 64), SERVE]


def share(got, want):
    """The share of ``3e-4 + 3e-4 |want|`` that the worst point uses."""
    want = want.to(F64)
    return float(((got.to(F64) - want).abs() / (3e-4 + 3e-4 * want.abs()))
                 .max())


def chunked_f64(x, b, c, dt, da, chunk):
    """The chunked scan (the TPU kernel's algorithm) in float64."""
    x, b, c, dt, da = (t.to(F64) for t in (x, b, c, dt, da))
    bsz, s, nh, p = x.shape
    h = torch.zeros((bsz, nh, p, b.shape[-1]), dtype=F64, device=x.device)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    ys = []
    for k in range(s // chunk):
        sl = slice(k * chunk, (k + 1) * chunk)
        xc, bc, cc, dtc = x[:, sl], b[:, sl], c[:, sl], dt[:, sl]
        ca = torch.cumsum(da[:, sl], 1)                          # [B,T,H]
        w = torch.exp(ca[:, :, None] - ca[:, None]) * dtc[:, None]
        scores = torch.where(tri[None, :, :, None],
                             torch.einsum("btn,bsn->bts", cc, bc)[..., None]
                             * w, 0.0)
        ys.append(torch.einsum("btsh,bshp->bthp", scores, xc)
                  + torch.exp(ca)[..., None]
                  * torch.einsum("btn,bhpn->bthp", cc, h))
        ca_t = ca[:, -1]
        h = torch.exp(ca_t)[..., None, None] * h + torch.einsum(
            "bshp,bsn,bsh->bhpn", xc, bc, torch.exp(ca_t[:, None] - ca) * dtc)
    return torch.cat(ys, 1), h


def card_test_inputs(b, s, h, p, n):
    """``tests/test_torch_cuda.py``'s draw (seed 0)."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x, bm, cm = (rand(*shape).to(BF) for shape in
                 ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = torch.nn.functional.softplus(rand(b, s, h))
    da = -dt * torch.exp(rand(h) * 0.1)
    return x, bm, cm, dt, da


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_check: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    build.build_all(["mamba_scan"])
    for row in cs.ptxas_report("mamba_scan"):
        cs.emit(row)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for b, s, h, p, n, chunk in SWEEP:
        args = cs._mamba_inputs(gen, b, s, h, p, n, BF)
        y, hf = mamba_chunk_scan(*args, chunk=chunk, out_dtype=F32)
        wy, wh = ref.mamba_chunk_scan_ref(*args, out_dtype=F32)
        again = mamba_chunk_scan(*args, chunk=chunk, out_dtype=F32)
        yb, _ = mamba_chunk_scan(*args, chunk=chunk)
        cs.emit({"case": [b, s, h, p, n, chunk],
                 "y_err": float((y - wy).abs().max()),
                 "h_err": float((hf - wh).abs().max()),
                 "y_share": share(y, wy), "h_share": share(hf, wh),
                 "rerun_bitwise": bool(torch.equal(y, again[0])
                                       and torch.equal(hf, again[1])),
                 "bf16_y_is_rounded_f32_y": bool(torch.equal(yb, y.to(BF)))})
    draws = {"chip_smoke": cs._mamba_inputs(
        torch.Generator(device="cuda").manual_seed(4), *SERVE[:5], BF),
             "test_torch_cuda": card_test_inputs(*SERVE[:5])}
    for name, args in draws.items():
        y, hf = mamba_chunk_scan(*args, chunk=SERVE[5], out_dtype=F32)
        wy, wh = ref.mamba_chunk_scan_ref(*args, out_dtype=F32)
        ey, eh = chunked_f64(*args, SERVE[5])
        cs.emit({"draw": name, "kernel_vs_plain": [share(y, wy),
                                                   share(hf, wh)],
                 "kernel_vs_f64": [share(y, ey), share(hf, eh)],
                 "plain_vs_f64": [share(wy, ey), share(wh, eh)]})
    x, bm, cm, dt, da = draws["chip_smoke"]
    ms = cs.time_ms(lambda: mamba_chunk_scan(x, bm, cm, dt, da,
                                             chunk=SERVE[5], out_dtype=F32),
                    cs._L2Flush())
    cs.emit({"time": "mamba_scan", "shape": list(x.shape), "ms": ms,
             "card": cs.card()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
