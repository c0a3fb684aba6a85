#!/usr/bin/env python3
"""Check the Mamba2 SSD scan kernel (K3) on the card, alone.

    python3 tools/k3_check.py

Builds ``kernels/csrc/mamba_scan.cu``, prints what ptxas reported for each
entry function, then for a sweep of bf16 shapes holds y (f32) and the final
h against the exact recurrence: the largest error, the share of the
tolerance ``3e-4 + 3e-4 |want|`` that the worst point uses (<= 1 passes),
bitwise reruns and the bf16 y as one rounding of the f32 y. At the serve
shape (x [4, 512, 112, 64], N 64, chunk 128) it then sweeps 24 draws
(seeds 0-23, drawn as ``chip_smoke.py`` draws its K3 inputs; seed 0 is
``tests/test_torch_cuda.py``'s draw, seed 4 ``chip_smoke.py``'s first):
for each, the share that the bf16 tensor-core kernel and the f32 FMA
kernel (on the same values in f32) use against the plain recurrence and
against the chunked scan computed in float64, then the maximum over the
draws. Last it times the bf16 kernel as ``chip_smoke.py`` does. One JSON
object a line.
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
DRAWS = 24                                # serve-shape draws of the sweep


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


def serve_sweep():
    """Each draw's shares of the tolerance ([y, h]) at the serve shape, for
    both kernels against the plain recurrence and the float64 chunked
    scan; then the maximum of each over the draws."""
    worst = {}
    for seed in range(DRAWS):
        args = cs._mamba_inputs(torch.Generator(device="cuda")
                                .manual_seed(seed), *SERVE[:5], BF)
        wy, wh = ref.mamba_chunk_scan_ref(*args, out_dtype=F32)
        ey, eh = chunked_f64(*args, SERVE[5])
        row = {"draw": seed, "plain_vs_f64": [share(wy, ey), share(wh, eh)]}
        for kernel, dtype in (("tc_bf16", BF), ("fma_f32", F32)):
            x, b, c = (t.to(dtype) for t in args[:3])
            y, hf = mamba_chunk_scan(x, b, c, *args[3:], chunk=SERVE[5],
                                     out_dtype=F32)
            row[kernel] = {"vs_plain": [share(y, wy), share(hf, wh)],
                           "vs_f64": [share(y, ey), share(hf, eh)]}
            for against, pair in row[kernel].items():
                key = f"{kernel}.{against}"
                worst[key] = [max(a, b) for a, b in
                              zip(worst.get(key, [0.0, 0.0]), pair)]
        cs.emit(row)
    cs.emit({"sweep": "serve", "shape": list(SERVE), "draws": DRAWS,
             "max_share_y_h": worst})


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
    serve_sweep()
    x, bm, cm, dt, da = cs._mamba_inputs(
        torch.Generator(device="cuda").manual_seed(4), *SERVE[:5], BF)
    ms = cs.time_ms(lambda: mamba_chunk_scan(x, bm, cm, dt, da,
                                             chunk=SERVE[5], out_dtype=F32),
                    cs._L2Flush())
    cs.emit({"time": "mamba_scan", "shape": list(x.shape), "ms": ms,
             "card": cs.card()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
