#!/usr/bin/env python3
"""Check the Mamba2 SSD scan kernel (K3) on the card, alone.

    python3 tools/k3_check.py [--backward [--csrc DIR]]

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

With ``--backward`` it checks the backward kernels
(``kernels/csrc/mamba_scan_bwd.cu``) alone: their ptxas lines, the cases of
``chip_smoke.py``'s train.kernels phase against autograd of the plain
version (each output's share of the backward's tolerance, reruns bitwise),
a sweep of draws at zamba2-7b's train shape (x [4, 512, 112, 64] bf16 as
views of the conv output, N 64, chunk 128, dy f32) with each output's
share and the maximum over the draws, then the CUDA-event time beside the
bound and the plain version, and the device time of each of its three
launches (state pass, chunk pass, reduce; for bf16 the tensor-core
``scan_bwd_tc_states`` and ``scan_bwd_tc_chunks``) from a profiler trace.
``--csrc DIR`` builds the backward from ``DIR/mamba_scan_bwd.cu`` instead
(another version of the source, such as the parent commit's, unpacked with
any header it includes under a directory that ``.gitignore`` lists); two
versions go in two processes, since their libraries share symbols: run
parent, change, change, parent in one call, e.g.

    mkdir -p build/parent_csrc && for f in mamba_scan_bwd.cu hopper_tc.cuh; do
      git show HEAD:src/repro_torch/kernels/csrc/$f > build/parent_csrc/$f; done
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    mamba_chunk_scan, mamba_chunk_scan_bwd)

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


BWD_NAMES = ("dx", "db", "dc", "ddt", "dda")
BWD_DRAWS = 8                             # train-shape draws of the sweep


def bwd_shares(got, want):
    """Each output's share of the backward's tolerance."""
    out = {}
    for name, g, w in zip(BWD_NAMES, got, want):
        atol, rtol = cs.scan_bwd_tol(w, g.dtype)
        out[name] = float(((g.float() - w.float()).abs()
                           / (atol + rtol * w.float().abs())).max())
    return out


def backward(csrc=None) -> int:
    card = cs.card()
    source = "src/repro_torch/kernels/csrc"
    if csrc:
        build.use_source("mamba_scan_bwd", csrc)
        source = csrc
    build.build_all(["mamba_scan_bwd"])
    for row in cs.ptxas_report("mamba_scan_bwd"):
        cs.emit({**row, "source": source})
    gen = torch.Generator(device="cuda").manual_seed(11)
    for shape, chunk, dtype, dy_dtype, with_dh, fused in cs._k3_bwd_cases():
        b, s, h, p, n = shape
        x, bm, cm, dt, da = cs._scan_inputs(gen, *shape, dtype, fused)
        dy = cs._rand(gen, (b, s, h, p), dy_dtype)
        dh = cs._rand(gen, (b, h, p, n), F32) if with_dh else None
        got = mamba_chunk_scan_bwd(x, bm, cm, dt, da, dy, dh, chunk=chunk)
        want = ref.mamba_chunk_scan_bwd_ref(x, bm, cm, dt, da, dy, dh)
        again = mamba_chunk_scan_bwd(x, bm, cm, dt, da, dy, dh, chunk=chunk)
        cs.emit({"case": list(shape), "chunk": chunk,
                 "dtype": str(dtype)[6:], "dy": str(dy_dtype)[6:],
                 "dh": with_dh, "fused": fused,
                 "share_of_tolerance": bwd_shares(got, want),
                 "reruns_bitwise": all(torch.equal(a, b_)
                                       for a, b_ in zip(got, again))})
        del x, bm, cm, dt, da, dy, dh, got, want, again
        torch.cuda.empty_cache()
    _, nh, p, n = cs.mamba2.dims(cs.ZAMBA)
    T = cs.ZAMBA.ssm_chunk
    worst = dict.fromkeys(BWD_NAMES, 0.0)
    for seed in range(BWD_DRAWS):
        g = torch.Generator(device="cuda").manual_seed(100 + seed)
        args = cs._scan_inputs(g, cs.B, cs.S, nh, p, n, BF, fused=True)
        dy = cs._rand(g, (cs.B, cs.S, nh, p), F32)
        got = mamba_chunk_scan_bwd(*args, dy, chunk=T)
        share = bwd_shares(got, ref.mamba_chunk_scan_bwd_ref(*args, dy))
        worst = {k: max(v, share[k]) for k, v in worst.items()}
        cs.emit({"draw": 100 + seed, "share_of_tolerance": share})
        del args, dy, got
        torch.cuda.empty_cache()
    cs.emit({"sweep": "train", "shape": [cs.B, cs.S, nh, p], "n": n,
             "chunk": T, "draws": BWD_DRAWS, "max_share": worst})
    row = cs._scan_bwd_times(card, gen, cs._L2Flush())
    cs.emit({"time": "mamba_scan_bwd", "source": source, "ms": row["ms"],
             "kernels_ms": row["kernels_ms"], "card": card})
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backward", action="store_true",
                    help="check and time the backward kernels instead")
    ap.add_argument("--csrc", help="with --backward: a directory holding "
                    "another mamba_scan_bwd.cu")
    args = ap.parse_args()
    if args.csrc and not args.backward:
        ap.error("--csrc goes with --backward")
    if not torch.cuda.is_available():
        print("k3_check: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.backward:
        return backward(args.csrc)
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
