#!/usr/bin/env python3
"""Time the RMSNorm kernel (K1) on the card, alone.

    python3 tools/k1_check.py [--csrc DIR] [--cluster] [--backward]

Builds K1 from ``src/repro_torch/kernels/csrc/rmsnorm.cu`` (or from
``DIR/rmsnorm.cu``, another version of the source such as the parent
commit's, unpacked under a directory that ``.gitignore`` lists; two
versions go in two processes, since their libraries share symbols) and
times, as ``chip_smoke.py`` does, the K1 calls of ``PERF.md``'s kernel
table at the served bf16 shapes: the qwen3-8b prefill layer's four norms,
the zamba2-7b Mamba block's two and attention application's two, and the
decode norms; where the source has the fused entry, the fused calls that
the models now make as well; and the launch floor (an empty kernel).

With ``--backward`` it times the backward entries instead, from
``rmsnorm_bwd.cu`` of the same directory, at qwen3-8b's train shapes
(q_norm [4, 512, 32, 128], k_norm [4, 512, 8, 128], the fused add+ln
[4, 512, 4096]) beside their bounds and the library's backward (autograd
of ``F.rms_norm``, after ``x + r`` for the fused entry), each first held
against autograd of the plain version (share of the bf16 tolerance) and
rerun bitwise. It calls the earlier interface (scratch sized by
``rmsnorm_bwd_rows_per_chunk``) where the source has it.

With ``--cluster`` it also builds ``tools/k1_cluster.cu`` (each decode row
split over a thread-block cluster of 2-8 CTAs), checks it against the
plain version and times it beside the shipped kernel (one CTA a row) at
decode's 4 rows. One JSON object a line.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402

BF = torch.bfloat16
B, S = cs.B, cs.S
# (cluster size, d): the configurations tools/k1_cluster.cu instantiates
CLUSTERS = [(2, 4096), (4, 4096), (8, 4096), (2, 7168), (4, 7168),
            (2, 3584)]


def k1_calls(gen, fused):
    """{table row: [(call, x, r, w)]} at the served shapes; w is ones, as
    the models' norm scales are initialised."""
    dq, dz, di = cs.QWEN.d_model, cs.ZAMBA.d_model, 2 * cs.ZAMBA.d_model

    def act(*shape):
        return cs._rand(gen, shape, BF)

    def ones(d):
        return torch.ones(d, dtype=BF, device="cuda")
    rows = {
        "qwen3-8b prefill layer: ln1+ln2+q+k": [
            ("ln1", act(B, S, dq), None, ones(dq)),
            ("ln2", act(B, S, dq), None, ones(dq)),
            ("q_norm", act(B, S, 32, 128), None, ones(128)),
            ("k_norm", act(B, S, 8, 128), None, ones(128))],
        "zamba2-7b prefill Mamba block: ln+out_norm": [
            ("mamba.ln", act(B, S, dz), None, ones(dz)),
            ("mamba.out_norm", act(B, S, di), None, ones(di))],
        "zamba2-7b attention application: attn_ln+attn_mlp_ln": [
            ("attn_ln", act(B, S, dz), None, ones(dz)),
            ("attn_mlp_ln", act(B, S, dz), None, ones(dz))],
        "zamba2-7b decode Mamba block: ln+out_norm": [
            ("mamba.ln_decode", act(B, 1, dz), None, ones(dz)),
            ("mamba.out_norm_decode", act(B, 1, di), None, ones(di))],
        "qwen3-8b decode: ln1+q_norm": [
            ("ln1_decode", act(B, 1, dq), None, ones(dq)),
            ("q_norm_decode", act(B, 1, 32, 128), None, ones(128))],
    }
    if fused:
        rows.update({
            "qwen3-8b prefill layer as served: add+ln1, add+ln2, q, k": [
                ("add+ln1", act(B, S, dq), act(B, S, dq), ones(dq)),
                ("add+ln2", act(B, S, dq), act(B, S, dq), ones(dq)),
                ("q_norm", act(B, S, 32, 128), None, ones(128)),
                ("k_norm", act(B, S, 8, 128), None, ones(128))],
            "zamba2-7b prefill Mamba block as served: add+ln, out_norm": [
                ("add+mamba.ln", act(B, S, dz), act(B, S, dz), ones(dz)),
                ("mamba.out_norm", act(B, S, di), None, ones(di))],
            "zamba2-7b decode Mamba block as served: add+ln, out_norm": [
                ("add+mamba.ln_decode", act(B, 1, dz), act(B, 1, dz),
                 ones(dz)),
                ("mamba.out_norm_decode", act(B, 1, di), None, ones(di))],
        })
    return rows


def cluster_probe(card, flush, gen):
    """The cluster-split decode norm against the shipped one-CTA-a-row
    kernel, at 4 rows."""
    lib = Path(build.BUILD_DIR) / "k1_cluster.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    os.path.join(ROOT, "tools", "k1_cluster.cu")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).rmsnorm_cluster_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for c, d in CLUSTERS:
        x = cs._rand(gen, (B, d), BF)
        w = cs._rand(gen, (d,), BF)
        y = torch.empty_like(x)

        def run():
            err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), B, d, c, 1e-5,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"cluster launch failed: CUDA error {err}")
        run()
        err = cs.compare("rmsnorm_cluster", y, ref.rmsnorm_ref(x, w), BF,
                         rows=B, d=d, cluster=c)
        cs.emit({"time": "rmsnorm_decode_design", "rows": B, "d": d,
                 "cluster_ctas": c, "cluster_ms": cs.time_ms(run, flush),
                 "one_cta_a_row_ms": cs.time_ms(lambda: rmsnorm(x, w),
                                                flush),
                 "max_abs_err": err, "card": card})


def backward_fn():
    """(dy, x, ds, w, eps) -> (dx, dw) of the built rmsnorm_bwd library:
    the tree's wrappers, or for the earlier source its C entry with the
    earlier scratch (float64 partials of rows_per_chunk rows, then rstd)."""
    if b"rmsnorm_bwd_scratch_bytes" in (build.source_dir("rmsnorm_bwd") /
                                        "rmsnorm_bwd.cu").read_bytes():
        return lambda dy, x, ds, w, eps: (
            rn.rmsnorm_bwd(dy, x, w, eps=eps) if ds is None
            else rn.add_rmsnorm_bwd(dy, ds, x, w, eps=eps))
    rpc = build.load_function("rmsnorm_bwd", "rmsnorm_bwd_rows_per_chunk",
                              [ctypes.c_int] * 2)
    fn = build.load_function("rmsnorm_bwd", "rmsnorm_bwd", rn._BWD_ARGTYPES)

    def old(dy, x, ds, w, eps):
        rows, x_n, x_outer, x_inner = rn.row_view(x)
        d = x.shape[-1]
        n_chunks = -(-rows // rpc(rows, d))
        scratch = torch.empty(2 * n_chunks * d + rows, dtype=torch.float32,
                              device="cuda")
        dx, dw = torch.empty_like(x), torch.empty_like(w)
        err = fn(dy.data_ptr(), x.data_ptr(),
                 None if ds is None else ds.data_ptr(), w.data_ptr(),
                 dx.data_ptr(), dw.data_ptr(), scratch.data_ptr(), 1, rows, d,
                 *rn.row_view(dy)[1:], x_n, x_outer, x_inner,
                 *((1, 0, 0) if ds is None else rn.row_view(ds)[1:]), eps,
                 torch.cuda.current_stream().cuda_stream)
        build.check("rmsnorm_bwd", err)
        return dx, dw
    return old


def backward_rows(card, flush, gen, source):
    """The backward entries at qwen3-8b's train shapes, as chip_smoke.py's
    train.kernels phase times them."""
    build.build_all(["rmsnorm_bwd"])
    bwd = backward_fn()
    for row in cs.ptxas_report("rmsnorm_bwd"):
        cs.emit({**row, "source": source})
    d, eps = cs.QWEN.d_model, cs.QWEN.norm_eps
    for call, shape, fused in [("add+ln", (B, S, d), True),
                               ("q_norm", (B, S, 32, 128), False),
                               ("k_norm", (B, S, 8, 128), False)]:
        x, dy = cs._rand(gen, shape, BF), cs._rand(gen, shape, BF)
        w = cs._rand(gen, (shape[-1],), BF)
        ds = cs._rand(gen, shape, BF) if fused else None
        got = bwd(dy, x, ds, w, eps)
        want = (ref.add_rmsnorm_bwd_ref(dy, ds, x, w, eps=eps) if fused
                else ref.rmsnorm_bwd_ref(dy, x, w, eps=eps))
        atol, rtol = cs.TOL[BF]
        share = max(float(((g.float() - t.float()).abs()
                           / (atol + rtol * t.float().abs())).max())
                    for g, t in zip(got, want))
        again = bwd(dy, x, ds, w, eps)
        lx, lw = (t.detach().requires_grad_(True) for t in (x, w))
        if fused:
            lr = torch.zeros_like(x).requires_grad_(True)
            ls = lx + lr
            ly = torch.nn.functional.rms_norm(ls, (shape[-1],), lw, eps)
            outs, ins, grads = [ls, ly], [lx, lr, lw], [ds, dy]
        else:
            ly = torch.nn.functional.rms_norm(lx, (shape[-1],), lw, eps)
            outs, ins, grads = [ly], [lx, lw], [dy]
        cs.emit({"time": "add_rmsnorm_bwd" if fused else "rmsnorm_bwd",
                 "call": call, "shape": list(shape), "source": source,
                 "ms": cs.time_ms(lambda: bwd(dy, x, ds, w, eps), flush),
                 "library_ms": cs._grad_ms(outs, ins, grads, flush),
                 **cs.bound((cs.cost.add_rmsnorm_bwd if fused
                             else cs.cost.rmsnorm_bwd)(shape, BF)),
                 "share_of_tolerance": share,
                 "reruns_bitwise": all(torch.equal(a, b_)
                                       for a, b_ in zip(got, again)),
                 "card": card})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", help="directory holding another rmsnorm.cu")
    ap.add_argument("--cluster", action="store_true",
                    help="also probe the cluster-split decode norm")
    ap.add_argument("--backward", action="store_true",
                    help="time the backward entries instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_check: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    source = "src/repro_torch/kernels/csrc"
    if args.csrc:
        build.use_source("rmsnorm_bwd" if args.backward else "rmsnorm",
                         args.csrc)
        source = args.csrc
    card = cs.card()
    if args.backward:
        backward_rows(card, cs._L2Flush(),
                      torch.Generator(device="cuda").manual_seed(5), source)
        return 0
    build.build_all(["rmsnorm"])
    fused = b"add_rmsnorm_fwd" in (build.source_dir("rmsnorm")
                                   / "rmsnorm.cu").read_bytes()
    flush = cs._L2Flush()
    gen = torch.Generator(device="cuda").manual_seed(5)
    for row, calls in k1_calls(gen, fused).items():
        tot = cs._rmsnorm_times(card, flush, calls, 1e-6)
        cs.emit({"row": row, "source": source,
                 **{k: tot[k] for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms")},
                 "card": card})
    cs._launch_floor(card, flush)
    if args.cluster:
        cluster_probe(card, flush, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
