#!/usr/bin/env python3
"""Time the RMSNorm kernel (K1) on the card, alone.

    python3 tools/k1_check.py [--csrc DIR] [--cluster] [--backward]

Builds K1 from ``src/repro_torch/kernels/csrc/rmsnorm.cu``, prints what
ptxas reported for each instantiation (registers, shared memory, spills)
and times, as ``chip_smoke.py`` does, the K1 calls of ``PERF.md``'s kernel
table at the served bf16 shapes: the qwen3-8b prefill layer's four norms,
the zamba2-7b Mamba block's two and attention application's two, the
decode norms, and the narrow widths: whisper-tiny's encoder ln1 and
add+ln2 at [4, 1500, 384], its decoder add+ln_x at [4, 416, 384] and a
decode add+ln2 at [4, 1, 384], xlstm-350m's ln and add+ln at
[4, 512, 1024] and a decode add+ln at [4, 1, 1024]; where the source has
the fused entry, the fused calls that the models now make as well; and the
launch floor (an empty kernel). Each call's line carries a digest of its
outputs (seeded inputs), so that two versions of the source can be
compared bit for bit.

With ``--backward`` it times the backward entries instead, from
``rmsnorm_bwd.cu`` of the same directory, at qwen3-8b's train shapes
(q_norm [4, 512, 32, 128], k_norm [4, 512, 8, 128], the fused add+ln
[4, 512, 4096]) and the narrow train shapes (whisper-tiny's encoder
add+ln [4, 1500, 384] and decoder add+ln [4, 448, 384], xlstm-350m's
add+ln and ln [4, 512, 1024]) beside their bounds and the library's
backward (autograd of ``F.rms_norm``, after ``x + r`` for the fused
entry), with the device time of each of its launches from a profiler
trace, each first held against autograd of the plain version (share of
the bf16 tolerance) and rerun bitwise. It calls the earlier interface
(scratch sized by ``rmsnorm_bwd_rows_per_chunk``) where the source has it.

``--csrc DIR`` compares another version of the source (``DIR/rmsnorm.cu``
or, with ``--backward``, ``DIR/rmsnorm_bwd.cu``; such as the parent
commit's, unpacked under a directory that ``.gitignore`` lists) with the
tree's: it runs DIR, the tree, the tree and DIR again, each in a process
of its own (their libraries share symbols), prints their lines, then one
``compare`` line a call: both versions' times (first and second run) and
whether their outputs are bitwise equal.

    mkdir -p build/parent_csrc && for f in rmsnorm.cu rmsnorm_bwd.cu; do
      git show HEAD:src/repro_torch/kernels/csrc/$f > build/parent_csrc/$f; done

With ``--cluster`` it also builds ``tools/k1_cluster.cu`` (each decode row
split over a thread-block cluster of 2-8 CTAs), checks it against the
plain version and times it beside the shipped kernel (one CTA a row) at
decode's 4 rows. One JSON object a line.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
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
    dw, dx, m, p = (cs.WHISPER.d_model, cs.XLSTM.d_model,
                    cs.WHISPER.n_frames, cs.WHISPER_PROMPT)
    rows["whisper-tiny encoder: ln1"] = [
        ("encoder ln1 d=384", act(B, m, dw), None, ones(dw))]
    rows["xlstm-350m: ln"] = [("ln d=1024", act(B, S, dx), None, ones(dx))]
    if fused:
        rows.update({
            "whisper-tiny encoder: add+ln2": [
                ("encoder add+ln2 d=384", act(B, m, dw), act(B, m, dw),
                 ones(dw))],
            "whisper-tiny decoder: add+ln_x": [
                ("decoder add+ln_x d=384", act(B, p, dw), act(B, p, dw),
                 ones(dw))],
            "whisper-tiny decode: add+ln2": [
                ("decode add+ln2 d=384", act(B, 1, dw), act(B, 1, dw),
                 ones(dw))],
            "xlstm-350m: add+ln": [
                ("add+ln d=1024", act(B, S, dx), act(B, S, dx), ones(dx))],
            "xlstm-350m decode: add+ln": [
                ("decode add+ln d=1024", act(B, 1, dx), act(B, 1, dx),
                 ones(dx))],
        })
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


def digest(*tensors):
    """sha256 (first 16 hex digits) of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def backward_rows(card, flush, gen, source):
    """The backward entries at qwen3-8b's train shapes and at the narrow
    widths' (whisper-tiny's d 384, xlstm-350m's d 1024), as
    chip_smoke.py's train.kernels phase times them."""
    build.build_all(["rmsnorm_bwd"])
    bwd = backward_fn()
    for row in cs.ptxas_report("rmsnorm_bwd"):
        cs.emit({**row, "source": source})
    d, eps = cs.QWEN.d_model, cs.QWEN.norm_eps
    dw, dx = cs.WHISPER.d_model, cs.XLSTM.d_model
    for call, shape, fused in [
            ("add+ln", (B, S, d), True),
            ("q_norm", (B, S, 32, 128), False),
            ("k_norm", (B, S, 8, 128), False),
            ("whisper enc add+ln d=384", (B, cs.WHISPER.n_frames, dw), True),
            ("whisper dec add+ln d=384", (B, 448, dw), True),
            ("xlstm add+ln d=1024", (B, S, dx), True),
            ("xlstm ln d=1024", (B, S, dx), False)]:
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
                 "split_ms": cs.kernel_split(lambda: bwd(dy, x, ds, w, eps)),
                 "share_of_tolerance": share,
                 "reruns_bitwise": all(torch.equal(a, b_)
                                       for a, b_ in zip(got, again)),
                 "digest": digest(*got), "card": card})


def forward_rows(card, flush, gen, source):
    """The forward calls of ``k1_calls``: ptxas lines, each call's times
    and output digest, each table row's sums, the launch floor."""
    build.build_all(["rmsnorm"])
    for row in cs.ptxas_report("rmsnorm"):
        cs.emit({**row, "source": source})
    fused = b"add_rmsnorm_fwd" in (build.source_dir("rmsnorm")
                                   / "rmsnorm.cu").read_bytes()
    for row, calls in k1_calls(gen, fused).items():
        digests = {}
        for call, x, r, w in calls:
            out = (rmsnorm(x, w, eps=1e-6),) if r is None else \
                rn.add_rmsnorm(x, r, w, eps=1e-6)
            digests[call] = digest(*out)
        tot = cs._rmsnorm_times(card, flush, calls, 1e-6)
        for call, x, _, _ in calls:
            cs.emit({"k1_call": call, "row": row, "shape": list(x.shape),
                     "digest": digests[call], "source": source,
                     **{k: tot["calls"][call][k]
                        for k in ("ms", "library_ms", "bound_ms")}})
        cs.emit({"row": row, "source": source,
                 **{k: tot[k] for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms")},
                 "card": card})
    cs._launch_floor(card, flush)


def compare_sources(csrc, backward):
    """DIR, the tree, the tree, DIR, each in a process of its own; then a
    ``compare`` line a call: the two versions' times and whether their
    outputs are bitwise equal."""
    tree = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
    runs = []
    for source in (csrc, tree, tree, csrc):
        cmd = [sys.executable, os.path.abspath(__file__), "--only", source]
        if backward:
            cmd.append("--backward")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            raise RuntimeError(f"k1_check --only {source} failed "
                               f"(exit {proc.returncode})")
        runs.append([json.loads(line) for line in proc.stdout.splitlines()
                     if line.startswith("{")])
    by_call = {}
    for i, lines in enumerate(runs):
        version = "parent" if i in (0, 3) else "change"
        for line in lines:
            if "digest" not in line:
                continue
            key = (line.get("row"), line.get("k1_call", line.get("call")),
                   tuple(line["shape"]))
            e = by_call.setdefault(key, {"parent_ms": [], "change_ms": [],
                                         "library_ms": [], "digests": {}})
            e["digests"].setdefault(version, set()).add(line["digest"])
            e[f"{version}_ms"].append(line["ms"])
            e["library_ms"].append(line["library_ms"])
            e["bound_ms"] = line["bound_ms"]
    card = cs.card()
    for (row, call, shape), e in by_call.items():
        dg = e.pop("digests")
        cs.emit({"compare": call, "row": row, "shape": list(shape), **e,
                 "bitwise": dg.get("parent") == dg.get("change"),
                 "runs_bitwise": all(len(v) == 1 for v in dg.values()),
                 "card": card})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", help="directory holding another rmsnorm.cu "
                    "(or rmsnorm_bwd.cu) to compare with the tree's")
    ap.add_argument("--only", help=argparse.SUPPRESS)  # one version, here
    ap.add_argument("--cluster", action="store_true",
                    help="also probe the cluster-split decode norm")
    ap.add_argument("--backward", action="store_true",
                    help="time the backward entries instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_check: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.csrc:
        compare_sources(args.csrc, args.backward)
        return 0
    source = "src/repro_torch/kernels/csrc"
    if args.only:
        build.use_source("rmsnorm_bwd" if args.backward else "rmsnorm",
                         args.only)
        source = args.only
    card = cs.card()
    flush = cs._L2Flush()
    gen = torch.Generator(device="cuda").manual_seed(5)
    if args.backward:
        backward_rows(card, flush, gen, source)
        return 0
    forward_rows(card, flush, gen, source)
    if args.cluster:
        cluster_probe(card, flush, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
