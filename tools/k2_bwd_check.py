#!/usr/bin/env python3
"""Check and time K2 (flash attention) on the card, alone: its backward
kernels by default, its forward kernel with ``--forward``.

    python3 tools/k2_bwd_check.py [--forward] [--shapes SETS]
                                  [--csrc DIR | --compare DIR]

Builds ``flash_attention_bwd.cu`` (or, with ``--forward``,
``flash_attention.cu``) from ``src/repro_torch/kernels/csrc``, or from
``DIR`` (another version of the source, such as the parent commit's,
unpacked under a directory that ``.gitignore`` lists, with any header it
includes); in the backward mode the forward, which gives o and the
logsumexp, is always the tree's. Two versions of a source go in two
processes, since their libraries share symbols: run parent, change,
change, parent in one call. The backward mode detects the source's C
interface (the bf16 kernels that read the forward's lse, or the earlier
one that recomputes it).

``--compare DIR`` compares DIR's version with the tree's in one call: it
runs DIR, the tree, the tree and DIR again, each in a process of its own
(``--csrc DIR`` for DIR's), prints their lines, then one ``compare`` line
a case: both versions' times (first and second run), their kernels'
split, SDPA's default and deterministic times (forward: also SDPA's
warm kernels and the stream floor), and whether the two
versions' outputs are bitwise equal (``bitwise``; ``runs_bitwise``: each
version's digest the same in both of its processes). The parent
commit's sources, for instance:

    mkdir -p build/parent_csrc && for f in flash_attention.cu \
        flash_attention_bwd.cu hopper_tc.cuh; do git show \
        HEAD:src/repro_torch/kernels/csrc/$f > build/parent_csrc/$f; done

``--shapes`` takes a comma-separated list of sets (default ``train``):
``train``, qwen3-8b's [4, 32, 512, 128] with 8 KV heads (also mixtral-8x7b's
and the VLM's self-attention) and zamba2-7b's [4, 32, 512, 112] with 32,
causal; ``wide``, the VLM's cross shape (q [4, 32, 512, 128] over k/v
[4, 8, 1600, 128], non-causal) and codeqwen1.5-7b's causal MHA
[4, 32, 512, 128]; ``small``, codeqwen1.5-7b reduced (D 32, 4 x 64),
qwen3-8b's shape with a window of 100 (no SDPA time: it takes no window)
and D 112 without a causal limit (zamba2-7b's heads at batch 1, 130 rows);
``whisper``,
whisper-tiny's D 64 MHA (6 heads): the encoder's [4, 6, 1500, 64] and the
cross-attention over 1,500 frames, non-causal, and the decoder's causal
self-attention (448 text rows as trained for the backward, the 416-row
served prompt for the forward); ``kvheads``, a diagnostic: codeqwen1.5-7b's
causal q [4, 32, 512, 128] over 16 KV heads (group 2: heads paired, twice
qwen3-8b's K/V bytes) and over 8 (qwen3-8b's), which parts the cost of
unpaired heads from that of MHA's K/V bytes.

For each shape it holds the bf16 result against the plain version (the
forward against ``ref.flash_attention_ref``, the gradients against
autograd of it: share of the bf16 tolerance; reruns bitwise), prints a
digest of the output bits (equal digests in two processes: bitwise equal
results), then CUDA-event medians (L2 flushed, as ``chip_smoke.py``
times) beside its bound and SDPA's with PyTorch's default and
deterministic settings, and the device time of each of its kernels from a
``torch.profiler`` trace of ten calls (L2 warm). The forward also gives
SDPA's kernels with L2 warm and, at an MHA shape with Sq = Skv, the time
of one elementwise kernel (``torch.addcmul``) that moves the bytes of the
attention's bound, timed as the attention is (``stream_floor_ms``: what
that timing's memory traffic alone takes). One JSON object a line.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

BF = torch.bfloat16


def _case(arch, cfg, sq, skv, causal, window=0, b=cs.B, hkv=None):
    return dict(arch=arch, b=b, hq=cfg.n_heads,
                hkv=hkv or cfg.n_kv_heads, d=cfg.resolved_head_dim, sq=sq,
                skv=skv, causal=causal, window=window)


def shape_sets(forward):
    """name -> the cases of that set; ``forward`` picks whisper's served
    prompt (416 rows) over its trained text (448)."""
    text = cs.WHISPER_PROMPT if forward else cs.TRAIN_SEQ_WHISPER
    frames = cs.WHISPER.n_frames
    return {
        "train": [_case("qwen3-8b", cs.QWEN, cs.S, cs.S, True),
                  _case("zamba2-7b", cs.ZAMBA, cs.S, cs.S, True)],
        "wide": [_case("llama-3.2-vision-11b cross", cs.VISION, cs.S,
                       cs.VISION.n_image_tokens, False),
                 _case("codeqwen1.5-7b", cs.CODEQWEN, cs.S, cs.S, True)],
        "whisper": [_case("whisper-tiny encoder", cs.WHISPER, frames,
                          frames, False),
                    _case("whisper-tiny cross", cs.WHISPER, text, frames,
                          False),
                    _case("whisper-tiny self", cs.WHISPER, text, text,
                          True)],
        "small": [_case("codeqwen1.5-7b reduced", cs.CODEQWEN.reduced(), 64,
                        64, True),
                  _case("qwen3-8b window 100", cs.QWEN, cs.S, cs.S, True,
                        window=100),
                  _case("zamba2-7b non-causal", cs.ZAMBA, 130, 130, False,
                        b=1)],
        "kvheads": [_case(f"codeqwen1.5-7b q, {h} KV heads", cs.CODEQWEN,
                          cs.S, cs.S, True, hkv=h) for h in (16, 8)],
    }


# the earlier interface: no lse argument, scratch of 2 [B, Hq, Sq] arrays
_OLD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 33
                 + [ctypes.c_float, ctypes.c_void_p])


def backward_fn(reads_lse):
    """The backward as (q, k, v, o, do, lse, causal, window) -> (dq, dk,
    dv): the tree's wrapper for a source that reads lse, else a call of the
    earlier C interface with the earlier scratch."""
    if reads_lse:
        return lambda q, k, v, o, do, lse, causal, window: (
            fa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                   window=window))
    fn = build.load_function("flash_attention_bwd", "flash_attention_bwd",
                             _OLD_ARGTYPES)

    def old(q, k, v, o, do, lse, causal, window):
        b, hq, sq, d = q.shape
        hkv, skv = k.shape[1], k.shape[2]
        dq = torch.empty((b, sq, hq, d), dtype=BF, device="cuda"
                         ).transpose(1, 2)
        dk = torch.empty((b, skv, hkv, d), dtype=BF, device="cuda"
                         ).transpose(1, 2)
        dv = torch.empty_like(dk)
        scratch = torch.empty(2 * b * hq * sq, dtype=torch.float32,
                              device="cuda")
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 scratch.data_ptr(), 1, b, hq, hkv, sq, skv, d,
                 *(s for t in (q, k, v, o, do, dq, dk, dv)
                   for s in fa._bsh_strides(t)),
                 int(causal), window, d ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        build.check("flash_attention_bwd", err)
        return dq, dk, dv
    return old


def digest(tensors):
    """sha256 (first 16 hex digits) of the tensors' bits, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def share(got, want):
    atol, rtol = cs.TOL[BF]
    return float(((got.float() - want.float()).abs()
                  / (atol + rtol * want.float().abs())).max())


def check_forward(c, gen, flush, card, source):
    q = cs._bshd(gen, c["b"], c["sq"], c["hq"], c["d"], BF)
    k, v = (cs._bshd(gen, c["b"], c["skv"], c["hkv"], c["d"], BF)
            for _ in range(2))
    causal, window = c["causal"], c["window"]

    def run():
        return fa.flash_attention(q, k, v, causal=causal, window=window)
    got = run()
    o, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                return_lse=True)
    lse_err = float((lse - ref.flash_attention_lse_ref(
        q, k, causal=causal, window=window)).abs().max())
    lib = [None if window else cs._sdpa_ms(q, k, v, flush, det, causal)
           for det in (False, True)]
    # SDPA's kernels with L2 warm, as kernels_ms; and, where q, k, v and o
    # have one shape (MHA, Sq = Skv), one elementwise kernel that moves the
    # attention's bound's bytes (q, k, v read once, o written once), timed
    # as the attention is: the floor of that timing's memory traffic
    lib_kernels = None if window else cs.kernel_split(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                               enable_gqa=True))
    floor = None
    if q.shape == k.shape:
        out = torch.empty_like(q)
        floor = cs.time_ms(lambda: torch.addcmul(q, k, v, out=out), flush)
    row = {"time": "flash_attention", **c, "source": source,
           "share_of_tolerance": share(got, ref.flash_attention_ref(
               q, k, v, causal=causal, window=window)),
           "lse_max_abs_err": lse_err,
           "o_equal_with_lse": torch.equal(o, got),
           "reruns_bitwise": torch.equal(got, run()),
           "digest": digest([got]), "lse_digest": digest([lse]),
           "ms": cs.time_ms(run, flush),
           "library_ms": lib[0], "library_deterministic_ms": lib[1],
           **cs.bound(cs.cost.attention(c["b"], c["hq"], c["hkv"], c["sq"],
                                        c["skv"], c["d"], BF, causal,
                                        window)),
           "kernels_ms": cs.kernel_split(run),
           "library_kernels_ms": lib_kernels, "stream_floor_ms": floor,
           "card": card}
    cs.emit(row)


def check_backward(c, gen, flush, card, source, bwd, reads_lse):
    q, do = (cs._bshd(gen, c["b"], c["sq"], c["hq"], c["d"], BF)
             for _ in range(2))
    k, v = (cs._bshd(gen, c["b"], c["skv"], c["hkv"], c["d"], BF)
            for _ in range(2))
    causal, window = c["causal"], c["window"]
    o, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                return_lse=True)

    def run():
        return bwd(q, k, v, o, do, lse, causal, window)
    got = run()
    want = ref.flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                       window=window)
    shares = [share(g, w) for g, w in zip(got, want)]
    bitwise = all(torch.equal(a, b) for a, b in zip(got, run()))
    del want
    lib = [None if window else
           cs._sdpa_bwd_ms(q, k, v, do, flush, det, causal)[0]
           for det in (False, True)]
    cs.emit({"time": "flash_attention_bwd", **c, "source": source,
             "reads_lse": reads_lse,
             "ms": cs.time_ms(run, flush),
             "library_ms": lib[0], "library_deterministic_ms": lib[1],
             **cs.bound(cs.cost.attention_bwd(c["b"], c["hq"], c["hkv"],
                                              c["sq"], c["skv"], c["d"], BF,
                                              causal, window)),
             "share_of_tolerance": {"dq": shares[0], "dk": shares[1],
                                    "dv": shares[2]},
             "reruns_bitwise": bitwise, "digest": digest(got),
             "kernels_ms": cs.kernel_split(run), "card": card})


def compare_sources(csrc, forward, shapes):
    """DIR, the tree, the tree, DIR, each in a process of its own; then a
    ``compare`` line a case: the two versions' times and kernel splits,
    SDPA's, and whether their outputs are bitwise equal."""
    runs = []
    for source in (csrc, None, None, csrc):
        cmd = [sys.executable, os.path.abspath(__file__), "--shapes", shapes]
        if forward:
            cmd.append("--forward")
        if source:
            cmd += ["--csrc", source]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            raise RuntimeError(f"k2_bwd_check {' '.join(cmd[2:])} failed "
                               f"(exit {proc.returncode})")
        runs.append([json.loads(line) for line in proc.stdout.splitlines()
                     if line.startswith("{") and '"time"' in line])
    by_case = {}
    for i, lines in enumerate(runs):
        version = "parent" if i in (0, 3) else "change"
        for line in lines:
            key = (line["arch"], line["sq"], line["skv"], line["causal"])
            e = by_case.setdefault(key, {
                "parent_ms": [], "change_ms": [], "parent_kernels_ms": [],
                "change_kernels_ms": [], "library_ms": [],
                "library_deterministic_ms": [], "library_kernels_ms": [],
                "stream_floor_ms": [], "digests": {}})
            e["digests"].setdefault(version, set()).add(line["digest"])
            e[f"{version}_ms"].append(line["ms"])
            e[f"{version}_kernels_ms"].append(line["kernels_ms"])
            e["library_ms"].append(line["library_ms"])
            e["library_deterministic_ms"].append(
                line["library_deterministic_ms"])
            for key in ("library_kernels_ms", "stream_floor_ms"):
                e[key].append(line.get(key))
            e["bound_ms"], e["bound_by"] = line["bound_ms"], line["bound_by"]
    card = cs.card()
    for (arch, sq, skv, causal), e in by_case.items():
        dg = e.pop("digests")
        cs.emit({"compare": "flash_attention" if forward
                 else "flash_attention_bwd", "arch": arch, "sq": sq,
                 "skv": skv, "causal": causal, **e,
                 "bitwise": dg.get("parent") == dg.get("change"),
                 "runs_bitwise": all(len(v) == 1 for v in dg.values()),
                 "card": card})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--forward", action="store_true",
                    help="check and time the forward kernel")
    ap.add_argument("--shapes", default="train",
                    help="comma-separated sets: train, wide, small, "
                    "whisper, kvheads")
    ap.add_argument("--csrc", help="directory holding another version of "
                    "the kernel's source")
    ap.add_argument("--compare", metavar="DIR",
                    help="compare DIR's version with the tree's: DIR, "
                    "tree, tree, DIR, each in a process of its own")
    args = ap.parse_args()
    sets = shape_sets(args.forward)
    cases = [c for name in args.shapes.split(",") for c in sets[name]]
    if not torch.cuda.is_available():
        print("k2_bwd_check: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.compare:
        compare_sources(args.compare, args.forward, args.shapes)
        return 0
    card = cs.card()
    # as chip_smoke.py runs: no fill of uninitialised memory under the
    # deterministic switch (it would add fill kernels to SDPA's time)
    torch.utils.deterministic.fill_uninitialized_memory = False
    name = "flash_attention" if args.forward else "flash_attention_bwd"
    source = "src/repro_torch/kernels/csrc"
    if args.csrc:
        build.use_source(name, args.csrc)
        source = args.csrc
    build.build_all([name] if args.forward
                    else ["flash_attention", "flash_attention_bwd"])
    for row in cs.ptxas_report(name):
        if "float" not in row.get("function", "").split("(")[0]:
            cs.emit({**row, "source": source})
    flush = cs._L2Flush()
    gen = torch.Generator(device="cuda").manual_seed(13)
    if not args.forward:
        text = (build.source_dir(name) / f"{name}.cu").read_text()
        reads_lse = "const void* lse" in text
        bwd = backward_fn(reads_lse)
    for c in cases:
        if args.forward:
            check_forward(c, gen, flush, card, source)
        else:
            check_backward(c, gen, flush, card, source, bwd, reads_lse)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
