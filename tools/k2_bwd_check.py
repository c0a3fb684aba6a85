#!/usr/bin/env python3
"""Check and time the flash-attention backward kernels (K2's backward) on
the card, alone.

    python3 tools/k2_bwd_check.py [--csrc DIR]

Builds ``flash_attention_bwd.cu`` from ``src/repro_torch/kernels/csrc``, or
from ``DIR`` (another version of the source, such as the parent commit's,
unpacked under a directory that ``.gitignore`` lists, with any header it
includes); the forward, which gives o and the logsumexp, is always the
tree's. Two versions of the backward go in two processes, since their
libraries share symbols: run parent, change, change, parent in one call.
It detects the source's C interface (the bf16 kernels that read the
forward's lse, or the earlier one that recomputes it). For each train
shape (qwen3-8b's [4, 32, 512, 128] with 8 KV heads, zamba2-7b's
[4, 32, 512, 112] with 32) it holds the bf16 gradients against autograd of
the plain version (share of the bf16 tolerance; reruns bitwise), then
prints CUDA-event medians (L2 flushed, as ``chip_smoke.py`` times) of the
backward beside its bound and SDPA's backward with PyTorch's default and
deterministic settings, and the device time of each of its kernels from a
``torch.profiler`` trace of ten calls (L2 warm). One JSON object a line.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

BF = torch.bfloat16
# (arch, hq, hkv, d) at batch 4 x 512, causal
SHAPES = [("qwen3-8b", cs.QWEN.n_heads, cs.QWEN.n_kv_heads,
           cs.QWEN.resolved_head_dim),
          ("zamba2-7b", cs.ZAMBA.n_heads, cs.ZAMBA.n_kv_heads,
           cs.ZAMBA.resolved_head_dim)]
# the earlier interface: no lse argument, scratch of 2 [B, Hq, Sq] arrays
_OLD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 33
                 + [ctypes.c_float, ctypes.c_void_p])


def backward_fn(reads_lse):
    """The backward as (q, k, v, o, do, lse) -> (dq, dk, dv): the tree's
    wrapper for a source that reads lse, else a call of the earlier C
    interface with the earlier scratch."""
    if reads_lse:
        return lambda q, k, v, o, do, lse: fa.flash_attention_bwd(
            q, k, v, o, do, lse)
    fn = build.load_function("flash_attention_bwd", "flash_attention_bwd",
                             _OLD_ARGTYPES)

    def old(q, k, v, o, do, lse):
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
                 1, 0, d ** -0.5, torch.cuda.current_stream().cuda_stream)
        build.check("flash_attention_bwd", err)
        return dq, dk, dv
    return old


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", help="directory holding another "
                    "flash_attention_bwd.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_bwd_check: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = cs.card()
    # as chip_smoke.py runs: no fill of uninitialised memory under the
    # deterministic switch (it would add fill kernels to SDPA's time)
    torch.utils.deterministic.fill_uninitialized_memory = False
    source = "src/repro_torch/kernels/csrc"
    if args.csrc:
        build.use_source("flash_attention_bwd", args.csrc)
        source = args.csrc
    build.build_all(["flash_attention_bwd"])
    text = (build.source_dir("flash_attention_bwd")
            / "flash_attention_bwd.cu").read_text()
    reads_lse = "const void* lse" in text
    bwd = backward_fn(reads_lse)
    for row in cs.ptxas_report("flash_attention_bwd"):
        if "float>" not in row.get("function", ""):
            cs.emit({**row, "source": source})
    flush = cs._L2Flush()
    gen = torch.Generator(device="cuda").manual_seed(13)
    for arch, hq, hkv, dh in SHAPES:
        q, k, v, do = (cs._bshd(gen, cs.B, cs.S, h, dh, BF)
                       for h in (hq, hkv, hkv, hq))
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        got = bwd(q, k, v, o, do, lse)
        want = ref.flash_attention_bwd_ref(q, k, v, do, causal=True)
        atol, rtol = cs.TOL[BF]
        shares = [float(((g.float() - w.float()).abs()
                         / (atol + rtol * w.float().abs())).max())
                  for g, w in zip(got, want)]
        again = bwd(q, k, v, o, do, lse)
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        del want, again
        lib, _ = cs._sdpa_bwd_ms(q, k, v, do, flush, deterministic=False)
        lib_det, _ = cs._sdpa_bwd_ms(q, k, v, do, flush, deterministic=True)
        cs.emit({"time": "flash_attention_bwd", "arch": arch,
                 "shape": list(q.shape), "kv_heads": hkv, "source": source,
                 "reads_lse": reads_lse,
                 "ms": cs.time_ms(lambda: bwd(q, k, v, o, do, lse), flush),
                 "library_ms": lib, "library_deterministic_ms": lib_det,
                 **cs.bound(cs.cost.attention_bwd(cs.B, hq, hkv, cs.S,
                                                  cs.S, dh, BF)),
                 "share_of_tolerance": {"dq": shares[0], "dk": shares[1],
                                        "dv": shares[2]},
                 "reruns_bitwise": bitwise,
                 "kernels_ms": cs.kernel_split(
                     lambda: bwd(q, k, v, o, do, lse)),
                 "card": card})
        del q, k, v, do, o, lse, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
