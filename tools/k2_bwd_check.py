#!/usr/bin/env python3
"""Check and time K2 (flash attention) on the card, alone: its backward
kernels by default, its forward kernel with ``--forward``.

    python3 tools/k2_bwd_check.py [--forward] [--shapes SETS] [--csrc DIR]

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

``--shapes`` takes a comma-separated list of sets (default ``train``):
``train``, qwen3-8b's [4, 32, 512, 128] with 8 KV heads and zamba2-7b's
[4, 32, 512, 112] with 32, causal; ``wide``, the VLM's cross shape (q
[4, 32, 512, 128] over k/v [4, 8, 1600, 128], non-causal) and
codeqwen1.5-7b's causal MHA [4, 32, 512, 128]; ``whisper``,
whisper-tiny's D 64 MHA (6 heads): the encoder's [4, 6, 1500, 64] and the
cross-attention over 1,500 frames, non-causal, and the decoder's causal
self-attention (448 text rows as trained for the backward, the 416-row
served prompt for the forward).

For each shape it holds the bf16 result against the plain version (the
forward against ``ref.flash_attention_ref``, the gradients against
autograd of it: share of the bf16 tolerance; reruns bitwise), prints a
digest of the output bits (equal digests in two processes: bitwise equal
results), then CUDA-event medians (L2 flushed, as ``chip_smoke.py``
times) beside its bound and SDPA's with PyTorch's default and
deterministic settings, and the device time of each of its kernels from a
``torch.profiler`` trace of ten calls (L2 warm). One JSON object a line.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
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


def _case(arch, cfg, sq, skv, causal):
    return dict(arch=arch, b=cs.B, hq=cfg.n_heads, hkv=cfg.n_kv_heads,
                d=cfg.resolved_head_dim, sq=sq, skv=skv, causal=causal)


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
    }


# the earlier interface: no lse argument, scratch of 2 [B, Hq, Sq] arrays
_OLD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 33
                 + [ctypes.c_float, ctypes.c_void_p])


def backward_fn(reads_lse):
    """The backward as (q, k, v, o, do, lse, causal) -> (dq, dk, dv): the
    tree's wrapper for a source that reads lse, else a call of the earlier
    C interface with the earlier scratch."""
    if reads_lse:
        return lambda q, k, v, o, do, lse, causal: fa.flash_attention_bwd(
            q, k, v, o, do, lse, causal=causal)
    fn = build.load_function("flash_attention_bwd", "flash_attention_bwd",
                             _OLD_ARGTYPES)

    def old(q, k, v, o, do, lse, causal):
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
                 int(causal), 0, d ** -0.5,
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
    causal = c["causal"]

    def run():
        return fa.flash_attention(q, k, v, causal=causal)
    got = run()
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    lse_err = float((lse - ref.flash_attention_lse_ref(
        q, k, causal=causal)).abs().max())
    row = {"time": "flash_attention", **c, "source": source,
           "share_of_tolerance": share(got, ref.flash_attention_ref(
               q, k, v, causal=causal)),
           "lse_max_abs_err": lse_err,
           "o_equal_with_lse": torch.equal(o, got),
           "reruns_bitwise": torch.equal(got, run()),
           "digest": digest([got]), "lse_digest": digest([lse]),
           "ms": cs.time_ms(run, flush),
           "library_ms": cs._sdpa_ms(q, k, v, flush, False, causal),
           "library_deterministic_ms": cs._sdpa_ms(q, k, v, flush, True,
                                                   causal),
           **cs.bound(cs.cost.attention(c["b"], c["hq"], c["hkv"], c["sq"],
                                        c["skv"], c["d"], BF, causal)),
           "kernels_ms": cs.kernel_split(run), "card": card}
    cs.emit(row)


def check_backward(c, gen, flush, card, source, bwd, reads_lse):
    q, do = (cs._bshd(gen, c["b"], c["sq"], c["hq"], c["d"], BF)
             for _ in range(2))
    k, v = (cs._bshd(gen, c["b"], c["skv"], c["hkv"], c["d"], BF)
            for _ in range(2))
    causal = c["causal"]
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)

    def run():
        return bwd(q, k, v, o, do, lse, causal)
    got = run()
    want = ref.flash_attention_bwd_ref(q, k, v, do, causal=causal)
    shares = [share(g, w) for g, w in zip(got, want)]
    bitwise = all(torch.equal(a, b) for a, b in zip(got, run()))
    del want
    lib, _ = cs._sdpa_bwd_ms(q, k, v, do, flush, False, causal)
    lib_det, _ = cs._sdpa_bwd_ms(q, k, v, do, flush, True, causal)
    cs.emit({"time": "flash_attention_bwd", **c, "source": source,
             "reads_lse": reads_lse,
             "ms": cs.time_ms(run, flush),
             "library_ms": lib, "library_deterministic_ms": lib_det,
             **cs.bound(cs.cost.attention_bwd(c["b"], c["hq"], c["hkv"],
                                              c["sq"], c["skv"], c["d"], BF,
                                              causal)),
             "share_of_tolerance": {"dq": shares[0], "dk": shares[1],
                                    "dv": shares[2]},
             "reruns_bitwise": bitwise, "digest": digest(got),
             "kernels_ms": cs.kernel_split(run), "card": card})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--forward", action="store_true",
                    help="check and time the forward kernel")
    ap.add_argument("--shapes", default="train",
                    help="comma-separated sets: train, wide, whisper")
    ap.add_argument("--csrc", help="directory holding another version of "
                    "the kernel's source")
    args = ap.parse_args()
    sets = shape_sets(args.forward)
    cases = [c for name in args.shapes.split(",") for c in sets[name]]
    if not torch.cuda.is_available():
        print("k2_bwd_check: needs an NVIDIA GPU", file=sys.stderr)
        return 1
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
