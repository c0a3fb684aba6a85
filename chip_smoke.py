#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (each a function; any failure exits non-zero):
  1. device and build: the card's name and power limit, then nvcc builds
     every kernel in ``src/repro_torch/kernels/csrc`` (one process per
     source, all at once);
  2. RMSNorm kernel against its plain PyTorch version on the card;
  3. flash-attention kernel against its plain PyTorch version on the card;
  4. serve: qwen3-8b at full width and depth in bf16 (random weights from a
     seed) under replication — a clean run, a run whose computational slice
     is killed mid-stream (the token streams must be bitwise equal, one
     promotion), and an unreplicated kill that must raise; the kernels'
     launch counters must show the path went through them;
  5. times: CUDA-event medians of each kernel, its plain version and the
     PyTorch library call at the serve phase's shapes, and the whole path's
     prefill and decode times.

Prints JSON lines as it goes, then ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {...}}``. Exits non-zero without CUDA, and when run
outside the repository (the port's package must be beside it in ``src``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# cuBLAS reproducibility needs this before the first CUDA call
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402
from repro_torch.launch.serve import ReplicatedServer  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
# |kernel - plain| <= atol + rtol * |plain| (tests/test_kernels.py's
# tolerances): f32 differs only by summation order; bf16 by at most one
# rounding of the f32 result
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (3e-2, 2e-2)}

B, S, GEN, KILL_AT = 4, 512, 32, 8
SPIN_CYCLES = 2_000_000            # ~1 ms at the H100's clock
QWEN = get_arch("qwen3-8b")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def compare(name, got, want, dtype, **shape):
    atol, rtol = TOL[dtype]
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    ok = bool((err <= bound).all())
    max_err = float(err.max())
    emit({"check": name, "dtype": str(dtype).replace("torch.", ""),
          **shape, "max_abs_err": max_err, "atol": atol, "rtol": rtol,
          "ok": ok})
    if not ok:
        raise AssertionError(f"{name} {shape}: kernel disagrees with its "
                             f"plain version (max |err| {max_err})")
    return max_err


# ---------------------------------------------------------------- phase 1

def phase_device_and_build(state):
    state["card"] = card()
    print(state["card"], flush=True)
    t0 = time.perf_counter()
    libs = build.build_all()
    emit({"phase": "build", "kernels": sorted(libs),
          "seconds": time.perf_counter() - t0})
    for name in libs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                emit({"ptxas": name, "line": line.strip()})


# ---------------------------------------------------------------- phase 2

def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def phase_rmsnorm(state):
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    d, dh, hq, hkv = (QWEN.d_model, QWEN.resolved_head_dim, QWEN.n_heads,
                      QWEN.n_kv_heads)
    cases = [(B * S, d), (B * S * hq, dh), (B * S * hq + 5, dh),
             (1000 + 3, d)]
    for dtype in (torch.bfloat16, torch.float32):
        for rows, d in cases:
            x = _rand(gen, (rows, d), dtype)
            w = _rand(gen, (d,), dtype)
            worst = max(worst, compare(
                "rmsnorm", rmsnorm(x, w, eps=1e-5), ref.rmsnorm_ref(x, w),
                dtype, rows=rows, d=d))
        # qk-norm heads sliced out of a fused [B, S, Hq + 2 Hkv, D] tensor:
        # a two-level strided row view, read without a copy
        fused = _rand(gen, (B, S, hq + 2 * hkv, dh), dtype)
        qv = fused[:, :, :hq]
        w = _rand(gen, (dh,), dtype)
        worst = max(worst, compare(
            "rmsnorm_strided_view", rmsnorm(qv, w), ref.rmsnorm_ref(qv, w),
            dtype, shape=list(qv.shape)))
    state["rmsnorm_err"] = worst


# ---------------------------------------------------------------- phase 3

def _bshd(gen, b, s, h, d, dtype):
    """A [B, H, S, D] view of [B, S, H, D] storage (the model's layout)."""
    return _rand(gen, (b, s, h, d), dtype).transpose(1, 2)


def phase_attention(state):
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [
        dict(b=B, hq=QWEN.n_heads, hkv=QWEN.n_kv_heads, s=S,
             d=QWEN.resolved_head_dim, causal=True, window=0,
             dtype=torch.bfloat16),                      # qwen3-8b prefill
        dict(b=B, hq=QWEN.n_heads, hkv=QWEN.n_kv_heads, s=S,
             d=QWEN.resolved_head_dim, causal=True, window=0,
             dtype=torch.float32),
        dict(b=2, hq=2, hkv=1, s=192, d=128, causal=True, window=0,
             dtype=torch.bfloat16),                      # ragged tail
        dict(b=1, hq=4, hkv=2, s=256, d=64, causal=True, window=128,
             dtype=torch.float32),                       # sliding window
        dict(b=1, hq=2, hkv=2, s=128, d=64, causal=False, window=0,
             dtype=torch.float32),                       # non-causal
        dict(b=1, hq=8, hkv=2, s=128, d=32, causal=True, window=0,
             dtype=torch.bfloat16),                      # D = 32, GQA 4x
        dict(b=2, hq=4, hkv=2, s=256, d=64, causal=True, window=0,
             dtype=torch.bfloat16),                      # D = 64, GQA 2x
    ]
    worst = 0.0
    for c in cases:
        q = _bshd(gen, c["b"], c["s"], c["hq"], c["d"], c["dtype"])
        k = _bshd(gen, c["b"], c["s"], c["hkv"], c["d"], c["dtype"])
        v = _bshd(gen, c["b"], c["s"], c["hkv"], c["d"], c["dtype"])
        got = flash_attention(q, k, v, causal=c["causal"], window=c["window"])
        want = ref.flash_attention_ref(q, k, v, causal=c["causal"],
                                       window=c["window"])
        shape = {k_: v_ for k_, v_ in c.items() if k_ != "dtype"}
        worst = max(worst, compare("flash_attention", got, want, c["dtype"],
                                   **shape))
        # fixed launch configuration, no atomics: reruns are bitwise equal
        again = flash_attention(q, k, v, causal=c["causal"],
                                window=c["window"])
        if not torch.equal(got, again):
            raise AssertionError(f"flash attention rerun differs: {shape}")
    state["attention_err"] = worst


# ------------------------------------------------------- reference check

def phase_reference(state):
    """The kernel path against the plain path on a small input: the
    reduced qwen3-8b in f32 with the same weights on the card (through
    the kernels) and on the CPU (through the plain versions, which the
    CPU tests hold against the JAX package). Prefill and 8 greedy decode
    steps; logits within 1e-3 (summation order only), tokens equal."""
    cfg = dataclasses.replace(get_arch("qwen3-8b").reduced(), dtype="float32")
    cpu = Transformer(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = Transformer(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 96), dtype=np.int32))
    lc, cc = cpu.prefill({"tokens": toks})
    lg, cg = gpu.prefill({"tokens": toks.cuda()})
    worst = float((lg.cpu() - lc).abs().max())
    pos = torch.full((2, 1), 96, dtype=torch.int32)
    for _ in range(8):
        tok = torch.argmax(lc[:, -1], -1)[:, None].to(torch.int32)
        if not torch.equal(tok, torch.argmax(lg[:, -1], -1)[:, None]
                           .to(torch.int32).cpu()):
            raise AssertionError("kernel path picked another token")
        lc, cc = cpu.decode_step(cc, tok, pos)
        lg, cg = gpu.decode_step(cg, tok.cuda(), pos.cuda())
        worst = max(worst, float((lg.cpu() - lc).abs().max()))
        pos = pos + 1
    emit({"check": "reduced_model_card_vs_cpu", "max_abs_err": worst,
          "atol": 1e-3, "ok": worst <= 1e-3})
    if worst > 1e-3:
        raise AssertionError(f"card and CPU logits differ by {worst}")


# ----------------------------------------------------------- phase 4: serve

def phase_serve(state):
    cfg = QWEN
    t0 = time.perf_counter()
    srv = ReplicatedServer("qwen3-8b", reduced=False, batch=B, prompt_len=S,
                           device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "serve.build", "arch": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "params": api.param_count(cfg), "dtype": cfg.dtype,
          "seconds": time.perf_counter() - t0})
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)

    rmsnorm.launches = flash_attention.launches = 0
    t0 = time.perf_counter()
    clean = srv.generate(prompts, GEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    clean_cache = srv.last_report.final_state["cache"]
    faulty = srv.generate(prompts, GEN, kill_at=KILL_AT)
    # the FT theorem on the whole state, not only the tokens: after the
    # promotion the final KV cache equals the clean run's bit for bit
    faulty_cache = srv.last_report.final_state["cache"]
    cache_equal = all(torch.equal(a[key], b[key])
                      for a, b in zip(clean_cache, faulty_cache)
                      for key in ("k", "v", "pos"))
    del clean_cache, faulty_cache
    unreplicated = ReplicatedServer("qwen3-8b", reduced=False, batch=B,
                                    prompt_len=S, replication=False,
                                    device="cuda")
    try:
        unreplicated.generate(prompts, GEN, kill_at=KILL_AT)
    except RuntimeError as e:
        fatal = str(e)
    else:
        raise AssertionError("an unreplicated kill did not raise")
    torch.cuda.synchronize()
    counts = {"rmsnorm": rmsnorm.launches,
              "flash_attention": flash_attention.launches}
    del unreplicated

    if clean.shape != (B, GEN) or clean.min() < 0 or \
            clean.max() >= cfg.vocab_size:
        raise AssertionError(f"bad token stream {clean.shape}")
    if not np.array_equal(clean, faulty) or not cache_equal:
        raise AssertionError("token stream or cache after failover differs")
    if srv.promotions != 1 or srv.failures != 1:
        raise AssertionError(f"promotions={srv.promotions} "
                             f"failures={srv.failures}")
    # forwards: 3 prefills (clean, killed, unreplicated); decodes: clean
    # 2 x 32 (replica re-executes), killed 2 x 8 + 24, unreplicated 8
    prefills = 3
    decodes = 2 * GEN + (2 * KILL_AT + GEN - KILL_AT) + KILL_AT
    per_fwd = 4 * cfg.n_layers + 1
    want = {"rmsnorm": per_fwd * (prefills + decodes),
            "flash_attention": cfg.n_layers * prefills}
    emit({"phase": "serve", "tokens_equal": True, "cache_equal": True,
          "promotions": srv.promotions, "failures": srv.failures,
          "unreplicated_kill": fatal, "launches": counts,
          "launches_expected": want, "first_tokens": clean[:, :8].tolist(),
          "clean_generate_s": wall,
          "clean_generate_tok_per_s": clean.size / wall,
          "card": state["card"]})
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    state["launches"] = counts
    state["server"] = srv
    state["prompts"] = prompts


# ----------------------------------------------------------- phase 5: times

class _L2Flush:
    """Writes 128 MB between timed runs so no run finds its inputs in the
    50 MB L2 left there by the previous one."""

    def __init__(self):
        self.buf = torch.empty(32 * 2 ** 20, dtype=torch.float32,
                               device="cuda")

    def __call__(self):
        self.buf.zero_()


def time_ms(fn, flush, reps=25, warmup=3):
    """Median CUDA-event time of ``fn`` over ``reps`` runs, L2 flushed
    before each. A ~1 ms device-side spin after the flush lets the host
    enqueue ``fn`` before the start event fires, so a kernel's time is the
    device's and not the wrapper's Python overhead; a ``fn`` that takes the
    host longer than that to enqueue (the whole prefill) is timed with its
    host time, as a caller sees it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes, n_ops):
    """Least time (ms) for work that moves ``n_bytes`` once and does
    ``n_ops`` bf16 operations, and which of the two sets it."""
    by_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * n_ops / BF16_FLOPS
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _rmsnorm_times(card_name, flush, calls, eps):
    """Kernel / plain / library times and bound of each call
    [(name, x, w)], and their sums."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for name, x, w in calls:
        row = {
            "ms": time_ms(lambda: rmsnorm(x, w, eps=eps), flush),
            "plain_ms": time_ms(lambda: ref.rmsnorm_ref(x, w, eps=eps),
                                flush),
            "library_ms": time_ms(
                lambda: F.rms_norm(x, (x.shape[-1],), w, eps), flush),
            # x and w read once, y written once; ~4 operations an element
            **bound((2 * x.numel() + w.numel()) * x.element_size(),
                    4 * x.numel()),
        }
        emit({"time": "rmsnorm", "call": name, "shape": list(x.shape),
              **row, "card": card_name})
        for key in tot:
            tot[key] += row[key]
    tot["bound_by"] = "bytes"
    return tot


def phase_times(state):
    card_name = state["card"]
    flush = _L2Flush()
    cfg = QWEN
    srv = state["server"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf = torch.bfloat16
    d, hq, hkv, dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim)
    lp = srv.model.layers[0]
    k1 = _rmsnorm_times(card_name, flush, [
        ("ln1", _rand(gen, (B, S, d), bf), lp["ln1"]["scale"]),
        ("ln2", _rand(gen, (B, S, d), bf), lp["ln2"]["scale"]),
        ("q_norm", _rand(gen, (B, S, hq, dh), bf),
         lp["attn"]["q_norm"]["scale"]),
        ("k_norm", _rand(gen, (B, S, hkv, dh), bf),
         lp["attn"]["k_norm"]["scale"])], cfg.norm_eps)
    emit({"time": "rmsnorm", "call": "one prefill layer: ln1+ln2+q+k",
          **k1, "card": card_name})
    k1_decode = _rmsnorm_times(card_name, flush, [
        ("ln1_decode", _rand(gen, (B, 1, d), bf), lp["ln1"]["scale"]),
        ("q_norm_decode", _rand(gen, (B, 1, hq, dh), bf),
         lp["attn"]["q_norm"]["scale"])], cfg.norm_eps)
    emit({"time": "rmsnorm", "call": "decode: ln1+q_norm", **k1_decode,
          "card": card_name})

    q = _bshd(gen, B, S, hq, dh, bf)
    k = _bshd(gen, B, S, hkv, dh, bf)
    v = _bshd(gen, B, S, hkv, dh, bf)
    pairs = B * hq * S * (S + 1) // 2            # unmasked (q, k) pairs
    k2 = {
        "ms": time_ms(lambda: flash_attention(q, k, v, causal=True), flush),
        "plain_ms": time_ms(
            lambda: ref.flash_attention_ref(q, k, v, causal=True), flush),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), flush),
        # q, k, v read once, o written once; QK and PV: 4 D per pair
        **bound((2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
                4 * dh * pairs),
    }
    emit({"time": "flash_attention", "shape": list(q.shape), **k2,
          "card": card_name})

    # whole path: the workload's prefill, then its decode steps (one slice)
    wl = srv.workload(state["prompts"])
    prefill_ms = time_ms(wl.init_state, flush, reps=20)
    logits, _ = srv.model.prefill(wl.batch)
    if logits.shape != (B, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} are "
                             f"not finite of the expected shape")
    st = wl.init_state()
    decode = []
    for t in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _ = wl.step(st, t)
        torch.cuda.synchronize()
        decode.append(time.perf_counter() - t0)
    decode_ms = 1e3 * statistics.median(decode)
    emit({"time": "serve_path", "arch": cfg.name, "batch": B,
          "prompt_len": S, "prefill_ms": prefill_ms,
          "decode_ms_per_step": decode_ms,
          "decode_tok_per_s": B / (decode_ms * 1e-3), "card": card_name})
    state["times"] = {"rmsnorm": k1, "flash_attention": k2}


PHASES = [phase_device_and_build, phase_rmsnorm, phase_attention,
          phase_reference, phase_serve, phase_times]


def kernels_line(state):
    rows = []
    for name, replaces, err in (
            ("rmsnorm", "src/repro/kernels/rmsnorm.py:31",
             state["rmsnorm_err"]),
            ("flash_attention", "src/repro/kernels/flash_attention.py:97",
             state["attention_err"])):
        t = state["times"][name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": state["launches"][name],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    return {"kernels": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    state = {}
    for phase in PHASES:
        t0 = time.perf_counter()
        phase(state)
        emit({"phase": phase.__name__, "seconds": time.perf_counter() - t0})
    emit(kernels_line(state))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
