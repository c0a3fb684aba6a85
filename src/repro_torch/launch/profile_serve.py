"""Where the serving path's time goes on the card: a ``torch.profiler``
trace of one prefill and of a few decode steps of a full-width model
(qwen3-8b by default, or ``--arch zamba2-7b`` and the others the port
serves; ``--layers N`` cuts the depth, as ``chip_smoke.py`` serves
mixtral-8x7b at 16 layers; ``--prompt-len`` sets the prompt, as
``chip_smoke.py`` serves whisper-tiny with 416 tokens; one slice, bf16,
random weights from a seed, the zero frames or image embeddings of the
server's prefill batch).

    python -m repro_torch.launch.profile_serve [--arch zamba2-7b]
    python -m repro_torch.launch.profile_serve --arch mixtral-8x7b \
        --layers 16
    python -m repro_torch.launch.profile_serve --arch whisper-tiny \
        --prompt-len 416
    python -m repro_torch.launch.profile_serve --arch xlstm-350m

It runs with ``chip_smoke.py``'s settings: deterministic algorithms on,
without the fill of uninitialised memory, and no TF32.

Prints one JSON line per window: wall time, device busy time (the sum of
kernel times; one stream, so kernels do not overlap), the device's idle
share, the kernel time grouped by kind, the top kernels by device
time, and the host's calls that wait for the device (synchronisations
and copies). Needs CUDA.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch
from repro_torch.launch.serve import ReplicatedServer

# the serve cell of chip_smoke.py
BATCH, PROMPT_LEN, DECODE_STEPS = 4, 512, 5
# kernel-name fragments -> group (first match wins)
GROUPS = (("rmsnorm", "rmsnorm kernel"), ("flash_fwd", "attention kernel"),
          ("mamba_ssd_scan", "mamba scan kernel"), ("gemm", "matmul"),
          ("gemv", "matmul"), ("nvjet", "matmul"), ("cutlass", "matmul"),
          ("xmma", "matmul"), ("sort", "sort, search (MoE dispatch)"),
          ("radix", "sort, search (MoE dispatch)"),
          ("index", "index, gather, scatter"),
          ("gather", "index, gather, scatter"),
          ("scatter", "index, gather, scatter"))
# CUDA runtime calls in which the host waits for the device
WAITS = ("Synchronize", "cudaMemcpy")


def _group(name: str) -> str:
    low = name.lower()
    for frag, group in GROUPS:
        if frag in low:
            return group
    return "other (elementwise, copies, reductions)"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, attr, None)
        if val is not None:
            return float(val)
    return 0.0


def trace(label: str, fn, card: str) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # repro: allow[wallclock] -- genuine wall measurement
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        # repro: allow[wallclock] -- genuine wall measurement
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    groups = defaultdict(float)
    for e in kernels:
        groups[_group(e.key)] += _device_us(e) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:8]
    waits = {e.key: e.count for e in prof.key_averages()
             if e.device_type != DeviceType.CUDA
             and any(w in e.key for w in WAITS)}
    return {"trace": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "kernel_launches": sum(e.count for e in kernels),
            "groups_ms": dict(groups), "host_waits": waits,
            "top": [{"name": e.key[:90], "count": e.count,
                     "ms": _device_us(e) / 1e3} for e in top],
            "card": card}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: full)")
    ap.add_argument("--prompt-len", type=int, default=PROMPT_LEN)
    args = ap.parse_args(argv)
    # cuBLAS reproducibility needs this before the first CUDA call
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    # the switch would also fill every new tensor (one launch each)
    torch.utils.deterministic.fill_uninitialized_memory = False
    cfg = get_arch(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    srv = ReplicatedServer(cfg, batch=BATCH,
                           prompt_len=args.prompt_len, device="cuda")
    prompts = np.random.default_rng(0).integers(
        0, srv.cfg.vocab_size, (BATCH, args.prompt_len), dtype=np.int32)
    wl = srv.workload(prompts)
    state = wl.init_state()                      # warm-up
    state, _ = wl.step(state, 0)
    head = {"arch": args.arch, "n_layers": cfg.n_layers,
            "prompt_len": args.prompt_len}
    print(json.dumps({**head, **trace("prefill", wl.init_state, card)}),
          flush=True)

    def decode():
        nonlocal state
        for t in range(DECODE_STEPS):
            state, _ = wl.step(state, 1 + t)

    out = trace(f"decode x{DECODE_STEPS}", decode, card)
    print(json.dumps({**head, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
