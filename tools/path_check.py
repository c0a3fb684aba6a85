#!/usr/bin/env python3
"""Time the port's serving path on the card: prefill and decode, per model.

    python3 tools/path_check.py [--root DIR] [--arch NAME ...]

Builds qwen3-8b and zamba2-7b at full size in bf16 (random weights from a
seed, as ``chip_smoke.py`` serves them: batch 4, 512-token prompt), one
after the other, and times the workload's prefill (``init_state``: prefill
and the first greedy token) and one decode step of one slice, each the
median of host-clock runs that end in ``torch.cuda.synchronize()`` - the
time a caller sees. ``--root`` runs the package of another checkout (for
example the parent commit, unpacked with ``git archive`` under a directory
that ``.gitignore`` lists), so that two versions are compared on one card
in one call: run them in turns (parent, change, change, parent), one
process each. One JSON object a line.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def _median_ms(fn, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def path_times(arch, root, card):
    srv = ReplicatedServer(arch, reduced=False, batch=4, prompt_len=512,
                           device="cuda")
    prompts = np.random.default_rng(0).integers(
        0, srv.model.cfg.vocab_size, (4, 512), dtype=np.int32)
    wl = srv.workload(prompts)
    for _ in range(3):                              # warm-up, builds
        wl.init_state()
    prefill = _median_ms(wl.init_state, 20)
    st = [wl.init_state()]

    def step():
        st[0], _ = wl.step(st[0], 0)
    for _ in range(3):
        step()
    decode = _median_ms(step, 20)
    print(json.dumps({"time": "serve_path", "arch": arch, "root": root,
                      "prefill_ms": prefill, "decode_ms_per_step": decode,
                      "card": card}), flush=True)
    del srv, wl, st
    gc.collect()
    torch.cuda.empty_cache()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose src/repro_torch to run")
    ap.add_argument("--arch", nargs="+", default=["qwen3-8b", "zamba2-7b"])
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import numpy as np
    import torch

    from repro_torch.launch.serve import ReplicatedServer

    if not torch.cuda.is_available():
        print("path_check: needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    for name in args.arch:
        path_times(name, os.path.relpath(args.root, ROOT), _card())
