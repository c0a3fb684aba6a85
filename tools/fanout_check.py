#!/usr/bin/env python3
"""Time ``BatchFanout.fan_out`` on the card, with and without private copies.

    python3 tools/fanout_check.py [--pairs 10] [--calls 25]

The transport gives every delivery of a tensor a clone of its own
(``comm.payload.own_tensors``); a fan-out of the [4, 512] int32 prompt
batch to a replicated serving rank so makes three 8 KB device copies (the
log's, the computational worker's, the replica's) where one shared clone
would make one.  This times one ``fan_out`` of a device batch, host clock
to the device's end as ``chip_smoke.py`` does, in ``--pairs`` alternating
pairs of blocks of ``--calls`` calls: ``own`` (the shipped transport) and
``shared`` (``own_tensors`` replaced by the identity, so the log and both
deliveries share the send's clone), and the host time of one bare 8 KB
device clone.  One JSON object a line; needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.comm import recovery, transport  # noqa: E402
from repro_torch.configs.base import FTConfig  # noqa: E402
from repro_torch.launch.serve import BatchFanout  # noqa: E402


def block_ms(fn, calls):
    """Median host ms of ``calls`` calls of ``fn``, each synced."""
    out = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--calls", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU with CUDA", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    batch = torch.from_numpy(np.random.default_rng(0).integers(
        0, 400, (4, 512), dtype=np.int32)).cuda()
    own = transport.own_tensors

    def variant(shared):
        fn = (lambda p: p) if shared else own
        transport.own_tensors = recovery.own_tensors = fn
        fan = BatchFanout(True, FTConfig(mode="none", topology="fattree"))
        return lambda: fan.fan_out(batch)

    times = {"own": [], "shared": []}
    for i in range(args.pairs):
        order = ("own", "shared") if i % 2 == 0 else ("shared", "own")
        for name in order:
            call = variant(name == "shared")
            call()                                   # warm-up
            times[name].append(block_ms(call, args.calls))
    transport.own_tensors = recovery.own_tensors = own
    clone_ms = block_ms(lambda: batch.clone(), args.calls * args.pairs)
    wins = sum(a < b for a, b in zip(times["own"], times["shared"]))
    print(json.dumps({
        "fanout_host_ms": {k: statistics.median(v) for k, v in times.items()},
        "blocks": times, "own_faster_pairs": wins, "pairs": args.pairs,
        "calls_per_block": args.calls, "clone_8kb_host_ms": clone_ms,
        "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
