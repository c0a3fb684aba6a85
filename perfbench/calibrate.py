"""The readings that a cell's check limits (``limits/<cell>.json``) are
set from, on the GPU, at the cell's own size, in one process:

    python3 perfbench/calibrate.py --workload <cell> --seeds 11 12 ... \
        --seconds <run_seconds> [--controls 3] [--out build/calibrate.jsonl]

Each seed is a whole run (``bench.run``: the warm-up under the cell's FT
mode with its promotion, the window with its promotion and its compared
last step), and its numbers against the plain f32 reference are the lower
readings. On the first ``--controls`` seeds the same numbers are read of
the control, the reference computed with fp8 products
(``reference/common``, ``FP8``) in the program's place, and of each fault
that the cell can have, planted in the reference in the program's place
(``unchanged``, ``grad_altered``, ``no_decay``, ``betas_swapped``; with
two rows or more, ``half_batch``), each against the clean reference: the
upper readings. One JSON line per reading.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "calibrate.jsonl"))
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    for p in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(p))
    import torch

    from perfbench import bench
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 3
    bench.settings()
    cell = bench.load_cell(args.workload)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    kinds = ["control_fp8", "unchanged", "grad_altered", "no_decay",
             "betas_swapped"]
    if cell.traffic["batch"] >= 2:
        kinds.append("half_batch")

    def emit(line):
        line = {"cell": cell.name, **line}
        print(json.dumps(line), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        out = bench.run(cell, seed, args.seconds, False, t_start=time.time(),
                        device="cuda",
                        kinds=kinds if i < args.controls else ())
        win = out["win"]
        for kind, numbers in out["readings"].items():
            emit({"seed": seed, "kind": kind, **numbers})
        emit({"seed": seed, "kind": "run", "correct":
              out["result"]["correct"], "steps": win.steps,
              "kill_step": win.kill_step, "compared_step": win.compared.t,
              "pause_ms": win.compared.pause_ms,
              "tokens_per_s": win.tokens / win.window_s,
              "losses": out["prog"]["losses"] + [win.compared.loss],
              "ref_losses": out["ref_losses"],
              "reference_s": out["reference_s"],
              "s": time.perf_counter() - t0})
        del out, win
        bench.free("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
