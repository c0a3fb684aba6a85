"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
Prints, as its last line, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones and a ``breakdown``), ``device`` and,
last, ``checks``: each number the output check compared, with its limit.
Standard error ends with the same numbers, a line each. Without CUDA,
with fewer devices than the cell asks for, without the program (``src/``)
or with a JAX module loaded, it exits non-zero and prints no result.
"""
from __future__ import annotations

import time

WALL0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """The process's start as a wall time (Linux), else this module's."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        hz = os.sysconf("SC_CLK_TCK")
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return min(WALL0, btime + ticks / hz)
    except (OSError, ValueError, IndexError, StopIteration):
        return WALL0


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    # before CUDA starts: cuBLAS's reproducible workspace, caches inside
    # the checkout
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    from perfbench import bench
    cell = bench.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    bench.settings()
    out = bench.run(cell, args.seed, args.seconds, bool(args.trace),
                    t_start=t_start, device="cuda")
    bad = bench.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 4
    result, win = out["result"], out["win"]
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": cell.chips,
                        "memory_peak_bytes": win.peak_bytes,
                        "power_limit": power_limit()}
    if args.trace and hasattr(win, "profile"):
        result["device"]["busy_s"] = win.profile.busy_s
        result["device"]["window_s"] = win.profile.window_s
    result["checks"] = out["checks"]
    info = {"numbers": out["numbers"],
            "steps": win.steps, "kill_step": win.kill_step,
            "window_s": win.window_s, "reference_s": out["reference_s"],
            "compared_step": win.compared.t,
            "compared_pause_ms": win.compared.pause_ms,
            "compared_worst_units": getattr(win.compared, "worst_units",
                                            None),
            "losses_compared": out["prog"]["losses"]
            + [win.compared.loss],
            "losses_reference": out["ref_losses"]}
    if args.trace and hasattr(win, "profile"):
        info["tallies"] = {k: {str(a): c for a, c in v.items()}
                           for k, v in win.profile.tallies.items()}
        info["launches_seen_expected"] = win.launches
        ends = {}
        for t, role, s0, s1 in win.spans:
            lo, hi = ends.get(t, (s0, s1))
            ends[t] = (min(lo, s0), max(hi, s1))
        info["session_step_ms"] = [round(hi - lo, 3) for _, (lo, hi)
                                   in sorted(ends.items())]
    print(json.dumps({"info": info}), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
