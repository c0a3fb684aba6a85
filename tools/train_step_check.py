#!/usr/bin/env python3
"""Time the hybrid's train step on the card with one version of K3's
backward.

    python3 tools/train_step_check.py [--csrc DIR | --plain [float64]]
        [--steps N]

Trains zamba2-7b at ``chip_smoke.py``'s train size (full width, 13
blocks, bf16, batch 4 x 512, seed 0, lr 1e-3) for N clean steps (no
replica, no kill; 40 by default: single 12-step runs spread by ~20 ms, as
much as K3's whole share of a step) through ``launch.train``'s trainer,
each step timed on the host with the card synchronised, as
``chip_smoke.py``'s train phase times it, under the same determinism
settings. ``--csrc DIR`` builds ``mamba_scan_bwd.cu`` from ``DIR`` instead
of the tree (another version of the source, such as the parent commit's,
unpacked with the header it includes under a directory that
``.gitignore`` lists); every other kernel is the tree's. Two versions go
in two processes: run parent, change, change, parent in one call.
``--plain`` takes K3's backward from autograd of the plain version
instead of a kernel (its f32 recurrence, or with ``float64`` the same
recurrence in float64; slow: a loss witness, not a timing). Prints one JSON
line: the source, the step times (median, each), every step's loss, K3's
backward launches and the card.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.base import FTConfig  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_chunk_scan_bwd  # noqa: E402

STEPS = 40


def plain_scan_bwd(arith):
    """K3's backward from autograd of the plain version (the same function
    at any chunk), its recurrence in ``arith``; each gradient comes back
    in its input's dtype."""
    def bwd(x, b, c, dt, da, dy, dh=None, *, chunk):
        del chunk
        kept, ref.F32 = ref.F32, arith
        try:
            return ref.mamba_chunk_scan_bwd_ref(x, b, c, dt, da, dy, dh)
        finally:
            ref.F32 = kept
    return bwd


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--csrc", help="directory holding another "
                       "mamba_scan_bwd.cu")
    which.add_argument("--plain", nargs="?", const="float32",
                       choices=("float32", "float64"),
                       help="K3's backward by autograd of the plain version "
                       "(its recurrence in float32, or float64)")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_step_check: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    source = "src/repro_torch/kernels/csrc"
    if args.csrc:
        build.use_source("mamba_scan_bwd", args.csrc)
        source = args.csrc
    if args.plain:
        # the plain version's autograd may lack deterministic kernels
        torch.use_deterministic_algorithms(True, warn_only=True)
        ms.mamba_chunk_scan_bwd = plain_scan_bwd(   # autograd.py's callee
            getattr(torch, args.plain))
        source = f"plain {args.plain}"
    build.build_all()
    cfg = cs.train_config_zamba()
    tr = cs.train_lib.build_trainer(
        cfg, batch=cs.B, seq=cs.S, seed=cs.TRAIN_SEED, lr=cs.TRAIN_LR,
        device="cuda", ft=FTConfig(mode="none"), ckpt_dir=None,
        kill_schedule={})
    times, _ = cs._timed_steps(tr.workload)
    mamba_chunk_scan_bwd.launches = 0
    rep = tr.run(args.steps)
    torch.cuda.synchronize()
    step_ms = [1e3 * t for t in times]
    cs.emit({"train_step": cfg.name, "n_layers": cfg.n_layers,
             "source": source, "steps": len(step_ms),
             "step_ms_median": statistics.median(step_ms),
             "step_ms": step_ms,
             "losses": [float(v) for v in rep.losses],
             "mamba_scan_bwd_launches": mamba_chunk_scan_bwd.launches,
             "card": cs.card()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
