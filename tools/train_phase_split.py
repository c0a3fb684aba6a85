#!/usr/bin/env python3
"""Split ``chip_smoke.py``'s qwen3-8b train phase into where its wall time
goes, on the card.

    python3 tools/train_phase_split.py

Builds the kernels (``phase_device_and_build``), then runs ``phase_train``
three times: with the clean run's final state held as one host copy, held
on the card (``chip_smoke._keep_clean``, what the script does), and on the
host again, so the two ways of holding it are compared within one call.
Each run wraps the disk checkpointer's ``save`` and ``restore``, the
pruning of old checkpoints and ``shutil.rmtree`` (which the pruning
calls, so its deletes are counted in both) to sum their wall seconds, and
prints one ``{"split": ...}`` line beside the phase's own ``train`` lines
(whose ``hold_s`` is the time the bitwise checks' copies took). Needs one
card and ~45 GiB of free disk under ``build/train_ckpt``.
"""
from __future__ import annotations

import collections
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.checkpoint import io as ckio  # noqa: E402


def _host_copy(final, state_bytes):
    return [(k, t.cpu()) for k, t in final]


def main() -> int:
    if not torch.cuda.is_available():
        print("train_phase_split: no CUDA device", file=sys.stderr)
        return 1
    # chip_smoke.main()'s switches
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    acc = collections.defaultdict(float)

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                acc[name] += time.perf_counter() - t0
        return wrapper

    ckio.Checkpointer.save = timed("save", ckio.Checkpointer.save)
    ckio.Checkpointer.restore = timed("restore", ckio.Checkpointer.restore)
    cs._prune_to_latest = timed("prune", cs._prune_to_latest)
    cs.shutil.rmtree = timed("rmtree", cs.shutil.rmtree)
    state = {}
    cs.phase_device_and_build(state)
    on_card = cs._keep_clean
    for label, keep in (("host", _host_copy), ("card", on_card),
                        ("host", _host_copy)):
        cs._keep_clean = keep
        acc.clear()
        t0 = time.perf_counter()
        cs.phase_train(state)
        cs.emit({"split": label, "phase_train_s": time.perf_counter() - t0,
                 **acc, "card": state["card"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
