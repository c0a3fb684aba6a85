#!/usr/bin/env python3
"""How far xlstm-350m's gradient can be taken at full width: the reference's
sLSTM is chaotic there (its ``r_gates`` are drawn with std H^-1/2 = 0.5
over dh = 256 terms), so the gradient through the scan grows with the
sequence until it overflows f32.

    python3 tools/xlstm_grad_check.py [--device cpu] [--seqs 32,64,512]

For each sequence length: one loss and gradient of the full model (bf16,
seed 0, batch 4, the reference's token stream) through
``launch.step_fns.make_train_step``'s loss, the largest |grad| of the
sLSTM's ``r_gates`` and of all leaves, and whether every leaf is finite;
then AdamW's second moment of that gradient (g^2 in f32) is checked for
overflow. Then the clean run that ``chip_smoke.py`` trains (12 steps at
``--train-seq``) and its losses. One JSON line each, with the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import FTConfig  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402

F32_MAX = float(torch.finfo(torch.float32).max)


def card(device) -> str:
    if device.type != "cuda":
        return "cpu (no device metric)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def gradient(cfg, seq, device):
    wl = train.build_workload(cfg, batch=4, seq=seq, device=device)
    params = wl.init_state()["params"]
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss = xlstm.loss_fn(cfg, leaves, wl.batch_fn(0), min(seq, 512))
    grads = dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()))))
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    top = max(float(g.float().abs().nan_to_num(0, F32_MAX, F32_MAX).max())
              for g in grads.values())
    r_top = max(float(g.float().abs().nan_to_num(0, F32_MAX, F32_MAX).max())
                for k, g in grads.items() if k.endswith("r_gates"))
    return {"loss": float(loss.detach()), "grads_finite": finite,
            "max_abs_grad": top, "max_abs_grad_r_gates": r_top,
            "adam_v_overflows": top * top > F32_MAX}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seqs", default="32,64,96,128,256,512")
    ap.add_argument("--train-seq", type=int, default=64)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.use_deterministic_algorithms(True)
    cfg = get_arch("xlstm-350m")
    name = card(dev)
    for seq in (int(s) for s in args.seqs.split(",")):
        t0 = time.perf_counter()
        row = gradient(cfg, seq, dev)
        print(json.dumps({"xlstm_grad": seq, "batch": 4, **row,
                          "seconds": time.perf_counter() - t0,
                          "card": name}), flush=True)
    tr = train.build_trainer(cfg, batch=4, seq=args.train_seq, device=dev,
                             ft=FTConfig(mode="none"), kill_schedule={})
    rep = tr.run(12)
    print(json.dumps({"xlstm_train": args.train_seq, "batch": 4,
                      "losses": rep.losses,
                      "finite": bool(np.isfinite(rep.losses).all()),
                      "card": name}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
