"""Training entry point of the port (port of ``repro/launch/train.py``): any
dense, VLM, hybrid, audio or SSM arch, any FT mode, on one device.

``build_workload`` wraps the train step as a ``TrainWorkload``;
``build_session`` pairs it with an ``FTSession``; ``build_trainer`` keeps
the legacy FTTrainer surface. The batches are the reference's token ids bit
for bit (``data.TokenSource``), with zero bf16 frames for the audio family
and zero bf16 image embeddings for the VLM, as the reference feeds them; the weights come from ``torch.Generator``
seeded by ``seed`` on the device (the reference's distribution, not its
bits), or from the reference's own init (``init_params``, numpy leaves, as
``models.convert.params_from_jax`` takes them).

Example (reduced qwen3-8b on the CPU, a promotion then a pair death; the
hybrid with ``--arch zamba2-7b``, the others with ``--arch whisper-tiny``,
``--arch xlstm-350m`` or ``--arch llama-3.2-vision-11b``):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 10 --seq 32 --batch 4 --ft-mode combined --ckpt-interval 3 \\
      --ckpt-dir /tmp/ck --kill 3:0 --kill 6:8
Without ``--device`` it runs on the card and raises where there is none.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs import RunConfig, as_config
from repro_torch.configs.base import FTConfig, ModelConfig, ShapeConfig
from repro_torch.core.ft_runtime import FTTrainer
from repro_torch.data import DataConfig, TokenSource
from repro_torch.ft import FTSession, TrainWorkload
from repro_torch.launch.step_fns import make_train_step
from repro_torch.models import api as model_api
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw


def init_params(cfg: ModelConfig, seed: int, device) -> dict:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    as a flat dict under the state-dict names, owned by the caller (no
    module keeps them)."""
    model = model_api.build_model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model.init(gen)
    params = {k: p.detach() for k, p in model.named_parameters()}
    del model
    return params


def build_workload(arch: Union[str, ModelConfig], *, reduced: bool = True,
                   batch: int = 8, seq: int = 128, seed: int = 0,
                   lr: float = 1e-3, device=None,
                   jax_params: Optional[dict] = None) -> TrainWorkload:
    """The train step over ``arch`` (a name, or a ``ModelConfig`` such as
    a depth-cut one) as a workload on ``device`` (CUDA unless told
    otherwise). ``jax_params``: start from these reference weights (numpy
    leaves) instead of the seeded draw."""
    cfg = as_config(arch, reduced)
    dev = device_lib.resolve(device)
    shape = ShapeConfig("cli", seq_len=seq, global_batch=batch, kind="train")
    run = RunConfig(model=cfg, shape=shape, remat="none",
                    seq_chunk=min(seq, 512), kv_block=min(seq, 128),
                    learning_rate=lr)
    step_fn, _ = make_train_step(run)
    data = TokenSource(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed))

    def batch_fn(step):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch_at(step).items()}
        if cfg.family == "audio":       # the stub frontend's frames
            b["frames"] = torch.zeros((batch, cfg.n_frames, cfg.d_model),
                                      dtype=torch.bfloat16, device=dev)
        if cfg.family == "vlm":         # the stub vision frontend's patches
            b["image_embeds"] = torch.zeros(
                (batch, cfg.n_image_tokens, cfg.d_model),
                dtype=torch.bfloat16, device=dev)
        return b

    def init_state():
        if jax_params is not None:
            params = dict(params_from_jax(jax_params, cfg, device=dev))
        else:
            params = init_params(cfg, seed, dev)
        return {"params": params, "opt": adamw.init(params)}

    def train_step(state, b):
        params, opt, loss = step_fn(state["params"], state["opt"], b)
        return {"params": params, "opt": opt}, loss

    return TrainWorkload(train_step=train_step, init_state=init_state,
                         batch_fn=batch_fn)


def build_session(arch: Union[str, ModelConfig], *, reduced: bool = True,
                  batch: int = 8, seq: int = 128, ft: FTConfig,
                  ckpt_dir=None, kill_schedule=None, injector=None,
                  seed: int = 0, n_logical_workers: int = 8,
                  workers_per_node: int = 4, lr: float = 1e-3, device=None,
                  jax_params: Optional[dict] = None):
    """Returns (FTSession, TrainWorkload)."""
    workload = build_workload(arch, reduced=reduced, batch=batch, seq=seq,
                              seed=seed, lr=lr, device=device,
                              jax_params=jax_params)
    if injector is None:
        injector = dict(kill_schedule or {})
    session = FTSession(ft=ft, ckpt_dir=ckpt_dir, injector=injector,
                        n_logical_workers=n_logical_workers,
                        workers_per_node=workers_per_node)
    return session, workload


def build_trainer(arch: Union[str, ModelConfig], *, reduced: bool = True,
                  batch: int = 8, seq: int = 128, ft: FTConfig,
                  ckpt_dir=None, kill_schedule=None, seed: int = 0,
                  n_logical_workers: int = 8, lr: float = 1e-3, device=None,
                  jax_params: Optional[dict] = None) -> FTTrainer:
    """Legacy surface: an FTTrainer shim over build_session's plumbing."""
    workload = build_workload(arch, reduced=reduced, batch=batch, seq=seq,
                              seed=seed, lr=lr, device=device,
                              jax_params=jax_params)
    return FTTrainer(train_step=workload.train_step,
                     init_state=workload.init_state_fn,
                     batch_fn=workload.batch_fn, ft=ft, ckpt_dir=ckpt_dir,
                     n_logical_workers=n_logical_workers,
                     kill_schedule=kill_schedule)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b",
                    help="a dense, VLM, hybrid, audio or SSM arch "
                         "(qwen3-8b, llama-3.2-vision-11b, zamba2-7b, "
                         "whisper-tiny, xlstm-350m, ...)")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ft-mode", default="combined",
                    choices=["none", "checkpoint", "replication", "combined"])
    ap.add_argument("--mtbf", type=float, default=1e9)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=float, default=0.0)
    ap.add_argument("--kill", action="append", default=[],
                    help="step:worker[,worker...] failure injection")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for tests)")
    args = ap.parse_args(argv)

    kills = {}
    for spec in args.kill:
        s, ws = spec.split(":")
        kills[int(s)] = [int(w) for w in ws.split(",")]

    ft = FTConfig(mode=args.ft_mode, mtbf_s=args.mtbf,
                  ckpt_interval_s=args.ckpt_interval)
    session, workload = build_session(
        args.arch, reduced=args.reduced, batch=args.batch, seq=args.seq, ft=ft, ckpt_dir=args.ckpt_dir,
        kill_schedule=kills, seed=args.seed, device=args.device)
    # repro: allow[wallclock] -- genuine wall measurement
    t0 = time.perf_counter()
    rep = session.run(workload, args.steps)
    # repro: allow[wallclock] -- genuine wall measurement
    dt = time.perf_counter() - t0
    print(f"arch={args.arch} mode={args.ft_mode} steps={rep.steps} "
          f"loss[first,last]=({rep.losses[0]:.4f},{rep.losses[-1]:.4f}) "
          f"failures={rep.failures} promotions={rep.promotions} "
          f"restarts={rep.restarts} ckpts={rep.ckpt_writes} "
          f"rolled_back={rep.rolled_back_steps} wall={dt:.1f}s")
    if not np.isfinite(rep.losses).all():
        print("ERROR: non-finite loss", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
