"""Serving driver: batched prefill + greedy decode with replication
failover (port of ``repro/launch/serve.py:114-238``).

The decode loop is a ``DecodeWorkload`` whose state carries the KV cache;
``FTSession`` owns replica management, so when the computational slice
fails mid-generation the replica's cache is CURRENT and failover costs one
promotion (no prefill replay). The server runs on the card unless it is
given ``device="cpu"``.

The JAX server routes each request batch to the serving rank over a
replicated transport (``BatchFanout``). That transport is not ported yet
(ROADMAP.md, Queue 1 item 3); the fan-out is an identity on the batch, so
``generate`` hands the prompt batch to the workload directly and the token
stream is the same.

Any ported family serves through the same code: the dense qwen3-8b (the
default) and the zamba2-7b hybrid, whose state carries a recurrent Mamba
state per block beside the attention rings (cloned like the rings).

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
      --batch 4 --prompt-len 32 --gen 16 --kill-at 8 --device cuda
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs import RunConfig, get_arch
from repro_torch.configs.base import FTConfig, ShapeConfig
from repro_torch.ft import DecodeWorkload, FTSession, StepKillInjector
from repro_torch.launch.step_fns import make_decode_step, make_prefill_step


class ReplicatedServer:
    """Model plumbing (prefill/decode steps, seeded weights) + a thin
    ``generate`` that delegates all fault tolerance to FTSession."""

    def __init__(self, arch: str, *, reduced: bool = True, batch: int = 4,
                 prompt_len: int = 32, replication: bool = True,
                 seed: int = 0, device=None):
        dev = device_lib.resolve(device)
        cfg = get_arch(arch)
        if reduced:
            cfg = cfg.reduced()
        self.cfg = cfg
        shape = ShapeConfig("serve", seq_len=prompt_len, global_batch=batch,
                            kind="prefill")
        self.prefill, self.model = make_prefill_step(
            RunConfig(model=cfg, shape=shape), dev)
        self.decode = make_decode_step()
        # weights drawn on the device they live on, from the seed
        self.model.init(torch.Generator(device=dev).manual_seed(seed))
        self.device = dev
        self.replication = replication
        self.batch = batch
        self.prompt_len = prompt_len
        self.failures = 0
        self.promotions = 0
        self.last_report = None

    def workload(self, prompt_tokens: np.ndarray) -> DecodeWorkload:
        """The decode loop as a Workload (also used by tests directly)."""
        tokens = torch.as_tensor(np.asarray(prompt_tokens), device=self.device)
        return DecodeWorkload(params=self.model, prefill=self.prefill,
                              decode=self.decode, batch={"tokens": tokens},
                              prompt_len=self.prompt_len)

    def session(self, kill_at: int = -1) -> FTSession:
        """One logical serving rank; replication adds its replica slice.
        ``allow_restart=False``: without a replica or checkpoint a mid-decode
        death is fatal (a restart would need a prefill replay)."""
        mode = "replication" if self.replication else "none"
        injector = StepKillInjector({kill_at: [0]}) if kill_at >= 0 else None
        return FTSession(ft=FTConfig(mode=mode), injector=injector,
                         n_logical_workers=1, workers_per_node=1,
                         allow_restart=False)

    def generate(self, prompt_tokens: np.ndarray, n_gen: int,
                 kill_at: int = -1) -> np.ndarray:
        """Greedy decode; kill_at k kills the computational slice after k
        generated tokens (replication failover or abort)."""
        session = self.session(kill_at)
        try:
            rep = session.run(self.workload(prompt_tokens), n_gen)
        except RuntimeError:
            # fatal (unrecoverable) kill: still record the failure
            self.failures += 1
            raise
        self.last_report = rep
        self.failures += rep.failures
        self.promotions += rep.promotions
        return DecodeWorkload.tokens(rep.final_state)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True, help="tiny same-family config "
                    "(--no-reduced serves the full model)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--kill-at", type=int, default=-1)
    ap.add_argument("--no-replication", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    srv = ReplicatedServer(args.arch, reduced=args.reduced, batch=args.batch,
                           prompt_len=args.prompt_len,
                           replication=not args.no_replication,
                           device=args.device)
    prompts = np.random.default_rng(0).integers(
        0, srv.cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
    t0 = time.perf_counter()
    toks = srv.generate(prompts, args.gen, kill_at=args.kill_at)
    dt = time.perf_counter() - t0
    print(f"arch={args.arch} device={srv.device} generated={toks.shape} "
          f"failures={srv.failures} promotions={srv.promotions} "
          f"wall={dt:.3f}s tok/s={toks.size / dt:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
