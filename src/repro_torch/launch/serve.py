"""Serving driver: batched prefill + greedy decode with replication
failover (port of ``repro/launch/serve.py``).

The decode loop is a ``DecodeWorkload`` whose state carries the KV cache;
``FTSession`` owns replica management, so when the computational slice
fails mid-generation the replica's cache is CURRENT and failover costs one
promotion (no prefill replay). The server runs on the card unless it is
given ``device="cpu"``.

Request batches reach the serving rank through ``BatchFanout``: a
``ReplicaTransport`` bcast from an unreplicated frontend rank, so the
computational copy arrives cmp→cmp and the replica copy over the §5
intercomm fill-in, logged with send-IDs like any other message. On the
card the bcast carries the device tensor of the batch; the batch is never
copied to the host for it.

With ``obs=True`` (or an ``obs.ObsRecorder``) one recorder counts the
fan-out's traffic and every serving session's steps, failures and
recovery arcs (host-side bookkeeping: it launches nothing on the card).

Any ported family serves through the same code: the dense qwen3-8b (the
default), the zamba2-7b hybrid, whose state carries a recurrent Mamba
state per block beside the attention rings (cloned like the rings), the
mixtral MoE and the llama-3.2-vision VLM, whose prefill also reads image
embeddings (zeros, as the reference's server feeds them) and whose state
carries each group's cross K/V, whisper-tiny, whose prefill encodes frames
(zeros, likewise) and whose state carries every decoder layer's cross K/V
over them, and xlstm-350m, whose state is recurrent (no KV ring).
``ReplicatedServer`` takes an arch name or a ``ModelConfig`` (a depth-cut
one, say).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
      --batch 4 --prompt-len 32 --gen 16 --kill-at 8 --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama-3.2-vision-11b --device cpu --kill-at 3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
      --no-reduced --prompt-len 416 --gen 32 --kill-at 8 --device cuda
  # replicated in-memory checkpoints: promote, then a pair death restored
  # from partner memory (8 logical ranks, 4 a node)
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --ckpt-mode combined --kill 4:1 --kill 8:9
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Union

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.clock import VirtualClock, pricing_from_ft
from repro_torch.comm import NOTHING, CollectiveEngine, ReplicaTransport
from repro_torch.configs import RunConfig, as_config
from repro_torch.configs.base import FTConfig, ModelConfig, ShapeConfig
from repro_torch.core.coordinator import ClusterTopology
from repro_torch.core.replica_map import ReplicaMap
from repro_torch.ft import DecodeWorkload, FTSession, StepKillInjector
from repro_torch.launch.step_fns import make_decode_step, make_prefill_step
from repro_torch.obs import ObsRecorder


class BatchFanout:
    """Routes each request batch over a ReplicaTransport bcast.

    Two logical ranks: rank 0 is the serving rank (replicated when the
    server replicates), rank 1 the unreplicated frontend holding the
    batch.  A ``bcast`` rooted at the frontend delivers the batch cmp→cmp
    to the serving computational worker and — because the destination is
    replicated and the source is not — over the intercomm fill-in to the
    replica worker, logged with send-IDs like any training message.  Each
    worker receives a tensor of its own (a clone of the logged one); both
    must be bitwise identical, and the cmp copy feeds the workload.

    With ``ft.topology`` set the fan-out traffic is α‑β-priced and charged
    into the fan-out's ``VirtualClock``; ``generate`` merges it into the
    run's ``RunReport.time.comm``.  With a recorder (``obs``) the fan-out
    traffic counts into the per-band counters and, when priced, the
    per-link heat of the same recorder the serving sessions use.
    """

    SERVE_RANK, FRONTEND_RANK = 0, 1

    def __init__(self, replication: bool, ft: FTConfig = None, obs=None):
        self.rmap = ReplicaMap(2, 1 if replication else 0)
        cluster = ClusterTopology(self.rmap.world_size, 1)
        pricing = pricing_from_ft(ft or FTConfig(), cluster)
        self.clock = VirtualClock(cost_model=pricing.cost_model)
        self.transport = ReplicaTransport(self.rmap, 2,
                                          cost_model=pricing.cost_model)
        self.engine = CollectiveEngine(self.transport)
        self.obs = obs
        if obs is not None:
            self.transport.add_observer(obs)
            self.engine.obs = obs
            if pricing.cost_model is not None and obs.links is None:
                self.transport.link_usage = \
                    obs.attach_links(pricing.cost_model)
        self.eps = {w: self.transport.register(w) for w in self.rmap.alive()}
        self.fanouts = 0
        self.received = {}               # worker -> its copy, last round

    def fan_out(self, batch: torch.Tensor) -> torch.Tensor:
        """One bcast round; returns the batch as received by the serving
        computational worker."""
        self.engine.begin_step()
        step = self.fanouts
        pend = {
            w: self.engine.post(
                ep,
                ("bcast",
                 batch if self.rmap.role_of(w)[1] == self.FRONTEND_RANK
                 else None,
                 self.FRONTEND_RANK),
                step)
            for w, ep in self.eps.items()}
        got = {}
        while len(got) < len(pend):
            for w, ep in self.eps.items():
                if w in got:
                    continue
                out = self.engine.resolve(ep, pend[w])
                if out is not NOTHING:
                    got[w] = out
        self.received = got
        cmp_w = self.rmap.cmp[self.SERVE_RANK]
        rep_w = self.rmap.rep[self.SERVE_RANK]
        if rep_w is not None and not torch.equal(got[cmp_w], got[rep_w]):
            raise RuntimeError("the replica received another batch than "
                               "the computational worker")
        self.fanouts += 1
        # priced fan-out traffic -> the clock's comm ledger (0.0 unpriced)
        self.clock.charge_comm(self.transport)
        return got[cmp_w]


class ReplicatedServer:
    """Model plumbing (prefill/decode steps, seeded weights) + a thin
    ``generate`` that delegates all fault tolerance to FTSession."""

    def __init__(self, arch: Union[str, ModelConfig], *,
                 reduced: bool = True, batch: int = 4, prompt_len: int = 32,
                 replication: bool = True, seed: int = 0, device=None,
                 topology: str = None, obs=None):
        dev = device_lib.resolve(device)
        cfg = as_config(arch, reduced)
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
        self.topology = topology
        # one recorder shared by the fan-out transport and every serving
        # session (obs=True builds it; None keeps everything unwired)
        self.obs = None
        if obs is not None:
            self.obs = ObsRecorder() if obs is True else obs
        self.fanout = BatchFanout(replication,
                                  ft=FTConfig(mode="none", topology=topology),
                                  obs=self.obs)
        self.failures = 0
        self.promotions = 0
        self.last_report = None

    def _extras(self, tokens: torch.Tensor) -> dict:
        """The prefill batch: the tokens and, for the audio family, the
        frames [B, n_frames, d], for the VLM the image embeddings [B,
        n_image_tokens, d], as zeros in bf16 on the server's device (the
        reference's ``_extras``; its frontends are stubs)."""
        batch = {"tokens": tokens}
        if self.cfg.family == "audio":
            batch["frames"] = torch.zeros(
                (tokens.shape[0], self.cfg.n_frames, self.cfg.d_model),
                dtype=torch.bfloat16, device=self.device)
        if self.cfg.family == "vlm":
            batch["image_embeds"] = torch.zeros(
                (tokens.shape[0], self.cfg.n_image_tokens, self.cfg.d_model),
                dtype=torch.bfloat16, device=self.device)
        return batch

    def workload(self, prompt_tokens) -> DecodeWorkload:
        """The decode loop as a Workload (also used by tests directly);
        ``prompt_tokens`` is an ndarray or a tensor, moved to the server's
        device once."""
        tokens = torch.as_tensor(prompt_tokens, device=self.device)
        return DecodeWorkload(params=self.model, prefill=self.prefill,
                              decode=self.decode, batch=self._extras(tokens),
                              prompt_len=self.prompt_len)

    def session(self, kill_at: int = -1) -> FTSession:
        """One logical serving rank; replication adds its replica slice.
        ``allow_restart=False``: without a replica or checkpoint a mid-decode
        death is fatal (a restart would need a prefill replay)."""
        mode = "replication" if self.replication else "none"
        injector = StepKillInjector({kill_at: [0]}) if kill_at >= 0 else None
        return FTSession(ft=FTConfig(mode=mode, topology=self.topology),
                         injector=injector, n_logical_workers=1,
                         workers_per_node=1, allow_restart=False,
                         obs=self.obs)

    def generate(self, prompt_tokens: np.ndarray, n_gen: int,
                 kill_at: int = -1) -> np.ndarray:
        """Greedy decode; kill_at k kills the computational slice after k
        generated tokens (replication failover or abort). The batch, int32
        as given, reaches the serving rank over the transport bcast
        (logged, deduped) as a tensor on the server's device."""
        session = self.session(kill_at)
        comm0 = self.fanout.clock.breakdown.comm
        tokens = self.fanout.fan_out(
            torch.as_tensor(prompt_tokens, device=self.device))
        try:
            rep = session.run(self.workload(tokens), n_gen)
        except RuntimeError:
            # fatal (unrecoverable) kill: still record the failure
            self.failures += 1
            raise
        # the batch fan-out's priced traffic lands in the same ledger as
        # the run's own time (0.0 without a topology)
        rep.time.comm += self.fanout.clock.breakdown.comm - comm0
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
    ap.add_argument("--topology", default=None,
                    help="price fan-out + session time over this topo graph "
                         "(flat|fattree|dragonfly|torus3d)")
    ap.add_argument("--ckpt-mode", choices=("checkpoint", "combined"),
                    help="decode under an FTSession of 8 logical ranks (4 a "
                         "node) with replicated in-memory checkpoints every "
                         "4 steps; workers die by --kill")
    ap.add_argument("--kill", action="append", default=[],
                    metavar="STEP:WORKER",
                    help="with --ckpt-mode: kill WORKER before STEP")
    args = ap.parse_args(argv)

    srv = ReplicatedServer(args.arch, reduced=args.reduced, batch=args.batch,
                           prompt_len=args.prompt_len,
                           replication=not args.no_replication,
                           device=args.device, topology=args.topology)
    prompts = np.random.default_rng(0).integers(
        0, srv.cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
    # repro: allow[wallclock] -- genuine wall measurement
    t0 = time.perf_counter()
    if args.ckpt_mode:
        kills = {}
        for spec in args.kill:
            step, worker = (int(v) for v in spec.split(":"))
            kills.setdefault(step, []).append(worker)
        session = FTSession(
            ft=FTConfig(mode=args.ckpt_mode, ckpt_backend="memory",
                        ckpt_interval_s=4.0, topology=args.topology),
            injector=kills, n_logical_workers=8, workers_per_node=4)
        rep = session.run(srv.workload(prompts), args.gen)
        toks = DecodeWorkload.tokens(rep.final_state)
        restores = [e.detail["restore_backend"] for e in rep.events
                    if e.kind == "restart_elastic"]
        summary = (f"mode={args.ckpt_mode} restarts={rep.restarts} "
                   f"ckpt_writes={rep.ckpt_writes} "
                   f"rolled_back_steps={rep.rolled_back_steps} "
                   f"restore_backend={','.join(restores) or '-'} "
                   f"failures={rep.failures} promotions={rep.promotions}")
    else:
        toks = srv.generate(prompts, args.gen, kill_at=args.kill_at)
        rep = srv.last_report
        summary = f"failures={srv.failures} promotions={srv.promotions}"
    # repro: allow[wallclock] -- genuine wall measurement
    dt = time.perf_counter() - t0
    print(f"arch={args.arch} device={srv.device} generated={toks.shape} "
          f"{summary} comm_s={rep.time.comm} "
          f"wall={dt:.3f}s tok/s={toks.size / dt:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
