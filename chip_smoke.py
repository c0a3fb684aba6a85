#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA H100
and check them.

    python3 chip_smoke.py

Phases (each a function; any failure exits non-zero):
  1. device and build: the card's name and power limit, then nvcc builds
     every kernel in ``src/repro_torch/kernels/csrc`` (one process per
     source, all at once);
  1b. comm: every collective of the replica-aware fabric on card tensors
     (5 ranks, 2 replicated, f32, bf16 and int64, sum and max), a
     computational worker killed mid-collective and repaired by drain and
     replay, then again under the fattree registry with α‑β pricing:
     results, sender logs, recovery counts and priced seconds bitwise the
     same run's on CPU tensors, results bitwise ``reference_result``'s;
  2. RMSNorm kernel against its plain PyTorch version on the card, at
     every (rows, d) of the served paths (prefill and decode; whisper-tiny's
     d 384 and xlstm-350m's d 1024 among them), ragged row
     counts, other widths, the strided qk-norm view and the unaligned
     scalar path, reruns bitwise; the fused residual add + norm
     (``add_rmsnorm``): s bitwise ``x + r``, y bitwise the kernel's norm
     of s;
  3. flash-attention kernels against their plain PyTorch version on the
     card (head dims 32, 64, 112, 128; bf16 runs the tensor-core kernel,
     f32 the FMA kernel), ragged key tails, short prompts, windows and
     non-causal cases included, and non-causal with Sq != Skv:
     llama-3.2-vision's cross-attention (q [4, 32, 512, 128] over k/v
     [4, 8, 1600, 128]) in bf16 and f32, and a ragged 40 x 1000 pair;
     whisper-tiny's D 64 MHA shapes: the encoder's non-causal 1,500 x
     1,500, the cross-attention's 448 x 1,500, the decoder's causal 448;
  4. Mamba2 SSD scan kernels against their plain PyTorch version (the exact
     recurrence) on the card (bf16 runs the tensor-core kernel, f32 the FMA
     kernel, which a profiler trace confirms): the serve shape on several
     draws, chunks of 64 and 40, P and N below 64, an odd head count,
     reruns and strided views bitwise;
  5. reference: the reduced qwen3-8b, zamba2-7b, mixtral-8x7b and
     llama-3.2-vision-11b (random image embeddings, nonzero gates) in
     f32, kernel path on the card against the plain path on the CPU; then
     whisper-tiny (seeded random frames) and xlstm-350m at full size in
     f32 the same way;
  6. serve, for each model — qwen3-8b (slice 1) and zamba2-7b (slice 2), at
     full width and depth, mixtral-8x7b (slice 12) at full width with 16 of
     its 32 layers and llama-3.2-vision-11b (slice 12) at full size (zero
     image embeddings, as the reference's server feeds them), whisper-tiny
     (slice 13; zero frames likewise, a 416-token prompt so that the
     stream ends at its 448-token text context) and xlstm-350m (slice 13)
     at full size, in bf16
     (random weights from a seed) under replication: an unreplicated kill
     that must raise (that server freed before the next is built, so one
     copy of the weights is on the card at a time), a clean run, and a run
     whose computational slice is killed mid-stream (the token streams and
     the whole final state, the VLM's cross K/V included, must be bitwise
     equal, one promotion); the kernels' launch counters, zeroed just
     before each path and read just after, must equal the counts the path
     implies; every
     request batch reaches the model through ``BatchFanout`` (a ``fanout``
     line: the server's log, one send-ID per ``generate`` in order, then a
     priced fan-out of the device batch timed on the host, its copies
     equal);
  6b. serve.ckpt, for each model: the server's decode loop (batch 4,
     512-token prompt, GEN steps) under an ``FTSession`` of 8 logical
     ranks (4 a node) with replicated in-memory checkpoints (``store``):
     combined mode with a promotion then a pair death, checkpoint mode
     with an unreplicated death; each restart restores the state from
     partner memory onto the card, and the stream equals the clean one
     bitwise; prints the state's bytes, the host bytes each generation's
     bands hold (shared frozen arrays, one copy per generation), save and
     restore wall ms and the kernels' launches;
  6c. obs (qwen3-8b): a second full-size server with a recorder
     (``obs=True``, fattree pricing) serves the killed stream: spans closed
     and nested, one kill, a promote arc, the fan-out's counted bytes
     equal to what it sent, measured link heat, a Chrome trace that loads;
     kernel launches equal with the recorder on and off; host ms a decode
     step on and off;
  6d. store (qwen3-8b): one ``MemStore`` world (4 ranks, 4 replicas, 2 a
     node, k = 2) over the card's KV rings: every f <= k node or pair
     death restores bitwise onto the card, a death mid-commit restores the
     previous generation, more than k failure domains lost raises;
  7. times, after each serve phase: CUDA-event medians of each kernel, its
     plain version and the PyTorch library call (where one exists) at the
     path's shapes (the fused norm beside ``x + r`` and ``F.rms_norm``),
     the launch floor (an empty kernel), and the whole path's prefill and
     decode times; for mixtral-8x7b and llama-3.2-vision-11b (in their
     serve phases) K2 at each of their prefill shapes, the cross shape
     with its operations bound, and the path's times; for whisper-tiny K1
     at d 384 and K2 at its encoder, self and cross shapes, for xlstm-350m
     K1 at d 1024, each with a ``times`` line. Each model's servers are
     freed before the next model's serve phase;
  8. train: the backward kernels of K1 (``rmsnorm_bwd``, ``add_rmsnorm_bwd``,
     at d 128, 3584, 4096 and zamba2-7b's out_norm at 7168), K2
     (``flash_attention_bwd``: bf16 on the tensor cores, reading the
     forward's logsumexp; f32 on FMAs) and K3 (``mamba_scan_bwd``: a state
     pass, a chunk pass and a reduce; bf16 on the tensor cores, f32 on
     FMAs, every entry in the ptxas gate; at zamba2-7b's train shape
     with x, B, C as views of the conv output, chunk 64, the reduced
     config's P 64 / N 16 / chunk 16 and a ragged head count; K2 also at
     the VLM's cross shape, q 512 over k/v 1,600, D 128, GQA 8,
     non-causal, and codeqwen1.5-7b's MHA) against
     autograd of their plain versions at the train shapes and the other
     cases, reruns bitwise, the forward's logsumexp against
     ``ref.flash_attention_lse_ref`` with o bitwise the same with and
     without it, their ptxas lines (no spills) and times (a
     ``train.kernels`` line); then qwen3-8b at full width, depth cut to 2
     layers, trained 9 steps (``TRAIN_STEPS``) at batch 4 x 512 through
     ``launch.train``:
     clean, and under replication (a promotion) and combined (a
     promotion, then a pair death restored from the on-disk checkpoint),
     each final state (params, m, v) bitwise the clean run's, its bytes
     those its tensors' dtypes give, and each kernel's launches the count
     the executed steps imply (a ``train`` line per run; the checkpoint
     schedule runs on the CPU only, see ``phase_train``). The disk run
     writes its checkpoints (16.3 GB each) under ``build/train_ckpt`` and
     keeps at most two there at a time;
  8b. train, zamba2-7b: full width, depth cut to 13 Mamba blocks (two
     groups of 6 behind the shared attention block and a tail of 1), the
     same 9 steps, clean, replication and combined under the same gates,
     every kernel of the path and its backward launched the counted
     number of times (14.5 GB checkpoints; the hybrid's checkpoint
     schedule runs on the CPU only, see ``phase_train_zamba``);
  8c. train, whisper-tiny (full size, batch 4 x 448, zero frames) and
     xlstm-350m (full width, 6 of its 24 blocks, 4 x 64: its gradient
     overflows past ~96 tokens, ROADMAP.md F7): the same 9 steps, clean,
     replication and combined under the same gates (K2's backward at D 64
     non-causal with Sq != Skv on whisper's path); phase 8's checks and
     times include K2's backward at whisper's three shapes and K1's at d
     384 and 1024;
  8d. train, llama-3.2-vision-11b (slice 16): full width, one group of a
     gated cross layer and 5 self layers, batch 4 x 512, zero image
     embeddings: clean and replication under the same gates, K2 launched
     at the cross shape once a group and forward (its disk schedules run
     on the CPU only, see ``phase_train_vlm``);
  8e. fig10 (slice 16): the paper's Fig 10 through
     ``repro_torch.figures.fig10_overhead`` with codeqwen1.5-7b, at the
     reference's configuration (reduced, 4 x 64) and at full width with 2
     layers (4 x 512): bare and FT ms a step and the overhead beside the
     paper's 1.3%, the FT run's final state bitwise the bare loop's, the
     virtual-time row the reference's, one execution a step (``fig10``
     lines); K2's forward at codeqwen1.5-7b's MHA shape timed;
  8f. train, mixtral-8x7b (slice 17): full width, one layer (1.71 B
     parameters), batch 4 x 512: clean and replication under the same
     gates (the sort-based dispatch's backward bitwise across runs), the
     loss with 0.01 x the router's load-balancing loss, its value at step
     0 printed (a ``train.moe`` line);
  8g. dryrun (slice 17): on the card,
     qwen3-8b's train step at 2 layers, its full-depth prefill and the
     MoE's train step, each at 4 x 512: ``FlopCounterMode``'s count plus
     each kernel's ``kernels/cost.py`` work times its launches equal to
     the dry run's count on one device exactly, beside the dry run's
     bound and the step's time and its argument bytes beside the state's
     (``dryrun.card`` lines);
  9. simrt: the simulated runtime with HPCG (16 ranks of 104^3), CloverLeaf
     (8 slabs of 3,840 x 240) and PIC (8 ranks of 4,096 cells and
     1,048,576 particles) in float64 on the card, 4 workers a node, 12
     steps under tests/test_simrt_apps.py's schedules (none; replication,
     three promotions; checkpoint, a restart from disk; combined, a
     promotion then a pair death restarted from disk): every rank's final
     state bitwise the none run's, the counters, the virtual time and
     counters equal to the CPU run of the same schedule at the tests'
     size, the replication run again with the divergence tripwire armed
     (bitwise, silent); HPCG combined with in-memory checkpoints under
     fattree pricing, restored from partner memory bitwise; each app at
     full per-rank size on 4 ranks for 4 steps on the card against the
     CPU (``SIMRT_TOL``, particle counts equal); the traced HPCG demo
     (spans closed and nested); ``SimAppWorkload`` under ``FTSession``,
     bitwise after a promotion (``simrt`` lines);
  10. pool: Fig 16's grid (3 MTTIs x 4 FT configurations, 24 tasks on 6
     workers, 60 rounds of 60 s, fattree) through ``repro_torch.pool`` with
     the tasks computing on the card: the rows' digest the pinned
     ``fig16_taskpool``, every value the CPU run's (mc_pi exactly,
     train_surrogate within ``POOL_LOSS_RTOL``), every cell's result table
     bitwise the failure-free one, no kernel launched (a ``pool`` line);
  11. analyze: ``repro_torch.analyze``'s ``all`` (the lint, the apps'
     schedules traced on the card) and ``divergence`` (a bit flipped on
     the card, caught) both return 0 (an ``analyze`` line);
  12. dryrun_sweep (slice 17), after every timed phase: the host's dry run
     of every applicable cell on both production meshes (``python -m
     repro_torch.launch.dryrun``, one CPU process a shape and mesh, all at
     once; JSON, logs and the 16 x 16 table in ``build/dryrun``), all OK
     (a ``dryrun.sweep`` line).

Prints JSON lines as it goes (``comm``, ``fanout``, ``serve``,
``serve.ckpt``, ``obs``, ``store``, ``times``, ``train.kernels``,
``train``, ``train.moe``, ``fig10``, ``dryrun.card``, ``dryrun.sweep``,
``simrt``, ``pool`` and ``analyze`` lines among them, and each
phase's seconds), then
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
Exits non-zero without CUDA, and when run outside the repository (the
port's package must be beside it in ``src``).
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import resource
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# cuBLAS reproducibility needs this before the first CUDA call
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import comm as comm_lib  # noqa: E402
from repro_torch.apps.cloverleaf import CloverLeaf  # noqa: E402
from repro_torch.apps.hpcg import HPCG  # noqa: E402
from repro_torch.apps.pic import PIC  # noqa: E402
from repro_torch.comm.collectives import TAG_BCAST  # noqa: E402
from repro_torch.comm.worlds import (  # noqa: E402
    PORT_FABRIC, CommZoo, canon, run_world, tensor_maker)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import FTConfig  # noqa: E402
from repro_torch.core.coordinator import ClusterTopology  # noqa: E402
from repro_torch.core.failure_sim import FailureEvent  # noqa: E402
from repro_torch.core.replica_map import (  # noqa: E402
    ApplicationDead, ReplicaMap)
from repro_torch.figures import fig10_overhead  # noqa: E402
from repro_torch.ft import (  # noqa: E402
    DecodeWorkload, FTSession, SimAppWorkload)
from repro_torch.kernels import build, cost, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd)
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    mamba_chunk_scan, mamba_chunk_scan_bwd)
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    add_rmsnorm, add_rmsnorm_bwd, rmsnorm, rmsnorm_bwd)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as train_lib  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    BatchFanout, ReplicatedServer)
from repro_torch.models import api, mamba2  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import layers as mlayers  # noqa: E402
from repro_torch.models import xlstm as xlstm_lib  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.models.zamba import Zamba  # noqa: E402
from repro_torch.obs import write_chrome_trace  # noqa: E402
from repro_torch.obs.demo import traced_hpcg_run  # noqa: E402
from repro_torch.simrt import CostModel, SimRuntime  # noqa: E402
from repro_torch.store import MemStore, StoreUnrecoverable  # noqa: E402
from repro_torch.store.backend import (  # noqa: E402
    MemBackend, from_host, to_host)
from repro_torch.tree import copy_tree, tree_map  # noqa: E402

# |kernel - plain| <= atol + rtol * |plain| (tests/test_kernels.py's
# tolerances): f32 differs only by summation order; bf16 by at most one
# rounding of the f32 result (and, in the bf16 attention kernel, by the
# softmax weights p rounded to bf16 before the PV product)
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (3e-2, 2e-2)}
# the Mamba2 scan's f32 outputs: the chunked scan against the exact per-step
# recurrence (tests/test_kernels.py's sweep tolerance)
MAMBA_TOL = (3e-4, 3e-4)
# the forward's logsumexp against the plain one: f32 sums in another order
# on values of order ln(Skv)
LSE_TOL = (1e-5, 1e-5)
# K3's backward (tests/test_torch_mamba_bwd.py, fixed before any card run):
# MAMBA_TOL scaled to each output's largest |plain|; TOL[bf16] on top for
# a bf16 output
SCAN_BWD_TOL = 3e-4


def scan_bwd_tol(want, dtype):
    """(atol, rtol) of K3's backward for one output of plain value
    ``want`` written in ``dtype``."""
    atol = SCAN_BWD_TOL * float(want.float().abs().max())
    rtol = SCAN_BWD_TOL
    if dtype == torch.bfloat16:
        atol, rtol = atol + TOL[dtype][0], rtol + TOL[dtype][1]
    return atol, rtol

B, S, GEN, KILL_AT = 4, 512, 32, 8
SPIN_CYCLES = 2_000_000            # ~1 ms at the H100's clock
QWEN = get_arch("qwen3-8b")
ZAMBA = get_arch("zamba2-7b")
# mixtral-8x7b at full width, depth cut from 32 to 16 layers (46.96 GB of
# bf16 weights; 32 layers would be 93.4 GB, more than the card holds)
MIXTRAL = dataclasses.replace(get_arch("mixtral-8x7b"), n_layers=16)
VISION = get_arch("llama-3.2-vision-11b")       # full size, 20.2 GB
CODEQWEN = get_arch("codeqwen1.5-7b")            # MHA with the QKV bias
WHISPER = get_arch("whisper-tiny")               # full size, 56.4 M params
XLSTM = get_arch("xlstm-350m")                   # full size, 265.8 M params
# whisper's served stream ends at its published text context (openai/whisper
# n_text_ctx 448): a 416-token prompt and GEN new tokens
WHISPER_PROMPT = 448 - GEN
KERNELS = {"rmsnorm": rmsnorm, "add_rmsnorm": add_rmsnorm,
           "flash_attention": flash_attention, "mamba_scan": mamba_chunk_scan}
SERVE_DRAWS = (7, 8, 9)            # more serve-shape draws of K3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0
    flash_attention.calls.clear()


def k2_by_shape():
    """K2's launches by (Sq, Skv, causal), from its wrapper's tally by
    ``kernels.cost.attention``'s arguments."""
    out = collections.Counter()
    for (_, _, _, sq, skv, _, _, causal, _), n in \
            flash_attention.calls.items():
        out[(sq, skv, causal)] += n
    return out


def read_launches():
    return {name: fn.launches for name, fn in KERNELS.items()}


def compare(name, got, want, dtype, tol=None, **shape):
    atol, rtol = tol or TOL[dtype]
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    ok = bool((err <= bound).all())
    max_err = float(err.max())
    emit({"check": name, "dtype": str(dtype).replace("torch.", ""),
          **shape, "max_abs_err": max_err, "atol": atol, "rtol": rtol,
          "share_of_tolerance": float((err / bound).max()), "ok": ok})
    if not ok:
        raise AssertionError(f"{name} {shape}: kernel disagrees with its "
                             f"plain version (max |err| {max_err})")
    return max_err


# ---------------------------------------------------------------- phase 1

def _demangle(symbol):
    tool = shutil.which("c++filt")
    if tool is None:
        return symbol
    return subprocess.run([tool, symbol], capture_output=True,
                          text=True).stdout.strip() or symbol


def ptxas_report(name):
    """What ``ptxas -v`` said of each kernel in ``name``'s library: its
    registers, shared memory and spills, one dict per entry function."""
    rows, function, spills = [], None, ""
    for line in build.build_log(name).splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            function = _demangle(line.split("'")[1])
        elif "spill" in line:
            spills = line
        elif "Used" in line and "registers" in line and function:
            rows.append({"ptxas": name, "function": function,
                         "usage": line.split(":", 1)[1].strip(),
                         "spills": spills})
            function, spills = None, ""
        elif "Performance Loss" in line:    # e.g. serialised wgmma
            rows.append({"ptxas": name, "note": line.split(":", 1)[1]})
    return rows


def phase_device_and_build(state):
    state["card"] = card()
    print(state["card"], flush=True)
    t0 = time.perf_counter()
    libs = build.build_all()
    emit({"phase": "build", "kernels": sorted(libs),
          "seconds": time.perf_counter() - t0})
    for name in libs:
        for row in ptxas_report(name):
            emit(row)
    # K2's tensor-core kernels: no spill, and no wgmma that ptxas
    # serialised (its "Potential Performance Loss" notes: C7513, C7518,
    # C7520 and kin); the report has to name each kernel of the D 128 rows
    # that see every key and the forward of causal rows of unpaired heads
    rows = [row for name in ("flash_attention", "flash_attention_bwd")
            for row in ptxas_report(name)]
    bad = [row for row in rows
           if "note" in row or not re.search(
               r"0 bytes spill stores, 0 bytes spill loads",
               row.get("spills", ""))]
    if bad:
        raise AssertionError(f"ptxas: K2 spills or serialises: {bad}")
    reported = " ".join(row.get("function", "") for row in rows)
    missing = [k for k in ("flash_fwd128_tc<false>",
                           "flash_fwd128_tc<true>", "flash_bwd_dq128_tc",
                           "flash_bwd_dkdv128_tc") if k not in reported]
    if missing:
        raise AssertionError(f"ptxas: no line for {missing}")


# ------------------------------------------------------------ phase 1b: comm
#
# The replica-aware fabric on card tensors, driven by the port's step
# scheduler (``repro_torch.comm.worlds.run_world``).

COMM_N, COMM_M, COMM_STEPS = 5, 2, 3      # ranks, replicated ranks, steps
# rank 1's computational worker dies after the second round of step 1,
# with the step's transport collectives in flight
COMM_KILL = (1, 2, 1)
COMM_SHAPE = (6,)
# below the 24 bytes of a (6,) f32 payload, so the priced run takes the
# ring allreduce and ring reduce_scatter beside the trees
COMM_SMALL_MSG = 16
COMM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "int64": torch.int64}


def comm_case(device, dtype_name, redop, topology=None):
    """One world of the comm phase on ``device``: the zoo under a kill."""
    app = CommZoo(COMM_N, tensor_maker(COMM_DTYPES[dtype_name], device),
                  redop=redop, integer=dtype_name == "int64",
                  shape=COMM_SHAPE)
    return app, run_world(PORT_FABRIC, app, COMM_N, COMM_M, COMM_STEPS,
                          kills=[COMM_KILL], topology=topology,
                          small_msg=COMM_SMALL_MSG)


def _exact(dtype_name, redop):
    """Whether every order of the reduction gives the same bits (then a
    ring or tree result equals the rank-order fold of reference_result)."""
    return redop == "max" or dtype_name == "int64"


def phase_comm(state):
    """Every collective on card tensors, n = 5 ranks of which 2 replicated,
    rank 1's computational worker killed mid-collective and repaired
    (drain, replay): results, sender logs, recovery counts and priced
    seconds bitwise equal to the same run on CPU tensors, and results
    bitwise equal to reference_result; then again with the fattree
    registry (trees, rings) and α‑β pricing."""
    t0 = time.perf_counter()
    counts = {"worlds": 0, "results": 0, "messages": 0, "promotions": 0,
              "replays": 0, "duplicates_skipped": 0}
    comm_s = {}
    for topology in (None, "fattree"):
        for dtype_name in COMM_DTYPES:
            for redop in ("sum", "max"):
                app, card = comm_case("cuda", dtype_name, redop, topology)
                _, cpu = comm_case("cpu", dtype_name, redop, topology)
                where = f"{topology} {dtype_name} {redop}"
                for key in ("states", "logs", "comm_s", "promotions",
                            "replays", "duplicates_skipped"):
                    a, b = card[key], cpu[key]
                    if key == "states":
                        a, b = canon(a), canon(b)
                    if a != b:
                        raise AssertionError(f"comm {where}: {key} differs "
                                             f"between card and CPU")
                if card["promotions"] != 1 or card["replays"] == 0:
                    raise AssertionError(f"comm {where}: no repair "
                                         f"({card['promotions']} promotions, "
                                         f"{card['replays']} replays)")
                if topology is None or _exact(dtype_name, redop):
                    for r, st in card["states"].items():
                        want = [x for t in range(COMM_STEPS)
                                for x in app.expected(
                                    comm_lib.reference_result, r, t)]
                        if canon(st["outs"]) != canon(want):
                            raise AssertionError(f"comm {where}: rank {r} "
                                                 f"differs from "
                                                 f"reference_result")
                        counts["results"] += len(want)
                counts["worlds"] += 1
                for key in ("messages", "promotions", "replays",
                            "duplicates_skipped"):
                    counts[key] += card[key]
                if topology is not None:
                    comm_s[f"{dtype_name}.{redop}"] = sum(card["comm_s"])
    emit({"phase": "comm", "ranks": COMM_N, "replicated": COMM_M,
          "steps": COMM_STEPS, "ops": sorted(comm_lib.COLLECTIVE_OPS),
          "dtypes": sorted(COMM_DTYPES), "redops": ["sum", "max"],
          "kill": dict(zip(("step", "round", "worker"), COMM_KILL)),
          **counts, "card_equals_cpu": True,
          "priced_comm_s_fattree_model": comm_s,
          "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------- phase 2

def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _k1_shapes():
    """(rows, d) of every K1 call of the served paths, prefill (B x S
    rows) and decode (B rows): the residual norms at d 4096 and 3584, the
    Mamba out_norm at 7168, the qk-norm heads at 128, xlstm-350m's blocks
    at d 1024; whisper-tiny's encoder (B x 1500 frames) and decoder (B x
    its prompt) at d 384."""
    dq, dz, dh = QWEN.d_model, ZAMBA.d_model, QWEN.resolved_head_dim
    di = mamba2.dims(ZAMBA)[0]
    heads = (QWEN.n_heads, QWEN.n_kv_heads)
    return [(rows * m, d) for rows in (B * S, B)
            for m, d in [(1, dq), (1, dz), (1, di), (1, XLSTM.d_model)]
            + [(h, dh) for h in heads]] + _whisper_rows()


def _whisper_rows():
    dw = WHISPER.d_model
    return [(B * WHISPER.n_frames, dw), (B * WHISPER_PROMPT, dw), (B, dw)]


def _fused_shapes():
    """(rows, d) of the fused add + norm on the served paths."""
    return [(rows, d) for rows in (B * S, B)
            for d in (QWEN.d_model, ZAMBA.d_model, XLSTM.d_model)] + \
        _whisper_rows()


def _unaligned(gen, rows, d, dtype):
    """A [rows, d] view whose rows start one element past 16 bytes apart:
    the kernels' scalar path."""
    return _rand(gen, (rows, d + 1), dtype)[:, 1:]


def phase_rmsnorm(state):
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = worst_add = 0.0
    dq, dh, hq, hkv = (QWEN.d_model, QWEN.resolved_head_dim, QWEN.n_heads,
                       QWEN.n_kv_heads)
    # ragged row counts, widths of the generic kernels (a warp of 1, 2 or
    # 4 chunks a lane; 128 threads of 2; 256 threads of 2, 4 or 8) and a
    # row longer than registers hold
    other = [(B * S * hq + 5, dh), (1000 + 3, dq), (37, 200), (9, 1000),
             (5, 1600), (2, 2400), (3, 5600), (3, 40960)]
    for dtype in (torch.bfloat16, torch.float32):
        for rows, d in _k1_shapes() + other:
            x = _rand(gen, (rows, d), dtype)
            w = _rand(gen, (d,), dtype)
            y = rmsnorm(x, w, eps=1e-5)
            worst = max(worst, compare("rmsnorm", y, ref.rmsnorm_ref(x, w),
                                       dtype, rows=rows, d=d))
            # a fixed reduction order and no atomics: reruns are bitwise
            if not torch.equal(y, rmsnorm(x, w, eps=1e-5)):
                raise AssertionError(f"rmsnorm rerun differs: {rows}x{d}")
        # qk-norm heads sliced out of a fused [B, S, Hq + 2 Hkv, D] tensor:
        # a two-level strided row view, read without a copy
        fused = _rand(gen, (B, S, hq + 2 * hkv, dh), dtype)
        qv = fused[:, :, :hq]
        w = _rand(gen, (dh,), dtype)
        worst = max(worst, compare(
            "rmsnorm_strided_view", rmsnorm(qv, w), ref.rmsnorm_ref(qv, w),
            dtype, shape=list(qv.shape)))
        for rows, d in ((64, dq), (33, 130)):     # the scalar path
            x = _unaligned(gen, rows, d, dtype)
            w = _rand(gen, (d,), dtype)
            worst = max(worst, compare(
                "rmsnorm_unaligned", rmsnorm(x, w), ref.rmsnorm_ref(x, w),
                dtype, rows=rows, d=d))

        # the fused add + norm: s is bitwise the separate add; on aligned
        # rows y is bitwise the plain kernel's norm of s (the same
        # reduction); on the scalar path y is held to the plain version
        for rows, d in _fused_shapes() + other[1:]:   # no add at d 128
            x, r = _rand(gen, (rows, d), dtype), _rand(gen, (rows, d), dtype)
            w = _rand(gen, (d,), dtype)
            s, y = add_rmsnorm(x, r, w)
            if not torch.equal(s, x + r) or not torch.equal(y, rmsnorm(s, w)):
                raise AssertionError(f"add_rmsnorm {rows}x{d}: s or y is not "
                                     f"bitwise the unfused pair's")
            worst_add = max(worst_add, compare(
                "add_rmsnorm", y, ref.add_rmsnorm_ref(x, r, w)[1], dtype,
                rows=rows, d=d))
            again = add_rmsnorm(x, r, w)
            if not (torch.equal(s, again[0]) and torch.equal(y, again[1])):
                raise AssertionError(f"add_rmsnorm rerun differs: {rows}x{d}")
        x, r = _unaligned(gen, 64, dq, dtype), _unaligned(gen, 64, dq, dtype)
        w = _rand(gen, (dq,), dtype)
        s, y = add_rmsnorm(x, r, w)
        if not torch.equal(s, x + r):
            raise AssertionError("add_rmsnorm (scalar path): s differs")
        worst_add = max(worst_add, compare(
            "add_rmsnorm_unaligned", y, ref.add_rmsnorm_ref(x, r, w)[1],
            dtype, rows=64, d=dq))
    state["rmsnorm_err"] = worst
    state["add_rmsnorm_err"] = worst_add


# ---------------------------------------------------------------- phase 3

def _bshd(gen, b, s, h, d, dtype):
    """A [B, H, S, D] view of [B, S, H, D] storage (the model's layout)."""
    return _rand(gen, (b, s, h, d), dtype).transpose(1, 2)


def _whisper_k2_cases():
    """K2 at whisper-tiny's D 64, MHA (6 heads, group 1: the tensor-core
    kernel's unpaired-head items): the encoder's non-causal 1,500 x 1,500
    (a ragged last key tile, 1,500 = 23 x 64 + 28), the cross-attention
    of the trained 448-token text over the 1,500 frames, the decoder's
    causal 448 (its served prompt of 416 runs in the serve phase).

    The grids at batch 4 on the H100's 132 SMs (one CTA an SM). Forward:
    the encoder 576 items of 64 rows (flash_fwd64_tc, its 12 key tiles of
    128 shared 6 and 6 by the warpgroups) in 5 rounds; the cross 416 x
    1,500 96 items of 128 rows in 1 round on 96 SMs (the last span's 32
    rows leave its second warpgroup idle); causal 416 96 items
    (flash_fwd_tc<64>) in 1 round. Backward: dq at the encoder 576 items
    of 64 rows (the 24 key tiles shared 12 and 12) in 5 rounds, at 448 x
    1,500 and causal 448 96 items of 128 rows in 1 round; dk/dv at both
    non-causal shapes 288 items of 128 keys (flash_bwd_dkdv64_tc, a 64-key
    tile a warpgroup) in 3 rounds, causal 448 168 items of 64 keys
    (flash_bwd_dkdv_tc<64>) in 2 rounds."""
    w = dict(b=B, hq=WHISPER.n_heads, hkv=WHISPER.n_kv_heads,
             d=WHISPER.resolved_head_dim, window=0)
    return [dict(w, s=WHISPER.n_frames, causal=False),
            dict(w, s=448, skv=WHISPER.n_frames, causal=False),
            dict(w, s=448, causal=True)]


def phase_attention(state):
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [
        dict(b=B, hq=QWEN.n_heads, hkv=QWEN.n_kv_heads, s=S,
             d=QWEN.resolved_head_dim, causal=True, window=0,
             dtype=torch.bfloat16),                      # qwen3-8b prefill
        dict(b=B, hq=QWEN.n_heads, hkv=QWEN.n_kv_heads, s=S,
             d=QWEN.resolved_head_dim, causal=True, window=0,
             dtype=torch.float32),
        dict(b=2, hq=2, hkv=1, s=192, d=128, causal=True, window=0,
             dtype=torch.bfloat16),                      # ragged tail
        dict(b=1, hq=4, hkv=2, s=256, d=64, causal=True, window=128,
             dtype=torch.float32),                       # sliding window
        dict(b=1, hq=2, hkv=2, s=128, d=64, causal=False, window=0,
             dtype=torch.float32),                       # non-causal
        dict(b=1, hq=8, hkv=2, s=128, d=32, causal=True, window=0,
             dtype=torch.bfloat16),                      # D = 32, GQA 4x
        dict(b=2, hq=4, hkv=2, s=256, d=64, causal=True, window=0,
             dtype=torch.bfloat16),                      # D = 64, GQA 2x
        dict(b=B, hq=ZAMBA.n_heads, hkv=ZAMBA.n_kv_heads, s=S,
             d=ZAMBA.resolved_head_dim, causal=True, window=0,
             dtype=torch.bfloat16),                      # zamba2-7b prefill
        dict(b=B, hq=ZAMBA.n_heads, hkv=ZAMBA.n_kv_heads, s=S,
             d=ZAMBA.resolved_head_dim, causal=True, window=0,
             dtype=torch.float32),
        dict(b=1, hq=4, hkv=4, s=256, d=112, causal=True, window=64,
             dtype=torch.float32),                       # D = 112, window
        dict(b=1, hq=2, hkv=2, s=128, d=112, causal=False, window=0,
             dtype=torch.bfloat16),                      # D = 112, full
        # what the tensor-core kernel masks or pads: keys that end inside
        # a 64-key tile, a prompt shorter than a tile with D 112's padded
        # columns, a window edge inside a tile, no causal limit
        dict(b=2, hq=8, hkv=2, s=200, d=128, causal=True, window=0,
             dtype=torch.bfloat16),                      # ragged, GQA 4x
        dict(b=1, hq=2, hkv=2, s=40, d=112, causal=True, window=0,
             dtype=torch.bfloat16),                      # S < one tile
        dict(b=1, hq=4, hkv=4, s=256, d=112, causal=True, window=100,
             dtype=torch.bfloat16),                      # D = 112, window
        dict(b=1, hq=4, hkv=2, s=192, d=128, causal=False, window=0,
             dtype=torch.bfloat16),                      # non-causal
        # non-causal with Sq != Skv: llama-3.2-vision's cross-attention of
        # the prompt over its 1,600 image tokens, a ragged pair, f32
        dict(b=B, hq=VISION.n_heads, hkv=VISION.n_kv_heads, s=S,
             skv=VISION.n_image_tokens, d=VISION.resolved_head_dim,
             causal=False, window=0, dtype=torch.bfloat16),
        dict(b=1, hq=4, hkv=2, s=40, skv=1000, d=128, causal=False,
             window=0, dtype=torch.bfloat16),
        dict(b=1, hq=4, hkv=2, s=40, skv=1000, d=128, causal=False,
             window=0, dtype=torch.float32),
        dict(b=B, hq=VISION.n_heads, hkv=VISION.n_kv_heads, s=S,
             skv=VISION.n_image_tokens, d=VISION.resolved_head_dim,
             causal=False, window=0, dtype=torch.float32),
    ] + [dict(c, dtype=dt)
         for c in _whisper_k2_cases() + [_codeqwen_case(),
                                         _codeqwen_reduced_case()]
         for dt in (torch.bfloat16, torch.float32)]
    worst = 0.0
    for c in cases:
        skv = c.get("skv", c["s"])
        q = _bshd(gen, c["b"], c["s"], c["hq"], c["d"], c["dtype"])
        k = _bshd(gen, c["b"], skv, c["hkv"], c["d"], c["dtype"])
        v = _bshd(gen, c["b"], skv, c["hkv"], c["d"], c["dtype"])
        got = flash_attention(q, k, v, causal=c["causal"], window=c["window"])
        want = ref.flash_attention_ref(q, k, v, causal=c["causal"],
                                       window=c["window"])
        shape = {k_: v_ for k_, v_ in c.items() if k_ != "dtype"}
        worst = max(worst, compare("flash_attention", got, want, c["dtype"],
                                   **shape))
        # fixed launch configuration, no atomics: reruns are bitwise equal
        again = flash_attention(q, k, v, causal=c["causal"],
                                window=c["window"])
        if not torch.equal(got, again):
            raise AssertionError(f"flash attention rerun differs: {shape}")
    state["attention_err"] = worst


# ---------------------------------------------------------------- phase 4

def _mamba_inputs(gen, b, s, h, p, n, dtype):
    """x, B, C in ``dtype``; dt = softplus(noise) and da = -dt * exp(noise)
    in f32 (tests/test_kernels.py's sweep inputs)."""
    x, bm, cm = (_rand(gen, shape, dtype) for shape in
                 ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = F.softplus(_rand(gen, (b, s, h), torch.float32))
    da = -dt * torch.exp(_rand(gen, (h,), torch.float32) * 0.1)
    return x, bm, cm, dt, da


def _cuda_kernels(fn):
    """Names of the CUDA kernels that ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def phase_mamba_scan(state):
    gen = torch.Generator(device="cuda").manual_seed(4)
    bf, f32 = torch.bfloat16, torch.float32
    _, nh, p, n = mamba2.dims(ZAMBA)                    # 112 heads, 64, 64
    cases = [  # (b, s, h, p, n, chunk, input dtype, output dtype)
        (B, S, nh, p, n, ZAMBA.ssm_chunk, bf, f32),    # zamba2-7b prefill
        (B, S, nh, p, n, ZAMBA.ssm_chunk, bf, bf),
        (B, S, nh, p, n, ZAMBA.ssm_chunk, f32, f32),
        (1, 64, 2, 8, 4, 16, f32, f32),                 # the sweep shapes
        (2, 128, 3, 16, 8, 32, f32, f32),
        (1, 96, 1, 8, 16, 32, f32, f32),
        (2, 40, 4, 64, 16, 40, bf, f32),                # T = S < 128
        # what the tensor-core kernel tiles: chunk 64, P and N below 64,
        # a ragged T of 40 over several chunks, an odd head count
        (2, 256, 4, p, n, 64, bf, f32),
        (2, 128, 3, 32, 16, 64, bf, f32),
        (1, 120, 2, p, n, 40, bf, bf),
        (1, 256, 5, p, n, ZAMBA.ssm_chunk, bf, f32),
    ]
    worst = 0.0
    for b, s, h, p_, n_, chunk, dtype, out in cases:
        args = _mamba_inputs(gen, b, s, h, p_, n_, dtype)
        y, hf = mamba_chunk_scan(*args, chunk=chunk, out_dtype=out)
        wy, wh = ref.mamba_chunk_scan_ref(*args, out_dtype=out)
        shape = dict(x=[b, s, h, p_], n=n_, chunk=chunk,
                     out=str(out).replace("torch.", ""))
        tol = MAMBA_TOL if out == f32 else None
        worst = max(worst, compare("mamba_scan.y", y, wy, out, tol, **shape),
                    compare("mamba_scan.h", hf, wh, f32, MAMBA_TOL, **shape))
        again = mamba_chunk_scan(*args, chunk=chunk, out_dtype=out)
        if not (torch.equal(y, again[0]) and torch.equal(hf, again[1])):
            raise AssertionError(f"mamba scan rerun differs: {shape}")
    # the serve shape on more draws, each from its own seed: the margin
    # under the tolerance at this shape's 14.7M outputs (ROADMAP F4)
    for seed in SERVE_DRAWS:
        args = _mamba_inputs(torch.Generator(device="cuda").manual_seed(seed),
                             B, S, nh, p, n, bf)
        y, hf = mamba_chunk_scan(*args, chunk=ZAMBA.ssm_chunk, out_dtype=f32)
        wy, wh = ref.mamba_chunk_scan_ref(*args, out_dtype=f32)
        shape = dict(x=[B, S, nh, p], n=n, chunk=ZAMBA.ssm_chunk,
                     out="float32", draw=seed)
        worst = max(worst,
                    compare("mamba_scan.y", y, wy, f32, MAMBA_TOL, **shape),
                    compare("mamba_scan.h", hf, wh, f32, MAMBA_TOL, **shape))
    # the route by dtype, from the kernels a profiler trace names
    for dtype, tc in ((bf, True), (f32, False)):
        args = _mamba_inputs(gen, 1, 128, 2, p, n, dtype)
        names = [nm for nm in _cuda_kernels(lambda: mamba_chunk_scan(
            *args, chunk=64, out_dtype=f32)) if "mamba_ssd_scan" in nm]
        if len(names) != 1 or ("mamba_ssd_scan_tc" in names[0]) != tc:
            raise AssertionError(f"mamba scan {dtype} ran {names}")
        emit({"check": "mamba_scan.route", "dtype": str(dtype),
              "kernel": re.search(r"mamba_ssd_scan\w*<[^>]*>", names[0])[0],
              "ok": True})
    # the model's split views of its conv output, read through strides
    xbc = _rand(gen, (B, 128, nh * p + 2 * n), bf)
    x = xbc[..., :nh * p].reshape(B, 128, nh, p)
    bm, cm = xbc[..., nh * p:nh * p + n], xbc[..., nh * p + n:]
    _, _, _, dt, da = _mamba_inputs(gen, B, 128, nh, p, n, bf)
    got = mamba_chunk_scan(x, bm, cm, dt, da, chunk=64, out_dtype=f32)
    want = mamba_chunk_scan(x.contiguous(), bm.contiguous(), cm.contiguous(),
                            dt, da, chunk=64, out_dtype=f32)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("mamba scan on strided views differs")
    # the result does not depend on the chunking (summation order only)
    args = _mamba_inputs(gen, 1, 128, 2, 8, 8, f32)
    y32, h32 = mamba_chunk_scan(*args, chunk=32)
    y64, h64 = mamba_chunk_scan(*args, chunk=64)
    compare("mamba_scan.chunk_invariance.y", y32, y64, f32, (1e-5, 1e-5),
            chunks=[32, 64])
    compare("mamba_scan.chunk_invariance.h", h32, h64, f32, (1e-5, 1e-5),
            chunks=[32, 64])
    state["mamba_scan_err"] = worst


# ---------------------------------------------------------------- phase 5

def phase_reference(state):
    """The kernel path against the plain path on a small input: the
    reduced qwen3-8b in f32 with the same weights on the card (through
    the kernels) and on the CPU (through the plain versions, which the
    CPU tests hold against the JAX package). Prefill and 8 greedy decode
    steps; logits within 1e-3 (summation order only), tokens equal."""
    cfg = dataclasses.replace(get_arch("qwen3-8b").reduced(), dtype="float32")
    cpu = Transformer(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = Transformer(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 96), dtype=np.int32))
    lc, cc = cpu.prefill({"tokens": toks})
    lg, cg = gpu.prefill({"tokens": toks.cuda()})
    worst = float((lg.cpu() - lc).abs().max())
    pos = torch.full((2, 1), 96, dtype=torch.int32)
    for _ in range(8):
        tok = torch.argmax(lc[:, -1], -1)[:, None].to(torch.int32)
        if not torch.equal(tok, torch.argmax(lg[:, -1], -1)[:, None]
                           .to(torch.int32).cpu()):
            raise AssertionError("kernel path picked another token")
        lc, cc = cpu.decode_step(cc, tok, pos)
        lg, cg = gpu.decode_step(cg, tok.cuda(), pos.cuda())
        worst = max(worst, float((lg.cpu() - lc).abs().max()))
        pos = pos + 1
    emit({"check": "reduced_model_card_vs_cpu", "max_abs_err": worst,
          "atol": 1e-3, "ok": worst <= 1e-3})
    if worst > 1e-3:
        raise AssertionError(f"card and CPU logits differ by {worst}")


def phase_reference_zamba(state):
    """The same for the reduced zamba2-7b (7 blocks, window 64), through
    all three kernels on the card: a 96-token prompt (windowed prefill) and
    a 32-token one (the ring of 32 slots is overwritten from position 0 by
    decode, as in the reference), each with 8 greedy decode steps; logits
    within 1e-3, tokens equal."""
    cfg = dataclasses.replace(ZAMBA.reduced(), dtype="float32")
    cpu = Zamba(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = Zamba(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    worst = 0.0
    for s in (96, 32):
        reset_launches()
        toks = torch.as_tensor(np.random.default_rng(s).integers(
            0, cfg.vocab_size, (2, s), dtype=np.int32))
        lc, cc = cpu.prefill({"tokens": toks})
        lg, cg = gpu.prefill({"tokens": toks.cuda()})
        worst = max(worst, float((lg.cpu() - lc).abs().max()))
        pos = torch.full((2, 1), s, dtype=torch.int32)
        for _ in range(8):
            tok = torch.argmax(lc[:, -1], -1)[:, None].to(torch.int32)
            if not torch.equal(tok, torch.argmax(lg[:, -1], -1)[:, None]
                               .to(torch.int32).cpu()):
                raise AssertionError("kernel path picked another token")
            lc, cc = cpu.decode_step(cc, tok, pos)
            lg, cg = gpu.decode_step(cg, tok.cuda(), pos.cuda())
            worst = max(worst, float((lg.cpu() - lc).abs().max()))
            pos = pos + 1
        counts = read_launches()
        if min(counts.values()) == 0:
            raise AssertionError(f"a kernel was not launched: {counts}")
    emit({"check": "reduced_zamba_card_vs_cpu", "prompts": [96, 32],
          "decode_steps": 8, "max_abs_err": worst, "atol": 1e-3,
          "ok": worst <= 1e-3})
    if worst > 1e-3:
        raise AssertionError(f"card and CPU logits differ by {worst}")


def phase_reference_families(state):
    """The same for the reduced mixtral-8x7b (4 layers, 4 experts top-2,
    window 64; assignments dropped at capacity) and llama-3.2-vision-11b
    (2 groups of 1 cross + 2 self layers; random image embeddings and
    nonzero gates, so the cross-attention counts, K2 non-causal at
    Sq 32 x Skv 16 on the card): a 32-token prompt and 8 greedy decode
    steps each in f32; logits within 1e-3, tokens equal, K1 and K2
    launched."""
    worst = {}
    for arch in (MIXTRAL.name, VISION.name):
        cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
        cpu = Transformer(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        if cfg.family == "vlm":
            for i, cp in enumerate(cpu.cross):
                cp["gate"].fill_(0.5 - i)
        gpu = Transformer(cfg, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(4)
        batch = {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (2, 32), dtype=np.int32))}
        if cfg.family == "vlm":
            batch["image_embeds"] = torch.as_tensor(rng.standard_normal(
                (2, cfg.n_image_tokens, cfg.d_model), dtype=np.float32))
        reset_launches()
        lc, cc = cpu.prefill(batch)
        lg, cg = gpu.prefill({k: t.cuda() for k, t in batch.items()})
        err = float((lg.cpu() - lc).abs().max())
        pos = torch.full((2, 1), 32, dtype=torch.int32)
        for _ in range(8):
            tok = torch.argmax(lc[:, -1], -1)[:, None].to(torch.int32)
            if not torch.equal(tok, torch.argmax(lg[:, -1], -1)[:, None]
                               .to(torch.int32).cpu()):
                raise AssertionError(f"{arch}: kernel path picked another "
                                     f"token")
            lc, cc = cpu.decode_step(cc, tok, pos)
            lg, cg = gpu.decode_step(cg, tok.cuda(), pos.cuda())
            err = max(err, float((lg.cpu() - lc).abs().max()))
            pos = pos + 1
        counts = read_launches()
        if not (counts["add_rmsnorm"] and counts["flash_attention"]):
            raise AssertionError(f"{arch}: a kernel was not launched: "
                                 f"{counts}")
        worst[arch] = err
    emit({"check": "reduced_moe_vlm_card_vs_cpu", "prompt": 32,
          "decode_steps": 8, "max_abs_err": worst, "atol": 1e-3,
          "ok": max(worst.values()) <= 1e-3})
    if max(worst.values()) > 1e-3:
        raise AssertionError(f"card and CPU logits differ by {worst}")


# the card-vs-CPU check of whisper-tiny and xlstm-350m: each compared
# tensor within 1e-3 of its largest |value|. Whisper, the whole model: the
# kernels' f32 sums in another order, as the reduced checks (1e-3
# absolute there). xlstm, block by block: at full width the reference's
# sLSTM is chaotic (its r_gates are drawn with std H^-1/2 = 0.5 over dh =
# 256 terms; one-ulp noise in them moves a block's output by 9e-6 of its
# largest after 8 tokens, 5e-4 after 16, 43% after 32, on the CPU), and the
# mLSTM's copied bf16 rounding of its score tile turns last-bit
# differences into steps of 2^-8 of one term (one-ulp input noise moves a
# block's output by 1.2e-4 of its largest at 64 tokens, 5.2e-4 at 512), so
# summation-order differences between two devices compound through 24
# blocks into different streams. Each block on the card therefore starts
# from the CPU's stream and state (an 8-token prompt, then 4 decode
# steps), and the whole, unforced model's gap is reported beside it
FAMILY_REF_TOL = 1e-3
FAMILY_REF_PROMPT = {"audio": 64, "ssm": 8}


def _rel(got, want):
    return float((got.cpu() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def _xlstm_blocks(model):
    """The model's blocks in order: (kind, params)."""
    for group, sp in zip(model.mlstm, model.slstm):
        for mp in group:
            yield "m", mp
        yield "s", sp


def _xlstm_forced(cpu, gpu, tokens, n_decode):
    """xlstm-350m on the card block by block, each block given the CPU's
    stream (x, r) and, in decode, the CPU's state: the worst gap of any
    block's stream, output and state tensors and of the logits, each
    relative to its largest |value|, over the prompt and ``n_decode``
    teacher-forced steps."""
    cfg = cpu.cfg
    pairs = list(zip(_xlstm_blocks(cpu), _xlstm_blocks(gpu)))
    worst, states = 0.0, [None] * len(pairs)
    tok = tokens
    for step in range(1 + n_decode):
        x, r = mlayers.embed_lookup(cpu.embed, tok), None
        for i, ((kind, pc), (_, pg)) in enumerate(pairs):
            gpu_st = None if states[i] is None else {
                k: t.cuda() for k, t in states[i].items()}
            gx, gr = x.cuda(), None if r is None else r.cuda()
            if kind == "s":
                xc, oc, sc = xlstm_lib.slstm_block(cfg, pc, x, r,
                                                   state=states[i])
                xg, og, sg = xlstm_lib.slstm_block(cfg, pg, gx, gr,
                                                   state=gpu_st)
            elif step == 0:
                xc, oc, sc = xlstm_lib.mlstm_block(cfg, pc, x, r)
                xg, og, sg = xlstm_lib.mlstm_block(cfg, pg, gx, gr)
            else:
                xc, oc, sc = xlstm_lib.mlstm_decode_block(cfg, pc, x, r,
                                                          states[i])
                xg, og, sg = xlstm_lib.mlstm_decode_block(cfg, pg, gx, gr,
                                                          gpu_st)
            worst = max([worst, _rel(xg, xc), _rel(og, oc)]
                        + [_rel(sg[k], sc[k]) for k in sc])
            x, r, states[i] = xc, oc, sc
        _, hc = mlayers.add_rmsnorm(cpu.ln_f, x, r, cfg.norm_eps)
        _, hg = mlayers.add_rmsnorm(gpu.ln_f, x.cuda(), r.cuda(),
                                        cfg.norm_eps)
        lc = mlayers.unembed(cfg, cpu.embed, hc[:, -1:])
        worst = max(worst, _rel(mlayers.unembed(cfg, gpu.embed,
                                                     hg[:, -1:]), lc))
        tok = torch.argmax(lc[:, -1], -1)[:, None].to(torch.int32)
    return worst


def _whole_model(cpu, gpu, batch, n_decode):
    """Prefill and ``n_decode`` decode steps on both, teacher-forced by
    the CPU's greedy tokens: (the worst logit gap relative to the largest
    |logit|, whether the card's greedy tokens were the CPU's)."""
    lc, cc = cpu.prefill(batch)
    lg, cg = gpu.prefill({k: t.cuda() for k, t in batch.items()})
    worst, agree = _rel(lg, lc), True
    s = batch["tokens"].shape[1]
    pos = torch.full((2, 1), s, dtype=torch.int32)
    for _ in range(n_decode):
        tok = torch.argmax(lc[:, -1], -1)[:, None].to(torch.int32)
        agree &= bool(torch.equal(torch.argmax(lg[:, -1], -1).cpu(),
                                  tok[:, 0]))
        lc, cc = cpu.decode_step(cc, tok, pos)
        lg, cg = gpu.decode_step(cg, tok.cuda(), pos.cuda())
        worst = max(worst, _rel(lg, lc))
        pos = pos + 1
    return worst, agree


@torch.no_grad()
def phase_reference_audio_ssm(state):
    """whisper-tiny at full size with seeded random frames (its served
    path feeds zeros, so this is where the encoder and the
    cross-attention run on the card on real inputs) and xlstm-350m at full
    size, both in f32, with the same weights on the card (through the
    kernels) and on the CPU (through the plain versions, which the CPU
    tests hold against the JAX package), batch 2, a prompt and 4 decode
    steps teacher-forced by the CPU's greedy tokens: whisper's logits (a
    64-token prompt) within FAMILY_REF_TOL of the largest; xlstm (an
    8-token prompt) block by block from the CPU's stream and state
    (``_xlstm_forced``), every block's tensors and the logits within it,
    the unforced whole model's gap reported; K1 (and for whisper K2)
    launched."""
    lines = {}
    for cfg in (WHISPER, XLSTM):
        cfg = dataclasses.replace(cfg, dtype="float32")
        cpu = api.build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        gpu = api.build_model(cfg, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(12)
        s = FAMILY_REF_PROMPT[cfg.family]
        batch = {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (2, s), dtype=np.int32))}
        if cfg.family == "audio":
            batch["frames"] = torch.as_tensor(rng.standard_normal(
                (2, cfg.n_frames, cfg.d_model),
                dtype=np.float32)).to(torch.bfloat16)
        reset_launches()
        whole, agree = _whole_model(cpu, gpu, batch, 4)
        line = {"prompt": s, "whole_model_rel_err": whole,
                "whole_model_tokens_equal": agree}
        if cfg.family == "ssm":
            line["blockwise_rel_err"] = _xlstm_forced(cpu, gpu,
                                                      batch["tokens"], 4)
        line["gated_rel_err"] = line.get("blockwise_rel_err", whole)
        counts = read_launches()
        if not counts["rmsnorm"] or not counts["add_rmsnorm"] or (
                cfg.family == "audio" and not counts["flash_attention"]):
            raise AssertionError(f"{cfg.name}: a kernel was not launched: "
                                 f"{counts}")
        lines[cfg.name] = {**line, "launches": counts}
        del cpu, gpu
        gc.collect()
        torch.cuda.empty_cache()
    worst = max(v["gated_rel_err"] for v in lines.values())
    emit({"check": "whisper_xlstm_card_vs_cpu", "dtype": "float32",
          "batch": 2, "decode_steps": 4, "frames": "seeded random",
          "by_arch": lines, "rtol_of_largest": FAMILY_REF_TOL,
          "ok": worst <= FAMILY_REF_TOL})
    if worst > FAMILY_REF_TOL:
        raise AssertionError(f"card and CPU differ: {lines}")


# ---------------------------------------------------------------- phase 6

def _state_tensors(tree):
    out = []
    tree_map(lambda leaf: out.append(leaf)
             if isinstance(leaf, torch.Tensor) else None, tree)
    return out


def expected_launches(cfg):
    """Launches of each kernel in one serve phase: 3 prefills (clean,
    killed, unreplicated) and the decode steps (clean 2 x GEN, the replica
    re-executing; killed 2 x KILL_AT + the rest; unreplicated KILL_AT).
    Every norm after a residual add is the fused ``add_rmsnorm``; the
    first norm of a forward, when no branch output is pending, and the
    norms inside a branch (the qk-norms, where ``cfg.qk_norm``) are
    plain."""
    prefills = 3
    decodes = 2 * GEN + (2 * KILL_AT + GEN - KILL_AT) + KILL_AT
    fwds = prefills + decodes
    if cfg.family == "audio":
        # the encoder runs at prefill only: its first ln1 plain, the other
        # ln1, every ln2 and ln_enc fused (2 x 4); the decoder's first ln1
        # plain, the other ln1, every ln_x and ln2 and ln_f fused (3 x 4);
        # K2 a prefill: 4 encoder, 4 causal, 4 cross (decode's attention
        # is plain)
        enc, dec = cfg.n_encoder_layers, cfg.n_layers
        return {"rmsnorm": 2 * prefills + decodes,
                "add_rmsnorm": (2 * enc + 3 * dec) * prefills
                + 3 * dec * decodes,
                "flash_attention": (enc + 2 * dec) * prefills,
                "mamba_scan": 0}
    if cfg.family == "ssm":
        # the first block's ln plain; every other block's ln and ln_f
        # fused (24 for xlstm-350m); no attention
        return {"rmsnorm": fwds, "add_rmsnorm": cfg.n_layers * fwds,
                "flash_attention": 0, "mamba_scan": 0}
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        # plain: the first attn_ln, each block's out_norm; fused: the
        # other attn_ln, each attn_mlp_ln, each block's ln, ln_f (189 in
        # all for zamba2-7b)
        return {"rmsnorm": (1 + cfg.n_layers) * fwds,
                "add_rmsnorm": (2 * groups + cfg.n_layers) * fwds,
                "flash_attention": groups * prefills,
                "mamba_scan": cfg.n_layers * prefills}
    if cfg.family == "vlm":
        groups = cfg.n_layers // cfg.cross_attn_every
        # the cross layer has no pre-norm (the pending r is added into the
        # stream before it, a plain add) and its output is pending at
        # every first ln1, so every ln1, ln2 and ln_f is fused (81 for
        # llama-3.2-vision-11b, which has no qk-norms). K2: every self
        # layer and every cross layer of a prefill (the decode's
        # cross-attention is plain, as its self-attention is)
        return {"rmsnorm": 0,
                "add_rmsnorm": (2 * cfg.n_layers + 1) * fwds,
                "flash_attention": (cfg.n_layers + groups) * prefills,
                "mamba_scan": 0}
    # dense and MoE: plain, the first ln1 and the qk-norms; fused, the
    # other ln1, ln2, ln_f (145 in all for qwen3-8b, 33 for mixtral-8x7b
    # at 16 layers)
    qk = 2 if cfg.qk_norm else 0
    return {"rmsnorm": (1 + qk * cfg.n_layers) * fwds,
            "add_rmsnorm": 2 * cfg.n_layers * fwds,
            "flash_attention": cfg.n_layers * prefills, "mamba_scan": 0}


def expected_k2_shapes(cfg, prompt_len=S):
    """K2's launches in one serve phase by (Sq, Skv, causal): the prompt's
    self-attention, for the VLM each cross layer's prompt over the image
    memory, for whisper its encoder over the frames and each decoder
    layer's prompt over them."""
    total = expected_launches(cfg)["flash_attention"]
    if cfg.family == "audio":
        m = cfg.n_frames
        return {(m, m, False): cfg.n_encoder_layers * 3,
                (prompt_len, prompt_len, True): cfg.n_layers * 3,
                (prompt_len, m, False): cfg.n_layers * 3}
    if not total:
        return {}
    if cfg.family != "vlm":
        return {(S, S, True): total}
    cross = cfg.n_layers // cfg.cross_attn_every * 3
    return {(S, S, True): total - cross,
            (S, cfg.n_image_tokens, False): cross}


FANOUT_CALLS = 7


def fanout_line(card_name, arch, srv, prompts, device="cuda"):
    """The request-batch fan-out: the server's own log (one bcast per
    ``generate``, send-IDs 0, 1, ... in order, each entry for the serving
    rank), then ``FANOUT_CALLS`` more fan-outs of the device batch through
    a fattree-priced ``BatchFanout``: both received copies equal, each in
    storage of its own (apart from each other and from the logged copy),
    the cmp copy equal to the batch, the median host ms of a call (to the
    device's end) and the priced comm seconds of one (the α‑β model's, not
    a measurement)."""
    log = srv.fanout.transport.send_logs[BatchFanout.FRONTEND_RANK]
    entries = [(m.dst, m.tag, m.send_id, m.step) for m in log.log]
    want = [(BatchFanout.SERVE_RANK, TAG_BCAST, i, i)
            for i in range(len(entries))]
    if not entries or entries != want:
        raise AssertionError(f"fan-out log out of order: {entries}")
    batch = torch.as_tensor(prompts, device=device)
    fan = BatchFanout(True, FTConfig(mode="none", topology="fattree"))
    sync = torch.cuda.synchronize if batch.is_cuda else (lambda: None)
    host_ms, equal, own = [], True, True
    for _ in range(FANOUT_CALLS):
        sync()
        t0 = time.perf_counter()
        got = fan.fan_out(batch)
        sync()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        cmp_copy = fan.received[fan.rmap.cmp[BatchFanout.SERVE_RANK]]
        rep_copy = fan.received[fan.rmap.rep[BatchFanout.SERVE_RANK]]
        equal &= bool(torch.equal(cmp_copy, rep_copy)) and \
            bool(torch.equal(got, batch)) and got.device == batch.device
        logged = fan.transport.send_logs[BatchFanout.FRONTEND_RANK].log[-1]
        own &= len({x.untyped_storage().data_ptr()
                    for x in (cmp_copy, rep_copy, logged.payload)}) == 3
    if not equal:
        raise AssertionError("fan-out copies differ")
    if not own:
        raise AssertionError("fan-out copies share storage")
    sids = [m.send_id for m in
            fan.transport.send_logs[BatchFanout.FRONTEND_RANK].log]
    if sids != list(range(FANOUT_CALLS)):
        raise AssertionError(f"fan-out send-IDs out of order: {sids}")
    emit({"fanout": arch, "server_sends": log.recorded_msgs,
          "server_bytes": log.recorded_bytes,
          "server_send_ids": [e[2] for e in entries],
          "batch": list(batch.shape), "dtype": str(batch.dtype),
          "device": str(got.device), "copies_equal": equal,
          "copies_own_storage": own,
          "priced_sends": FANOUT_CALLS, "send_ids": sids,
          "bytes_per_send": log.log[0].nbytes(),
          "priced_comm_s_per_fanout_model": fan.clock.breakdown.comm
          / FANOUT_CALLS,
          "host_ms": statistics.median(host_ms), "host_ms_all": host_ms,
          "card": card_name})


def _server(cfg, replication=True, prompt_len=S):
    return ReplicatedServer(cfg, batch=B, prompt_len=prompt_len,
                            replication=replication, device="cuda")


def serve(state, cfg, prompt_len=S):
    """The replicated serving path of ``cfg`` at full size (width; depth
    as ``cfg`` has it) with ``prompt_len``-token prompts; leaves the
    server in ``state`` for the times that follow. The unreplicated server
    is built, killed and freed before the replicated one is built, so the
    card holds one copy of the weights at a time (mixtral-8x7b's 16
    layers are 47 GB)."""
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, prompt_len), dtype=np.int32)
    unreplicated = _server(cfg, replication=False, prompt_len=prompt_len)
    reset_launches()
    try:
        unreplicated.generate(prompts, GEN, kill_at=KILL_AT)
    except RuntimeError as e:
        fatal = str(e)
    else:
        raise AssertionError("an unreplicated kill did not raise")
    torch.cuda.synchronize()
    counts = read_launches()
    shapes = k2_by_shape()
    del unreplicated
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    srv = _server(cfg, prompt_len=prompt_len)
    torch.cuda.synchronize()
    build_line = {"phase": "serve.build", "arch": cfg.name,
                  "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                  "params": api.param_count(cfg), "dtype": cfg.dtype,
                  "seconds": time.perf_counter() - t0}
    if cfg.n_experts:
        build_line["active_params"] = api.param_count(cfg, active_only=True)
    emit(build_line)

    reset_launches()
    t0 = time.perf_counter()
    clean = srv.generate(prompts, GEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    clean_state = _state_tensors(srv.last_report.final_state["cache"])
    faulty = srv.generate(prompts, GEN, kill_at=KILL_AT)
    # the FT theorem on the whole state, not only the tokens: after the
    # promotion every tensor of the final state (KV rings, the VLM's cross
    # K/V and, for the hybrid, every Mamba h and conv) equals the clean
    # run's bit for bit
    faulty_state = _state_tensors(srv.last_report.final_state["cache"])
    state_equal = len(clean_state) == len(faulty_state) and all(
        torch.equal(a, b) for a, b in zip(clean_state, faulty_state))
    n_state = len(clean_state)
    del clean_state, faulty_state
    torch.cuda.synchronize()
    later = read_launches()
    counts = {k: counts[k] + later[k] for k in counts}
    shapes = dict(shapes + k2_by_shape())

    if clean.shape != (B, GEN) or clean.min() < 0 or \
            clean.max() >= cfg.vocab_size:
        raise AssertionError(f"bad token stream {clean.shape}")
    if not np.array_equal(clean, faulty) or not state_equal:
        raise AssertionError("token stream or state after failover differs")
    if srv.promotions != 1 or srv.failures != 1:
        raise AssertionError(f"promotions={srv.promotions} "
                             f"failures={srv.failures}")
    want = expected_launches(cfg)
    want_shapes = expected_k2_shapes(cfg, prompt_len)
    emit({"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers,
          "prompt_len": prompt_len, "tokens_equal": True,
          "state_equal": True,
          "state_tensors": n_state,
          "promotions": srv.promotions, "failures": srv.failures,
          "unreplicated_kill": fatal, "launches": counts,
          "launches_expected": want,
          "flash_attention_by_shape": _shape_rows(shapes),
          "flash_attention_by_shape_expected": _shape_rows(want_shapes),
          "first_tokens": clean[:, :8].tolist(),
          "clean_generate_s": wall,
          "clean_generate_tok_per_s": clean.size / wall,
          "card": state["card"]})
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    if shapes != want_shapes:
        raise AssertionError(f"K2 launches by shape {shapes}, expected "
                             f"{want_shapes}")
    fanout_line(state["card"], cfg.name, srv, prompts)
    state.setdefault("launches", {})[cfg.name] = counts
    state.setdefault("k2_shapes", {})[cfg.name] = shapes
    state["server"] = srv
    state["prompts"] = prompts
    state.setdefault("clean_tokens", {})[cfg.name] = clean
    state.setdefault("generate_tok_per_s", {})[cfg.name] = clean.size / wall


def phase_serve(state):
    serve(state, QWEN)


def phase_serve_zamba(state):
    serve(state, ZAMBA)


def phase_serve_mixtral(state):
    """mixtral-8x7b (16 layers, full width) served, then its times: K2 at
    its prefill shape (causal, window 4096) and the whole path."""
    serve(state, MIXTRAL)
    flush = _L2Flush()
    gen = torch.Generator(device="cuda").manual_seed(8)
    k2 = _attention_times(state["card"], flush, gen, MIXTRAL.n_heads,
                          MIXTRAL.n_kv_heads, MIXTRAL.resolved_head_dim,
                          window=MIXTRAL.sliding_window)
    _path_times(state, MIXTRAL, flush)
    state.setdefault("times", {})[MIXTRAL.name] = {"flash_attention": k2}
    _free_server(state)


def phase_serve_vlm(state):
    """llama-3.2-vision-11b (full size) served, then its times: K2 at its
    self-attention shape (causal) and at its cross-attention shape (the
    prompt over 1,600 image tokens, non-causal), and the whole path."""
    serve(state, VISION)
    flush = _L2Flush()
    gen = torch.Generator(device="cuda").manual_seed(9)
    hq, hkv, dh = (VISION.n_heads, VISION.n_kv_heads,
                   VISION.resolved_head_dim)
    k2 = _attention_times(state["card"], flush, gen, hq, hkv, dh)
    k2_cross = _attention_times(state["card"], flush, gen, hq, hkv, dh,
                                skv=VISION.n_image_tokens, causal=False)
    _path_times(state, VISION, flush)
    state.setdefault("times", {})[VISION.name] = {
        "flash_attention": k2, "flash_attention_cross": k2_cross}
    _free_server(state)


# ------------------------------------------------------ phase 6b: serve.ckpt

# (mode, kills, checkpoint interval): the reference's own store tests
# (tests/test_store.py::test_session_pair_death_memory_backend_bitwise and
# ::test_session_checkpoint_only_memory_backend); 8 logical ranks, 4 a node
CKPT_RUNS = (("combined", {4: [1], 8: [9]}, 4.0),     # promote, pair death
             ("checkpoint", {7: [2]}, 3.0))           # unreplicated death
CKPT_RANKS, CKPT_PER_NODE = 8, 4


@contextlib.contextmanager
def _backend_timer():
    """Wall ms of every ``MemBackend`` save and restore in the block (the
    card synchronised around each), and the devices of each restored
    state's tensors at the moment it is restored."""
    saves, restores = [], []
    save, restore = MemBackend.save, MemBackend.restore

    def timed_save(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = save(self, *args, **kw)
        saves.append(1e3 * (time.perf_counter() - t0))
        return out

    def timed_restore(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = restore(self, *args, **kw)
        torch.cuda.synchronize()
        restores.append({"ms": 1e3 * (time.perf_counter() - t0),
                         "devices": sorted({t.device.type for t in
                                            _state_tensors(out[0])})})
        return out

    MemBackend.save, MemBackend.restore = timed_save, timed_restore
    try:
        yield saves, restores
    finally:
        MemBackend.save, MemBackend.restore = save, restore


def _held_bytes(store):
    """Host bytes of the distinct band arrays the store holds, by
    generation, and how many references (owner-local and partner copies)
    point at them: a band is one frozen array however many workers keep
    it."""
    arrays, refs = {}, {}
    for ws in store.stores.values():
        for (_owner, gen), ss in ws.items():
            for band in ss.bands.values():
                arrays.setdefault(gen, {})[id(band)] = band.nbytes
                refs[gen] = refs.get(gen, 0) + 1
    return ({str(g): sum(a.values()) for g, a in sorted(arrays.items())},
            {str(g): refs[g] for g in sorted(refs)},
            {str(g): len(a) for g, a in sorted(arrays.items())})


def _state_nbytes(state):
    return sum(t.numel() * t.element_size() for t in _state_tensors(state))


def serve_ckpt(state, cfg):
    """The served decode loop of ``cfg`` at full size under the checkpoint
    strategies (CKPT_RUNS): each restart restores from partner memory onto
    the card and the stream equals the clean one bitwise."""
    srv, prompts = state["server"], state["prompts"]
    clean = state["clean_tokens"][cfg.name]
    runs = []
    for mode, kills, interval in CKPT_RUNS:
        session = FTSession(ft=FTConfig(mode=mode, ckpt_backend="memory",
                                        ckpt_interval_s=interval),
                            injector=dict(kills),
                            n_logical_workers=CKPT_RANKS,
                            workers_per_node=CKPT_PER_NODE)
        reset_launches()
        t0 = time.perf_counter()
        with _backend_timer() as (saves, restores):
            rep = session.run(srv.workload(prompts), GEN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        toks = DecodeWorkload.tokens(rep.final_state)
        restart = [e.detail["restore_backend"] for e in rep.events
                   if e.kind == "restart_elastic"]
        store = session.strategy.backend.store
        held, refs, arrays = _held_bytes(store)
        row = {"mode": mode, "kills": {str(k): v for k, v in kills.items()},
               "ckpt_interval_s": interval, "promotions": rep.promotions,
               "restarts": rep.restarts, "failures": rep.failures,
               "rolled_back_steps": rep.rolled_back_steps,
               "ckpt_writes": rep.ckpt_writes, "restore_backend": restart,
               "tokens_equal": bool(np.array_equal(toks, clean)),
               "restored_devices": [r["devices"] for r in restores],
               "state_tensor_bytes": _state_nbytes(rep.final_state),
               "store_committed_bytes": store.committed_bytes,
               "host_bytes_by_generation": held,
               "band_arrays_by_generation": arrays,
               "band_references_by_generation": refs,
               "save_ms": statistics.median(saves), "save_ms_all": saves,
               "restore_ms": [r["ms"] for r in restores],
               "ledger_ckpt_write_s_model": rep.time.ckpt_write,
               "ledger_restore_s_model": rep.time.restore,
               "launches": launches, "wall_s": wall,
               "host_max_rss_gb": resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}
        runs.append(row)
        if rep.restarts != 1 or restart != ["memory"]:
            raise AssertionError(f"{cfg.name} {mode}: restarts "
                                 f"{rep.restarts}, restore {restart}")
        if not row["tokens_equal"]:
            raise AssertionError(f"{cfg.name} {mode}: the stream after the "
                                 f"restart differs from the clean one")
        if [r["devices"] for r in restores] != [["cuda"]]:
            raise AssertionError(f"{cfg.name} {mode}: restored state on "
                                 f"{row['restored_devices']}")
        if mode == "combined" and (rep.promotions != 1
                                   or rep.rolled_back_steps <= 0):
            raise AssertionError(f"{cfg.name} combined: promotions "
                                 f"{rep.promotions}, rolled back "
                                 f"{rep.rolled_back_steps}")
        if min(launches[k] for k in ("rmsnorm", "flash_attention")) == 0 or \
                (cfg.family == "hybrid" and launches["mamba_scan"] == 0):
            raise AssertionError(f"{cfg.name} {mode}: a kernel of the path "
                                 f"was not launched: {launches}")
        del session, rep, store
        gc.collect()
    emit({"serve.ckpt": cfg.name, "ranks": CKPT_RANKS,
          "workers_per_node": CKPT_PER_NODE, "batch": B, "prompt_len": S,
          "gen": GEN, "runs": runs, "card": state["card"]})


def phase_serve_ckpt(state):
    serve_ckpt(state, QWEN)


def phase_serve_ckpt_zamba(state):
    serve_ckpt(state, ZAMBA)


# ------------------------------------------------------------ phase 6c: obs

TRACE_DIR = os.path.join(ROOT, "build", "traces")   # build/ is gitignored


class _TimedSteps:
    """A workload whose decode steps are each timed on the host, the card
    synchronised around each."""

    def __init__(self, inner):
        self.inner, self.ms = inner, []

    def init_state(self):
        return self.inner.init_state()

    def step(self, st, t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.inner.step(st, t)
        torch.cuda.synchronize()
        self.ms.append(1e3 * (time.perf_counter() - t0))
        return out


def _nested_and_closed(tracer):
    if tracer.open_spans():
        return False
    for s in tracer.spans:
        if not s.instant and s.dur is None:
            return False
        if s.parent >= 0:
            p = tracer.spans[s.parent]
            if p.tid != s.tid or s.ts < p.ts - 1e-9 or (
                    s.dur is not None and p.dur is not None
                    and s.ts + s.dur > p.ts + p.dur + 1e-9):
                return False
    return True


def phase_obs(state):
    """The full-width qwen3-8b replicated generate with a kill, served by a
    second server with a recorder and fattree pricing; the same generate
    on the server without one; then each server's decode steps timed,
    off and on in turns."""
    off = state["server"]
    prompts = state["prompts"]
    on = ReplicatedServer(QWEN.name, reduced=False, batch=B, prompt_len=S,
                          device="cuda", topology="fattree", obs=True)
    launches = {}
    for name, srv in (("off", off), ("on", on)):
        reset_launches()
        toks = srv.generate(prompts, GEN, kill_at=KILL_AT)
        torch.cuda.synchronize()
        launches[name] = read_launches()
        if not np.array_equal(toks, state["clean_tokens"][QWEN.name]):
            raise AssertionError(f"obs {name}: the stream differs")
    snap = on.last_report.obs_metrics
    tracer = on.obs.tracer
    c = snap["counters"]
    log = on.fanout.transport.send_logs[BatchFanout.FRONTEND_RANK]
    sent_bytes = log.log[-1].nbytes()
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, "obs_serve_trace.json")
    write_chrome_trace(path, tracer, snap)
    with open(path) as f:
        events = len(json.load(f)["traceEvents"])
    promote_arcs = [s for s in tracer.spans if s.name == "recovery.promote"]
    checks = {
        "spans_closed_and_nested": _nested_and_closed(tracer),
        "kills": c.get("failures.kills.worker") == 1,
        "promote_arc": len(promote_arcs) == 1
        and promote_arcs[0].dur is not None,
        "fanout_bytes": c.get("comm.bytes.coll.cmp") == log.recorded_bytes
        == sent_bytes == B * S * 4,
        "fanout_msgs": c.get("comm.msgs.coll.cmp") == log.recorded_msgs == 1,
        "link_heat": snap.get("links", {}).get("max_contended", {})
        .get("busy_s", 0) > 0,
        "launches_equal": launches["on"] == launches["off"],
    }
    timed = {"off": [], "on": []}
    for name in ("off", "on", "off", "on"):
        srv = off if name == "off" else on
        wl = _TimedSteps(srv.workload(prompts))
        srv.session(KILL_AT).run(wl, GEN)
        timed[name] += wl.ms
    emit({"obs": QWEN.name, "topology": "fattree", "checks": checks,
          "counters": {k: c[k] for k in sorted(c) if k.startswith(
              ("comm.", "failures.", "steps.", "collectives."))},
          "spans": len(tracer.spans), "trace_events": events,
          "trace": os.path.relpath(path, ROOT),
          "max_contended_link": snap["links"]["max_contended"],
          "launches_on": launches["on"], "launches_off": launches["off"],
          "decode_host_ms_on": statistics.median(timed["on"]),
          "decode_host_ms_off": statistics.median(timed["off"]),
          "decode_steps_timed": {k: len(v) for k, v in timed.items()},
          "card": state["card"]})
    if not all(checks.values()):
        raise AssertionError(f"obs checks failed: {checks}")
    del on
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------- phase 6d: store

STORE_N, STORE_PER_NODE, STORE_K = 4, 2, 2


def _store_world():
    rmap = ReplicaMap(STORE_N, STORE_N)
    topo = ClusterTopology(rmap.world_size, STORE_PER_NODE)
    t = comm_lib.ReplicaTransport(rmap, STORE_N)
    for w in rmap.alive():
        t.register(w)
    return topo, MemStore(t, topo, k_partners=STORE_K, n_bands=4)


def _store_kill(store, workers):
    try:
        store.transport.rmap.fail_many(list(workers))
    except ApplicationDead:
        pass
    for w in workers:
        store.lose_worker(w)


def _store_respawn(store, topo):
    rmap = store.transport.rmap.restart_map(store.transport.rmap.world_size)
    t = comm_lib.ReplicaTransport(rmap, STORE_N)
    for w in rmap.alive():
        t.register(w)
    store.rebind(topology=topo, transport=t)


def _encode_ranks(cache):
    """Rank r's payload: the host form of layers r, r + n, ... of the
    cache (one device-to-host copy per tensor), and its manifest."""
    out = {r: to_host(cache[r::STORE_N]) for r in range(STORE_N)}
    return ({r: host for r, (host, _) in out.items()},
            {r: man for r, (_, man) in out.items()})


def _restore_equal(store, manifests, want, like):
    """Restore the store's durable generation onto the card and compare
    every tensor with ``want``'s bitwise; returns (step, equal, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, step = store.restore()
    tensors = [from_host(got[r], manifests[r], like[r::STORE_N])
               for r in range(STORE_N)]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    a = [t for r in range(STORE_N) for t in _state_tensors(tensors[r])]
    b = [t for r in range(STORE_N) for t in _state_tensors(want[r::STORE_N])]
    equal = len(a) == len(b) and all(
        x.is_cuda and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(a, b))
    return step, equal, ms


def phase_store(state):
    """One MemStore world over qwen3-8b's prefill KV rings on the card."""
    srv, prompts = state["server"], state["prompts"]
    wl = srv.workload(prompts)
    st = wl.init_state()
    cache_a = copy_tree(st["cache"])            # generation 1's state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host_a, man_a = _encode_ranks(cache_a)
    encode_ms = 1e3 * (time.perf_counter() - t0)
    topo, base = _store_world()
    # the save's three phases: encode + CRC + push, partner intake (CRC
    # of every received band set) + acks, commit
    save_ms = {}
    t0 = time.perf_counter()
    gen = base.begin_save(5, host_a)
    save_ms["begin_save"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    base.pump()
    save_ms["pump"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    if not base.try_commit(gen):
        raise AssertionError("store: the first generation did not commit")
    save_ms["try_commit"] = 1e3 * (time.perf_counter() - t0)
    held, refs, _ = _held_bytes(base)
    # every combination of f <= k node or pair deaths
    rmap = base.transport.rmap
    units = [tuple(topo.workers_on(nd)) for nd in range(topo.n_nodes)]
    units += [(rmap.cmp[r], rmap.rep[r]) for r in range(STORE_N)]
    combos, restore_ms = 0, []
    for f in range(1, STORE_K + 1):
        for combo in itertools.combinations(units, f):
            store = copy.deepcopy(base)          # host bands only
            dead = sorted(set(itertools.chain.from_iterable(combo)))
            _store_kill(store, dead)
            _store_respawn(store, topo)
            step, equal, ms = _restore_equal(store, man_a, cache_a,
                                             st["cache"])
            if step != 5 or not equal:
                raise AssertionError(f"store: {combo} restored step {step}, "
                                     f"bitwise {equal}")
            combos += 1
            restore_ms.append(ms)
    # a pair death mid-commit: generation 2 is abandoned, 1 restores
    st, _ = wl.step(st, 0)                       # writes the ring in place
    host_b, _ = _encode_ranks(st["cache"])
    topo, store = _store_world()
    store.save(4, host_a)
    gen2 = store.begin_save(8, host_b)
    partner = store.placement.partners_of(0)[0]
    _store_kill(store, [partner, partner + STORE_N])
    store.pump()
    committed = store.try_commit(gen2)
    _store_respawn(store, topo)
    step, mid_equal, _ = _restore_equal(store, man_a, cache_a, st["cache"])
    if committed or step != 4 or not mid_equal:
        raise AssertionError(f"store mid-commit: committed {committed}, "
                             f"step {step}, bitwise {mid_equal}")
    # more than k failure domains: rank 0's pair and its partners' pairs
    topo, store = _store_world()
    store.save(1, host_a)
    victims = [w for r in (0,) + store.placement.partners_of(0)
               for w in (r, r + STORE_N)]
    _store_kill(store, victims)
    _store_respawn(store, topo)
    try:
        store.restore()
    except StoreUnrecoverable:
        unrecoverable = True
    else:
        unrecoverable = False
    emit({"phase": "store", "ranks": STORE_N, "replicated": STORE_N,
          "workers_per_node": STORE_PER_NODE, "k": STORE_K,
          "state": f"{QWEN.name} prefill KV rings, layers r::{STORE_N}",
          "state_tensor_bytes": _state_nbytes(cache_a),
          "store_bytes": base.committed_bytes,
          "host_bytes_by_generation": held,
          "band_references_by_generation": refs,
          "f_le_k_combos_bitwise": combos, "mid_commit_restored_step": step,
          "mid_commit_bitwise": mid_equal,
          "more_than_k_raises": unrecoverable,
          "encode_ms": encode_ms, "save_ms": save_ms,
          "restore_ms_median": statistics.median(restore_ms),
          "card": state["card"]})
    if not unrecoverable:
        raise AssertionError("store: more than k domains lost did not raise")
    del cache_a, st, host_a, host_b, base, store
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 7

class _L2Flush:
    """Writes 128 MB between timed runs so no run finds its inputs in the
    50 MB L2 left there by the previous one."""

    def __init__(self):
        self.buf = torch.empty(32 * 2 ** 20, dtype=torch.float32,
                               device="cuda")

    def __call__(self):
        self.buf.zero_()


def time_ms(fn, flush, reps=25, warmup=3):
    """Median CUDA-event time of ``fn`` over ``reps`` runs, L2 flushed
    before each. A ~1 ms device-side spin after the flush lets the host
    enqueue ``fn`` before the start event fires, so a kernel's time is the
    device's and not the wrapper's Python overhead; a ``fn`` that takes the
    host longer than that to enqueue (the whole prefill) is timed with its
    host time, as a caller sees it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_split(fn, calls=10):
    """Mean device ms of one launch of each CUDA kernel that ``fn``
    launches (each once a call), over the launches that a
    ``torch.profiler`` trace of ``calls`` calls holds: a trace can miss
    some launches of kernels started through ctypes, so the mean is taken
    per launch seen, not per call (empty if the trace has no device
    time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, seen = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us > 0:   # "void ns::name<args>(params)" -> "name<args>"
            head = ev.key.replace("(anonymous namespace)::", "")
            head = head.split("(")[0]
            base = head.split("<")[0].split("::")[-1].split()[-1]
            name = (base + head[len(head.split("<")[0]):])[:60]
            total[name] = total.get(name, 0.0) + us
            seen[name] = seen.get(name, 0) + ev.count
    return {name: total[name] / seen[name] / 1e3 for name in total}


def bound(work):
    """Least time (ms) on the card for a kernel's ``cost.Work`` (the bytes
    and operations that ``kernels/cost.py`` charges its arguments), and
    which of the two sets it."""
    return cost.bound(work)


def _rmsnorm_times(card_name, flush, calls, eps):
    """Kernel / plain / library times and bound of each call
    [(name, x, r, w)], and their sums (with each call's row under
    ``calls``). r None: ``rmsnorm(x)``, its library call ``F.rms_norm``;
    else the fused ``add_rmsnorm(x, r)``, whose library time is the two
    calls it replaces, ``x + r`` and ``F.rms_norm``."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    rows = {}
    for name, x, r, w in calls:
        d = x.shape[-1]
        if r is None:
            fns = (lambda: rmsnorm(x, w, eps=eps),
                   lambda: ref.rmsnorm_ref(x, w, eps=eps),
                   lambda: F.rms_norm(x, (d,), w, eps))
            work = cost.rmsnorm(x.shape, x.dtype)
        else:
            fns = (lambda: add_rmsnorm(x, r, w, eps=eps),
                   lambda: ref.add_rmsnorm_ref(x, r, w, eps=eps),
                   lambda: F.rms_norm(x + r, (d,), w, eps))
            work = cost.add_rmsnorm(x.shape, x.dtype)
        row = {"ms": time_ms(fns[0], flush),
               "plain_ms": time_ms(fns[1], flush),
               "library_ms": time_ms(fns[2], flush), **bound(work)}
        emit({"time": "rmsnorm" if r is None else "add_rmsnorm",
              "call": name, "shape": list(x.shape), **row,
              "card": card_name})
        rows[name] = row
        for key in tot:
            tot[key] += row[key]
    tot["bound_by"] = "bytes"
    tot["calls"] = rows
    return tot


def _launch_floor(card_name, flush):
    """The card's floor for one launch: an empty kernel (a device spin of
    0 cycles) timed as the kernels are."""
    ms = time_ms(lambda: torch.cuda._sleep(0), flush)
    emit({"time": "launch_floor", "ms": ms, "card": card_name})
    return ms


def _tally_host_us(card_name, x, w, eps):
    """Host microseconds of one call of K1's wrapper at a decode shape
    (the launch queued, not waited for) and of the launch tally's line
    alone (``calls[(shape, dtype)] += 1``, on a Counter of its own): what
    the tally adds to each launch on the host-bound decode path. Each the
    median of 5 loops of 2,000 calls."""
    tally = collections.Counter()

    def bump():
        tally[(x.shape, x.dtype)] += 1

    def loop(fn, n=2000):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = 1e6 * (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
        return us
    wrapper = statistics.median(loop(lambda: rmsnorm(x, w, eps=eps))
                                for _ in range(5))
    line = statistics.median(loop(bump) for _ in range(5))
    emit({"time": "launch_tally", "shape": list(x.shape),
          "wrapper_host_us": wrapper, "tally_host_us": line,
          "tally_share": line / wrapper, "card": card_name})


def _sdpa_ms(q, k, v, flush, deterministic, causal=True):
    """``scaled_dot_product_attention`` (GQA) with PyTorch's
    deterministic-algorithms switch set as asked: the serve phases run with
    it on, which steers SDPA to another backend than the default."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        return time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), flush)
    finally:
        torch.use_deterministic_algorithms(before)


def _attention_times(card_name, flush, gen, hq, hkv, dh, skv=S, causal=True,
                     window=0, sq=S):
    """K2 (the bf16 tensor-core kernel) at the prefill shape
    [B, hq, sq, dh] over ``skv`` keys (causal, or non-causal as the VLM's
    and whisper's cross-attention and whisper's encoder), beside its
    plain version and
    ``scaled_dot_product_attention`` (the yardstick, never called by the
    port): ``library_ms`` with PyTorch's default settings and
    ``library_deterministic_ms`` with the switch on, as the serve path
    runs. A window as wide as the prompt (mixtral's 4096) masks nothing
    more, so SDPA's causal call computes the same function."""
    if window and window < sq:
        raise ValueError("SDPA has no window narrower than the prompt")
    bf = torch.bfloat16
    q = _bshd(gen, B, sq, hq, dh, bf)
    k = _bshd(gen, B, skv, hkv, dh, bf)
    v = _bshd(gen, B, skv, hkv, dh, bf)
    kw = dict(causal=causal, window=window)
    k2 = {
        "shape": list(q.shape), "kv_heads": hkv, "skv": skv,
        "causal": causal, "window": window,
        "ms": time_ms(lambda: flash_attention(q, k, v, **kw), flush),
        "plain_ms": time_ms(
            lambda: ref.flash_attention_ref(q, k, v, **kw), flush),
        "library_ms": _sdpa_ms(q, k, v, flush, False, causal),
        "library_deterministic_ms": _sdpa_ms(q, k, v, flush, True, causal),
        **bound(cost.attention(B, hq, hkv, sq, skv, dh, bf, causal, window)),
    }
    emit({"time": "flash_attention", **k2, "card": card_name})
    return k2


def _path_times(state, cfg, flush, prefill_reps=20):
    """The whole path: the workload's prefill (the median of
    ``prefill_reps``), then its decode steps (one slice); the prefill
    logits must be finite of the expected shape."""
    srv = state["server"]
    wl = srv.workload(state["prompts"])
    prefill_ms = time_ms(wl.init_state, flush, reps=prefill_reps,
                         warmup=min(3, prefill_reps))
    logits, _ = srv.model.prefill(wl.batch)
    if logits.shape != (B, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} are "
                             f"not finite of the expected shape")
    st = wl.init_state()
    decode = []
    for t in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _ = wl.step(st, t)
        torch.cuda.synchronize()
        decode.append(time.perf_counter() - t0)
    decode_ms = 1e3 * statistics.median(decode)
    line = {"arch": cfg.name, "batch": B, "prompt_len": srv.prompt_len,
            "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
            "decode_tok_per_s": B / (decode_ms * 1e-3),
            "replicated_generate_tok_per_s":
                state["generate_tok_per_s"][cfg.name]}
    emit({"time": "serve_path", **line, "card": state["card"]})
    return line


def phase_serve_whisper(state):
    """whisper-tiny (full size; zero frames, as the reference's server
    feeds them) served with a 416-token prompt and GEN tokens, to its
    448-token text context, then its times: K1 at d 384 (the encoder's
    4 x 1,500 rows, the decoder's prompt rows, a decode step), K2 at its
    three prefill shapes (the encoder's 1,500 x 1,500 and the
    cross-attention's 416 x 1,500, non-causal; the decoder's causal 416),
    each beside SDPA, and the whole path (a ``times`` line)."""
    cfg, p = WHISPER, WHISPER_PROMPT
    serve(state, cfg, p)
    card_name = state["card"]
    flush = _L2Flush()
    gen = torch.Generator(device="cuda").manual_seed(13)
    model = state["server"].model
    enc, dec = model.enc_layers[0], model.dec_layers[0]
    d, m = cfg.d_model, cfg.n_frames

    def act(*shape):
        return _rand(gen, shape, torch.bfloat16)
    k1 = _rmsnorm_times(card_name, flush, [
        ("encoder add+ln2 d=384", act(B, m, d), act(B, m, d),
         enc["ln2"]["scale"]),
        ("encoder ln1 d=384", act(B, m, d), None, enc["ln1"]["scale"]),
        ("decoder add+ln_x d=384", act(B, p, d), act(B, p, d),
         dec["ln_x"]["scale"]),
        ("decode add+ln2 d=384", act(B, 1, d), act(B, 1, d),
         dec["ln2"]["scale"])], cfg.norm_eps)
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    k2_enc = _attention_times(card_name, flush, gen, hq, hkv, dh, skv=m,
                              causal=False, sq=m)
    k2 = _attention_times(card_name, flush, gen, hq, hkv, dh, skv=p, sq=p)
    k2_cross = _attention_times(card_name, flush, gen, hq, hkv, dh, skv=m,
                                causal=False, sq=p)
    path = _path_times(state, cfg, flush)
    times = {"rmsnorm": k1, "flash_attention_encoder": k2_enc,
             "flash_attention": k2, "flash_attention_cross": k2_cross,
             "path": path}
    state.setdefault("times", {})[cfg.name] = times
    emit({"times": cfg.name, "prefill_ms": path["prefill_ms"],
          "decode_ms_per_step": path["decode_ms_per_step"],
          "replicated_generate_tok_per_s":
              path["replicated_generate_tok_per_s"],
          "k1_ms": {c: r["ms"] for c, r in k1["calls"].items()},
          "k2_ms": {"encoder": k2_enc["ms"], "self": k2["ms"],
                    "cross": k2_cross["ms"]},
          "card": card_name})
    _free_server(state)


def phase_serve_xlstm(state):
    """xlstm-350m (full size) served under the same traffic as qwen3-8b
    (a 512-token prompt, GEN tokens), then its times: K1 at d 1024 (a
    block's fused add + ln at the prompt and at a decode step, the first
    block's plain ln) beside ``F.rms_norm``, and the whole path (a
    ``times`` line). The mLSTM and the sLSTM scan are plain PyTorch, as
    the reference's are jnp: no kernel of theirs to time."""
    cfg = XLSTM
    serve(state, cfg)
    card_name = state["card"]
    flush = _L2Flush()
    gen = torch.Generator(device="cuda").manual_seed(14)
    model = state["server"].model
    ln, d = model.mlstm[0][1]["ln"]["scale"], cfg.d_model

    def act(*shape):
        return _rand(gen, shape, torch.bfloat16)
    k1 = _rmsnorm_times(card_name, flush, [
        ("add+ln d=1024", act(B, S, d), act(B, S, d), ln),
        ("ln d=1024", act(B, S, d), None, ln),
        ("decode add+ln d=1024", act(B, 1, d), act(B, 1, d), ln)],
        cfg.norm_eps)
    # a prefill is ~0.6 s of host-bound sLSTM steps: 5 timed, not 20
    path = _path_times(state, cfg, flush, prefill_reps=5)
    state.setdefault("times", {})[cfg.name] = {"rmsnorm": k1, "path": path}
    emit({"times": cfg.name, "prefill_ms": path["prefill_ms"],
          "decode_ms_per_step": path["decode_ms_per_step"],
          "replicated_generate_tok_per_s":
              path["replicated_generate_tok_per_s"],
          "k1_ms": {c: r["ms"] for c, r in k1["calls"].items()},
          "card": card_name})
    _free_server(state)


def _free_server(state):
    """Drop the model's server before the next model is built."""
    del state["server"]
    gc.collect()
    torch.cuda.empty_cache()


def phase_times(state):
    card_name = state["card"]
    flush = _L2Flush()
    cfg = QWEN
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf = torch.bfloat16
    d, hq, hkv, dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim)
    lp = state["server"].model.layers[0]
    ln1, ln2 = lp["ln1"]["scale"], lp["ln2"]["scale"]
    qn, kn = lp["attn"]["q_norm"]["scale"], lp["attn"]["k_norm"]["scale"]

    def act(*shape):
        return _rand(gen, shape, bf)
    k1 = _rmsnorm_times(card_name, flush, [
        ("ln1", act(B, S, d), None, ln1), ("ln2", act(B, S, d), None, ln2),
        ("q_norm", act(B, S, hq, dh), None, qn),
        ("k_norm", act(B, S, hkv, dh), None, kn)], cfg.norm_eps)
    emit({"time": "rmsnorm", "call": "one prefill layer: ln1+ln2+q+k",
          **k1, "card": card_name})
    k1_fused = _rmsnorm_times(card_name, flush, [
        ("add+ln1", act(B, S, d), act(B, S, d), ln1),
        ("add+ln2", act(B, S, d), act(B, S, d), ln2),
        ("q_norm", act(B, S, hq, dh), None, qn),
        ("k_norm", act(B, S, hkv, dh), None, kn)], cfg.norm_eps)
    emit({"time": "rmsnorm", "call": "one prefill layer as served: "
          "add+ln1, add+ln2, q, k", **k1_fused, "card": card_name})
    k1_decode = _rmsnorm_times(card_name, flush, [
        ("ln1_decode", act(B, 1, d), None, ln1),
        ("q_norm_decode", act(B, 1, hq, dh), None, qn)], cfg.norm_eps)
    emit({"time": "rmsnorm", "call": "decode: ln1+q_norm", **k1_decode,
          "card": card_name})
    k1_decode_fused = _rmsnorm_times(card_name, flush, [
        ("add+ln1_decode", act(B, 1, d), act(B, 1, d), ln1),
        ("q_norm_decode", act(B, 1, hq, dh), None, qn)], cfg.norm_eps)
    emit({"time": "rmsnorm", "call": "decode as served: add+ln1, q_norm",
          **k1_decode_fused, "card": card_name})
    _launch_floor(card_name, flush)
    _tally_host_us(card_name, act(B, 1, d), ln1, cfg.norm_eps)
    k2 = _attention_times(card_name, flush, gen, hq, hkv, dh)
    _path_times(state, cfg, flush)
    state.setdefault("times", {})[cfg.name] = {"rmsnorm": k1,
                                               "flash_attention": k2}
    _free_server(state)


def phase_times_zamba(state):
    card_name = state["card"]
    flush = _L2Flush()
    cfg = ZAMBA
    gen = torch.Generator(device="cuda").manual_seed(6)
    bf, f32 = torch.bfloat16, torch.float32
    d = cfg.d_model
    d_inner, nh, p, n = mamba2.dims(cfg)
    model = state["server"].model
    blk = model.mamba[0][0]
    ln, on = blk["ln"]["scale"], blk["out_norm"]["scale"]
    aln, mln = model.attn_ln["scale"], model.attn_mlp_ln["scale"]

    def act(*shape):
        return _rand(gen, shape, bf)
    k1 = _rmsnorm_times(card_name, flush, [
        ("mamba.ln d=3584", act(B, S, d), None, ln),
        ("mamba.out_norm d=7168", act(B, S, d_inner), None, on)],
        cfg.norm_eps)
    emit({"time": "rmsnorm", "call": "one prefill Mamba block: ln+out_norm",
          **k1, "card": card_name})
    k1_fused = _rmsnorm_times(card_name, flush, [
        ("add+mamba.ln d=3584", act(B, S, d), act(B, S, d), ln),
        ("mamba.out_norm d=7168", act(B, S, d_inner), None, on)],
        cfg.norm_eps)
    emit({"time": "rmsnorm", "call": "one prefill Mamba block as served: "
          "add+ln, out_norm", **k1_fused, "card": card_name})
    k1_attn = _rmsnorm_times(card_name, flush, [
        ("attn_ln d=3584", act(B, S, d), None, aln),
        ("attn_mlp_ln d=3584", act(B, S, d), None, mln)], cfg.norm_eps)
    emit({"time": "rmsnorm", "call": "one attention application: "
          "attn_ln+attn_mlp_ln", **k1_attn, "card": card_name})
    k1_attn_fused = _rmsnorm_times(card_name, flush, [
        ("add+attn_ln d=3584", act(B, S, d), act(B, S, d), aln),
        ("add+attn_mlp_ln d=3584", act(B, S, d), act(B, S, d), mln)],
        cfg.norm_eps)
    emit({"time": "rmsnorm", "call": "one attention application as "
          "served: add+attn_ln, add+attn_mlp_ln", **k1_attn_fused,
          "card": card_name})
    k1_decode = _rmsnorm_times(card_name, flush, [
        ("mamba.ln_decode", act(B, 1, d), None, ln),
        ("mamba.out_norm_decode", act(B, 1, d_inner), None, on)],
        cfg.norm_eps)
    emit({"time": "rmsnorm", "call": "decode Mamba block: ln+out_norm",
          **k1_decode, "card": card_name})
    k1_decode_fused = _rmsnorm_times(card_name, flush, [
        ("add+mamba.ln_decode", act(B, 1, d), act(B, 1, d), ln),
        ("mamba.out_norm_decode", act(B, 1, d_inner), None, on)],
        cfg.norm_eps)
    emit({"time": "rmsnorm", "call": "decode Mamba block as served: "
          "add+ln, out_norm", **k1_decode_fused, "card": card_name})
    floor = _launch_floor(card_name, flush)
    k2 = _attention_times(card_name, flush, gen, cfg.n_heads,
                          cfg.n_kv_heads, cfg.resolved_head_dim)

    # K3 as the model calls it: bf16 x, B, C; f32 dt, da; y in f32
    T = cfg.ssm_chunk
    x, bm, cm, dt, da = _mamba_inputs(gen, B, S, nh, p, n, bf)
    k3 = {
        "ms": time_ms(lambda: mamba_chunk_scan(x, bm, cm, dt, da, chunk=T,
                                               out_dtype=f32), flush),
        "plain_ms": time_ms(lambda: ref.mamba_chunk_scan_ref(
            x, bm, cm, dt, da, out_dtype=f32), flush, reps=5, warmup=1),
        "library_ms": None,      # no single PyTorch call computes the scan
        **bound(cost.mamba_scan(B, S, nh, p, n, T, bf, f32)),
    }
    emit({"time": "mamba_scan", "shape": list(x.shape), "n": n, "chunk": T,
          **k3, "card": card_name})
    _path_times(state, cfg, flush)
    state.setdefault("times", {})[cfg.name] = {
        "rmsnorm": k1, "add_rmsnorm": k1_fused["calls"]["add+mamba.ln d=3584"],
        "flash_attention": k2, "mamba_scan": k3, "launch_floor_ms": floor}
    _free_server(state)


# --------------------------------------------------------- phase 8: train
# The backward kernels of K1, K2 and K3 (no TPU counterpart: the JAX
# package differentiates its jnp model), then qwen3-8b and zamba2-7b
# trained at full width.

BWD_KERNELS = {"rmsnorm_bwd": rmsnorm_bwd, "add_rmsnorm_bwd": add_rmsnorm_bwd,
               "flash_attention_bwd": flash_attention_bwd,
               "mamba_scan_bwd": mamba_chunk_scan_bwd}
# K3's backward: the launches of each route (csrc/mamba_scan_bwd.cu)
SCAN_BWD_ROUTES = {
    "bfloat16": ["scan_bwd_tc_states", "scan_bwd_tc_chunks", "scan_bwd_reduce"],
    "float32": ["scan_bwd_states", "scan_bwd_chunks", "scan_bwd_reduce"]}


def _k1_bwd_cases(gen, dtype):
    """(name, dy, x, ds, w) of the K1 backward checks: the train shape's
    qk-norm heads (d 128) and residual norms (d 4096), zamba2-7b's d 3584
    and its Mamba out_norm at d_inner 7168, whisper-tiny's d 384 (the
    encoder's 1,500 frames, the decoder's 448 tokens), xlstm-350m's d
    1024, a strided head view, unaligned rows and a ragged row count."""
    dq, dz, dh = QWEN.d_model, ZAMBA.d_model, QWEN.resolved_head_dim
    di = mamba2.dims(ZAMBA)[0]
    hq, hkv = QWEN.n_heads, QWEN.n_kv_heads
    cases = []
    dw, dx = WHISPER.d_model, XLSTM.d_model
    for shape in [(B, S, hq, dh), (B, S, hkv, dh), (B, S, dq), (B, S, dz),
                  (B, S, di), (1000 + 3, dq), (37, 200),
                  (B, WHISPER.n_frames, dw), (B, 448, dw), (B, S, dx)]:
        d = shape[-1]
        cases.append((shape, _rand(gen, shape, dtype), _rand(gen, shape, dtype),
                      _rand(gen, (d,), dtype)))
    fused = _rand(gen, (B, S, hq + 2 * hkv, dh), dtype)
    cases.append(("strided", _rand(gen, (B, S, hq, dh), dtype),
                  fused[:, :, :hq], _rand(gen, (dh,), dtype)))
    cases.append(("unaligned", _unaligned(gen, 64, dq, dtype),
                  _unaligned(gen, 64, dq, dtype), _rand(gen, (dq,), dtype)))
    return cases


def _scan_inputs(gen, b, s, h, p, n, dtype, fused=False):
    """x, B, C in ``dtype`` (with ``fused``, strided views of one
    [b, s, h p + 2 n] tensor, as the model splits its conv output), dt =
    softplus(noise) and da = -dt exp(0.1 noise) in f32."""
    if fused:
        xbc = _rand(gen, (b, s, h * p + 2 * n), dtype)
        x = xbc[..., :h * p].unflatten(-1, (h, p))
        bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    else:
        x, bm, cm = (_rand(gen, shape, dtype) for shape in
                     ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = F.softplus(_rand(gen, (b, s, h), torch.float32))
    da = -dt * torch.exp(_rand(gen, (h,), torch.float32) * 0.1)
    return x, bm, cm, dt, da


def _k3_bwd_cases():
    """(shape (b, s, h, p, n), chunk, dtype, dy dtype, dh given, x/B/C
    fused) of the K3 backward checks: zamba2-7b's train shape (x [4, 512,
    112, 64], N 64, chunk 128, x/B/C views of the conv output) in bf16 and
    f32, with and without a gradient of the final h; chunk 64 (dy in bf16);
    the reduced config's P 64 / N 16 / chunk 16; a ragged head count."""
    bf, f32 = torch.bfloat16, torch.float32
    _, nh, p, n = mamba2.dims(ZAMBA)
    train = (B, S, nh, p, n)
    return ([(train, ZAMBA.ssm_chunk, dt, f32, dh, True)
             for dt in (bf, f32) for dh in (False, True)]
            + [((2, 256, 3, 64, 64), 64, bf, bf, True, False),
               ((2, 64, 4, 64, 16), 16, f32, f32, True, False),
               ((2, 64, 4, 64, 16), 16, bf, f32, False, True),
               ((1, 256, 5, 64, 64), 128, bf, f32, True, False)])


def _vlm_cross_case():
    """The VLM's cross-attention in training: q [4, 32, 512, 128] over
    k/v [4, 8, 1600, 128] (the image memory), non-causal: D 128 rows that
    see every key. The grids on the H100's 132 SMs: forward 512 items of
    two heads' 64 rows (flash_fwd128_tc<false>, 13 key tiles of 128) in 4
    rounds; backward dk/dv 800 items of 64 keys (flash_bwd_dkdv128_tc, 32
    pairs shared 16 and 16 by the warpgroups) in 7 rounds, the seventh
    of 8 items, then dq 512 items (flash_bwd_dq128_tc, 25 key tiles)
    launched as its dependent, whose CTAs start on the SMs that seventh
    round leaves idle."""
    return dict(b=B, hq=VISION.n_heads, hkv=VISION.n_kv_heads, s=S,
                skv=VISION.n_image_tokens, d=VISION.resolved_head_dim,
                causal=False, window=0)


def _codeqwen_case():
    """codeqwen1.5-7b's causal MHA (32 q and 32 KV heads of 128), Fig 10's
    model. The forward's grid on the H100's 132 SMs: 512 items of 128 rows
    of one head (flash_fwd128_tc<true>, 1-4 key tiles of 128), the rows
    ascending round by round, 4 rounds."""
    return dict(b=B, hq=CODEQWEN.n_heads, hkv=CODEQWEN.n_kv_heads, s=S,
                d=CODEQWEN.resolved_head_dim, causal=True, window=0)


def _codeqwen_reduced_case():
    """codeqwen1.5-7b reduced at Fig 10's reference configuration (4 x 64):
    MHA, 4 q and 4 KV heads of 32 (group 1 at D 32)."""
    cfg = CODEQWEN.reduced()
    return dict(b=4, hq=cfg.n_heads, hkv=cfg.n_kv_heads, s=64,
                d=cfg.resolved_head_dim, causal=True, window=0)


def _k2_bwd_cases():
    cases = [
        dict(b=B, hq=QWEN.n_heads, hkv=QWEN.n_kv_heads, s=S,
             d=QWEN.resolved_head_dim, causal=True, window=0),  # qwen3-8b
        dict(b=B, hq=ZAMBA.n_heads, hkv=ZAMBA.n_kv_heads, s=S,
             d=ZAMBA.resolved_head_dim, causal=True, window=0),  # zamba2-7b
        _vlm_cross_case(), _codeqwen_case(), _codeqwen_reduced_case(),
        dict(b=2, hq=8, hkv=2, s=200, d=128, causal=True, window=0),
        dict(b=1, hq=4, hkv=2, s=256, d=64, causal=True, window=100),
        dict(b=1, hq=2, hkv=2, s=130, d=112, causal=False, window=0),
        dict(b=1, hq=8, hkv=2, s=40, d=32, causal=True, window=0),
    ] + _whisper_k2_cases()
    return [dict(c, dtype=dt) for c in cases
            for dt in (torch.bfloat16, torch.float32)]


def phase_train_kernels(state):
    """K1's two backward entries, K2's and K3's backward against autograd
    of their plain versions on the card, reruns bitwise; their ptxas lines
    (no spills); their times at the train shapes."""
    card_name = state["card"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    checks, worst = [], {name: 0.0 for name in BWD_KERNELS}

    def held(name, got, want, dtype, **shape):
        share = []
        for i, (g, w_) in enumerate(zip(got, want)):
            atol, rtol = TOL[dtype]
            if name != "flash_attention_bwd" and i == 1 and \
                    dtype == torch.float32:
                # K1's dw sums every row; each term carries its row's f32
                # rstd (2^-23 relative), so f32 errors grow as sqrt(rows)
                atol *= math.sqrt(got[0].numel() // got[0].shape[-1])
            err = compare(name, g, w_, dtype, tol=(atol, rtol), **shape)
            worst[name] = max(worst[name], err)
            share.append(float(((g.float() - w_.float()).abs()
                                / (atol + rtol * w_.float().abs())).max()))
        checks.append({"kernel": name, "dtype": str(dtype)[6:], **shape,
                       "share_of_tolerance": max(share)})

    for dtype in (torch.bfloat16, torch.float32):
        for shape, dy, x, w in _k1_bwd_cases(gen, dtype):
            tag = {"shape": shape if isinstance(shape, str)
                   else list(shape)}
            got = rmsnorm_bwd(dy, x, w)
            held("rmsnorm_bwd", got, ref.rmsnorm_bwd_ref(dy, x, w), dtype,
                 **tag)
            again = rmsnorm_bwd(dy, x, w)
            if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                raise AssertionError(f"rmsnorm_bwd rerun differs: {tag}")
            if x.shape[-1] == 128 and isinstance(shape, tuple):
                continue                 # no fused add at the head norms
            for ds in (_rand(gen, x.shape, dtype), None):
                got = add_rmsnorm_bwd(dy, ds, x, w)
                held("add_rmsnorm_bwd", got,
                     ref.add_rmsnorm_bwd_ref(dy, ds, x, w), dtype,
                     **tag, ds=ds is not None)
                again = add_rmsnorm_bwd(dy, ds, x, w)
                if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                    raise AssertionError(f"add_rmsnorm_bwd rerun differs: "
                                         f"{tag}")
        torch.cuda.empty_cache()
    for c in _k2_bwd_cases():
        dtype = c["dtype"]
        skv = c.get("skv", c["s"])
        q = _bshd(gen, c["b"], c["s"], c["hq"], c["d"], dtype)
        k = _bshd(gen, c["b"], skv, c["hkv"], c["d"], dtype)
        v = _bshd(gen, c["b"], skv, c["hkv"], c["d"], dtype)
        do = _bshd(gen, c["b"], c["s"], c["hq"], c["d"], dtype)
        mask = {"causal": c["causal"], "window": c["window"]}
        shape = {k_: v_ for k_, v_ in c.items() if k_ != "dtype"}
        # the forward's o against its plain version, its logsumexp (f32
        # sums in another order), and o the same bits with and without it
        o, lse = flash_attention(q, k, v, **mask, return_lse=True)
        compare("flash_attention", o, ref.flash_attention_ref(q, k, v, **mask),
                dtype, **shape)
        compare("flash_attention_lse", lse,
                ref.flash_attention_lse_ref(q, k, **mask), torch.float32,
                tol=LSE_TOL, **shape, of=str(dtype)[6:])
        if not torch.equal(o, flash_attention(q, k, v, **mask)):
            raise AssertionError(f"flash_attention: o differs with lse "
                                 f"asked: {shape}")
        got = flash_attention_bwd(q, k, v, o, do, lse, **mask)
        want = ref.flash_attention_bwd_ref(q, k, v, do, **mask)
        held("flash_attention_bwd", got, want, dtype, **shape)
        again = flash_attention_bwd(q, k, v, o, do, lse, **mask)
        if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd rerun differs: {shape}")
        del q, k, v, do, o, lse, got, want, again
        torch.cuda.empty_cache()
    for shape, chunk, dtype, dy_dtype, with_dh, fused in _k3_bwd_cases():
        b, s, h, p, n = shape
        x, bm, cm, dt, da = _scan_inputs(gen, *shape, dtype, fused)
        dy = _rand(gen, (b, s, h, p), dy_dtype)
        dh = _rand(gen, (b, h, p, n), torch.float32) if with_dh else None
        tag = {"shape": list(shape), "chunk": chunk, "dy": str(dy_dtype)[6:],
               "dh": with_dh, "fused": fused}
        got = mamba_chunk_scan_bwd(x, bm, cm, dt, da, dy, dh, chunk=chunk)
        want = ref.mamba_chunk_scan_bwd_ref(x, bm, cm, dt, da, dy, dh)
        share = {}
        for name, g, w_ in zip(("dx", "db", "dc", "ddt", "dda"), got, want):
            if g.dtype != w_.dtype or g.shape != w_.shape:
                raise AssertionError(f"mamba_scan_bwd {name}: {g.dtype} "
                                     f"{tuple(g.shape)} is not the plain "
                                     f"{w_.dtype} {tuple(w_.shape)}")
            atol, rtol = scan_bwd_tol(w_, g.dtype)
            err = compare("mamba_scan_bwd", g, w_, g.dtype, tol=(atol, rtol),
                          **tag, output=name)
            worst["mamba_scan_bwd"] = max(worst["mamba_scan_bwd"], err)
            share[name] = float(((g.float() - w_.float()).abs()
                                 / (atol + rtol * w_.float().abs())).max())
        again = mamba_chunk_scan_bwd(x, bm, cm, dt, da, dy, dh, chunk=chunk)
        if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
            raise AssertionError(f"mamba_scan_bwd rerun differs: {tag}")
        checks.append({"kernel": "mamba_scan_bwd", "dtype": str(dtype)[6:],
                       **tag, "share_of_tolerance": share})
        del x, bm, cm, dt, da, dy, dh, got, want, again
        torch.cuda.empty_cache()
    ptxas = [row for name in ("rmsnorm_bwd", "flash_attention_bwd",
                              "mamba_scan_bwd")
             for row in ptxas_report(name)]
    spilled = [row for row in ptxas
               if "spills" in row and not re.search(
                   r"0 bytes spill stores, 0 bytes spill loads",
                   row["spills"])]
    if spilled:
        raise AssertionError(f"ptxas spilled in a backward kernel: {spilled}")
    reported = [row["function"] for row in ptxas if "function" in row]
    unreported = [entry for route in SCAN_BWD_ROUTES.values()
                  for entry in route
                  if not any(f"::{entry}(" in f or f.startswith(f"{entry}(")
                             for f in reported)]
    if unreported:
        raise AssertionError(f"no ptxas line for {unreported}")
    times = _train_kernel_times(card_name, gen)
    state["train_kernels"] = {"worst": worst, "times": times}
    emit({"phase": "train.kernels", "checks": checks,
          "reruns_bitwise": True, "max_abs_err": worst, "ptxas": ptxas,
          "times": times, "card": card_name})


def _grad_ms(outputs, inputs, grads, flush):
    """Time of autograd's backward of a graph built once (the library
    yardstick of a backward kernel)."""
    return time_ms(lambda: torch.autograd.grad(outputs, inputs, grads,
                                               retain_graph=True), flush)


def _sdpa_bwd_ms(q, k, v, do, flush, deterministic, causal=True):
    """Backward of ``scaled_dot_product_attention`` (GQA) with the
    deterministic-algorithms switch as asked; None with PyTorch's reason
    where it refuses the combination."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                           enable_gqa=True)
        return _grad_ms([o], leaves, [do], flush), None
    except RuntimeError as e:
        return None, str(e).splitlines()[0]
    finally:
        torch.use_deterministic_algorithms(before)


def _train_kernel_times(card_name, gen):
    """CUDA-event medians (L2 flushed) of the backward kernels at the
    train shapes (qwen3-8b's for K1 and K2, zamba2-7b's out_norm for K1 at
    d 7168 and its scan for K3), beside their plain versions (autograd of
    the plain forward), their bounds and the PyTorch library backward."""
    flush = _L2Flush()
    bf = torch.bfloat16
    d, dh, hq, hkv = (QWEN.d_model, QWEN.resolved_head_dim, QWEN.n_heads,
                      QWEN.n_kv_heads)
    eps = QWEN.norm_eps
    rows = {}
    dw = WHISPER.d_model
    for call, shape, fused in [("add+ln", (B, S, d), True),
                               ("q_norm", (B, S, hq, dh), False),
                               ("k_norm", (B, S, hkv, dh), False),
                               ("out_norm", (B, S, mamba2.dims(ZAMBA)[0]),
                                False),
                               ("whisper enc add+ln d=384",
                                (B, WHISPER.n_frames, dw), True),
                               ("whisper dec add+ln d=384", (B, 448, dw),
                                True),
                               ("xlstm add+ln d=1024",
                                (B, S, XLSTM.d_model), True),
                               ("xlstm ln d=1024", (B, S, XLSTM.d_model),
                                False)]:
        x, dy = _rand(gen, shape, bf), _rand(gen, shape, bf)
        w = _rand(gen, (shape[-1],), bf)
        n = x.numel()
        if fused:
            ds = _rand(gen, shape, bf)
            r = _rand(gen, shape, bf)
            lx, lr, lw = (t.detach().requires_grad_(True) for t in (x, r, w))
            ls = lx + lr
            ly = F.rms_norm(ls, (shape[-1],), lw, eps)
            row = {"ms": time_ms(lambda: add_rmsnorm_bwd(dy, ds, x, w,
                                                         eps=eps), flush),
                   "plain_ms": time_ms(lambda: ref.add_rmsnorm_bwd_ref(
                       dy, ds, x, w, eps=eps), flush),
                   "library_ms": _grad_ms([ls, ly], [lx, lr, lw], [ds, dy],
                                          flush),
                   **bound(cost.add_rmsnorm_bwd(shape, bf))}
            name = "add_rmsnorm_bwd"
        else:
            lx, lw = (t.detach().requires_grad_(True) for t in (x, w))
            ly = F.rms_norm(lx, (shape[-1],), lw, eps)
            row = {"ms": time_ms(lambda: rmsnorm_bwd(dy, x, w, eps=eps),
                                 flush),
                   "plain_ms": time_ms(lambda: ref.rmsnorm_bwd_ref(
                       dy, x, w, eps=eps), flush),
                   "library_ms": _grad_ms([ly], [lx, lw], [dy], flush),
                   **bound(cost.rmsnorm_bwd(shape, bf))}
            name = "rmsnorm_bwd"
        row.update(kernel=name, call=call, shape=list(shape))
        emit({"time": name, **row, "card": card_name})
        rows[call] = row
    q, k, v, do = (_bshd(gen, B, S, h, dh, bf) for h in (hq, hkv, hkv, hq))
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    lib, lib_note = _sdpa_bwd_ms(q, k, v, do, flush, deterministic=False)
    lib_det, det_note = _sdpa_bwd_ms(q, k, v, do, flush, deterministic=True)
    row = {"kernel": "flash_attention_bwd", "shape": list(q.shape),
           "kv_heads": hkv,
           "ms": time_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse),
                         flush),
           "plain_ms": time_ms(lambda: ref.flash_attention_bwd_ref(
               q, k, v, do), flush),
           "library_ms": lib, "library_deterministic_ms": lib_det,
           "library_notes": [lib_note, det_note],
           **bound(cost.attention_bwd(B, hq, hkv, S, S, dh, bf))}
    emit({"time": "flash_attention_bwd", **row, "card": card_name})
    rows["attention"] = row
    del q, k, v, do, o, lse
    rows["attention_d64"] = [_k2_bwd_times(card_name, gen, flush, c)
                             for c in _whisper_k2_cases()]
    rows["attention_cross"] = _k2_bwd_times(card_name, gen, flush,
                                            _vlm_cross_case())
    rows["attention_mha"] = _k2_bwd_times(card_name, gen, flush,
                                          _codeqwen_case())
    rows["scan"] = _scan_bwd_times(card_name, gen, flush)
    return rows


def _k2_bwd_times(card_name, gen, flush, c):
    """K2's backward (bf16) at one train shape (whisper-tiny's, the VLM's
    cross-attention, codeqwen1.5-7b's MHA), beside
    its plain version, SDPA's backward and its bound (the visible pairs'
    five products of 2 D flops, or the bytes if they take longer)."""
    bf = torch.bfloat16
    sq, skv, causal = c["s"], c.get("skv", c["s"]), c["causal"]
    q, do = (_bshd(gen, c["b"], sq, c["hq"], c["d"], bf) for _ in range(2))
    k, v = (_bshd(gen, c["b"], skv, c["hkv"], c["d"], bf) for _ in range(2))
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    lib, lib_note = _sdpa_bwd_ms(q, k, v, do, flush, False, causal)
    lib_det, det_note = _sdpa_bwd_ms(q, k, v, do, flush, True, causal)
    row = {"kernel": "flash_attention_bwd", "shape": list(q.shape),
           "skv": skv, "kv_heads": c["hkv"], "causal": causal,
           "ms": time_ms(lambda: flash_attention_bwd(
               q, k, v, o, do, lse, causal=causal), flush),
           "plain_ms": time_ms(lambda: ref.flash_attention_bwd_ref(
               q, k, v, do, causal=causal), flush),
           "library_ms": lib, "library_deterministic_ms": lib_det,
           "library_notes": [lib_note, det_note],
           **bound(cost.attention_bwd(c["b"], c["hq"], c["hkv"], sq, skv,
                                      c["d"], bf, causal))}
    emit({"time": "flash_attention_bwd", **row, "card": card_name})
    return row


def scan_bwd_tc_macs(b, s, h, chunk):
    """Multiply-adds that the bf16 backward's wgmma passes issue (whole
    tiles, as the kernels loop). Per chunk, warpgroup r of
    scan_bwd_tc_chunks (if 64 r < chunk) runs B G^T and x G (2 passes
    each) and dy h (3) on 64 x 64 x 64 tiles, then on each causal
    32-column block (t >= 64 r in pass A, s < 64 (r + 1) in pass B) S^T or
    S (1 pass) and D^T or D (2) on 64 x 32 x 64 and dx's SE^T dy (3) and
    dB's K^T C (2), or dC's K B (2), on 64 x 64 x 32; scan_bwd_tc_states
    runs 2 passes of 64 x 64 x 128 a chunk and direction."""
    blocks = -(-chunk // 32)
    macs = 0
    for r in range(2):
        if 64 * r >= chunk:
            continue
        macs += (2 + 2 + 3) * 64 * 64 * 64
        macs += (blocks - 2 * r) * (3 * 64 * 32 * 64 + 5 * 64 * 64 * 32)
        macs += min(2 * r + 2, blocks) * (3 * 64 * 32 * 64 + 2 * 64 * 64 * 32)
    macs += 2 * 2 * 64 * 64 * 128
    return macs * (s // chunk) * b * h


def _scan_bwd_times(card_name, gen, flush):
    """K3's backward at zamba2-7b's train shape as the model calls it
    (bf16 x, B, C views of the conv output, f32 dt, da and dy, the final h
    unused), beside its plain version and its bound: by bytes (the bf16
    tensor-core kernels' operands), with the FP32-pipe bound of the same
    causal products, the TFLOP/s of the wgmma passes issued and the device
    time of each launch."""
    _, nh, p, n = mamba2.dims(ZAMBA)
    T = ZAMBA.ssm_chunk
    x, bm, cm, dt, da = _scan_inputs(gen, B, S, nh, p, n, torch.bfloat16,
                                     fused=True)
    dy = _rand(gen, (B, S, nh, p), torch.float32)
    work = cost.mamba_scan_bwd(B, S, nh, p, n, T, torch.bfloat16,
                               torch.float32)

    def call():
        return mamba_chunk_scan_bwd(x, bm, cm, dt, da, dy, chunk=T)
    ms = time_ms(call, flush)
    row = {"kernel": "mamba_scan_bwd", "shape": list(x.shape), "n": n,
           "chunk": T, "ms": ms,
           "plain_ms": time_ms(lambda: ref.mamba_chunk_scan_bwd_ref(
               x, bm, cm, dt, da, dy), flush, reps=5, warmup=1),
           # no single PyTorch call computes the SSD scan's gradient
           "library_ms": None,
           **bound(work),
           "bound_fp32_ms": bound(dataclasses.replace(
               work, dtype=torch.float32))["bound_ms"],
           "wgmma_tflops": 2 * scan_bwd_tc_macs(B, S, nh, T) / ms / 1e9,
           "kernels_ms": kernel_split(call)}
    emit({"time": "mamba_scan_bwd", **row, "card": card_name})
    return row



# 9 steps, not the reference's 12 (tests/test_ft_trainer.py, which the
# CPU tests keep): the least that holds the pair death at step 8; the
# combined runs then write two checkpoints after the baseline, not three,
# which saves a ~40 s save of a 16.3 GB state (14.5 GB for zamba2-7b)
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_LR, TRAIN_SEED = 2, 9, 1e-3, 0
# zamba2-7b's depth in training: two groups of 6 Mamba blocks behind the
# shared attention block, and a tail of 1
TRAIN_ZAMBA_BLOCKS = 13
# the disk runs' checkpoint directory (gitignored), emptied before and
# after the phase
TRAIN_CKPT = os.path.join(ROOT, "build", "train_ckpt")
# (mode, FTConfig fields, kills {step: [workers]}, checkpoints on disk):
# the reference's FT-theorem schedules (tests/test_ft_trainer.py:31-66)
TRAIN_RUNS = [
    ("none", dict(mode="none"), {}, False),
    ("replication", dict(mode="replication"), {5: [0]}, False),
    ("combined", dict(mode="combined", ckpt_interval_s=4.0),
     {4: [1], 8: [9]}, True),
    ("checkpoint", dict(mode="checkpoint", ckpt_interval_s=3.0),
     {7: [2]}, True),
]
# every model's on the card: the checkpoint schedule runs on the CPU only
# (tests/test_torch_train.py, tests/test_torch_zamba_train.py,
# tests/test_torch_vlm_train.py; see phase_train)
TRAIN_RUNS_CARD = [run for run in TRAIN_RUNS if run[0] != "checkpoint"]
# the VLM's: no disk run (see phase_train_vlm)
TRAIN_RUNS_VLM = [run for run in TRAIN_RUNS_CARD if not run[3]]
# llama-3.2-vision-11b trains at full width with one group (a gated cross
# layer and 5 self layers), the least depth the model takes
TRAIN_VLM_LAYERS = VISION.cross_attn_every
# whisper-tiny trains at its published text context (n_text_ctx 448)
TRAIN_SEQ_WHISPER = 448
# xlstm-350m trains at 64 tokens: at full width the reference's sLSTM is
# chaotic (ROADMAP.md F7) and the gradient through its scan grows with the
# sequence, in the reference's arithmetic as in the port's (one block's
# r_gates gradient 1.8e6 at 32 tokens, 1.8e12 at 64, 2e19 at 96, 1e25 at
# 128, non-finite at 256 and 512: tests/test_torch_xlstm.py,
# tools/xlstm_grad_check.py), so at 4 x 512 the first update is NaN; at 64
# tokens the gradient and AdamW's f32 second moment (g^2) stay finite
TRAIN_SEQ_XLSTM = 64
# xlstm-350m trains at full width with its depth cut from 24 to 6 blocks
# (one group of 5 mLSTM + 1 sLSTM): the script's cut to stay within its
# time limit (PERF.md §4)
TRAIN_XLSTM_BLOCKS = 6


def train_config():
    """qwen3-8b at full width (d 4096, 32 q / 8 KV heads of 128, d_ff
    12288, vocab 151936, bf16), depth cut from 36 to 2 layers: 1.63 B
    parameters, a 16.3 GB train state (two copies under replication)."""
    return dataclasses.replace(QWEN, n_layers=TRAIN_LAYERS)


def train_config_zamba():
    """zamba2-7b at full width (d 3584, d_inner 7168, 112 SSM heads of 64,
    N 64, 32 attention heads of 112, d_ff 14336, vocab 32000, bf16), depth
    cut from 81 to 13 Mamba blocks: two groups of 6 and a tail of 1, so
    both param stacks, the tail and the shared block's summed gradients
    take part; 1,448,622,480 parameters, a 14.5 GB train state."""
    return dataclasses.replace(ZAMBA, n_layers=TRAIN_ZAMBA_BLOCKS)


def train_launches_per_step(cfg):
    """Kernel launches of one train step (forward and backward), each
    backward once per forward call. Dense (L layers): layer 0's ln1 and,
    with qk-norm, each layer's two are plain norms (1 + 2 L); ln2, the
    later ln1s and ln_f fuse the residual add (2 L); one attention a
    layer. VLM (L self layers in G groups, no qk-norm): the cross
    output is pending when each group's first ln1 runs, so every ln1, ln2
    and ln_f fuses the add (2 L + 1) and none is plain; L causal
    self-attentions and G cross-attentions over the image memory. Hybrid (n Mamba blocks, G groups): every block's out_norm and
    the first attn_ln are plain norms (n + 1); the later attn_lns, every
    attn_mlp_ln, every block's ln and ln_f fuse the add (2 G + n); one
    attention a group, one scan a block. Whisper (e encoder, n decoder
    layers): each stack's first ln1 is plain (2); the other ln1s, every
    ln2, ln_x, ln_enc and ln_f fuse the add (2 e + 3 n); K2 once an
    encoder layer and twice a decoder layer (causal and cross). xLSTM (n
    blocks): the first block's ln plain, the other lns and ln_f fused
    (n); no attention."""
    n = cfg.n_layers
    if cfg.family == "hybrid":
        g = n // cfg.attn_every
        fwd = {"rmsnorm": n + 1, "add_rmsnorm": 2 * g + n,
               "flash_attention": g, "mamba_scan": n}
    elif cfg.family == "audio":
        e = cfg.n_encoder_layers
        fwd = {"rmsnorm": 2, "add_rmsnorm": 2 * e + 3 * n,
               "flash_attention": e + 2 * n, "mamba_scan": 0}
    elif cfg.family == "ssm":
        fwd = {"rmsnorm": 1, "add_rmsnorm": n, "flash_attention": 0,
               "mamba_scan": 0}
    elif cfg.family == "vlm":
        if cfg.qk_norm:
            raise ValueError("the VLM's count takes no qk-norm")
        fwd = {"rmsnorm": 0, "add_rmsnorm": 2 * n + 1,
               "flash_attention": n + n // cfg.cross_attn_every,
               "mamba_scan": 0}
    else:
        fwd = {"rmsnorm": 1 + 2 * n * cfg.qk_norm, "add_rmsnorm": 2 * n,
               "flash_attention": n, "mamba_scan": 0}
    return {**fwd, "rmsnorm_bwd": fwd["rmsnorm"],
            "add_rmsnorm_bwd": fwd["add_rmsnorm"],
            "flash_attention_bwd": fwd["flash_attention"],
            "mamba_scan_bwd": fwd["mamba_scan"]}


def train_state_bytes(cfg):
    """Bytes of the train state from its tensors' own dtypes (the hybrid
    keeps a_log, d_skip and dt_bias in f32 in a bf16 model): each param,
    its f32 m and v, the int32 step."""
    model = api.build_model(cfg, device="meta")
    return sum(p.numel() * (p.element_size() + 8)
               for p in model.parameters()) + 4


def _train_state_tensors(state):
    opt = state["opt"]
    return ([("opt/.step", opt.step)]
            + [(f"params/{k}", v) for k, v in state["params"].items()]
            + [(f"opt/.m/{k}", v) for k, v in opt.m.items()]
            + [(f"opt/.v/{k}", v) for k, v in opt.v.items()])


def _keep_clean(final, state_bytes):
    """The clean run's final state, held for the later runs' bitwise
    checks: a copy on the card where it fits beside a promotion's three
    states (qwen3-8b, zamba2-7b and the small models), else one host copy
    (the VLM: 4 x 21.8 GB)."""
    total = torch.cuda.get_device_properties(0).total_memory
    if 4 * state_bytes <= 0.85 * total:
        return [(k, t.clone()) for k, t in final]
    return [(k, t.cpu()) for k, t in final]


def _prune_to_latest(ckpt_dir):
    """Delete every checkpoint in ``ckpt_dir`` but the one ``LATEST``
    names, the baseline included (a session restores only from LATEST and
    restarts from its init without one); returns the bytes the directory
    held before. A checkpoint of the train state is 16.3 GB and the card's
    machine holds at most 45 GiB on its disk, so the disk runs prune before
    each step: at most two checkpoints, the newest and the one being
    written, are ever on disk."""
    held = sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(ckpt_dir) for f in files)
    latest = os.path.join(ckpt_dir, "LATEST")
    if os.path.exists(latest):
        with open(latest) as f:
            keep = f.read().strip()
        for tag in os.listdir(ckpt_dir):
            if tag != keep and (tag == "baseline" or tag.startswith("step_")):
                shutil.rmtree(os.path.join(ckpt_dir, tag))
    return held


def _timed_steps(workload, ckpt_dir=None):
    """Wrap the workload's train step: count its calls (the cmp's and the
    replica's) and time each on the host with the card synchronised; with
    ``ckpt_dir``, prune the checkpoints there before each step (untimed)
    and keep the most bytes the directory held in ``held``."""
    inner, times, held = workload.train_step, [], [0]

    def step(st, b):
        if ckpt_dir is not None:
            held[0] = max(held[0], _prune_to_latest(ckpt_dir))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(st, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out
    workload.train_step = step
    return times, held


def phase_train(state):
    """qwen3-8b trained at full width for TRAIN_STEPS steps, batch 4 x 512,
    clean and under replication (a promotion) and combined (a promotion
    then a pair death, restarted from disk); each run's final params and
    moments bitwise the clean run's. Its checkpoint schedule runs on the
    CPU only (``tests/test_torch_train.py``): on the card it took ~210 s
    (four saves and a restore of the 16.3 GB state), which the VLM's and
    Fig 10's phases need within the script's time limit."""
    _train_phase(state, train_config(), TRAIN_RUNS_CARD)


def phase_train_zamba(state):
    """zamba2-7b trained at full width (``train_config_zamba``) for
    TRAIN_STEPS steps, batch 4 x 512, clean and under replication (a
    promotion) and combined (a promotion then a pair death, restarted from
    disk), under qwen3-8b's gates. The hybrid's checkpoint schedule runs on
    the CPU only (``tests/test_torch_zamba_train.py``): on the card its ~4
    saves and a restore of the 14.5 GB state would add ~180 s and leave the
    script within ~70 s of its 1,200 s limit."""
    _train_phase(state, train_config_zamba(), TRAIN_RUNS_CARD)


def phase_train_whisper(state):
    """whisper-tiny trained at full size (56.4 M parameters; zero frames,
    as the reference's trainer feeds them) for TRAIN_STEPS steps at batch
    4 x 448, clean, under replication and combined, under qwen3-8b's
    gates: every forward and backward kernel of the path (K2 in the
    encoder at 1,500 x 1,500 and the cross-attention at 448 x 1,500,
    non-causal, and the decoder's causal 448) launched the counted number
    of times."""
    _train_phase(state, WHISPER, TRAIN_RUNS_CARD, seq=TRAIN_SEQ_WHISPER)


def phase_train_xlstm(state):
    """xlstm-350m trained at full width, depth cut to TRAIN_XLSTM_BLOCKS
    (6 of 24 blocks), for TRAIN_STEPS steps at batch 4 x TRAIN_SEQ_XLSTM
    (64: the longest power-of-two sequence whose gradient stays finite in
    the reference's arithmetic), clean, under replication and combined,
    under qwen3-8b's gates (K1 and its backward the only kernels: the
    mLSTM and the sLSTM scan are plain, as in the reference)."""
    _train_phase(state, dataclasses.replace(XLSTM,
                                            n_layers=TRAIN_XLSTM_BLOCKS),
                 TRAIN_RUNS_CARD, seq=TRAIN_SEQ_XLSTM)


def train_config_vlm():
    """llama-3.2-vision-11b at full width (d 4096, 32 q / 8 KV heads of
    128, d_ff 14336, vocab 128256 untied, 1,600 image tokens, bf16), depth
    cut from 8 groups to 1: 2,183,180,289 parameters, a 21.8 GB train
    state."""
    return dataclasses.replace(VISION, n_layers=TRAIN_VLM_LAYERS)


def phase_train_vlm(state):
    """llama-3.2-vision-11b trained at full width (``train_config_vlm``)
    for TRAIN_STEPS steps, batch 4 x 512, on zero image embeddings as the
    reference's trainer feeds them, clean and under replication (a
    promotion), under qwen3-8b's gates, and K2 launched at the cross
    shape (512 x 1,600, non-causal) once a group and forward, as its
    wrapper's tally counts. Its combined and checkpoint schedules need a
    21.8 GB disk checkpoint and run on the CPU only, at the reduced size
    (``tests/test_torch_vlm_train.py``). With the embeddings zero and the
    gates at 0 the cross path's gradient is exactly 0, so K2's backward at
    this shape is held on random data in ``phase_train_kernels``."""
    _train_phase(state, train_config_vlm(), TRAIN_RUNS_VLM)


def _train_phase(state, cfg, runs, seq=S):
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)     # a killed run's
    try:
        _train_runs(state, cfg, runs, seq)
    finally:
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)


def _train_runs(state, cfg, runs, seq):
    card_name = state["card"]
    per_step = train_launches_per_step(cfg)
    counters = {**KERNELS, **BWD_KERNELS}
    n_params = api.param_count(cfg)
    state_bytes = train_state_bytes(cfg)
    # a promotion holds three states at once (the session's, the promoted
    # replica's and the new replica's copy of it): the replicated peak
    emit({"phase": "train.build", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size, "params": n_params,
          "state_bytes": state_bytes, "batch": B, "seq": seq,
          "steps": TRAIN_STEPS, "lr": TRAIN_LR,
          "launches_per_step": per_step,
          "replication_peak_predicted_bytes": 3 * state_bytes,
          "card": card_name})
    clean = None
    totals = dict.fromkeys(counters, 0)
    for mode, ft, kills, disk in runs:
        ckpt_dir = os.path.join(TRAIN_CKPT, mode) if disk else None
        if ckpt_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        t0 = time.perf_counter()
        tr = train_lib.build_trainer(
            cfg, batch=B, seq=seq, seed=TRAIN_SEED, lr=TRAIN_LR, device="cuda",
            ft=FTConfig(**ft), ckpt_dir=ckpt_dir,
            kill_schedule=kills)
        build_s = time.perf_counter() - t0
        times, held = _timed_steps(tr.workload, ckpt_dir)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        flash_attention.calls.clear()
        t0 = time.perf_counter()
        rep = tr.run(TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # the run's own peak: without the clean state held on the card
        held_on_card = sum(t.numel() * t.element_size() for _, t in clean
                           if t.is_cuda) if clean else 0
        peak = torch.cuda.max_memory_allocated() - held_on_card
        launches = {k: fn.launches for k, fn in counters.items()}
        expected = {k: v * len(times) for k, v in per_step.items()}
        backend = tr.session.strategy.backend
        losses = rep.losses
        if len(losses) != TRAIN_STEPS + rep.rolled_back_steps or \
                not np.isfinite(losses).all():
            raise AssertionError(f"train {mode}: losses {losses}")
        if launches != expected:
            raise AssertionError(f"train {mode}: launches {launches} != "
                                 f"{expected}")
        k2_shapes = dict(k2_by_shape())
        if cfg.family == "vlm":
            groups = cfg.n_layers // cfg.cross_attn_every
            want_shapes = {(seq, seq, True): cfg.n_layers * len(times),
                           (seq, cfg.n_image_tokens, False):
                               groups * len(times)}
            if k2_shapes != want_shapes:
                raise AssertionError(f"train {mode}: K2 by shape "
                                     f"{k2_shapes} != {want_shapes}")
        final = _train_state_tensors(rep.final_state)
        held_bytes = sum(t.numel() * t.element_size() for _, t in final)
        if held_bytes != state_bytes:
            raise AssertionError(f"train {mode}: the state holds "
                                 f"{held_bytes} B, not {state_bytes}")
        t0 = time.perf_counter()
        if clean is None:
            clean = _keep_clean(final, state_bytes)
            equal = True
        else:
            equal = all(k == kc and t.dtype == c.dtype
                        and torch.equal(t.to(c.device), c)
                        for (k, t), (kc, c) in zip(final, clean))
        torch.cuda.synchronize()
        hold_s = time.perf_counter() - t0
        want = {"none": (0, 0), "replication": (1, 0), "combined": (1, 1),
                "checkpoint": (0, 1)}[mode]
        line = {
            "phase": "train", "mode": mode, "arch": cfg.name,
            "n_layers": cfg.n_layers, "steps": rep.steps,
            "executed_steps": len(times), "loss_first": losses[0],
            "loss_last": losses[-1], "failures": rep.failures,
            "promotions": rep.promotions, "restarts": rep.restarts,
            "rolled_back_steps": rep.rolled_back_steps,
            "ckpt_writes": rep.ckpt_writes,
            "restore_backend": getattr(backend, "kind", None),
            "final_state_equal": equal, "launches": launches,
            "launches_expected": expected,
            "k2_by_shape": _shape_rows(k2_shapes),
            "step_ms_median": 1e3 * statistics.median(times),
            "wall_s": wall, "build_s": build_s,
            # holding the final state for, or against, the clean run's
            "hold_s": hold_s, "clean_on": str(clean[0][1].device),
            "state_bytes": held_bytes,
            "max_memory_allocated": peak,
            "host_rss_peak_bytes":
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
            "card": card_name}
        if disk:
            ck = backend.ckpt
            line.update({
                "ckpt_save_s_total": rep.ckpt_s,
                "ckpt_save_s_mean": rep.ckpt_s / max(rep.ckpt_writes, 1),
                "ckpt_restore_s": rep.restore_s,
                "ckpt_bytes_each": ck.last_bytes,
                "ckpt_bytes_written": ck.last_bytes * (rep.ckpt_writes + 1),
                "ckpt_dir_peak_bytes": max(held[0],
                                           _prune_to_latest(ckpt_dir))})
        emit(line)
        if not equal:
            raise AssertionError(f"train {mode}: final state differs from "
                                 f"the clean run's")
        if (rep.promotions, rep.restarts) != want:
            raise AssertionError(f"train {mode}: promotions, restarts "
                                 f"{(rep.promotions, rep.restarts)} != "
                                 f"{want}")
        if disk and (backend.kind != "disk" or rep.restore_s <= 0 or (
                mode == "combined" and rep.rolled_back_steps <= 0)):
            raise AssertionError(f"train {mode}: not restarted from disk")
        for k in totals:
            totals[k] += launches[k]
        del tr, rep, final, backend
        gc.collect()
        torch.cuda.empty_cache()
        if ckpt_dir:
            shutil.rmtree(ckpt_dir)
    state.setdefault("train_launches", {})[cfg.name] = totals


# ------------------------------------------------- MoE training (slice 17)
# mixtral-8x7b at full width (d 4096, 8 experts of d_ff 14336, top-2, 32 q /
# 8 KV heads of 128, window 4096, vocab 32000), depth cut from 32 layers to
# 1: 1,713,418,240 parameters, a 17.1 GB train state (a replicated one at
# 2 layers, 3 x 31.6 GB at a promotion, would not fit the card)
TRAIN_MOE_LAYERS = 1


def train_config_moe():
    return dataclasses.replace(get_arch("mixtral-8x7b"),
                               n_layers=TRAIN_MOE_LAYERS)


def phase_train_moe(state):
    """mixtral-8x7b trained at full width (``train_config_moe``) for
    TRAIN_STEPS steps, batch 4 x 512, clean and under replication (a
    promotion), under qwen3-8b's gates (final state bitwise the clean
    run's, launches as the steps imply: K1 and K2 forward and backward at
    mixtral's shapes); the loss adds 0.01 x the router's load-balancing
    loss, whose value at step 0 is printed. The sort-based dispatch's
    backward is a scatter-add (``index_select``'s and the advanced
    index's), which the bitwise gate holds to deterministic."""
    cfg = train_config_moe()
    inner, seen = moe_lib.moe_aux_loss, []

    def recorded(*args, **kwargs):
        out = inner(*args, **kwargs)
        if not seen:                        # step 0 of the clean run
            seen.append(float(out.detach()))
        return out
    moe_lib.moe_aux_loss = recorded
    try:
        _train_phase(state, cfg, TRAIN_RUNS_VLM)
    finally:
        moe_lib.moe_aux_loss = inner
    line = {"phase": "train.moe", "arch": cfg.name, "n_layers": cfg.n_layers,
            "params": api.param_count(cfg), "aux_loss_step0": seen[0],
            "aux_weight": 0.01, "card": state["card"]}
    emit(line)
    # E * sum(frac * imp) is 1 for a balanced router and at most E
    if not 0.0 < seen[0] <= cfg.n_experts:
        raise AssertionError(f"train.moe: aux loss {seen[0]}")


# ------------------------------------------------------ the dry run
# on the card, the dry run's count of three steps cut to one card against
# the card's own count; after the last timed phase, python -m
# repro_torch.launch.dryrun over every applicable cell on both production
# meshes on the host (it needs no card), one process a (shape, mesh), so
# that no timed phase runs beside it (its JSON lands in build/dryrun)
DRYRUN_DIR = os.path.join(ROOT, "build", "dryrun")
COST_KERNELS = {"rmsnorm": rmsnorm, "add_rmsnorm": add_rmsnorm,
                "rmsnorm_bwd": rmsnorm_bwd,
                "add_rmsnorm_bwd": add_rmsnorm_bwd,
                "flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd,
                "mamba_scan": mamba_chunk_scan,
                "mamba_scan_bwd": mamba_chunk_scan_bwd}
# the dry run's op names of the kernels (kernels/meta.py)
META_NAMES = {"mamba_scan": "mamba_chunk_scan",
              "mamba_scan_bwd": "mamba_chunk_scan_bwd"}


def _card_count(step):
    """One call of ``step`` on the card: FlopCounterMode's count (the
    ATen ops; the kernels' ctypes launches are invisible to it), each
    kernel's ``kernels/cost.py`` work times its launches by argument, and
    their sum."""
    from torch.utils.flop_counter import FlopCounterMode
    for fn in COST_KERNELS.values():
        fn.calls.clear()
    torch.cuda.synchronize()
    with FlopCounterMode(display=False) as fc:
        step()
        torch.cuda.synchronize()
    kernels = {name: cost.tally_work(name, fn.calls).flops
               for name, fn in COST_KERNELS.items() if fn.calls}
    aten = fc.get_total_flops()
    return aten + sum(kernels.values()), aten, kernels


def _step_ms(step, reps=3):
    step()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _dry_check(card_name, what, cfg, kind, step, state_bytes, seq_chunk):
    """The dry run's count of ``cfg``'s ``kind`` step at B x S on one
    device (no mesh) against the card's count of ``step``, exactly; its
    bound time (compute or HBM bytes) against the step's measured ms; its
    argument bytes against the state the card holds."""
    shape = ShapeConfig(what, seq_len=S, global_batch=B, kind=kind)
    t0 = time.perf_counter()
    dry = dryrun.lower_cell(cfg.name, what, cfg=cfg, shape=shape,
                            one_device=True, seq_chunk=seq_chunk)
    trace_s = time.perf_counter() - t0
    total, aten, kernels = _card_count(step)
    ms = _step_ms(step)
    t = dry["terms"]
    want = {name: dry["kernel_flops"].get(META_NAMES.get(name, name), 0)
            for name in COST_KERNELS}
    got = {name: kernels.get(name, 0) for name in COST_KERNELS}
    mem = t["memory_per_device"]
    args = mem["argument_parts"]
    line = {"phase": "dryrun.card", "step": what, "arch": cfg.name,
            "n_layers": cfg.n_layers, "batch": B, "seq": S,
            "dry_flops": t["flops_per_device"], "card_flops": total,
            "card_aten_flops": aten, "card_kernel_flops": got,
            "dry_kernel_flops": want,
            "flops_equal": t["flops_per_device"] == total and got == want,
            "units": dry["units"], "traces": dry["traces"],
            "trace_s": trace_s, "dry_bytes_lb": t["bytes_per_device"],
            "dry_bytes_ub": t["bytes_per_device_ub"],
            "bound_ms": 1e3 * t["bound_time_s"],
            "bound_by": "compute" if t["compute_s"] >= t["memory_s"]
            else "memory",
            "step_ms": ms, "bound_over_step": 1e3 * t["bound_time_s"] / ms,
            "model_flops": t["model_flops_global"],
            "useful_ratio": t["useful_ratio"],
            "argument_bytes": {k: args[k] for k in ("params", "opt")
                               if k in args},
            "state_bytes_measured": state_bytes,
            "argument_equal": args["params"] + args.get("opt", 0)
            == state_bytes,
            "card": card_name}
    emit(line)
    if not line["flops_equal"]:
        raise AssertionError(f"dryrun.card {what}: the dry run's "
                             f"{t['flops_per_device']} FLOPs != the card's "
                             f"{total} ({got} vs {want})")
    if not line["argument_equal"]:
        raise AssertionError(f"dryrun.card {what}: argument bytes {args} "
                             f"!= the card's {state_bytes}")
    return line


def _train_check(card_name, what, cfg):
    wl = train_lib.build_workload(cfg, reduced=False, batch=B, seq=S,
                                  seed=TRAIN_SEED, lr=TRAIN_LR,
                                  device="cuda")
    st = wl.init_state()
    held = sum(t.numel() * t.element_size()
               for _, t in _train_state_tensors(st))
    batch = wl.batch_fn(0)
    try:
        return _dry_check(card_name, what, cfg, "train",
                          lambda: wl.train_step(st, batch), held,
                          seq_chunk=min(S, 512))
    finally:
        del wl, st, batch
        gc.collect()
        torch.cuda.empty_cache()


def _prefill_check(card_name, what, cfg):
    model = Transformer(cfg, device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(TRAIN_SEED))
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)}
    try:
        return _dry_check(card_name, what, cfg, "prefill",
                          lambda: model.prefill(batch), held, seq_chunk=2048)
    finally:
        del model, batch
        gc.collect()
        torch.cuda.empty_cache()


def phase_dryrun(state):
    """On the card: qwen3-8b's train step at 2 layers, its full-depth
    prefill and the MoE's train step (``train_config_moe``), each at
    4 x 512 on one device, counted by the dry run and by the card, equal
    to the FLOP; the dry run's bound against each step's time."""
    card_name = state["card"]
    state["dryrun"] = [
        _train_check(card_name, "train_2_layers", train_config()),
        _prefill_check(card_name, "prefill", QWEN),
        _train_check(card_name, "train_moe", train_config_moe())]


def phase_dryrun_sweep(state):
    """The host's sweep, after every timed phase: every applicable cell
    OK on both production meshes, in one CPU-only process of one thread a
    (shape, mesh), all at once; the count, the wall, the 16 x 16 table
    (``build/dryrun/report.md``) and the hill-climb cells."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    os.makedirs(DRYRUN_DIR)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    jobs = []
    t0 = time.perf_counter()
    try:
        for shape in sorted({s for _, s in dryrun.applicable_cells()}):
            for mesh in ("single", "multi"):
                stem = os.path.join(DRYRUN_DIR, f"cells_{shape}_{mesh}")
                log = open(stem + ".log", "w")
                jobs.append((stem + ".json", log, subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--shape", shape, "--mesh", mesh, "--out",
                     stem + ".json"],
                    stdout=log, stderr=subprocess.STDOUT, env=env,
                    cwd=ROOT)))
        rcs = [proc.wait(timeout=600) for _, _, proc in jobs]
    finally:
        for _, log, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    wall = time.perf_counter() - t0
    cells = []
    for path, _, _ in jobs:
        with open(path) as f:
            cells += json.load(f)
    bad = [c["cell"] for c in cells if not c["ok"]]
    by_mesh = {}
    for c in cells:
        if c["ok"]:
            by_mesh[c["terms"]["mesh"]] = by_mesh.get(c["terms"]["mesh"],
                                                      0) + 1
    with open(os.path.join(DRYRUN_DIR, "report.md"), "w") as f:
        f.write(dryrun.markdown_table(cells) + "\n")
    emit({"phase": "dryrun.sweep", "cells": len(cells),
          "ok": len(cells) - len(bad), "by_mesh": by_mesh,
          "processes": len(jobs), "rc": max(rcs), "wall_s": wall,
          "trace_s": sum(c.get("trace_s", 0) for c in cells),
          "dominant": {d: sum(1 for c in cells if c["ok"]
                              and c["terms"]["dominant"] == d)
                       for d in ("compute", "memory", "collective")},
          "hillclimb": dryrun.pick_hillclimb_cells(cells),
          "torch": sorted({c["torch"] for c in cells if c["ok"]}),
          "failed": bad, "card": state["card"]})
    if max(rcs) != 0 or bad or \
            len(cells) != 2 * len(dryrun.applicable_cells()):
        raise AssertionError(f"dryrun.sweep: rcs {rcs}, failed {bad}")


# Fig 10 (the FT layer's failure-free overhead) through
# ``repro_torch.figures.fig10_overhead``: the reference's configuration
# (codeqwen1.5-7b reduced, 4 x 64) and full width with the depth cut to
# FIG10_FULL_LAYERS layers at 4 x 512 (1,221,636,096 parameters, a 12.2 GB
# train state; no replica copy: simulate_replica is off)
FIG10_FULL_LAYERS = 2
FIG10_STEPS, FIG10_WARM = 40, 6
# the reference's virtual-time row at 40 steps (tests/test_torch_figures.py
# holds the same row live against the reference's script)
FIG10_BREAKDOWN = "useful=40s redundant=40s total=80s"
FIG10_RUNS = (("reduced", dict(reduced=True, batch=4, seq=64)),
              ("full", dict(reduced=False, n_layers=FIG10_FULL_LAYERS,
                            batch=B, seq=S)))


def phase_fig10(state):
    """Fig 10 on the card at both FIG10_RUNS configurations: the bare loop
    and the FT session, the least of 3 runs of 40 steps each, after 6 warm
    steps. Fails unless the FT run's final state is bitwise the bare
    loop's, the ``fig10/ft_time_breakdown`` row is the reference's, the
    launches count one execution a step (no replica), and the losses are
    finite. Then K2's forward at codeqwen1.5-7b's MHA shape, timed. Both
    configurations' K2 shapes are held against the plain version by
    ``phase_attention`` (forward) and ``phase_train_kernels`` (backward);
    the reduced run puts K1 and K2 at D 32, group 1, on the card under the
    FT session, which the CPU test of Fig 10 cannot."""
    card_name = state["card"]
    counters = {**KERNELS, **BWD_KERNELS}
    totals = dict.fromkeys(counters, 0)
    for label, kw in FIG10_RUNS:
        cfg = CODEQWEN.reduced() if kw["reduced"] else dataclasses.replace(
            CODEQWEN, n_layers=kw["n_layers"])
        per_step = train_launches_per_step(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        m = fig10_overhead.measure(CODEQWEN.name, steps=FIG10_STEPS,
                                   warm=FIG10_WARM, device="cuda", **kw)
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        executions = FIG10_WARM + 6 * FIG10_STEPS
        expected = {k: v * executions for k, v in per_step.items()}
        rows = m.rows()
        ft_final = _train_state_tensors(m.report.final_state)
        bare_final = _train_state_tensors(m.bare_state)
        equal = [k for k, _ in ft_final] == [k for k, _ in bare_final] and \
            all(a.dtype == b.dtype and torch.equal(a, b)
                for (_, a), (_, b) in zip(ft_final, bare_final))
        losses = m.report.losses
        emit({"phase": "fig10", "config": label, "arch": cfg.name,
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "params": api.param_count(cfg),
              "state_bytes": train_state_bytes(cfg), "batch": kw["batch"],
              "seq": kw["seq"], "steps": FIG10_STEPS, "warm": FIG10_WARM,
              "bare_ms_per_step": 1e3 * m.bare_s / FIG10_STEPS,
              "ft_ms_per_step": 1e3 * m.ft_s / FIG10_STEPS,
              "overhead_pct": m.overhead_pct,
              "paper_overhead_pct": fig10_overhead.PAPER_OVERHEAD_PCT,
              "init_ms": 1e3 * m.init_s,
              "overhead_without_init_pct": m.overhead_without_init_pct,
              "rows": [[name, derived] for name, _, derived in rows],
              "breakdown_equal": rows[1][2] == FIG10_BREAKDOWN,
              "final_state_equal": equal, "launches": launches,
              "launches_expected": expected, "loss_first": losses[0],
              "loss_last": losses[-1],
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "wall_s": wall, "card": card_name})
        if not equal:
            raise AssertionError(f"fig10 {label}: the FT run's final state "
                                 f"differs from the bare loop's")
        if rows[1][2] != FIG10_BREAKDOWN:
            raise AssertionError(f"fig10 {label}: breakdown {rows[1][2]!r}")
        if launches != expected:
            raise AssertionError(f"fig10 {label}: launches {launches} != "
                                 f"{expected}")
        if len(losses) != FIG10_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"fig10 {label}: losses {losses}")
        for k in totals:
            totals[k] += launches[k]
        del m, ft_final, bare_final
        gc.collect()
        torch.cuda.empty_cache()
    state.setdefault("train_launches", {})[f"fig10 {CODEQWEN.name}"] = totals
    gen = torch.Generator(device="cuda").manual_seed(13)
    state["fig10_k2"] = _attention_times(
        card_name, _L2Flush(), gen, CODEQWEN.n_heads, CODEQWEN.n_kv_heads,
        CODEQWEN.resolved_head_dim)


# ---------------------------------------------------------------- phase 9
#
# The simulated runtime and the paper's three apps (float64, no kernel of
# their own) at their published per-rank sizes; ranks cut to what one card
# holds (PERF.md §4), 4 workers a node.

# The ranks are cut (32, 16 and 32 planned) to keep the script within its
# time limit; the per-rank sizes are the sources' own.
SIMRT_APPS = {
    # HPCG's shipped hpcg.dat: a 104^3 local grid, ranks stacked along z
    "hpcg": (HPCG, 16, dict(nx=104, ny=104, nz=104)),
    # CloverLeaf's InputDecks/clover_bm16.in: 3,840 x 3,840 cells in 16
    # slabs of 3,840 x 240, of which 8
    "cloverleaf": (CloverLeaf, 8, dict(nx=3840, ny_local=240)),
    # 4,096 cells and 1,048,576 particles (256 a cell) a rank
    "pic": (PIC, 8, dict(cells_per_rank=4096, particles_per_rank=1 << 20)),
}
# tests/test_simrt_apps.py's per-rank sizes: the CPU run whose virtual
# time and counters each card run must equal (virtual time does not
# depend on the grid)
SIMRT_TEST_SIZES = {"hpcg": dict(nx=8, ny=8, nz=4),
                    "cloverleaf": dict(nx=16, ny_local=8),
                    "pic": dict(cells_per_rank=32, particles_per_rank=96)}
SIMRT_STEPS, SIMRT_WPN = 12, 4
# HPCG's in-memory checkpoint run: fewer ranks, the same per-rank grid
SIMRT_MEMSTORE_RANKS = 8
SIMRT_CKPT = os.path.join(ROOT, "build", "simrt_ckpt")
# card against CPU (4 ranks, full per-rank size, 4 steps), of each state
# tensor's largest magnitude: float64 sums in other orders on the card
# (cuBLAS dots, reductions, the deposit's sorted runs, the scan's matrix
# products), ~1e-16 relative a sum, carried a few steps (fixed in
# PERF.md §6 before the first card run)
SIMRT_TOL = 1e-10
SIMRT_COUNTERS = ("failures", "promotions", "restarts", "replays",
                  "duplicates_skipped", "store_restores", "store_fallbacks",
                  "steps_done")


def simrt_schedules(n):
    """tests/test_simrt_apps.py:26-120's schedules for n ranks: mode ->
    (kills [(time s, workers)], replication degree). Combined kills rank
    1's computational worker, then its promoted replica (worker n + 1)."""
    return {"none": ([], 1.0),
            "replication": ([(2.5, (0,)), (5.5, (2,)), (8.5, (1,))], 1.0),
            "checkpoint": ([(6.5, (2,))], 0.0),
            "combined": ([(3.2, (1,)), (6.3, (n + 1,))], 1.0)}


def simrt_runtime(app, mode, kills, rep, ckpt_dir=None, **kw):
    ft_kw = {k: kw.pop(k) for k in ("ckpt_backend", "topology") if k in kw}
    ft = FTConfig(mode=mode, replication_degree=rep, mtbf_s=1e9,
                  ckpt_interval_s=4.0, **ft_kw)
    return SimRuntime(app, ft,
                      costs=CostModel(step_time_s=1.0, ckpt_cost_s=0.2,
                                      restore_cost_s=0.3),
                      ckpt_dir=ckpt_dir, workers_per_node=SIMRT_WPN,
                      failure_events=[FailureEvent(t, w) for t, w in kills],
                      **kw)


def _cached_init(app, cache):
    """``app`` whose ``init_state(rank)`` draws each rank's state once per
    phase (numpy on the host, then one copy to the card) and hands every
    worker its own clone: set-up, kept out of the timed runs' way."""
    draw = app.init_state

    def init_state(rank):
        if rank not in cache:
            cache[rank] = draw(rank)
        return copy_tree(cache[rank])
    app.init_state = init_state
    return app


def _simrt_counters(res):
    return {k: getattr(res, k) for k in SIMRT_COUNTERS}


def _states_bitwise(got, want):
    if sorted(got) != sorted(want):
        return False
    for r, st in want.items():
        for key, w in st.items():
            g = got[r][key]
            if isinstance(w, torch.Tensor):
                if g.device != w.device or not torch.equal(g, w):
                    return False
            elif g != w:
                return False
    return True


def _timed_simrt(make):
    """(runtime, result, wall s, peak bytes) of ``make()``'s run: the peak
    counts what the runtime allocates, its workers' initial states
    included, above what the phase already holds."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    rt = make()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rt.run(SIMRT_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return rt, res, wall, torch.cuda.max_memory_allocated() - held


def _simrt_app_runs(state, name):
    """Every schedule of one app at full per-rank size: the FT theorem
    (final states bitwise the none run's), the counters, the virtual time
    and the counters of the CPU run at the tests' size, then the
    replication run again with the divergence tripwire armed (bitwise,
    silent). A replicated run without failures beside the none run, after
    a one-step warm-up, times the replica's re-execution."""
    cls, n, size = SIMRT_APPS[name]
    card_name = state.get("card") or card()
    cache, split = {}, state.setdefault("simrt_split", {})
    t0 = time.perf_counter()

    def app():
        return _cached_init(cls(n_ranks=n, device="cuda", **size), cache)
    simrt_runtime(app(), "none", [], 1.0).run(1)
    split[f"{name}.warmup"] = time.perf_counter() - t0
    runs = [(mode, mode, kills, rep)
            for mode, (kills, rep) in simrt_schedules(n).items()]
    runs.insert(1, ("replication.failure_free", "replication", [], 1.0))
    clean, walls = None, {}
    for label, mode, kills, rep in runs:
        ckpt_dir = os.path.join(SIMRT_CKPT, name, label)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        t0 = time.perf_counter()
        rt, res, wall, peak = _timed_simrt(lambda: simrt_runtime(
            app(), mode, kills, rep, ckpt_dir=ckpt_dir))
        t1 = time.perf_counter()
        cpu = simrt_runtime(cls(n_ranks=n, device="cpu",
                                **SIMRT_TEST_SIZES[name]),
                            mode, kills, rep).run(SIMRT_STEPS)
        split[f"{name}.{label}"] = t1 - t0
        split[f"{name}.{label}.cpu_test_size"] = time.perf_counter() - t1
        equal = True if clean is None else _states_bitwise(res.states,
                                                           clean)
        executed = SIMRT_STEPS + round(res.time.rollback)
        walls[label] = wall
        emit({"phase": "simrt", "app": name, "mode": label, "ranks": n,
              "workers": n + rt.m, "per_rank": size, "steps": SIMRT_STEPS,
              "executed_steps": executed, "wall_s": wall,
              "wall_ms_a_step": 1e3 * wall / SIMRT_STEPS,
              **_simrt_counters(res),
              "rollback_s": res.time.rollback,
              "time": res.time.as_dict(),
              "time_equal_cpu": res.time.as_dict() == cpu.time.as_dict(),
              "counters_equal_cpu":
                  _simrt_counters(res) == _simrt_counters(cpu),
              "final_state_equal": equal,
              "peak_memory_bytes": peak, "card": card_name})
        want = {"none": (0, 0), "replication.failure_free": (0, 0),
                "replication": (3, 0), "checkpoint": (0, 1),
                "combined": (None, 1)}[label]
        if not equal:
            raise AssertionError(f"simrt {name} {label}: final state "
                                 f"differs from the failure-free run's")
        if res.time.as_dict() != cpu.time.as_dict() or \
                _simrt_counters(res) != _simrt_counters(cpu):
            raise AssertionError(f"simrt {name} {label}: virtual time or "
                                 f"counters differ from the CPU run's")
        if res.restarts != want[1] or (want[0] is not None and
                                       res.promotions != want[0]) or \
                (label == "combined" and res.promotions < 1):
            raise AssertionError(f"simrt {name} {label}: promotions "
                                 f"{res.promotions}, restarts "
                                 f"{res.restarts}")
        if label in ("checkpoint", "combined") and res.time.rollback <= 0:
            raise AssertionError(f"simrt {name} {label}: nothing rolled "
                                 f"back")
        if name == "pic" and label == "replication" and res.replays <= 0:
            raise AssertionError("simrt pic replication: no replay")
        if label == "none":
            clean = res.states
        elif label == "replication":
            first = res.states
        del rt, res
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    # the replication run again, with the divergence tripwire armed
    kills, rep = simrt_schedules(n)["replication"]
    t0 = time.perf_counter()
    rt, res, wall, _peak = _timed_simrt(lambda: simrt_runtime(
        app(), "replication", kills, rep, detect_divergence=True))
    split[f"{name}.rerun"] = time.perf_counter() - t0
    rerun = _states_bitwise(res.states, first)
    emit({"phase": "simrt.rerun", "app": name, "mode": "replication",
          "detect_divergence": True, "wall_s": wall,
          "compared_sends": rt.divergence.compared,
          "divergences": len(rt.divergence.divergences),
          "bitwise_equal_first_run": rerun,
          "replica_wall_over_none":
              walls["replication.failure_free"] / walls["none"],
          "card": card_name})
    if not rerun or rt.divergence.divergences or not rt.divergence.compared:
        raise AssertionError(f"simrt {name}: rerun not bitwise or the "
                             f"tripwire fired")


def _simrt_hpcg_memstore(state):
    """HPCG at full size, combined, in-memory checkpoints under fattree
    pricing, a pair death: restored from partner memory, bitwise the
    failure-free run under the same pricing (fattree's collectives are
    trees and rings, which sum in another order than the flat ones)."""
    cls, _n, size = SIMRT_APPS["hpcg"]
    n, cache = SIMRT_MEMSTORE_RANKS, {}

    def app():
        return _cached_init(cls(n_ranks=n, device="cuda", **size), cache)
    clean = simrt_runtime(app(), "none", [], 1.0,
                          topology="fattree").run(SIMRT_STEPS).states
    kills, rep = simrt_schedules(n)["combined"]
    rt, res, wall, peak = _timed_simrt(lambda: simrt_runtime(
        app(), "combined", kills, rep, ckpt_backend="memory",
        topology="fattree"))
    equal = _states_bitwise(res.states, clean)
    del clean
    emit({"phase": "simrt", "app": "hpcg", "mode": "combined.memory",
          "topology": "fattree", "ranks": n, "wall_s": wall,
          **_simrt_counters(res), "time": res.time.as_dict(),
          "store_committed_bytes": rt.store.committed_bytes,
          "final_state_equal": equal, "peak_memory_bytes": peak,
          "card": state.get("card") or card()})
    if not equal or res.restarts != 1 or res.store_restores != 1 or \
            res.store_fallbacks:
        raise AssertionError("simrt hpcg memory: not restored from partner "
                             "memory bitwise")


def _simrt_card_vs_cpu(state):
    """Each app at full per-rank size on 4 ranks for 4 steps, on the card
    and on the CPU: every state tensor within SIMRT_TOL of its largest
    magnitude, particle counts equal."""
    out = {}
    for name, (cls, _n, size) in SIMRT_APPS.items():
        res = {}
        for dev in ("cuda", "cpu"):
            rt = simrt_runtime(cls(n_ranks=4, device=dev, **size), "none",
                               [], 1.0)
            res[dev] = rt.run(4).states
        worst = 0.0
        for r, st in res["cpu"].items():
            for key, want in st.items():
                got = res["cuda"][r][key]
                if not isinstance(want, torch.Tensor):
                    if not math.isclose(float(got), float(want),
                                        rel_tol=SIMRT_TOL):
                        raise AssertionError(f"simrt {name}: {key} card "
                                             f"{got} CPU {want}")
                    continue
                if got.shape != want.shape:
                    raise AssertionError(f"simrt {name}: rank {r} {key} "
                                         f"{tuple(got.shape)} on the card, "
                                         f"{tuple(want.shape)} on the CPU")
                scale = float(want.abs().max()) if want.numel() else 0.0
                err = float((got.cpu() - want).abs().max()) \
                    if want.numel() else 0.0
                if err > SIMRT_TOL * scale:
                    raise AssertionError(f"simrt {name}: rank {r} {key} "
                                         f"differs by {err} (scale {scale})")
                if scale:
                    worst = max(worst, err / (SIMRT_TOL * scale))
        out[name] = worst
        del res
    emit({"phase": "simrt.card_vs_cpu", "ranks": 4, "steps": 4,
          "tolerance": SIMRT_TOL, "share_of_tolerance": out,
          "card": state.get("card") or card()})


def phase_simrt(state):
    """The simulated runtime and HPCG, CloverLeaf and PIC on the card
    (``SIMRT_APPS``), 12 steps under tests/test_simrt_apps.py's schedules
    (none, replication, checkpoint with rep 0, combined with a pair death;
    disk checkpoints under build/simrt_ckpt, a rank's baseline and latest
    there at a time): final states bitwise the none run's, the counters,
    virtual time and counters equal to the CPU run at the tests' size, a
    bitwise rerun with the divergence tripwire silent; HPCG in partner
    memory under fattree pricing; the card against the CPU; the traced
    HPCG demo; ``SimAppWorkload`` under ``FTSession``."""
    card_name = state.get("card") or card()
    split = state.setdefault("simrt_split", {})
    shutil.rmtree(SIMRT_CKPT, ignore_errors=True)
    try:
        for name in SIMRT_APPS:
            _simrt_app_runs(state, name)
        t0 = time.perf_counter()
        _simrt_hpcg_memstore(state)
        split["hpcg.memstore"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(SIMRT_CKPT, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _simrt_card_vs_cpu(state)
    split["card_vs_cpu"] = time.perf_counter() - t0
    # the traced demo at its default size (64 ranks, a node killed)
    t0 = time.perf_counter()
    _rt, res, obs = traced_hpcg_run(device="cuda")
    traced = {"spans": len(obs.tracer.spans),
              "nested_and_closed": _nested_and_closed(obs.tracer),
              "failures": res.failures, "promotions": res.promotions,
              "replays": res.replays,
              "wall_s": time.perf_counter() - t0}
    # SimAppWorkload under FTSession: bitwise the clean run after a
    # promotion (HPCG, 4 ranks at full per-rank size)
    cls, _n, size = SIMRT_APPS["hpcg"]

    def workload():
        return SimAppWorkload(cls(n_ranks=4, device="cuda", **size))
    clean = FTSession(ft=FTConfig(mode="none"),
                      n_logical_workers=4).run(workload(), 6).final_state
    rep = FTSession(ft=FTConfig(mode="replication"), injector={3: [0]},
                    n_logical_workers=4).run(workload(), 6)
    session_equal = _states_bitwise(rep.final_state, clean)
    split["obs_session"] = time.perf_counter() - t0
    emit({"phase": "simrt.obs_session", "traced_hpcg": traced,
          "session_promotions": rep.promotions,
          "session_final_state_equal": session_equal, "card": card_name})
    emit({"phase": "simrt.split", "seconds": split})
    if not traced["nested_and_closed"] or not res.promotions or \
            rep.promotions != 1 or not session_equal:
        raise AssertionError("simrt: traced demo or SimAppWorkload failed")


# Fig 16's grid (benchmarks/fig16_taskpool.py, whose module imports the
# reference): W worker ranks, STEPS rounds of POOL_STEP_S, fattree pricing
POOL_W, POOL_STEPS, POOL_STEP_S, POOL_CKPT_S = 6, 60, 60.0, 600.0
POOL_CONFIGS = (
    ("rep1.0", {"mode": "replication", "replication_degree": 1.0}),
    ("rep0.5", {"mode": "replication", "replication_degree": 0.5}),
    ("comb1.0", {"mode": "combined", "replication_degree": 1.0,
                 "ckpt_interval_s": POOL_CKPT_S}),
    ("ckpt", {"mode": "checkpoint", "ckpt_interval_s": POOL_CKPT_S}),
)
POOL_MTTIS = (("mtti=inf", None), ("mtti=1h", 3600.0), ("mtti=20m", 1200.0))
# train_surrogate's loss, card against CPU (tests/test_torch_pool.py):
# theta is the same float64 arithmetic, the final dot of eight positive
# squares may sum in another order (<= 7 * 2**-53 relative)
POOL_LOSS_RTOL = 1e-15


def _pool_cell(cfg, mtbf_s, device):
    """One Fig 16 cell: (derived row string, results table, stats,
    wall s)."""
    from repro_torch.pool import (hyperparameter_sweep_tasks,
                                  monte_carlo_tasks, run_pool)
    tasks = hyperparameter_sweep_tasks(pool_seed=3) + \
        monte_carlo_tasks(n_tasks=12, pool_seed=4)
    t0 = time.perf_counter()
    report, pool = run_pool(
        tasks, n_workers=POOL_W, n_steps=POOL_STEPS,
        step_time_s=POOL_STEP_S, mtbf_s=mtbf_s, seed=23, policy="lpt",
        topology="fattree", device=device, **cfg)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = pool.pool_stats(report.final_state)
    t = report.time
    makespan_s = t.total - t.redundant
    goodput = stats["completed"] / (makespan_s / 3600.0) if makespan_s \
        else 0.0
    p99_s = stats["latency_p99_rounds"] * POOL_STEP_S
    derived = (f"goodput={goodput:.2f}/h p99={p99_s:.0f}s "
               f"completed={stats['completed']} "
               f"reassigned={stats['reassigned']} "
               f"covered={stats['replica_covered']} "
               f"promotions={report.promotions} "
               f"restarts={report.restarts} "
               f"rolled_back={report.rolled_back_steps} "
               f"eff={report.efficiency:.3f}")
    return derived, report.final_state["ms"]["results"], stats, wall, \
        report.steps


def _pool_digest(rows):
    """benchmarks/pin_digests.py's digest of (name, derived) rows."""
    import hashlib
    h = hashlib.sha256()
    for name, derived in rows:
        h.update(name.encode())
        h.update(b"\x00")
        h.update(derived.encode())
        h.update(b"\n")
    return h.hexdigest()


def _pool_values_match(got, want):
    """mc_pi exactly, train_surrogate's loss within POOL_LOSS_RTOL."""
    if sorted(got) != sorted(want):
        return False
    for tid, w in want.items():
        g = got[tid]
        if sorted(g) != sorted(w):
            return False
        for key, v in w.items():
            if type(g[key]) is not type(v):
                return False
            if key == "loss":
                if abs(g[key] - v) > POOL_LOSS_RTOL * abs(v):
                    return False
            elif g[key] != v:
                return False
    return True


def phase_pool(state):
    """Slice 15: Fig 16's 12-cell grid (3 MTTIs x 4 FT configurations,
    24 tasks, W 6, 60 rounds of 60 s, fattree) through
    ``repro_torch.pool.run_pool`` with the tasks computing on the card.
    Fails unless the rows' digest is the pinned ``fig16_taskpool``, every
    completed task's value equals the same grid's on the CPU (mc_pi
    exactly, train_surrogate within POOL_LOSS_RTOL), each cell's result
    table is bitwise the failure-free run's, and no hand-written kernel
    ran (the pool's path has none)."""
    card_name = state.get("card") or card()
    with open(os.path.join(ROOT, "benchmarks", "fig_digests.json")) as f:
        pinned = json.load(f)["fig16_taskpool"]
    cpu = {}
    t0 = time.perf_counter()
    for mtti, mtbf_s in POOL_MTTIS:
        for label, cfg in POOL_CONFIGS:
            cpu[(mtti, label)] = _pool_cell(dict(cfg), mtbf_s, "cpu")[1]
    cpu_s = time.perf_counter() - t0
    reset_launches()
    rows, cells = [], []
    clean = None
    values_equal = table_equal = True
    t0 = time.perf_counter()
    for mtti, mtbf_s in POOL_MTTIS:
        for label, cfg in POOL_CONFIGS:
            derived, results, stats, wall, rounds = _pool_cell(
                dict(cfg), mtbf_s, "cuda")
            name = f"fig16/{mtti}/{label}"
            rows.append((name, derived))
            if clean is None:
                clean = results
            same_cpu = _pool_values_match(results, cpu[(mtti, label)])
            same_clean = results == clean
            values_equal &= same_cpu
            table_equal &= same_clean
            cells.append({"cell": name, "rounds": rounds,
                          "completed": stats["completed"],
                          "wall_s": wall,
                          "tasks_per_s": stats["completed"] / wall,
                          "values_equal_cpu": same_cpu,
                          "table_equal_clean": same_clean})
    card_s = time.perf_counter() - t0
    launches = read_launches()
    digest = _pool_digest(rows)
    emit({"phase": "pool", "cells": cells, "digest": digest,
          "digest_equal": digest == pinned,
          "values_equal_cpu": values_equal,
          "tables_equal_clean": table_equal, "launches": launches,
          "card_s": card_s, "cpu_s": cpu_s, "card": card_name})
    if digest != pinned or not values_equal or not table_equal or \
            any(launches.values()):
        raise AssertionError("pool: Fig 16's grid disagrees")


def phase_analyze(state):
    """Slice 15: ``python -m repro_torch.analyze all`` (the lint over
    src/repro_torch, the three apps' schedules traced at n_ranks=4 on the
    card) and ``divergence`` (one mantissa bit of a replica's halo plane
    flipped on the card): both must return 0, the flip caught."""
    import io

    from repro_torch.analyze.__main__ import main as analyze_main
    card_name = state.get("card") or card()
    out = {}
    for argv in (["all"], ["divergence"]):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = analyze_main(argv)
        out[argv[0]] = {"rc": rc, "seconds": time.perf_counter() - t0,
                        "lines": buf.getvalue().splitlines()}
    caught = [line.strip() for line in out["divergence"]["lines"]
              if line.strip().startswith("caught:")]
    emit({"phase": "analyze", "all": out["all"],
          "divergence": out["divergence"], "caught": bool(caught),
          "card": card_name})
    if out["all"]["rc"] or out["divergence"]["rc"] or not caught:
        raise AssertionError("analyze: a pass failed or the flip was "
                             "not caught")


PHASES = [phase_device_and_build, phase_comm, phase_rmsnorm, phase_attention,
          phase_mamba_scan, phase_reference, phase_reference_zamba,
          phase_reference_families, phase_reference_audio_ssm, phase_serve,
          phase_serve_ckpt, phase_obs, phase_store, phase_times,
          phase_serve_zamba, phase_serve_ckpt_zamba, phase_times_zamba,
          phase_serve_mixtral, phase_serve_vlm, phase_serve_whisper,
          phase_serve_xlstm, phase_train_kernels, phase_train,
          phase_train_zamba, phase_train_whisper, phase_train_xlstm,
          phase_train_vlm, phase_train_moe, phase_fig10, phase_dryrun,
          phase_simrt, phase_pool, phase_analyze, phase_dryrun_sweep]

REPLACES = {"rmsnorm": "src/repro/kernels/rmsnorm.py:31",
            "flash_attention": "src/repro/kernels/flash_attention.py:97",
            "mamba_scan": "src/repro/kernels/mamba_scan.py:79"}
ERRORS = {"rmsnorm": "rmsnorm_err", "add_rmsnorm": "add_rmsnorm_err",
          "flash_attention": "attention_err", "mamba_scan": "mamba_scan_err"}


TIMED = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
SERVED = (QWEN.name, ZAMBA.name, MIXTRAL.name, VISION.name, WHISPER.name,
          XLSTM.name)
K2_TIMES = ("flash_attention", "flash_attention_cross",
            "flash_attention_encoder")


def kernels_line(state):
    """One row per kernel, with the launch counts and times of the zamba2-7b
    path, the only one that runs all three; the RMSNorm row counts both of
    its entries' launches, lists each entry (the fused one timed at the
    Mamba block's add + ln) and each served path's launches of both; the
    flash-attention row also lists every served prefill shape (qwen3-8b's,
    zamba2-7b's, mixtral-8x7b's, llama-3.2-vision-11b's self and cross,
    whisper-tiny's encoder, self and cross) with each path's launches,
    and codeqwen1.5-7b's MHA shape (Fig 10's model) timed."""
    launches, times = state["launches"][ZAMBA.name], state["times"][ZAMBA.name]
    rows = []
    for name, replaces in REPLACES.items():
        t = times[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": state[ERRORS[name]],
            **{key: t[key] for key in TIMED}})
        if name == "rmsnorm":
            rows[-1]["launches"] += launches["add_rmsnorm"]
            rows[-1]["entries"] = [
                {"name": entry, "launches": launches[entry],
                 "max_abs_err": state[ERRORS[entry]],
                 **{key: times[entry][key] for key in TIMED}}
                for entry in ("rmsnorm", "add_rmsnorm")]
        if name == "rmsnorm":
            rows[-1]["by_path"] = [
                {"arch": arch, **{e: state["launches"][arch][e]
                                  for e in ("rmsnorm", "add_rmsnorm")}}
                for arch in SERVED]
        if name == "flash_attention":
            rows[-1]["by_shape"] = [
                _k2_shape(state, arch, key) for arch in SERVED
                for key in K2_TIMES if key in state["times"][arch]]
            rows[-1]["fig10_mha"] = {
                key: state["fig10_k2"][key] for key in TIMED + (
                    "library_deterministic_ms", "shape", "kv_heads")}
    rows += _backward_rows(state)
    return {"kernels": rows}


def _shape_rows(shapes):
    return [{"sq": sq, "skv": skv, "causal": causal, "launches": n}
            for (sq, skv, causal), n in sorted(shapes.items())]


def _k2_shape(state, arch, key):
    """One K2 shape of a served path: its times and the launches the
    path's serve phase made at that (Sq, Skv, causal), as the wrapper
    counted them."""
    t = state["times"][arch][key]
    launches = state["k2_shapes"][arch].get(
        (t["shape"][2], t["skv"], t["causal"]), 0)
    return {"arch": arch, "shape": t["shape"], "skv": t["skv"],
            "causal": t["causal"], "window": t["window"],
            "launches": launches,
            **{k: t[k] for k in TIMED + ("library_deterministic_ms",)}}


def _backward_rows(state):
    """The backward kernels (port only: the JAX package differentiates its
    jnp model): launches over the train runs of both models, the worst
    error of the train.kernels checks, times at the train shapes
    (qwen3-8b's for K1 and K2, zamba2-7b's for K3). ``replaces`` names the
    TPU kernel whose function they differentiate. The K1 row sums one call
    of each timed entry (q_norm, k_norm, add+ln) and lists zamba2-7b's
    out_norm at d 7168 and whisper-tiny's and xlstm-350m's widths beside
    them; the K2 row lists whisper-tiny's three shapes at D 64, the VLM's
    cross-attention (512 x 1,600) and codeqwen1.5-7b's MHA."""
    launches = {name: sum(runs[name]
                          for runs in state["train_launches"].values())
                for name in BWD_KERNELS}
    tk = state["train_kernels"]
    times, worst = tk["times"], tk["worst"]
    k1_calls = [times[c] for c in ("q_norm", "k_norm", "add+ln")]
    k1 = {key: sum(t[key] for t in k1_calls)
          for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    k1["bound_by"] = "bytes"
    att = times["attention"]
    return [
        {"name": "rmsnorm_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
         "replaces": REPLACES["rmsnorm"], "backward_of": "rmsnorm",
         "launches": launches["rmsnorm_bwd"] + launches["add_rmsnorm_bwd"],
         "max_abs_err": max(worst["rmsnorm_bwd"], worst["add_rmsnorm_bwd"]),
         **k1, "call": "q_norm + k_norm + add+ln",
         "out_norm": {key: times["out_norm"][key]
                      for key in TIMED + ("shape",)},
         "by_shape": [{"call": call, **{key: times[call][key]
                                        for key in TIMED + ("shape",)}}
                      for call in times if " d=" in call],
         "entries": [
             {"name": name, "launches": launches[name],
              "max_abs_err": worst[name],
              **{key: times[call][key] for key in TIMED}}
             for name, call in (("rmsnorm_bwd", "q_norm"),
                                ("add_rmsnorm_bwd", "add+ln"))]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": REPLACES["flash_attention"],
         "backward_of": "flash_attention",
         "launches": launches["flash_attention_bwd"],
         "max_abs_err": worst["flash_attention_bwd"],
         **{key: att[key] for key in TIMED + ("library_deterministic_ms",)},
         "shape": att["shape"],
         "by_shape": [{key: r[key] for key in TIMED + (
             "library_deterministic_ms", "shape", "skv", "kv_heads",
             "causal")}
             for r in times["attention_d64"] + [times["attention_cross"],
                                                times["attention_mha"]]]},
        {"name": "mamba_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mamba_scan_bwd.cu",
         "replaces": REPLACES["mamba_scan"], "backward_of": "mamba_scan",
         "launches": launches["mamba_scan_bwd"],
         "max_abs_err": worst["mamba_scan_bwd"],
         **{key: times["scan"][key] for key in TIMED},
         "shape": times["scan"]["shape"], "routes": SCAN_BWD_ROUTES,
         "kernels_ms": times["scan"]["kernels_ms"]}]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    state = {}
    for phase in PHASES:
        t0 = time.perf_counter()
        phase(state)
        emit({"phase": phase.__name__,
              "seconds": time.perf_counter() - t0})
    emit(kernels_line(state))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
