"""Checkpoint-interval policy and efficiency models (paper Table 1, §7; a
copy of ``repro/core/ckpt_policy.py``).

Implements:
  * Young-Daly optimal interval  tau* = sqrt(2 mu C)   (paper Table 1)
  * Daly's first-order waste model for checkpoint/restart efficiency
  * replication MTTI (mean time to interruption) for dual redundancy —
    the birthday-problem growth that makes replication win at scale
    (Ferreira et al. [10], reproduced analytically + by simulation)
  * the crossover finder: smallest process count where replication beats
    checkpointing (the paper's 8192-core result)
  * the diskless (``store``) cost model: network-bound C for checkpoints
    pushed to partner memory instead of the parallel filesystem, combined-
    mode efficiency (replication + checkpoints against pair deaths at the
    MTTI rate), and the combined-vs-checkpoint crossover — which moves to
    a smaller process count when C is the memory store's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


def young_daly_interval(mtbf_s: float, ckpt_cost_s: float) -> float:
    """tau* = sqrt(2 mu C)."""
    if mtbf_s <= 0 or ckpt_cost_s < 0:
        raise ValueError("need mtbf > 0 and ckpt cost >= 0")
    return math.sqrt(2.0 * mtbf_s * ckpt_cost_s)


def daly_interval(mtbf_s: float, ckpt_cost_s: float) -> float:
    """Daly's higher-order optimum (better for C within ~2x of mu)."""
    c, mu = ckpt_cost_s, mtbf_s
    if c >= 2 * mu:
        return mu
    x = math.sqrt(c / (2 * mu))
    return math.sqrt(2 * c * mu) * (1 + x / 3 + (c / (2 * mu)) / 9) - c


def ckpt_efficiency(mtbf_s: float, ckpt_cost_s: float, restart_cost_s: float,
                    interval_s: float = 0.0) -> float:
    """Fraction of time doing useful work under checkpoint/restart.

    waste = C/tau (checkpoint overhead)
          + (tau/2 + R) / mu (expected rework + restart per failure)
    """
    tau = interval_s or young_daly_interval(mtbf_s, ckpt_cost_s)
    tau = max(tau, ckpt_cost_s)
    waste = ckpt_cost_s / tau + (tau / 2.0 + restart_cost_s) / mtbf_s
    return max(0.0, 1.0 - waste)


def replication_mtti(proc_mtbf_s: float, n_pairs: int) -> float:
    """MTTI of a dual-redundant job with n_pairs (original, replica) pairs.

    With exponential per-process failures, the expected time until some
    *pair* has lost both members grows like the birthday bound:
        MTTI ~ proc_mtbf * sqrt(pi / (4 n_pairs))
    (each failure "colours" a pair; a second hit on a coloured pair kills
    the job; sqrt(pi/2) / sqrt(2 n) after accounting for the two-member
    rate). Exact small-n behaviour is covered by the simulator in
    the JAX package's core/failure_sim.py; its tests cross-check the two.
    """
    if n_pairs <= 0:
        raise ValueError("n_pairs must be positive")
    return proc_mtbf_s * math.sqrt(math.pi / (4.0 * n_pairs))


def replication_efficiency(job_mtbf_s: float, n_procs: int,
                           runtime_s: float,
                           repair_cost_s: float = 1.0,
                           restart_cost_s: float = 60.0,
                           ckpt_cost_s: float = 0.0) -> float:
    """Useful fraction for FULL replication on n_procs cores.

    Redundancy halves throughput (0.5 factor). Each *process* failure costs
    only ``repair_cost_s`` (communicator repair + message recovery, no
    rollback — paper Fig 9). Pair-death events force a restart; with pure
    replication (no checkpointing) the whole run restarts, so we require
    MTTI >> runtime for this model (the paper's regime).
    """
    proc_mtbf = job_mtbf_s * n_procs          # per-process MTBF
    n_pairs = n_procs // 2
    mtti = replication_mtti(proc_mtbf, n_pairs)
    # process-failure repair overhead (failures at job MTBF rate)
    repair_waste = repair_cost_s / job_mtbf_s
    # pair-death: probability runtime has a job-killing event
    pair_waste = (runtime_s / 2.0 + restart_cost_s) / mtti if mtti > 0 else 1.0
    pair_waste = min(pair_waste, 1.0)
    eff = 0.5 * (1.0 - repair_waste) * (1.0 - pair_waste)
    return max(0.0, eff)


# -- diskless checkpointing (store) -------------------------------------------

# 100 Gb/s NIC per node, the ReStore-style partner-push regime
DEFAULT_NET_BW_BPS = 12.5e9
DEFAULT_NET_LATENCY_S = 100e-6


def memstore_ckpt_cost(state_bytes: float, *, n_partners: int = 2,
                       net_bw_Bps: float = DEFAULT_NET_BW_BPS,
                       net_latency_s: float = DEFAULT_NET_LATENCY_S,
                       n_messages: int = 8, topo=None) -> float:
    """Network-bound checkpoint cost C of the in-memory store.

    Each process pushes its ``state_bytes`` to ``n_partners`` partner
    memories (banded into ``n_messages`` point-to-point messages each);
    pushes across processes overlap, so per-process C is the serialized
    partner copies over the NIC plus message latencies.  Unlike disk C it
    does NOT grow with the aggregate job size — that is what moves the
    combined-mode crossover to smaller process counts.

    ``topo`` (a topo.TopoCostModel) derives C from the topology's
    α‑β estimator — hop-weighted latencies over the actual graph — in
    place of the flat constants; on a flat graph with the default α/β the
    two are identical.
    """
    if topo is not None:
        return topo.memstore_ckpt_cost(state_bytes, n_partners=n_partners,
                                       n_messages=n_messages)
    if state_bytes < 0 or n_partners < 1 or net_bw_Bps <= 0:
        raise ValueError("need state_bytes >= 0, n_partners >= 1, bw > 0")
    return (n_partners * state_bytes / net_bw_Bps
            + n_partners * n_messages * net_latency_s)


def memstore_restore_cost(state_bytes: float, *,
                          net_bw_Bps: float = DEFAULT_NET_BW_BPS,
                          relaunch_s: float = 60.0, topo=None) -> float:
    """Pull the shards back from one surviving partner + job relaunch.
    No parallel-filesystem reload: the dominant term is the relaunch.
    ``topo`` delegates to the topology estimator (same flat-graph
    equivalence as memstore_ckpt_cost)."""
    if topo is not None:
        return topo.memstore_restore_cost(state_bytes, relaunch_s=relaunch_s)
    if state_bytes < 0 or net_bw_Bps <= 0:
        raise ValueError("need state_bytes >= 0 and bw > 0")
    return state_bytes / net_bw_Bps + relaunch_s


def combined_efficiency(job_mtbf_s: float, n_procs: int,
                        ckpt_cost_s: float = None,
                        restart_cost_s: float = None, *,
                        repair_cost_s: float = 1.0,
                        interval_s: float = 0.0,
                        topo=None, state_bytes: float = None,
                        relaunch_s: float = 60.0) -> float:
    """Useful fraction for the COMBINED mode on n_procs cores.

    Redundancy halves throughput (0.5).  Single-process failures cost only
    the O(1) promotion repair; pair deaths arrive at the replication MTTI
    and are absorbed by checkpoint/restart with the Young-Daly interval
    tuned to that MTTI — so the combined mode's waste is governed by ITS
    backend's C (disk, or the memory store's network-bound C).

    Pass ``topo`` (topo.TopoCostModel) + ``state_bytes`` to derive
    C and R from the topology estimators instead of hand-fed constants.
    """
    if topo is not None and state_bytes is not None:
        if ckpt_cost_s is None:
            ckpt_cost_s = topo.memstore_ckpt_cost(state_bytes)
        if restart_cost_s is None:
            restart_cost_s = topo.memstore_restore_cost(
                state_bytes, relaunch_s=relaunch_s)
    if ckpt_cost_s is None or restart_cost_s is None:
        raise ValueError("pass ckpt_cost_s/restart_cost_s, or topo + "
                         "state_bytes to derive them")
    proc_mtbf = job_mtbf_s * n_procs
    mtti = replication_mtti(proc_mtbf, max(n_procs // 2, 1))
    repair_waste = min(repair_cost_s / job_mtbf_s, 1.0)
    eff = ckpt_efficiency(mtti, ckpt_cost_s, restart_cost_s,
                          interval_s=interval_s)
    return max(0.0, 0.5 * (1.0 - repair_waste) * eff)


def combined_crossover_processes(base_procs: int, base_mtbf_s: float,
                                 base_ckpt_cost_s: float, *,
                                 combined_ckpt_cost_s: float = None,
                                 restart_cost_s: float = 60.0,
                                 combined_restart_cost_s: float = None,
                                 repair_cost_s: float = 1.0,
                                 max_doublings: int = 12,
                                 steps_per_doubling: int = 8,
                                 ckpt_growth: float = 1.6,
                                 topo=None, state_bytes: float = None,
                                 relaunch_s: float = 60.0) -> int:
    """Smallest process count where COMBINED-mode efficiency exceeds plain
    checkpoint/restart.

    The checkpoint baseline always pays the disk C (growing ``ckpt_growth``
    per doubling, per the paper's Table 1); the combined mode pays its own
    backend's C: pass ``combined_ckpt_cost_s`` = the memory store's
    network-bound C (scale-free) for the diskless variant, or leave None to
    share the disk C.  ``topo`` + ``state_bytes`` derive the combined C/R
    from the topology estimators (hop-weighted α‑β over the graph), so the
    crossover moves per topology.  The scan is finer than doublings so
    nearby crossovers of the two backends resolve to different counts.
    """
    if topo is not None and state_bytes is not None:
        if combined_ckpt_cost_s is None:
            combined_ckpt_cost_s = topo.memstore_ckpt_cost(state_bytes)
        if combined_restart_cost_s is None:
            combined_restart_cost_s = topo.memstore_restore_cost(
                state_bytes, relaunch_s=relaunch_s)
    for i in range(max_doublings * steps_per_doubling + 1):
        factor = 2.0 ** (i / steps_per_doubling)
        p = int(round(base_procs * factor))
        mu = base_mtbf_s / factor
        c_disk = base_ckpt_cost_s * ckpt_growth ** math.log2(factor)
        c_cmb = combined_ckpt_cost_s if combined_ckpt_cost_s is not None \
            else c_disk
        r_cmb = combined_restart_cost_s if combined_restart_cost_s \
            is not None else restart_cost_s
        if combined_efficiency(mu, p, c_cmb, r_cmb,
                               repair_cost_s=repair_cost_s) > \
                ckpt_efficiency(mu, c_disk, restart_cost_s):
            return p
    return -1


@dataclass
class ScalingPoint:
    n_procs: int
    job_mtbf_s: float
    ckpt_cost_s: float
    ckpt_eff: float
    repl_eff: float


def scaling_study(base_procs: int, base_mtbf_s: float, base_ckpt_cost_s: float,
                  runtime_s: float, n_doublings: int = 4,
                  restart_cost_s: float = 60.0,
                  ckpt_growth: float = 1.6) -> list:
    """Reproduces the paper's Fig 7/8 structure analytically: MTBF halves per
    doubling, checkpoint cost grows with data volume (paper Table 1 shows
    46 -> 215 s for HPCG across 1024 -> 8192 procs ~= 1.6x per doubling)."""
    out = []
    for i in range(n_doublings + 1):
        p = base_procs * (2 ** i)
        mu = base_mtbf_s / (2 ** i)
        c = base_ckpt_cost_s * (ckpt_growth ** i)
        out.append(ScalingPoint(
            n_procs=p, job_mtbf_s=mu, ckpt_cost_s=c,
            ckpt_eff=ckpt_efficiency(mu, c, restart_cost_s),
            repl_eff=replication_efficiency(mu, p, runtime_s,
                                            restart_cost_s=restart_cost_s)))
    return out


def crossover_processes(base_procs: int, base_mtbf_s: float,
                        base_ckpt_cost_s: float, runtime_s: float,
                        max_doublings: int = 12) -> int:
    """Smallest process count at which replication efficiency exceeds
    checkpointing efficiency (paper: 8192 at mu=2000s for HPCG)."""
    for pt in scaling_study(base_procs, base_mtbf_s, base_ckpt_cost_s,
                            runtime_s, n_doublings=max_doublings):
        if pt.repl_eff > pt.ckpt_eff:
            return pt.n_procs
    return -1
