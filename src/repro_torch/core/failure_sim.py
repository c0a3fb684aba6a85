"""Failure injection: Weibull process-level kills + node-level log replay
(a copy of ``repro/core/failure_sim.py``; numpy only, so both packages draw
the same schedules from the same seeds).

Two generators, both used by the paper (§7):
  * WeibullInjector — inter-arrival times ~ Weibull(shape 0.7), which
    Schroeder & Gibson showed matches real HPC failure traces. Each event
    kills one uniformly-random alive worker (process-level).
  * LogReplayInjector — replays a node-failure log (Tsubame-3 style:
    absolute event times + node names), time-scaled; each event kills every
    worker on the named node. Repeated node names hit the same node again,
    exactly as in the paper's log-based simulations (Fig 13).

A synthetic-but-statistically-matched Tsubame-like log generator is included
(bursty arrivals, heavy-tailed per-node counts) so benchmarks run offline.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class FailureEvent:
    time_s: float
    workers: Tuple[int, ...]        # worker ids killed at this instant
    node: Optional[str] = None


class WeibullInjector:
    """Process-level failures with Weibull(shape) inter-arrival times whose
    mean equals ``mtbf_s`` (scale = mtbf / Gamma(1 + 1/shape))."""

    def __init__(self, mtbf_s: float, shape: float = 0.7, seed: int = 0):
        if mtbf_s <= 0:
            raise ValueError("mtbf must be positive")
        self.mtbf_s = mtbf_s
        self.shape = shape
        self.scale = mtbf_s / math.gamma(1.0 + 1.0 / shape)
        self.rng = np.random.default_rng(seed)

    def draw_interval(self) -> float:
        return float(self.scale * self.rng.weibull(self.shape))

    def schedule(self, horizon_s: float, alive_workers) -> List[FailureEvent]:
        """Pre-draw all failures within the horizon against a *fixed* worker
        set (the runtime re-queries alive workers at delivery time)."""
        events, t = [], 0.0
        workers = list(alive_workers)
        while True:
            t += self.draw_interval()
            if t >= horizon_s:
                break
            victim = int(self.rng.choice(workers))
            events.append(FailureEvent(time_s=t, workers=(victim,)))
        return events

    def next_failure(self, now_s: float, alive_workers) -> FailureEvent:
        victim = int(self.rng.choice(list(alive_workers)))
        return FailureEvent(time_s=now_s + self.draw_interval(),
                            workers=(victim,))


class LogReplayInjector:
    """Node-level failure replay (paper Fig 13).

    log: sequence of (time_s, node_name). time_scale < 1 compresses time
    (the paper scales Tsubame-3 gaps by 1/100 to reach MTBF ~ 2308 s).
    node_of: worker id -> node name.
    """

    def __init__(self, log: Sequence[Tuple[float, str]],
                 workers_per_node: int, n_workers: int,
                 time_scale: float = 1.0):
        self.events_raw = sorted(log, key=lambda e: e[0])
        self.time_scale = time_scale
        self.workers_per_node = workers_per_node
        self.n_workers = n_workers
        nodes = sorted({n for _, n in log})
        self.node_index = {n: i for i, n in enumerate(nodes)}

    def node_workers(self, node: str) -> Tuple[int, ...]:
        i = self.node_index[node]
        n_nodes = max(1, self.n_workers // self.workers_per_node)
        base = (i % n_nodes) * self.workers_per_node
        return tuple(range(base, min(base + self.workers_per_node,
                                     self.n_workers)))

    def schedule(self, horizon_s: float, alive_workers=None) -> List[FailureEvent]:
        t0 = self.events_raw[0][0] if self.events_raw else 0.0
        out = []
        for t, node in self.events_raw:
            ts = (t - t0) * self.time_scale
            if ts >= horizon_s:
                break
            out.append(FailureEvent(time_s=ts, workers=self.node_workers(node),
                                    node=node))
        return out

    @property
    def mtbf_s(self) -> float:
        ev = self.events_raw
        if len(ev) < 2:
            return float("inf")
        span = (ev[-1][0] - ev[0][0]) * self.time_scale
        return span / (len(ev) - 1)


def synth_tsubame_log(n_nodes: int = 256, n_events: int = 120,
                      mtbf_target_s: float = 2308.0, burstiness: float = 0.35,
                      seed: int = 7) -> List[Tuple[float, str]]:
    """Synthetic node-failure log statistically shaped like the Tsubame-3
    trace as described in the paper: bursty arrivals (a fraction of events
    lands within minutes of the previous one) and a heavy-tailed node
    distribution (some nodes fail repeatedly)."""
    rng = np.random.default_rng(seed)
    # heavy-tailed node popularity (zipf-ish)
    pop = 1.0 / np.arange(1, n_nodes + 1) ** 1.2
    pop /= pop.sum()
    node_ids = rng.choice(n_nodes, size=n_events, p=pop)
    times, t = [], 0.0
    for _ in range(n_events):
        if rng.random() < burstiness:
            t += float(rng.exponential(mtbf_target_s * 0.05))   # burst
        else:
            t += float(rng.exponential(mtbf_target_s / (1 - burstiness)))
        times.append(t)
    # rescale to hit the target MTBF exactly
    span = times[-1] - times[0]
    scale = mtbf_target_s * (n_events - 1) / span if span > 0 else 1.0
    return [(tt * scale, f"node{int(n):04d}") for tt, n in zip(times, node_ids)]


def empirical_pair_mtti(proc_mtbf_s: float, n_pairs: int, seed: int = 0,
                        trials: int = 200) -> float:
    """Monte-Carlo MTTI of dual redundancy (cross-checks ckpt_policy math)."""
    rng = np.random.default_rng(seed)
    rate = 1.0 / proc_mtbf_s
    total = 0.0
    for _ in range(trials):
        t = 0.0
        hit = np.zeros(n_pairs, dtype=bool)
        while True:
            n_alive = 2 * n_pairs - hit.sum()
            t += float(rng.exponential(1.0 / (rate * n_alive)))
            # pick a victim uniformly among alive members
            probs = np.where(hit, 1.0, 2.0)
            probs = probs / probs.sum()
            pair = int(rng.choice(n_pairs, p=probs))
            if hit[pair]:
                break
            hit[pair] = True
        total += t
    return total / trials
