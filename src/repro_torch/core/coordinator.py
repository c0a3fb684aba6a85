"""Checkpoint coordinators + failure detection/propagation (paper §3.1, §6.1).

A copy of ``repro/core/coordinator.py`` for the PyTorch port.

Topology mirrors the paper: one coordinator per node, connected to the
node-local workers and to its peer coordinators; a single *primary*
coordinator runs the periodic checkpoint timer and messages the others, who
signal their local workers. Failure information enters through the
interception layer (the paper's poll/waitpid proxy; here, the runtime's
kill events), reaches the local coordinator, is propagated coordinator-to-
coordinator, and then fanned out to every surviving worker.

This module is runtime-agnostic: `simrt` drives it in virtual time; the
production launcher (`launch/train.py`) drives it from the step loop. The
pieces that need real-cluster plumbing (TCP heartbeats) are isolated behind
``Transport`` so the logic is identical in both worlds.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set


@dataclass
class ClusterTopology:
    """worker id -> node id placement. The paper places replicas on different
    nodes than their originals (latter half of the worker set)."""

    n_workers: int
    workers_per_node: int

    @property
    def n_nodes(self) -> int:
        return -(-self.n_workers // self.workers_per_node)

    def node_of(self, worker: int) -> int:
        return worker // self.workers_per_node

    def workers_on(self, node: int) -> List[int]:
        lo = node * self.workers_per_node
        return list(range(lo, min(lo + self.workers_per_node, self.n_workers)))


class Coordinator:
    """Per-node coordinator. The primary (node 0) owns the checkpoint timer."""

    def __init__(self, node: int, topology: ClusterTopology,
                 ckpt_interval_s: float, primary: bool = False):
        self.node = node
        self.topology = topology
        self.primary = primary
        self.ckpt_interval_s = ckpt_interval_s
        self.next_ckpt_s = ckpt_interval_s if primary else float("inf")
        self.known_dead: Set[int] = set()
        self.local_workers = set(topology.workers_on(node))

    # -- checkpoint timer (primary only) --------------------------------------

    def due_checkpoint(self, now_s: float) -> bool:
        return self.primary and now_s >= self.next_ckpt_s

    def restart_timer(self, now_s: float):
        """Paper §3.1.7: the timer restarts after checkpoint completion."""
        if self.primary:
            self.next_ckpt_s = now_s + self.ckpt_interval_s

    def set_interval(self, interval_s: float, now_s: float):
        self.ckpt_interval_s = interval_s
        if self.primary:
            self.next_ckpt_s = now_s + interval_s

    # -- failure intake (from the interception proxy) --------------------------

    def report_failure(self, workers: Sequence[int]) -> List[int]:
        """Returns newly-learned dead workers (to be propagated to peers)."""
        fresh = [w for w in workers if w not in self.known_dead]
        self.known_dead.update(fresh)
        return fresh

    def report_miscellaneous(self, poll_alive: Callable[[int], bool]) -> List[int]:
        """poll()-style detection: "some process died" without a PID — verify
        by polling every local worker (paper §6.1)."""
        fresh = [w for w in sorted(self.local_workers - self.known_dead)
                 if not poll_alive(w)]
        self.known_dead.update(fresh)
        return fresh


class CoordinatorSet:
    """All coordinators of a job + the propagation fabric between them."""

    def __init__(self, topology: ClusterTopology, ckpt_interval_s: float):
        self.topology = topology
        self.coordinators = [
            Coordinator(n, topology, ckpt_interval_s, primary=(n == 0))
            for n in range(topology.n_nodes)]
        self.propagations = 0
        self.dead_nodes: Set[int] = set()
        self._primary_idx = 0

    @property
    def primary(self) -> Coordinator:
        # primary migrates to the first node that still has live coordinators
        return self.coordinators[self._primary_idx]

    def _node_dead(self, node: int) -> bool:
        """A node's coordinator dies with its node: every local worker dead."""
        c = self.coordinators[node]
        return bool(c.local_workers) and c.local_workers <= c.known_dead

    def _migrate_primary(self):
        """Transfer the checkpoint timer to the first live coordinator
        (paper §3.1: a single primary owns the periodic timer)."""
        old = self.coordinators[self._primary_idx]
        for c in self.coordinators:
            if c.node not in self.dead_nodes:
                if c is old:
                    return
                c.primary = True
                c.ckpt_interval_s = old.ckpt_interval_s
                c.next_ckpt_s = old.next_ckpt_s
                old.primary = False
                self._primary_idx = c.node
                return
        # every node dead: keep the stale primary (job is over anyway)

    def intercept_failure(self, workers: Sequence[int]) -> List[int]:
        """Entry point of the interception layer: route each dead worker to
        its node coordinator, then propagate to all peers (fan-out)."""
        by_node: Dict[int, List[int]] = {}
        for w in workers:
            by_node.setdefault(self.topology.node_of(w), []).append(w)
        fresh_all: List[int] = []
        for node, ws in by_node.items():
            fresh = self.coordinators[node].report_failure(ws)
            fresh_all.extend(fresh)
        if fresh_all:
            # propagate to every other coordinator
            for c in self.coordinators:
                c.known_dead.update(fresh_all)
            self.propagations += 1
            for node in by_node:
                if self._node_dead(node):
                    self.dead_nodes.add(node)
            if self._primary_idx in self.dead_nodes:
                self._migrate_primary()
        return fresh_all

    def due_checkpoint(self, now_s: float) -> bool:
        return self.primary.due_checkpoint(now_s)

    def restart_timer(self, now_s: float):
        self.primary.restart_timer(now_s)

    def set_interval(self, interval_s: float, now_s: float = 0.0):
        for c in self.coordinators:
            c.set_interval(interval_s, now_s)
