"""Replica-map algebra: the paper's process-role bookkeeping (§3.2, §6.2).

A copy of ``repro/core/replica_map.py`` (no jax in either), kept so the
PyTorch port imports nothing of the JAX package.

The application runs N logical ranks; M <= N of them are replicated
(partial replication). Workers 0..N-1 start as computational processes for
ranks 0..N-1; workers N..N+M-1 start as replicas of ranks 0..M-1.

The paper's six communicators map to derived groups:
  eworldComm            -> alive()
  EMPI_COMM_CMP         -> cmp_group()
  EMPI_COMM_REP         -> rep_group()
  EMPI_CMP_NO_REP       -> no_rep_group()
  (the two intercomms are implicit in the rank<->worker maps)

Failure handling (paper §6.2): a dead replica is dropped; a dead
computational worker with a live replica triggers *promotion* — the replica
becomes the computational process and "it is considered that the replica was
the one that had failed". If both copies of a rank die the job must restart
from the last checkpoint (ApplicationDead).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple


class ApplicationDead(Exception):
    """Both copies of some rank have failed: restart from checkpoint.

    ``events`` carries the repairs that WERE applied before/alongside the
    fatal death (promotions, replica drops) and ``dead_ranks`` every rank
    that lost both copies — so a batch failure leaves the map consistent
    and fully described for ``restart_map``.
    """

    def __init__(self, rank: int, events: Optional[List[dict]] = None,
                 dead_ranks: Optional[List[int]] = None):
        super().__init__(f"rank {rank}: computational and replica both dead")
        self.rank = rank
        self.events = events or []
        self.dead_ranks = dead_ranks if dead_ranks is not None else [rank]


@dataclass
class ReplicaMap:
    n: int                                   # logical ranks
    m: int                                   # replicated ranks (<= n)
    cmp: Dict[int, Optional[int]] = field(default_factory=dict)
    rep: Dict[int, Optional[int]] = field(default_factory=dict)
    dead: Set[int] = field(default_factory=set)
    # ranks taken out of service by an elastic workload (repro.pool):
    # unlike a dead rank these are a *planned* shrink — the invariants
    # tolerate them and restart_map forgets them (a fresh world respawns
    # every rank)
    retired: Set[int] = field(default_factory=set)
    promotions: int = 0
    # worker -> (role, rank) reverse index, maintained by every mutation:
    # role_of is called once per send and once per worker per step, so a
    # linear scan here turns the whole simulator O(N^2) regardless of how
    # fast the transport is
    _roles: Dict[int, Tuple[str, int]] = field(default_factory=dict,
                                               repr=False, compare=False)

    def __post_init__(self):
        if not 0 <= self.m <= self.n:
            raise ValueError(f"need 0 <= M <= N, got N={self.n} M={self.m}")
        if not self.cmp:
            self.cmp = {r: r for r in range(self.n)}
            self.rep = {r: (self.n + r if r < self.m else None)
                        for r in range(self.n)}
        self._roles = {}
        for r in range(self.n):
            if self.cmp[r] is not None:
                self._roles[self.cmp[r]] = ("cmp", r)
            if self.rep[r] is not None:
                self._roles[self.rep[r]] = ("rep", r)

    # -- queries ------------------------------------------------------------

    @property
    def world_size(self) -> int:
        return self.n + self.m

    def alive(self) -> List[int]:
        return [w for w in range(self.world_size) if w not in self.dead]

    def cmp_group(self) -> List[int]:
        return [self.cmp[r] for r in range(self.n)]

    def rep_group(self) -> List[int]:
        return [self.rep[r] for r in range(self.n) if self.rep[r] is not None]

    def no_rep_group(self) -> List[int]:
        return [self.cmp[r] for r in range(self.n) if self.rep[r] is None]

    def replicated_ranks(self) -> List[int]:
        return [r for r in range(self.n) if self.rep[r] is not None]

    def role_of(self, worker: int):
        """-> ("cmp"|"rep", rank) or ("dead", -1). O(1)."""
        if worker in self.dead:
            return ("dead", -1)
        return self._roles.get(worker, ("dead", -1))

    def rank_alive(self, rank: int) -> bool:
        return self.cmp[rank] is not None

    def active_ranks(self) -> List[int]:
        """Ranks still in service (live cmp worker, not retired)."""
        return [r for r in range(self.n)
                if r not in self.retired and self.cmp[r] is not None]

    def replication_degree(self) -> float:
        return len(self.replicated_ranks()) / self.n

    # -- mutation (paper §6.2 shrink semantics) -------------------------------

    def fail(self, worker: int) -> dict:
        """Process worker death. Returns an event dict describing the repair.

        Raises ApplicationDead if a rank loses both copies.
        """
        if worker in self.dead:
            return {"kind": "noop", "worker": worker}
        self.dead.add(worker)
        role, rank = self._roles.pop(worker, ("dead", -1))
        if role == "rep":
            self.rep[rank] = None
            return {"kind": "drop_replica", "worker": worker, "rank": rank}
        if role == "cmp":
            promoted = self.rep[rank]
            if promoted is None:
                self.cmp[rank] = None
                raise ApplicationDead(rank)
            # promotion: replica becomes computational; afterwards it is as
            # if the replica had failed (paper wording)
            self.cmp[rank] = promoted
            self.rep[rank] = None
            self._roles[promoted] = ("cmp", rank)
            self.promotions += 1
            return {"kind": "promote", "worker": worker, "rank": rank,
                    "promoted": promoted}
        return {"kind": "noop", "worker": worker}

    def retire_rank(self, rank: int) -> dict:
        """Take a logical rank out of service (elastic task-pool shrink,
        the forward-recovery alternative to ApplicationDead): both of its
        workers are recorded dead, the slot is cleared, and the rank joins
        ``retired`` — the invariants accept the hole and the remaining
        world continues without a restart.  Returns the event dict."""
        dropped = []
        for wid in (self.cmp.get(rank), self.rep.get(rank)):
            if wid is not None:
                self.dead.add(wid)
                self._roles.pop(wid, None)
                dropped.append(wid)
        self.cmp[rank] = None
        self.rep[rank] = None
        self.retired.add(rank)
        return {"kind": "retire_rank", "rank": rank, "workers": dropped}

    def fail_many(self, workers) -> List[dict]:
        """Simultaneous (node-level) failure: all deaths are recorded before
        any promotion decision, matching the paper's node-failure handling.

        Every death in the batch is processed (promotions that succeed are
        applied and kept); if any rank loses both copies, ApplicationDead is
        raised AFTER the whole batch, carrying the applied ``events`` and all
        ``dead_ranks`` — the map stays consistent for ``restart_map``.
        """
        events: List[dict] = []
        dead_ranks: List[int] = []
        pending = [w for w in workers if w not in self.dead]
        self.dead.update(pending)
        for w in pending:
            # a worker whose slot was already cleared by an earlier death in
            # this batch (its rank went dead, or it was the doomed replica of
            # a promoted rank) has no entry left — and, like the pre-index
            # scan, produces no event of its own
            role_rank = self._roles.pop(w, None)
            if role_rank is None:
                continue
            role, r = role_rank
            if role == "cmp":
                promoted = self.rep[r]
                if promoted is not None and promoted in self.dead:
                    self._roles.pop(promoted, None)
                    promoted = None
                if promoted is None:
                    self.cmp[r] = None
                    self.rep[r] = None
                    dead_ranks.append(r)
                    events.append({"kind": "rank_dead", "worker": w,
                                   "rank": r})
                else:
                    self.cmp[r] = promoted
                    self.rep[r] = None
                    self._roles[promoted] = ("cmp", r)
                    self.promotions += 1
                    events.append({"kind": "promote", "worker": w,
                                   "rank": r, "promoted": promoted})
            else:
                self.rep[r] = None
                events.append({"kind": "drop_replica", "worker": w,
                               "rank": r})
        if dead_ranks:
            raise ApplicationDead(dead_ranks[0], events=events,
                                  dead_ranks=dead_ranks)
        return events

    # -- invariants (property-tested) ----------------------------------------

    def check_invariants(self) -> None:
        seen = set()
        for r in range(self.n):
            if r in self.retired:
                assert self.cmp[r] is None and self.rep[r] is None, \
                    f"retired rank {r} still holds workers"
                continue
            c = self.cmp[r]
            assert c is not None, f"rank {r} has no computational worker"
            assert c not in self.dead, f"rank {r} cmp worker {c} is dead"
            assert c not in seen, f"worker {c} owns two ranks"
            seen.add(c)
            p = self.rep[r]
            if p is not None:
                assert p not in self.dead
                assert p not in seen
                seen.add(p)

    def restart_map(self, n_workers: int) -> "ReplicaMap":
        """Elastic restart (paper §3.3): rebuild roles for a *different*
        worker count. Keeps N logical ranks; replication degree shrinks to
        whatever the spare workers allow."""
        if n_workers < self.n:
            raise ValueError(
                f"cannot restart {self.n} ranks on {n_workers} workers")
        m = min(self.n, n_workers - self.n)
        return ReplicaMap(self.n, m)
