"""Recovery planning (port of ``repro/core/shrink.py``): the paper's §6.2
"repairing the world" as a pure planner. Given a failure event, decide

  * continue           — only replicas died; drop them;
  * promote            — a computational worker died with a live replica:
    the replica slice becomes computational (no rollback, no restore);
  * restart_elastic    — some rank lost both copies: restore the last
    checkpoint, possibly with fewer workers / lower replication degree.

With the replicated in-memory store (``store.MemStore``) a restart rolls
back to the store's durable generation and is costed at the store's
network-bound restore instead of the disk one.  Also estimates the repair
cost components (paper Fig 9: repair is communicator recreation + message
recovery, and is tiny next to checkpoint-restore-rollback).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.core import ckpt_policy
from repro_torch.core.replica_map import ApplicationDead, ReplicaMap


@dataclass
class RecoveryPlan:
    kind: str                                  # continue|promote|restart_elastic
    failed_workers: Tuple[int, ...]
    promotions: List[dict] = field(default_factory=list)
    needs_restore: bool = False
    rollback_to_step: Optional[int] = None
    new_replication_degree: float = 1.0
    new_world_size: int = 0
    # which durability layer serves the restore: "disk" (an on-disk
    # checkpoint), "memory" (store shards pulled from partner memory), or
    # "scratch" (a memory-backed world whose store cannot serve: restart
    # from deterministic init)
    restore_backend: str = "disk"
    # cost components (seconds) for the time-accounting model
    repair_cost_s: float = 0.0
    restore_cost_s: float = 0.0


def plan_recovery(rmap: ReplicaMap, failed: Sequence[int], *,
                  last_ckpt_step: int, current_step: int,
                  respawn: bool = True,
                  repair_cost_s: float = 0.005,
                  restore_cost_s: float = 1.0,
                  store=None) -> Tuple[ReplicaMap, RecoveryPlan]:
    """Returns (new_rmap, plan). new_rmap is rmap mutated (promote/drop) or a
    fresh elastic map when a restart is required.

    ``store`` is an optional ``store.MemStore``: when it holds a durable
    generation, a restart plan rolls back to THAT generation's step and is
    costed at the store's network-bound restore instead of the disk one.
    """
    try:
        events = rmap.fail_many(list(failed))
        promotions = [e for e in events if e["kind"] == "promote"]
        kind = "promote" if promotions else "continue"
        plan = RecoveryPlan(
            kind=kind, failed_workers=tuple(failed),
            promotions=promotions,
            new_replication_degree=rmap.replication_degree(),
            new_world_size=len(rmap.alive()),
            repair_cost_s=repair_cost_s)
        rmap.check_invariants()
        return rmap, plan
    except ApplicationDead:
        n_workers = rmap.world_size if respawn else len(rmap.alive())
        new_map = rmap.restart_map(max(n_workers, rmap.n))
        rollback_to, backend = last_ckpt_step, "disk"
        if store is not None:
            durable = store.durable()
            # the plan must not promise a memory restore the store cannot
            # serve once these deaths take their shard memory with them;
            # a memory-backed caller has no disk either, so the honest
            # fallback label is "scratch"
            if durable is not None and \
                    store.recoverable_without(list(failed)):
                backend = "memory"
                rollback_to = durable[1]
                restore_cost_s = ckpt_policy.memstore_restore_cost(
                    store.committed_bytes / max(rmap.n, 1))
            else:
                backend = "scratch"
                rollback_to = 0
        plan = RecoveryPlan(
            kind="restart_elastic", failed_workers=tuple(failed),
            needs_restore=True, rollback_to_step=rollback_to,
            new_replication_degree=new_map.replication_degree(),
            new_world_size=new_map.world_size, restore_backend=backend,
            repair_cost_s=repair_cost_s, restore_cost_s=restore_cost_s)
        return new_map, plan
