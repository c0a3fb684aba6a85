"""Recovery planning (port of ``repro/core/shrink.py``): the paper's §6.2
"repairing the world" as a pure planner. Given a failure event, decide

  * continue           — only replicas died; drop them;
  * promote            — a computational worker died with a live replica:
    the replica slice becomes computational (no rollback, no restore);
  * restart_elastic    — some rank lost both copies: restore the last
    checkpoint, possibly with fewer workers / lower replication degree.

The JAX package's planner can also cost a restore from its replicated
in-memory store; the port has no store yet (ROADMAP.md), so every restart
is planned against the last checkpoint step, as the reference plans it
without a store.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

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
    restore_backend: str = "disk"
    # cost components (seconds) for the time-accounting model
    repair_cost_s: float = 0.0
    restore_cost_s: float = 0.0


def plan_recovery(rmap: ReplicaMap, failed: Sequence[int], *,
                  last_ckpt_step: int, current_step: int,
                  respawn: bool = True,
                  repair_cost_s: float = 0.005,
                  restore_cost_s: float = 1.0
                  ) -> Tuple[ReplicaMap, RecoveryPlan]:
    """Returns (new_rmap, plan). new_rmap is rmap mutated (promote/drop) or a
    fresh elastic map when a restart is required."""
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
        plan = RecoveryPlan(
            kind="restart_elastic", failed_workers=tuple(failed),
            needs_restore=True, rollback_to_step=last_ckpt_step,
            new_replication_degree=new_map.replication_degree(),
            new_world_size=new_map.world_size, restore_backend="disk",
            repair_cost_s=repair_cost_s, restore_cost_s=restore_cost_s)
        return new_map, plan
