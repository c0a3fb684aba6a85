"""Task vocabulary for the elastic master/worker pool (a copy of
``repro/pool/task.py``).

A :class:`Task` is the unit the master dispatches: a named *program*
(looked up in ``pool.workloads.PROGRAMS``), an opaque payload of
plain parameters, a deterministic per-task seed, and a cost hint in
scheduler rounds.  Determinism contract: executing the same task dict
always produces a bit-identical value, which is what lets a replica
finish a dead worker's task without re-dispatch and lets a reassigned
task land on a different worker with the same result.

Idempotency: ``task_id`` is the task's idempotency key at the pool
layer (the master's result table is set-once; late duplicates from
speculative or replayed executions are counted, not applied), and the
wire layer below reuses the transport's per-(src, dst, tag) send-ID
machinery — a replayed directive or status arrives with the send-ID it
was logged under, so the receiver cursors drop byte-identical
duplicates before the pool ever sees them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List


def task_seed(pool_seed: int, index: int) -> int:
    """Deterministic per-task seed from the pool seed and task index
    (an LCG-style mix — avoids handing adjacent tasks adjacent seeds)."""
    return (pool_seed * 1_000_003 + 7919 * index + 12345) % (1 << 63)


@dataclass(frozen=True)
class Task:
    """One dispatchable unit of work."""

    task_id: str                         # idempotency key (unique in pool)
    program: str                         # name in pool.workloads.PROGRAMS
    payload: Dict[str, Any] = field(default_factory=dict)
    seed: int = 0                        # deterministic per-task seed
    cost_rounds: int = 1                 # cost hint: scheduler rounds

    def as_dict(self) -> Dict[str, Any]:
        """The wire form the master dispatches (plain data; the transport
        freezes it copy-on-write like any payload)."""
        return {"task_id": self.task_id, "program": self.program,
                "payload": dict(self.payload), "seed": self.seed,
                "cost_rounds": self.cost_rounds}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Task":
        return Task(task_id=d["task_id"], program=d["program"],
                    payload=dict(d["payload"]), seed=d["seed"],
                    cost_rounds=d["cost_rounds"])


@dataclass(frozen=True)
class TaskResult:
    """A completed task as the master records it."""

    task_id: str
    value: Any
    worker_rank: int
    latency_rounds: int


def make_tasks(specs: List[dict], *, pool_seed: int = 0) -> List[Task]:
    """Build a task list from plain spec dicts, assigning sequential
    task_ids and deterministic per-index seeds."""
    out = []
    for i, spec in enumerate(specs):
        out.append(Task(
            task_id=spec.get("task_id", f"t{i:04d}"),
            program=spec["program"],
            payload=dict(spec.get("payload", {})),
            seed=spec.get("seed", task_seed(pool_seed, i)),
            cost_rounds=int(spec.get("cost_rounds", 1))))
    return out
