"""Dispatch-order policies for the pool master (a copy of
``repro/pool/scheduling.py``).

A policy turns the submitted task list into the master's dispatch queue
once, up front; the master then pops from the front as workers free up
(requeued tasks from retired ranks go back to the *head* — they are the
oldest work in the system).  Every policy is deterministic, including
its tie-breaks (submission index), so the dispatch schedule — and with
it the whole run — is a pure function of (tasks, failures).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Type


class SchedulingPolicy:
    """Order the submitted tasks into the master's dispatch queue."""

    name = "policy"

    def order(self, tasks: Sequence) -> List:
        raise NotImplementedError


class FifoPolicy(SchedulingPolicy):
    """Submission order, unchanged."""

    name = "fifo"

    def order(self, tasks: Sequence) -> List:
        return list(tasks)


class LptPolicy(SchedulingPolicy):
    """Longest Processing Time first: heaviest ``cost_rounds`` dispatched
    first (the classic list-scheduling heuristic — big tasks early keeps
    the makespan tail short); ties break by submission index."""

    name = "lpt"

    def order(self, tasks: Sequence) -> List:
        indexed = list(enumerate(tasks))
        indexed.sort(key=lambda p: (-p[1].cost_rounds, p[0]))
        return [t for _i, t in indexed]


POLICIES: Dict[str, Type[SchedulingPolicy]] = {
    FifoPolicy.name: FifoPolicy,
    LptPolicy.name: LptPolicy,
}


def make_policy(name: str) -> SchedulingPolicy:
    try:
        return POLICIES[name]()
    except KeyError:
        raise ValueError(f"unknown scheduling policy {name!r}; "
                         f"expected one of {sorted(POLICIES)}") from None
