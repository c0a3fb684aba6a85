"""FT strategies (port of ``repro/ft/strategy.py``: ``NoFT`` and
``ReplicationStrategy``; the checkpoint strategies wait for the training
slice, ROADMAP.md).

  NoFT                 native step loop (the "EMPI direct" baseline)
  ReplicationStrategy  a replica redundantly executes every step; on
                       computational failure the replica is promoted in O(1)
                       (state already current — no restore, no rollback)

A strategy is bound to one FTSession, which owns the coordinators, the
replica map and the recovery planner; the strategy decides what to do with
each RecoveryPlan.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.configs.base import FTConfig
from repro_torch.tree import copy_tree


class FTStrategy:
    mode = "none"
    wants_replica = False

    def __init__(self, ft: Optional[FTConfig] = None):
        self.ft = ft or FTConfig(mode=self.mode)
        self.session = None
        self.last_ckpt_step = 0

    def bind(self, session) -> "FTStrategy":
        self.session = session
        return self

    def n_replica_workers(self, n: int) -> int:
        return 0

    # -- lifecycle hooks -----------------------------------------------------

    def on_start(self, workload, state, rep) -> None:
        self.last_ckpt_step = 0

    def step(self, workload, state, t) -> Tuple[Any, Any]:
        return workload.step(state, t)

    def handle_plan(self, workload, state, plan, step, rep):
        """Execute a RecoveryPlan; returns (state, step)."""
        if plan.kind == "promote":
            return self._on_promote(workload, state, plan, step, rep)
        if plan.kind == "restart_elastic":
            return self._on_restart(workload, state, step, rep)
        return state, step                       # "continue": replicas dropped

    # -- plan execution ------------------------------------------------------

    def _on_promote(self, workload, state, plan, step, rep):
        rep.promotions += len(plan.promotions)
        return state, step

    def _on_restart(self, workload, state, step, rep):
        if not self.session.allow_restart:
            raise RuntimeError(
                "computational slice died without a live replica or "
                "checkpoint: restart + replay required")
        rep.restarts += 1
        state, ck_step = self._restore(workload, state, rep)
        rep.rolled_back_steps += step - ck_step
        return state, ck_step

    def _restore(self, workload, state, rep):
        """No checkpoints: restart from scratch (deterministic init)."""
        return workload.init_state(), 0


class _ReplicaMixin:
    """Replica-state management: double execution + O(1) promotion. The
    replica's state is a ``copy_tree`` (clone) of the computational one, so
    a step that writes its state in place cannot reach the other copy."""

    wants_replica = True

    def n_replica_workers(self, n: int) -> int:
        return int(round(self.ft.replication_degree * n))

    def on_start(self, workload, state, rep) -> None:
        super().on_start(workload, state, rep)
        self.replica_state = copy_tree(state)

    def step(self, workload, state, t):
        state, metrics = super().step(workload, state, t)
        if self.replica_state is not None:
            # the replica slice executes the same step on the same data
            self.replica_state, _ = workload.step(self.replica_state, t)
        return state, metrics

    def _on_promote(self, workload, state, plan, step, rep):
        state, step = super()._on_promote(workload, state, plan, step, rep)
        if self.replica_state is not None:
            # replica slice state is CURRENT: swap, no rollback
            state = self.replica_state
            self.replica_state = copy_tree(state) \
                if self.session.rmap.replication_degree() > 0 else None
        return state, step

    def _on_restart(self, workload, state, step, rep):
        state, step = super()._on_restart(workload, state, step, rep)
        self.replica_state = copy_tree(state)
        return state, step


class NoFT(FTStrategy):
    mode = "none"


class ReplicationStrategy(_ReplicaMixin, FTStrategy):
    mode = "replication"


_STRATEGIES = {"none": NoFT, "replication": ReplicationStrategy}
_NOT_PORTED = ("checkpoint", "combined")


def make_strategy(ft: FTConfig) -> FTStrategy:
    if ft.mode in _NOT_PORTED:
        raise NotImplementedError(
            f"FT mode {ft.mode!r} needs the checkpoint strategies, which "
            f"are not ported to PyTorch yet (ROADMAP.md, Queue 1 item 5)")
    try:
        return _STRATEGIES[ft.mode](ft)
    except KeyError:
        raise ValueError(f"unknown FT mode {ft.mode!r}; expected one of "
                         f"{sorted(_STRATEGIES)}") from None
