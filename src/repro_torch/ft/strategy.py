"""FT strategies (port of ``repro/ft/strategy.py``).

  NoFT                 native step loop (the "EMPI direct" baseline)
  CheckpointStrategy   coordinated checkpoint/restart at the Young-Daly
                       interval through a CheckpointBackend (``store``):
                       on disk, or shards replicated into partner memory
                       (the ReStore idea)
  ReplicationStrategy  a replica redundantly executes every step; on
                       computational failure the replica is promoted in O(1)
                       (state already current — no restore, no rollback)
  CombinedStrategy     both (checkpoints guard against pair deaths)

A strategy is bound to one FTSession, which owns the coordinators, the
replica map and the recovery planner; the strategy decides what to do with
each RecoveryPlan.
"""
from __future__ import annotations

import time
from typing import Any, Optional, Tuple

from repro_torch.configs.base import FTConfig
from repro_torch.core import ckpt_policy
from repro_torch.store import StoreUnrecoverable, make_backend
from repro_torch.tree import copy_tree


class FTStrategy:
    mode = "none"
    wants_replica = False
    backend = None                       # CheckpointBackend (store)

    def __init__(self, ft: Optional[FTConfig] = None):
        self.ft = ft or FTConfig(mode=self.mode)
        self.session = None
        self.last_ckpt_step = 0

    def recovery_store(self):
        """The in-memory store backing this strategy's checkpoints, if any
        (consulted by plan_recovery for restore-cost planning)."""
        return None

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

    def maybe_checkpoint(self, workload, state, step, vtime, rep) -> None:
        pass

    def handle_plan(self, workload, state, plan, step, rep):
        """Execute a RecoveryPlan; returns (state, step)."""
        # a workload that owns its transport (the pool) repairs it here —
        # drop dead endpoints, drain + replay the promoted replica's
        # network state — before the strategy-level state handling
        hook = getattr(workload, "apply_plan", None)
        if hook is not None:
            state = hook(state, plan, step, rep)
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
    a step that writes its state in place cannot reach the other copy.
    A ``self_replicating`` workload (the pool) runs its replica endpoints
    inside its own step, so it gets no whole-state shadow copy."""

    wants_replica = True

    def n_replica_workers(self, n: int) -> int:
        return int(round(self.ft.replication_degree * n))

    def on_start(self, workload, state, rep) -> None:
        super().on_start(workload, state, rep)
        self.replica_state = None if getattr(
            workload, "self_replicating", False) else copy_tree(state)

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
        # the replica died with its pair: free its state before the
        # restore brings a new one onto the device
        self.replica_state = None
        state, step = super()._on_restart(workload, state, step, rep)
        if not getattr(workload, "self_replicating", False):
            self.replica_state = copy_tree(state)
        return state, step


class _CheckpointMixin:
    """Coordinated checkpoint/restart on the primary coordinator's
    Young-Daly timer, through whichever CheckpointBackend the FTConfig
    selects (``store.make_backend``) — the strategy is backend-agnostic."""

    def on_start(self, workload, state, rep) -> None:
        super().on_start(workload, state, rep)
        self._interval_set = False
        self.backend = make_backend(self.ft, self.session, workload)
        self.backend.save(0, state, workload=workload, baseline=True,
                          extra={"mode": self.ft.mode})

    def recovery_store(self):
        return getattr(self.backend, "store", None)

    def handle_plan(self, workload, state, plan, step, rep):
        if self.backend is not None:
            # the dead workers' shard memory dies with them
            self.backend.on_failure(plan.failed_workers)
        return super().handle_plan(workload, state, plan, step, rep)

    def _effective_c(self) -> float:
        """The effective checkpoint cost C feeding Young-Daly: the
        configured constant, else the backend's last (priced or modeled)
        write cost."""
        measured = self.backend.last_write_s or 0.05
        return self.ft.ckpt_cost_s or max(measured, 1e-6)

    def _auto_interval(self) -> bool:
        return not self.ft.ckpt_interval_s and not self.ft.ckpt_cost_s

    def maybe_checkpoint(self, workload, state, step, vtime, rep) -> None:
        sess = self.session
        if not self._interval_set:
            interval = self.ft.ckpt_interval_s or \
                ckpt_policy.young_daly_interval(self.ft.mtbf_s,
                                                self._effective_c())
            sess.coords.set_interval(interval, vtime)
            self._interval_set = True
        if sess.coords.due_checkpoint(vtime):
            obs = sess.obs
            if obs is not None:
                obs.span("ckpt.write", "ckpt", step=step)
                obs.metrics.inc("ckpt.writes")
            # repro: allow[wallclock] -- genuine wall measurement
            t0 = time.perf_counter()
            self.backend.save(step, state, workload=workload)
            # repro: allow[wallclock] -- genuine wall measurement
            rep.ckpt_s += time.perf_counter() - t0
            rep.ckpt_writes += 1
            self.last_ckpt_step = step
            # the write's cost enters the shared ledger (ledger-only: the
            # session's schedule clock stays step-indexed).  A configured
            # ft.ckpt_cost_s is the modeled C and wins, else the backend's
            # priced/modeled write cost
            sess.clock.charge("ckpt_write",
                              self.ft.ckpt_cost_s
                              or self.backend.last_write_s or 0.0,
                              advance=False,
                              label=type(self.backend).__name__)
            if obs is not None:
                obs.end_span()
            if self._auto_interval() and getattr(self.backend,
                                                 "modeled_cost", False):
                # Young-Daly recomputed from the *effective* priced C: a
                # priced store measures C from its actual push traffic,
                # which can drift as the state grows
                sess.coords.set_interval(
                    ckpt_policy.young_daly_interval(self.ft.mtbf_s,
                                                    self._effective_c()),
                    vtime)
            else:
                sess.coords.restart_timer(vtime)

    def _restore(self, workload, state, rep):
        if self.backend is None or not self.backend.has_checkpoint():
            return super()._restore(workload, state, rep)
        obs = self.session.obs
        if obs is not None:
            obs.span("ckpt.restore", "recovery")
        # repro: allow[wallclock] -- genuine wall measurement
        t0 = time.perf_counter()
        try:
            state, ck_step = self.backend.restore(state, workload=workload)
        except StoreUnrecoverable:
            # more failure domains lost than the placement tolerates:
            # restart from scratch like the no-checkpoint baseline
            if obs is not None:
                obs.end_span(outcome="unrecoverable")
            return super()._restore(workload, state, rep)
        # repro: allow[wallclock] -- genuine wall measurement
        dt = time.perf_counter() - t0
        rep.restore_s += dt
        # priced/modeled R when the backend reports one (a measured 0.0
        # is a legitimate cost: all shards served owner-locally); wall
        # time only when the backend has no notion of restore cost
        cost = getattr(self.backend, "last_restore_s", None)
        self.session.clock.charge("restore", dt if cost is None else cost,
                                  advance=False,
                                  label=type(self.backend).__name__)
        if obs is not None:
            obs.end_span(to_step=ck_step)
        return state, ck_step


class NoFT(FTStrategy):
    mode = "none"


class CheckpointStrategy(_CheckpointMixin, FTStrategy):
    mode = "checkpoint"


class ReplicationStrategy(_ReplicaMixin, FTStrategy):
    mode = "replication"


class CombinedStrategy(_ReplicaMixin, _CheckpointMixin, FTStrategy):
    mode = "combined"


_STRATEGIES = {
    "none": NoFT,
    "checkpoint": CheckpointStrategy,
    "replication": ReplicationStrategy,
    "combined": CombinedStrategy,
}


def make_strategy(ft: FTConfig) -> FTStrategy:
    try:
        return _STRATEGIES[ft.mode](ft)
    except KeyError:
        raise ValueError(f"unknown FT mode {ft.mode!r}; expected one of "
                         f"{sorted(_STRATEGIES)}") from None
