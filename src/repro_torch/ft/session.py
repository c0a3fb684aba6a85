"""FTSession: the workload-agnostic FT driver (port of
``repro/ft/session.py`` for the serving path).

One loop: failure intake (injector -> coordinators -> plan_recovery),
strategy-owned step execution (replica double execution under
replication), O(1) promotion and restart, producing a ``RunReport`` with a
typed event stream and the ``TimeBreakdown`` ledger. The schedule clock
advances exactly ``step_time_s`` per executed step; repair and the replica
share are ledger-only charges.

Left for later slices (ROADMAP.md): the observability hooks, checkpoints,
and the hooks the task pool's self-repairing workloads use.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

from repro_torch.clock import (TimeBreakdown, VirtualClock,
                               injection_horizon, pricing_from_ft)
from repro_torch.configs.base import FTConfig
from repro_torch.core.coordinator import ClusterTopology, CoordinatorSet
from repro_torch.core.replica_map import ReplicaMap
from repro_torch.core.shrink import plan_recovery
from repro_torch.ft.injector import FailureInjector, as_injector
from repro_torch.ft.strategy import FTStrategy, make_strategy


@dataclass
class StepEvent:
    step: int
    kind: str
    detail: dict = field(default_factory=dict)


@dataclass
class RunReport:
    """Workload-agnostic run outcome."""

    steps: int = 0
    metrics: List[Any] = field(default_factory=list)
    events: List[StepEvent] = field(default_factory=list)
    failures: int = 0
    promotions: int = 0
    restarts: int = 0
    rolled_back_steps: int = 0
    wall_s: float = 0.0
    final_state: Any = None
    time: TimeBreakdown = field(default_factory=TimeBreakdown)


class FTSession:
    """Drives a Workload under an FTStrategy with failure injection.

    Both slices live on one device and the replica step is executed
    redundantly — the exact semantics (bit-identical states, O(1)
    promotion) at 2x local cost, so FT-theorem tests can compare failure
    runs against failure-free runs for equality. The schedule clock
    advances ``step_time_s`` (1 s, the JAX session's default) a step."""

    step_time_s = 1.0

    def __init__(self, *, ft: Optional[FTConfig] = None,
                 strategy: Optional[FTStrategy] = None,
                 injector=None,
                 n_logical_workers: int = 8,
                 workers_per_node: int = 4,
                 allow_restart: bool = True):
        if strategy is None:
            strategy = make_strategy(ft or FTConfig())
        self.strategy = strategy.bind(self)
        self.ft = strategy.ft
        self.injector: FailureInjector = as_injector(injector)
        self.n_logical_workers = n_logical_workers
        self.workers_per_node = workers_per_node
        self.allow_restart = allow_restart
        self._init_fabric()

    def _init_fabric(self):
        n = self.n_logical_workers
        self.rmap = ReplicaMap(n, self.strategy.n_replica_workers(n))
        self.topology = ClusterTopology(self.rmap.world_size,
                                        self.workers_per_node)
        self.coords = CoordinatorSet(self.topology, float("inf"))
        # cost-model injection (clock.pricing): with FTConfig.topology set
        # the session's clock carries the topology's cost model
        self.pricing = pricing_from_ft(self.ft, self.topology)
        self.clock = VirtualClock(cost_model=self.pricing.cost_model)

    # -- main loop -----------------------------------------------------------

    def run(self, workload, n_steps: int) -> RunReport:
        rep = RunReport()
        wall0 = time.perf_counter()
        self._init_fabric()                       # re-entrant sessions
        clock = self.clock = VirtualClock(breakdown=rep.time,
                                          cost_model=self.pricing.cost_model)
        state = workload.init_state()
        strat = self.strategy
        strat.on_start(workload, state, rep)
        self.injector.prepare(
            injection_horizon(n_steps, self.step_time_s,
                              self.ft.ckpt_cost_s),
            self.rmap.alive())

        step = 0
        done_through = 0                  # first step index not yet earned
        while step < n_steps:
            # --- failure intake (injector -> coordinators -> plan) ---------
            for ev in self.injector.poll(step, clock.now):
                fresh = self.coords.intercept_failure(list(ev.workers))
                fresh = [w for w in fresh if w not in self.rmap.dead]
                if not fresh:
                    continue
                rep.failures += len(fresh)
                self.rmap, plan = plan_recovery(
                    self.rmap, fresh,
                    last_ckpt_step=strat.last_ckpt_step, current_step=step)
                rep.events.append(StepEvent(step, plan.kind,
                                            {"failed": list(fresh),
                                             "promotions": plan.promotions,
                                             "restore_backend":
                                                 plan.restore_backend}))
                state, step = strat.handle_plan(workload, state, plan,
                                                step, rep)
                # shrink + message recovery (paper Fig 9 'repair'),
                # ledger-only: the step-indexed schedule clock ignores it
                clock.charge("repair", plan.repair_cost_s, advance=False,
                             label=plan.kind)

            # --- one workload step (strategy may double-execute) -----------
            component = "rollback" if step < done_through else "useful"
            state, metrics = strat.step(workload, state, step)
            rep.metrics.append(metrics)
            if step >= done_through:
                done_through = step + 1
            step += 1
            clock.charge(component, self.step_time_s)
            # replica processor-seconds: the live replicated share
            n_redundant = len(self.rmap.replicated_ranks())
            if n_redundant:
                clock.charge("redundant",
                             self.step_time_s * n_redundant / self.rmap.n,
                             advance=False)
            rep.steps = step

        rep.final_state = state
        rep.wall_s = time.perf_counter() - wall0
        return rep
