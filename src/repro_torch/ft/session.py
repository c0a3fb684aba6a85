"""FTSession: the workload-agnostic FT driver (port of
``repro/ft/session.py``).

One loop: failure intake (injector -> coordinators -> plan_recovery, which
consults the strategy's in-memory store), strategy-owned step execution
(replica double execution under replication), Young-Daly checkpointing,
O(1) promotion and elastic restart, producing a ``RunReport`` with a typed
event stream and the ``TimeBreakdown`` ledger. The schedule clock advances
exactly ``step_time_s`` per executed step; checkpoint writes, restores,
repair and the replica share are ledger-only charges.

``obs=True`` (or an ``obs.ObsRecorder``) records the run: failure marks,
recovery and checkpoint spans, per-step spans, every clock charge, and the
store's counters at the end (``RunReport.obs_metrics``).  With ``obs=None``
every hook is one falsy check.

Workloads that own their transport (the task pool, ``pool/``) use the
session's elastic hooks: ``bind_session`` (called before ``init_state``),
``absorb_failures`` (take an unreplicated death forward instead of a
world restart), ``apply_plan`` (the strategy's transport repair) and
``repair_transport`` (the measured repair cost of a promotion);
``replicable_ranks`` keeps a placement-pinned rank unreplicated.
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
from repro_torch.obs import ObsRecorder


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
    ckpt_writes: int = 0
    rolled_back_steps: int = 0
    wall_s: float = 0.0
    ckpt_s: float = 0.0
    restore_s: float = 0.0
    final_state: Any = None
    # useful/rollback from the step loop, ckpt_write/restore at the
    # backend's priced cost, repair from the recovery plans, comm from
    # priced fan-out traffic
    time: TimeBreakdown = field(default_factory=TimeBreakdown)
    # observability (sessions built with obs=...): the run's recorder and
    # its end-of-run snapshot — not the per-step workload ``metrics``
    obs: Any = None
    obs_metrics: Optional[dict] = None

    @property
    def efficiency(self) -> float:
        """Useful fraction of the ledger."""
        t = self.time.total
        return self.time.useful / t if t > 0 else 1.0

    @property
    def losses(self) -> List[float]:
        """Scalar metrics as floats (train workloads emit the loss)."""
        return [float(m) for m in self.metrics if m is not None]


# the reference's old name for the train-specific report
TrainReport = RunReport


class FTSession:
    """Drives a Workload under an FTStrategy with failure injection.

    Both slices live on one device and, with ``simulate_replica`` (the
    default), the replica step is executed redundantly — the exact
    semantics (bit-identical states, O(1) promotion) at 2x local cost, so
    FT-theorem tests can compare failure runs against failure-free runs
    for equality. With it off no replica is kept or executed (the replica
    slice stands on another pod): a promotion continues the computational
    slice's state. The schedule clock advances ``step_time_s`` (1 s by
    default) a step."""

    def __init__(self, *, ft: Optional[FTConfig] = None,
                 strategy: Optional[FTStrategy] = None,
                 injector=None,
                 ckpt_dir: Optional[str] = None,
                 n_logical_workers: int = 8,
                 workers_per_node: int = 4,
                 simulate_replica: bool = True,
                 allow_restart: bool = True,
                 step_time_s: float = 1.0,
                 replicable_ranks: Optional[int] = None,
                 obs=None):
        if strategy is None:
            strategy = make_strategy(ft or FTConfig())
        self.strategy = strategy.bind(self)
        self.ft = strategy.ft
        self.injector: FailureInjector = as_injector(injector)
        self.n_logical_workers = n_logical_workers
        self.workers_per_node = workers_per_node
        self.simulate_replica = simulate_replica and strategy.wants_replica
        self.allow_restart = allow_restart
        self.step_time_s = step_time_s
        # cap on how many logical ranks the replication degree applies to:
        # a workload with a placement-pinned unreplicated rank (the pool
        # master) passes n-1 so replicas cover exactly the worker ranks
        # (replicas attach to ranks 0..m-1)
        self.replicable_ranks = replicable_ranks
        # a directory selects the disk backend for a disk-checkpointable
        # workload (store.make_backend)
        self.ckpt_dir = ckpt_dir
        # observability: obs=True builds a recorder, or pass one in;
        # obs=None (default) keeps every hook a falsy check
        self.obs = None
        if obs is not None:
            self.obs = ObsRecorder() if obs is True else obs
        self._init_fabric()

    def _init_fabric(self):
        n = self.n_logical_workers
        base = n if self.replicable_ranks is None \
            else max(0, min(self.replicable_ranks, n))
        self.rmap = ReplicaMap(n, self.strategy.n_replica_workers(base))
        self.topology = ClusterTopology(self.rmap.world_size,
                                        self.workers_per_node)
        self.coords = CoordinatorSet(self.topology, float("inf"))
        # cost-model injection (clock.pricing): with FTConfig.topology set
        # the checkpoint backend's transport prices every push/fetch
        # message, so C and R are measured, not assumed
        self.pricing = pricing_from_ft(self.ft, self.topology)
        self.clock = VirtualClock(cost_model=self.pricing.cost_model)

    # -- main loop -----------------------------------------------------------

    def run(self, workload, n_steps: int) -> RunReport:
        rep = RunReport()
        # repro: allow[wallclock] -- genuine wall measurement
        wall0 = time.perf_counter()
        self._init_fabric()                       # re-entrant sessions
        clock = self.clock = VirtualClock(breakdown=rep.time,
                                          cost_model=self.pricing.cost_model)
        obs = self.obs
        if obs is not None:
            obs.bind_clock(clock)
            obs.set_world(self.rmap.n, self.rmap.m,
                          injector_kind=type(self.injector).__name__)
        # session-aware workloads (the pool) build their transport over
        # this run's fabric before init_state builds the world state
        bind = getattr(workload, "bind_session", None)
        if bind is not None:
            bind(self)
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
                if obs is not None:
                    obs.metrics.inc("failures.kills.worker", len(fresh))
                    obs.mark("failure", "failure", workers=tuple(fresh),
                             step=step)
                # an elastic workload (the pool) can take an unreplicated
                # death forward — retire the rank, reassign its work —
                # instead of the world restart plan_recovery would force
                absorb = getattr(workload, "absorb_failures", None)
                if absorb is not None:
                    state, fresh = absorb(state, list(fresh), step, rep)
                    if not fresh:
                        continue
                self.rmap, plan = plan_recovery(
                    self.rmap, fresh,
                    last_ckpt_step=strat.last_ckpt_step, current_step=step,
                    store=strat.recovery_store())
                if obs is not None:
                    obs.span(f"recovery.{plan.kind}", "recovery", step=step)
                rep.events.append(StepEvent(step, plan.kind,
                                            {"failed": list(fresh),
                                             "promotions": plan.promotions,
                                             "restore_backend":
                                                 plan.restore_backend}))
                state, step = strat.handle_plan(workload, state, plan,
                                                step, rep)
                # shrink + message recovery (paper Fig 9 'repair'),
                # ledger-only: the step-indexed schedule clock ignores it.
                # A workload that repairs its own priced transport in
                # apply_plan (the pool) reports the measured drain/replay
                # traffic; everyone else gets the planner's flat estimate
                repair_s = plan.repair_cost_s
                rtrans = getattr(workload, "repair_transport", None)
                if plan.kind == "promote" and rtrans is not None \
                        and rtrans.cost_model is not None:
                    repair_s = rtrans.take_comm_time()
                clock.charge("repair", repair_s, advance=False,
                             label=plan.kind)
                if obs is not None:
                    obs.end_span(resumed_step=step)

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
            if obs is not None:
                obs.on_step(step - 1, clock.now - self.step_time_s,
                            self.step_time_s, component == "rollback",
                            self.rmap.n)

            # --- coordinated checkpoint (primary timer) --------------------
            strat.maybe_checkpoint(workload, state, step, clock.now, rep)

        rep.final_state = state
        # repro: allow[wallclock] -- genuine wall measurement
        rep.wall_s = time.perf_counter() - wall0
        if obs is not None:
            store = strat.recovery_store()
            if store is not None:
                obs.sample_store(store)
                obs.sample_transport(store.transport)
            if obs.tracer is not None:
                obs.tracer.finish()
            rep.obs = obs
            rep.obs_metrics = obs.snapshot()
        return rep
