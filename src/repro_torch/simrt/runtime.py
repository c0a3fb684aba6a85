"""Multi-worker simulation runtime: the paper's end-to-end failure pipeline
executed with real numerics on one machine (the port of
``repro/simrt/runtime.py``).

Logical MPI workers are Python generators that yield communication ops; the
runtime is the SCHEDULER: it pumps generators, accounts virtual time (the
paper's Fig 9 components), orchestrates checkpoints and elastic restarts,
and fires failure events.  Everything message-shaped lives in the layered
``comm`` subsystem:

  comm.transport   - replica-aware routing (parallel cmp->cmp and
                     rep->rep paths, intercomm fill-in, replica-side
                     skip, MPI_ANY_SOURCE forwarding, sender-based
                     logging, send-ID dedup),
  comm.collectives - the CollectiveEngine (allreduce/barrier plus
                     bcast/gather/reduce_scatter/alltoall),
  comm.recovery    - failure-time drain + sender-log replay.

With ``FTConfig.topology`` set, ``topo`` prices every transport message
(α·hops + size/β) into the ``TimeBreakdown.comm`` component, the
collective registry switches to tree/ring/recursive-doubling algorithm
selection, and checkpoint/restore costs of the in-memory store are
measured from the priced traffic instead of fed in as constants.

The runtime runs on whatever device its app's state lives on (the apps of
``apps/`` take a ``device``; numpy apps run as in the reference) and never
moves that state elsewhere to carry on.  Snapshots in memory hold device
clones (``comm.payload.structural_copy``).  A checkpoint that leaves the
process — a pickle on disk, the in-memory store's bands — holds host
copies made by ``store.backend.to_host`` (never a pickled tensor), with
the manifest of its tensors, and is restored onto the app's ``device``:
a checkpoint written on the card restores on the CPU and the reverse.

Apps (``apps.*``) write worker-local code:

    def step(self, rank, state, step_idx):
        ...
        got = yield ("exchange", {nbr: payload}, TAG)
        total = yield ("allreduce", local, "sum")
        parts = yield ("alltoall", per_dest_chunks)
        return new_state
"""
from __future__ import annotations

import heapq
import os
import pickle
import time as _time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from repro_torch.clock import (TimeBreakdown, VirtualClock,
                               injection_horizon, pricing_from_ft)
from repro_torch.comm import (NOTHING, P2P_OPS, CollectiveEngine,
                              RecoveryManager, ReplicaTransport)
from repro_torch.comm.payload import structural_copy
from repro_torch.comm.transport import Endpoint
from repro_torch.configs.base import FTConfig
from repro_torch.core import ckpt_policy
from repro_torch.core.coordinator import ClusterTopology, CoordinatorSet
from repro_torch.core.failure_sim import FailureEvent
from repro_torch.core.replica_map import ApplicationDead, ReplicaMap
from repro_torch.store.backend import from_host, to_host

# TimeBreakdown lives in clock (the shared ledger FTSession and the
# strategies charge too); re-exported here as in the reference.
__all__ = ["SimRuntime", "CostModel", "RunResult", "TimeBreakdown"]


@dataclass
class RunResult:
    states: Dict[int, Any]
    time: TimeBreakdown
    steps_done: int
    failures: int = 0
    promotions: int = 0
    restarts: int = 0
    replays: int = 0
    duplicates_skipped: int = 0
    store_restores: int = 0         # elastic restores served by the store
    store_fallbacks: int = 0        # store unrecoverable -> harness snapshot
    wall_s: float = 0.0
    check_value: Optional[float] = None
    obs: Optional[Any] = None       # the run's ObsRecorder (obs= wired)
    obs_metrics: Optional[dict] = None   # its end-of-run snapshot()

    @property
    def efficiency(self) -> float:
        t = self.time.total
        return self.time.useful / t if t > 0 else 1.0


@dataclass
class CostModel:
    """Virtual-time costs. Defaults are per-step scale-free units; the
    benchmarks set them from the paper's Table 1 measurements.

    ``mem_ckpt_cost_s`` / ``mem_restore_cost_s`` are the network-bound C
    and R of the in-memory store (FTConfig.ckpt_backend == "memory");
    benchmarks derive them from ckpt_policy.memstore_ckpt_cost.  None
    falls back to the disk values."""

    step_time_s: float = 1.0
    ckpt_cost_s: float = 0.05
    restore_cost_s: float = 0.05
    repair_cost_s: float = 0.005        # shrink + replay (paper: negligible)
    log_removal_cost_s: float = 0.001
    mem_ckpt_cost_s: Optional[float] = None
    mem_restore_cost_s: Optional[float] = None


class _Worker:
    """Scheduling state for one logical worker; comm state lives in the
    transport's Endpoint."""

    __slots__ = ("wid", "state", "gen", "pending", "done", "ep")

    def __init__(self, wid: int, state, ep: Endpoint):
        self.wid = wid
        self.state = state
        self.ep = ep
        self.gen = None
        self.pending = None          # op tuple currently blocking this worker
        self.done = False


class SimRuntime:
    def __init__(self, app, ft: FTConfig, *, workers_per_node: int = 4,
                 costs: CostModel = None, ckpt_dir: str = None,
                 failure_events: List[FailureEvent] = None,
                 injector=None,
                 respawn_on_restart: bool = True,
                 drop_inflight_on_failure: bool = True,
                 detect_divergence: bool = False,
                 obs=None):
        self.app = app
        self.ft = ft
        self.n = app.n_ranks
        self.m = int(round(ft.replication_degree * self.n)) \
            if ft.mode in ("replication", "combined") else 0
        self.rmap = ReplicaMap(self.n, self.m)
        self.topology = ClusterTopology(self.rmap.world_size, workers_per_node)
        self.costs = costs or CostModel()
        self.ckpt_dir = ckpt_dir
        self.respawn = respawn_on_restart
        self.drop_inflight = drop_inflight_on_failure
        # where restored tensors go: the app's device (numpy apps: none)
        self.device = getattr(app, "device", None)

        backend = getattr(ft, "ckpt_backend", "disk")
        if backend not in ("disk", "memory"):
            raise ValueError(f"unknown ckpt_backend {backend!r}; "
                             f"expected 'disk' or 'memory'")
        self.use_memstore = ft.mode in ("checkpoint", "combined") and \
            backend == "memory"
        interval = ft.ckpt_interval_s or ckpt_policy.young_daly_interval(
            max(ft.mtbf_s, 1e-9), self._ckpt_c()) \
            if ft.mode in ("checkpoint", "combined") else float("inf")
        self.coords = CoordinatorSet(self.topology, interval)

        # unified failure injection (ft.injector): failure_events lists
        # are wrapped; any FailureInjector works.
        from repro_torch.ft.injector import as_injector
        if injector is not None and failure_events:
            raise ValueError("pass failure_events OR injector, not both")
        self.injector = as_injector(
            injector if injector is not None else failure_events)
        self._injector_prepared = False

        # cluster topology + α‑β message pricing (clock.pricing):
        # when FTConfig.topology names a graph, every transport message is
        # priced, the collective registry switches to the MPICH-style
        # tree/ring selection, and ckpt/restore costs are MEASURED from
        # the store's priced traffic instead of fed in as constants
        self.pricing = pricing_from_ft(ft, self.topology)
        self.topo_graph = self.pricing.graph
        self.topo_costs = self.pricing.cost_model
        engine_ops = self.pricing.engine_ops
        # the unified virtual-time engine: schedule clock + priced ledger
        self.clock = VirtualClock(cost_model=self.topo_costs)

        # the layered comm subsystem (comm)
        self.transport = ReplicaTransport(self.rmap, self.n,
                                          ft.message_log_limit_bytes,
                                          cost_model=self.topo_costs,
                                          mutable_recv=getattr(
                                              ft, "mutable_recv", False))
        self.engine = CollectiveEngine(self.transport, ops=engine_ops)
        # replica-divergence tripwire (analyze): CRC-compare every
        # cmp/rep send pair and raise at the first mismatch — silent
        # replica drift becomes a located failure instead of a downstream
        # bitwise miscompare
        self.divergence = None
        if detect_divergence:
            from repro_torch.analyze.divergence import DivergenceDetector
            self.divergence = DivergenceDetector(
                raise_on_divergence=True).attach(self.transport)
        # diskless checkpointing (store): rank snapshots replicated into
        # partner memory over the same transport, as host bytes; the
        # tensors of each generation are recorded in store_manifests
        self.store = None
        self.store_manifests: Dict[int, dict] = {}
        if self.use_memstore:
            from repro_torch.store import MemStore
            self.store = MemStore(self.transport, self.topology,
                                  k_partners=ft.store_partners,
                                  n_bands=ft.store_bands,
                                  graph=self.topo_graph)
        self.recovery = RecoveryManager(self.transport, store=self.store)

        # observability (obs): one recorder wired through every
        # seam — the clock's charge hook, the transport's observer list
        # (after any divergence detector: the raising tripwire keeps its
        # first slot), the collective engine, and per-link utilization on
        # priced runs.  obs=None (default) leaves every wired hot path a
        # single falsy check with zero allocations.
        self.obs = None
        if obs is not None:
            from repro_torch.obs import ObsRecorder
            self.obs = ObsRecorder() if obs is True else obs
            self.obs.bind_clock(self.clock)
            self.obs.set_world(self.n, self.m,
                               injector_kind=type(self.injector).__name__)
            self.transport.add_observer(self.obs)
            if self.topo_costs is not None:
                self.transport.link_usage = \
                    self.obs.attach_links(self.topo_costs)
            self.engine.obs = self.obs

        self.workers: Dict[int, _Worker] = {}
        for w in self.rmap.alive():
            role, rank = self.rmap.role_of(w)
            self.workers[w] = _Worker(w, app.init_state(rank),
                                      self.transport.register(w))

        self.step_idx = 0
        self.max_step_done = 0
        self.result = RunResult(states={}, time=self.clock.breakdown,
                                steps_done=0)
        self.last_ckpt_step = 0
        self._ckpt_mem: Optional[dict] = None
        if ckpt_dir:
            os.makedirs(ckpt_dir, exist_ok=True)
        self._write_checkpoint(baseline=True)

    @property
    def t(self) -> float:
        """Virtual time — the clock's schedule clock (kept as a read-only
        attribute for callers/tests that inspect ``rt.t``)."""
        return self.clock.now

    # ------------------------------------------------------------------ ckpt

    def _ckpt_c(self) -> float:
        """Effective checkpoint cost C: the memory backend's network-bound
        cost when configured, else the disk cost."""
        if self.use_memstore and self.costs.mem_ckpt_cost_s is not None:
            return self.costs.mem_ckpt_cost_s
        return self.costs.ckpt_cost_s

    def _restore_c(self) -> float:
        if self.use_memstore and self.costs.mem_restore_cost_s is not None:
            return self.costs.mem_restore_cost_s
        return self.costs.restore_cost_s

    def _ckpt_path(self, rank: int, baseline: bool = False) -> str:
        kind = "baseline" if baseline else "latest"
        return os.path.join(self.ckpt_dir, f"{kind}_rank{rank}.pkl")

    def _snapshot(self) -> dict:
        """Rank-level snapshot: app state + the transport's comm state —
        written only by computational workers (paper §3.3 incremental)."""
        snap = {"step": self.step_idx, "ranks": {}}
        for r in range(self.n):
            w = self.workers[self.rmap.cmp[r]]
            snap["ranks"][r] = {
                # frozen (sent) arrays are shared, writeable ones copied,
                # tensors cloned on their device — no deepcopy walk per
                # checkpoint (comm.payload)
                "state": structural_copy(w.state),
                **self.transport.snapshot_rank(r, w.ep),
            }
        return snap

    def _write_checkpoint(self, baseline: bool = False):
        obs = self.obs
        if obs is not None:
            obs.span("ckpt.write", "ckpt", step=self.step_idx,
                     baseline=baseline)
            obs.metrics.inc("ckpt.writes")
        snap = self._snapshot()
        self._ckpt_mem = snap
        self.last_ckpt_step = self.step_idx
        topo_c = None
        if self.store is not None:
            # diskless: rank snapshots pushed to partner memory over the
            # transport (two-generation commit; previous gen retained on
            # any mid-commit failure).  With a topology configured, C is
            # not a constant: it is the α‑β-priced time of the push
            # traffic the save just generated.
            if self.topo_costs is not None:
                self.clock.drain_comm(self.transport)
            if obs is not None:
                obs.span("store.push", "store", gen=self.store.next_gen)
            host = {r: to_host(data) for r, data in snap["ranks"].items()}
            gen = self.store.save(snap["step"],
                                  {r: h for r, (h, _) in host.items()})
            self.store_manifests[gen] = {r: m for r, (_, m) in host.items()}
            for g in [g for g in self.store_manifests
                      if g not in self.store.gens]:
                del self.store_manifests[g]
            if obs is not None:
                obs.end_span(committed=self.store.committed)
            if self.topo_costs is not None:
                topo_c = self.clock.drain_comm(self.transport)
        elif self.ckpt_dir:
            for r, data in snap["ranks"].items():
                # protocol 5 writes each host array's buffer as it is
                host, manifest = to_host(data)
                with open(self._ckpt_path(r, baseline), "wb") as f:
                    pickle.dump({"step": snap["step"], **host,
                                 "tensors": manifest}, f,
                                protocol=pickle.HIGHEST_PROTOCOL)
            if not baseline:
                with open(os.path.join(self.ckpt_dir, "LATEST"), "w") as f:
                    f.write(str(snap["step"]))
        if not baseline:
            c = topo_c if topo_c is not None else self._ckpt_c()
            self.clock.charge("ckpt_write", c)
            # checkpoint boundary: trim message logs (log removal component)
            # and the wildcard-order histories (consumed prefixes; cursor
            # offsets preserved so replay correlation still lines up)
            for log in self.transport.send_logs.values():
                log.trim_before_step(self.step_idx)
            for r in range(self.n):
                self.transport.trim_wildcards(r)
            self.clock.charge("log_removal", self.costs.log_removal_cost_s)
        if obs is not None:
            obs.end_span()          # ckpt.write (dur = C + log removal)
        self.coords.restart_timer(self.clock.now)

    def _restore_checkpoint(self):
        """Elastic restart (paper §3.3): rebuild the world from the last
        checkpoint. With respawn, failed slots are refilled (same N+M);
        otherwise the replication degree shrinks to the surviving workers."""
        obs = self.obs
        if obs is not None:
            obs.span("recovery.restart", "recovery", at_step=self.step_idx)
            obs.metrics.inc("recovery.restarts")
        snap = self._ckpt_mem
        if self.store is None and self.ckpt_dir and os.path.exists(
                os.path.join(self.ckpt_dir, "LATEST")):
            ranks = {}
            for r in range(self.n):
                with open(self._ckpt_path(r), "rb") as f:
                    host = pickle.load(f)
                ranks[r] = from_host(host, host.pop("tensors"),
                                     device=self.device)
            snap = {"step": ranks[0]["step"], "ranks": ranks}

        n_workers = self.rmap.world_size if self.respawn else \
            len(self.rmap.alive())
        self.rmap = self.rmap.restart_map(n_workers)
        self.topology = ClusterTopology(self.rmap.world_size,
                                        self.topology.workers_per_node)
        self.transport.rebind(self.rmap)
        if self.topo_costs is not None:
            self.topo_costs.attach(self.topology)
        if self.divergence is not None:
            # execution rewinds to the checkpoint: pre-rollback sends must
            # not pair against post-rollback re-sends
            self.divergence.reset()
        self.engine.world_changed()
        self.workers = {}
        for w in self.rmap.alive():
            self.workers[w] = _Worker(w, None, self.transport.register(w))

        restore_c = self._restore_c()
        if self.store is not None:
            # pull the durable generation's shards back from surviving
            # partner memory through the rebuilt world's endpoints
            from repro_torch.store import StoreUnrecoverable
            self.store.rebind(topology=self.topology)
            if self.topo_costs is not None:
                self.clock.drain_comm(self.transport)
            if obs is not None:
                obs.span("store.fetch", "store")
            try:
                gen = self.store.committed
                ranks, step = self.store.restore()
                manifests = self.store_manifests[gen]
                ranks = {r: from_host(data, manifests[r], device=self.device)
                         for r, data in ranks.items()}
                if obs is not None:
                    obs.end_span(outcome="restored", step=step)
                snap = {"step": step, "ranks": ranks}
                self.result.store_restores += 1
                if self.topo_costs is not None:
                    # topo-priced restore: the fetch/reply traffic the
                    # pull just generated, plus the configured relaunch
                    # surcharge (restore_cost_s doubles as that floor)
                    restore_c = self.clock.drain_comm(self.transport) \
                        + self.costs.restore_cost_s
            except StoreUnrecoverable:
                # beyond the placement's tolerance: fall back to the
                # harness's coordinated snapshot (counted, not hidden)
                if obs is not None:
                    obs.end_span(outcome="unrecoverable")
                self.result.store_fallbacks += 1
                restore_c = self.costs.restore_cost_s

        for w, nw in self.workers.items():
            _role, rank = self.rmap.role_of(w)
            data = snap["ranks"][rank]
            # independent writeable copies: the snapshot may be restored
            # again, and apps mutate their state in place
            nw.state = structural_copy(data["state"], mutable=True)
            self.transport.load_rank(rank, nw.ep, data)

        self.step_idx = snap["step"]
        self.result.restarts += 1
        self.clock.charge("restore", restore_c, label="elastic_restart")
        if obs is not None:
            obs.end_span(to_step=self.step_idx)     # recovery.restart

    # --------------------------------------------------------------- failure

    def _due_events(self, until: float) -> List[FailureEvent]:
        return self.injector.poll(self.step_idx, until)

    def _apply_failure(self, ev: FailureEvent):
        victims = [w for w in ev.workers if w in self.workers]
        if not victims:
            return
        self.result.failures += len(victims)
        obs = self.obs
        if obs is not None:
            kind = "node" if ev.node is not None or len(victims) > 1 \
                else "worker"
            obs.metrics.inc(f"failures.kills.{kind}", len(victims))
            obs.mark("failure", "failure", workers=tuple(victims),
                     node=ev.node, step=self.step_idx)
        # interception layer -> coordinators -> propagation (paper §6.1)
        self.coords.intercept_failure(victims)
        try:
            events = self.rmap.fail_many(victims)
        except ApplicationDead:
            # both copies dead: elastic restart from the last checkpoint
            for w in victims:
                self.workers.pop(w, None)
                self.transport.drop(w)
            self.recovery.note_dead(victims)
            raise
        for w in victims:
            self.workers.pop(w, None)
            self.transport.drop(w)
        self.recovery.note_dead(victims)
        self.engine.world_changed()
        promoted = [e for e in events if e["kind"] == "promote"]
        self.result.promotions += len(promoted)
        if obs is not None:
            # the promote arcs open BEFORE the repair charge so each
            # span's virtual duration covers the booked repair time
            for e in promoted:
                obs.span("recovery.promote", "recovery", tid=e["rank"],
                         worker=e["worker"], promoted=e["promoted"])
        # drain + replay on promoted workers (comm.recovery)
        self.clock.charge("repair", self.costs.repair_cost_s,
                          label="promotion")
        for e in promoted:
            ep = self.workers[e["promoted"]].ep
            if obs is None:
                self.recovery.repair_promoted(
                    ep, self.step_idx, drop_inflight=self.drop_inflight)
                continue
            # traced repair: same drain-then-replay the manager performs,
            # with each move marked as a child of the promote arc
            rank = e["rank"]
            dropped = 0
            if self.drop_inflight:
                before = len(ep.live_messages())
                self.recovery.drain_current_step(ep, self.step_idx)
                dropped = before - len(ep.live_messages())
            obs.mark("drain", "recovery", tid=rank, dropped=dropped)
            replayed = self.recovery.replay_to(ep)
            obs.mark("replay", "recovery", tid=rank, messages=replayed)
            obs.mark("promotion", "recovery", tid=rank,
                     worker=e["promoted"])
            obs.metrics.inc("recovery.promotions")
            obs.end_span(tid=rank, replayed=replayed)

    # ------------------------------------------------------------------ step

    def _run_step(self):
        """Advance every alive worker through one application step.

        Ready-queue scheduling: instead of rescanning every worker each
        pass (O(passes x workers)), the step runs in *rounds* that attempt
        only runnable workers, so cost scales with messages moved.  A
        blocked worker parks and is woken by exactly the events that can
        unblock it: a delivery to its endpoint (``transport.waker``), a
        wildcard-order append for its rank, a contribution posted to the
        collective it waits on, or a failure repair (wake-all — promotion
        fallbacks and role-view invalidation can unblock anyone).

        Rounds replay the old pass semantics bitwise: each round attempts
        a set of workers in ascending wid order, each attempted worker
        advances its generator at most once, and a wake for a
        not-yet-attempted wid later in the current round joins this round
        (the old scan would still have reached it), while any other wake
        schedules the next round.  Since every worker the old scheduler
        would have *advanced* is attempted here in the same round, the
        global order of sends/receives — and therefore every wildcard
        choice and virtual-time figure — is unchanged (the JAX package's
        docs/perf.md walks the equivalence argument).
        """
        app = self.app
        self.engine.begin_step()
        for w, worker in self.workers.items():
            role, rank = self.rmap.role_of(w)
            worker.gen = app.step(rank, worker.state, self.step_idx)
            worker.pending = None
            worker.done = False

        # failure events that land inside this step fire between rounds
        step_end = self.t + self.costs.step_time_s
        pending_events = deque(self._due_events(step_end))
        round_i = 0

        # round state: ``curr`` is a min-heap of wids scheduled for the
        # current round (a sorted list is a valid heap), ``nxt`` collects
        # wids for the next round, ``attempted`` guards one-advance-per-
        # round, ``current_wid`` is the scan cursor the wake rule compares
        # against.  Parked collective waiters live in ``coll_waiters``
        # keyed by the engine's match key.
        curr = sorted(self.workers.keys())
        in_curr = set(curr)
        nxt: set = set()
        attempted: set = set()
        coll_waiters: Dict[tuple, set] = {}
        current_wid = -1

        def wake(wid):
            if wid in in_curr:
                return
            if wid > current_wid and wid not in attempted:
                heapq.heappush(curr, wid)
                in_curr.add(wid)
            else:
                nxt.add(wid)

        def wake_collective(key):
            ws = coll_waiters.pop(key, None)
            if ws:
                for wid in ws:
                    wake(wid)

        self.transport.waker = wake
        try:
            while True:
                progressed = False
                activity0 = self.transport.activity
                while curr:
                    w = heapq.heappop(curr)
                    in_curr.discard(w)
                    current_wid = w
                    attempted.add(w)
                    worker = self.workers.get(w)
                    if worker is None or worker.done:
                        continue
                    if worker.pending is None:
                        send_val = None      # first resume
                    else:
                        a0 = self.transport.activity
                        send_val = self._resolve(worker)
                        if send_val is NOTHING:
                            pend = worker.pending
                            if self.transport.activity != a0:
                                # the resolve consumed/forwarded messages
                                # mid-schedule (exchange partials, tree/
                                # ring rounds): still blocked but live —
                                # retry next round like the old rescan did
                                nxt.add(w)
                            elif pend[0] == "collective":
                                coll_waiters.setdefault(pend[1],
                                                        set()).add(w)
                            # p2p waits park with no entry: the next
                            # delivery (or wildcard-order append) wakes
                            continue
                        worker.pending = None
                    try:
                        op = worker.gen.send(send_val)
                        progressed = True
                    except StopIteration as stop:
                        worker.state = stop.value if stop.value is not None \
                            else worker.state
                        worker.done = True
                        progressed = True
                        continue
                    worker.pending = self._intake(worker, op)
                    if worker.pending is not None and \
                            worker.pending[0] == "collective":
                        # batched resolution: the engine queues the keys
                        # this post completed; wake exactly those keys'
                        # parked waiters (a post into a still-incomplete
                        # instance wakes nobody — workers only park
                        # pre-completion, so no wakeup can be lost)
                        for ckey in self.engine.take_completions():
                            wake_collective(ckey)
                    nxt.add(w)
                round_i += 1
                # wakes fired while events/repairs run (replay deliveries)
                # belong to the next round, not the drained current heap
                current_wid = float("inf")
                if pending_events:
                    world0 = len(self.workers)
                    while pending_events:
                        self._apply_failure(pending_events.popleft())
                    if len(self.workers) != world0:
                        # failures invalidate role views and can unblock
                        # any collective via promotion fallback: wake all
                        nxt.update(self.workers.keys())
                live = list(self.workers.values())
                if all(x.done for x in live):
                    break
                if not progressed and self.transport.activity == activity0:
                    blocked = {x.wid: x.pending for x in live if not x.done}
                    raise RuntimeError(f"deadlock at step {self.step_idx}: "
                                       f"{blocked}")
                curr = sorted(w for w in nxt if w in self.workers
                              and not self.workers[w].done)
                in_curr = set(curr)
                nxt = set()
                attempted = set()
                current_wid = -1
        finally:
            self.transport.waker = None

        # step boundary is pinned to step_end even when mid-step repair
        # charges moved the clock (pre-clock behavior, kept bitwise)
        self.clock.advance_to(step_end)
        comm_items = ()
        if self.topo_costs is not None:
            if self.obs is not None:
                # per-sender accrual, captured before charge_comm drains
                # it (the obs comm spans show who waited, not just max)
                comm_items = tuple(self.transport.comm_time.items())
            # α‑β-priced message time of this step (max over workers:
            # senders serialize on their own port, workers run in
            # parallel) — a virtual-time component the flat model folds
            # into step_time_s
            self.clock.charge_comm(self.transport)
        rolled_back = self.step_idx < self.max_step_done
        if rolled_back:
            # re-executing work lost to a rollback (paper Fig 9 'rollback');
            # ledger-only: the schedule clock already sits at step_end
            self.clock.charge("rollback", self.costs.step_time_s,
                              advance=False)
        else:
            self.clock.charge("useful", self.costs.step_time_s,
                              advance=False)
            self.max_step_done = self.step_idx + 1
        if self.m:
            # replica share is redundant work (paper Fig 9 accounting is on
            # processor-seconds: half the machine redoes the other half)
            self.clock.charge("redundant", 0.0, advance=False)
        if self.obs is not None:
            self.obs.on_step(self.step_idx,
                             step_end - self.costs.step_time_s,
                             self.costs.step_time_s, rolled_back, self.n,
                             comm_items, self.rmap.role_of)
        self.step_idx += 1
        self.result.steps_done = self.step_idx

    # -- op dispatch: route to the owning comm layer -------------------------

    def _intake(self, worker: _Worker, op: tuple) -> Optional[tuple]:
        if op[0] in P2P_OPS:
            return self.transport.post(worker.ep, op, self.step_idx)
        return self.engine.post(worker.ep, op, self.step_idx)

    def _resolve(self, worker: _Worker):
        pend = worker.pending
        if self.transport.owns_pending(pend):
            return self.transport.resolve(worker.ep, pend)
        return self.engine.resolve(worker.ep, pend)

    # ------------------------------------------------------------------- run

    def run(self, n_steps: int) -> RunResult:
        # repro: allow[wallclock] -- genuine wall measurement
        wall0 = _time.perf_counter()
        if not self._injector_prepared:
            # horizon with slack: virtual time also advances on checkpoint
            # writes/restores (pre-scheduled event lists ignore prepare)
            horizon = injection_horizon(n_steps, self.costs.step_time_s,
                                        self.costs.ckpt_cost_s)
            self.injector.prepare(horizon, self.rmap.alive())
            self._injector_prepared = True
        while self.step_idx < n_steps:
            try:
                self._run_step()
            except ApplicationDead:
                self._restore_checkpoint()
                continue
            if self.coords.due_checkpoint(self.t) and \
                    self.ft.mode in ("checkpoint", "combined"):
                self._write_checkpoint()
        self.result.states = {
            r: self.workers[self.rmap.cmp[r]].state for r in range(self.n)}
        self.result.replays = self.recovery.replays
        self.result.duplicates_skipped = self.transport.duplicates_skipped
        # repro: allow[wallclock] -- genuine wall measurement
        self.result.wall_s = _time.perf_counter() - wall0
        if hasattr(self.app, "check"):
            self.result.check_value = self.app.check(self.result.states)
        if self.obs is not None:
            self.obs.sample_transport(self.transport)
            if self.store is not None:
                self.obs.sample_store(self.store)
            if self.obs.tracer is not None:
                self.obs.tracer.finish()
            self.result.obs = self.obs
            self.result.obs_metrics = self.obs.snapshot()
        return self.result
