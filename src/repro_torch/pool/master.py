"""Pool master + the PoolWorkload FTSession adapter (port of
``repro/pool/master.py``).

The master is the pool's placement-pinned, unreplicated rank — always
the LAST logical rank, so a session built with
``replicable_ranks=n_workers`` attaches replicas to exactly the worker
ranks (ReplicaMap replicas cover ranks ``0..m-1``).  Per round it
consumes one status from every live worker rank, records completions
set-once by idempotency key, and answers every non-busy worker with a
directive (a task off the policy queue, a speculative copy of the
oldest in-flight task when work-stealing is on, or ``("idle",)``).

Failure semantics (the tentpole contract):

  * worker cmp dies, replica alive -> the strategy promotes it O(1);
    ``apply_plan`` drops the dead endpoints and repairs the promoted
    one through ``comm.recovery`` (drain the failure round's
    in-flight directive, replay it PRICED from the master's sender
    log) — the task in flight finishes on the replica bit-identically,
    zero rollback;
  * worker cmp dies with no replica -> ``absorb_failures`` retires the
    rank in place (``ReplicaMap.retire_rank``) and requeues its task at
    the head — forward recovery, never a world restart (replication /
    combined modes; a checkpoint-only session takes the restore+replay
    path instead, by design);
  * master dies -> ``plan_recovery`` escalates to an elastic restart;
    the pool's snapshot/restore carries the master ledger, per-rank
    worker state, comm state AND in-flight messages, and prunes the
    master's send-ID streams toward respawned ranks so the dedup
    cursors never see a gap.

All pool traffic runs on the reserved ``repro_torch.pool.master`` tag
band registered in ``analyze.tags`` and is priced per message through the
session's topology cost model when one is configured.  The messages carry
plain Python data (task dicts, statuses, result values); the tasks compute
on the pool's ``device`` (``pool.workloads``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.comm.recovery import RecoveryManager
from repro_torch.comm.transport import ReplicaTransport
from repro_torch.core.message_log import LoggedMessage
from repro_torch.device import resolve
from repro_torch.pool import worker as _worker
from repro_torch.pool.scheduling import SchedulingPolicy, make_policy
from repro_torch.pool.task import Task
from repro_torch.tree import copy_tree

# reserved band ("repro_torch.pool.master", -44, -41) in analyze.tags
TAG_POOL_TASK = -41      # master -> worker: ("task", td) | ("idle",)
TAG_POOL_STATUS = -42    # worker -> master: ("ready",) | ("busy", id)
#                          | ("result", id, value)


class PoolWorkload:
    """The elastic replica-aware task pool as a first-class Workload.

    Runs under ``FTSession.run`` in all four FT modes.  The pool owns
    its transport (``self_replicating``: the strategy's whole-state
    shadow copy is bypassed — replica endpoints already execute inside
    ``step``) and implements the full elastic protocol surface:
    ``bind_session`` / ``apply_plan`` / ``absorb_failures`` /
    ``repair_transport`` plus ``snapshot``/``restore`` for checkpointed
    modes (memory-backed: ``disk_checkpointable = False``).  The tasks
    compute on ``device`` (None: the card; raises without CUDA)."""

    self_replicating = True
    disk_checkpointable = False

    def __init__(self, tasks: List[Task], *, policy="lpt",
                 speculate: bool = False, elastic: bool = True,
                 record_schedule: bool = False, device=None):
        self.device = resolve(device)
        self.tasks = list(tasks)
        self.policy: SchedulingPolicy = \
            make_policy(policy) if isinstance(policy, str) else policy
        self.speculate = speculate
        self.elastic = elastic
        self.record_schedule = record_schedule
        self.session = None
        self.transport: Optional[ReplicaTransport] = None
        self.eps: Dict[int, Any] = {}
        self.program_spec = None
        self.n_ranks = 0
        self.master_rank = -1
        self._sched = None                   # rank -> [op] (cmp role only)
        self._open: Dict[int, int] = {}      # rank -> undelivered directives

    # -- session wiring ------------------------------------------------------

    def bind_session(self, session) -> None:
        """FTSession calls this before ``init_state`` (and the session's
        ``_init_fabric`` has already built the rmap/pricing for the run)."""
        self.session = session

    @property
    def repair_transport(self):
        """The priced transport whose accrued drain/replay traffic the
        session books as the measured promotion repair cost."""
        return self.transport

    def _build_world(self) -> None:
        sess = self.session
        if sess is None:
            raise RuntimeError(
                "PoolWorkload must run under FTSession (session.run binds "
                "it before init_state)")
        rmap = sess.rmap
        self.n_ranks = rmap.n
        if self.n_ranks < 2:
            raise ValueError("pool needs >= 2 ranks (workers + master)")
        self.master_rank = self.n_ranks - 1
        if rmap.rep.get(self.master_rank) is not None:
            raise ValueError(
                "the pool master must stay unreplicated: build the session "
                "with replicable_ranks=n_logical_workers-1")
        self.transport = ReplicaTransport(
            rmap, self.n_ranks, cost_model=sess.pricing.cost_model)
        obs = sess.obs
        if obs is not None:
            self.transport.add_observer(obs)
            if self.transport.cost_model is not None and obs.links is None:
                self.transport.link_usage = obs.attach_links(
                    self.transport.cost_model)
        self.eps = {}
        for w in rmap.alive():
            self.eps[w] = self.transport.register(w)
        if self.record_schedule and self._sched is None:
            self._sched = {r: [] for r in range(self.n_ranks)}
            self._open = {r: 0 for r in range(self.n_ranks)}

    def _broadcast_program(self):
        """Initial program broadcast from the master rank: every rank
        posts the bcast through the reference collective matcher before
        round zero (the armi idiom — ship the task program once, then
        stream the work over p2p)."""
        from repro_torch.comm.collectives import (NOTHING,
                                                  ReferenceCollectives)
        names = sorted(dict.fromkeys(t.program for t in self.tasks))
        spec = {"programs": names, "n_tasks": len(self.tasks),
                "policy": self.policy.name}
        coll = ReferenceCollectives(self.n_ranks)
        pending = {}
        for r in range(self.n_ranks):
            value = spec if r == self.master_rank else None
            pending[r] = coll.post(r, ("bcast", value, self.master_rank))
            if self._sched is not None:
                self._sched[r].append(("bcast", None, self.master_rank))
        out = None
        for r in range(self.n_ranks):
            got = coll.resolve(r, pending[r])
            if got is NOTHING:
                raise RuntimeError("program bcast failed to resolve")
            out = got
        return out

    # -- Workload protocol ---------------------------------------------------

    def init_state(self):
        self._build_world()
        self.program_spec = self._broadcast_program()
        rmap = self.session.rmap
        ws = {}
        for r in range(self.master_rank):
            for wid in (rmap.cmp.get(r), rmap.rep.get(r)):
                if wid is not None:
                    ws[wid] = _worker.fresh_worker_state(self.program_spec)
        ms = {
            "queue": [t.as_dict() for t in self.policy.order(self.tasks)],
            "in_flight": {},      # id -> {rank, task, round, spec}
            "results": {},        # id -> value (set-once: idempotency)
            "latencies": [],      # completion latency, in rounds
            "retired": [],        # ranks taken out of service
            "completed": 0, "dispatched": 0, "reassigned": 0,
            "replica_covered": 0, "duplicates": 0, "speculated": 0,
            "busy_rounds": 0, "worker_rounds": 0,
        }
        return {"ms": ms, "ws": ws}

    def step(self, state, t: int):
        rmap = self.session.rmap
        ms, ws = state["ms"], state["ws"]
        # worker phase: cmp then rep per rank, ranks ascending — the two
        # endpoints of a rank run identical rounds on identical state
        for r in range(self.master_rank):
            if r in ms["retired"]:
                continue
            for wid in (rmap.cmp.get(r), rmap.rep.get(r)):
                if wid is None:
                    continue
                ep = self.eps.get(wid)
                if ep is not None:
                    _worker.run_worker_round(self, ep, ws[wid], t)
        self._master_round(ms, t)
        clock = self.session.clock
        if self.transport.cost_model is not None and clock is not None:
            # priced pool traffic enters the shared ledger; the schedule
            # clock stays step-indexed (ledger-only, like repair/ckpt)
            clock.charge_comm(self.transport, advance=False)
        obs = self.session.obs
        if obs is not None:
            obs.metrics.set_gauge("pool.queue_depth", len(ms["queue"]))
            obs.metrics.set_gauge("pool.in_flight", len(ms["in_flight"]))
            obs.metrics.set_gauge("pool.tasks.completed", ms["completed"])
            if ms["worker_rounds"]:
                obs.metrics.set_gauge(
                    "pool.occupancy",
                    ms["busy_rounds"] / ms["worker_rounds"])
        return state, float(ms["completed"])

    # -- master round --------------------------------------------------------

    def _master_round(self, ms, t: int) -> None:
        tp = self.transport
        rmap = tp.rmap
        ep = self.eps[rmap.cmp[self.master_rank]]
        live = [r for r in range(self.master_rank)
                if r not in ms["retired"] and rmap.cmp.get(r) is not None]
        free, busy = [], 0
        for r in live:
            m = tp.match_recv(ep, r, TAG_POOL_STATUS)
            if m is None:
                raise RuntimeError(
                    f"pool master: no status from rank {r} at round {t} "
                    f"(protocol error: every live worker reports per round)")
            self._record(ep, ("recv", r, TAG_POOL_STATUS))
            status = m.payload
            if status[0] == "result":
                self._accept_result(ms, status[1], status[2], r, t)
                busy += 1
                free.append(r)
            elif status[0] == "ready":
                free.append(r)
            else:                        # ("busy", id)
                busy += 1
        for r in free:
            directive = self._next_directive(ms, r, t)
            self._record(ep, ("send", r, TAG_POOL_TASK))
            tp.send(ep, r, TAG_POOL_TASK, directive, t, log=True)
        ms["busy_rounds"] += busy
        ms["worker_rounds"] += len(live)

    def _accept_result(self, ms, tid, value, r: int, t: int) -> None:
        entry = ms["in_flight"].pop(tid, None)
        if tid in ms["results"]:
            # idempotency: a speculative copy or a replayed execution
            # finishing late is counted, never applied
            ms["duplicates"] += 1
            self._obs_inc("pool.tasks.duplicates")
            return
        ms["results"][tid] = value
        ms["completed"] += 1
        self._obs_inc("pool.tasks.completed_total")
        if entry is None:
            return
        lat = t - entry["round"] + 1
        ms["latencies"].append(lat)
        obs = self.session.obs
        if obs is not None:
            obs.metrics.observe("pool.task_latency_rounds", lat)
            tr = obs.tracer
            if tr is not None:
                st = self.session.step_time_s
                tr.complete(r, "task", "pool.task", entry["round"] * st,
                            lat * st, {"task_id": tid, "rank": r})

    def _next_directive(self, ms, r: int, t: int):
        if ms["queue"]:
            td = ms["queue"].pop(0)
            ms["in_flight"][td["task_id"]] = \
                {"rank": r, "task": td, "round": t, "spec": []}
            ms["dispatched"] += 1
            self._obs_inc("pool.tasks.dispatched")
            return ("task", td)
        if self.speculate and ms["in_flight"]:
            # work-stealing: when the queue runs dry, re-dispatch the
            # oldest in-flight task (one copy max) to the idle worker —
            # idempotent by construction, the result table is set-once
            order = sorted(ms["in_flight"],
                           key=lambda k: (ms["in_flight"][k]["round"], k))
            for tid in order:
                entry = ms["in_flight"][tid]
                if entry["rank"] != r and not entry["spec"]:
                    entry["spec"].append(r)
                    ms["speculated"] += 1
                    self._obs_inc("pool.tasks.speculated")
                    return ("task", entry["task"])
        return ("idle",)

    # -- failure hooks (FTSession / FTStrategy seams) ------------------------

    def absorb_failures(self, state, fresh, step: int, rep):
        """Forward recovery for unreplicated worker-cmp deaths under a
        replica-bearing strategy: retire the rank in place and requeue
        its in-flight task — the alternative to the world restart
        ``plan_recovery`` would be forced into.  Everything else
        (promotable cmps, replicas, the master) flows through to the
        planner untouched."""
        sess = self.session
        if not self.elastic or not sess.strategy.wants_replica:
            return state, fresh
        from repro_torch.ft.session import StepEvent
        rmap = sess.rmap
        ms = state["ms"]
        remaining = []
        for w in fresh:
            role, r = rmap.role_of(w)
            live = [q for q in range(self.master_rank)
                    if q not in ms["retired"] and rmap.cmp.get(q) is not None]
            if role != "cmp" or r == self.master_rank or \
                    rmap.rep.get(r) is not None or len(live) <= 1:
                remaining.append(w)
                continue
            rmap.retire_rank(r)
            self.transport.drop(w)
            self.eps.pop(w, None)
            state["ws"].pop(w, None)
            ms["retired"].append(r)
            requeued = [tid for tid, entry in ms["in_flight"].items()
                        if entry["rank"] == r]
            for tid in requeued:
                entry = ms["in_flight"].pop(tid)
                ms["queue"].insert(0, entry["task"])
            ms["reassigned"] += len(requeued)
            self._obs_inc("pool.tasks.reassigned", len(requeued))
            self._obs_mark("pool.retire", rank=r, requeued=len(requeued))
            rep.events.append(StepEvent(step, "retire_rank",
                                        {"rank": r, "worker": w,
                                         "requeued": requeued}))
        return state, remaining

    def apply_plan(self, state, plan, step: int, rep):
        """Transport-side plan execution (called from the strategy's
        ``handle_plan`` before state handling): drop dead endpoints and
        repair each promoted replica's network view — drain the failure
        round's in-flight directive, replay it PRICED from the master's
        sender log (the session books ``take_comm_time()`` as the
        measured repair)."""
        if plan.kind == "restart_elastic":
            return state                  # restore/init_state rebuilds
        ms, ws = state["ms"], state["ws"]
        for w in plan.failed_workers:
            self.transport.drop(w)
            self.eps.pop(w, None)
            ws.pop(w, None)
        if not plan.promotions:
            return state
        man = RecoveryManager(self.transport, price_replay=True)
        # in-flight traffic was pipelined during the previous round;
        # treat it as lost with the dead worker's NIC and re-fetch it
        boundary = max(step - 1, 0)
        for event in plan.promotions:
            ep = self.eps.get(event["promoted"])
            if ep is None:
                continue
            n_replayed = man.repair_promoted(ep, boundary)
            r = event["rank"]
            covered = [tid for tid, entry in ms["in_flight"].items()
                       if entry["rank"] == r]
            if covered:
                ms["replica_covered"] += len(covered)
                self._obs_inc("pool.tasks.replica_covered", len(covered))
            self._obs_mark("pool.promote", rank=r, replayed=n_replayed)
        return state

    # -- checkpoint surface --------------------------------------------------

    def snapshot(self, state):
        """A consistent pool cut, keyed by LOGICAL RANK (worker ids churn
        across promotions/restarts): the master ledger, one worker state
        per rank (cmp's — the replica's is bit-identical), the rank's
        comm state, and its undelivered in-flight messages (the transport
        snapshot deliberately excludes inboxes; the pool pipelines
        directives across round boundaries, so it must carry them)."""
        rmap = self.session.rmap
        ranks = {}
        for r in rmap.active_ranks():
            wid = rmap.cmp[r]
            ep = self.eps[wid]
            ranks[r] = {
                "ws": None if r == self.master_rank
                else copy_tree(state["ws"][wid]),
                "comm": self.transport.snapshot_rank(r, ep),
                "inbox": [(m.send_id, m.src, m.dst, m.tag, m.payload,
                           m.step) for m in ep.live_messages()],
            }
        return {"ms": copy_tree(state["ms"]), "ranks": ranks,
                "program": self.program_spec}

    def restore(self, snap):
        """Rebuild the world on the session's (possibly fresh) rmap and
        load the snapshot into BOTH endpoints of every covered rank.
        Ranks absent from the snapshot (retired before the checkpoint,
        respawned by the restart) come back fresh — and the master's
        send-ID streams toward them are pruned, because a respawned rank
        restarts its streams at zero (the old counters would fault the
        dedup cursors: gap on the next send, silent skip on the next
        status)."""
        self._build_world()
        self.program_spec = snap.get("program")
        rmap = self.session.rmap
        ms = copy_tree(snap["ms"])
        ms["retired"] = []                # restart_map respawns every rank
        ws = {}
        missing = []
        for r in rmap.active_ranks():
            data = snap["ranks"].get(r)
            if data is None:
                missing.append(r)
                continue
            for wid in (rmap.cmp.get(r), rmap.rep.get(r)):
                if wid is None:
                    continue
                ep = self.eps[wid]
                self.transport.load_rank(r, ep, data["comm"])
                for sid, src, dst, tag, payload, mstep in data["inbox"]:
                    self.transport.deliver(
                        ep, LoggedMessage(sid, src, dst, tag, payload,
                                          mstep))
                if r != self.master_rank:
                    ws[wid] = copy_tree(data["ws"])
        for r in missing:
            for wid in (rmap.cmp.get(r), rmap.rep.get(r)):
                if wid is not None:
                    ws[wid] = _worker.fresh_worker_state(self.program_spec)
        if missing:
            self._prune_streams(missing)
        return {"ms": ms, "ws": ws}

    def _prune_streams(self, missing: List[int]) -> None:
        """Drop the master's counters / cursor entries / logged messages
        toward respawned ranks.  Only the master talks to workers, so
        pruning its state is the complete fix."""
        mrank = self.master_rank
        ep = self.eps[self.session.rmap.cmp[mrank]]
        for key in [k for k in ep.send_counters if k[1] in missing]:
            del ep.send_counters[key]
        for key in [k for k in ep.cursor.expected if k[0] in missing]:
            del ep.cursor.expected[key]
        log = self.transport.send_logs[mrank]
        log.log = [m for m in log.log if m.dst not in missing]
        log.bytes = sum(m.nbytes() for m in log.log)
        for key in [k for k in log.next_send_id if k[1] in missing]:
            del log.next_send_id[key]

    # -- introspection -------------------------------------------------------

    @staticmethod
    def pool_stats(state) -> dict:
        """The master ledger's counters plus derived occupancy/latency."""
        ms = state["ms"]
        lats = sorted(ms["latencies"])
        return {
            "completed": ms["completed"],
            "dispatched": ms["dispatched"],
            "reassigned": ms["reassigned"],
            "replica_covered": ms["replica_covered"],
            "duplicates": ms["duplicates"],
            "speculated": ms["speculated"],
            "queued": len(ms["queue"]),
            "in_flight": len(ms["in_flight"]),
            "retired_ranks": list(ms["retired"]),
            "occupancy": (ms["busy_rounds"] / ms["worker_rounds"]
                          if ms["worker_rounds"] else 0.0),
            "latency_mean_rounds": (sum(lats) / len(lats)
                                    if lats else 0.0),
            "latency_p99_rounds": (lats[min(len(lats) - 1,
                                            int(0.99 * len(lats)))]
                                   if lats else 0.0),
        }

    def recorded_schedule(self, close: bool = True):
        """The cmp-side op schedule this run executed, in the simrt op
        vocabulary — feed it to ``analyze.verify_schedule`` with
        ``infra_owners=("repro_torch.pool.master",)``.  ``close=True`` appends
        the receive each still-undelivered directive would have matched
        (the pipeline always ends a run with the final round's directives
        in flight)."""
        if self._sched is None:
            raise RuntimeError(
                "build the PoolWorkload with record_schedule=True")
        sched = {r: list(ops) for r, ops in self._sched.items()}
        if close:
            for r in range(self.master_rank):
                for _ in range(max(0, self._open.get(r, 0))):
                    sched[r].append(("recv", self.master_rank,
                                     TAG_POOL_TASK))
        return sched

    # -- internal helpers ----------------------------------------------------

    def _record(self, ep, op) -> None:
        if self._sched is None:
            return
        role, rank = self.transport.rmap.role_of(ep.wid)
        if role != "cmp":
            return
        self._sched[rank].append(op)
        kind, peer, tag = op
        if tag == TAG_POOL_TASK:
            if kind == "send":
                self._open[peer] = self._open.get(peer, 0) + 1
            else:
                self._open[rank] = self._open.get(rank, 0) - 1

    def _obs_inc(self, name: str, n: int = 1) -> None:
        obs = self.session.obs if self.session is not None else None
        if obs is not None:
            obs.metrics.inc(name, n)

    def _obs_mark(self, name: str, **args) -> None:
        obs = self.session.obs if self.session is not None else None
        if obs is not None:
            obs.mark(name, "pool", **args)
