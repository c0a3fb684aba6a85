"""ISP/MUST-style static match verifier for per-rank op schedules (the
port of ``repro/analyze/schedule.py``).

A *schedule* is ``{rank: [op, ...]}`` in the simrt generator op
vocabulary (docs/comm_api.md) — either declared directly in a test, or
extracted from a live app with :func:`trace_app`, which runs the app
through the sequential reference resolver with a recording proxy so the
captured ops are exactly what the app would yield to ``SimRuntime``.

The verifier abstract-interprets the schedule the way the runtime would
execute it — round-robin passes, inbox matching by (src, tag), transport
collectives decomposed into point-to-point messages on their real
reserved tags, switchboard collectives (allreduce / barrier) matched by
per-rank instance index exactly like ``CollectiveEngine`` keys — and
reports, as :class:`~repro_torch.analyze.findings.Finding`s:

  unmatched-send        a message nobody ever receives
  unmatched-recv        a receive no remaining rank can satisfy
  deadlock              a cycle in the wait-for graph at quiescence
  collective-mismatch   ranks disagree on the collective instance
                        (kind / redop / malformed chunks or neighbors)
  tag-reserved          an app op using a reserved negative tag
  wildcard-ambiguity    (warning) a ``recv_any`` that matches while
                        messages from >1 distinct source are eligible —
                        the match order is timing-dependent, which is
                        precisely the case replica promotion must
                        reconcile through the transport's wc_order log

Because promotion replays a replica over the same schedule, a schedule
that verifies clean here is safe under any single-failure promotion: the
protocol only reorders *when* matches happen, never *whether* they do.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Set

from repro_torch.analyze.findings import ERROR, Finding, WARNING
from repro_torch.analyze.tags import band_owner

Schedule = Dict[int, Sequence[tuple]]

# switchboard collectives match in a shared table (no messages); everything
# else in this set decomposes into p2p on a reserved tag
_SWITCHBOARD = ("allreduce", "barrier")
_COLLECTIVES = _SWITCHBOARD + (
    "bcast", "gather", "allgather", "reduce_scatter", "alltoall", "scan",
    "neighbor_allgather", "neighbor_alltoall")


def _coll_tags() -> Dict[str, int]:
    from repro_torch.comm import collectives as c
    return {
        "bcast": c.TAG_BCAST, "gather": c.TAG_GATHER,
        "allgather": c.TAG_ALLGATHER,
        "reduce_scatter": c.TAG_REDUCE_SCATTER,
        "alltoall": c.TAG_ALLTOALL, "scan": c.TAG_SCAN,
        "neighbor_allgather": c.TAG_NEIGHBOR_ALLGATHER,
        "neighbor_alltoall": c.TAG_NEIGHBOR_ALLTOALL,
    }


class _Token:
    """One in-flight message: who sent it, on which tag, from which op."""

    __slots__ = ("src", "tag", "opidx", "what")

    def __init__(self, src: int, tag: int, opidx: int, what: str):
        self.src = src
        self.tag = tag
        self.opidx = opidx
        self.what = what        # "send"/"exchange"/collective kind


class _Rank:
    __slots__ = ("ops", "pc", "pending", "done", "sb_index")

    def __init__(self, ops: Sequence[tuple]):
        self.ops = list(ops)
        self.pc = 0             # index of the op currently being executed
        self.pending: Optional[tuple] = None
        self.done = False
        self.sb_index = 0       # switchboard instance counter (engine keys)


class _Verifier:
    def __init__(self, sched: Schedule, n: Optional[int], label: str,
                 infra_owners: Sequence[str] = ()):
        self.n = n if n is not None else (max(sched) + 1 if sched else 0)
        self.label = label
        # subsystems whose own reserved bands the schedule may use: an
        # infra subsystem verifying its hand-written protocol (e.g. the
        # task pool's master/worker rounds) runs on its registered band
        self.infra_owners = tuple(infra_owners)
        self.ranks = {r: _Rank(sched.get(r, ())) for r in range(self.n)}
        self.inbox: Dict[int, List[_Token]] = {r: [] for r in range(self.n)}
        self.contrib: Dict[tuple, Set[int]] = {}   # switchboard table
        self.findings: List[Finding] = []
        self.coll_tags = _coll_tags()

    # -- reporting -----------------------------------------------------------

    def _where(self, rank: int) -> str:
        return f"{self.label} rank {rank}"

    def _emit(self, rank: int, opidx: int, rule: str, message: str,
              hint: str = "", severity: str = ERROR) -> None:
        self.findings.append(Finding(rule, self._where(rank), opidx + 1,
                                     message, hint, severity))

    # -- inbox ---------------------------------------------------------------

    def _deliver(self, dst: int, src: int, tag: int, opidx: int,
                 what: str) -> None:
        self.inbox[dst].append(_Token(src, tag, opidx, what))

    def _take(self, rank: int, src: Optional[int], tag: int
              ) -> Optional[_Token]:
        box = self.inbox[rank]
        for i, tok in enumerate(box):
            if (src is None or tok.src == src) and tok.tag == tag:
                del box[i]
                return tok
        return None

    def _wildcard_candidates(self, rank: int, tag: int) -> Set[int]:
        return {tok.src for tok in self.inbox[rank] if tok.tag == tag}

    # -- op intake -----------------------------------------------------------

    def _check_app_tag(self, rank: int, opidx: int, tag: Any,
                       kind: str) -> None:
        if not isinstance(tag, int) or tag >= 0:
            return
        owner = band_owner(tag)
        if owner is not None and owner in self.infra_owners:
            return                   # the schedule's own registered band
        owned = f", reserved by {owner}" if owner else \
            " in the reserved negative space"
        self._emit(rank, opidx, "tag-reserved",
                   f"{kind} uses tag {tag}{owned}; app tags must be >= 0",
                   "pick a non-negative tag")

    def _intake(self, rank: int, op: tuple) -> Optional[tuple]:
        """Execute the non-blocking half of ``op``; return the pending
        descriptor for its blocking half (or None)."""
        st = self.ranks[rank]
        opidx = st.pc
        kind = op[0]
        if kind == "send":
            _, dst, tag = op[0], op[1], op[2]
            self._check_app_tag(rank, opidx, tag, "send")
            if not self._valid_peer(rank, opidx, dst, "send"):
                return None
            self._deliver(dst, rank, tag, opidx, "send")
            return None
        if kind == "exchange":
            _, outmap, tag = op
            self._check_app_tag(rank, opidx, tag, "exchange")
            dsts = sorted(outmap)
            for dst in dsts:
                if self._valid_peer(rank, opidx, dst, "exchange"):
                    self._deliver(dst, rank, tag, opidx, "exchange")
            return ("waitall", frozenset(d for d in dsts
                                         if 0 <= d < self.n), tag,
                    set(), "exchange")
        if kind == "recv":
            _, src, tag = op
            self._check_app_tag(rank, opidx, tag, "recv")
            return ("recv", src, tag)
        if kind == "recv_any":
            self._check_app_tag(rank, opidx, op[1], "recv_any")
            return ("recv_any", op[1])
        if kind in _SWITCHBOARD:
            return self._intake_switchboard(rank, op)
        if kind in _COLLECTIVES:
            return self._intake_transport_coll(rank, op)
        self._emit(rank, opidx, "unknown-op",
                   f"unknown op kind {kind!r}",
                   "see docs/comm_api.md for the op vocabulary")
        return None

    def _valid_peer(self, rank: int, opidx: int, peer: Any,
                    kind: str) -> bool:
        if isinstance(peer, int) and 0 <= peer < self.n:
            return True
        self._emit(rank, opidx, "unknown-op",
                   f"{kind} addresses rank {peer!r} outside the "
                   f"0..{self.n - 1} world")
        return False

    def _intake_switchboard(self, rank: int, op: tuple) -> tuple:
        st = self.ranks[rank]
        idx = st.sb_index
        st.sb_index += 1
        # CollectiveEngine key: (kind, instance index) + redop for allreduce
        key = (op[0], idx) + ((op[2],) if op[0] == "allreduce" else ())
        self.contrib.setdefault(key, set()).add(rank)
        return ("collective", key)

    def _intake_transport_coll(self, rank: int,
                               op: tuple) -> Optional[tuple]:
        st = self.ranks[rank]
        opidx = st.pc
        kind = op[0]
        n = self.n
        tag = self.coll_tags[kind]

        def fanout(dsts):
            for dst in dsts:
                self._deliver(dst, rank, tag, opidx, kind)

        def waitall(srcs):
            return ("waitall", frozenset(srcs), tag, set(), kind)

        if kind == "bcast":
            root = op[2]
            if not self._valid_peer(rank, opidx, root, kind):
                return None
            if rank == root:
                fanout(d for d in range(n) if d != root)
                return None
            return waitall({root})
        if kind == "gather":
            root = op[2]
            if not self._valid_peer(rank, opidx, root, kind):
                return None
            if rank == root:
                return waitall(s for s in range(n) if s != root)
            self._deliver(root, rank, tag, opidx, kind)
            return None
        if kind in ("allgather", "reduce_scatter", "alltoall"):
            if kind != "allgather" and len(op[1]) != n:
                self._emit(rank, opidx, "collective-mismatch",
                           f"{kind} needs one chunk per rank ({n}), "
                           f"got {len(op[1])}")
                return None
            fanout(d for d in range(n) if d != rank)
            return waitall(s for s in range(n) if s != rank)
        if kind == "scan":
            fanout(range(rank + 1, n))
            return waitall(range(rank)) if rank else None
        # neighborhood collectives
        nbrs = tuple(op[2])
        if len(nbrs) != len(set(nbrs)) or rank in nbrs or \
                not all(isinstance(q, int) and 0 <= q < n for q in nbrs):
            self._emit(rank, opidx, "collective-mismatch",
                       f"{kind} neighbor list must be unique in-world "
                       f"ranks excluding self, got {nbrs}")
            return None
        if kind == "neighbor_alltoall" and len(op[1]) != len(nbrs):
            self._emit(rank, opidx, "collective-mismatch",
                       f"neighbor_alltoall needs one chunk per neighbor "
                       f"({len(nbrs)}), got {len(op[1])}")
            return None
        fanout(nbrs)
        return waitall(nbrs)

    # -- pending resolution --------------------------------------------------

    def _resolve(self, rank: int, pend: tuple) -> bool:
        """True when the pending op completed this pass."""
        kind = pend[0]
        if kind == "recv":
            return self._take(rank, pend[1], pend[2]) is not None
        if kind == "recv_any":
            cands = self._wildcard_candidates(rank, pend[1])
            if not cands:
                return False
            if len(cands) > 1:
                self._emit(
                    rank, self.ranks[rank].pc, "wildcard-ambiguity",
                    f"recv_any(tag={pend[1]}) can match messages from "
                    f"ranks {sorted(cands)}: match order is "
                    f"timing-dependent",
                    "replica promotion reconciles this through the "
                    "transport wc_order log, but a deterministic "
                    "schedule should prefer explicit recv(src, tag)",
                    WARNING)
            self._take(rank, None, pend[1])
            return True
        if kind == "waitall":
            _, srcs, tag, got, _what = pend
            for s in srcs:
                if s not in got:
                    if self._take(rank, s, tag) is not None:
                        got.add(s)
            return len(got) == len(srcs)
        if kind == "collective":
            return self.contrib.get(pend[1], set()) >= \
                set(range(self.n))
        raise AssertionError(pend)

    # -- wait-for graph at quiescence ----------------------------------------

    def _waits_on(self, rank: int, pend: tuple) -> Set[int]:
        kind = pend[0]
        if kind == "recv":
            return {pend[1]} if 0 <= pend[1] < self.n else set()
        if kind == "recv_any":
            return {r for r in range(self.n)
                    if r != rank and not self.ranks[r].done}
        if kind == "waitall":
            return set(pend[1]) - pend[3]
        if kind == "collective":
            return set(range(self.n)) - self.contrib.get(pend[1], set())
        raise AssertionError(pend)

    def _describe(self, pend: tuple) -> str:
        kind = pend[0]
        if kind == "recv":
            return f"recv(src={pend[1]}, tag={pend[2]})"
        if kind == "recv_any":
            return f"recv_any(tag={pend[1]})"
        if kind == "waitall":
            missing = sorted(set(pend[1]) - pend[3])
            return f"{pend[4]} waiting on ranks {missing} (tag {pend[2]})"
        if kind == "collective":
            return f"collective {pend[1][0]} instance {pend[1][1:]}"
        raise AssertionError(pend)

    def _report_quiescence(self) -> None:
        blocked = {r: st.pending for r, st in self.ranks.items()
                   if not st.done}
        if not blocked:
            return
        edges = {r: self._waits_on(r, p) & set(blocked)
                 for r, p in blocked.items()}

        def reaches(a: int, b: int) -> bool:
            seen, stack = set(), list(edges[a])
            while stack:
                x = stack.pop()
                if x == b:
                    return True
                if x in seen:
                    continue
                seen.add(x)
                stack.extend(edges.get(x, ()))
            return False

        in_cycle = {r for r in blocked if reaches(r, r)}
        reported: Set[int] = set()
        for r in sorted(in_cycle):
            if r in reported:
                continue
            scc = sorted(s for s in in_cycle
                         if s == r or (reaches(r, s) and reaches(s, r)))
            reported.update(scc)
            chain = "; ".join(
                f"rank {s} blocked at op {self.ranks[s].pc + 1} on "
                f"{self._describe(blocked[s])}" for s in scc)
            self._emit(r, self.ranks[r].pc, "deadlock",
                       f"wait-for cycle among ranks {scc}: {chain}",
                       "reorder the ops so some rank in the cycle can "
                       "make progress (classic head-to-head recv)")
        for r in sorted(set(blocked) - in_cycle):
            p = blocked[r]
            rule = "collective-mismatch" if p[0] == "collective" \
                else "unmatched-recv"
            self._emit(r, self.ranks[r].pc, rule,
                       f"{self._describe(p)} can never complete: no "
                       f"remaining rank supplies it",
                       "add the matching send / collective call on the "
                       "peer rank")

    def _report_leftovers(self) -> None:
        for dst in range(self.n):
            for tok in self.inbox[dst]:
                what = tok.what if tok.what in ("send", "exchange") \
                    else f"{tok.what} (tag {tok.tag})"
                self._emit(tok.src, tok.opidx, "unmatched-send",
                           f"{what} to rank {dst} (tag {tok.tag}) is "
                           f"never received",
                           "add the matching recv on the destination "
                           "rank, or drop the send")

    # -- driver --------------------------------------------------------------

    def run(self) -> List[Finding]:
        while True:
            progressed = False
            for r in range(self.n):
                st = self.ranks[r]
                while not st.done:
                    if st.pending is not None:
                        if not self._resolve(r, st.pending):
                            break
                        st.pending = None
                        st.pc += 1
                    if st.pc >= len(st.ops):
                        st.done = True
                        break
                    st.pending = self._intake(r, st.ops[st.pc])
                    progressed = True
                    if st.pending is None:
                        st.pc += 1
            if all(st.done for st in self.ranks.values()):
                break
            if not progressed:
                self._report_quiescence()
                break
        self._report_leftovers()
        return self.findings


def verify_schedule(sched: Schedule, n: Optional[int] = None,
                    label: str = "schedule",
                    infra_owners: Sequence[str] = ()) -> List[Finding]:
    """Statically verify one per-rank op schedule; empty list == clean
    (warnings such as wildcard-ambiguity count as findings but not
    errors — filter with findings.errors()).  ``infra_owners`` names
    reserved-band owners (analyze.tags.RESERVED_BANDS) whose tags
    the schedule legitimately uses — for verifying an infra subsystem's
    own hand-written protocol on its registered band."""
    return _Verifier(sched, n, label, infra_owners).run()


# --------------------------------------------------------------------------
# schedule extraction from live apps
# --------------------------------------------------------------------------

def _strip(op: tuple) -> tuple:
    """Replace payloads with None, keeping everything matching depends on
    (destinations, tags, roots, redops, chunk counts, neighbor lists)."""
    kind = op[0]
    if kind == "send":
        return ("send", op[1], op[2], None)
    if kind == "exchange":
        return ("exchange", {dst: None for dst in op[1]}, op[2])
    if kind in ("recv", "recv_any", "barrier", "bcast", "gather",
                "allreduce", "scan"):
        # payload slot (if any) is op[1]; bcast/gather roots and
        # allreduce/scan redops live at op[2] and must survive
        if kind in ("allreduce", "scan", "bcast", "gather"):
            return (kind, None, op[2])
        return op
    if kind == "allgather":
        return ("allgather", None)
    if kind in ("reduce_scatter", "alltoall"):
        stripped = [None] * len(op[1])
        return (kind, stripped) + ((op[2],) if kind == "reduce_scatter"
                                   else ())
    if kind == "neighbor_allgather":
        return (kind, None, tuple(op[2]))
    if kind == "neighbor_alltoall":
        return (kind, [None] * len(op[1]), tuple(op[2]))
    return op


class _RecorderApp:
    """Proxy that records every op an app's generators yield, while the
    sequential reference resolver supplies real answers — so traced
    schedules reflect genuine control flow, including branches taken on
    received values."""

    def __init__(self, app):
        self.app = app
        self.n_ranks = app.n_ranks
        self.ops: Dict[int, List[tuple]] = {}

    def begin(self) -> None:
        self.ops = {r: [] for r in range(self.n_ranks)}

    def schedule(self) -> Schedule:
        return {r: list(ops) for r, ops in self.ops.items()}

    def init_state(self, rank: int):
        return self.app.init_state(rank)

    def check(self, states):
        chk = getattr(self.app, "check", None)
        return chk(states) if chk else None

    def step(self, rank: int, state, t: int):
        inner = self.app.step(rank, state, t)

        def recording():
            send_val = None
            while True:
                try:
                    op = inner.send(send_val)
                except StopIteration as stop:
                    return stop.value
                # stripped first: payload tensors are never copied
                self.ops[rank].append(copy.deepcopy(_strip(op)))
                send_val = yield op

        return recording()


def trace_app(app, steps: int = 1) -> List[Schedule]:
    """Run ``app`` for ``steps`` steps under the sequential reference
    resolver, returning one recorded schedule per step."""
    from repro_torch.ft.workload import SimAppWorkload

    rec = _RecorderApp(app)
    wl = SimAppWorkload(rec)
    states = wl.init_state()
    out: List[Schedule] = []
    for t in range(steps):
        rec.begin()
        states, _ = wl.step(states, t)
        out.append(rec.schedule())
    return out


def verify_app(app, steps: int = 1, label: str = "") -> List[Finding]:
    """Trace ``app`` and verify every step's schedule."""
    label = label or type(app).__name__
    findings: List[Finding] = []
    for t, sched in enumerate(trace_app(app, steps)):
        findings.extend(verify_schedule(sched, app.n_ranks,
                                        f"{label} step {t}"))
    return findings
