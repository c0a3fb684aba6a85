"""Replica-aware point-to-point transport (paper §5, §6.3).

Owns the routing rules of FTHP-MPI's parallel communication scheme:

  * a computational sender sends cmp->cmp and, when the destination is
    replicated but the source is not, also fills in the replica copy over
    the intercomm (cmp->rep);
  * a replica sender sends rep->rep in parallel, and SKIPS the send when
    the destination has no replica;
  * every send carries a piggybacked send-ID per (src, dst, tag) stream —
    cmp and rep advance the same counters because they execute identical
    sends — and computational sends are recorded in the sender-based
    message log for replay after failures;
  * MPI_ANY_SOURCE: the computational receiver picks the message and
    forwards its chosen (src, tag, send_id) order to the replica, which
    consumes the same stream in the same order;
  * receiver-side send-ID cursors drop duplicates (exactly-once).

Matching is indexed (docs/perf.md): every delivery lands in a
per-(src, tag) FIFO bucket AND a per-tag arrival index, as one shared
*cell* ``[message, arrival_seq, alive]``.  A directed receive pops its
bucket head; a wildcard receive pops the earliest live cell of its tag —
both O(1) — and consuming through either index flips the cell's alive
flag AND nulls its message reference, so the payload is released the
moment it is consumed even though the dead cell is still queued in the
sibling index.  Dead cells themselves are bounded: ``admit`` pops the
dead prefix of both deques before appending, and ``drain_tag`` drops
the buckets it has fully consumed — neither index retains
O(message-history) state.  Payloads are captured copy-on-write
(``comm.payload``): ndarrays are frozen at send time and the
single frozen message is shared by the sender log, the computational
delivery, and the replica fill-in; payloads the CoW walker cannot
freeze (views of writeable buffers, opaque objects) are copied instead,
restoring the pre-CoW isolation exactly where sharing would be unsafe.

The transport knows nothing about scheduling, virtual time, checkpoints,
or failure policy — those live in the runtime and ``comm.recovery``.

The PyTorch port's copy of ``repro/comm/transport.py``.  A tensor payload
(on the CPU or the card) cannot be frozen, so it is never shared: the
clone ``comm.payload`` captures at the send stays in the sender log, and
every delivery — the computational copy, the intercomm fill-in, a replay —
carries a clone of its own (``own_tensors``), so a receiver's in-place
write reaches neither the log nor its twin.  Routing, matching, send-IDs
and pricing are the reference's line for line, and so are the observer
list, the per-link utilization accumulator (``link_usage``), the
scheduler's wake hook (``waker``) and elastic rebinding (``rebind``).
"""
from __future__ import annotations

import copy
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.comm.payload import (freeze_payload, own_tensors,
                                      structural_copy)
from repro_torch.core.message_log import (LoggedMessage, ReceiverCursor,
                                          SenderLog, payload_nbytes)
from repro_torch.core.replica_map import ReplicaMap


class _Nothing:
    """Sentinel for "operation not yet satisfiable" (distinct from None,
    which is a legal op result — e.g. a barrier's)."""

    __repr__ = lambda self: "<NOTHING>"          # noqa: E731


NOTHING = _Nothing()

# op kinds the transport intakes / resolves on its own
P2P_OPS = frozenset({"send", "exchange", "recv", "recv_any"})
_P2P_PENDING = frozenset({"recv", "recv_any", "exchange_wait"})


class Endpoint:
    """Per-worker communication state: the part of a worker the comm
    subsystem owns (the scheduler owns app state / generator / pending).

    Arrivals are indexed twice through shared cells (see module
    docstring); ``inbox`` remains available as a read-only arrival-order
    view for tests and debugging."""

    __slots__ = ("wid", "buckets", "tag_index", "arrival_seq", "cursor",
                 "wc_consumed", "wc_matches", "wc_matches_base",
                 "send_counters", "op_index")

    def __init__(self, wid: int):
        self.wid = wid
        # (src, tag) -> deque of cells [msg, seq, alive]: directed FIFO
        self.buckets: Dict[Tuple[int, int], deque] = {}
        # tag -> deque of the same cells in arrival order: wildcard index
        self.tag_index: Dict[int, deque] = {}
        self.arrival_seq = 0
        self.cursor = ReceiverCursor(wid)    # send-ID dedup cursor
        self.wc_consumed = 0                 # wildcard-order cursor (global)
        # every wildcard match this endpoint performed, as (src, tag,
        # send_id) — recorded on BOTH roles so a cmp/rep pair's wildcard
        # histories can be compared entry-by-entry (the send-ID pins the
        # exact logged message each recv_any consumed).  Checkpoint
        # boundaries trim the list; wc_matches_base is the consumed index
        # of its first retained entry.
        self.wc_matches: List[Tuple[int, int, int]] = []
        self.wc_matches_base = 0
        # per-stream send-id counters: cmp and rep advance these identically
        # because they execute identical sends (paper §6.3)
        self.send_counters: Dict[Tuple[int, int, int], int] = {}
        self.op_index = 0                    # collective-matching index

    # -- arrival indexes ----------------------------------------------------

    def admit(self, msg: LoggedMessage) -> None:
        cell = [msg, self.arrival_seq, True]
        self.arrival_seq += 1
        b = self.buckets.get((msg.src, msg.tag))
        if b is None:
            b = self.buckets[(msg.src, msg.tag)] = deque()
        # compact the dead prefix (cells consumed through the sibling
        # index) so steady-state traffic never accumulates dead cells
        while b and not b[0][2]:
            b.popleft()
        b.append(cell)
        t = self.tag_index.get(msg.tag)
        if t is None:
            t = self.tag_index[msg.tag] = deque()
        while t and not t[0][2]:
            t.popleft()
        t.append(cell)

    def admit_bulk(self, msgs) -> int:
        """Admit many messages in the given order (replay/rebuild): one
        call amortizes the per-message index lookups.  Returns the count
        admitted."""
        count = 0
        for m in msgs:
            self.admit(m)
            count += 1
        return count

    def live_messages(self) -> List[LoggedMessage]:
        """Unconsumed messages in arrival order (drain/replay/tests)."""
        cells = [c for q in self.buckets.values() for c in q if c[2]]
        cells.sort(key=lambda c: c[1])
        return [c[0] for c in cells]

    def replace_messages(self, msgs) -> None:
        """Rebuild both indexes from ``msgs`` preserving the given order
        (failure-time drain)."""
        self.buckets = {}
        self.tag_index = {}
        self.arrival_seq = 0
        self.admit_bulk(msgs)

    @property
    def inbox(self) -> List[LoggedMessage]:
        return self.live_messages()


class ReplicaTransport:
    """Routing + matching over a ReplicaMap world.

    ``rebind`` swaps the replica map after an elastic restart; endpoints are
    registered by the scheduler for every alive worker.
    """

    def __init__(self, rmap: ReplicaMap, n_ranks: int,
                 log_limit_bytes: int = 1 << 28, cost_model=None,
                 mutable_recv: bool = False):
        self.rmap = rmap
        self.n = n_ranks
        # opt-in (FTConfig.mutable_recv): hand every resolved p2p recv a
        # private writeable copy instead of the shared frozen payload —
        # for apps that mutate received ndarrays in place (legal under
        # real MPI, where the recv buffer is app-owned).  Costs one
        # structural_copy per recv; the log keeps the frozen original.
        # A tensor delivery is already the receiver's own.
        self.mutable_recv = mutable_recv
        self.send_logs = {r: SenderLog(r, log_limit_bytes)
                          for r in range(n_ranks)}
        # rank -> [(src, tag, send_id)]: the cmp-chosen wildcard order.
        # Checkpoint boundaries trim consumed prefixes; wc_base[rank] is
        # the consumed index of the first retained entry, so endpoint
        # cursors (wc_consumed) keep counting monotonically across trims.
        self.wc_order: Dict[int, List[Tuple[int, int, int]]] = \
            {r: [] for r in range(n_ranks)}
        self.wc_base: Dict[int, int] = {r: 0 for r in range(n_ranks)}
        self.endpoints: Dict[int, Endpoint] = {}
        self.duplicates_skipped = 0
        # monotone delivery/consumption counter: multi-round collective
        # schedules (topo.algorithms) consume and forward messages
        # inside a resolve that still returns NOTHING — schedulers watch
        # this to tell that apart from a genuine deadlock
        self.activity = 0
        # per-message α‑β pricing (topo.TopoCostModel or anything
        # with msg_cost_workers); None keeps the transport cost-free
        self.cost_model = cost_model
        self.comm_time: Dict[int, float] = {}   # sender wid -> accrued s
        # ordered send observers (analyze.DivergenceDetector,
        # obs.ObsRecorder): each is called once per logical send
        # with (role, src, dst, tag, send_id, payload, step) BEFORE role
        # routing, so replica-side skipped sends are still observed.
        # Ordering contract (docs/comm_api.md): the divergence detector
        # registers FIRST (add_observer(first=True)) so a raising
        # tripwire fires before any metrics/tracing observer counts the
        # send it is about to reject.
        self.observers: List[Any] = []
        # per-link utilization accumulator (obs.LinkUsage) fed by _charge
        # alongside the α‑β pricing; None (default) adds one attribute
        # check per priced message
        self.link_usage = None
        # delivery wake hook: the ready-queue scheduler registers a
        # callable(wid) and gets woken per delivery and per wildcard-order
        # append (the two events that can unblock a parked worker)
        self.waker: Optional[Callable[[int], None]] = None

    # ------------------------------------------------------------ lifecycle

    def register(self, wid: int) -> Endpoint:
        ep = Endpoint(wid)
        self.endpoints[wid] = ep
        return ep

    def rebind(self, rmap: ReplicaMap) -> None:
        """Adopt a rebuilt world (elastic restart); endpoints re-register."""
        self.rmap = rmap
        self.endpoints = {}

    def drop(self, wid: int) -> None:
        self.endpoints.pop(wid, None)

    def role_of(self, ep: Endpoint) -> Tuple[str, int]:
        return self.rmap.role_of(ep.wid)

    # ------------------------------------------------------------ observers

    def add_observer(self, obs, *, first: bool = False) -> None:
        """Register a send observer.  ``first=True`` prepends (the
        divergence detector's slot: raising tripwires run before
        counting observers); re-adding an already-registered observer is
        a no-op, and adding never displaces another observer."""
        if obs not in self.observers:
            if first:
                self.observers.insert(0, obs)
            else:
                self.observers.append(obs)

    def remove_observer(self, obs) -> None:
        try:
            self.observers.remove(obs)
        except ValueError:
            pass

    # -------------------------------------------------------------- sending

    def deliver(self, ep: Endpoint, msg: LoggedMessage) -> None:
        ep.admit(msg)
        self.activity += 1
        if self.waker is not None:
            self.waker(ep.wid)

    def deliver_bulk(self, ep: Endpoint, msgs) -> None:
        """Deliver many messages to one endpoint (log replay): a single
        activity bump and ONE waker call instead of one per message."""
        count = ep.admit_bulk(msgs)
        if count:
            self.activity += count
            if self.waker is not None:
                self.waker(ep.wid)

    def _charge(self, src_wid: int, dst_wid: int, nbytes: int,
                tag: Optional[int] = None) -> None:
        """Accrue the priced cost of one physical message on the sender
        (port model: the sender's NIC serializes its own messages; senders
        run in parallel, so a step's comm time is the max over workers).
        ``tag`` labels the traffic class for the optional per-link
        utilization accumulator (None: switchboard phantom pricing)."""
        cost = self.cost_model.msg_cost_workers(src_wid, dst_wid, nbytes)
        self.comm_time[src_wid] = self.comm_time.get(src_wid, 0.0) + cost
        if self.link_usage is not None:
            self.link_usage.record(src_wid, dst_wid, tag, nbytes)

    def take_comm_time(self) -> float:
        """Max accrued per-worker comm time since the last take (0.0 with
        no cost model); resets the accumulator."""
        if not self.comm_time:
            return 0.0
        worst = max(self.comm_time.values())
        self.comm_time.clear()
        return worst

    def charge_phantom(self, sender: Endpoint, dst_rank: int,
                       nbytes: int) -> None:
        """Price one message the caller matched in shared memory instead
        of sending (the switchboard collectives): identical §5 routing and
        accrual to ``send`` — cmp→cmp plus intercomm fill-in, rep→rep with
        replica-side skip — but no delivery, no logging, no send-ID.  This
        is how switchboard allreduce/barrier report ``TimeBreakdown.comm``
        through the same priced transport as the p2p-schedule algorithms
        (no-op without a cost model)."""
        if self.cost_model is None:
            return
        role, src_rank = self.rmap.role_of(sender.wid)
        if role == "cmp":
            dst_wid = self.rmap.cmp.get(dst_rank)
            if dst_wid is not None:
                self._charge(sender.wid, dst_wid, nbytes)
            if self.rmap.rep.get(dst_rank) is not None and \
                    self.rmap.rep.get(src_rank) is None:
                self._charge(sender.wid, self.rmap.rep[dst_rank], nbytes)
        elif self.rmap.rep.get(dst_rank) is not None:
            self._charge(sender.wid, self.rmap.rep[dst_rank], nbytes)

    def send(self, sender: Endpoint, dst_rank: int, tag: int, payload,
             step: int, *, log: bool) -> None:
        """Route one send per the paper's §5 parallel scheme.

        The payload is captured copy-on-write: frozen (ndarray
        ``writeable=False``) and shared by the log, the computational
        delivery and the replica fill-in — no per-send deepcopy.  A
        tensor cannot be frozen: the log keeps the captured clone and
        each delivery gets a clone of its own.  A sender
        that mutates the object after the send gets a ValueError instead
        of silent log corruption (the MPI buffer contract, made loud).
        Views of writeable buffers are copied at capture (sending a slice
        of state you keep updating is legal, as under real MPI), and a
        payload the CoW walker cannot freeze at all (subclass container,
        custom object) falls back to the pre-CoW deepcopy isolation:
        one capture copy here, one more for the replica fill-in below —
        only fully-frozen payloads are ever shared."""
        role, src_rank = self.rmap.role_of(sender.wid)
        payload, frozen = freeze_payload(payload)
        if not frozen:
            # opaque payload: isolate from later sender mutation exactly
            # as the pre-CoW transport did
            payload = copy.deepcopy(payload)  # repro: allow[deepcopy]
        nbytes = payload_nbytes(payload) if self.cost_model is not None else 0
        stream = (src_rank, dst_rank, tag)
        sid = sender.send_counters.get(stream, 0)
        sender.send_counters[stream] = sid + 1
        if self.observers:
            for ob in self.observers:
                ob.on_send(role, src_rank, dst_rank, tag, sid,
                           payload, step)
        if role == "cmp":
            if log:
                self.send_logs[src_rank].record(dst_rank, tag, payload,
                                                step, send_id=sid)
            # the log's tensors stay private: the delivery takes clones
            delivered = own_tensors(payload) if log else payload
            msg = LoggedMessage(sid, src_rank, dst_rank, tag, delivered,
                                step)
            dst_wid = self.rmap.cmp[dst_rank]
            self.deliver(self.endpoints[dst_wid], msg)
            if self.cost_model is not None:
                self._charge(sender.wid, dst_wid, nbytes, tag)
            # intercomm fill-in: destination replicated, source not — the
            # replica consumes the SAME frozen message through its own
            # cursor (CoW: nobody can write the shared payload); an
            # unfrozen payload gets its own isolated copy instead, and a
            # tensor payload its own clone
            if self.rmap.rep[dst_rank] is not None and \
                    self.rmap.rep[src_rank] is None:
                rep_wid = self.rmap.rep[dst_rank]
                if not frozen:
                    msg = copy.deepcopy(msg)  # repro: allow[deepcopy]
                else:
                    own = own_tensors(payload)
                    if own is not payload:
                        msg = LoggedMessage(sid, src_rank, dst_rank, tag,
                                            own, step)
                self.deliver(self.endpoints[rep_wid], msg)
                if self.cost_model is not None:
                    self._charge(sender.wid, rep_wid, nbytes, tag)
        else:  # replica sender
            if self.rmap.rep[dst_rank] is not None:
                msg = LoggedMessage(sid, src_rank, dst_rank, tag, payload,
                                    step)
                rep_wid = self.rmap.rep[dst_rank]
                self.deliver(self.endpoints[rep_wid], msg)
                if self.cost_model is not None:
                    self._charge(sender.wid, rep_wid, nbytes, tag)
            # else: skip (paper: no replica destination -> source replica
            # skips the send)

    # ------------------------------------------------------------- matching

    def match_recv(self, ep: Endpoint, src_rank: Optional[int],
                   tag: int) -> Optional[LoggedMessage]:
        """Find (and consume) the next matching inbox message; None if none.
        Wildcard receives on replicas follow the rank's cmp-chosen order."""
        role, rank = self.rmap.role_of(ep.wid)
        if src_rank is None and role == "rep":
            order = self.wc_order[rank]
            idx = ep.wc_consumed - self.wc_base[rank]
            if idx >= len(order):
                return None
            want_src, want_tag, _want_sid = order[idx]
            got = self._take(ep, want_src, want_tag)
            if got is None:
                return None
            ep.wc_consumed += 1
            ep.wc_matches.append((got.src, got.tag, got.send_id))
            return got
        got = self._take(ep, src_rank, tag)
        if got is None:
            return None
        if src_rank is None and role == "cmp":
            # record the chosen order and forward to the replica (paper §5);
            # the send-ID travels with the order entry, so the replica's
            # match — and any offline correlation (static analysis) — pins
            # the exact logged message, not just a (src, tag) stream
            self.wc_order[rank].append((got.src, got.tag, got.send_id))
            ep.wc_consumed += 1
            ep.wc_matches.append((got.src, got.tag, got.send_id))
            # the order entry may be the only thing a parked replica
            # twin was waiting on (its copy already arrived)
            if self.waker is not None:
                rep_wid = self.rmap.rep.get(rank)
                if rep_wid is not None:
                    self.waker(rep_wid)
        return got

    def _take(self, ep: Endpoint, src_rank: Optional[int],
              tag: int) -> Optional[LoggedMessage]:
        """Pop the next live match: the (src, tag) bucket head, or — for a
        wildcard — the earliest arrival of the tag across sources.  The
        duplicate skip is a loop (a replayed burst must not recurse).
        Consuming a cell nulls its message reference: the dead cell may
        linger in the sibling index until compaction, but never pins the
        payload."""
        if src_rank is None:
            q = ep.tag_index.get(tag)
        else:
            q = ep.buckets.get((src_rank, tag))
        if not q:
            return None
        while q:
            cell = q.popleft()
            if not cell[2]:
                continue                     # consumed via the other index
            cell[2] = False
            m = cell[0]
            cell[0] = None                   # release for the sibling index
            if not ep.cursor.should_deliver(m):
                self.duplicates_skipped += 1
                continue
            self.activity += 1
            return m
        return None

    def drain_tag(self, ep: Endpoint, tag: int) -> List[LoggedMessage]:
        """Consume EVERY live message with ``tag``, ordered by (src,
        arrival) — the order an explicit per-source match_recv scan would
        produce — with the same send-ID dedup.  O(messages), not
        O(sources): the checkpoint store pumps its reserved tags through this."""
        q = ep.tag_index.get(tag)
        if not q:
            return []
        cells = [c for c in q if c[2]]
        q.clear()
        cells.sort(key=lambda c: (c[0].src, c[1]))
        out = []
        srcs = set()
        for cell in cells:
            cell[2] = False
            m = cell[0]
            cell[0] = None
            srcs.add(m.src)
            if not ep.cursor.should_deliver(m):
                self.duplicates_skipped += 1
                continue
            self.activity += 1
            out.append(m)
        # a live cell only ever leaves an index by being consumed, so
        # after the flip above EVERY cell of this tag is dead — the
        # drained sources' buckets hold nothing else; drop them whole
        # (store tags are consumed exclusively through here, and without
        # this every push would pin a dead cell per message forever)
        for src in sorted(srcs):
            ep.buckets.pop((src, tag), None)
        return out

    # -------------------------------------------------------- op intake/resolve

    def post(self, ep: Endpoint, op: tuple, step: int) -> Optional[tuple]:
        """Intake a p2p op; returns a pending descriptor when blocked."""
        kind = op[0]
        role, _rank = self.rmap.role_of(ep.wid)
        log = role == "cmp"
        if kind == "send":
            _, dst, tag, payload = op
            self.send(ep, dst, tag, payload, step, log=log)
            return None
        if kind == "exchange":
            _, outmap, tag = op
            for dst, payload in sorted(outmap.items()):
                self.send(ep, dst, tag, payload, step, log=log)
            return ("exchange_wait", sorted(outmap.keys()), tag, {})
        if kind == "recv":
            _, src, tag = op
            return ("recv", src, tag)
        if kind == "recv_any":
            _, tag = op
            return ("recv_any", tag)
        raise ValueError(f"not a p2p op: {kind!r}")

    def owns_pending(self, pend: tuple) -> bool:
        return pend[0] in _P2P_PENDING

    def _recv_payload(self, m: LoggedMessage) -> Any:
        """The payload an app-level recv hands back: the shared frozen
        payload, or a private writeable copy under ``mutable_recv``.  A
        tensor payload is the receiver's own already and is handed back
        as it is."""
        if self.mutable_recv and not isinstance(m.payload, torch.Tensor):
            return structural_copy(m.payload, mutable=True)
        return m.payload

    def resolve(self, ep: Endpoint, pend: tuple):
        """Attempt to complete a p2p pending; NOTHING while blocked."""
        kind = pend[0]
        if kind == "recv":
            _, src, tag = pend
            m = self.match_recv(ep, src, tag)
            return self._recv_payload(m) if m is not None else NOTHING
        if kind == "recv_any":
            _, tag = pend
            m = self.match_recv(ep, None, tag)
            return (m.src, self._recv_payload(m)) if m is not None \
                else NOTHING
        if kind == "exchange_wait":
            _, srcs, tag, got = pend
            for s in srcs:
                if s not in got:
                    m = self.match_recv(ep, s, tag)
                    if m is not None:
                        got[s] = self._recv_payload(m)
            return got if len(got) == len(srcs) else NOTHING
        raise ValueError(f"not a p2p pending: {kind!r}")

    # ------------------------------------------------- checkpointable state

    def trim_wildcards(self, rank: int) -> None:
        """Checkpoint-boundary trim of the wildcard histories (the analogue
        of SenderLog.trim_before_step): drop wc_order entries every live
        endpoint of ``rank`` has consumed, and each endpoint's matching
        wc_matches prefix.  Cursor offsets (wc_base / wc_matches_base)
        keep the global consumed indexes intact, so replica replay and
        offline correlation line up across trims."""
        eps = [self.endpoints[w]
               for w in (self.rmap.cmp.get(rank), self.rmap.rep.get(rank))
               if w is not None and w in self.endpoints]
        if not eps:
            return
        keep = min(ep.wc_consumed for ep in eps)
        drop = keep - self.wc_base[rank]
        if drop > 0:
            del self.wc_order[rank][:drop]
            self.wc_base[rank] = keep
        for ep in eps:
            mdrop = keep - ep.wc_matches_base
            if mdrop > 0:
                del ep.wc_matches[:mdrop]
                ep.wc_matches_base = keep

    def snapshot_rank(self, rank: int, ep: Endpoint) -> dict:
        """The comm half of a rank-level checkpoint (paper §3.3): log,
        cursor, wildcard order, send counters — app state stays with the
        scheduler."""
        return {
            "cursor": ep.cursor.state(),
            "send_log": self.send_logs[rank].state(),
            "wc_order": list(self.wc_order[rank]),
            "wc_base": self.wc_base[rank],
            "wc_consumed": ep.wc_consumed,
            "wc_matches": list(ep.wc_matches),
            "wc_matches_base": ep.wc_matches_base,
            "send_counters": dict(ep.send_counters),
        }

    def load_rank(self, rank: int, ep: Endpoint, data: dict) -> None:
        ep.cursor.load_state(data["cursor"])
        ep.wc_consumed = data["wc_consumed"]
        ep.wc_matches = list(data.get("wc_matches", ()))
        ep.wc_matches_base = data.get("wc_matches_base", 0)
        ep.send_counters = dict(data["send_counters"])
        self.send_logs[rank].load_state(data["send_log"])
        self.wc_order[rank] = list(data["wc_order"])
        self.wc_base[rank] = data.get("wc_base", 0)
