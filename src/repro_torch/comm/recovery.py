"""Failure-time message recovery (paper §6.3).

When a computational worker dies and its replica is promoted, the promoted
worker's view of the network is repaired in two moves:

  * drain: in-flight messages of the current step are considered lost to
    the network during the repair window and dropped from the inbox;
  * replay: every surviving sender's log is scanned for messages addressed
    to the promoted rank whose send-IDs the promoted worker's receive
    cursor has not yet seen, and those are re-delivered.  Messages the
    replica already consumed (it may be AHEAD of its dead twin) arrive as
    duplicates and are skipped by the transport's send-ID dedup —
    exactly-once delivery, the paper's §6.3 example.

The manager only touches transport state; scheduling policy (when to
drain, which workers were promoted) stays with the runtime.

The PyTorch port's copy of ``repro/comm/recovery.py``.  A replayed
message carries a clone of each tensor of the logged one, as every
delivery does, so the log stays the sender's own.
"""
from __future__ import annotations

from repro_torch.comm.payload import own_tensors
from repro_torch.comm.transport import Endpoint, ReplicaTransport
from repro_torch.core.message_log import LoggedMessage, payload_nbytes


class RecoveryManager:
    """``store`` optionally attaches a ``store.MemStore``: worker deaths
    reported through ``note_dead`` then also kill that worker's in-memory
    shard copies (partner memory dies with its host process).

    ``price_replay=True`` accrues each replayed message's α‑β cost on the
    surviving sender through the transport's cost model (no-op without
    one) — the caller then books ``transport.take_comm_time()`` as the
    measured per-message repair instead of a flat estimate."""

    def __init__(self, transport: ReplicaTransport, store=None,
                 price_replay: bool = False):
        self.transport = transport
        self.store = store
        self.price_replay = price_replay
        self.replays = 0

    def note_dead(self, workers) -> None:
        """Record worker deaths with the attached store (no-op without
        one); the transport's endpoints are dropped by the scheduler."""
        if self.store is not None:
            for w in workers:
                self.store.lose_worker(w)

    def drain_current_step(self, ep: Endpoint, step: int) -> None:
        """Drop in-flight messages of the current step (network loss during
        the repair window); older messages were already stable."""
        ep.replace_messages(
            [m for m in ep.live_messages() if m.step < step])

    def replay_to(self, ep: Endpoint) -> int:
        """Re-deliver logged messages this endpoint has not consumed.
        Returns the number of replayed messages."""
        t = self.transport
        _role, rank = t.role_of(ep)
        have = {(m.src, m.dst, m.tag, m.send_id)
                for m in ep.live_messages()}
        to_replay = []
        for _src_rank, log in t.send_logs.items():
            for m in log.replay_for(rank, ep.cursor.expected):
                key = (m.src, m.dst, m.tag, m.send_id)
                if key in have:
                    continue
                # a frozen payload is immutable and redelivered as-is; a
                # tensor payload is delivered as a clone of the log's
                own = own_tensors(m.payload)
                if own is not m.payload:
                    m = LoggedMessage(m.send_id, m.src, m.dst, m.tag, own,
                                      m.step)
                to_replay.append(m)
        # one bulk admit for the whole replay burst
        t.deliver_bulk(ep, to_replay)
        if self.price_replay and t.cost_model is not None:
            for m in to_replay:
                src_wid = t.rmap.cmp.get(m.src)
                if src_wid is not None:
                    t._charge(src_wid, ep.wid,
                              payload_nbytes(m.payload), m.tag)
        n_replayed = len(to_replay)
        self.replays += n_replayed
        return n_replayed

    def repair_promoted(self, ep: Endpoint, step: int,
                        drop_inflight: bool = True) -> int:
        """The full promoted-worker repair: drain, then replay."""
        if drop_inflight:
            self.drain_current_step(ep, step)
        return self.replay_to(ep)
