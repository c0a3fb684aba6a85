"""Sender-based message logging with piggybacked send-IDs (paper §6.3).

Every send is recorded on the sender with a monotonically increasing send-ID
per (src, dst, tag) stream. Receivers track the last delivered send-ID per
stream, so after a failure:

  * messages a dead worker had SENT but the promoted replica never received
    are *replayed* from the surviving senders' logs;
  * messages the promoted replica already received (as a replica it may be
    AHEAD of its dead computational twin) are *skipped* by send-ID —
    exactly-once delivery, the paper's §6.3 example.

Logs are trimmed at checkpoint boundaries or when exceeding a memory limit
("log removal" in the paper's Fig 9 time budget).

A copy of ``repro/core/message_log.py`` for the PyTorch port: a tensor
payload is priced at ``numel() * element_size()``, which equals
``ndarray.nbytes`` for the same data, so priced times and the log's eviction
cap are the same for tensors as for arrays.
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

Stream = Tuple[int, int, int]           # (src_rank, dst_rank, tag)


def payload_nbytes(payload) -> int:
    """Approximate wire size of a message payload.  Containers are summed
    recursively (the tree/ring collective schedules wrap arrays in tuples
    and dicts — counting those as a constant would let the sender-log
    eviction cap miss almost all of their memory); a tensor counts its
    elements' bytes, as an ndarray does; opaque objects fall back to their
    pickled length."""
    if payload is None:
        return 0
    if isinstance(payload, np.ndarray):
        return payload.nbytes
    if isinstance(payload, torch.Tensor):
        return payload.numel() * payload.element_size()
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return len(payload)
    if isinstance(payload, str):
        return len(payload.encode())
    if isinstance(payload, (bool, int, float, complex, np.generic)):
        return 8
    if isinstance(payload, (list, tuple, set, frozenset)):
        return sum(payload_nbytes(x) for x in payload)
    if isinstance(payload, dict):
        return sum(payload_nbytes(k) + payload_nbytes(v)
                   for k, v in payload.items())
    return len(pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL))


@dataclass
class LoggedMessage:
    send_id: int
    src: int
    dst: int
    tag: int
    payload: Any
    step: int                            # application step when sent

    def nbytes(self) -> int:
        return payload_nbytes(self.payload)


class SenderLog:
    """Per-worker sender-side log (lives with the computational process and
    is part of the replication payload, as in the paper §3.2)."""

    def __init__(self, rank: int, limit_bytes: int = 1 << 28):
        self.rank = rank
        self.limit_bytes = limit_bytes
        self.next_send_id: Dict[Stream, int] = {}
        self.log: List[LoggedMessage] = []
        self.bytes = 0
        self.removal_events = 0
        # monotone totals over the log's whole life: unlike ``bytes`` /
        # ``len(log)`` they never shrink on trims, so observability can
        # reconcile them against the transport's per-band send counters
        self.recorded_msgs = 0
        self.recorded_bytes = 0

    def record(self, dst: int, tag: int, payload: Any, step: int,
               send_id: Optional[int] = None) -> int:
        stream = (self.rank, dst, tag)
        sid = self.next_send_id.get(stream, 0) if send_id is None else send_id
        self.next_send_id[stream] = sid + 1
        msg = LoggedMessage(sid, self.rank, dst, tag, payload, step)
        self.log.append(msg)
        nbytes = msg.nbytes()
        self.bytes += nbytes
        self.recorded_msgs += 1
        self.recorded_bytes += nbytes
        if self.bytes > self.limit_bytes:
            self._trim_half()
        return sid

    def _trim_half(self):
        """Drop the oldest half (paper: clean logs over a memory limit)."""
        keep_from = len(self.log) // 2
        for m in self.log[:keep_from]:
            self.bytes -= m.nbytes()
        self.log = self.log[keep_from:]
        self.removal_events += 1

    def trim_before_step(self, step: int):
        """Checkpoint boundary: messages older than the checkpoint can never
        need replay."""
        kept = [m for m in self.log if m.step >= step]
        self.bytes = sum(m.nbytes() for m in kept)
        self.log = kept

    def replay_for(self, dst: int, after: Dict[Stream, int]) -> List[LoggedMessage]:
        """Messages to re-send to ``dst``: send-IDs the receiver has not seen."""
        out = []
        for m in self.log:
            if m.dst != dst:
                continue
            stream = (m.src, m.dst, m.tag)
            if m.send_id >= after.get(stream, 0):
                out.append(m)
        return sorted(out, key=lambda m: m.send_id)

    def state(self) -> dict:
        """Serializable state — included in checkpoints & replication copies."""
        return {"next_send_id": dict(self.next_send_id),
                "log": list(self.log), "bytes": self.bytes}

    def load_state(self, st: dict):
        self.next_send_id = dict(st["next_send_id"])
        self.log = list(st["log"])
        self.bytes = st["bytes"]


class ReceiverCursor:
    """Receiver-side dedup: next expected send-ID per stream."""

    def __init__(self, rank: int):
        self.rank = rank
        self.expected: Dict[Stream, int] = {}
        self.skipped = 0

    def should_deliver(self, msg: LoggedMessage) -> bool:
        stream = (msg.src, msg.dst, msg.tag)
        exp = self.expected.get(stream, 0)
        if msg.send_id < exp:
            self.skipped += 1
            return False                     # duplicate — skip (paper §6.3)
        if msg.send_id > exp:
            raise RuntimeError(
                f"gap in stream {stream}: expected {exp} got {msg.send_id}")
        self.expected[stream] = exp + 1
        return True

    def state(self) -> dict:
        return {"expected": dict(self.expected)}

    def load_state(self, st: dict):
        self.expected = dict(st["expected"])
