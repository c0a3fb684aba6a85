"""Runtime replica-divergence detector (the simulator analogue of SDC; the
port of ``repro/analyze/divergence.py``).

The replication scheme is only as strong as the determinism contract: a
replica that silently computes different bytes than its computational
partner will pass every liveness check and then corrupt the result the
moment it is promoted.  In the real library that is silent data
corruption; in the simulator it shows up — far downstream — as a bitwise
test failure with no pointer back to the first bad message.

``DivergenceDetector`` hooks :class:`ReplicaTransport` as its send
observer.  Every logical send is observed **before** role routing (so a
replica-side *skipped* send is still observed), keyed by the protocol's
own identity for a message occurrence: ``(src_rank, dst_rank, tag,
send_id)``.  The cmp and rep executions of a rank perform identical send
sequences, so each key is seen at most once per role; the detector CRCs
the payload (canonically: dtype/shape + bytes for arrays, structure-aware
recursion for containers) and compares the pair the moment both sides
have reported.  The first mismatch is the **first divergence** — the
located root cause — reported as a :class:`DivergenceRecord` and,
optionally, raised as :class:`ReplicaDivergence` to stop the run at the
exact send.

A torch tensor (on the CPU or the card) is canonicalised as the reference
canonicalises an ndarray: numpy's dtype string, the shape and the C-order
bytes, copied to the host — so the CRC of a tensor equals the reference's
CRC of an ndarray with the same values, and a tensor never reaches the
pickle fallback.  On the card every observed payload is copied to the
host; the detector is off by default (``SimRuntime(detect_divergence=
False)``).
"""
from __future__ import annotations

import pickle
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analyze.findings import ERROR, Finding


def _tensor_header_and_bytes(t: torch.Tensor):
    """(dtype string, C-order host bytes) of a tensor: numpy's dtype
    string where numpy has the dtype, else torch's name (bf16's bits)."""
    host = t.detach().to("cpu", memory_format=torch.contiguous_format)
    if t.dtype == torch.bfloat16:
        return "bfloat16", host.view(torch.int16).numpy().tobytes()
    arr = host.numpy()
    return arr.dtype.str, arr.tobytes()


def payload_crc(payload: Any, _crc: int = 0) -> int:
    """Canonical CRC32 of a message payload.

    Arrays and tensors hash as (dtype, shape, bytes); containers recurse
    with type-distinguishing prefixes (so ``[1]`` != ``(1,)`` != ``{1}``);
    dict entries are visited in sorted-key order.  Anything unrecognized
    falls back to its pickle — stable within a run, which is all a
    cmp-vs-rep comparison needs."""
    crc = _crc
    if payload is None:
        return zlib.crc32(b"N", crc)
    if isinstance(payload, np.ndarray):
        arr = np.ascontiguousarray(payload)
        crc = zlib.crc32(f"A{arr.dtype.str}{arr.shape}".encode(), crc)
        return zlib.crc32(arr.tobytes(), crc)
    if isinstance(payload, torch.Tensor):
        dtype, data = _tensor_header_and_bytes(payload)
        crc = zlib.crc32(f"A{dtype}{tuple(payload.shape)}".encode(), crc)
        return zlib.crc32(data, crc)
    if isinstance(payload, np.generic):
        crc = zlib.crc32(f"G{payload.dtype.str}".encode(), crc)
        return zlib.crc32(payload.tobytes(), crc)
    if isinstance(payload, (bool, int, float, complex, str, bytes)):
        return zlib.crc32(f"S{type(payload).__name__}:{payload!r}"
                          .encode(), crc)
    if isinstance(payload, (list, tuple)):
        crc = zlib.crc32(b"L" if isinstance(payload, list) else b"T", crc)
        for item in payload:
            crc = payload_crc(item, crc)
        return crc
    if isinstance(payload, dict):
        crc = zlib.crc32(b"D", crc)
        for key in sorted(payload, key=repr):
            crc = payload_crc(key, crc)
            crc = payload_crc(payload[key], crc)
        return crc
    return zlib.crc32(pickle.dumps(payload, protocol=4), crc)


@dataclass(frozen=True)
class DivergenceRecord:
    """One cmp/rep payload mismatch, located by the protocol's message
    identity."""

    src: int
    dst: int
    tag: int
    send_id: int
    step: int
    cmp_crc: int
    rep_crc: int

    def describe(self) -> str:
        return (f"replica divergence at send (src={self.src}, "
                f"dst={self.dst}, tag={self.tag}, send_id={self.send_id},"
                f" step={self.step}): cmp crc {self.cmp_crc:#010x} != "
                f"rep crc {self.rep_crc:#010x}")


class ReplicaDivergence(RuntimeError):
    """Raised (when the detector is armed to raise) at the FIRST
    divergent send — the simulator's located SDC alarm."""

    def __init__(self, record: DivergenceRecord):
        super().__init__(record.describe())
        self.record = record


class DivergenceDetector:
    """Observer comparing cmp vs rep payload CRCs per send occurrence.

    Usage::

        det = DivergenceDetector(raise_on_divergence=True)
        det.attach(transport)          # joins transport.observers (first)
        ... run ...
        det.first                      # None, or the first DivergenceRecord

    Unpaired entries (sends by unreplicated ranks, or sends whose partner
    has not executed yet) cost one int each and are dropped as soon as
    the pair completes.  ``reset()`` clears in-flight state — call it
    whenever execution rewinds (checkpoint restore) so pre-rollback cmp
    sends are not paired against post-rollback rep re-sends.
    """

    def __init__(self, raise_on_divergence: bool = False):
        self.raise_on_divergence = raise_on_divergence
        self.transport = None
        # (src, dst, tag, send_id) -> (role, crc, step) awaiting its pair
        self._pending: Dict[Tuple[int, int, int, int],
                            Tuple[str, int, int]] = {}
        self.divergences: List[DivergenceRecord] = []
        self.compared = 0            # completed cmp/rep pairs

    # -- lifecycle -----------------------------------------------------------

    def attach(self, transport) -> "DivergenceDetector":
        self.transport = transport
        # first=True: the detector must see every send before other
        # observers (metrics recorders) account it, so a raised
        # divergence stops the run before its traffic is booked
        transport.add_observer(self, first=True)
        return self

    def detach(self) -> None:
        if self.transport is not None:
            self.transport.remove_observer(self)
        self.transport = None

    def reset(self) -> None:
        self._pending.clear()

    # -- observer hook -------------------------------------------------------

    def on_send(self, role: str, src: int, dst: int, tag: int,
                send_id: int, payload: Any, step: int) -> None:
        key = (src, dst, tag, send_id)
        crc = payload_crc(payload)
        other = self._pending.pop(key, None)
        if other is None:
            self._pending[key] = (role, crc, step)
            return
        other_role, other_crc, other_step = other
        if other_role == role:
            # same role twice: a replay or re-registration raced a reset —
            # treat the newest occurrence as the open half
            self._pending[key] = (role, crc, step)
            return
        self.compared += 1
        if crc == other_crc:
            return
        cmp_crc, rep_crc = (other_crc, crc) if other_role == "cmp" \
            else (crc, other_crc)
        rec = DivergenceRecord(src, dst, tag, send_id,
                               min(step, other_step), cmp_crc, rep_crc)
        self.divergences.append(rec)
        if self.raise_on_divergence:
            raise ReplicaDivergence(rec)

    # -- reporting -----------------------------------------------------------

    @property
    def first(self) -> Optional[DivergenceRecord]:
        return self.divergences[0] if self.divergences else None

    def findings(self, label: str = "run") -> List[Finding]:
        return [Finding("replica-divergence",
                        f"{label} rank {rec.src}", rec.send_id + 1,
                        rec.describe(),
                        "bisect the rank's step function for the "
                        "nondeterminism (wall clock, unseeded RNG, set "
                        "order) feeding this payload",
                        ERROR)
                for rec in self.divergences]
