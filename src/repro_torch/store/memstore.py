"""MemStore: banded in-memory checkpoint shards in partner process memory
(a copy of ``repro/store/memstore.py``).

Data path (all of it over ``comm.ReplicaTransport``, on reserved
negative tags, so pushes inherit the paper's parallel cmp/rep routing,
intercomm fill-in and send-ID dedup):

  * ``begin_save``: each owner rank pickles its payload, splits the bytes
    into ``n_bands`` shards, retains the shard set in its OWN workers'
    memory (a local memcpy — ReStore keeps the checkpoint at the owner and
    redundantly at partners, so a coordinated rollback does not need the
    network for surviving ranks), and pushes the whole band set to each of
    its k placement partners in ONE batched message per partner (the
    per-band CRCs ride inside the payload; the α‑priced transport makes
    per-band messages pure latency waste) — from its computational
    endpoint AND its replica endpoint, so both copies of a partner end up
    holding the shards and a later promotion loses nothing;
  * ``pump``: partner workers consume the pushes into their per-worker
    stores and ack each complete (owner, generation) shard set back to the
    owner;
  * ``try_commit``: a generation is durable only once ALL partners of ALL
    ranks have acked — the ranks then agree on the manifest with an
    ``allgather`` — at which point the previous generation is dropped.
    Until then the previous generation is retained: a crash mid-commit
    (lost pushes, missing acks, dead partners) abandons the new generation
    and recovery restores the previous one bitwise-identically.  This is
    the two-generation, double-buffered mirror of ``checkpoint/io.py``'s
    tmp + rename guarantee.

``save`` bundles the three phases; tests drive them separately to land
kills mid-commit.  Restores pull shards back from surviving partners
(``store.recovery``).

Bands are frozen (read-only) host numpy arrays, as in the reference: the
checkpoint lives in the partners' process memory, which is host memory.
They never become tensors: the transport shares a frozen ndarray among the
owner's retained copy and every partner's, where it would clone a tensor
for each delivery.  Payloads are whatever the caller pickles; the session's
backend (``store.backend.MemBackend``) hands the store host bytes, never a
torch tensor.
"""
from __future__ import annotations

import pickle
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.comm import ReferenceCollectives
from repro_torch.store.placement import PartnerPlacement

# reserved tag space (collectives use -11..-16; apps use tags >= 0)
TAG_PUSH = -21
TAG_ACK = -22
TAG_FETCH = -23
TAG_FETCH_REPLY = -24

STORE_TAGS = frozenset({TAG_PUSH, TAG_ACK, TAG_FETCH, TAG_FETCH_REPLY})


class _ShardSet:
    """One (owner, generation) entry in a worker's store."""

    __slots__ = ("step", "n_bands", "nbytes", "crcs", "bands")

    def __init__(self, step: int, n_bands: int, nbytes: int, crcs):
        self.step = step
        self.n_bands = n_bands
        self.nbytes = nbytes
        self.crcs = tuple(crcs)
        self.bands: Dict[int, np.ndarray] = {}

    def add(self, band: int, data: np.ndarray) -> None:
        self.bands[band] = data

    def complete(self) -> bool:
        if len(self.bands) != self.n_bands:
            return False
        # crc32 reads the array buffer directly — no tobytes() copy
        return all(zlib.crc32(self.bands[b]) == self.crcs[b]
                   for b in range(self.n_bands))

    def blob(self) -> np.ndarray:
        """The reassembled byte stream as a uint8 view/concatenation
        (``len`` and slicing behave like bytes; decode with
        ``MemStore._decode``)."""
        if self.n_bands == 1:
            return self.bands[0]
        return np.concatenate([self.bands[b] for b in range(self.n_bands)])


class MemStore:
    """Replicated in-memory checkpoint store over a ReplicaTransport."""

    def __init__(self, transport, topology, *, k_partners: int = 2,
                 n_bands: int = 4, graph=None):
        self.transport = transport
        self.topology = topology
        self.k = k_partners
        self.n_bands = n_bands
        self.graph = graph            # topo graph: wider failure domains
        self.placement = PartnerPlacement(transport.rmap, topology,
                                          k_partners, graph=graph)
        # per-worker shard memory: worker id -> {(owner, gen): _ShardSet}
        self.stores: Dict[int, Dict[Tuple[int, int], _ShardSet]] = {}
        # generation metadata (shared bookkeeping standing in for what every
        # rank tracks about its own pushes)
        self.gens: Dict[int, dict] = {}
        self.committed: Optional[int] = None
        self.next_gen = 1
        # observability
        self.last_save_bytes = 0        # sum of per-rank payload bytes
        self.committed_bytes = 0
        self.pushes = 0
        self.acks = 0
        self.fetches = 0
        self.local_reads = 0
        self.direct_salvages = 0
        # generation lifecycle counters (observability): committed = made
        # durable by try_commit; abandoned = pruned before completing (a
        # partner died mid-round and a newer generation committed past it)
        self.gens_committed = 0
        self.gens_abandoned = 0

    # ------------------------------------------------------------- lifecycle

    def rebind(self, topology=None, transport=None) -> None:
        """Adopt a rebuilt world (elastic restart).  Worker shard memory
        survives in the workers that survived; placement is recomputed for
        the new replica map."""
        if transport is not None:
            self.transport = transport
        if topology is not None:
            self.topology = topology
        self.placement = PartnerPlacement(self.transport.rmap, self.topology,
                                          self.k, graph=self.graph)

    def lose_worker(self, worker: int) -> None:
        """The worker's memory is gone: its shard copies with it."""
        self.stores.pop(worker, None)
        self.transport.drop(worker)

    # -------------------------------------------------------------- plumbing

    def _rank_endpoints(self, rank: int) -> List[Any]:
        """Live endpoints of a rank: computational first, then replica."""
        rmap = self.transport.rmap
        out = []
        for w in (rmap.cmp.get(rank), rmap.rep.get(rank)):
            if w is not None and w in self.transport.endpoints:
                out.append(self.transport.endpoints[w])
        return out

    def _rank_reachable(self, rank: int) -> bool:
        rmap = self.transport.rmap
        return rmap.cmp.get(rank) in self.transport.endpoints

    def _send(self, ep, dst_rank: int, tag: int, payload, step: int) -> None:
        self.transport.send(ep, dst_rank, tag, payload, step, log=False)

    def _drain(self, ep, tag: int):
        """Consume every message with ``tag`` from ``ep`` in (src, arrival)
        order — the transport's indexed drain (the store never uses
        wildcard receives, which would disturb the transport's
        MPI_ANY_SOURCE forwarding order)."""
        return self.transport.drain_tag(ep, tag)

    @staticmethod
    def _chunk(blob: bytes, n_bands: int) -> List[np.ndarray]:
        arr = np.frombuffer(blob, dtype=np.uint8)
        return [c.copy() for c in np.array_split(arr, n_bands)]

    # -------------------------------------------------- banded serialization

    def _encode(self, payload) -> Tuple[List[np.ndarray], int]:
        """Serialize ``payload`` and band the byte stream in ONE copy.

        Pickle protocol 5 hands every contiguous array buffer out-of-band
        (``buffer_callback``), so large numpy state is never run through
        the pickle stream itself; the parts are framed with a length
        header and copied directly into ``n_bands`` read-only uint8 band
        arrays (boundaries match ``np.array_split``).  The bands are
        shared — owner-local retention and every partner push reference
        the same frozen arrays, replacing the per-worker chunk copies of
        the tobytes() era."""
        bufs: List[pickle.PickleBuffer] = []
        blob = pickle.dumps(payload, protocol=5, buffer_callback=bufs.append)
        parts = [memoryview(blob)]
        for b in bufs:
            mv = memoryview(b)
            if not mv.contiguous:
                mv = memoryview(bytes(mv))
            parts.append(mv.cast("B"))
        header = struct.pack("<I", len(parts)) + b"".join(
            struct.pack("<Q", p.nbytes) for p in parts)
        parts.insert(0, memoryview(header))
        total = sum(p.nbytes for p in parts)
        base, extra = divmod(total, self.n_bands)
        bands = []
        it = iter(parts)
        cur = next(it)
        off = 0
        for b in range(self.n_bands):
            size = base + 1 if b < extra else base
            band = np.empty(size, dtype=np.uint8)
            filled = 0
            while filled < size:
                take = min(size - filled, cur.nbytes - off)
                if take:
                    band[filled:filled + take] = np.frombuffer(
                        cur, dtype=np.uint8, count=take, offset=off)
                    filled += take
                    off += take
                if off == cur.nbytes and filled < size:
                    cur = next(it)
                    off = 0
            band.flags.writeable = False
            bands.append(band)
        return bands, total

    @staticmethod
    def _decode(data):
        """Inverse of ``_encode``: parse the length header and unpickle
        with the out-of-band buffers as views into the (writeable) byte
        stream — restored arrays alias it instead of being copied out."""
        if isinstance(data, (bytes, bytearray)):
            # np.frombuffer over bytes would yield read-only views;
            # restored states must be writeable
            arr = np.frombuffer(bytearray(data), dtype=np.uint8)
        else:
            arr = np.ascontiguousarray(data)
            if not arr.flags.writeable:
                arr = arr.copy()
        mv = memoryview(arr)
        (nparts,) = struct.unpack_from("<I", mv, 0)
        lengths = struct.unpack_from(f"<{nparts}Q", mv, 4)
        pos = 4 + 8 * nparts
        blob = mv[pos:pos + lengths[0]]
        pos += lengths[0]
        bufs = []
        for length in lengths[1:]:
            bufs.append(mv[pos:pos + length])
            pos += length
        return pickle.loads(blob, buffers=bufs)

    # ----------------------------------------------------------------- write

    def begin_save(self, step: int, states: Dict[int, Any]) -> int:
        """Phase 1: push every rank's banded shards to its partners."""
        gen = self.next_gen
        self.next_gen += 1
        owners: Dict[int, dict] = {}
        total = 0
        for r in sorted(states):
            bands, nbytes = self._encode(states[r])
            crcs = tuple(zlib.crc32(b) for b in bands)
            partners = self.placement.partners_of(r)
            # a partner that is fully dead right now can never ack; it is
            # excluded from this generation's durability condition (the
            # next elastic restart re-levels the placement)
            expected = tuple(p for p in partners if self._rank_reachable(p))
            owners[r] = {"partners": partners, "expected": expected,
                         "nbytes": nbytes, "crcs": crcs}
            total += nbytes
            # owner-local retention: surviving ranks roll back from their
            # own memory, only dead ranks pull from partners — the bands
            # are read-only and shared, not copied per worker
            rmap = self.transport.rmap
            for w in (rmap.cmp.get(r), rmap.rep.get(r)):
                if w is None or w not in self.transport.endpoints:
                    continue
                ss = _ShardSet(step, self.n_bands, nbytes, crcs)
                for b, band in enumerate(bands):
                    ss.add(b, band)
                self.stores.setdefault(w, {})[(r, gen)] = ss
            for ep in self._rank_endpoints(r):
                for p in expected:
                    # all bands for one partner ride in ONE message (the
                    # transport prices per-message α, so fragmenting a
                    # push into n_bands messages would pay n_bands hops
                    # of latency for no durability gain); the per-band
                    # CRCs travel inside the batched payload
                    self._send(ep, p, TAG_PUSH,
                               ("push", r, gen, step, nbytes, crcs,
                                bands), step)
                    self.pushes += 1
        self.last_save_bytes = total
        self.gens[gen] = {"step": step, "owners": owners,
                          "acks": set(), "complete": False}
        return gen

    def pump(self, partner_workers=None) -> int:
        """Phase 2: partner workers consume pushes and ack complete shard
        sets; owners consume acks.  ``partner_workers`` restricts which
        workers process their inboxes (tests use it to land kills
        mid-commit).  Returns the number of acks recorded."""
        rmap = self.transport.rmap
        # partner intake
        for w, ep in list(self.transport.endpoints.items()):
            if partner_workers is not None and w not in partner_workers:
                continue
            role, my_rank = rmap.role_of(ep.wid)
            if role == "dead":
                continue
            ws = self.stores.setdefault(w, {})
            for m in self._drain(ep, TAG_PUSH):
                _, r, gen, step, nbytes, crcs, chunks = m.payload
                key = (r, gen)
                ss = ws.get(key)
                if ss is None:
                    ss = ws[key] = _ShardSet(step, len(chunks), nbytes, crcs)
                for b, chunk in enumerate(chunks):
                    ss.add(b, chunk)
                if ss.complete() and self._rank_reachable(r):
                    self._send(ep, r, TAG_ACK, ("ack", r, gen, my_rank), step)
        # owner ack intake (both role endpoints; acks are per partner rank)
        recorded = 0
        for r in range(rmap.n):
            for ep in self._rank_endpoints(r):
                for m in self._drain(ep, TAG_ACK):
                    _, owner, gen, partner_rank = m.payload
                    meta = self.gens.get(gen)
                    if meta is None:
                        continue
                    if (owner, partner_rank) not in meta["acks"]:
                        meta["acks"].add((owner, partner_rank))
                        recorded += 1
                        self.acks += 1
        return recorded

    def try_commit(self, gen: int) -> bool:
        """Phase 3: durable once all partners acked.  Ranks agree on the
        manifest with an allgather; the previous generation is dropped only
        now (and retained on any failure)."""
        meta = self.gens.get(gen)
        if meta is None or meta["complete"]:
            return meta is not None and meta["complete"]
        need = {(r, p) for r, info in meta["owners"].items()
                for p in info["expected"]}
        if not need <= meta["acks"]:
            return False
        # manifest exchange: every rank allgathers its (gen, step, nbytes)
        # entry; the agreed manifest is what recovery later validates
        # pulled blobs against (in this collapsed world the votes come
        # from one table, so the exchange distributes knowledge rather
        # than detecting divergence)
        ranks = sorted(meta["owners"])
        coll = ReferenceCollectives(len(ranks))
        pend = {i: coll.post(i, ("allgather",
                                 (gen, meta["step"],
                                  meta["owners"][r]["nbytes"])))
                for i, r in enumerate(ranks)}
        meta["manifest"] = coll.resolve(0, pend[0])
        meta["complete"] = True
        self.committed = gen
        self.gens_committed += 1
        self.committed_bytes = sum(info["nbytes"]
                                   for info in meta["owners"].values())
        # prune: older generations (including abandoned ones) are dead now
        for ws in self.stores.values():
            for key in [k for k in ws if k[1] < gen]:
                del ws[key]
        for g in [g for g in self.gens if g < gen]:
            if not self.gens[g]["complete"]:
                self.gens_abandoned += 1
            del self.gens[g]
        return True

    def save(self, step: int, states: Dict[int, Any]) -> int:
        """Push + pump + commit in one synchronous round.  When a partner
        died mid-round the generation stays incomplete and the previous
        one remains the durable restore point."""
        gen = self.begin_save(step, states)
        self.pump()
        self.try_commit(gen)
        return gen

    # ------------------------------------------------------------------ read

    def durable(self) -> Optional[Tuple[int, int]]:
        """(generation, step) of the newest committed generation."""
        if self.committed is None:
            return None
        return self.committed, self.gens[self.committed]["step"]

    def recoverable_without(self, dead_workers,
                            gen: Optional[int] = None) -> bool:
        """Would the durable generation survive losing ``dead_workers`` on
        top of the deaths already recorded?  (Recovery planners ask this
        BEFORE the deaths are applied to the store.)"""
        gen = self.committed if gen is None else gen
        meta = self.gens.get(gen) if gen is not None else None
        if meta is None or not meta["complete"]:
            return False
        dead = set(dead_workers)
        for rank in meta["owners"]:
            if not any((rank, gen) in ws and ws[(rank, gen)].complete()
                       for w, ws in self.stores.items() if w not in dead):
                return False
        return True

    def restore(self, gen: Optional[int] = None):
        """Pull every rank's payload back from surviving partner shards.
        Returns ({rank: payload}, step); raises StoreUnrecoverable."""
        from repro_torch.store.recovery import StoreRecovery
        return StoreRecovery(self).pull(gen)
