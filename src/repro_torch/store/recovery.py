"""Pull-side of the in-memory store: rebuild state from partner shards (a
copy of ``repro/store/recovery.py``).

After a pair death the restarted world pulls every rank's payload back
from the workers that held its shards:

  * each rank's (re-spawned) endpoints send a fetch to every placement
    partner over the transport;
  * a holder that has the complete (owner, generation) shard set replies
    band-by-band from its own endpoint — so replies follow the same
    parallel cmp/rep routing as the pushes did;
  * the requester merges bands from both of its role endpoints, verifies
    the CRCs and byte count, and unpickles.

When the message protocol cannot reach a surviving copy (e.g. the only
holder is a replica worker of a rank whose requester lost its replica —
the real library would cross the intercomm here), the recovery falls back
to reading the surviving worker store directly (``direct_salvages``
counts these).  If no complete copy survives anywhere the generation is
unrecoverable and ``StoreUnrecoverable`` is raised — by construction this
needs more than k failure-domain deaths since the last commit.

``plan_recovery`` (core.shrink) consults the store when planning a
restart so the plan carries the memory backend's network-bound restore
cost instead of the disk one; ``RecoveryManager`` (comm.recovery)
forwards worker deaths into the store so shard memory dies with its host.
"""
from __future__ import annotations

import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.store.memstore import TAG_FETCH, TAG_FETCH_REPLY, MemStore


class StoreUnrecoverable(RuntimeError):
    """No surviving complete copy of some rank's shards."""

    def __init__(self, rank: int, gen: Optional[int]):
        super().__init__(
            f"rank {rank}: no surviving complete shard copy for "
            f"generation {gen} (more failure domains lost than the "
            f"placement tolerates)")
        self.rank = rank
        self.gen = gen


class StoreRecovery:
    def __init__(self, store: MemStore):
        self.store = store

    # -- message protocol ----------------------------------------------------

    def _local_rank(self, rank: int, gen: int):
        """Owner-local retained copy: surviving ranks roll back from their
        own memory without touching the network."""
        store = self.store
        rmap = store.transport.rmap
        for w in (rmap.cmp.get(rank), rmap.rep.get(rank)):
            ss = store.stores.get(w, {}).get((rank, gen)) \
                if w is not None else None
            if ss is not None and ss.complete():
                store.local_reads += 1
                return ss.blob()
        return None

    def _fetch_rank(self, rank: int, gen: int, info: dict):
        """Fetch + reply + merge for one rank; None when incomplete."""
        store = self.store
        t = store.transport
        rmap = t.rmap
        reqs = store._rank_endpoints(rank)
        if not reqs:
            return None
        step = store.gens[gen]["step"]
        for ep in reqs:
            for p in info["partners"]:
                if store._rank_reachable(p):
                    store._send(ep, p, TAG_FETCH, ("fetch", rank, gen), step)
                    store.fetches += 1
        # holder side: answer fetches from complete shard sets
        for w, ep in list(t.endpoints.items()):
            ws = store.stores.get(w)
            if not ws:
                store._drain(ep, TAG_FETCH)
                continue
            for m in store._drain(ep, TAG_FETCH):
                _, owner, g = m.payload
                ss = ws.get((owner, g))
                if ss is None or not ss.complete():
                    continue
                for b in range(ss.n_bands):
                    store._send(ep, owner, TAG_FETCH_REPLY,
                                ("band", owner, g, b, ss.bands[b]), step)
        # requester side: merge bands from both role endpoints, accepting
        # only chunks whose CRC matches the generation manifest
        bands: Dict[int, np.ndarray] = {}
        for ep in reqs:
            for m in store._drain(ep, TAG_FETCH_REPLY):
                _, owner, g, b, chunk = m.payload
                if owner == rank and g == gen and b not in bands and \
                        zlib.crc32(chunk) == info["crcs"][b]:
                    bands[b] = chunk
        if len(bands) < store.n_bands:
            return None
        return np.concatenate([bands[b] for b in range(store.n_bands)])

    def _salvage_rank(self, rank: int, gen: int, *, count: bool = True):
        """Direct read of any surviving complete copy (intercomm stand-in)."""
        for ws in self.store.stores.values():
            ss = ws.get((rank, gen))
            if ss is not None and ss.complete():
                if count:
                    self.store.direct_salvages += 1
                return ss.blob()
        return None

    # -- entry points --------------------------------------------------------

    def pull(self, gen: Optional[int] = None) -> Tuple[Dict[int, object], int]:
        store = self.store
        if gen is None:
            if store.committed is None:
                raise StoreUnrecoverable(-1, None)
            gen = store.committed
        meta = store.gens.get(gen)
        if meta is None or not meta["complete"]:
            raise StoreUnrecoverable(-1, gen)
        states: Dict[int, object] = {}
        # blob sizes are validated against the committed generation's
        # allgathered manifest — the value every rank agreed on at commit
        manifest = {r: entry for r, entry in
                    zip(sorted(meta["owners"]), meta["manifest"])}
        for rank, info in sorted(meta["owners"].items()):
            blob = self._local_rank(rank, gen)
            if blob is None:
                blob = self._fetch_rank(rank, gen, info)
            if blob is None:
                blob = self._salvage_rank(rank, gen)
            if blob is None or len(blob) != manifest[rank][2]:
                raise StoreUnrecoverable(rank, gen)
            states[rank] = MemStore._decode(blob)
        return states, meta["step"]

    def recoverable(self, gen: Optional[int] = None) -> bool:
        store = self.store
        gen = store.committed if gen is None else gen
        meta = store.gens.get(gen) if gen is not None else None
        if meta is None or not meta["complete"]:
            return False
        for rank in meta["owners"]:
            if self._salvage_rank(rank, gen, count=False) is None:
                return False
        return True
