"""Tree/ring/recursive-doubling collective algorithms over ReplicaTransport.

Each algorithm is a ``CollectiveOp`` whose schedule decomposes into the
same logged point-to-point sends the dense collectives use — so every
variant inherits the §5/§6 fault story for free (parallel cmp/rep paths,
intercomm fill-in, sender-based logging, replay after promotion, send-ID
dedup) and stays bitwise-faithful to ``ReferenceCollectives``:

  * binomial-tree ``bcast``/``gather`` (MPICH's mask walk): log₂N rounds
    instead of the root's N−1 messages;
  * ring ``allgather`` and ring ``reduce_scatter``: N−1 neighbor steps —
    constant fan-out, neighbor-distance hops;
  * ring ``allreduce``: reduce-scatter + allgather over 1/N-size chunks
    (the bandwidth-optimal 2·(N−1)·s/N volume);
  * recursive-doubling ``allreduce``/``allgather`` (power-of-two worlds):
    log₂N exchange rounds.

Reductions combine in a deterministic algorithm order (cyclic from the
chunk's successor for rings; lower-rank-block-first for recursive
doubling), so results are identical on every rank, every replica, and
every rerun; for payloads whose reduction is exact (all the test
payloads; max/min always) they are bitwise-equal to the sequential
reference fold as well.

``SelectionPolicy`` is the MPICH-style chooser (by world size and message
size — sizes must agree across ranks, MPI's own contract) and
``make_topo_ops`` wraps the default registry with selecting ops; plug the
result into ``CollectiveEngine(transport, ops=...)``.

The PyTorch port's copy of ``repro/topo/algorithms.py``.  A tensor payload
selects the algorithm an ndarray of the same shape and dtype selects, the
ring splits it into the same chunks (``torch.tensor_split`` is
``np.array_split``) and combines them in the same order, so results and
priced times are the reference's, on the CPU and on the card.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.comm.collectives import (AllgatherOp, AllreduceOp, BcastOp,
                                          COLLECTIVE_OPS, CollectiveOp,
                                          GatherOp, ReduceScatterOp,
                                          _TransportOp, combine, copy_array,
                                          is_array)
from repro_torch.comm.transport import NOTHING, payload_nbytes

# reserved tag block for algorithm variants (dense collectives use
# -11..-18, the checkpoint store -21..-24)
TAG_TREE_BCAST = -31
TAG_TREE_GATHER = -32
TAG_RING_ALLGATHER = -33
TAG_RD_ALLGATHER = -34
TAG_RING_RS = -35            # ring allreduce, reduce-scatter phase
TAG_RING_AG = -36            # ring allreduce, allgather phase
TAG_RD_ALLREDUCE = -37
TAG_RING_REDUCE_SCATTER = -38


def _pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def _binomial(vrank: int, n: int):
    """(parent, children) of ``vrank`` in the binomial tree rooted at 0 —
    MPICH's mask walk.  Children are returned high-subtree-first."""
    mask = 1
    parent = None
    while mask < n:
        if vrank & mask:
            parent = vrank - mask
            break
        mask <<= 1
    children = []
    m = mask >> 1
    while m > 0:
        if vrank + m < n:
            children.append(vrank + m)
        m >>= 1
    return parent, children


# --------------------------------------------------------------------------
# rooted trees
# --------------------------------------------------------------------------

class TreeBcastOp(_TransportOp):
    """Binomial-tree broadcast: the root sends to log₂N subtree heads;
    every other rank receives once from its parent and forwards to its
    children."""

    kind = "bcast"
    tag = TAG_TREE_BCAST

    def pending_heads(self):
        return ("bcast_tree",)

    def post(self, engine, ep, role, rank, op, step):
        _, value, root = op
        n = engine.n
        parent, children = _binomial((rank - root) % n, n)
        kids = [(c + root) % n for c in children]
        if parent is None:
            value = copy.deepcopy(value)
            for dst in kids:
                self._send(engine, ep, role, dst, value, step)
            return ("bcast_tree", {"done": True, "value": value})
        return ("bcast_tree", {"done": False, "parent": (parent + root) % n,
                               "children": kids, "step": step})

    def resolve(self, engine, ep, role, rank, pend):
        st = pend[1]
        if st["done"]:
            return st["value"]
        m = engine.transport.match_recv(ep, st["parent"], self.tag)
        if m is None:
            return NOTHING
        for dst in st["children"]:
            self._send(engine, ep, role, dst, m.payload, st["step"])
        return m.payload


class TreeGatherOp(_TransportOp):
    """Binomial-tree gather: leaves send ``{rank: value}`` up; interior
    ranks merge their children's subtree tables before forwarding, so the
    root receives log₂N messages instead of N−1."""

    kind = "gather"
    tag = TAG_TREE_GATHER

    def pending_heads(self):
        return ("gather_tree",)

    def post(self, engine, ep, role, rank, op, step):
        _, value, root = op
        n = engine.n
        parent, children = _binomial((rank - root) % n, n)
        st = {"got": {rank: copy.deepcopy(value)},
              "waiting": sorted((c + root) % n for c in children),
              "parent": None if parent is None else (parent + root) % n,
              "step": step}
        if not st["waiting"] and st["parent"] is not None:
            self._send(engine, ep, role, st["parent"], st["got"], step)
            return ("gather_tree", {"done": True})
        return ("gather_tree", st)

    def resolve(self, engine, ep, role, rank, pend):
        st = pend[1]
        if st.get("done"):
            return None
        for c in list(st["waiting"]):
            m = engine.transport.match_recv(ep, c, self.tag)
            if m is not None:
                st["got"].update(m.payload)
                st["waiting"].remove(c)
        if st["waiting"]:
            return NOTHING
        if st["parent"] is None:
            return [st["got"][s] for s in range(engine.n)]
        self._send(engine, ep, role, st["parent"], st["got"], st["step"])
        return None


# --------------------------------------------------------------------------
# rings
# --------------------------------------------------------------------------

class RingAllgatherOp(_TransportOp):
    """Ring allgather: each contribution travels the ring once — N−1
    neighbor steps of constant size, no fan-in hotspot."""

    kind = "allgather"
    tag = TAG_RING_ALLGATHER

    def pending_heads(self):
        return ("allgather_ring",)

    def post(self, engine, ep, role, rank, op, step):
        _, value = op
        n = engine.n
        if n == 1:
            return ("allgather_ring", {"result": [copy.deepcopy(value)]})
        self._send(engine, ep, role, (rank + 1) % n, (rank, value), step)
        return ("allgather_ring",
                {"round": 0, "got": {rank: copy.deepcopy(value)},
                 "step": step})

    def resolve(self, engine, ep, role, rank, pend):
        st = pend[1]
        if "result" in st:
            return st["result"]
        n = engine.n
        left, right = (rank - 1) % n, (rank + 1) % n
        while st["round"] < n - 1:
            m = engine.transport.match_recv(ep, left, self.tag)
            if m is None:
                return NOTHING
            src, val = m.payload
            st["got"][src] = val
            st["round"] += 1
            if st["round"] < n - 1:
                self._send(engine, ep, role, right, (src, val), st["step"])
        return [st["got"][s] for s in range(n)]


class RingReduceScatterOp(_TransportOp):
    """Ring reduce-scatter: the partial for destination d starts at rank
    d+1 and accumulates around the ring (cyclic order d+1, d+2, …, d), so
    every link carries one chunk per round and rank d performs the final
    combine."""

    kind = "reduce_scatter"
    tag = TAG_RING_REDUCE_SCATTER

    def pending_heads(self):
        return ("reduce_scatter_ring",)

    def post(self, engine, ep, role, rank, op, step):
        _, chunks, redop = op
        n = engine.n
        if len(chunks) != n:
            raise ValueError(f"reduce_scatter needs one chunk per rank "
                             f"({n}), got {len(chunks)}")
        if n == 1:
            return ("reduce_scatter_ring",
                    {"result": copy.deepcopy(chunks[0])})
        chunks = [copy.deepcopy(c) for c in chunks]
        d0 = (rank - 1) % n
        self._send(engine, ep, role, (rank + 1) % n, (d0, chunks[d0]), step)
        return ("reduce_scatter_ring",
                {"chunks": chunks, "redop": redop, "round": 0, "step": step})

    def resolve(self, engine, ep, role, rank, pend):
        st = pend[1]
        if "result" in st:
            return st["result"]
        n = engine.n
        left, right = (rank - 1) % n, (rank + 1) % n
        while st["round"] < n - 1:
            m = engine.transport.match_recv(ep, left, self.tag)
            if m is None:
                return NOTHING
            d, partial = m.payload
            partial = combine(st["redop"], [partial, st["chunks"][d]])
            st["round"] += 1
            if d == rank:                    # final combine (last round)
                st["result"] = partial
                return partial
            self._send(engine, ep, role, right, (d, partial), st["step"])
        raise RuntimeError("ring reduce_scatter finished without a result")


class RingAllreduceOp(_TransportOp):
    """Ring allreduce = ring reduce-scatter + ring allgather over
    1/N-size chunks: 2·(N−1) neighbor steps moving ~2·s/N bytes each —
    the bandwidth-optimal schedule dense exchanges cannot match at scale.
    Requires array payloads, ndarrays or tensors (the selection policy
    routes scalars to recursive doubling or the switchboard)."""

    kind = "allreduce"
    tag = TAG_RING_RS

    def pending_heads(self):
        return ("allreduce_ring",)

    def post(self, engine, ep, role, rank, op, step):
        _, value, redop = op
        n = engine.n
        if not is_array(value) or value.ndim < 1:
            raise ValueError("ring allreduce needs ndarray or tensor "
                             "payloads (ndim >= 1); the selection policy "
                             "routes scalars elsewhere")
        if n == 1:
            return ("allreduce_ring", {"result": copy_array(value)})
        split = torch.tensor_split if isinstance(value, torch.Tensor) \
            else np.array_split
        chunks = [copy_array(c) for c in split(value, n, 0)]
        d0 = (rank - 1) % n
        self._send(engine, ep, role, (rank + 1) % n, (d0, chunks[d0]), step)
        return ("allreduce_ring",
                {"phase": "rs", "chunks": chunks, "redop": redop,
                 "round": 0, "step": step})

    def resolve(self, engine, ep, role, rank, pend):
        st = pend[1]
        if "result" in st:
            return st["result"]
        n = engine.n
        left, right = (rank - 1) % n, (rank + 1) % n
        if st["phase"] == "rs":
            while st["round"] < n - 1:
                m = engine.transport.match_recv(ep, left, TAG_RING_RS)
                if m is None:
                    return NOTHING
                d, partial = m.payload
                partial = combine(st["redop"], [partial, st["chunks"][d]])
                st["round"] += 1
                if d == rank:                # reduced chunk owned; phase 2
                    st["chunks"][rank] = partial
                    st["phase"], st["round"] = "ag", 0
                    self._send(engine, ep, role, right, (rank, partial),
                               st["step"], tag=TAG_RING_AG)
                    break
                self._send(engine, ep, role, right, (d, partial), st["step"])
        while st["round"] < n - 1:
            m = engine.transport.match_recv(ep, left, TAG_RING_AG)
            if m is None:
                return NOTHING
            idx, chunk = m.payload
            st["chunks"][idx] = chunk
            st["round"] += 1
            if st["round"] < n - 1:
                self._send(engine, ep, role, right, (idx, chunk), st["step"],
                           tag=TAG_RING_AG)
        parts = [st["chunks"][i] for i in range(n)]
        st["result"] = torch.cat(parts, 0) \
            if isinstance(parts[0], torch.Tensor) \
            else np.concatenate([np.asarray(c) for c in parts], axis=0)
        return st["result"]

    def _send(self, engine, ep, role, dst, payload, step, tag=None):
        engine.transport.send(ep, dst, self.tag if tag is None else tag,
                              payload, step, log=(role == "cmp"))


# --------------------------------------------------------------------------
# recursive doubling (power-of-two worlds)
# --------------------------------------------------------------------------

class RDAllgatherOp(_TransportOp):
    """Recursive-doubling allgather: log₂N exchange rounds with doubling
    tables — latency-optimal for small messages."""

    kind = "allgather"
    tag = TAG_RD_ALLGATHER

    def pending_heads(self):
        return ("allgather_rd",)

    def post(self, engine, ep, role, rank, op, step):
        _, value = op
        n = engine.n
        if not _pow2(n):
            raise ValueError(f"recursive doubling needs a power-of-two "
                             f"world, got {n}")
        if n == 1:
            return ("allgather_rd", {"result": [copy.deepcopy(value)]})
        st = {"stage": 0, "got": {rank: copy.deepcopy(value)}, "step": step}
        self._send(engine, ep, role, rank ^ 1, dict(st["got"]), step)
        return ("allgather_rd", st)

    def resolve(self, engine, ep, role, rank, pend):
        st = pend[1]
        if "result" in st:
            return st["result"]
        n = engine.n
        n_stages = n.bit_length() - 1
        while st["stage"] < n_stages:
            partner = rank ^ (1 << st["stage"])
            m = engine.transport.match_recv(ep, partner, self.tag)
            if m is None:
                return NOTHING
            st["got"].update(m.payload)
            st["stage"] += 1
            if st["stage"] < n_stages:
                self._send(engine, ep, role, rank ^ (1 << st["stage"]),
                           dict(st["got"]), st["step"])
        return [st["got"][s] for s in range(n)]


class RDAllreduceOp(_TransportOp):
    """Recursive-doubling allreduce: log₂N butterfly rounds on the full
    vector, combining lower-rank block first at every stage so all ranks
    produce bit-identical results."""

    kind = "allreduce"
    tag = TAG_RD_ALLREDUCE

    def pending_heads(self):
        return ("allreduce_rd",)

    def post(self, engine, ep, role, rank, op, step):
        _, value, redop = op
        n = engine.n
        if not _pow2(n):
            raise ValueError(f"recursive doubling needs a power-of-two "
                             f"world, got {n}")
        if n == 1:
            return ("allreduce_rd", {"result": copy.deepcopy(value)})
        st = {"stage": 0, "acc": copy.deepcopy(value), "redop": redop,
              "step": step}
        self._send(engine, ep, role, rank ^ 1, st["acc"], step)
        return ("allreduce_rd", st)

    def resolve(self, engine, ep, role, rank, pend):
        st = pend[1]
        if "result" in st:
            return st["result"]
        n = engine.n
        n_stages = n.bit_length() - 1
        while st["stage"] < n_stages:
            partner = rank ^ (1 << st["stage"])
            m = engine.transport.match_recv(ep, partner, self.tag)
            if m is None:
                return NOTHING
            lo, hi = (st["acc"], m.payload) if rank < partner \
                else (m.payload, st["acc"])
            st["acc"] = combine(st["redop"], [lo, hi])
            st["stage"] += 1
            if st["stage"] < n_stages:
                self._send(engine, ep, role, rank ^ (1 << st["stage"]),
                           st["acc"], st["step"])
        return st["acc"]


# --------------------------------------------------------------------------
# selection policy + registry
# --------------------------------------------------------------------------

@dataclass
class SelectionPolicy:
    """MPICH-style algorithm choice by world size and message size.

    Sizes are read from the local contribution, which MPI's own contract
    makes identical across ranks for the size-selected collectives
    (allreduce/allgather/reduce_scatter counts must agree); the rooted
    collectives select on N alone because non-roots may not know the
    payload (bcast's non-root value is ignored).

    | collective     | N <= 2       | small message     | large message |
    |----------------|--------------|-------------------|---------------|
    | bcast          | dense        | binomial tree     | binomial tree |
    | gather         | dense        | binomial tree     | binomial tree |
    | allgather      | dense        | rec. doubling*    | ring          |
    | allreduce      | switchboard  | rec. doubling*    | ring (arrays) |
    | reduce_scatter | dense        | dense             | ring          |
    | alltoall       | dense        | dense             | dense         |

    (*) power-of-two worlds only.  Non-pow2 allgather uses ring; non-pow2
    allreduce uses ring for large arrays and the switchboard for
    everything else (small arrays included).
    """

    small_msg_bytes: int = 8192

    def choose(self, kind: str, n: int, op: tuple) -> str:
        if kind in ("bcast", "gather"):
            return "tree" if n > 2 else "dense"
        if kind == "allgather":
            if n <= 2:
                return "dense"
            if _pow2(n) and payload_nbytes(op[1]) < self.small_msg_bytes:
                return "rd"
            return "ring"
        if kind == "allreduce":
            if n <= 2:
                return "switchboard"
            v = op[1]
            if is_array(v) and v.ndim >= 1 and \
                    payload_nbytes(v) >= self.small_msg_bytes:
                return "ring"
            if _pow2(n) and isinstance(v, (np.ndarray, torch.Tensor,
                                           np.generic, float, int)):
                return "rd"
            return "switchboard"
        if kind == "reduce_scatter":
            if n > 2 and payload_nbytes(op[1]) >= self.small_msg_bytes:
                return "ring"
            return "dense"
        return "dense"


class SelectingOp(CollectiveOp):
    """Registry entry that picks an algorithm per instance (the policy is
    a deterministic function of (N, sizes), so every rank and role of one
    collective instance picks the same schedule) and dispatches pendings
    to whichever algorithm produced them."""

    def __init__(self, kind: str, policy: SelectionPolicy,
                 algorithms: Dict[str, CollectiveOp]):
        self.kind = kind
        self.policy = policy
        self.algorithms = algorithms
        self._by_head = {head: alg for alg in algorithms.values()
                         for head in alg.pending_heads()}

    def pending_heads(self):
        return tuple(self._by_head)

    def post(self, engine, ep, role, rank, op, step):
        name = self.policy.choose(self.kind, engine.n, op)
        return self.algorithms[name].post(engine, ep, role, rank, op, step)

    def resolve(self, engine, ep, role, rank, pend):
        # switchboard pendings arrive under the shared "collective" head
        alg = self._by_head.get(pend[0]) or self.algorithms["switchboard"]
        return alg.resolve(engine, ep, role, rank, pend)


def make_topo_ops(policy: SelectionPolicy = None) -> Dict[str, CollectiveOp]:
    """The default registry with topology-aware selecting collectives;
    feed to ``CollectiveEngine(transport, ops=make_topo_ops(...))``."""
    policy = policy or SelectionPolicy()
    ops = dict(COLLECTIVE_OPS)
    ops["bcast"] = SelectingOp("bcast", policy, {
        "dense": BcastOp(), "tree": TreeBcastOp()})
    ops["gather"] = SelectingOp("gather", policy, {
        "dense": GatherOp(), "tree": TreeGatherOp()})
    ops["allgather"] = SelectingOp("allgather", policy, {
        "dense": AllgatherOp(), "ring": RingAllgatherOp(),
        "rd": RDAllgatherOp()})
    ops["allreduce"] = SelectingOp("allreduce", policy, {
        "switchboard": AllreduceOp(), "ring": RingAllreduceOp(),
        "rd": RDAllreduceOp()})
    ops["reduce_scatter"] = SelectingOp("reduce_scatter", policy, {
        "dense": ReduceScatterOp(), "ring": RingReduceScatterOp()})
    return ops
