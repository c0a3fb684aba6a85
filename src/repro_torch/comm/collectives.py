"""Collective engine over the replica-aware transport.

Two implementation families, one registry:

  * switchboard collectives (``allreduce``, ``barrier``) match role-tagged
    contributions directly — the paper's §5 rule: a computational worker's
    result combines the computational contributions; a replica's result
    combines replica contributions plus the no-replica computational ones
    (delivered over the intercomm in the real library).  A promoted
    worker's old-role contribution counts for its new role (same value by
    construction).  Intake is structure-of-arrays (``_SwitchTable``,
    docs/perf.md "SoA collective tables"): per-role numpy arrival
    bitmasks, contributions stacked into one ``(n, …)`` buffer, an O(1)
    union-completeness counter.  Combining is one vectorized ufunc
    reduction (``combine_stacked``; rank-ascending, bitwise-identical to
    the sequential fold), memoized per (instance, role-view), and
    resolution is batched: completed instances land on a completion list
    the scheduler drains to wake exactly the parked waiters
    (``CollectiveEngine.take_completions``).

  * transport collectives (``bcast``, ``gather``, ``reduce_scatter``,
    ``alltoall``) decompose into explicit point-to-point sends over the
    transport on reserved negative tags.  They therefore inherit the full
    §5/§6 fault story for free: parallel cmp/rep paths, intercomm fill-in,
    sender-based logging, replay, and send-ID dedup.

Adding a collective means registering one ``CollectiveOp`` subclass — no
scheduler changes.  ``ReferenceCollectives`` is the failure-free
straight-line matcher (shared by the JAX package's SimAppWorkload and the
tests' numpy references); ``reference_result`` defines the semantics of
every collective in one place.

Op vocabulary (generator yields):

    ("allreduce", value, redop)            -> combined value, all ranks
    ("barrier",)                           -> None, all ranks
    ("bcast", value, root)                 -> root's value, all ranks
    ("gather", value, root)                -> [v_0..v_{n-1}] at root, None elsewhere
    ("allgather", value)                   -> [v_0..v_{n-1}], all ranks
    ("reduce_scatter", chunks, redop)      -> combine of chunk[rank] across ranks
    ("alltoall", chunks)                   -> [chunk_from_0..chunk_from_{n-1}]
    ("scan", value, redop)                 -> combine of v_0..v_rank (inclusive
                                              prefix reduction)
    ("neighbor_allgather", value, nbrs)    -> [v_q for q in nbrs]
    ("neighbor_alltoall", chunks, nbrs)    -> [chunk addressed to us by each
                                              q in nbrs]

``chunks`` is a length-n sequence indexed by destination rank; for the
neighborhood collectives it aligns with ``nbrs`` instead — the rank's MPI
``dist_graph`` neighbor list (topo.graph builds the common ones).
The neighbor graph must be symmetric: every listed neighbor must list the
rank back, or the collective deadlocks (exactly MPI's contract).

The PyTorch port's copy of ``repro/comm/collectives.py``.  Wherever the
reference treats an ``ndarray`` (the stacked combine, the SoA row stacks
and their demotion, the rep/cmp row select, the per-worker result copy) a
``torch.Tensor`` takes the same path, on its own device.  A tensor
reduction folds the rows explicitly in rank order, as numpy's outer-axis
``ufunc.reduce`` does, so an allreduce gives the reference's bits on CPU
tensors and the same bits on the card; numpy's reduction quirks are kept
(``combine_stacked``).  Numpy payloads take the reference's code
unchanged.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm.payload import structural_copy
from repro_torch.comm.transport import NOTHING, Endpoint, ReplicaTransport
from repro_torch.core.message_log import payload_nbytes

# reserved tag space for transport collectives (apps use tags >= 0;
# the checkpoint store uses -21..-24, topo.algorithms -31..-38)
TAG_BCAST = -11
TAG_GATHER = -12
TAG_REDUCE_SCATTER = -13
TAG_ALLTOALL = -14
TAG_ALLGATHER = -15
TAG_SCAN = -16
TAG_NEIGHBOR_ALLGATHER = -17
TAG_NEIGHBOR_ALLTOALL = -18

_REDOPS = {"sum": np.add, "max": np.maximum, "min": np.minimum,
           "prod": np.multiply}
_TORCH_REDOPS = {"sum": torch.add, "max": torch.maximum,
                 "min": torch.minimum, "prod": torch.mul}
# numpy's add and multiply reductions accumulate bool and integers narrower
# than 64 bits in int64 (unsigned ones in uint64: the same bits, since
# two's-complement add and multiply wrap alike)
_NARROW_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)
_NARROW = (torch.bool, torch.int8, torch.int16, torch.int32) \
    + _NARROW_UNSIGNED
# dtypes whose 1-D add reduction numpy sums pairwise (float16 in float32)
_PAIRWISE = {torch.float16: torch.float32, torch.float32: torch.float32,
             torch.float64: torch.float64}


def is_array(v) -> bool:
    """An ndarray or a tensor: the payloads the stacked paths take."""
    return isinstance(v, (np.ndarray, torch.Tensor))


def copy_array(v):
    """A fresh copy of an ndarray or a tensor (on its own device)."""
    return v.clone() if isinstance(v, torch.Tensor) else v.copy()


def _pairwise_sum(rows):
    """numpy's ``pairwise_sum`` over whole rows, in their order: fewer
    than 8 rows summed in turn from -0.0; up to 128 in eight interleaved
    partial sums; more split in two at a multiple of 8."""
    n = len(rows)
    if n < 8:
        res = torch.full_like(rows[0], -0.0)
        for r in rows:
            res = res + r
        return res
    if n <= 128:
        acc = list(rows[:8])
        i = 8
        while i < n - n % 8:
            for j in range(8):
                acc[j] = acc[j] + rows[i + j]
            i += 8
        res = ((acc[0] + acc[1]) + (acc[2] + acc[3])) \
            + ((acc[4] + acc[5]) + (acc[6] + acc[7]))
        for r in rows[i:]:
            res = res + r
        return res
    half = n // 2
    half -= half % 8
    return _pairwise_sum(rows[:half]) + _pairwise_sum(rows[half:])


def _combine_stacked_tensor(redop: str, stacked: torch.Tensor):
    """numpy's ``ufunc.reduce(stacked, axis=0)`` on a tensor, bit for bit:
    rows folded in rank order from the ufunc's identity (0 for sum, 1 for
    prod; max and min start from row 0), narrow integers in 64 bits, and a
    single-element row (which numpy reduces as a 1-D sum) summed
    pairwise."""
    fn = _TORCH_REDOPS[redop]
    out_dtype = stacked.dtype
    if redop in ("sum", "prod") and out_dtype in _NARROW:
        stacked = stacked.to(torch.int64)
    rows = list(stacked.unbind(0))
    if redop in ("max", "min"):
        out = rows[0].clone()
        for r in rows[1:]:
            out = fn(out, r)
        return out
    pairwise = _PAIRWISE.get(stacked.dtype)
    if redop == "sum" and pairwise is not None and rows \
            and rows[0].numel() == 1:
        acc = _pairwise_sum([r.to(pairwise) for r in rows])
        return (torch.zeros_like(acc) + acc).to(stacked.dtype)
    out = (torch.zeros_like if redop == "sum" else torch.ones_like)(
        stacked[0])
    for r in rows:
        out = fn(out, r)
    if out_dtype in _NARROW_UNSIGNED:
        out = out.view(torch.uint64)
    return out


def combine_stacked(redop: str, stacked) -> Any:
    """THE combine kernel: one vectorized ufunc reduction over the
    leading (rank) axis of a stacked ``(n, …)`` contribution buffer.
    numpy's outer-axis reduction is a row-by-row accumulation, so for
    rows of ndim >= 1 the result is bitwise-identical to the sequential
    rank-ascending fold.  Both the engine's SoA tables and the
    ``ReferenceCollectives`` resolver reduce through here.  A stacked
    tensor is reduced by ``_combine_stacked_tensor`` to the same bits."""
    ufunc = _REDOPS.get(redop)
    if ufunc is None:
        raise ValueError(f"unknown reduction op {redop!r}")
    if isinstance(stacked, torch.Tensor):
        return _combine_stacked_tensor(redop, stacked)
    return ufunc.reduce(stacked, axis=0)


def _stackable(values) -> bool:
    """Arrays of one kind, ndim >= 1, one shape and dtype (and for tensors
    one device): what ``combine`` stacks."""
    v0 = values[0]
    if isinstance(v0, torch.Tensor):
        return all(type(v) is torch.Tensor and v.ndim >= 1
                   and v.shape == v0.shape and v.dtype == v0.dtype
                   and v.device == v0.device for v in values)
    return all(isinstance(v, np.ndarray) and v.ndim >= 1
               and v.shape == v0.shape and v.dtype == v0.dtype
               for v in values)


def combine(redop: str, values) -> Any:
    """Reduce ``values`` in index order. Array payloads of a common shape
    are stacked and handed to ``combine_stacked``; scalars and ragged
    payloads fall back to the sequential fold (keeping result types
    bitwise-stable: a scalar allreduce returns a Python float, not a
    numpy scalar)."""
    ufunc = _REDOPS.get(redop)
    if ufunc is None:
        raise ValueError(f"unknown reduction op {redop!r}")
    values = list(values)
    if len(values) > 2 and _stackable(values):
        stack = torch.stack if isinstance(values[0], torch.Tensor) \
            else np.stack
        return combine_stacked(redop, stack(values))
    out = values[0]
    for v in values[1:]:
        if redop == "sum":
            out = out + v
        elif isinstance(out, torch.Tensor) or isinstance(v, torch.Tensor):
            out = _TORCH_REDOPS[redop](out, v)
        else:
            out = ufunc(out, v)
    return out


def reference_result(kind: str, votes: Dict[int, Any], rank: int, n: int,
                     meta=None):
    """Straight-line semantics of every collective, given the full
    contribution table ``votes[src_rank]``. The single source of truth the
    replicated engine, the sequential resolver, and the tests share."""
    if kind == "barrier":
        return None
    if kind == "allreduce":
        return combine(meta, [votes[r] for r in range(n)])
    if kind == "bcast":
        return structural_copy(votes[meta])
    if kind == "gather":
        return [structural_copy(votes[r]) for r in range(n)] \
            if rank == meta else None
    if kind == "allgather":
        return [structural_copy(votes[r]) for r in range(n)]
    if kind == "reduce_scatter":
        return combine(meta, [votes[s][rank] for s in range(n)])
    if kind == "alltoall":
        return [structural_copy(votes[s][rank]) for s in range(n)]
    if kind == "scan":
        return combine(meta, [votes[s] for s in range(rank + 1)])
    if kind == "neighbor_allgather":
        # votes[src] = (value, neighbor list)
        _value, nbrs = votes[rank]
        return [structural_copy(votes[q][0]) for q in nbrs]
    if kind == "neighbor_alltoall":
        # votes[src] = (chunks aligned with src's neighbor list, that list)
        _chunks, nbrs = votes[rank]
        return [structural_copy(votes[q][0][list(votes[q][1]).index(rank)])
                for q in nbrs]
    raise ValueError(f"unknown collective {kind!r}")


# --------------------------------------------------------------------------
# collective ops (registry entries)
# --------------------------------------------------------------------------

class CollectiveOp:
    """One collective's intake + resolution strategy."""

    kind: str = ""

    def pending_heads(self) -> tuple:
        """Heads of the pending descriptors this op resolves.  Switchboard
        ops share the "collective" head (dispatched via the key's kind);
        transport ops default to the ``<kind>_wait``/``<kind>_done``
        convention and algorithm variants add their own."""
        return (f"{self.kind}_wait", f"{self.kind}_done")

    def post(self, engine: "CollectiveEngine", ep: Endpoint, role: str,
             rank: int, op: tuple, step: int) -> tuple:
        raise NotImplementedError

    def resolve(self, engine: "CollectiveEngine", ep: Endpoint, role: str,
                rank: int, pend: tuple):
        raise NotImplementedError


class _SwitchTable:
    """Structure-of-arrays intake table for ONE switchboard instance.

    Per role: a boolean arrival mask over ranks plus the contributions
    stacked into one ``(n, …)`` numpy buffer, or tensor on the payload's
    device (the role's first exact-type ndarray or tensor payload sizes
    the stack; scalars, ragged shapes, other dtypes or devices,
    subclasses, and object dtypes demote the role to a plain object
    list, which resolves through the sequential ``combine`` path).
    ``have`` counts ranks with a vote from EITHER role, so union
    completeness — the §5 rule with promotion fallback folded in — is
    one integer compare instead of a per-rank membership scan."""

    __slots__ = ("n", "masks", "stacks", "objs", "have", "complete")

    def __init__(self, n: int):
        self.n = n
        self.masks: Dict[str, np.ndarray] = {}
        self.stacks: Dict[str, Any] = {}
        self.objs: Dict[str, Optional[list]] = {}
        self.have = 0                 # ranks with >= 1 vote (union count)
        self.complete = False

    def post(self, role: str, rank: int, value, store: bool) -> bool:
        """Record one contribution; True when this vote completed the
        union.  ``store=False`` (barrier) keeps only the arrival mask."""
        mask = self.masks.get(role)
        if mask is None:
            mask = self.masks[role] = np.zeros(self.n, dtype=bool)
            if store:
                if type(value) is np.ndarray and value.ndim >= 1 \
                        and value.dtype != object:
                    self.stacks[role] = np.zeros(
                        (self.n,) + value.shape, dtype=value.dtype)
                    self.objs[role] = None
                elif type(value) is torch.Tensor and value.ndim >= 1:
                    self.stacks[role] = torch.zeros(
                        (self.n,) + tuple(value.shape), dtype=value.dtype,
                        device=value.device)
                    self.objs[role] = None
                else:
                    self.stacks[role] = None
                    self.objs[role] = [None] * self.n
        had = self._covered(rank)
        mask[rank] = True
        if store:
            stack = self.stacks.get(role)
            if stack is not None and type(value) is type(stack) \
                    and value.shape == stack.shape[1:] \
                    and value.dtype == stack.dtype \
                    and (not isinstance(value, torch.Tensor)
                         or value.device == stack.device):
                stack[rank] = value       # the row write IS the copy
            else:
                self._demote(role, stack)
                self.objs[role][rank] = structural_copy(value)
        if not had:
            self.have += 1
            if self.have == self.n:
                self.complete = True
                return True
        return False

    def _covered(self, rank: int) -> bool:
        for mask in self.masks.values():      # <= 2 roles
            if mask[rank]:
                return True
        return False

    def _demote(self, role: str, stack) -> None:
        """Mixed payload shapes/dtypes within one role: fall back to an
        object list (resolved via the sequential ``combine``)."""
        if self.objs.get(role) is not None:
            return
        objs = [None] * self.n
        if stack is not None:
            mask = self.masks[role]
            n = self.n
            for r in range(n):               # demotion slow path
                if mask[r]:
                    objs[r] = copy_array(stack[r])
        self.objs[role] = objs
        self.stacks[role] = None


class _SwitchboardOp(CollectiveOp):
    """Matches role-tagged contributions in the engine's SoA tables (no
    messages): the §5 role-aware completion rule with promotion fallback.

    Pricing: the in-memory match stands in for a dense exchange — one
    message from every endpoint to each of its n-1 peers.  When the
    transport carries a cost model those phantom messages are charged
    through it (``charge_phantom``, same §5 routing as a real send), so
    switchboard and tree/ring algorithms report a comparable
    ``TimeBreakdown.comm``; the closed-form ``collective_time`` estimator
    remains only for policy layers with no transport at hand."""

    def pending_heads(self):
        return ()                            # shares the "collective" head

    def _key(self, engine, ep, op, step) -> tuple:
        idx = ep.op_index
        ep.op_index += 1
        return (self.kind, step, idx) + self._key_extra(op)

    def _key_extra(self, op) -> tuple:
        return ()

    def _charge_dense(self, engine, ep, rank, value=None) -> None:
        t = engine.transport
        if t.cost_model is None:
            return                       # unpriced: skip sizing the payload
        nbytes = payload_nbytes(value) if value is not None else 0
        for dst in range(engine.n):  # repro: allow[per-rank-loop] -- priced (small-N) runs only
            if dst != rank:
                t.charge_phantom(ep, dst, nbytes)


class AllreduceOp(_SwitchboardOp):
    kind = "allreduce"

    def _key_extra(self, op):
        return (op[2],)                      # redop

    def post(self, engine, ep, role, rank, op, step):
        _, value, redop = op
        key = self._key(engine, ep, op, step)
        engine.intake(key, role, rank, value, store=True)
        self._charge_dense(engine, ep, rank, value)
        return ("collective", key, redop)

    def resolve(self, engine, ep, role, rank, pend):
        _, key, redop = pend
        table = engine.tables.get(key)
        if table is None or not table.complete:
            return NOTHING
        # memoized per (instance, role view); the view key is O(1) — the
        # rep view collapses to "cmp" while no rank has a live replica
        memo_key = (key, engine.view_key(role))
        out = engine.combined.get(memo_key)
        if out is None:
            out = engine.combine_table(table, role, redop)
            engine.combined[memo_key] = out
        # each worker gets its own array (matching the pre-memoization
        # contract): an app mutating its result in place must not corrupt
        # the memo or its same-role peers
        return copy_array(out) if is_array(out) else out


class BarrierOp(_SwitchboardOp):
    kind = "barrier"

    def post(self, engine, ep, role, rank, op, step):
        key = self._key(engine, ep, op, step)
        engine.intake(key, role, rank, None, store=False)
        self._charge_dense(engine, ep, rank)      # zero-byte sync round
        return ("collective", key, None)

    def resolve(self, engine, ep, role, rank, pend):
        _, key, _ = pend
        table = engine.tables.get(key)
        if table is None or not table.complete:
            return NOTHING
        return None


class _TransportOp(CollectiveOp):
    """Base for collectives that decompose into p2p sends over the
    transport (and so are logged, replayed, and deduped like any send)."""

    tag: int = 0

    def _send(self, engine, ep, role, dst, payload, step):
        engine.transport.send(ep, dst, self.tag, payload, step,
                              log=(role == "cmp"))


class BcastOp(_TransportOp):
    kind = "bcast"
    tag = TAG_BCAST

    def post(self, engine, ep, role, rank, op, step):
        _, value, root = op
        if rank == root:
            for dst in range(engine.n):  # repro: allow[per-rank-loop] -- one real send per peer
                if dst != root:
                    self._send(engine, ep, role, dst, value, step)
            return ("bcast_done", structural_copy(value))
        return ("bcast_wait", root)

    def resolve(self, engine, ep, role, rank, pend):
        if pend[0] == "bcast_done":
            return pend[1]
        _, root = pend
        m = engine.transport.match_recv(ep, root, self.tag)
        return m.payload if m is not None else NOTHING


class GatherOp(_TransportOp):
    kind = "gather"
    tag = TAG_GATHER

    def post(self, engine, ep, role, rank, op, step):
        _, value, root = op
        if rank == root:
            return ("gather_wait", root, {root: structural_copy(value)})
        self._send(engine, ep, role, root, value, step)
        return ("gather_done",)

    def resolve(self, engine, ep, role, rank, pend):
        if pend[0] == "gather_done":
            return None
        _, _root, got = pend
        for s in range(engine.n):  # repro: allow[per-rank-loop] -- p2p match per peer
            if s not in got:
                m = engine.transport.match_recv(ep, s, self.tag)
                if m is not None:
                    got[s] = m.payload
        if len(got) < engine.n:
            return NOTHING
        # repro: allow[per-rank-loop] -- per-peer result assembly
        return [got[s] for s in range(engine.n)]


class _ScatterWaitAllOp(_TransportOp):
    """Send chunk[dst] to every other rank, keep the own chunk, wait for
    one message from every peer — the dense exchange both reduce_scatter
    and alltoall are built on."""

    def _chunks(self, op):
        return op[1]

    def post(self, engine, ep, role, rank, op, step):
        chunks = self._chunks(op)
        if len(chunks) != engine.n:
            raise ValueError(
                f"{self.kind} needs one chunk per rank "
                f"({engine.n}), got {len(chunks)}")
        for dst in range(engine.n):  # repro: allow[per-rank-loop] -- one real send per peer
            if dst != rank:
                self._send(engine, ep, role, dst, chunks[dst], step)
        return (f"{self.kind}_wait", self._meta(op),
                {rank: structural_copy(chunks[rank])})

    def _meta(self, op):
        return None

    def resolve(self, engine, ep, role, rank, pend):
        _, meta, got = pend
        for s in range(engine.n):  # repro: allow[per-rank-loop] -- p2p match per peer
            if s not in got:
                m = engine.transport.match_recv(ep, s, self.tag)
                if m is not None:
                    got[s] = m.payload
        if len(got) < engine.n:
            return NOTHING
        # repro: allow[per-rank-loop] -- per-peer result assembly
        return self._finish(meta, [got[s] for s in range(engine.n)])

    def _finish(self, meta, parts):
        raise NotImplementedError


class ReduceScatterOp(_ScatterWaitAllOp):
    kind = "reduce_scatter"
    tag = TAG_REDUCE_SCATTER

    def _meta(self, op):
        return op[2]                         # redop

    def _finish(self, redop, parts):
        return combine(redop, parts)


class AlltoallOp(_ScatterWaitAllOp):
    kind = "alltoall"
    tag = TAG_ALLTOALL

    def _finish(self, meta, parts):
        return parts


class AllgatherOp(_TransportOp):
    """Every rank contributes one value; every rank receives the full
    [v_0..v_{n-1}] list (gather without a root): a dense exchange of the
    same payload to every peer."""

    kind = "allgather"
    tag = TAG_ALLGATHER

    def post(self, engine, ep, role, rank, op, step):
        _, value = op
        for dst in range(engine.n):  # repro: allow[per-rank-loop] -- one real send per peer
            if dst != rank:
                self._send(engine, ep, role, dst, value, step)
        return ("allgather_wait", None, {rank: structural_copy(value)})

    def resolve(self, engine, ep, role, rank, pend):
        _, _meta, got = pend
        for s in range(engine.n):  # repro: allow[per-rank-loop] -- p2p match per peer
            if s not in got:
                m = engine.transport.match_recv(ep, s, self.tag)
                if m is not None:
                    got[s] = m.payload
        if len(got) < engine.n:
            return NOTHING
        # repro: allow[per-rank-loop] -- per-peer result assembly
        return [got[s] for s in range(engine.n)]


class ScanOp(_TransportOp):
    """Inclusive prefix reduction (MPI_Scan): rank r's result combines the
    contributions of ranks 0..r in rank order.  Each rank sends its value
    only to the ranks above it and waits only for the ranks below it, so
    rank 0 never blocks."""

    kind = "scan"
    tag = TAG_SCAN

    def post(self, engine, ep, role, rank, op, step):
        _, value, redop = op
        for dst in range(rank + 1, engine.n):  # repro: allow[per-rank-loop] -- one real send per peer
            self._send(engine, ep, role, dst, value, step)
        return ("scan_wait", redop, {rank: structural_copy(value)})

    def resolve(self, engine, ep, role, rank, pend):
        _, redop, got = pend
        for s in range(rank):
            if s not in got:
                m = engine.transport.match_recv(ep, s, self.tag)
                if m is not None:
                    got[s] = m.payload
        if len(got) < rank + 1:
            return NOTHING
        return combine(redop, [got[s] for s in range(rank + 1)])


class _NeighborOp(_TransportOp):
    """Base for the MPI ``dist_graph`` neighborhood collectives: one send
    to and one receive from every rank in the op-supplied neighbor list
    (which must be symmetric across ranks — MPI's contract)."""

    def _payload_for(self, op, i: int):
        raise NotImplementedError

    def post(self, engine, ep, role, rank, op, step):
        nbrs = tuple(op[2])
        if len(nbrs) != len(set(nbrs)) or rank in nbrs:
            raise ValueError(f"{self.kind}: neighbor list must be unique "
                             f"ranks excluding self, got {nbrs}")
        for i, q in enumerate(nbrs):
            self._send(engine, ep, role, q, self._payload_for(op, i), step)
        return (f"{self.kind}_wait", nbrs, {})

    def resolve(self, engine, ep, role, rank, pend):
        _, nbrs, got = pend
        for q in nbrs:
            if q not in got:
                m = engine.transport.match_recv(ep, q, self.tag)
                if m is not None:
                    got[q] = m.payload
        if len(got) < len(nbrs):
            return NOTHING
        return [got[q] for q in nbrs]


class NeighborAllgatherOp(_NeighborOp):
    """("neighbor_allgather", value, nbrs): every neighbor receives this
    rank's value; the result lists the neighbors' values in list order."""

    kind = "neighbor_allgather"
    tag = TAG_NEIGHBOR_ALLGATHER

    def _payload_for(self, op, i):
        return op[1]


class NeighborAlltoallOp(_NeighborOp):
    """("neighbor_alltoall", chunks, nbrs): chunks[i] goes to nbrs[i];
    the result lists the chunk each neighbor addressed to this rank."""

    kind = "neighbor_alltoall"
    tag = TAG_NEIGHBOR_ALLTOALL

    def post(self, engine, ep, role, rank, op, step):
        if len(op[1]) != len(op[2]):
            raise ValueError(
                f"neighbor_alltoall needs one chunk per neighbor "
                f"({len(op[2])}), got {len(op[1])}")
        return super().post(engine, ep, role, rank, op, step)

    def _payload_for(self, op, i):
        return op[1][i]


COLLECTIVE_OPS: Dict[str, CollectiveOp] = {
    op.kind: op for op in (AllreduceOp(), BarrierOp(), BcastOp(),
                           GatherOp(), ReduceScatterOp(), AlltoallOp(),
                           AllgatherOp(), ScanOp(),
                           NeighborAllgatherOp(), NeighborAlltoallOp())
}


class CollectiveEngine:
    """Registry-dispatched collective matching over a transport."""

    def __init__(self, transport: ReplicaTransport,
                 ops: Optional[Dict[str, CollectiveOp]] = None):
        self.transport = transport
        self.ops = dict(COLLECTIVE_OPS if ops is None else ops)
        self.n = transport.n
        # pending-descriptor head -> handler, built from THIS registry so
        # algorithm variants (topo.algorithms) resolve their own
        # pendings; switchboard ops share the "collective" head (the
        # handler is recovered from the key's kind)
        self._pending_owners: Dict[str, Optional[CollectiveOp]] = \
            {"collective": None}
        for op in self.ops.values():
            for head in op.pending_heads():
                self._pending_owners[head] = op
        # switchboard state: one SoA table per (kind, step, idx, …) key
        self.tables: Dict[tuple, _SwitchTable] = {}
        self.combined: Dict[tuple, Any] = {}
        self._role_views: Dict[str, Tuple] = {}
        self._view_masks: Dict[str, np.ndarray] = {}
        self._view_keys: Dict[str, str] = {}
        # optional observability hook (obs.ObsRecorder): transport
        # collectives mirror every post() as on_collective(kind, role,
        # rank, step, idx) with idx the endpoint's pre-post op_index;
        # switchboard instances instead emit one batch summary at
        # completion (on_collective_batch).  None (default) is one check.
        self.obs = None
        # batched resolution: keys of switchboard instances completed
        # since the last drain.  The scheduler drains take_completions()
        # after every switchboard post and wakes exactly those keys'
        # parked waiters (posts into incomplete instances wake nobody).
        self._completions: list = []

    # -- lifecycle ---------------------------------------------------------

    def begin_step(self) -> None:
        """Collectives match within a step; drop the previous step's
        tables (keys carry the step index, so this is pure GC) and reset
        per-endpoint op counters."""
        self.tables.clear()
        self.combined.clear()
        self._role_views.clear()
        self._completions.clear()
        for ep in self.transport.endpoints.values():
            ep.op_index = 0

    def world_changed(self) -> None:
        """Replica map mutated (promotion / drop / restart): role views and
        memoized combines are stale."""
        self._role_views.clear()
        self._view_masks.clear()
        self._view_keys.clear()
        self.combined.clear()

    def role_view(self, role: str) -> Tuple:
        """The §5 completion rule: which (role, rank) contributions form
        this role's allreduce result.  (Documentation/compat accessor —
        the hot path uses the boolean-mask form, ``_needs_rep``.)"""
        view = self._role_views.get(role)
        if view is None:
            rmap = self.transport.rmap
            view = tuple(  # repro: allow[per-rank-loop] -- compat accessor, not the hot path
                ("cmp", r) if role == "cmp" or rmap.rep[r] is None
                else ("rep", r)
                for r in range(self.n))
            self._role_views[role] = view
        return view

    def _needs_rep(self, role: str) -> np.ndarray:
        """``role_view`` as a boolean per-rank mask: True where the
        role's result takes the replica contribution (rep view, rank has
        a live replica).  Cached until the world changes."""
        mask = self._view_masks.get(role)
        if mask is None:
            n = self.n
            if role == "cmp":
                mask = np.zeros(n, dtype=bool)
            else:
                rep = self.transport.rmap.rep
                mask = np.fromiter((rep[r] is not None for r in range(n)),
                                   dtype=bool, count=n)
            self._view_masks[role] = mask
        return mask

    def view_key(self, role: str) -> str:
        """O(1) memo key for a role's combine — replaces hashing an
        N-tuple role view per resolve.  The rep view collapses to "cmp"
        while no rank has a live replica (the two views then select
        identical contributions)."""
        vk = self._view_keys.get(role)
        if vk is None:
            vk = "rep" if role != "cmp" and bool(self._needs_rep(role).any()) \
                else "cmp"
            self._view_keys[role] = vk
        return vk

    # -- switchboard tables ------------------------------------------------

    def intake(self, key: tuple, role: str, rank: int, value,
               store: bool) -> None:
        """Post one contribution into the instance's SoA table; the vote
        that completes the union queues the key for the scheduler's
        batched wake and emits the obs batch summary."""
        table = self.tables.get(key)
        if table is None:
            table = self.tables[key] = _SwitchTable(self.n)
        if table.post(role, rank, value, store):
            self._completions.append(key)
            if self.obs is not None:
                cmask = table.masks.get("cmp")
                rmask = table.masks.get("rep")
                self.obs.on_collective_batch(
                    key[0], key[1], key[2],
                    np.nonzero(cmask)[0].tolist()
                    if cmask is not None else (),
                    int(rmask.sum()) if rmask is not None else 0)

    def take_completions(self) -> list:
        """Drain the completed-instance keys queued since the last call."""
        if not self._completions:
            return []
        out = self._completions
        self._completions = []
        return out

    def combine_table(self, table: _SwitchTable, role: str, redop: str):
        """Materialize one role view's reduction from a completed table:
        a vectorized row select between the rep and cmp stacks, then one
        ``combine_stacked`` call (rank-ascending, bitwise-identical to
        the old per-worker fold).  Falls back to the sequential
        ``combine`` when a role holds object-path payloads or the two
        roles' stacks disagree on shape/dtype."""
        n = self.n
        cmask = table.masks.get("cmp")
        rmask = table.masks.get("rep")
        if rmask is None:
            take_rep = None
        else:
            have_cmp = cmask if cmask is not None \
                else np.zeros(n, dtype=bool)
            # the §5 view with promotion fallback in BOTH directions:
            # the rep view takes each replicated rank's rep vote when it
            # arrived (else the cmp twin's — same value by construction);
            # the cmp view takes rep only where cmp never voted
            take_rep = np.where(self._needs_rep(role), rmask, ~have_cmp)
        stack_c = table.stacks.get("cmp")
        stack_r = table.stacks.get("rep")
        if table.objs.get("cmp") is None and table.objs.get("rep") is None:
            if take_rep is None or not take_rep.any():
                return combine_stacked(redop, stack_c)
            if take_rep.all():
                return combine_stacked(redop, stack_r)
            if isinstance(stack_c, torch.Tensor) \
                    and isinstance(stack_r, torch.Tensor) \
                    and stack_c.shape == stack_r.shape \
                    and stack_c.dtype == stack_r.dtype \
                    and stack_c.device == stack_r.device:
                # the row select on the stacks' device (no host mask copy)
                sel = torch.stack([stack_r[r] if take_rep[r] else stack_c[r]
                                   for r in range(n)])
                return combine_stacked(redop, sel)
            if isinstance(stack_c, np.ndarray) \
                    and isinstance(stack_r, np.ndarray) \
                    and stack_c.shape == stack_r.shape \
                    and stack_c.dtype == stack_r.dtype:
                sel = np.where(
                    take_rep.reshape((n,) + (1,) * (stack_c.ndim - 1)),
                    stack_r, stack_c)
                return combine_stacked(redop, sel)
        values = []
        for r in range(n):                  # object-path slow fallback
            src = "rep" if take_rep is not None and take_rep[r] else "cmp"
            objs = table.objs.get(src)
            values.append(objs[r] if objs is not None
                          else table.stacks[src][r])
        return combine(redop, values)

    # -- dispatch ----------------------------------------------------------

    def owns(self, kind: str) -> bool:
        return kind in self.ops

    def owns_pending(self, pend: tuple) -> bool:
        return pend[0] in self._pending_owners

    def post(self, ep: Endpoint, op: tuple, step: int) -> tuple:
        handler = self.ops.get(op[0])
        if handler is None:
            raise ValueError(f"unknown collective {op[0]!r}")
        role, rank = self.transport.role_of(ep)
        # capture op_index BEFORE the handler advances it: this is the
        # instance index the collective is keyed by
        idx = ep.op_index
        pend = handler.post(self, ep, role, rank, op, step)
        if self.obs is not None and pend[0] != "collective":
            # transport collectives mirror per post; switchboard
            # instances ("collective" head) report once, at completion
            # (on_collective_batch via intake) — not 2N per-post calls
            self.obs.on_collective(op[0], role, rank, step, idx)
        return pend

    def resolve(self, ep: Endpoint, pend: tuple):
        head = pend[0]
        handler = self._pending_owners.get(head)
        if handler is None and head == "collective":
            handler = self.ops[pend[1][0]]
        if handler is None:
            raise ValueError(f"unknown pending {head!r}")
        role, rank = self.transport.role_of(ep)
        return handler.resolve(self, ep, role, rank, pend)


# --------------------------------------------------------------------------
# failure-free reference matcher (sequential resolvers, tests)
# --------------------------------------------------------------------------

class ReferenceCollectives:
    """Single-process collective matcher with straight-line semantics —
    the resolver the JAX package's SimAppWorkload runs its apps on. No
    roles, no replication, no messages: contributions keyed per (kind,
    instance), results from ``reference_result``.

    Allreduce intake shares the engine's SoA machinery: contributions go
    into a single-role ``_SwitchTable`` and reduce through the same
    ``combine_stacked`` kernel (memoized per instance) instead of a
    per-rank dict plus one combine per resolver."""

    def __init__(self, n: int):
        self.n = n
        self.contrib: Dict[tuple, Dict[int, Any]] = {}
        self.meta: Dict[tuple, Any] = {}
        # per-rank op-index cursors as one int array (not a dict)
        self.op_index = np.zeros(n, dtype=np.int64)
        self.tables: Dict[tuple, _SwitchTable] = {}
        self._memo: Dict[tuple, Any] = {}

    def begin_step(self) -> None:
        """Optional per-step GC mirroring the engine: callers that key
        instances per step may drop the previous step's tables."""
        self.contrib.clear()
        self.meta.clear()
        self.tables.clear()
        self._memo.clear()
        self.op_index[:] = 0

    def post(self, rank: int, op: tuple) -> tuple:
        """Record rank's contribution; returns the pending descriptor."""
        kind = op[0]
        idx = int(self.op_index[rank])
        self.op_index[rank] = idx + 1
        if kind == "allreduce":
            _, value, redop = op
            key = (kind, idx, redop)
            table = self.tables.get(key)
            if table is None:
                table = self.tables[key] = _SwitchTable(self.n)
            table.post("cmp", rank, value, store=True)
            self.meta[key] = redop
            return ("collective", key)
        if kind == "barrier":
            key, value, meta = (kind, idx), True, None
        elif kind in ("reduce_scatter", "scan"):
            _, value, redop = op
            key, meta = (kind, idx, redop), redop
        elif kind in ("bcast", "gather"):
            _, value, root = op
            key, meta = (kind, idx, root), root
        elif kind in ("allgather", "alltoall"):
            key, value, meta = (kind, idx), op[1], None
        elif kind in ("neighbor_allgather", "neighbor_alltoall"):
            # the vote carries (payload, neighbor list): reference_result
            # reconstructs who addressed what to whom from the lists
            key, value, meta = (kind, idx), (op[1], tuple(op[2])), None
        else:
            raise ValueError(f"unknown collective {kind!r}")
        if kind != "barrier":
            value = structural_copy(value)
        self.contrib.setdefault(key, {})[rank] = value
        self.meta[key] = meta
        return ("collective", key)

    def resolve(self, rank: int, pend: tuple):
        _, key = pend
        table = self.tables.get(key)
        if table is not None:                # allreduce: SoA fast path
            if not table.complete:
                return NOTHING
            out = self._memo.get(key)
            if out is None:
                stack = table.stacks.get("cmp")
                if stack is not None:
                    out = combine_stacked(self.meta[key], stack)
                else:
                    out = combine(self.meta[key], list(table.objs["cmp"]))
                self._memo[key] = out
            return copy_array(out) if is_array(out) else out
        votes = self.contrib.get(key, {})
        if len(votes) < self.n:
            return NOTHING
        return reference_result(key[0], votes, rank, self.n, self.meta[key])
