"""The port's replica-aware fabric against the JAX package's, bitwise.

``repro_torch.core.message_log``, ``repro_torch.comm`` (payload capture,
transport, recovery, collectives) are copies of their ``repro``
counterparts that take ``torch.Tensor`` payloads wherever the reference
takes ndarrays. Every test here feeds the same numpy-made inputs to the
reference (as ndarrays) and to the port (as CPU tensors) and compares the
results exactly: the paths are integer bookkeeping or fixed-order
elementwise folds, so the tolerance is zero.

Worlds are driven by ``repro_torch.comm.worlds.run_world`` — the
post/resolve loop of ``BatchFanout.fan_out`` over many workers and steps,
with a kill between two rounds — which takes either package's classes;
the comm phase of ``chip_smoke.py`` runs worlds of the same kind on the
card. The ``cuda`` cases skip without a card.
"""
import types

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro.comm as ref_comm
from repro.clock import pricing_from_ft as ref_pricing_from_ft
from repro.comm.collectives import ReferenceCollectives as RefReference
from repro.comm.collectives import combine_stacked as ref_combine_stacked
from repro.configs.base import FTConfig as RefFTConfig
from repro.core.coordinator import ClusterTopology as RefClusterTopology
from repro.core.message_log import ReceiverCursor as RefCursor
from repro.core.message_log import SenderLog as RefSenderLog
from repro.core.message_log import payload_nbytes as ref_payload_nbytes
from repro.core.replica_map import ReplicaMap as RefReplicaMap
from repro_torch import comm
from repro_torch.comm.collectives import (ReferenceCollectives, combine,
                                          combine_stacked)
from repro_torch.comm.payload import freeze_payload, structural_copy
from repro_torch.comm.worlds import (PORT_FABRIC, CommZoo, canon, run_world,
                                     tensor_maker)
from repro_torch.core.message_log import (LoggedMessage, ReceiverCursor,
                                          SenderLog, payload_nbytes)
from repro_torch.core.replica_map import ReplicaMap
from repro_torch.topo import ring_neighbors

REF_FABRIC = types.SimpleNamespace(
    ReplicaMap=RefReplicaMap, ReplicaTransport=ref_comm.ReplicaTransport,
    CollectiveEngine=ref_comm.CollectiveEngine,
    RecoveryManager=ref_comm.RecoveryManager, NOTHING=ref_comm.NOTHING,
    P2P_OPS=ref_comm.P2P_OPS, ClusterTopology=RefClusterTopology,
    FTConfig=RefFTConfig, pricing_from_ft=ref_pricing_from_ft)

DTYPE_NAMES = ("bfloat16", "bool", "complex64", "float16", "float32",
               "float64", "int16", "int32", "int64", "int8", "uint8")
TORCH_DTYPES = {name: getattr(torch, name) for name in DTYPE_NAMES}

# the collective worlds: 5 ranks, 2 replicated, 3 steps; rank 1's
# computational worker dies after the second round of step 1, with the
# step's transport collectives in flight
ZOO_N, ZOO_M, ZOO_STEPS = 5, 2, 3
ZOO_KILL = (1, 2, 1)
# below the 24 bytes of a (6,) f32 payload, so the priced worlds take the
# ring allreduce and ring reduce_scatter beside the trees
ZOO_SMALL_MSG = 16


def np_dtype(name):
    """The numpy dtype of ``name``; bf16 is ml_dtypes' (imported here, so
    the card-only cases collect where ml_dtypes is not installed)."""
    if name == "bfloat16":
        import ml_dtypes
        return ml_dtypes.bfloat16
    return np.dtype(name).type


def array_maker(dtype_name):
    """numpy values -> an ndarray of ``dtype_name`` (bf16 through f32,
    as ``tensor_maker`` rounds it)."""
    dt = np_dtype(dtype_name)

    def make(a):
        a = np.asarray(a)
        if dtype_name == "bfloat16":
            a = a.astype(np.float32)
        return a.astype(dt)
    return make


def both(x):
    """(ndarray, CPU tensor) of the same data."""
    return x, torch.from_numpy(np.array(x))


def assert_same_world(ours, theirs):
    assert canon(ours["states"]) == canon(theirs["states"])
    for key in ("logs", "comm_s", "promotions", "replays",
                "duplicates_skipped", "messages"):
        assert ours[key] == theirs[key], key


# ------------------------------------------------------------ message_log

def _deliver(cursor, m):
    """should_deliver, with a gap (a message the cap trimmed away) as a
    result of its own."""
    try:
        return cursor.should_deliver(m)
    except RuntimeError as e:
        return str(e)


@given(n_msgs=st.integers(1, 40), consumed=st.integers(0, 40),
       dup_rounds=st.integers(1, 3))
@settings(max_examples=100, deadline=None)
def test_log_and_cursor_match_the_reference_under_replay(n_msgs, consumed,
                                                         dup_rounds):
    """``test_message_log.py``'s exactly-once schedule, run through both
    copies with numpy payloads on one side and tensors on the other, on
    two tags and a memory cap that trims: the same send-IDs, replay sets,
    skips, trims and state."""
    rng = np.random.default_rng([n_msgs, consumed, dup_rounds])
    logs = (SenderLog(0, limit_bytes=64 * 8 * 6),
            RefSenderLog(0, limit_bytes=64 * 8 * 6))
    curs = (ReceiverCursor(1), RefCursor(1))
    sids = ([], [])
    for i in range(n_msgs):
        a, t = both(rng.standard_normal(int(rng.integers(1, 64))))
        tag = int(rng.integers(0, 2))
        for k, payload in enumerate((t, a)):
            sids[k].append(logs[k].record(1, tag, payload, step=i // 4))
    assert sids[0] == sids[1]
    seen = ([], [])
    for k in range(2):
        for m in logs[k].log[:min(consumed, len(logs[k].log))]:
            seen[k].append((m.tag, m.send_id, _deliver(curs[k], m)))
        for _ in range(dup_rounds):
            for m in logs[k].replay_for(1, dict(curs[k].expected)):
                seen[k].append((m.tag, m.send_id, _deliver(curs[k], m)))
    assert seen[0] == seen[1]
    for attr in ("bytes", "removal_events", "recorded_msgs",
                 "recorded_bytes", "next_send_id"):
        assert getattr(logs[0], attr) == getattr(logs[1], attr), attr
    assert curs[0].expected == curs[1].expected
    assert curs[0].skipped == curs[1].skipped
    for k in range(2):
        logs[k].trim_before_step(n_msgs // 8)
    assert [(m.tag, m.send_id, m.step) for m in logs[0].log] == \
        [(m.tag, m.send_id, m.step) for m in logs[1].log]
    assert logs[0].bytes == logs[1].bytes
    copies = (SenderLog(0), RefSenderLog(0))
    for k in range(2):
        copies[k].load_state(logs[k].state())
        curs[k].load_state(curs[k].state())
    assert copies[0].record(1, 0, 1.0, step=99) == \
        copies[1].record(1, 0, 1.0, step=99)
    assert canon([m.payload for m in copies[0].log]) == \
        canon([m.payload for m in copies[1].log])


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("shape", [(), (1,), (3, 5), (2, 0, 4)])
def test_payload_nbytes_of_a_tensor_is_its_arrays(dtype, shape):
    a = array_maker(dtype)(np.ones(shape))
    t = tensor_maker(TORCH_DTYPES[dtype], "cpu")(np.ones(shape))
    assert payload_nbytes(t) == a.nbytes == ref_payload_nbytes(a)
    assert payload_nbytes((t, {"k": [t]})) == \
        ref_payload_nbytes((a, {"k": [a]}))
    if dtype == "bfloat16":
        assert payload_nbytes(t) == 2 * t.numel()


# ---------------------------------------------------------------- payload

def test_tensor_capture_is_a_clone_and_numpy_is_frozen():
    t = torch.arange(6.0).reshape(2, 3)
    box, frozen = freeze_payload({"x": t, "rest": [t[0], 3]})
    assert frozen
    got = box["x"]
    assert torch.equal(got, t)
    assert got.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()
    t.add_(1)
    assert torch.equal(got, torch.arange(6.0).reshape(2, 3))
    for mutable in (False, True):
        c = structural_copy(got, mutable=mutable)
        assert torch.equal(c, got) and c.data_ptr() != got.data_ptr()
    a = np.arange(3.0)
    out, frozen = freeze_payload(a)
    assert frozen and out is a and not a.flags.writeable


class _Unclonable(torch.Tensor):
    @classmethod
    def __torch_function__(cls, func, types_, args=(), kwargs=None):
        if func is torch.Tensor.clone:
            raise RuntimeError("this tensor cannot be copied")
        return super().__torch_function__(func, types_, args, kwargs or {})


def test_a_tensor_that_cannot_be_captured_raises():
    t = torch.zeros(3).as_subclass(_Unclonable)
    with pytest.raises(TypeError, match="refusing to share"):
        freeze_payload([t])


def test_sender_mutation_leaves_log_and_deliveries_unchanged():
    """Rank 1 (unreplicated) sends a tensor to rank 0 (replicated): the
    log, the cmp delivery and the intercomm fill-in hold the value at the
    send, after the sender rewrites its tensor."""
    rmap = ReplicaMap(2, 1)
    t = comm.ReplicaTransport(rmap, 2)
    eps = {w: t.register(w) for w in rmap.alive()}
    x = torch.arange(8, dtype=torch.int32)
    t.send(eps[rmap.cmp[1]], 0, 5, x, 0, log=True)
    x.mul_(-1)
    want = torch.arange(8, dtype=torch.int32)
    logged = t.send_logs[1].log[0].payload
    cmp_copy = t.match_recv(eps[rmap.cmp[0]], 1, 5).payload
    rep_copy = t.match_recv(eps[rmap.rep[0]], 1, 5).payload
    assert all(torch.equal(p, want) for p in (logged, cmp_copy, rep_copy))


def _storage(t):
    return t.untyped_storage().data_ptr()


def test_receiver_writes_leave_the_log_replay_and_twin_unchanged():
    """A tensor delivery is the receiver's own: the cmp copy, the
    intercomm fill-in, the log and every replay hold distinct storage, and
    a receiver that writes into its copy changes none of the others."""
    rmap = ReplicaMap(2, 1)
    t = comm.ReplicaTransport(rmap, 2)
    eps = {w: t.register(w) for w in rmap.alive()}
    want = torch.arange(8, dtype=torch.int32)
    t.send(eps[rmap.cmp[1]], 0, 5, want.clone(), 0, log=True)
    logged = t.send_logs[1].log[0].payload
    cmp_copy = t.resolve(eps[rmap.cmp[0]], ("recv", 1, 5))
    rep_copy = t.resolve(eps[rmap.rep[0]], ("recv", 1, 5))
    assert len({_storage(x) for x in (logged, cmp_copy, rep_copy)}) == 3
    cmp_copy.mul_(-1)
    assert torch.equal(rep_copy, want) and torch.equal(logged, want)
    recovery = comm.RecoveryManager(t)
    replayed = []
    for _ in range(2):
        fresh = t.register(rmap.rep[0])          # a restarted endpoint
        assert recovery.replay_to(fresh) == 1
        got = t.resolve(fresh, ("recv", 1, 5))
        assert torch.equal(got, want)
        replayed.append(got)
        got.add_(100)
    assert _storage(replayed[0]) != _storage(replayed[1]) != _storage(logged)
    assert torch.equal(logged, want) and torch.equal(rep_copy, want)


@pytest.mark.parametrize("mutable_recv", [False, True])
def test_mutable_recv_matches_the_reference(mutable_recv):
    """The opt-in hands a numpy recv a private writeable copy, as the
    reference does; a tensor recv is writeable and private either way."""
    outs = []
    for fab, payload in ((PORT_FABRIC, np.arange(4.0)),
                         (REF_FABRIC, np.arange(4.0)),
                         (PORT_FABRIC, torch.arange(4.0))):
        rmap = fab.ReplicaMap(2, 0)
        t = fab.ReplicaTransport(rmap, 2, mutable_recv=mutable_recv)
        eps = {w: t.register(w) for w in rmap.alive()}
        t.send(eps[rmap.cmp[0]], 1, 7, payload, 0, log=True)
        out = t.resolve(eps[rmap.cmp[1]], ("recv", 0, 7))
        logged = t.send_logs[0].log[0].payload
        if isinstance(out, np.ndarray):
            outs.append((out.flags.writeable, out is logged))
            if mutable_recv:
                out[:] = 0.0
        else:
            assert _storage(out) != _storage(logged)
            out.zero_()
        assert canon(logged) == canon(np.arange(4.0)) or \
            torch.equal(logged, torch.arange(4.0))
    assert outs[0] == outs[1] == (mutable_recv, not mutable_recv)


# -------------------------------------------------------------- transport

class P2PZoo:
    """One step of point-to-point traffic: a ring send/recv, a neighbour
    exchange, and an MPI_ANY_SOURCE hub at rank 0 (its result in arrival
    order, which the cmp picks and forwards to its replica)."""

    def __init__(self, n, make, seed=0):
        self.n, self.make, self.seed = n, make, seed
        self.nbrs = ring_neighbors(n)

    def value(self, rank, t, k):
        rng = np.random.default_rng([self.seed, rank, t, k])
        return self.make(rng.uniform(-2.0, 2.0, (3,)))

    def init_state(self, rank):
        return {"outs": []}

    def step(self, rank, state, t):
        n, v, outs = self.n, self.value, state["outs"]
        if n > 1:
            yield ("send", (rank + 1) % n, 1, (rank, v(rank, t, 0)))
            outs.append((yield ("recv", (rank - 1) % n, 1)))
            outs.append((yield ("exchange",
                                {q: {"v": v(rank, t, 1 + q)}
                                 for q in self.nbrs[rank]}, 2)))
        if rank == 0:
            for _ in range(n - 1):
                src, got = yield ("recv_any", 3)
                outs.append((src, got))
        else:
            yield ("send", 0, 3, [v(rank, t, 9), rank])
        return state

    def check(self, states, steps):
        """The p2p semantics straight: what each rank must have got."""
        n, v = self.n, self.value
        for r in range(n):
            outs = iter(states[r]["outs"])
            for t in range(steps):
                if n > 1:
                    left = (r - 1) % n
                    assert canon(next(outs)) == canon((left, v(left, t, 0)))
                    assert canon(next(outs)) == canon(
                        {q: {"v": v(q, t, 1 + r)} for q in self.nbrs[r]})
                if r == 0:
                    hub = dict(next(outs) for _ in range(n - 1))
                    assert canon(hub) == canon(
                        {s: [v(s, t, 9), s] for s in range(1, n)})


P2P_WORLDS = [(2, 1, ()), (2, 1, [(1, 2, 0)]), (3, 2, ()),
              (3, 2, [(1, 2, 0)]), (3, 2, [(1, 1, 1)]), (5, 2, ()),
              (5, 2, [(1, 2, 0)]), (5, 3, [(2, 3, 2)]), (5, 5, [(0, 1, 4)]),
              # test_comm_layer.py's wildcard hub: both copies promoted
              (4, 4, [(1, 2, 0), (3, 2, 2)])]


@pytest.mark.parametrize("n,m,kills", P2P_WORLDS)
def test_p2p_schedules_match_the_reference(n, m, kills):
    """Partial replication exercises the intercomm fill-in (unreplicated
    sender, replicated receiver) and the replica-side skip; killing rank
    0's computational worker promotes the hub's replica, which must follow
    the forwarded wildcard order; every kill is repaired by drain and
    replay."""
    steps = 4
    ours = run_world(PORT_FABRIC, P2PZoo(n, tensor_maker(torch.float32,
                                                         "cpu")),
                     n, m, steps, kills=kills)
    theirs = run_world(REF_FABRIC, P2PZoo(n, array_maker("float32")),
                       n, m, steps, kills=kills)
    assert_same_world(ours, theirs)
    P2PZoo(n, array_maker("float32")).check(theirs["states"], steps)
    assert ours["promotions"] == len(kills)


def test_duplicate_replay_is_skipped_like_the_reference():
    """A replay burst delivered twice: the second copy of every message is
    skipped by send-ID, the same count on both sides."""
    counts = []
    for fab, make in ((PORT_FABRIC, tensor_maker(torch.int64, "cpu")),
                      (REF_FABRIC, array_maker("int64"))):
        rmap = fab.ReplicaMap(2, 1)
        t = fab.ReplicaTransport(rmap, 2)
        eps = {w: t.register(w) for w in rmap.alive()}
        for i in range(4):
            t.send(eps[rmap.cmp[1]], 0, 7, make(np.arange(3) + i), 0,
                   log=True)
        ep = eps[rmap.rep[0]]
        first = t.match_recv(ep, 1, 7)
        replay = t.send_logs[1].replay_for(0, ep.cursor.expected)
        t.deliver_bulk(ep, replay)
        t.deliver_bulk(ep, replay)
        got = [first.payload] + [t.match_recv(ep, 1, 7).payload
                                 for _ in range(3)]
        assert t.match_recv(ep, 1, 7) is None
        counts.append((t.duplicates_skipped, canon(got)))
    assert counts[0] == counts[1]
    assert counts[0][0] == 6


def test_snapshot_and_load_rank_match_the_reference():
    """A rank's comm checkpoint (log, cursor, wildcard order, counters)
    after a world, loaded into a fresh transport."""
    snaps = []
    for fab, make in ((PORT_FABRIC, tensor_maker(torch.float32, "cpu")),
                      (REF_FABRIC, array_maker("float32"))):
        rmap = fab.ReplicaMap(3, 3)
        t = fab.ReplicaTransport(rmap, 3)
        eps = {w: t.register(w) for w in rmap.alive()}
        for r in (1, 2):
            for w in (rmap.cmp[r], rmap.rep[r]):
                t.post(eps[w], ("send", 0, 3, make(np.ones(2) * r)), 0)
        for w in (rmap.cmp[0], rmap.rep[0]):
            for _ in range(2):
                t.resolve(eps[w], ("recv_any", 3))
        t.trim_wildcards(0)
        snap = t.snapshot_rank(0, eps[rmap.cmp[0]])
        fresh = fab.ReplicaTransport(rmap, 3)
        ep = fresh.register(rmap.cmp[0])
        fresh.load_rank(0, ep, snap)
        snaps.append([canon(fresh.snapshot_rank(0, ep)),
                      ep.wc_consumed, dict(ep.send_counters), t.wc_base[0],
                      list(eps[rmap.rep[0]].wc_matches)])
    assert snaps[0] == snaps[1]


# ------------------------------------------------------------ collectives

REDOPS = ("sum", "min", "max", "prod")
SOA_DTYPES = ("float32", "float64", "int64", "bool")


def soa_payloads(n, steps, dtype, shape=(5,), seed=0):
    """``test_collective_soa.payloads``: per-(rank, step) contributions,
    dtype-ranged so prod stays representable, bool a real mix."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, n, steps]))
    out = {}
    for t in range(steps):
        for r in range(n):
            if dtype == "bool":
                v = rng.integers(0, 2, size=shape).astype(np.bool_)
            elif dtype == "int64":
                v = rng.integers(1, 5, size=shape).astype(np.int64)
            else:
                v = rng.uniform(0.5, 2.0, size=shape).astype(np_dtype(dtype))
            out[(t, r)] = v
    return out


class AllreduceProbe:
    """``test_collective_soa.AllreduceProbe``: per step one allreduce, one
    bcast (real p2p traffic for a kill to drain and replay) and a
    barrier."""

    def __init__(self, n, pay, redop):
        self.n, self.pay, self.redop = n, pay, redop

    def init_state(self, rank):
        return {"outs": []}

    def step(self, rank, state, t):
        out = yield ("allreduce", self.pay[(t, rank)], self.redop)
        root = t % self.n
        b = yield ("bcast", self.pay[(t, root)], root)
        yield ("barrier",)
        state["outs"].append((out, b))
        return state


def soa_world(n, redop, dtype, m, steps, kills=()):
    pay = soa_payloads(n, steps, dtype)
    tpay = {k: torch.from_numpy(v.copy()) for k, v in pay.items()}
    ours = run_world(PORT_FABRIC, AllreduceProbe(n, tpay, redop), n, m,
                     steps, kills=kills)
    theirs = run_world(REF_FABRIC, AllreduceProbe(n, pay, redop), n, m,
                       steps, kills=kills)
    assert_same_world(ours, theirs)
    for t in range(steps):
        vecs = [pay[(t, r)] for r in range(n)]
        tvecs = [tpay[(t, r)] for r in range(n)]
        ref, port = RefReference(n), ReferenceCollectives(n)
        pr = [ref.post(r, ("allreduce", vecs[r], redop)) for r in range(n)]
        pp = [port.post(r, ("allreduce", tvecs[r], redop))
              for r in range(n)]
        for r in range(n):
            want = ref.resolve(r, pr[r])
            assert canon(port.resolve(r, pp[r])) == canon(want)
            got, b = ours["states"][r]["outs"][t]
            assert isinstance(got, torch.Tensor)
            assert canon(got) == canon(want)
            assert canon(b) == canon(pay[(t, t % n)])
            assert canon(comm.reference_result(
                "allreduce", dict(enumerate(tvecs)), r, n, redop)) == \
                canon(ref_comm.reference_result(
                    "allreduce", dict(enumerate(vecs)), r, n, redop))
    return ours


@pytest.mark.parametrize("redop", REDOPS)
@pytest.mark.parametrize("dtype", SOA_DTYPES)
@pytest.mark.parametrize("n,rep", [(1, 1.0), (2, 1.0), (5, 0.5),
                                   (8, 1.0)])
def test_soa_matches_the_reference(redop, dtype, n, rep):
    """``test_collective_soa.py``'s sweep: the port's SoA switchboard on
    CPU tensors gives the reference engine's and ReferenceCollectives'
    bits, for every redop x dtype x (world, replication)."""
    soa_world(n, redop, dtype, int(round(rep * n)), steps=2)


@pytest.mark.parametrize("redop", ("sum", "prod"))
@pytest.mark.parametrize("dtype", ("float64", "int64"))
@pytest.mark.parametrize("rep", (0.5, 1.0))
def test_soa_matches_the_reference_under_kill(redop, dtype, rep):
    """The sweep's kill cases: a computational worker dies mid-collective
    (rank 1's — replicated at both degrees; an unreplicated death would be
    a restart, which ``run_world`` does not do), its replica is promoted,
    drained and replayed; every rank's history stays the reference's."""
    out = soa_world(5, redop, dtype, int(round(rep * 5)), steps=4,
                    kills=[(1, 1, 1)])
    assert out["promotions"] == 1


def zoo_world(fab, make, dtype, redop, kills=(), topology=None):
    """One collective world: the zoo of every op on ZOO_N ranks."""
    app = CommZoo(ZOO_N, make, redop=redop, integer=dtype == "int64")
    return app, run_world(fab, app, ZOO_N, ZOO_M, ZOO_STEPS, kills=kills,
                          topology=topology, small_msg=ZOO_SMALL_MSG)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "int64"))
@pytest.mark.parametrize("redop", ("sum", "max"))
@pytest.mark.parametrize("kills", [(), [ZOO_KILL]], ids=["clean", "kill"])
@pytest.mark.parametrize("topology", [None, "fattree"])
def test_every_collective_matches_the_reference(dtype, redop, kills,
                                                topology):
    """Every op of COLLECTIVE_OPS (the comm phase's world: 5 ranks, 2
    replicated), with the dense registry and with the fattree one (trees,
    rings, α‑β pricing): the port on CPU tensors against the reference
    on ndarrays — results, logs, recovery counts and priced seconds — and
    both against reference_result wherever the order of the reduction
    cannot change the bits."""
    app, ours = zoo_world(PORT_FABRIC, tensor_maker(TORCH_DTYPES[dtype],
                                                    "cpu"),
                          dtype, redop, kills, topology)
    ref_app, theirs = zoo_world(REF_FABRIC, array_maker(dtype), dtype, redop,
                                kills, topology)
    assert_same_world(ours, theirs)
    assert sorted(comm.COLLECTIVE_OPS) == sorted(ref_comm.COLLECTIVE_OPS)
    if topology is None or redop == "max" or dtype == "int64":
        for r in range(ZOO_N):
            want = [x for t in range(ZOO_STEPS)
                    for x in ref_app.expected(ref_comm.reference_result, r,
                                              t)]
            assert canon(ours["states"][r]["outs"]) == canon(want)
    assert (sum(ours["comm_s"]) > 0) == (topology is not None)
    if kills:
        assert ours["promotions"] == 1 and ours["replays"] > 0


# ------------------------------------------------- combine: numpy's bits

@pytest.mark.parametrize("dtype", ("float16", "float32", "float64",
                                   "bfloat16"))
@pytest.mark.parametrize("n", [1, 3, 7, 8, 9, 16, 17, 40, 129, 300])
@pytest.mark.parametrize("row", [(1,), (1, 1), (4,), (2, 3)])
def test_stacked_sum_is_numpys_reduce(dtype, n, row):
    """A stacked float sum gives ``np.add.reduce(axis=0)``'s bits: a
    multi-element row is a fold from +0.0 in rank order, a single-element
    row numpy's pairwise sum (float16 accumulated in float32)."""
    rng = np.random.default_rng([n, len(row)])
    a = array_maker(dtype)(rng.standard_normal((n,) + row)
                           * 10.0 ** rng.integers(-3, 3, (n,) + row))
    t = tensor_maker(TORCH_DTYPES[dtype], "cpu")(np.asarray(a, np.float64))
    assert canon(combine_stacked("sum", t)) == \
        canon(ref_combine_stacked("sum", a))
    assert canon(combine("sum", list(t))) == \
        canon(ref_comm.combine("sum", list(a)))


@pytest.mark.parametrize("dtype", ("bool", "int8", "int16", "int32",
                                   "uint8", "int64"))
@pytest.mark.parametrize("redop", REDOPS)
def test_stacked_integers_take_numpys_dtype(dtype, redop):
    """numpy adds and multiplies narrow integers and bools in 64 bits
    (uint64 for unsigned): the same dtype and bits from a tensor."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 60, (9, 4)).astype(np_dtype(dtype))
    t = torch.from_numpy(a.copy())
    assert canon(combine_stacked(redop, t)) == \
        canon(ref_combine_stacked(redop, a))


def test_negative_zero_sums_like_numpy():
    for shape in ((3, 2), (3, 1)):
        a = np.full(shape, -0.0)
        assert canon(combine_stacked("sum", torch.from_numpy(a.copy()))) \
            == canon(ref_combine_stacked("sum", a))


def test_mixed_payloads_demote_like_the_reference():
    """``test_collective_soa.py``'s mixed case: ranks disagreeing on shape
    and dtype demote the stack to the object path on both sides."""
    n = 4
    mixed = {(0, 0): np.float64(2.0), (0, 1): np.arange(3.0) + 1.0,
             (0, 2): np.arange(3, dtype=np.float32) + 2.0, (0, 3): 0.5}
    tmixed = {k: torch.from_numpy(v.copy()) if isinstance(v, np.ndarray)
              else v for k, v in mixed.items()}
    ours = run_world(PORT_FABRIC, AllreduceProbe(n, tmixed, "sum"), n, n, 1)
    theirs = run_world(REF_FABRIC, AllreduceProbe(n, mixed, "sum"), n, n, 1)
    got = [canon(ours["states"][r]["outs"][0][0]) for r in range(n)]
    want = [canon(theirs["states"][r]["outs"][0][0]) for r in range(n)]
    assert got == want


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "int64"))
@pytest.mark.parametrize("topology", [None, "fattree"])
def test_card_worlds_equal_the_cpu(dtype, topology):
    """The comm phase's worlds on card tensors: results, logs, recovery
    counts and priced seconds bitwise the CPU run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    for redop in ("sum", "max"):
        _, card = zoo_world(PORT_FABRIC,
                            tensor_maker(TORCH_DTYPES[dtype], "cuda"),
                            dtype, redop, [ZOO_KILL], topology)
        _, cpu = zoo_world(PORT_FABRIC,
                           tensor_maker(TORCH_DTYPES[dtype], "cpu"),
                           dtype, redop, [ZOO_KILL], topology)
        assert_same_world(card, cpu)
        assert all(x[2].is_cuda for x in card["states"][0]["outs"]
                   if isinstance(x[2], torch.Tensor))


@pytest.mark.cuda
def test_card_allreduce_is_bitwise_the_cpus():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    rng = np.random.default_rng(0)
    for n in (3, 8, 9, 40):
        for row in ((1,), (4096,)):
            a = rng.standard_normal((n,) + row).astype(np.float32)
            for redop in ("sum", "max"):
                want = ref_combine_stacked(redop, a)
                cpu = combine_stacked(redop, torch.from_numpy(a.copy()))
                card = combine_stacked(redop, torch.from_numpy(a).cuda())
                assert card.is_cuda
                assert canon(card) == canon(cpu) == canon(want)


def test_message_log_prices_a_logged_tensor_message():
    m = LoggedMessage(0, 1, 0, 3, torch.zeros(4, 512, dtype=torch.int32), 0)
    assert m.nbytes() == 4 * 512 * 4
