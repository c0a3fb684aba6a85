"""Drive worlds of workers through the replica-aware fabric.

``run_world`` is a step scheduler over a transport, a collective engine
and a recovery manager: the post/resolve loop ``BatchFanout.fan_out``
runs, for many workers and steps, with kills applied between two rounds.
It takes the fabric's classes as a namespace (``PORT_FABRIC`` holds this
package's), so one scheduler drives any implementation of the same
interfaces and their results can be compared with ``canon``.
``CommZoo`` is an app whose step runs every collective of
``COLLECTIVE_OPS`` once; ``tensor_maker`` turns its numpy-made values
into tensors of a dtype on a device.  The simulated runtime, which
schedules apps with a ready queue, virtual time and checkpoints, is a
later port.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from repro_torch import comm as comm_lib
from repro_torch.clock import pricing_from_ft
from repro_torch.configs.base import FTConfig
from repro_torch.core.coordinator import ClusterTopology
from repro_torch.core.replica_map import ReplicaMap
from repro_torch.topo import ring_neighbors

PORT_FABRIC = types.SimpleNamespace(
    ReplicaMap=ReplicaMap, ReplicaTransport=comm_lib.ReplicaTransport,
    CollectiveEngine=comm_lib.CollectiveEngine,
    RecoveryManager=comm_lib.RecoveryManager, NOTHING=comm_lib.NOTHING,
    P2P_OPS=comm_lib.P2P_OPS, ClusterTopology=ClusterTopology,
    FTConfig=FTConfig, pricing_from_ft=pricing_from_ft)


class _Worker:
    __slots__ = ("ep", "state", "gen", "pending", "done")

    def __init__(self, ep, state):
        self.ep, self.state = ep, state
        self.gen = self.pending = None
        self.done = False


def run_world(fab, app, n, m, steps, kills=(), topology=None,
              small_msg=8192):
    """Run ``app`` (``init_state(rank)``, generator ``step(rank, state,
    t)``) on ``n`` ranks, ``m`` of them replicated, for ``steps`` steps.
    Each round attempts every live worker once in worker order; each kill
    ``(step, round, worker)`` fails the worker after that round, promotes
    its replica and repairs it (drain, then replay). With ``topology`` every
    message is priced and the engine takes the selecting registry. Returns
    the computational workers' final states, the priced comm seconds of
    each step, the sender logs and the recovery counts."""
    rmap = fab.ReplicaMap(n, m)
    cost_model = ops = None
    if topology is not None:
        pricing = fab.pricing_from_ft(
            fab.FTConfig(topology=topology, topo_small_msg=small_msg),
            fab.ClusterTopology(rmap.world_size, 2))
        cost_model, ops = pricing.cost_model, pricing.engine_ops
    transport = fab.ReplicaTransport(rmap, n, cost_model=cost_model)
    engine = fab.CollectiveEngine(transport, ops=ops)
    recovery = fab.RecoveryManager(transport)
    workers = {w: _Worker(transport.register(w),
                          app.init_state(rmap.role_of(w)[1]))
               for w in rmap.alive()}
    comm_s, promotions = [], 0
    for t in range(steps):
        engine.begin_step()
        for w, wk in workers.items():
            wk.gen = app.step(rmap.role_of(w)[1], wk.state, t)
            wk.pending, wk.done = None, False
        rnd = 0
        while True:
            progressed, activity = False, transport.activity
            for w in sorted(workers):
                wk = workers[w]
                if wk.done:
                    continue
                val = None
                if wk.pending is not None:
                    owner = transport if transport.owns_pending(wk.pending) \
                        else engine
                    val = owner.resolve(wk.ep, wk.pending)
                    if val is fab.NOTHING:
                        continue
                    wk.pending = None
                progressed = True
                try:
                    op = wk.gen.send(val)
                except StopIteration as stop:
                    wk.state, wk.done = stop.value, True
                    continue
                owner = transport if op[0] in fab.P2P_OPS else engine
                wk.pending = owner.post(wk.ep, op, t)
            rnd += 1
            for victim in [k[2] for k in kills if k[:2] == (t, rnd)]:
                events = rmap.fail_many([victim])
                del workers[victim]
                transport.drop(victim)
                recovery.note_dead([victim])
                engine.world_changed()
                for e in events:
                    if e["kind"] == "promote":
                        promotions += 1
                        recovery.repair_promoted(
                            workers[e["promoted"]].ep, t)
                progressed = True
            if all(wk.done for wk in workers.values()):
                break
            if not progressed and transport.activity == activity:
                raise RuntimeError(f"deadlock at step {t}, round {rnd}")
        comm_s.append(transport.take_comm_time())
    logs = {r: [(msg.send_id, msg.src, msg.dst, msg.tag, msg.step,
                 canon(msg.payload)) for msg in log.log]
            for r, log in transport.send_logs.items()}
    return {"states": {r: workers[rmap.cmp[r]].state for r in range(n)},
            "comm_s": comm_s, "logs": logs, "promotions": promotions,
            "replays": recovery.replays,
            "duplicates_skipped": transport.duplicates_skipped,
            "messages": sum(log.recorded_msgs
                            for log in transport.send_logs.values())}


def canon(x):
    """A comparable form of a payload or result: arrays and tensors as
    (dtype name, shape, bytes), containers walked, scalars as they are."""
    if isinstance(x, torch.Tensor):
        raw = x.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        return ("array", str(x.dtype).replace("torch.", ""),
                tuple(x.shape), raw.numpy().tobytes())
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.name, x.shape,
                np.ascontiguousarray(x).tobytes())
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [canon(v) for v in x])
    if isinstance(x, dict):
        return ("dict", [(k, canon(v)) for k, v in sorted(x.items())])
    return x


class CommZoo:
    """One step = one instance of every collective of ``COLLECTIVE_OPS``
    (allreduce, reduce_scatter and scan with ``redop``); each result is
    kept in the rank's state. Payloads come from numpy, seeded by (seed,
    rank, step, op), and ``make`` turns them into the payload type (an
    ndarray of some dtype, a tensor on some device)."""

    def __init__(self, n, make, redop="sum", integer=False,
                 shape=(6,), seed=0):
        self.n, self.make, self.redop = n, make, redop
        self.integer, self.shape, self.seed = integer, shape, seed
        self.nbrs = ring_neighbors(n)

    def value(self, rank, t, k):
        rng = np.random.default_rng([self.seed, rank, t, k])
        if self.integer:
            return self.make(rng.integers(-40, 40, self.shape))
        return self.make(rng.uniform(0.5, 2.0, self.shape))

    def init_state(self, rank):
        return {"outs": []}

    def ops(self, rank, t):
        """(kind, op, votes as reference_result takes them, meta) of
        every collective of step ``t`` as rank ``rank`` posts it."""
        n, root, red = self.n, t % self.n, self.redop
        v = self.value
        nbr = self.nbrs
        chunks = {r: [v(r, t, 10 + d) for d in range(n)] for r in range(n)}
        na = {r: (v(r, t, 5), nbr[r]) for r in range(n)}
        nt = {r: ([v(r, t, 20 + q) for q in nbr[r]], nbr[r])
              for r in range(n)}
        yield "bcast", ("bcast", v(rank, t, 0), root), \
            {r: v(r, t, 0) for r in range(n)}, root
        yield "gather", ("gather", v(rank, t, 1), root), \
            {r: v(r, t, 1) for r in range(n)}, root
        yield "allgather", ("allgather", v(rank, t, 2)), \
            {r: v(r, t, 2) for r in range(n)}, None
        yield "reduce_scatter", ("reduce_scatter", chunks[rank], red), \
            chunks, red
        yield "alltoall", ("alltoall", chunks[rank]), chunks, None
        yield "scan", ("scan", v(rank, t, 3), red), \
            {r: v(r, t, 3) for r in range(n)}, red
        yield "neighbor_allgather", ("neighbor_allgather", *na[rank]), \
            na, None
        yield "neighbor_alltoall", ("neighbor_alltoall", *nt[rank]), \
            nt, None
        yield "allreduce", ("allreduce", v(rank, t, 4), red), \
            {r: v(r, t, 4) for r in range(n)}, red
        yield "barrier", ("barrier",), {}, None

    def step(self, rank, state, t):
        for kind, op, _votes, _meta in self.ops(rank, t):
            state["outs"].append((t, kind, (yield op)))
        return state

    def expected(self, reference_result, rank, t):
        """reference_result of each collective of step ``t`` at ``rank``."""
        return [(t, kind, reference_result(kind, votes, rank, self.n, meta))
                for kind, _op, votes, meta in self.ops(rank, t)]


def tensor_maker(dtype, device):
    """numpy values -> a ``dtype`` tensor on ``device`` (bf16 through f32,
    rounded to nearest even)."""
    def make(a):
        t = torch.from_numpy(np.asarray(a))
        if dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.to(dtype).to(device)
    return make
