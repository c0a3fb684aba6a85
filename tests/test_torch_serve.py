"""The port's serving path and FT core.

* Ports of ``test_system.py::test_serve_failover_identical_stream`` and
  ``test_serve_without_replication_fails`` on the CPU, for the dense
  family and the zamba2 hybrid: a mid-stream kill with replication gives
  the bitwise-identical token stream and final state (one promotion);
  without a replica it is fatal.
* The replica's state owns its storage after ``on_start`` and after a
  promotion (the decode step writes its KV ring in place, so an aliased
  copy would silently follow the computational slice), the hybrid's Mamba
  ``h`` and ``conv`` states included.
* The port's copy of the FT core (``FTSession``, strategies, injector,
  replica map, planner, clock, the in-memory checkpoint store) against
  ``repro``'s on one numpy workload and the same kill schedules, in all
  four FT modes: every ``RunReport`` field, the event list and the final
  state are equal (exact: the same arithmetic on the host).
* Topology pricing and the request-batch fan-out (``BatchFanout``)
  against ``repro``'s: the same priced seconds, received batch and log
  entries (exact: integer bookkeeping and the same float arithmetic).
  The ``cuda`` case skips without a card.
"""
import numpy as np
import pytest
import torch

from repro.configs.base import FTConfig as JaxFTConfig
from repro.ft import FTSession as JaxFTSession
from repro_torch.configs.base import FTConfig
from repro_torch.ft import DecodeWorkload, FTSession
from repro_torch.launch.serve import BatchFanout, ReplicatedServer
from repro_torch.tree import copy_tree, tree_map


@pytest.mark.parametrize("arch", ["qwen3-8b", "codeqwen1.5-7b",
                                  "zamba2-7b"])
def test_serve_failover_identical_stream(arch):
    prompts = np.random.default_rng(0).integers(0, 400, (2, 16),
                                                dtype=np.int32)
    a = ReplicatedServer(arch, batch=2, prompt_len=16, device="cpu")
    clean = a.generate(prompts, 8, kill_at=-1)
    b = ReplicatedServer(arch, batch=2, prompt_len=16, device="cpu")
    faulty = b.generate(prompts, 8, kill_at=3)
    assert clean.shape == (2, 8)
    np.testing.assert_array_equal(clean, faulty)
    assert b.promotions == 1 and b.failures == 1 and a.promotions == 0


def test_serve_without_replication_fails():
    prompts = np.zeros((2, 16), dtype=np.int32)
    srv = ReplicatedServer("qwen3-8b", batch=2, prompt_len=16,
                           replication=False, device="cpu")
    with pytest.raises(RuntimeError):
        srv.generate(prompts, 8, kill_at=2)
    assert srv.failures == 1


def _tensors(tree):
    out = []
    tree_map(lambda leaf: out.append(leaf)
             if isinstance(leaf, torch.Tensor) else None, tree)
    return out


def test_zamba_failover_final_state_equals_clean():
    """The FT theorem on the hybrid's whole state: after the promotion the
    final attention rings and every Mamba ``h`` and ``conv`` equal the
    clean run's bit for bit."""
    prompts = np.random.default_rng(2).integers(0, 400, (2, 16),
                                                dtype=np.int32)
    srv = ReplicatedServer("zamba2-7b", batch=2, prompt_len=16,
                           device="cpu")
    clean = srv.generate(prompts, 8)
    clean_state = srv.last_report.final_state["cache"]
    faulty = srv.generate(prompts, 8, kill_at=3)
    faulty_state = srv.last_report.final_state["cache"]
    np.testing.assert_array_equal(clean, faulty)
    assert srv.promotions == 1 and srv.failures == 1
    assert set(clean_state) == {"attn", "mamba", "mamba_tail"}
    a, b = _tensors(clean_state), _tensors(faulty_state)
    assert len(a) == len(b) == 2 * 3 + 2 * 6 + 2   # k/v/pos, h/conv
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_zamba_serve_without_replication_fails():
    prompts = np.zeros((2, 16), dtype=np.int32)
    srv = ReplicatedServer("zamba2-7b", batch=2, prompt_len=16,
                           replication=False, device="cpu")
    with pytest.raises(RuntimeError):
        srv.generate(prompts, 8, kill_at=2)
    assert srv.failures == 1


def _storage(tree):
    """Addresses of the storages behind every tensor of ``tree``."""
    ptrs = set()

    def visit(leaf):
        if isinstance(leaf, torch.Tensor):
            ptrs.add(leaf.untyped_storage().data_ptr())
    tree_map(visit, tree)
    return ptrs


class _StorageProbe:
    """Wraps a workload; at each step of the computational slice records
    whether its cache shares storage with the replica's."""

    def __init__(self, inner, session):
        self.inner, self.session, self.seen = inner, session, []

    def init_state(self):
        return self.inner.init_state()

    def step(self, state, t):
        replica = self.session.strategy.replica_state
        if replica is not None and replica is not state:
            self.seen.append((t, _storage(state["cache"])
                              & _storage(replica["cache"])))
        return self.inner.step(state, t)


def test_replica_cache_owns_its_storage():
    srv = ReplicatedServer("qwen3-8b", batch=2, prompt_len=16, device="cpu")
    prompts = np.random.default_rng(1).integers(0, 400, (2, 16),
                                                dtype=np.int32)
    # two ranks: after worker 0 dies, rank 0's replica is promoted and
    # rank 1 still has one, so the promoted state is copied again
    session = FTSession(ft=FTConfig(mode="replication"), injector={3: [0]},
                        n_logical_workers=2, workers_per_node=1,
                        allow_restart=False)
    probe = _StorageProbe(srv.workload(prompts), session)
    rep = session.run(probe, 6)
    assert rep.promotions == 1
    steps = [t for t, _ in probe.seen]
    assert steps == list(range(6))              # before and after promotion
    assert all(not shared for _, shared in probe.seen)
    clean = srv.generate(prompts, 6)
    np.testing.assert_array_equal(DecodeWorkload.tokens(rep.final_state),
                                  clean)


def test_zamba_replica_state_owns_its_storage():
    """The hybrid's state: attention rings written in place, Mamba ``h``
    and ``conv`` made anew each step — none shared between the slices,
    before and after the promotion."""
    srv = ReplicatedServer("zamba2-7b", batch=2, prompt_len=16,
                           device="cpu")
    prompts = np.random.default_rng(3).integers(0, 400, (2, 16),
                                                dtype=np.int32)
    session = FTSession(ft=FTConfig(mode="replication"), injector={3: [0]},
                        n_logical_workers=2, workers_per_node=1,
                        allow_restart=False)
    probe = _StorageProbe(srv.workload(prompts), session)
    rep = session.run(probe, 6)
    assert rep.promotions == 1
    assert [t for t, _ in probe.seen] == list(range(6))
    assert all(not shared for _, shared in probe.seen)
    state = rep.final_state["cache"]
    # the probe looked at every state tensor: 2 rings x (k, v, pos) and
    # 7 Mamba blocks x (h, conv), each with a storage of its own
    assert len(_storage(state)) == len(_tensors(state)) == 2 * 3 + 7 * 2
    np.testing.assert_array_equal(DecodeWorkload.tokens(rep.final_state),
                                  srv.generate(prompts, 6))


def test_copy_tree_clones_tensors_and_arrays():
    tree = {"a": torch.ones(3), "b": [np.zeros(2), 5], "c": (torch.zeros(1),)}
    out = copy_tree(tree)
    assert out["b"][1] == 5 and isinstance(out["c"], tuple)
    assert not _storage(tree) & _storage(out)
    assert out["b"][0] is not tree["b"][0]
    out["a"].add_(1)
    assert torch.all(tree["a"] == 1)


# ---------------------------------------------- the FT core against repro

class _Toy:
    """A deterministic numpy workload: any (state, t) -> same result."""

    def init_state(self):
        return {"x": np.arange(4.0), "n": 0, "hist": []}

    def step(self, s, t):
        x = s["x"] * 1.5 + t
        return {"x": x, "n": s["n"] + 1,
                "hist": s["hist"] + [float(x.sum())]}, float(x.sum())


SCHEDULES = [
    ("replication", 2, {3: [0]}, False),          # promotion
    ("replication", 2, {2: [3]}, False),          # a replica dies
    ("replication", 2, {2: [0, 2]}, True),        # a rank loses both copies
    ("replication", 2, {1: [0], 4: [2]}, True),   # promote, then lose it
    ("replication", 3, {2: [1], 5: [0, 4]}, True),
    ("none", 2, {3: [1]}, True),                  # restart from scratch
    ("none", 1, {}, False),                       # clean
    ("checkpoint", 2, {3: [1]}, True),            # restart from memory
    ("combined", 2, {1: [0], 4: [2]}, True),      # promote, then restore
    ("combined", 3, {2: [1], 5: [0, 4]}, True),
]


@pytest.mark.parametrize("mode,n,kills,allow_restart", SCHEDULES)
def test_ft_core_matches_repro(mode, n, kills, allow_restart):
    def run(session_cls, ft_cls):
        session = session_cls(ft=ft_cls(mode=mode), injector=dict(kills),
                              n_logical_workers=n, workers_per_node=1,
                              allow_restart=allow_restart)
        return session.run(_Toy(), 8)

    ours, theirs = run(FTSession, FTConfig), run(JaxFTSession, JaxFTConfig)
    for field in ("steps", "metrics", "failures", "promotions", "restarts",
                  "ckpt_writes", "rolled_back_steps"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert [(e.step, e.kind, e.detail) for e in ours.events] == \
        [(e.step, e.kind, e.detail) for e in theirs.events]
    assert ours.time.as_dict() == theirs.time.as_dict()
    np.testing.assert_array_equal(ours.final_state["x"],
                                  theirs.final_state["x"])
    assert ours.final_state["hist"] == theirs.final_state["hist"]
    assert ours.final_state["n"] == theirs.final_state["n"]


TOPOLOGIES = ("flat", "fattree", "dragonfly", "torus3d")


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_session_prices_like_the_reference(topology):
    """An FTSession with a topology builds, and its cost model prices
    every worker pair and message size as the reference session's does."""
    def prices(session_cls, ft_cls):
        session = session_cls(ft=ft_cls(mode="replication", topology=topology,
                                        topo_alpha=7e-6, topo_gamma=1e-11),
                              n_logical_workers=6, workers_per_node=2)
        cm = session.pricing.cost_model
        assert session.clock.cost_model is cm and session.pricing.priced
        assert session.pricing.graph.kind == topology
        ws = range(session.rmap.world_size)
        return [cm.msg_cost_workers(a, b, nbytes) for a in ws for b in ws
                for nbytes in (0, 8192, 4 * 512 * 4, 1 << 24)]

    assert prices(FTSession, FTConfig) == prices(JaxFTSession, JaxFTConfig)


# ------------------------------------------------- the request-batch fan-out

def _log_entries(fanout):
    log = fanout.transport.send_logs[fanout.FRONTEND_RANK]
    return [(m.dst, m.tag, m.send_id, m.step, m.nbytes()) for m in log.log]


@pytest.mark.parametrize("replication", [True, False])
@pytest.mark.parametrize("topology", [None, "fattree"])
def test_fanout_matches_the_reference(replication, topology):
    """The port's BatchFanout on a CPU tensor against the JAX package's on
    the same int32 ndarray, over two rounds: the same received batch, log
    entries (dst, tag, send-ID, step, bytes) and priced comm seconds."""
    from repro.launch.serve import BatchFanout as JaxBatchFanout
    batch = np.random.default_rng(4).integers(0, 400, (4, 512),
                                              dtype=np.int32)
    ours = BatchFanout(replication, FTConfig(mode="none", topology=topology))
    theirs = JaxBatchFanout(replication,
                            JaxFTConfig(mode="none", topology=topology))
    for _ in range(2):
        got = ours.fan_out(torch.from_numpy(batch.copy()))
        want = theirs.fan_out(batch.copy())
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert ours.clock.breakdown.comm == theirs.clock.breakdown.comm
    assert _log_entries(ours) == _log_entries(theirs)
    assert len(_log_entries(ours)) == 2
    assert (ours.clock.breakdown.comm > 0) == (topology is not None)
    if replication:
        cmp_copy, rep_copy = (ours.received[ours.rmap.cmp[0]],
                              ours.received[ours.rmap.rep[0]])
        assert torch.equal(cmp_copy, rep_copy)
        # each worker's copy is its own: the equality check compares two
        # tensors, and the workload's writes reach neither the replica
        # nor the frontend's log
        logged = ours.transport.send_logs[ours.FRONTEND_RANK].log[-1].payload
        ptrs = {x.untyped_storage().data_ptr()
                for x in (cmp_copy, rep_copy, logged)}
        assert len(ptrs) == 3
        cmp_copy.fill_(-1)
        assert np.array_equal(rep_copy.numpy(), batch)
        assert np.array_equal(logged.numpy(), batch)


def test_generate_prices_the_fanout_like_the_reference():
    """The reduced qwen3-8b served with topology="fattree" and a kill: the
    run's comm seconds are the JAX server's for the same config, batch and
    prompt length; the tokens are the unpriced clean run's; one
    promotion; one logged fan-out per generate."""
    from repro.launch.serve import ReplicatedServer as JaxServer
    prompts = np.random.default_rng(5).integers(0, 400, (2, 16),
                                                dtype=np.int32)
    clean = ReplicatedServer("qwen3-8b", batch=2, prompt_len=16,
                             device="cpu").generate(prompts, 4)
    ours = ReplicatedServer("qwen3-8b", batch=2, prompt_len=16, device="cpu",
                            topology="fattree")
    toks = ours.generate(prompts, 4, kill_at=2)
    theirs = JaxServer("qwen3-8b", batch=2, prompt_len=16,
                       topology="fattree")
    theirs.generate(prompts.copy(), 4, kill_at=2)   # freezes its batch
    np.testing.assert_array_equal(toks, clean)
    assert ours.promotions == 1
    assert ours.last_report.time.comm == theirs.last_report.time.comm > 0
    assert ours.last_report.time.as_dict() == \
        theirs.last_report.time.as_dict()
    ours.generate(prompts, 4)
    assert [e[2] for e in _log_entries(ours.fanout)] == [0, 1]


@pytest.mark.cuda
def test_fanout_of_a_device_batch_stays_on_the_card():
    """On the card the bcast carries the device tensor: both received
    copies are on the card, equal to the batch and to each other, and the
    priced seconds are the CPU fan-out's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    batch = torch.from_numpy(np.random.default_rng(6).integers(
        0, 400, (4, 512), dtype=np.int32))
    fans = [BatchFanout(True, FTConfig(mode="none", topology="fattree"))
            for _ in range(2)]
    card = fans[0].fan_out(batch.cuda())
    cpu = fans[1].fan_out(batch)
    assert card.is_cuda and torch.equal(card.cpu(), batch)
    copies = list(fans[0].received.values())
    assert all(c.is_cuda and torch.equal(c, copies[0]) for c in copies)
    # the frontend's, the computational worker's and the replica's
    assert len({c.untyped_storage().data_ptr() for c in copies}) == \
        len(copies) == 3
    assert fans[0].clock.breakdown.comm == fans[1].clock.breakdown.comm
    assert _log_entries(fans[0]) == _log_entries(fans[1])
