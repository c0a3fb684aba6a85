"""The port's simulated runtime and the paper's three apps against the JAX
package's, on the CPU.

``repro_torch.simrt.SimRuntime`` is a copy of ``repro.simrt``'s scheduler
over the port's fabric; ``repro_torch.apps`` compute HPCG, CloverLeaf and
PIC in float64 torch where the reference computes in numpy.  Two kinds of
check:

* The FT theorem (``tests/test_simrt_apps.py``, on the port): any
  survivable failure schedule ends bitwise on the failure-free run — every
  rank's state, tensor by tensor — under the replication, checkpoint and
  combined modes, with the reference's counters.
* The port against the reference, for every app and schedule of those
  tests: the counters (failures, promotions, restarts, replays, duplicates
  skipped, store restores and fallbacks) and the ``TimeBreakdown``, field
  by field, are equal — virtual time is the scheduler's arithmetic and
  does not depend on the numbers the apps compute — and the initial states
  are bitwise equal (both drawn with numpy).  Check values and final
  states agree within ``RTOL``: torch and numpy may sum in other orders
  (HPCG's dot products; PIC's ``rho_local.sum()``, the prefix and total of
  its allreduce, its scan and its check), so the last bits can differ and
  CG carries them on; PIC's deposit (``index_put_`` with ``accumulate``,
  serial on the CPU) takes ``np.add.at``'s order on the CPU.  CloverLeaf
  comes out bitwise at these sizes.

Also ported: the four ``test_simrt_*`` tests of ``tests/test_store.py``
(the in-memory store under the runtime, here with tensor state) and the
two ``SimRuntime`` tests of ``tests/test_transport_scale.py``.
"""
import functools
import tempfile
import types

import numpy as np
import pytest
import torch

from repro.apps.cloverleaf import CloverLeaf as RefCloverLeaf
from repro.apps.hpcg import HPCG as RefHPCG
from repro.apps.pic import PIC as RefPIC
from repro.configs.base import FTConfig as RefFTConfig
from repro.core.failure_sim import FailureEvent as RefFailureEvent
from repro.core.failure_sim import WeibullInjector as RefWeibullInjector
from repro.simrt import CostModel as RefCostModel
from repro.simrt import SimRuntime as RefSimRuntime
from repro_torch.apps.cloverleaf import CloverLeaf
from repro_torch.apps.hpcg import HPCG
from repro_torch.apps.pic import (PIC, inclusive_scan, migrate_blocks,
                                  np_mod)
from repro_torch.comm import ReplicaTransport
from repro_torch.configs.base import FTConfig
from repro_torch.core import ckpt_policy
from repro_torch.core.failure_sim import FailureEvent, WeibullInjector
from repro_torch.core.message_log import LoggedMessage
from repro_torch.core.replica_map import ReplicaMap
from repro_torch.simrt import CostModel, SimRuntime

# float64 agreement of the port's CPU run with the reference's, relative
# to each tensor's largest magnitude: the sums named in the module
# docstring differ in their last bits and twelve CG iterations carry that
# on; the largest gap over every schedule below is 2.9e-15 (HPCG; PIC
# 4.4e-16; CloverLeaf is bitwise)
RTOL = 1e-12

APPS = {
    "hpcg": dict(nx=8, ny=8, nz=4),
    "cloverleaf": dict(nx=16, ny_local=8),
    "pic": dict(cells_per_rank=32, particles_per_rank=96),
}
PORT = types.SimpleNamespace(
    apps={"hpcg": functools.partial(HPCG, device="cpu"),
          "cloverleaf": functools.partial(CloverLeaf, device="cpu"),
          "pic": functools.partial(PIC, device="cpu")},
    FTConfig=FTConfig, FailureEvent=FailureEvent, CostModel=CostModel,
    SimRuntime=SimRuntime, Weibull=WeibullInjector)
REF = types.SimpleNamespace(
    apps={"hpcg": RefHPCG, "cloverleaf": RefCloverLeaf, "pic": RefPIC},
    FTConfig=RefFTConfig, FailureEvent=RefFailureEvent,
    CostModel=RefCostModel, SimRuntime=RefSimRuntime,
    Weibull=RefWeibullInjector)

KILLS = {
    "replication": ([(2.5, (0,)), (5.5, (2,)), (8.5, (1,))], {}),
    "checkpoint": ([(6.5, (2,))], {"rep": 0.0}),
    "combined": ([(3.2, (1,)), (6.3, (5,))], {}),
}
# every schedule of tests/test_simrt_apps.py: name -> (app, mode, kills, kw)
CASES = {f"{app}-{mode}": (app, mode, kills, kw)
         for app in APPS for mode, (kills, kw) in KILLS.items()}
CASES.update({
    "hpcg-node": ("hpcg", "replication", [(4.5, (0, 1))], {}),
    "hpcg-partial": ("hpcg", "combined", [(2.5, (1,)), (6.5, (3,))],
                     {"rep": 0.5}),
    "hpcg-no-respawn": ("hpcg", "combined", [(3.2, (1,)), (5.3, (5,))],
                        {"respawn": False}),
    "pic-weibull": ("pic", "combined", "weibull", {}),
    "pic-replay": ("pic", "replication", [(2.5, (0,)), (5.5, (2,))], {}),
})
CASES.update({f"{app}-none": (app, "none", [], {}) for app in APPS})
COUNTERS = ("steps_done", "failures", "promotions", "restarts", "replays",
            "duplicates_skipped", "store_restores", "store_fallbacks")


def _run(pkg, app, mode, kills, steps=12, n=4, rep=1.0, respawn=True,
         wpn=2):
    if kills == "weibull":
        # tests/test_simrt_apps.py::test_weibull_schedule_...: random kills
        events = pkg.Weibull(mtbf_s=4.0, shape=0.7, seed=5).schedule(
            12.0, alive_workers=range(8))
    else:
        events = [pkg.FailureEvent(t, ws) for t, ws in kills]
    ft = pkg.FTConfig(mode=mode, replication_degree=rep, mtbf_s=1e9,
                      ckpt_interval_s=4.0)
    with tempfile.TemporaryDirectory() as d:
        rt = pkg.SimRuntime(pkg.apps[app](n_ranks=n, **APPS[app]), ft,
                            costs=pkg.CostModel(step_time_s=1.0,
                                                ckpt_cost_s=0.2,
                                                restore_cost_s=0.3),
                            ckpt_dir=d, failure_events=events,
                            workers_per_node=wpn,
                            respawn_on_restart=respawn)
        return rt.run(steps)


@functools.lru_cache(maxsize=None)
def port_run(case):
    app, mode, kills, kw = CASES[case]
    return _run(PORT, app, mode, kills, **kw)


@functools.lru_cache(maxsize=None)
def ref_run(case):
    app, mode, kills, kw = CASES[case]
    return _run(REF, app, mode, kills, **kw)


def assert_states_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for r in want:
        assert sorted(got[r]) == sorted(want[r])
        for key, w in want[r].items():
            g = got[r][key]
            if isinstance(w, torch.Tensor):
                assert g.dtype == w.dtype and g.device == w.device
                assert torch.equal(g, w), (r, key)
            else:
                assert g == w, (r, key)


def assert_ft_exact(case, app):
    """The FT theorem: bitwise the failure-free run's states."""
    res = port_run(case)
    clean = port_run(f"{app}-none")
    assert_states_bitwise(res.states, clean.states)
    assert res.check_value == clean.check_value
    return res


# -------------------------------------- tests/test_simrt_apps.py, on the port

@pytest.mark.parametrize("name", list(APPS))
def test_replication_promotion_exact(name):
    r = assert_ft_exact(f"{name}-replication", name)
    assert r.promotions == 3 and r.restarts == 0


@pytest.mark.parametrize("name", list(APPS))
def test_checkpoint_restart_exact(name):
    r = assert_ft_exact(f"{name}-checkpoint", name)
    assert r.restarts == 1 and r.time.rollback > 0


@pytest.mark.parametrize("name", list(APPS))
def test_combined_pair_death_exact(name):
    r = assert_ft_exact(f"{name}-combined", name)
    assert r.restarts == 1 and r.promotions >= 1


def test_node_failure_kills_worker_group():
    # workers_per_node=2: node 0 = workers {0,1} -> two promotions at once
    r = assert_ft_exact("hpcg-node", "hpcg")
    assert r.promotions == 2


def test_partial_replication_mixed_recovery():
    # rep degree 0.5: ranks 0,1 replicated (workers 4,5). Kill a replicated
    # cmp (promote) then an unreplicated cmp (restart).
    r = assert_ft_exact("hpcg-partial", "hpcg")
    assert r.promotions == 1 and r.restarts == 1


def test_elastic_restart_without_respawn():
    """After a pair death without spare workers, the job restarts with
    fewer workers and a lower replication degree (paper §3.3)."""
    r = assert_ft_exact("hpcg-no-respawn", "hpcg")
    assert r.restarts == 1


def test_weibull_schedule_replication_survives():
    """Random Weibull kills at a high rate; full replication + checkpoints
    keep the answer exact."""
    r = assert_ft_exact("pic-weibull", "pic")
    assert r.failures >= 1


def test_message_replay_happens():
    """Promotions mid-step drop in-flight messages; sender logs must replay
    them (replays counter > 0) and the answer stays exact."""
    r = assert_ft_exact("pic-replay", "pic")
    assert r.replays > 0


def test_efficiency_accounting():
    t = port_run("hpcg-checkpoint").time
    assert t.total == pytest.approx(
        t.useful + t.redundant + t.ckpt_write + t.restore + t.rollback
        + t.repair + t.log_removal)
    assert port_run("hpcg-checkpoint").efficiency < 1.0


# ------------------------------------------------ the port against repro

@pytest.mark.parametrize("name", list(APPS))
def test_initial_states_equal_the_reference(name):
    ours = PORT.apps[name](n_ranks=4, **APPS[name])
    theirs = REF.apps[name](n_ranks=4, **APPS[name])
    for r in range(4):
        a, b = ours.init_state(r), theirs.init_state(r)
        assert sorted(a) == sorted(b)
        for key, want in b.items():
            got = a[key]
            if isinstance(want, np.ndarray):
                assert got.dtype == torch.float64 and got.device.type == "cpu"
                np.testing.assert_array_equal(got.numpy(), want)
            elif isinstance(got, torch.Tensor):
                assert got.item() == want            # CloverLeaf's t
            else:
                assert got == want


def _as_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("case", sorted(CASES))
def test_counters_and_time_equal_the_reference(case):
    ours, theirs = port_run(case), ref_run(case)
    for field in COUNTERS:
        assert getattr(ours, field) == getattr(theirs, field), field
    assert ours.time.as_dict() == theirs.time.as_dict()
    assert ours.check_value == pytest.approx(theirs.check_value, rel=RTOL)
    for r, want in theirs.states.items():
        for key, w in want.items():
            if w is None:
                assert ours.states[r][key] is None
                continue
            g = _as_numpy(ours.states[r][key])
            assert g.shape == np.shape(w), (r, key)
            scale = float(np.abs(w).max()) if np.size(w) else 0.0
            np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * scale,
                                       err_msg=key)


# ------------------------------------- tests/test_store.py's test_simrt_*

class AllreduceApp:
    """Tiny deterministic app: one exchange + one allreduce per step, its
    state torch tensors on the CPU."""

    device = torch.device("cpu")

    def __init__(self, n_ranks=4):
        self.n_ranks = n_ranks

    def init_state(self, rank):
        return {"acc": torch.zeros(5, dtype=torch.float64),
                "ring": torch.zeros(5, dtype=torch.float64)}

    def step(self, rank, state, t):
        n = self.n_ranks
        v = (torch.arange(5, dtype=torch.float64) + 1) * (rank + 1) * (t + 2)
        got = yield ("exchange", {(rank + 1) % n: v, (rank - 1) % n: v * 2},
                     3)
        total = yield ("allreduce", v, "sum")
        ring = sum(got.values())
        return {"acc": state["acc"] + total, "ring": state["ring"] + ring}

    def check(self, states):
        return float(sum(s["acc"].sum() + s["ring"].sum()
                         for s in states.values()))


def _simrt(backend, events=(), n=4, steps=8):
    ft = FTConfig(mode="combined", replication_degree=1.0, mtbf_s=1e9,
                  ckpt_interval_s=3.0, ckpt_backend=backend)
    costs = CostModel(step_time_s=1.0, ckpt_cost_s=0.5, restore_cost_s=0.5,
                      mem_ckpt_cost_s=0.01, mem_restore_cost_s=0.02)
    rt = SimRuntime(AllreduceApp(n), ft, costs=costs,
                    failure_events=list(events), workers_per_node=2)
    return rt, rt.run(steps)


def test_simrt_memory_backend_pair_death_bitwise():
    _, clean = _simrt("disk")                        # no dir: _ckpt_mem path
    rt, faulty = _simrt("memory", [FailureEvent(1.5, (1,)),
                                   FailureEvent(4.2, (1 + 4, ))])
    assert faulty.restarts == 1
    assert faulty.store_restores == 1 and faulty.store_fallbacks == 0
    assert_states_bitwise(faulty.states, clean.states)
    assert faulty.check_value == clean.check_value


def test_simrt_memory_backend_network_bound_accounting():
    """Virtual time charges the memory backend's network-bound C/R, not
    the disk constants."""
    _rt_d, disk = _simrt("disk")
    rt_m, mem = _simrt("memory")
    writes = mem.time.ckpt_write / 0.01
    assert writes == pytest.approx(round(writes))    # integral multiple of C
    assert mem.time.ckpt_write < disk.time.ckpt_write
    assert rt_m.store is not None and rt_m.store.durable() is not None


def test_simrt_rejects_unknown_backend():
    """Typo'd backend names must fail loudly, not silently run on disk
    costs (FTSession's make_backend raises the same way)."""
    with pytest.raises(ValueError):
        SimRuntime(AllreduceApp(4),
                   FTConfig(mode="combined", ckpt_backend="mem"),
                   workers_per_node=2)


def test_simrt_memory_backend_young_daly_uses_mem_cost():
    ft = FTConfig(mode="combined", mtbf_s=800.0, ckpt_backend="memory")
    costs = CostModel(step_time_s=1.0, ckpt_cost_s=50.0, mem_ckpt_cost_s=0.25)
    rt = SimRuntime(AllreduceApp(4), ft, costs=costs, workers_per_node=2)
    want = ckpt_policy.young_daly_interval(800.0, 0.25)
    assert rt.coords.primary.ckpt_interval_s == pytest.approx(want)


# ---------------------- tests/test_transport_scale.py's SimRuntime tests

def _flat_transport(n_ranks: int, replicated: bool = False):
    """A bare transport over a fresh world, every worker registered."""
    rmap = ReplicaMap(n_ranks, n_ranks if replicated else 0)
    t = ReplicaTransport(rmap, n_ranks)
    eps = {w: t.register(w) for w in rmap.alive()}
    return rmap, t, eps


def test_trim_wildcards_keeps_cursor_math_across_bases():
    """Trim drops consumed wc_order/wc_matches prefixes and advances the
    bases; a replica that consumed less than its cmp twin gates the trim,
    and its next wildcard match still lands on the right order entry."""
    rmap, t, eps = _flat_transport(1, replicated=True)
    cmp_ep, rep_ep = eps[rmap.cmp[0]], eps[rmap.rep[0]]
    for sid in range(3):
        m = LoggedMessage(sid, 0, 0, 9, torch.tensor(float(sid)), 0)
        t.deliver(cmp_ep, m)
        t.deliver(rep_ep, m)
    for _ in range(3):
        assert t.match_recv(cmp_ep, None, 9) is not None
    assert t.match_recv(rep_ep, None, 9).send_id == 0

    t.trim_wildcards(0)                  # rep consumed 1 -> keep = 1
    assert t.wc_base[0] == 1 and len(t.wc_order[0]) == 2
    assert cmp_ep.wc_matches_base == 1 and len(cmp_ep.wc_matches) == 2
    assert rep_ep.wc_matches_base == 1 and rep_ep.wc_matches == []

    # the replica's next wildcard still resolves entries 1 and 2
    assert t.match_recv(rep_ep, None, 9).send_id == 1
    assert t.match_recv(rep_ep, None, 9).send_id == 2
    t.trim_wildcards(0)
    assert t.wc_base[0] == 3 and t.wc_order[0] == []

    # snapshot/load round-trips the bases; legacy snapshots default to 0
    snap = t.snapshot_rank(0, cmp_ep)
    assert snap["wc_base"] == 3 and snap["wc_matches_base"] == 3
    t.load_rank(0, cmp_ep, snap)
    assert t.wc_base[0] == 3 and cmp_ep.wc_matches_base == 3
    legacy = {k: v for k, v in snap.items()
              if k not in ("wc_base", "wc_matches_base")}
    legacy["wc_order"] = []
    t.load_rank(0, cmp_ep, legacy)
    assert t.wc_base[0] == 0 and cmp_ep.wc_matches_base == 0


class _TrimHub:
    """Rank 0 wildcard-drains its peers every step (tests/test_comm_layer's
    WildcardHub, sized for a combined-mode checkpointed run)."""

    TAG = 9

    def __init__(self, n_ranks: int):
        self.n_ranks = n_ranks

    def init_state(self, rank: int) -> dict:
        return {"acc": torch.zeros(2, dtype=torch.float64)}

    def step(self, rank, state, t):
        if rank == 0:
            total = torch.zeros(2, dtype=torch.float64)
            for _ in range(self.n_ranks - 1):
                src, payload = yield ("recv_any", self.TAG)
                total = total + payload * (src + 1)
        else:
            yield ("send", 0, self.TAG,
                   torch.full((2,), float(rank * 10 + t),
                              dtype=torch.float64))
            total = None
        total = yield ("bcast", total, 0)
        return {"acc": state["acc"] + total}


def _run_trim_hub(events=()):
    app = _TrimHub(3)
    ft = FTConfig(mode="combined", replication_degree=1.0, mtbf_s=1e9,
                  ckpt_interval_s=2.0, ckpt_backend="memory")
    rt = SimRuntime(app, ft, costs=CostModel(step_time_s=1.0),
                    failure_events=list(events), workers_per_node=2)
    res = rt.run(8)
    return rt, res


def test_checkpoint_trims_wildcard_history_and_replay_survives():
    rt, clean = _run_trim_hub()
    # 8 steps x 2 wildcard matches happened, but checkpoints trimmed the
    # retained order down; the base accounts for the dropped prefix
    assert rt.transport.wc_base[0] > 0
    assert len(rt.transport.wc_order[0]) + rt.transport.wc_base[0] == 8 * 2
    ep = rt.transport.endpoints[rt.rmap.cmp[0]]
    assert ep.wc_consumed == 8 * 2
    assert len(ep.wc_matches) == len(rt.transport.wc_order[0])

    # a kill after a trim forces replica replay against the trimmed order
    rt2, faulty = _run_trim_hub([FailureEvent(4.5, (0,))])
    assert faulty.promotions == 1
    assert_states_bitwise(faulty.states, clean.states)


# ------------------------------------------------------------- PIC's pieces

def test_np_mod_equals_numpy_at_the_edges():
    """``np_mod`` gives ``np.mod``'s bits, signed zeros included, at and
    around the domain's edges and for negative positions."""
    L = 128.0
    tiny = np.nextafter(0.0, 1.0)
    edge = [0.0, -0.0, L, -L, 2 * L, -2 * L, tiny, -tiny,
            np.nextafter(L, 0.0), np.nextafter(L, 2 * L),
            np.nextafter(-L, 0.0), -1e-18, 1e-18, -5.5, 130.25, -300.75,
            np.nextafter(0.0, -1.0) * 3]
    rng = np.random.default_rng(0)
    a = np.concatenate([edge, rng.uniform(-3 * L, 3 * L, 1000)])
    got = np_mod(torch.from_numpy(a),
                 torch.tensor(L, dtype=torch.float64)).numpy()
    want = np.mod(a, L)
    assert got.view(np.uint64).tolist() == want.view(np.uint64).tolist()


def test_deposit_equals_np_add_at_on_the_cpu():
    rng = np.random.default_rng(1)
    nc = 32
    x = rng.random(5000) * nc
    cell = np.floor(x).astype(np.int64)
    frac = x - cell
    want = np.zeros(nc + 2)
    np.add.at(want, cell + 1, 1.0 - frac)
    np.add.at(want, cell + 2, frac)
    tx = torch.from_numpy(x)
    tcell = torch.floor(tx).to(torch.int64)
    tfrac = tx - tcell
    got = torch.zeros(nc + 2, dtype=torch.float64)
    got.index_put_((tcell + 1,), 1.0 - tfrac, accumulate=True)
    got.index_put_((tcell + 2,), tfrac, accumulate=True)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 3, 31, 32, 33, 4096, 4099])
def test_inclusive_scan_against_cumsum(n):
    """Within float64 rounding of ``np.cumsum`` (another summation
    order: 1e-14 of the largest partial sum)."""
    x = np.random.default_rng(n).standard_normal(n)
    got = inclusive_scan(torch.from_numpy(x)).numpy()
    want = np.cumsum(x)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-14 * np.abs(want).max())


@pytest.mark.parametrize("n,count", [(1, 10), (4, 300), (7, 1000),
                                     (32, 64)])
def test_migrate_blocks_equal_the_masked_blocks(n, count):
    """One block per destination, bitwise the reference's
    ``np.stack([pos[owner == d], vel[owner == d]])``, empty ones too."""
    rng = np.random.default_rng(count)
    pos, vel = rng.random(count) * 8 * n, rng.standard_normal(count)
    owner = np.floor(pos / 8).astype(np.int64) % n
    if n == 32:
        owner[:] = 5                              # all to one rank
    blocks = migrate_blocks(torch.from_numpy(pos), torch.from_numpy(vel),
                            torch.from_numpy(owner), n)
    assert len(blocks) == n
    for d, block in enumerate(blocks):
        want = np.stack([pos[owner == d], vel[owner == d]])
        assert block.shape == want.shape
        assert np.array_equal(block.numpy(), want)
