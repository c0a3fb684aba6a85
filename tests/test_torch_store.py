"""The port's replicated in-memory checkpoint store, checkpoint policy and
checkpoint strategies against the JAX package's.

``repro_torch.store`` (placement, memstore, recovery, backend),
``repro_torch.core.ckpt_policy``, the store branch of ``plan_recovery``
and the ``checkpoint``/``combined`` strategies are copies of their
``repro`` counterparts. Every comparison feeds the same numpy-made inputs
to both packages and is exact (tolerance zero): placement is integer
bookkeeping, the store moves bytes, and the policy and session ledgers
are the same float arithmetic in the same order. ``MemBackend`` turns a
state's tensors into host numpy arrays; a state of f32, f64 and int64
tensors gives the reference's bands for the same values as ndarrays.

Ported from ``tests/test_store.py``: every test that does not need the
simulated runtime. The four ``test_simrt_*`` tests wait for its port
(ROADMAP.md, Queue 1 item 9).
"""
import copy
import itertools
import pickle

import numpy as np
import pytest
import torch

from repro.clock import pricing_from_ft as ref_pricing_from_ft
from repro.comm import ReplicaTransport as RefTransport
from repro.configs.base import FTConfig as RefFTConfig
from repro.core import ckpt_policy as ref_policy
from repro.core.coordinator import ClusterTopology as RefClusterTopology
from repro.core.replica_map import ApplicationDead as RefApplicationDead
from repro.core.replica_map import ReplicaMap as RefReplicaMap
from repro.core.shrink import plan_recovery as ref_plan_recovery
from repro.ft import FTSession as RefFTSession
from repro.store import DiskBackend as RefDiskBackend
from repro.store import MemBackend as RefMemBackend
from repro.store import MemStore as RefMemStore
from repro.store import PartnerPlacement as RefPlacement
from repro.store import PlacementError as RefPlacementError
from repro_torch.clock import pricing_from_ft
from repro_torch.comm import ReplicaTransport
from repro_torch.configs.base import FTConfig
from repro_torch.core import ckpt_policy
from repro_torch.core.coordinator import ClusterTopology
from repro_torch.core.replica_map import ApplicationDead, ReplicaMap
from repro_torch.core.shrink import plan_recovery
from repro_torch.ft import FTSession
from repro_torch.store import (DiskBackend, MemBackend, MemStore,
                               PartnerPlacement, PlacementError,
                               StoreUnrecoverable)
from repro_torch.store import backend as backend_lib

PORT = dict(map=ReplicaMap, topo=ClusterTopology, transport=ReplicaTransport,
            store=MemStore, dead=ApplicationDead, placement=PartnerPlacement,
            placement_error=PlacementError, pricing=pricing_from_ft,
            ft=FTConfig, session=FTSession, backend=MemBackend,
            plan=plan_recovery)
REF = dict(map=RefReplicaMap, topo=RefClusterTopology, transport=RefTransport,
           store=RefMemStore, dead=RefApplicationDead, placement=RefPlacement,
           placement_error=RefPlacementError, pricing=ref_pricing_from_ft,
           ft=RefFTConfig, session=RefFTSession, backend=RefMemBackend,
           plan=ref_plan_recovery)


def build_world(side, n, m, wpn, k=2, bands=3):
    rmap = side["map"](n, m)
    topo = side["topo"](rmap.world_size, wpn)
    t = side["transport"](rmap, n)
    for w in rmap.alive():
        t.register(w)
    return rmap, topo, t, side["store"](t, topo, k_partners=k, n_bands=bands)


def rank_states(n, seed, shape=(7,)):
    rng = np.random.default_rng(seed)
    return {r: {"x": rng.standard_normal(shape),
                "i": np.int32(seed * 100 + r),
                "nested": {"u8": rng.integers(0, 255, (3, 2), dtype=np.uint8)}}
            for r in range(n)}


def assert_states_bitwise(got, want):
    for r in want:
        for key in ("x", "i"):
            np.testing.assert_array_equal(got[r][key], want[r][key])
            assert got[r][key].dtype == want[r][key].dtype
        np.testing.assert_array_equal(got[r]["nested"]["u8"],
                                      want[r]["nested"]["u8"])


def respawn_world(side, store, topo, n):
    """Mirror the runtimes' elastic restart: fresh full map, fresh
    transport, store rebound with shard memory carried over."""
    rmap = store.transport.rmap.restart_map(store.transport.rmap.world_size)
    t = side["transport"](rmap, n)
    for w in rmap.alive():
        t.register(w)
    store.rebind(topology=topo, transport=t)
    return rmap


def kill(side, store, workers):
    try:
        store.transport.rmap.fail_many(list(workers))
    except side["dead"]:
        pass
    for w in workers:
        store.lose_worker(w)


def counters(store):
    return {k: getattr(store, k) for k in (
        "pushes", "acks", "fetches", "local_reads", "direct_salvages",
        "gens_committed", "gens_abandoned", "committed_bytes",
        "last_save_bytes", "committed", "next_gen")}


def shard_table(store):
    """Every worker's shard sets: (worker, owner, gen) -> (step, nbytes,
    crcs, band bytes)."""
    return {(w, owner, gen): (ss.step, ss.nbytes, ss.crcs,
                              [ss.bands[b].tobytes()
                               for b in sorted(ss.bands)])
            for w, ws in store.stores.items()
            for (owner, gen), ss in ws.items()}


# ----------------------------------------------------------- placement

@pytest.mark.parametrize("n", range(2, 9))
def test_placement_tables_equal_the_reference(n):
    """Over test_store.py's (n, wpn, replicated, k) grid: the same partners,
    degraded flag, failure domains and brute-force tolerance; and the
    reference test's invariants hold on the port."""
    for wpn, replicated, k in itertools.product(range(1, 5), (False, True),
                                                range(1, 4)):
        m = n if replicated else 0
        pls = []
        for side in (PORT, REF):
            rmap = side["map"](n, m)
            topo = side["topo"](rmap.world_size, wpn)
            pls.append(side["placement"](rmap, topo, k_partners=k))
        ours, theirs = pls
        where = (n, wpn, replicated, k)
        assert ours.degraded == theirs.degraded, where
        for r in range(n):
            assert ours.partners_of(r) == theirs.partners_of(r), where
            assert ours.domain(r) == theirs.domain(r), where
            assert ours.holders_of(r) == theirs.holders_of(r), where
            partners = ours.partners_of(r)
            assert r not in partners
            assert len(partners) == len(set(partners)) <= k
            if not ours.degraded:
                assert len(partners) == min(k, n - 1)
                for p in partners:
                    assert not (ours.domain(p) & ours.domain(r))
        try:
            want = theirs.tolerance()
        except RefPlacementError:
            with pytest.raises(PlacementError):
                ours.tolerance()
        else:
            assert ours.tolerance() == want, where
            assert 0 <= want <= k
        assert ours.survives(())


@pytest.mark.parametrize("topology", ["flat", "fattree", "dragonfly",
                                      "torus3d"])
def test_graph_placement_equals_the_reference(topology):
    """With a topo graph the failure domain widens to the switch or group
    and ties break by link contention: the same partners as the
    reference's on every graph kind."""
    for n, wpn in ((8, 2), (8, 1), (6, 1)):
        pls = []
        for side in (PORT, REF):
            rmap = side["map"](n, n)
            topo = side["topo"](rmap.world_size, wpn)
            graph = side["pricing"](side["ft"](topology=topology), topo).graph
            pls.append(side["placement"](rmap, topo, k_partners=2,
                                         graph=graph))
        ours, theirs = pls
        assert ours.degraded == theirs.degraded
        assert [ours.partners_of(r) for r in range(n)] == \
            [theirs.partners_of(r) for r in range(n)]


def test_placement_full_tolerance_on_separated_topologies():
    for n, wpn in ((4, 2), (8, 4), (8, 2), (6, 2)):
        rmap = ReplicaMap(n, n)
        topo = ClusterTopology(rmap.world_size, wpn)
        pl = PartnerPlacement(rmap, topo, k_partners=2)
        assert not pl.degraded
        assert pl.tolerance() == 2


def test_placement_shift_pattern_never_colocates():
    pl = PartnerPlacement(ReplicaMap(4, 4), ClusterTopology(8, 2),
                          k_partners=2)
    assert [pl.partners_of(r) for r in range(4)] == \
        [(2, 3), (2, 3), (0, 1), (0, 1)]


# ------------------------------------------------------------ the store

@pytest.mark.parametrize("n,m,wpn,k,bands", [(4, 4, 2, 2, 3), (8, 8, 4, 2, 4),
                                             (6, 0, 2, 1, 1), (5, 2, 1, 3, 2)])
def test_store_bands_crcs_and_counts_equal_the_reference(n, m, wpn, k, bands):
    """Two saves of numpy payloads: every worker's shard sets (step, bytes,
    CRCs, band bytes), the generation table and every counter as the
    reference's; the bands are frozen host arrays, one array per band
    shared by the owner's and every partner's copy."""
    stores = [build_world(side, n, m, wpn, k, bands)[3] for side in
              (PORT, REF)]
    for seed, step in ((3, 5), (7, 9)):
        gens = [s.save(step, rank_states(n, seed)) for s in stores]
        assert gens[0] == gens[1]
    ours, theirs = stores
    assert shard_table(ours) == shard_table(theirs)
    assert counters(ours) == counters(theirs)
    assert ours.durable() == theirs.durable() == (2, 9)
    assert ours.gens[2]["manifest"] == theirs.gens[2]["manifest"]
    bands_seen = {}
    for ws in ours.stores.values():
        for (owner, gen), ss in ws.items():
            for b, band in ss.bands.items():
                assert isinstance(band, np.ndarray)
                assert not band.flags.writeable
                bands_seen.setdefault((owner, gen, b), set()).add(id(band))
    assert all(len(ids) == 1 for ids in bands_seen.values())


@pytest.mark.parametrize("n,wpn", [(4, 2), (8, 2)])
def test_bitwise_recovery_after_any_f_le_k_deaths(n, wpn):
    """Every combination of f <= k node/pair deaths leaves every rank's
    committed state bitwise recoverable; the fetch, local-read and salvage
    counts of each recovery are the reference's."""
    bases = []
    for side in (PORT, REF):
        rmap, topo, _t, store = build_world(side, n, n, wpn, k=2)
        store.save(5, rank_states(n, seed=3))
        store.save(9, rank_states(n, seed=7))
        bases.append(store)
    want = rank_states(n, seed=7)
    units = [tuple(topo.workers_on(nd)) for nd in range(topo.n_nodes)]
    units += [(r, r + n) for r in range(n)]
    for f in (1, 2):
        for combo in itertools.combinations(units, f):
            dead = sorted(set(itertools.chain.from_iterable(combo)))
            results = []
            for side, base in zip((PORT, REF), bases):
                store = copy.deepcopy(base)
                kill(side, store, dead)
                respawn_world(side, store, topo, n)
                got, step = store.restore()
                assert step == 9, f"combo {combo}"
                assert_states_bitwise(got, want)
                results.append(counters(store))
            assert results[0] == results[1], combo


def test_more_than_k_domain_deaths_is_unrecoverable():
    n = 4
    _rmap, topo, _t, store = build_world(PORT, n, n, 2, k=2)
    store.save(1, rank_states(n, seed=1))
    victims = []
    for r in (0,) + store.placement.partners_of(0):
        victims += [r, r + n]
    kill(PORT, store, victims)
    respawn_world(PORT, store, topo, n)
    assert not store.recoverable_without([])
    with pytest.raises(StoreUnrecoverable):
        store.restore()


def test_push_batches_bands_per_partner():
    n, k, bands = 4, 2, 3
    _rmap, topo, _t, store = build_world(PORT, n, n, 2, k=k, bands=bands)
    want = rank_states(n, seed=13)
    store.save(5, want)
    assert store.pushes == n * 2 * k < n * 2 * k * bands
    kill(PORT, store, [0, n])
    respawn_world(PORT, store, topo, n)
    got, step = store.restore()
    assert step == 5
    assert_states_bitwise(got, want)


def test_mid_commit_death_restores_previous_generation_bitwise():
    """A pair death between the push and the acks abandons the in-flight
    generation; the previous one restores bitwise — on both packages, with
    the same counters."""
    n = 4
    want = rank_states(n, seed=11)
    seen = []
    for side in (PORT, REF):
        _rmap, topo, _t, store = build_world(side, n, n, 2, k=2)
        store.save(4, want)
        assert store.durable() == (1, 4)
        g2 = store.begin_save(8, rank_states(n, seed=12))
        kill(side, store, [2, 2 + n])
        store.pump()
        assert not store.try_commit(g2)
        assert store.durable() == (1, 4)
        respawn_world(side, store, topo, n)
        got, step = store.restore()
        assert step == 4
        assert_states_bitwise(got, want)
        seen.append(counters(store))
    assert seen[0] == seen[1]


def test_partial_ack_does_not_commit():
    n = 4
    seen = []
    for side in (PORT, REF):
        _rmap, _topo, _t, store = build_world(side, n, n, 2, k=2)
        store.save(2, rank_states(n, seed=5))
        g2 = store.begin_save(6, rank_states(n, seed=6))
        acked = store.pump(partner_workers=[0])
        assert not store.try_commit(g2)
        assert store.durable() == (1, 2)
        acked_rest = store.pump()
        assert store.try_commit(g2)
        assert store.durable() == (g2, 6)
        assert all(g == g2 for ws in store.stores.values() for (_o, g) in ws)
        seen.append((acked, acked_rest, counters(store), shard_table(store)))
    assert seen[0] == seen[1]


def test_promotion_keeps_partner_copies():
    n = 4
    _rmap, topo, _t, store = build_world(PORT, n, n, 2, k=2)
    want = rank_states(n, seed=21)
    store.save(3, want)
    assert store.transport.rmap.fail(2)["kind"] == "promote"
    store.lose_worker(2)
    kill(PORT, store, [0, n])
    respawn_world(PORT, store, topo, n)
    got, step = store.restore()
    assert step == 3
    assert_states_bitwise(got, want)


# ------------------------------------------------------ plan_recovery

def _plan_fields(plan):
    return {k: getattr(plan, k) for k in (
        "kind", "failed_workers", "promotions", "needs_restore",
        "rollback_to_step", "new_replication_degree", "new_world_size",
        "restore_backend", "repair_cost_s", "restore_cost_s")}


@pytest.mark.parametrize("victims", [[1, 5], [2], "rank0_and_partners",
                                     [0, 4, 2]])
def test_plan_recovery_consults_the_store_like_the_reference(victims):
    """A pair death plans a memory restore at the durable generation's
    step and network-bound cost; deaths that take the last copies plan a
    restart from scratch; a cmp death promotes — every field of the plan
    and the new map as the reference's."""
    n = 4
    out = []
    for side in (PORT, REF):
        rmap, _topo, _t, store = build_world(side, n, n, 2, k=2)
        store.save(6, rank_states(n, seed=2))
        dead = victims
        if victims == "rank0_and_partners":
            dead = []
            for r in (0,) + store.placement.partners_of(0):
                dead += [r, r + n]
        new_map, plan = side["plan"](rmap, dead, last_ckpt_step=0,
                                     current_step=9, store=store)
        out.append((_plan_fields(plan), new_map.alive(),
                    store.recoverable_without(dead)))
    assert out[0] == out[1]
    plan = out[0][0]
    if victims == [1, 5]:
        assert plan["restore_backend"] == "memory"
        assert plan["rollback_to_step"] == 6
        assert plan["restore_cost_s"] < 61.0
    if victims == "rank0_and_partners":
        assert plan["restore_backend"] == "scratch"
        assert plan["rollback_to_step"] == 0
    _map, no_store = plan_recovery(ReplicaMap(n, n), [1, 1 + n],
                                   last_ckpt_step=0, current_step=9)
    assert no_store.restore_backend == "disk"


# ------------------------------------------------------- ckpt_policy

POLICY_CASES = {
    "young_daly_interval": [(m, c) for m in (1.0, 800.0, 16000.0)
                            for c in (0.0, 0.25, 46.0)],
    "daly_interval": [(m, c) for m in (1.0, 800.0, 16000.0)
                      for c in (0.0, 0.25, 46.0, 3.0)],
    "ckpt_efficiency": [(m, c, r, i) for m in (800.0, 16000.0)
                        for c in (0.25, 46.0) for r in (0.0, 60.0)
                        for i in (0.0, 100.0)],
    "replication_mtti": [(m, p) for m in (1e5, 3.6e6) for p in (1, 8, 4096)],
    "replication_efficiency": [(m, p, t) for m in (1e5, 3.6e6)
                               for p in (8, 8192) for t in (3600.0, 1e5)],
    "memstore_ckpt_cost": [(b,) for b in (0.0, 1.4e9, 3.4e8)],
    "memstore_restore_cost": [(b,) for b in (0.0, 1.4e9, 3.4e8)],
    "combined_efficiency": [(m, p, c, r) for m in (1e5, 3.6e6)
                            for p in (8, 8192) for c in (0.25, 46.0)
                            for r in (0.5, 1046.0)],
}


@pytest.mark.parametrize("name", sorted(POLICY_CASES))
def test_ckpt_policy_equals_the_reference_to_the_last_bit(name):
    ours, theirs = getattr(ckpt_policy, name), getattr(ref_policy, name)
    for args in POLICY_CASES[name]:
        assert ours(*args) == theirs(*args), (name, args)


def test_ckpt_policy_studies_equal_the_reference():
    c_mem = ckpt_policy.memstore_ckpt_cost(1.4e9)
    kwargs = dict(combined_ckpt_cost_s=c_mem, restart_cost_s=1046.0,
                  combined_restart_cost_s=ckpt_policy.memstore_restore_cost(
                      1.4e9))
    assert ckpt_policy.combined_crossover_processes(
        1024, 16000.0, 46.0, **kwargs) == \
        ref_policy.combined_crossover_processes(1024, 16000.0, 46.0,
                                                **kwargs)
    assert ckpt_policy.crossover_processes(1024, 16000, 46, 10800) == \
        ref_policy.crossover_processes(1024, 16000, 46, 10800) > 0
    assert [vars(p) for p in ckpt_policy.scaling_study(
        1024, 2000.0, 46.0, 1e5)] == \
        [vars(p) for p in ref_policy.scaling_study(1024, 2000.0, 46.0, 1e5)]
    for mtbf in (800.0, 16000.0):
        kw = dict(ckpt_cost_s=0.3, restart_cost_s=2.0, interval_s=30.0)
        assert ckpt_policy.combined_efficiency(mtbf, 64, **kw) == \
            ref_policy.combined_efficiency(mtbf, 64, **kw)


def test_memstore_cost_model():
    c = ckpt_policy.memstore_ckpt_cost(1.4e9, n_partners=2,
                                       net_bw_Bps=12.5e9)
    assert 0.2 < c < 0.3
    assert ckpt_policy.memstore_ckpt_cost(0.0) > 0
    with pytest.raises(ValueError):
        ckpt_policy.memstore_ckpt_cost(-1.0)
    r = ckpt_policy.memstore_restore_cost(1.4e9, relaunch_s=60.0)
    assert 60.0 < r < 61.0


def test_combined_crossover_moves_down_with_memory_backend():
    c_mem = ckpt_policy.memstore_ckpt_cost(1.4e9)
    r_disk = 46.0 + 1000.0
    cross_disk = ckpt_policy.combined_crossover_processes(
        1024, 16000.0, 46.0, restart_cost_s=r_disk,
        combined_restart_cost_s=r_disk)
    cross_mem = ckpt_policy.combined_crossover_processes(
        1024, 16000.0, 46.0, combined_ckpt_cost_s=c_mem,
        restart_cost_s=r_disk,
        combined_restart_cost_s=ckpt_policy.memstore_restore_cost(1.4e9))
    assert 0 < cross_mem < cross_disk


# ------------------------------------------------ MemBackend: tensors

def _backend(side, topology=None, n=8, wpn=4):
    session = side["session"](ft=side["ft"](mode="combined",
                                            topology=topology),
                              n_logical_workers=n, workers_per_node=wpn)
    return side["backend"](session)


def _state(seed, dtype):
    rng = np.random.default_rng(seed)

    def make(*shape):
        if dtype == np.int64:
            return rng.integers(-2**40, 2**40, shape, dtype=np.int64)
        return rng.standard_normal(shape).astype(dtype)
    return {"cache": [{"k": make(3, 5, 4), "v": make(3, 5, 4)}
                      for _ in range(2)],
            "tok": make(3, 1), "out": [np.arange(3, dtype=np.int32)]}


def _tensors(tree):
    """``tree`` with every ndarray of the cache and ``tok`` as a tensor
    (``out`` stays host numpy, as the decode workload keeps it)."""
    return {"cache": [{k: torch.from_numpy(v.copy()) for k, v in d.items()}
                      for d in tree["cache"]],
            "tok": torch.from_numpy(tree["tok"].copy()),
            "out": [a.copy() for a in tree["out"]]}


@pytest.mark.parametrize("topology", [None, "fattree"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_tensor_state_bands_equal_the_numpy_states(dtype, topology):
    """A state of f32, f64 or int64 tensors saves to the reference's
    bands, CRCs and bytes for the same values as ndarrays, and is priced
    the same; restored, every tensor is bitwise the saved one, owns its
    storage, and ``out`` stays numpy."""
    ours, theirs = _backend(PORT, topology), _backend(REF, topology)
    for step, seed in ((0, 1), (4, 2)):
        want = _state(seed, dtype)
        c_ours = ours.save(step, _tensors(want))
        c_theirs = theirs.save(step, copy.deepcopy(want))
        assert c_ours == c_theirs > 0
    assert shard_table(ours.store) == shard_table(theirs.store)
    assert counters(ours.store) == counters(theirs.store)
    assert sorted(ours.manifests) == [ours.store.committed]
    like = _tensors(_state(9, dtype))
    got, step = ours.restore(like)
    ref_got, ref_step = theirs.restore(copy.deepcopy(want))
    assert step == ref_step == 4
    assert ours.last_restore_s == theirs.last_restore_s
    flat = [got["tok"]] + [d[k] for d in got["cache"] for k in ("k", "v")]
    want_flat = [want["tok"]] + [d[k] for d in want["cache"]
                                 for k in ("k", "v")]
    for t, w in zip(flat, want_flat):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), w)
        assert t.numpy().dtype == w.dtype
    assert len({t.untyped_storage().data_ptr() for t in flat}) == len(flat)
    assert isinstance(got["out"][0], np.ndarray)
    np.testing.assert_array_equal(got["out"][0], ref_got["out"][0])


DTYPES = [torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32,
          torch.int64, torch.float16, torch.bfloat16, torch.float32,
          torch.float64, torch.complex64]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_every_dtype_round_trips_bitwise(dtype):
    g = torch.Generator().manual_seed(5)
    x = torch.randn((4, 6), generator=g, dtype=torch.float64)
    src = (x * 100).to(dtype) if not dtype.is_complex else x.to(dtype)
    backend = _backend(PORT)
    backend.save(0, {"a": src, "n": 3})
    got, step = backend.restore({"a": torch.zeros(1)})
    assert step == 0 and got["n"] == 3
    assert got["a"].dtype == dtype and got["a"].shape == src.shape
    assert torch.equal(got["a"], src)


def test_bf16_framing_overhead_and_unsupported_dtypes():
    """bf16 travels as uint16 bits in a tag of the stated pickle framing;
    a dtype numpy lacks and the store cannot encode raises."""
    bits = [np.arange(4, dtype=np.uint16) + i for i in range(3)]
    plain = [len(pickle.dumps(bits[:i], protocol=5)) for i in (1, 2, 3)]
    tagged = [len(pickle.dumps([backend_lib.BF16Bits(b) for b in bits[:i]],
                               protocol=5)) for i in (1, 2, 3)]
    assert tagged[0] - plain[0] == backend_lib.BF16_FIRST_FRAME_BYTES
    assert (tagged[1] - plain[1]) - (tagged[0] - plain[0]) == \
        (tagged[2] - plain[2]) - (tagged[1] - plain[1]) == \
        backend_lib.BF16_FRAME_BYTES
    host, manifest = backend_lib.to_host(
        {"w": torch.arange(4, dtype=torch.bfloat16)})
    assert isinstance(host["w"], backend_lib.BF16Bits)
    assert host["w"].bits.dtype == np.uint16
    assert manifest[0].dtype == torch.bfloat16
    if hasattr(torch, "float8_e4m3fn"):
        with pytest.raises(TypeError, match="float8"):
            backend_lib.to_host({"f8": torch.zeros(3).to(torch.float8_e4m3fn)})


def test_a_view_stores_only_its_elements():
    """A strided view of a large tensor costs its own elements, not its
    base storage's: its blob is the contiguous copy's."""
    base = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
    view = base[::8, 3:5]
    host, _ = backend_lib.to_host({"v": view})
    solo, _ = backend_lib.to_host({"v": view.contiguous()})
    assert len(pickle.dumps(host)) == len(pickle.dumps(solo)) < 4096
    np.testing.assert_array_equal(host["v"], view.numpy())


def test_restore_places_tensors_where_like_has_them():
    """Each tensor comes back on the device of ``like``'s tensor at the
    same place, else on the device it was saved from; no tensor shares a
    storage with ``like`` or with another restored tensor."""
    state = {"a": torch.arange(6.0), "b": [torch.ones(2, dtype=torch.int64)]}
    host, manifest = backend_lib.to_host(state)
    blob = pickle.loads(pickle.dumps(host))
    like = {"a": torch.zeros(6, device="meta")}
    got = backend_lib.from_host(blob, manifest, like)
    assert got["a"].device.type == "meta"
    assert got["b"][0].device.type == "cpu"
    assert torch.equal(got["b"][0], state["b"][0])
    again = backend_lib.from_host(pickle.loads(pickle.dumps(host)), manifest)
    assert torch.equal(again["a"], state["a"])
    assert again["a"].untyped_storage().data_ptr() != \
        state["a"].untyped_storage().data_ptr()
    with pytest.raises(ValueError, match="does not match"):
        backend_lib.from_host({"a": np.zeros(5), "b": blob["b"]}, manifest)


class _TmpWorkload:
    disk_checkpointable = True

    def init_state(self):
        return {"x": np.float64(1.0)}

    def step(self, state, t):
        return {"x": state["x"] + t}, None


def test_backend_selection_matches_the_reference(tmp_path):
    """``make_backend`` picks ``DiskBackend`` exactly where the reference
    does (``ckpt_backend="disk"``, a ckpt_dir and a disk-checkpointable
    workload) and ``MemBackend`` elsewhere; the disk run's checkpoints are
    on disk and its report is the reference's."""
    def run(session_cls, ft_cls, backend, wl, ckpt_dir=None):
        s = session_cls(ft=ft_cls(mode="combined", ckpt_interval_s=2.0,
                                  ckpt_backend=backend),
                        ckpt_dir=ckpt_dir, n_logical_workers=4,
                        workers_per_node=2, injector={3: [1], 4: [5]})
        return s, s.run(wl, 6)
    memory_only = _TmpWorkload()
    memory_only.disk_checkpointable = False
    cases = [("disk", _TmpWorkload(), "a", "disk"),
             ("disk", _TmpWorkload(), None, "memory"),
             ("memory", _TmpWorkload(), "b", "memory"),
             ("disk", memory_only, "c", "memory")]
    for backend, wl, sub, kind in cases:
        sessions, reports = [], []
        for side, (cls, ft_cls) in {"port": (FTSession, FTConfig),
                                    "ref": (RefFTSession,
                                            RefFTConfig)}.items():
            ckpt = str(tmp_path / side / sub) if sub else None
            sess, rep = run(cls, ft_cls, backend, wl, ckpt)
            assert sess.strategy.backend.kind == kind, (side, backend, sub)
            sessions.append(sess)
            reports.append(rep)
        (port_sess, ref_sess), (port, ref) = sessions, reports
        assert port.restarts == 1            # a pair death: from the backend
        assert (port.restarts, port.ckpt_writes, port.rolled_back_steps) \
            == (ref.restarts, ref.ckpt_writes, ref.rolled_back_steps)
        assert float(port.final_state["x"]) == float(ref.final_state["x"])
        want = {"disk": (DiskBackend, RefDiskBackend),
                "memory": (MemBackend, RefMemBackend)}[kind]
        assert isinstance(port_sess.strategy.backend, want[0])
        assert isinstance(ref_sess.strategy.backend, want[1])
        if kind == "disk":
            assert (tmp_path / "port" / sub / "LATEST").read_text() == \
                (tmp_path / "ref" / sub / "LATEST").read_text()
    with pytest.raises(ValueError):
        run(FTSession, FTConfig, "tape", _TmpWorkload())


# ------------------------------------------------------------ sessions

class CounterWorkload:
    disk_checkpointable = False

    def init_state(self):
        return {"x": np.float64(1.0), "hist": np.zeros(4)}

    def step(self, state, t):
        x = state["x"] * 1.0000001 + np.sin(0.1 * t)
        hist = np.roll(state["hist"], 1)
        hist[0] = x
        return {"x": x, "hist": hist}, float(x)


class VecCounterWorkload(CounterWorkload):
    """The counter with ``x`` a one-element array."""

    def init_state(self):
        return {"x": np.ones(1), "hist": np.zeros(4)}

    def step(self, state, t):
        x = state["x"] * 1.0000001 + np.sin(0.1 * t)
        hist = np.roll(state["hist"], 1)
        hist[0] = x[0]
        return {"x": x, "hist": hist}, float(x[0])


class TensorCounterWorkload(CounterWorkload):
    """``VecCounterWorkload``'s arithmetic on f64 CPU tensors."""

    def init_state(self):
        return {"x": torch.ones(1, dtype=torch.float64),
                "hist": torch.zeros(4, dtype=torch.float64)}

    def step(self, state, t):
        x = state["x"] * 1.0000001 + np.sin(0.1 * t)
        hist = torch.roll(state["hist"], 1)
        hist[0] = x[0]
        return {"x": x, "hist": hist}, float(x[0])


SESSIONS = [  # (mode, kills, interval, n, wpn, steps)
    ("combined", {4: [1], 8: [9]}, 4.0, 8, 4, 12),   # promote, pair death
    ("checkpoint", {7: [2]}, 3.0, 8, 4, 12),         # restart from memory
    ("checkpoint", {3: [0], 9: [5, 6]}, 2.0, 8, 4, 14),
    ("combined", {5: [0, 4]}, 0.0, 4, 2, 10),        # Young-Daly interval
    ("combined", {2: [1], 6: [0, 2, 3, 4, 6, 7]}, 3.0, 4, 2, 10),
]


def _run(side, mode, kills, interval, n, wpn, steps, topology=None,
         workload=CounterWorkload):
    session = side["session"](
        ft=side["ft"](mode=mode, ckpt_interval_s=interval,
                      ckpt_backend="memory", topology=topology),
        injector=dict(kills), n_logical_workers=n, workers_per_node=wpn)
    return session, session.run(workload(), steps)


REPORT_FIELDS = ("steps", "metrics", "failures", "promotions", "restarts",
                 "ckpt_writes", "rolled_back_steps")


def assert_reports_equal(ours, theirs):
    for name in REPORT_FIELDS:
        assert getattr(ours, name) == getattr(theirs, name), name
    assert [(e.step, e.kind, e.detail) for e in ours.events] == \
        [(e.step, e.kind, e.detail) for e in theirs.events]
    assert ours.time.as_dict() == theirs.time.as_dict()


@pytest.mark.parametrize("topology", [None, "fattree"])
@pytest.mark.parametrize("case", range(len(SESSIONS)))
def test_checkpoint_sessions_match_the_reference(case, topology):
    """checkpoint and combined sessions through MemBackend: promotions,
    pair deaths, elastic restarts from partner memory (or from scratch
    when the shards are gone) — every RunReport field, the events, the
    priced ledger and the final state equal the reference's, priced or
    not."""
    args = SESSIONS[case]
    s_ours, ours = _run(PORT, *args, topology=topology)
    s_theirs, theirs = _run(REF, *args, topology=topology)
    assert_reports_equal(ours, theirs)
    assert ours.final_state["x"] == theirs.final_state["x"]
    np.testing.assert_array_equal(ours.final_state["hist"],
                                  theirs.final_state["hist"])
    assert counters(s_ours.strategy.backend.store) == \
        counters(s_theirs.strategy.backend.store)
    assert ours.ckpt_writes >= 1


def test_session_pair_death_memory_backend_bitwise():
    """FT theorem through the memory backend: promote, then pair death,
    elastic restart restored from partner shards — the final state equals
    the failure-free run's."""
    _, clean = _run(PORT, "none", {}, 0.0, 8, 4, 12)
    session, rep = _run(PORT, *SESSIONS[0])
    assert rep.promotions == 1 and rep.restarts == 1
    assert rep.ckpt_writes >= 1 and rep.rolled_back_steps > 0
    restart = [e for e in rep.events if e.kind == "restart_elastic"]
    assert restart and restart[0].detail["restore_backend"] == "memory"
    assert clean.final_state["x"] == rep.final_state["x"]
    np.testing.assert_array_equal(clean.final_state["hist"],
                                  rep.final_state["hist"])
    assert session.strategy.backend.store.durable() is not None


def test_session_checkpoint_only_memory_backend():
    _, clean = _run(PORT, "none", {}, 0.0, 8, 4, 12)
    _, rep = _run(PORT, *SESSIONS[1])
    assert rep.restarts == 1 and rep.ckpt_writes >= 1
    assert clean.final_state["x"] == rep.final_state["x"]


@pytest.mark.parametrize("case", [0, 1])
def test_tensor_workload_sessions_match_the_numpy_reference(case):
    """The counter on f64 tensors through the port's session and store
    against the reference's on ndarrays: the same report and ledger (the
    store's bytes and priced costs depend only on the values), the
    restored state bitwise, and tensors again after the restart."""
    _, ours = _run(PORT, *SESSIONS[case], topology="fattree",
                   workload=TensorCounterWorkload)
    _, theirs = _run(REF, *SESSIONS[case], topology="fattree",
                     workload=VecCounterWorkload)
    assert ours.restarts == 1
    assert_reports_equal(ours, theirs)
    assert isinstance(ours.final_state["hist"], torch.Tensor)
    np.testing.assert_array_equal(ours.final_state["x"].numpy(),
                                  theirs.final_state["x"])
    np.testing.assert_array_equal(ours.final_state["hist"].numpy(),
                                  theirs.final_state["hist"])


# ------------------------------------------------- the served decode loop

def _cache_tensors(state):
    out = []

    def visit(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
    visit(state)
    return out


@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-7b"])
@pytest.mark.parametrize("mode,kills,interval", [
    ("combined", {4: [1], 8: [9]}, 4.0),
    ("checkpoint", {7: [2]}, 3.0)])
def test_decode_restarts_from_partner_memory_bitwise(arch, mode, kills,
                                                     interval):
    """The reduced server's decode loop under the checkpoint strategies
    (8 logical ranks, 4 a node): the restart restores the KV rings (and
    the hybrid's Mamba states) from partner memory, and the token stream
    and the whole final state equal the clean run's bit for bit."""
    from repro_torch.launch.serve import ReplicatedServer
    prompts = np.random.default_rng(11).integers(0, 400, (2, 16),
                                                 dtype=np.int32)
    srv = ReplicatedServer(arch, batch=2, prompt_len=16, device="cpu")
    clean = srv.generate(prompts, 12)
    clean_state = _cache_tensors(srv.last_report.final_state["cache"])
    session = FTSession(ft=FTConfig(mode=mode, ckpt_backend="memory",
                                    ckpt_interval_s=interval),
                        injector=dict(kills), n_logical_workers=8,
                        workers_per_node=4)
    rep = session.run(srv.workload(prompts), 12)
    restart = [e for e in rep.events if e.kind == "restart_elastic"]
    assert rep.restarts == 1 and rep.ckpt_writes >= 2
    assert restart[0].detail["restore_backend"] == "memory"
    np.testing.assert_array_equal(
        np.concatenate(rep.final_state["out"], axis=1), clean)
    state = _cache_tensors(rep.final_state["cache"])
    assert len(state) == len(clean_state)
    assert all(torch.equal(a, b) for a, b in zip(state, clean_state))
    assert rep.time.restore >= 0 and rep.time.ckpt_write > 0
