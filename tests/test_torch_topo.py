"""The port's topology pricing against the JAX package's, exactly.

``repro_torch.topo`` is a copy of ``repro.topo``: the graphs and the α‑β
cost model are pure Python (the same hops, links and float seconds), and
the algorithm registry takes tensor payloads where the reference takes
ndarrays — the same algorithm for the same bytes, the same chunks, the
same combine order. Worlds run through
``repro_torch.comm.worlds.run_world`` (see ``tests/test_torch_comm.py``)
with the reference's fabric on ndarrays and the port's on CPU tensors;
results, sender logs and priced seconds must be equal, no tolerance.
"""
import numpy as np
import pytest
import torch
from test_torch_comm import (REF_FABRIC, TORCH_DTYPES, array_maker,
                             assert_same_world)

from repro.core.coordinator import ClusterTopology as RefCluster
from repro.topo import SelectionPolicy as RefPolicy
from repro.topo import TopoCostModel as RefCostModel
from repro.topo import line_neighbors as ref_line_neighbors
from repro.topo import make_topology as ref_make_topology
from repro.topo import ring_neighbors as ref_ring_neighbors
from repro_torch.comm.worlds import (PORT_FABRIC, CommZoo, run_world,
                                     tensor_maker)
from repro_torch.core.coordinator import ClusterTopology
from repro_torch.topo import (COLLECTIVE_ALGOS, SelectionPolicy,
                              TopoCostModel, line_neighbors, make_topo_ops,
                              make_topology, ring_neighbors)
from repro_torch.topo.algorithms import (TAG_RD_ALLREDUCE, TAG_RING_AG,
                                         TAG_RING_RS)

TOPOLOGIES = ("flat", "fattree", "dragonfly", "torus3d")
OPTIONS = {"flat": [{}],
           "fattree": [{}, {"radix": 3, "oversubscription": 2.5}],
           "dragonfly": [{}, {"group_size": 3}],
           "torus3d": [{}, {"dims": (2, 3, 4)}]}
SIZES = (0, 1, 1000, 8191, 8192, 1 << 20)


def _graph_facts(g):
    n = g.n_nodes
    pairs = [(a, b) for a in range(n) for b in range(n)]
    return {"hops": [g.hops(a, b) for a, b in pairs],
            "links": [g.links_on_path(a, b) for a, b in pairs],
            "shares": [[g.link_share(link) for link in g.links_on_path(a, b)]
                       for a, b in pairs],
            "neighbors": [g.neighbors(a) for a in range(n)],
            "domains": [g.failure_domain(a) for a in range(n)],
            "avg": g.avg_hops(), "nbr": g.neighbor_hops(),
            "dims": getattr(g, "dims", None)}


@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("n", [1, 2, 5, 8, 17, 64])
def test_graphs_match_the_reference(name, n):
    for kw in OPTIONS[name]:
        if name == "torus3d" and kw and n > 24:
            continue                          # dims hold 24 nodes
        assert _graph_facts(make_topology(name, n, **kw)) == \
            _graph_facts(ref_make_topology(name, n, **kw))


@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("n_workers,per_node", [(3, 1), (7, 2), (24, 4)])
def test_costs_match_the_reference(name, n_workers, per_node):
    """msg_cost per worker pair and size, round_time, every closed-form
    estimator and the store's C and R: the same floats."""
    def facts(make, model_cls, cluster_cls):
        cluster = cluster_cls(n_workers, per_node)
        g = make(name, cluster.n_nodes)
        cm = model_cls(g, alpha_s=3e-6, beta_Bps=2.5e10, gamma_s_per_B=1e-12)
        cm.attach(cluster)
        ws = range(n_workers)
        out = [cm.msg_cost_workers(a, b, s) for a in ws for b in ws
               for s in SIZES]
        out.append(cm.round_time([(a % g.n_nodes, (a * 3 + 1) % g.n_nodes,
                                   1000 * a) for a in ws]))
        for kind, algos in sorted(COLLECTIVE_ALGOS.items()):
            for algo in algos:
                for k in (1, 2, 5, 16):
                    out.append(cm.collective_time(kind, algo, k, 4096.0))
        out += [cm.memstore_ckpt_cost(1e9), cm.memstore_restore_cost(1e9)]
        return out
    assert facts(make_topology, TopoCostModel, ClusterTopology) == \
        facts(ref_make_topology, RefCostModel, RefCluster)


def test_neighbor_lists_match_the_reference():
    for n in range(1, 12):
        assert line_neighbors(n) == ref_line_neighbors(n)
        assert ring_neighbors(n) == ref_ring_neighbors(n)


def test_unknown_topology_rejected():
    with pytest.raises(ValueError, match="unknown topology"):
        make_topology("hypercube", 4)


KINDS = ("bcast", "gather", "allgather", "allreduce", "reduce_scatter",
         "alltoall")


@pytest.mark.parametrize("small", [64, 8192])
@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "int64"))
def test_selection_is_the_same_for_a_tensor_as_for_its_array(small, dtype):
    """On both sides of ``topo_small_msg``: a tensor picks what an ndarray
    of the same shape and dtype picks, in the port and in the reference."""
    ours, theirs = SelectionPolicy(small), RefPolicy(small)
    width = small // np.dtype(array_maker(dtype)(0).dtype).itemsize
    for elems in (1, width - 1, width, width + 1, 4 * width):
        a = array_maker(dtype)(np.ones(elems))
        t = tensor_maker(TORCH_DTYPES[dtype], "cpu")(np.ones(elems))
        for n in range(1, 10):
            for kind in KINDS:
                op_a = (kind, [a] * n if kind == "reduce_scatter" else a,
                        "sum")
                op_t = (kind, [t] * n if kind == "reduce_scatter" else t,
                        "sum")
                want = theirs.choose(kind, n, op_a)
                assert ours.choose(kind, n, op_t) == want, (kind, n, elems)
                assert ours.choose(kind, n, op_a) == want


def test_registry_matches_the_reference():
    from repro.topo import make_topo_ops as ref_make_topo_ops
    ours, theirs = make_topo_ops(), ref_make_topo_ops()
    assert sorted(ours) == sorted(theirs)
    for kind in ours:
        assert sorted(ours[kind].pending_heads()) == \
            sorted(theirs[kind].pending_heads())


def _tags(world):
    return {entry[3] for log in world["logs"].values() for entry in log}


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("n,m,small", [(4, 2, 16), (4, 4, 8192),
                                       (5, 2, 16), (8, 3, 8192)])
@pytest.mark.parametrize("dtype", ("float32", "int64"))
def test_topo_collectives_match_the_reference(topology, n, m, small, dtype):
    """Every collective under the selecting registry (trees, rings,
    recursive doubling) and α‑β pricing, with rank 1's computational
    worker killed mid-schedule: the port on tensors and the reference on
    ndarrays give the same results, logs, replays and priced seconds.
    Small worlds with a low threshold run the ring allreduce; power-of-two
    worlds with the default one run recursive doubling."""
    steps, kills = 3, [(1, 2, 1)]
    kw = dict(redop="sum", integer=dtype == "int64")
    ours = run_world(PORT_FABRIC,
                     CommZoo(n, tensor_maker(TORCH_DTYPES[dtype], "cpu"),
                             **kw),
                     n, m, steps, kills=kills, topology=topology,
                     small_msg=small)
    theirs = run_world(REF_FABRIC, CommZoo(n, array_maker(dtype), **kw),
                       n, m, steps, kills=kills, topology=topology,
                       small_msg=small)
    assert_same_world(ours, theirs)
    assert ours["promotions"] == 1 and sum(ours["comm_s"]) > 0
    tags = _tags(ours)
    if small == 16:
        assert {TAG_RING_RS, TAG_RING_AG} <= tags
    else:
        assert TAG_RD_ALLREDUCE in tags


def test_ring_allreduce_splits_like_array_split():
    """The ring's chunks of a tensor are ``np.array_split``'s, and its
    result the reference's bits, on a length the world does not divide."""
    n, shape = 5, (13, 2)
    ours = run_world(PORT_FABRIC, _RingProbe(n, shape, torch.from_numpy), n,
                     0, 1, topology="flat", small_msg=8)
    theirs = run_world(REF_FABRIC, _RingProbe(n, shape, np.asarray), n, 0, 1,
                       topology="flat", small_msg=8)
    assert_same_world(ours, theirs)
    want = [len(c) for c in np.array_split(np.zeros(shape), n)]
    sent = [(e[5][1][0], e[5][1][1][2]) for log in ours["logs"].values()
            for e in log if e[3] == TAG_RING_RS]    # (index, chunk shape)
    assert len(sent) == n * (n - 1)
    assert all(shp == (want[d], 2) for d, shp in sent)


class _RingProbe:
    def __init__(self, n, shape, make):
        self.n, self.shape, self.make = n, shape, make

    def init_state(self, rank):
        return {}

    def step(self, rank, state, t):
        rng = np.random.default_rng(rank)
        out = yield ("allreduce", self.make(rng.uniform(0.5, 2.0, self.shape)),
                     "sum")
        return {"out": out}


def test_priced_bytes_of_a_tensor_equal_its_arrays():
    """One message of an int32 [4, 512] batch costs what its ndarray
    costs, on every topology."""
    batch = np.zeros((4, 512), np.int32)
    for name in TOPOLOGIES:
        seconds = []
        for fab, payload in ((PORT_FABRIC, torch.from_numpy(batch.copy())),
                             (REF_FABRIC, batch)):
            rmap = fab.ReplicaMap(2, 1)
            pricing = fab.pricing_from_ft(fab.FTConfig(topology=name),
                                          fab.ClusterTopology(3, 1))
            t = fab.ReplicaTransport(rmap, 2, cost_model=pricing.cost_model)
            eps = {w: t.register(w) for w in rmap.alive()}
            t.send(eps[rmap.cmp[1]], 0, 0, payload, 0, log=True)
            seconds.append(t.take_comm_time())
        assert seconds[0] == seconds[1] > 0
