"""repro_torch.topo — cluster topology + α‑β communication cost subsystem
(the PyTorch port of ``repro.topo``, with the same public names).

  graph       - flat / fat-tree / dragonfly / 3-D-torus topologies:
                hop distances, link paths for contention, node→failure-
                domain mapping, and the dist_graph neighbor lists the
                neighborhood collectives take;
  costs       - TopoCostModel: α·hops + size/β (+ γ·size) per message,
                contended round pricing, closed-form estimators for every
                collective algorithm, and the in-memory store's C and R;
  algorithms  - binomial-tree bcast/gather, ring allgather/reduce_scatter/
                allreduce and recursive-doubling allreduce/allgather as
                p2p schedules over ReplicaTransport (inheriting logging /
                replay / dedup), with an MPICH-style SelectionPolicy and
                make_topo_ops() registry for CollectiveEngine.

Configured through FTConfig.topology / topo_alpha / topo_beta /
topo_gamma / topo_small_msg (``clock.pricing.pricing_from_ft``).
"""
from repro_torch.topo.algorithms import (SelectingOp, SelectionPolicy,
                                         make_topo_ops)
from repro_torch.topo.costs import COLLECTIVE_ALGOS, TopoCostModel
from repro_torch.topo.graph import (DragonflyTopology, FatTreeTopology,
                                    FlatTopology, TopoGraph, Torus3DTopology,
                                    line_neighbors, make_topology,
                                    ring_neighbors)

__all__ = [
    "TopoGraph", "FlatTopology", "FatTreeTopology", "DragonflyTopology",
    "Torus3DTopology", "make_topology", "line_neighbors", "ring_neighbors",
    "TopoCostModel", "COLLECTIVE_ALGOS",
    "SelectionPolicy", "SelectingOp", "make_topo_ops",
]
