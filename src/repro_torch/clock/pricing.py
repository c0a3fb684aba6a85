"""Cost-model injection: FTConfig.topology -> the priced fabric pieces
(port of ``repro/clock/pricing.py``).

``pricing_from_ft`` builds the ``TopoGraph`` over the cluster's nodes,
wraps it in a ``TopoCostModel`` with the FTConfig's α/β/γ, attaches the
worker→node map, and swaps the collective registry to the MPICH-style
selecting ops. ``ClockPricing`` is what it returns: ``graph``,
``cost_model`` (fed to every ``ReplicaTransport`` and kept on the
``VirtualClock``) and ``engine_ops`` (fed to ``CollectiveEngine``). All
three are ``None`` when no topology is configured.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class ClockPricing:
    """The priced-fabric triple built from one FTConfig."""

    graph: object = None          # topo.TopoGraph
    cost_model: object = None     # topo.TopoCostModel
    engine_ops: Optional[dict] = None   # CollectiveEngine registry

    @property
    def priced(self) -> bool:
        return self.cost_model is not None


def pricing_from_ft(ft, cluster) -> ClockPricing:
    """Build the priced fabric for ``ft`` over ``cluster`` (a
    ``ClusterTopology``); re-attach after elastic restarts with
    ``pricing.cost_model.attach(new_cluster)``. Returns an un-priced
    ``ClockPricing`` when ``ft.topology`` is unset."""
    if not getattr(ft, "topology", None):
        return ClockPricing()
    # lazy: topo pulls in the algorithm registry; unpriced runs (the
    # default) never pay the import
    from repro_torch.topo import (SelectionPolicy, TopoCostModel,
                                  make_topo_ops, make_topology)
    graph = make_topology(ft.topology, cluster.n_nodes)
    cost_model = TopoCostModel(graph, alpha_s=ft.topo_alpha,
                               beta_Bps=ft.topo_beta,
                               gamma_s_per_B=ft.topo_gamma)
    cost_model.attach(cluster)
    engine_ops = make_topo_ops(
        SelectionPolicy(small_msg_bytes=ft.topo_small_msg))
    return ClockPricing(graph=graph, cost_model=cost_model,
                        engine_ops=engine_ops)
