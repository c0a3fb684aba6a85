"""α‑β(+γ) per-message communication costs over a TopoGraph.

LogGP-style pricing: a message of ``s`` bytes travelling ``h`` hops costs

    α·h + s/β + γ·s

with α the per-hop latency, β the link bandwidth and γ an optional
per-byte processing overhead.  ``round_time`` prices a *round* of
concurrent messages with link contention: every message deposits its
bytes on every link of its route, and the round finishes when the most
loaded link drains (links carry ``graph.link_share`` of β — fat-tree
up-links divide by the oversubscription factor).

``TopoCostModel`` is the object the transport takes (``msg_cost_workers``
per delivered message) and the closed-form estimator the policy layer
takes (``collective_time`` per algorithm, ``memstore_ckpt_cost`` /
``memstore_restore_cost`` for the in-memory store's C and R).  On a
``flat`` graph with the default α/β the estimators reduce exactly to the
pre-topo constants in ``core.ckpt_policy`` — the property tests pin this.

The PyTorch port's copy of ``repro/topo/costs.py`` (pure Python).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.topo.graph import TopoGraph

# the default network of the JAX package's checkpoint policy
# (``core/ckpt_policy.py``), copied here until that module is ported
DEFAULT_NET_BW_BPS = 12.5e9
DEFAULT_NET_LATENCY_S = 100e-6

# algorithms each collective can be priced under (see topo.algorithms for
# the executable schedules; "dense" is the pre-topo exchange, "switchboard"
# the role-matched allreduce — both price identically)
COLLECTIVE_ALGOS = {
    "bcast": ("dense", "tree"),
    "gather": ("dense", "tree"),
    "allgather": ("dense", "ring", "rd"),
    "allreduce": ("dense", "switchboard", "ring", "rd"),
    "reduce_scatter": ("dense", "ring"),
    "alltoall": ("dense",),
}


@dataclass
class TopoCostModel:
    """Prices messages on a graph; attach a ClusterTopology to map the
    transport's worker ids onto graph nodes."""

    graph: TopoGraph
    alpha_s: float = DEFAULT_NET_LATENCY_S       # per-hop latency
    beta_Bps: float = DEFAULT_NET_BW_BPS         # per-link bandwidth
    gamma_s_per_B: float = 0.0                   # per-byte overhead
    cluster: object = None                       # ClusterTopology (attach())

    def __post_init__(self):
        if self.alpha_s < 0 or self.beta_Bps <= 0 or self.gamma_s_per_B < 0:
            raise ValueError("need alpha >= 0, beta > 0, gamma >= 0")

    # -- worker plumbing -----------------------------------------------------

    def attach(self, cluster) -> None:
        """Bind the worker->node map (re-bound after elastic restarts)."""
        self.cluster = cluster

    def node_of_worker(self, wid: int) -> int:
        node = self.cluster.node_of(wid) if self.cluster is not None else wid
        return node % self.graph.n_nodes

    # -- per-message pricing -------------------------------------------------

    def msg_cost(self, src_node: int, dst_node: int, nbytes: int) -> float:
        h = self.graph.hops(src_node, dst_node)
        return self.alpha_s * h + nbytes / self.beta_Bps \
            + self.gamma_s_per_B * nbytes

    def msg_cost_workers(self, src_wid: int, dst_wid: int,
                         nbytes: int) -> float:
        return self.msg_cost(self.node_of_worker(src_wid),
                             self.node_of_worker(dst_wid), nbytes)

    def round_time(self, msgs: Iterable[Tuple[int, int, int]]) -> float:
        """Completion time of concurrent messages [(src_node, dst_node,
        nbytes)] with link contention: α·(longest route) + the most loaded
        link's drain time (+ γ on the largest message)."""
        load: Dict[object, float] = {}
        max_hops = 0
        max_bytes = 0
        for src, dst, nbytes in msgs:
            links = self.graph.links_on_path(src, dst)
            max_hops = max(max_hops, self.graph.hops(src, dst))
            max_bytes = max(max_bytes, nbytes)
            for link in links:
                load[link] = load.get(link, 0.0) + \
                    nbytes / (self.beta_Bps * self.graph.link_share(link))
        drain = max(load.values()) if load else 0.0
        return self.alpha_s * max_hops + drain \
            + self.gamma_s_per_B * max_bytes

    # -- closed-form collective estimators -----------------------------------

    def _per_msg(self, nbytes: float, hops: float) -> float:
        return self.alpha_s * hops + nbytes / self.beta_Bps \
            + self.gamma_s_per_B * nbytes

    def collective_time(self, kind: str, algo: str, n: int, nbytes: float,
                        *, hops: Optional[float] = None) -> float:
        """Per-rank completion-time estimate for one collective of ``n``
        ranks with per-rank contribution ``nbytes``, under ``algo``.
        ``hops`` overrides the graph's average hop distance (ring
        algorithms always use the neighbor distance)."""
        if n < 1 or nbytes < 0:
            raise ValueError("need n >= 1 and nbytes >= 0")
        if algo not in COLLECTIVE_ALGOS.get(kind, ()):
            raise ValueError(f"no {algo!r} pricing for {kind!r}; "
                             f"known: {COLLECTIVE_ALGOS.get(kind)}")
        if n == 1:
            return 0.0
        h = self.graph.avg_hops() if hops is None else hops
        hn = self.graph.neighbor_hops()
        log_n = math.ceil(math.log2(n))
        if algo in ("dense", "switchboard"):
            # one message to/from every peer (root-bound for the rooted
            # collectives, symmetric for the rest)
            return (n - 1) * self._per_msg(nbytes, h)
        if kind == "bcast":                      # binomial tree
            return log_n * self._per_msg(nbytes, h)
        if kind == "gather":                     # binomial tree: the root
            # still receives (n-1) payloads, but in log rounds
            return log_n * self.alpha_s * h \
                + (n - 1) * (nbytes / self.beta_Bps
                             + self.gamma_s_per_B * nbytes)
        if kind == "allgather":
            if algo == "ring":                   # n-1 neighbor steps
                return (n - 1) * self._per_msg(nbytes, hn)
            # recursive doubling: log rounds, doubling payloads
            return log_n * self.alpha_s * h \
                + (n - 1) * (nbytes / self.beta_Bps
                             + self.gamma_s_per_B * nbytes)
        if kind == "allreduce":
            if algo == "ring":                   # RS + AG, s/n chunks
                return 2 * (n - 1) * self._per_msg(nbytes / n, hn)
            return log_n * self._per_msg(nbytes, h)      # rd: full vector
        if kind == "reduce_scatter":             # ring: n-1 chunk steps
            return (n - 1) * self._per_msg(nbytes, hn)
        raise ValueError(f"no estimator for ({kind!r}, {algo!r})")

    # -- in-memory store C and R ---------------------------------------------

    def _cross_domain_share(self) -> float:
        """Worst link share on a representative cross-failure-domain path.
        Partner placement deliberately leaves the owner's domain, so store
        pushes cross the graph's shared links (fat-tree up-links divided
        by the oversubscription factor); flat graphs return 1.0."""
        g = self.graph
        for b in range(1, g.n_nodes):
            if g.failure_domain(b) != g.failure_domain(0):
                return min((g.link_share(link)
                            for link in g.links_on_path(0, b)), default=1.0)
        return 1.0

    def memstore_ckpt_cost(self, state_bytes: float, *, n_partners: int = 2,
                           n_messages: int = 4,
                           hops: Optional[float] = None) -> float:
        """Network-bound checkpoint cost C: each process serializes
        ``n_partners`` shard copies (``n_messages`` messages each) through
        its NIC across ``hops`` switch hops, at the bandwidth the
        cross-domain path actually offers.  Flat graph + default α/β
        reduces to ckpt_policy.memstore_ckpt_cost exactly."""
        if state_bytes < 0 or n_partners < 1 or n_messages < 1:
            raise ValueError("need state_bytes >= 0, partners/messages >= 1")
        h = self.graph.avg_hops() if hops is None else hops
        bw = self.beta_Bps * self._cross_domain_share()
        return n_partners * (state_bytes / bw
                             + self.gamma_s_per_B * state_bytes
                             + n_messages * self.alpha_s * h)

    def memstore_restore_cost(self, state_bytes: float, *,
                              relaunch_s: float = 60.0) -> float:
        """One partner pull (over the cross-domain path) + job relaunch
        (per-message latency is noise next to the relaunch; flat graph
        reduces to the ckpt_policy form)."""
        if state_bytes < 0 or relaunch_s < 0:
            raise ValueError("need state_bytes >= 0 and relaunch >= 0")
        bw = self.beta_Bps * self._cross_domain_share()
        return state_bytes / bw \
            + self.gamma_s_per_B * state_bytes + relaunch_s
