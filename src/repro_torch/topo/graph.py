"""Cluster topology graphs: hop distances, link paths, failure domains.

The simulator's virtual time so far priced communication with flat
constants; this module gives it a *shape*.  A ``TopoGraph`` models the
cluster's nodes and the links between them and answers the three queries
the rest of the stack needs:

  * ``hops(a, b)``        — switch/router hops between two nodes (the α
                            multiplier of the α‑β cost model, topo.costs);
  * ``links_on_path(a,b)``— the shared-link ids a message crosses, so a
                            round of concurrent messages can be priced
                            with contention (max bytes over any link);
  * ``failure_domain(n)`` — the infrastructure unit a node dies with
                            (edge switch, dragonfly group, or just the
                            node), reused by ``store.placement`` so
                            checkpoint shards avoid their owner's blast
                            radius, not just its node.

Four topologies cover the regimes the FT literature prices collectives
on: ``flat`` (single crossbar — reduces every cost to the old constants),
``fattree`` (two-level Clos with an oversubscription knob), ``dragonfly``
(groups with all-to-all local and one global link per group pair), and
``torus3d`` (3-D wraparound mesh, dimension-ordered routing).

``line_neighbors`` / ``ring_neighbors`` are the MPI ``dist_graph``
neighbor lists the neighborhood collectives take (comm.collectives);
apps build them once per decomposition (cloverleaf's slab halo is the
worked example).

The PyTorch port's copy of ``repro/topo/graph.py`` (pure Python).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple


class TopoGraph:
    """Base contract; subclasses fill in the structure."""

    kind: str = ""

    def __init__(self, n_nodes: int):
        if n_nodes < 1:
            raise ValueError("need at least one node")
        self.n_nodes = n_nodes

    # -- structure queries ---------------------------------------------------

    def hops(self, a: int, b: int) -> int:
        raise NotImplementedError

    def links_on_path(self, a: int, b: int) -> Tuple:
        """Hashable link ids the (a -> b) route crosses, for contention."""
        raise NotImplementedError

    def neighbors(self, node: int) -> List[int]:
        """Directly-attached peers (one switch/link away)."""
        raise NotImplementedError

    def failure_domain(self, node: int) -> int:
        """Infrastructure unit this node shares fate with (itself by
        default; switches/groups for the hierarchical topologies)."""
        return node

    def link_share(self, link) -> float:
        """Relative capacity of a link (1.0 = full β; fat-tree up-links
        divide by the oversubscription factor)."""
        return 1.0

    # -- aggregate hop statistics (closed form; used by the estimators) ------

    def avg_hops(self) -> float:
        """Expected hops between two distinct uniformly-random nodes."""
        raise NotImplementedError

    def neighbor_hops(self) -> float:
        """Average hops between consecutively-numbered nodes — the cost of
        one ring-algorithm step under the usual rank-major placement."""
        n = self.n_nodes
        if n < 2:
            return 0.0
        return sum(self.hops(i, (i + 1) % n) for i in range(n)) / n

    def _check(self, *nodes) -> None:
        for x in nodes:
            if not 0 <= x < self.n_nodes:
                raise ValueError(f"node {x} outside [0, {self.n_nodes})")


class FlatTopology(TopoGraph):
    """One non-blocking crossbar: every pair is one hop apart and shares
    only its own host links — the degenerate graph under which every
    topo cost reduces to the pre-topo constants."""

    kind = "flat"

    def hops(self, a, b):
        self._check(a, b)
        return 0 if a == b else 1

    def links_on_path(self, a, b):
        self._check(a, b)
        if a == b:
            return ()
        return (("host", a), ("host", b))

    def neighbors(self, node):
        self._check(node)
        return [x for x in range(self.n_nodes) if x != node]

    def avg_hops(self):
        return 1.0 if self.n_nodes > 1 else 0.0


class FatTreeTopology(TopoGraph):
    """Two-level Clos: ``radix`` hosts per edge switch, a non-blocking
    core, and an optional up-link oversubscription factor.  Same-switch
    traffic is 2 hops (up + down through the edge switch); cross-switch
    traffic is 4 (host–edge, edge–core, core–edge, edge–host) and shares
    the two edge up-links — where contention lives."""

    kind = "fattree"

    def __init__(self, n_nodes: int, radix: int = 8,
                 oversubscription: float = 1.0):
        super().__init__(n_nodes)
        if radix < 1 or oversubscription < 1.0:
            raise ValueError("need radix >= 1 and oversubscription >= 1")
        self.radix = radix
        self.oversubscription = oversubscription

    def switch_of(self, node: int) -> int:
        return node // self.radix

    @property
    def n_switches(self) -> int:
        return -(-self.n_nodes // self.radix)

    def hops(self, a, b):
        self._check(a, b)
        if a == b:
            return 0
        return 2 if self.switch_of(a) == self.switch_of(b) else 4

    def links_on_path(self, a, b):
        self._check(a, b)
        if a == b:
            return ()
        sa, sb = self.switch_of(a), self.switch_of(b)
        if sa == sb:
            return (("host", a), ("host", b))
        return (("host", a), ("up", sa), ("up", sb), ("host", b))

    def link_share(self, link):
        if link[0] == "up":
            return 1.0 / self.oversubscription
        return 1.0

    def neighbors(self, node):
        """Same-edge-switch peers (one switch away)."""
        self._check(node)
        lo = self.switch_of(node) * self.radix
        return [x for x in range(lo, min(lo + self.radix, self.n_nodes))
                if x != node]

    def failure_domain(self, node):
        self._check(node)
        return self.switch_of(node)

    def avg_hops(self):
        n = self.n_nodes
        if n < 2:
            return 0.0
        # pairs sharing an edge switch (exact, accounting for the
        # possibly-short last switch)
        same = 0
        for s in range(self.n_switches):
            k = min(self.radix, n - s * self.radix)
            same += k * (k - 1)
        total = n * (n - 1)
        return (2.0 * same + 4.0 * (total - same)) / total


class DragonflyTopology(TopoGraph):
    """Groups of ``group_size`` routers, all-to-all links inside a group
    and one global link per group pair: 1 hop inside a group, 3 hops
    (local, global, local) between groups, with the single global link
    shared by every pair of the two groups — the classic dragonfly
    contention point."""

    kind = "dragonfly"

    def __init__(self, n_nodes: int, group_size: int = 8):
        super().__init__(n_nodes)
        if group_size < 1:
            raise ValueError("need group_size >= 1")
        self.group_size = group_size

    def group_of(self, node: int) -> int:
        return node // self.group_size

    @property
    def n_groups(self) -> int:
        return -(-self.n_nodes // self.group_size)

    def hops(self, a, b):
        self._check(a, b)
        if a == b:
            return 0
        return 1 if self.group_of(a) == self.group_of(b) else 3

    def links_on_path(self, a, b):
        self._check(a, b)
        if a == b:
            return ()
        ga, gb = self.group_of(a), self.group_of(b)
        if ga == gb:
            return (("local", ga, min(a, b), max(a, b)),)
        return (("egress", a), ("global", min(ga, gb), max(ga, gb)),
                ("egress", b))

    def neighbors(self, node):
        """Same-group routers (one local link away)."""
        self._check(node)
        lo = self.group_of(node) * self.group_size
        return [x for x in range(lo, min(lo + self.group_size, self.n_nodes))
                if x != node]

    def failure_domain(self, node):
        self._check(node)
        return self.group_of(node)

    def avg_hops(self):
        n = self.n_nodes
        if n < 2:
            return 0.0
        same = 0
        for g in range(self.n_groups):
            k = min(self.group_size, n - g * self.group_size)
            same += k * (k - 1)
        total = n * (n - 1)
        return (1.0 * same + 3.0 * (total - same)) / total


class Torus3DTopology(TopoGraph):
    """3-D wraparound mesh with dimension-ordered (x, then y, then z)
    routing.  No shared switches: a node's failure domain is itself, hop
    distance is the cyclic Manhattan distance, and contention comes from
    many routes crossing the same mesh link."""

    kind = "torus3d"

    def __init__(self, n_nodes: int, dims: Tuple[int, int, int] = None):
        super().__init__(n_nodes)
        self.dims = tuple(dims) if dims else self._fit_dims(n_nodes)
        if len(self.dims) != 3 or any(d < 1 for d in self.dims):
            raise ValueError(f"bad torus dims {self.dims}")
        if self.dims[0] * self.dims[1] * self.dims[2] < n_nodes:
            raise ValueError(f"dims {self.dims} hold fewer than "
                             f"{n_nodes} nodes")

    @staticmethod
    def _fit_dims(n: int) -> Tuple[int, int, int]:
        """Near-cubic dims covering n nodes."""
        dz = max(1, round(n ** (1.0 / 3.0)))
        dy = max(1, math.ceil(math.sqrt(n / dz)))
        dx = max(1, -(-n // (dy * dz)))
        return (dx, dy, dz)

    def coords(self, node: int) -> Tuple[int, int, int]:
        self._check(node)
        dx, dy, _dz = self.dims
        return (node % dx, (node // dx) % dy, node // (dx * dy))

    @staticmethod
    def _axis_steps(c0: int, c1: int, dim: int) -> List[int]:
        """Coordinate sequence c0 -> c1 along the shorter cyclic arc."""
        if c0 == c1 or dim == 1:
            return [c0]
        fwd = (c1 - c0) % dim
        step = 1 if fwd <= dim - fwd else -1
        seq = [c0]
        c = c0
        while c != c1:
            c = (c + step) % dim
            seq.append(c)
        return seq

    def hops(self, a, b):
        ca, cb = self.coords(a), self.coords(b)
        return sum(min((c1 - c0) % d, (c0 - c1) % d)
                   for c0, c1, d in zip(ca, cb, self.dims))

    def links_on_path(self, a, b):
        ca, cb = list(self.coords(a)), list(self.coords(b))
        links = []
        cur = list(ca)
        for axis in range(3):
            seq = self._axis_steps(cur[axis], cb[axis], self.dims[axis])
            for c0, c1 in zip(seq, seq[1:]):
                p0, p1 = list(cur), list(cur)
                p0[axis], p1[axis] = c0, c1
                links.append((axis,) + tuple(sorted((tuple(p0), tuple(p1)))))
            cur[axis] = cb[axis]
        return tuple(links)

    def neighbors(self, node):
        self._check(node)
        dx, dy, dz = self.dims
        x, y, z = self.coords(node)
        out = set()
        for ax, (c, d) in enumerate(zip((x, y, z), self.dims)):
            for step in (-1, 1):
                cc = [x, y, z]
                cc[ax] = (c + step) % d
                nb = cc[0] + cc[1] * dx + cc[2] * dx * dy
                if nb < self.n_nodes and nb != node:
                    out.add(nb)
        return sorted(out)

    def avg_hops(self):
        if self.n_nodes < 2:
            return 0.0
        # per-axis mean cyclic distance over ALL offset combinations
        # (axes are independent), corrected from the all-ordered-pairs
        # mean to the distinct-pair mean.  Exact for fully-populated
        # grids; prefix-populated grids use the full-grid value.
        full = self.dims[0] * self.dims[1] * self.dims[2]
        exp = sum(sum(min(o, d - o) for o in range(d)) / d
                  for d in self.dims)
        return exp * full / (full - 1)


_TOPOLOGIES = {
    "flat": FlatTopology,
    "fattree": FatTreeTopology,
    "dragonfly": DragonflyTopology,
    "torus3d": Torus3DTopology,
}


def make_topology(name: str, n_nodes: int, **kw) -> TopoGraph:
    try:
        cls = _TOPOLOGIES[name]
    except KeyError:
        raise ValueError(f"unknown topology {name!r}; "
                         f"expected one of {sorted(_TOPOLOGIES)}") from None
    return cls(n_nodes, **kw)


# -- dist_graph neighbor lists (for the neighborhood collectives) -----------

def line_neighbors(n: int) -> List[List[int]]:
    """1-D slab decomposition: each rank borders rank-1 and rank+1 (no
    wraparound) — cloverleaf's halo graph."""
    return [[q for q in (r - 1, r + 1) if 0 <= q < n] for r in range(n)]


def ring_neighbors(n: int) -> List[List[int]]:
    """Periodic 1-D decomposition (wraparound)."""
    return [sorted({(r - 1) % n, (r + 1) % n} - {r}) for r in range(n)]
