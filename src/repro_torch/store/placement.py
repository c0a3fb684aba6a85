"""Shift-by-k partner-group placement for the in-memory store (a copy of
``repro/store/placement.py``).

Every rank pushes its checkpoint shards to k *partner* ranks.  For the
store to survive any f <= k failures, a shard must never share a failure
domain with its owner: a partner's workers may live neither on the owner's
computational node nor on the owner's replica node (the owner's replica
pair already holds a live copy of the state — co-locating shards with it
would make one node loss take out both).

The *failure domain* of a rank is the set of nodes hosting its surviving
copies (computational worker + replica worker, when replicated).  Partners
are chosen by scanning shifts (r + s) mod n for s = 1, 2, ... — the
shift-by-k pattern of ReStore — in three preference passes:

  1. domain disjoint from the owner AND from every already-chosen partner
     (the strong form: owner + partners occupy k+1 pairwise-disjoint
     domains, so ANY f <= k worker/node/pair deaths leave a holder alive);
  2. domain disjoint from the owner only (sufficient for k <= 2 whenever
     each rank's two copies sit on different nodes: one death can never
     fell a whole partner);
  3. any distinct rank (*degraded*: the topology is too small to separate
     failure domains at all — the store still helps, but `tolerance()`
     reports what it can actually absorb).

With a ``TopoGraph``, equally-admissible candidates within passes 1 and 2
are tie-broken by *contention*: each chosen partner's push path deposits
``1 / link_share`` on every link it crosses, and the next partner is the
admissible candidate minimizing the resulting maximum link load — so a
dragonfly owner spreads its pushes over distinct global links and a torus
owner over both ring directions instead of piling consecutive ranks onto
one cross-domain link.  Candidates of equal load keep the shift order, so
flat graphs (where every cross-node path is symmetric) reproduce the
unweighted shift-by-k choice exactly — property-tested.  The
never-share-a-failure-domain invariant is untouched: the tie-break only
reorders candidates that were already admissible in the same pass.

``tolerance()`` verifies the guarantee by brute force over every scenario
of f node deaths and pair deaths (which dominate single-worker deaths),
and is the oracle the property tests check against.
"""
from __future__ import annotations

import itertools
from typing import Dict, FrozenSet, List, Tuple


class PlacementError(ValueError):
    """No admissible partner group exists for some rank."""


class PartnerPlacement:
    """``graph`` (a topo.TopoGraph) widens the failure domain from
    the node to the infrastructure unit the node dies with — a fat-tree
    edge switch, a dragonfly group — so shards also avoid sharing a
    switch/group with their owner, not just a node."""

    def __init__(self, rmap, topology, k_partners: int = 2, graph=None):
        if k_partners < 1:
            raise PlacementError("need at least one partner per rank")
        self.rmap = rmap
        self.topology = topology
        self.graph = graph
        self.k = k_partners
        self.degraded = False
        self._partners: Dict[int, Tuple[int, ...]] = {}
        pick = self._pick_flat if graph is None else self._pick
        for r in range(rmap.n):
            self._partners[r] = pick(r)

    def _domain_of_node(self, node: int) -> int:
        if self.graph is None:
            return node
        return self.graph.failure_domain(node % self.graph.n_nodes)

    # -- queries -------------------------------------------------------------

    def partners_of(self, rank: int) -> Tuple[int, ...]:
        return self._partners[rank]

    def domain(self, rank: int) -> FrozenSet[int]:
        """Failure domains hosting this rank's live copies (cmp +
        replica): the nodes themselves, or the graph's infrastructure
        units (edge switch, dragonfly group) when a topo graph is set."""
        domains = set()
        for w in (self.rmap.cmp.get(rank), self.rmap.rep.get(rank)):
            if w is not None and w not in self.rmap.dead:
                domains.add(self._domain_of_node(self.topology.node_of(w)))
        return frozenset(domains)

    def holders_of(self, rank: int) -> List[int]:
        """Live workers holding a copy of this rank's shards (the partner
        ranks' computational + replica workers)."""
        out = []
        for p in self._partners[rank]:
            for w in (self.rmap.cmp.get(p), self.rmap.rep.get(p)):
                if w is not None and w not in self.rmap.dead:
                    out.append(w)
        return out

    # -- selection -----------------------------------------------------------

    def _graph_node(self, rank: int):
        """Graph node of a rank's representative (computational, else
        replica) live worker; None off-graph."""
        if self.graph is None:
            return None
        for w in (self.rmap.cmp.get(rank), self.rmap.rep.get(rank)):
            if w is not None and w not in self.rmap.dead:
                return self.topology.node_of(w) % self.graph.n_nodes
        return None

    def _push_links(self, r: int, q: int) -> Tuple:
        """Links the representative owner->partner push path crosses."""
        a, b = self._graph_node(r), self._graph_node(q)
        if a is None or b is None or a == b:
            return ()
        return self.graph.links_on_path(a, b)

    def _pick_least_contended(self, r: int, cands: List[int],
                              load: Dict) -> int:
        """Contention objective: the admissible candidate whose push path
        minimizes the maximum weighted link load (each path deposits
        1/link_share per link — an oversubscribed fat-tree up-link counts
        for its oversubscription factor).  Ties keep shift order, so flat
        graphs reproduce the unweighted scan exactly."""
        best, best_cost = cands[0], None
        for q in cands:
            trial = dict(load)
            for link in self._push_links(r, q):
                trial[link] = trial.get(link, 0.0) \
                    + 1.0 / self.graph.link_share(link)
            cost = max(trial.values()) if trial else 0.0
            if best_cost is None or cost < best_cost:
                best, best_cost = q, cost
        return best

    def _pick_flat(self, r: int) -> Tuple[int, ...]:
        """Graph-free fast path: one forward scan per preference pass,
        computing candidate domains lazily, so placement over N ranks is
        ~O(N·k) instead of the restart-scan's O(N²).  Choices are
        identical to ``_pick``: without a graph each pass takes
        ``cands[0]``, and pass-1 admissibility only *shrinks* as chosen
        domains grow — so the first admissible candidate of a fresh
        rescan is always at or beyond the previous pick's shift position,
        which is exactly what the forward scan takes next."""
        n = self.rmap.n
        own = self.domain(r)
        dom: Dict[int, FrozenSet[int]] = {}
        chosen: List[int] = []
        domains: List[FrozenSet[int]] = []

        def dom_of(q: int) -> FrozenSet[int]:
            d = dom.get(q)
            if d is None:
                d = dom[q] = self.domain(q)
            return d

        for s in range(1, n):                   # pass 1: pairwise disjoint
            if len(chosen) == self.k:
                break
            q = (r + s) % n
            d = dom_of(q)
            if not (d & own) and not any(d & c for c in domains):
                chosen.append(q)
                domains.append(d)
        if len(chosen) < self.k:
            for s in range(1, n):               # pass 2: owner-disjoint
                if len(chosen) == self.k:
                    break
                q = (r + s) % n
                if q in chosen or (dom_of(q) & own):
                    continue
                chosen.append(q)
                domains.append(dom[q])
        if len(chosen) < self.k:
            for s in range(1, n):               # pass 3: degraded
                if len(chosen) == self.k:
                    break
                q = (r + s) % n
                if q in chosen:
                    continue
                self.degraded = True
                chosen.append(q)
                domains.append(dom_of(q))
        if not chosen:
            raise PlacementError(
                f"rank {r}: no partner candidates in a {n}-rank world")
        if len(chosen) < self.k:
            self.degraded = True
        return tuple(chosen)

    def _pick(self, r: int) -> Tuple[int, ...]:
        n = self.rmap.n
        own = self.domain(r)
        order = [(r + s) % n for s in range(1, n)]
        dom = {q: self.domain(q) for q in order}
        chosen: List[int] = []
        domains: List[FrozenSet[int]] = []
        load: Dict = {}                         # link -> weighted push load

        def take(q: int) -> None:
            chosen.append(q)
            domains.append(dom[q])
            if self.graph is not None:
                for link in self._push_links(r, q):
                    load[link] = load.get(link, 0.0) \
                        + 1.0 / self.graph.link_share(link)

        while len(chosen) < self.k:             # pass 1: pairwise disjoint
            cands = [q for q in order
                     if q not in chosen and not (dom[q] & own)
                     and not any(dom[q] & c for c in domains)]
            if not cands:
                break
            take(cands[0] if self.graph is None
                 else self._pick_least_contended(r, cands, load))
        while len(chosen) < self.k:             # pass 2: owner-disjoint
            cands = [q for q in order
                     if q not in chosen and not (dom[q] & own)]
            if not cands:
                break
            take(cands[0] if self.graph is None
                 else self._pick_least_contended(r, cands, load))
        for q in order:                         # pass 3: degraded
            if len(chosen) == self.k:
                break
            if q in chosen:
                continue
            self.degraded = True
            take(q)
        if not chosen:
            raise PlacementError(
                f"rank {r}: no partner candidates in a {n}-rank world")
        if len(chosen) < self.k:
            self.degraded = True
        return tuple(chosen)

    # -- verification --------------------------------------------------------

    def _death_units(self) -> List[Tuple[int, ...]]:
        """Atomic failure units: whole nodes and replica pairs.  A single
        worker death is dominated by its node's death, so checking nodes +
        pairs covers every worker/node/pair mix."""
        units = [tuple(self.topology.workers_on(nd))
                 for nd in range(self.topology.n_nodes)]
        for r in range(self.rmap.n):
            pair = tuple(w for w in (self.rmap.cmp.get(r),
                                     self.rmap.rep.get(r)) if w is not None)
            if pair:
                units.append(pair)
        return units

    def survives(self, dead_workers) -> bool:
        """True iff every rank still has a live copy of its state: its own
        worker pair, or a partner worker holding its shards."""
        dead = set(dead_workers) | set(self.rmap.dead)
        for r in range(self.rmap.n):
            own_alive = any(
                w is not None and w not in dead
                for w in (self.rmap.cmp.get(r), self.rmap.rep.get(r)))
            if own_alive:
                continue
            if not any(w not in dead for w in self.holders_of(r)):
                return False
        return True

    def tolerance(self, max_units: int = 24) -> int:
        """Largest f <= k such that EVERY combination of f unit deaths
        (nodes, pairs) leaves every rank recoverable.  Exhaustive — the
        worlds this runs on are small."""
        units = self._death_units()
        if len(units) > max_units:
            raise PlacementError(
                f"tolerance check over {len(units)} units is too large")
        best = 0
        for f in range(1, self.k + 1):
            for combo in itertools.combinations(units, f):
                dead = set(itertools.chain.from_iterable(combo))
                if not self.survives(dead):
                    return best
            best = f
        return best
