"""Metrics registry (the aggregate half of ``obs``; a copy of
``repro/obs/metrics.py``).

Three instrument kinds, all keyed by dotted string names (the stable
schema is documented in ``docs/obs_api.md``):

  * counters — monotone totals (messages/bytes by tag band, collective
    posts, dedup hits, injector kills);
  * gauges — last-sampled values (live sender-log bytes, store
    generation numbers), set at snapshot points;
  * histograms — value distributions kept as count/sum/min/max plus
    power-of-two buckets (recovery latency).

``snapshot()`` is JSON-safe and deterministically ordered.  The
registry is plain dicts underneath so the hot-path increments are two
dict operations — the overhead contract in ``docs/obs_api.md`` depends
on this staying allocation-light.

``time_distribution`` is the paper's Fig 9 percentage accounting (the
JAX package's Fig 9 benchmark reads the same function there): it converts a
``TimeBreakdown.as_dict()`` ledger into percentages and splits the
``useful`` component into useful/redundant processor-seconds by the
replica share of the machine (replication degree 1.0 means half the
machine redoes the other half's work — the paper plots those halves
separately).
"""
from __future__ import annotations

import json
import math
from typing import Dict, Optional


class Histogram:
    """count/sum/min/max plus power-of-two buckets."""

    __slots__ = ("count", "total", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.buckets: Dict[int, int] = {}     # exponent -> count

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value
        exp = math.frexp(value)[1] if value > 0 else 0
        self.buckets[exp] = self.buckets.get(exp, 0) + 1

    def as_dict(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min,
            "max": self.max,
            "mean": self.total / self.count if self.count else None,
            # bucket "e" counts values in (2^(e-1), 2^e]
            "buckets": {str(e): c for e, c in sorted(self.buckets.items())},
        }


class MetricsRegistry:
    """Counters, gauges and histograms behind dotted names."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}

    # -- instruments ---------------------------------------------------------

    def inc(self, name: str, n: float = 1) -> None:
        c = self.counters
        c[name] = c.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        h.observe(value)

    def get(self, name: str, default: float = 0) -> float:
        if name in self.counters:
            return self.counters[name]
        if name in self.gauges:
            return self.gauges[name]
        return default

    # -- export --------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-safe, deterministically ordered view of every instrument."""
        return {
            "counters": {k: self.counters[k]
                         for k in sorted(self.counters)},
            "gauges": {k: self.gauges[k] for k in sorted(self.gauges)},
            "histograms": {k: self.histograms[k].as_dict()
                           for k in sorted(self.histograms)},
        }

    def to_json(self, path: Optional[str] = None, **extra) -> str:
        data = {**self.snapshot(), **extra}
        text = json.dumps(data, indent=2, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text


def time_distribution(breakdown: Dict[str, float],
                      replica_fraction: float = 0.0) -> Dict[str, float]:
    """Fig 9 percentage accounting from a ``TimeBreakdown.as_dict()``.

    ``replica_fraction`` is the replica share of the machine,
    ``m / (n + m)`` — that fraction of the ``useful`` processor-seconds
    is redundant re-execution and is rebooked under ``redundant``.
    Full replication (m == n) gives the paper's half/half split.

    A ledger that already carries an explicit ``redundant`` charge
    (FTSession books replica processor-seconds as their own component)
    is passed through unchanged — rebooking on top of it would count the
    replica share twice.
    """
    if not 0.0 <= replica_fraction < 1.0:
        raise ValueError(f"replica_fraction must be in [0, 1), "
                         f"got {replica_fraction}")
    tot = breakdown.get("total")
    if tot is None:
        tot = sum(v for k, v in breakdown.items() if k != "total")
    comp = {k: 100.0 * v / tot for k, v in breakdown.items()
            if k != "total"} if tot > 0 else \
        {k: 0.0 for k in breakdown if k != "total"}
    if replica_fraction and breakdown.get("redundant", 0.0) <= 0.0:
        useful = comp.get("useful", 0.0)
        comp["redundant"] = comp.get("redundant", 0.0) \
            + useful * replica_fraction
        comp["useful"] = useful * (1.0 - replica_fraction)
    return comp
