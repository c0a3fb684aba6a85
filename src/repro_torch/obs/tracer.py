"""Virtual-time span tracer (the timeline half of ``obs``; a copy of
``repro/obs/tracer.py``).

Spans are recorded against :class:`repro_torch.clock.VirtualClock` time — the
``ts``/``dur`` fields are *virtual seconds*, the same currency as the
``TimeBreakdown`` ledger — with wall-clock annotations carried alongside
(``wall_ts``/``wall_dur``) so a trace can answer both "where did the
simulated machine spend its time" and "where did the simulator spend
ours".

The span model is deliberately small:

  * every span lives on a *track* (``tid``): logical rank ``r`` for
    per-rank work, :data:`RUNTIME_TID` for world-level arcs (checkpoint
    writes, elastic restarts);
  * ``begin``/``end`` maintain a per-tid stack, so spans nest properly by
    construction and the nesting is recorded (``Span.parent`` indexes
    ``tracer.spans``);
  * ``instant`` marks a point event as a child of the currently open
    span (failure marks, drain/replay/promotion arcs);
  * ``complete`` records a closed span with explicit ``ts``/``dur`` —
    the cheap path the runtime uses for per-step spans, one list append
    per rank per step.

Exporters (Chrome trace JSON, text flamegraph) live in
``obs.exporters``; they only read ``tracer.spans``.
"""
from __future__ import annotations

import time as _time
from typing import Any, Dict, List, Optional

#: track id for world-level spans (checkpoint write, elastic restart);
#: per-rank spans use the logical rank as the tid.
RUNTIME_TID = -1


class Span:
    """One recorded span; ``dur is None`` while still open."""

    __slots__ = ("tid", "name", "cat", "ts", "dur", "args", "parent",
                 "wall_ts", "wall_dur", "instant")

    def __init__(self, tid: int, name: str, cat: str, ts: float,
                 dur: Optional[float], args: Optional[dict],
                 parent: int, wall_ts: float, wall_dur: float,
                 instant: bool = False):
        self.tid = tid
        self.name = name
        self.cat = cat
        self.ts = ts
        self.dur = dur
        self.args = args
        self.parent = parent          # index into tracer.spans, or -1
        self.wall_ts = wall_ts
        self.wall_dur = wall_dur
        self.instant = instant

    def __repr__(self) -> str:
        return (f"Span(tid={self.tid}, {self.name!r}, cat={self.cat!r}, "
                f"ts={self.ts}, dur={self.dur})")


class SpanTracer:
    """Per-tid nested span recording against a bound VirtualClock.

    ``clock`` is bound by :meth:`ObsRecorder.bind_clock`; until then the
    virtual timestamp is 0.0 (spans recorded through ``complete`` carry
    their own explicit ``ts`` and never consult the clock).
    """

    def __init__(self, clock=None):
        self.clock = clock
        self.spans: List[Span] = []
        self._stacks: Dict[int, List[int]] = {}

    # -- clock access --------------------------------------------------------

    def _now(self) -> float:
        return self.clock.now if self.clock is not None else 0.0

    def _top(self, tid: int) -> int:
        stack = self._stacks.get(tid)
        return stack[-1] if stack else -1

    # -- recording -----------------------------------------------------------

    def begin(self, tid: int, name: str, cat: str = "", **args: Any) -> int:
        """Open a span on ``tid``; returns its index (for tests)."""
        # repro: allow[wallclock] -- wall-time annotation on the span
        wall = _time.perf_counter()
        span = Span(tid, name, cat, self._now(), None, args or None,
                    self._top(tid), wall, 0.0)
        idx = len(self.spans)
        self.spans.append(span)
        self._stacks.setdefault(tid, []).append(idx)
        return idx

    def end(self, tid: int, **args: Any) -> Span:
        """Close the innermost open span on ``tid``."""
        stack = self._stacks.get(tid)
        if not stack:
            raise RuntimeError(f"end() with no open span on tid {tid}")
        span = self.spans[stack.pop()]
        span.dur = self._now() - span.ts
        # repro: allow[wallclock] -- wall-time annotation on the span
        span.wall_dur = _time.perf_counter() - span.wall_ts
        if args:
            span.args = {**(span.args or {}), **args}
        return span

    def instant(self, tid: int, name: str, cat: str = "",
                **args: Any) -> Span:
        """A point event, recorded as a child of the open span (if any)."""
        # repro: allow[wallclock] -- wall-time annotation on the span
        wall = _time.perf_counter()
        span = Span(tid, name, cat, self._now(), 0.0, args or None,
                    self._top(tid), wall, 0.0, instant=True)
        self.spans.append(span)
        return span

    def complete(self, tid: int, name: str, cat: str, ts: float,
                 dur: float, args: Optional[dict] = None) -> None:
        """Record an already-closed span with explicit virtual times —
        the hot path (one append; no clock read, no wall read)."""
        self.spans.append(Span(tid, name, cat, ts, dur, args,
                               self._top(tid), 0.0, 0.0))

    # -- inspection ----------------------------------------------------------

    def open_spans(self) -> List[Span]:
        return [self.spans[i] for stack in self._stacks.values()
                for i in stack]

    def finish(self) -> None:
        """Close every open span (end-of-run safety net)."""
        for tid in sorted(self._stacks):
            while self._stacks[tid]:
                self.end(tid)

    def children_of(self, idx: int) -> List[Span]:
        return [s for s in self.spans if s.parent == idx]

    def find(self, name: str, tid: Optional[int] = None) -> List[Span]:
        return [s for s in self.spans if s.name == name
                and (tid is None or s.tid == tid)]
