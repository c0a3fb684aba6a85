"""Trace/metrics exporters: Chrome-trace (Perfetto) JSON and a text
flamegraph (a copy of ``repro/obs/exporters.py``).

Chrome-trace format: the JSON object form, ``{"traceEvents": [...]}``.
Spans export as complete events (``ph: "X"``) with ``ts``/``dur`` in
microseconds of *virtual* time; instants as thread-scoped ``ph: "i"``;
per-tid ``thread_name`` metadata labels logical ranks and the runtime
track.  Wall-time annotations travel in ``args.wall_ms``.  Events are
sorted by (tid, ts, record order), so ``ts`` is monotone per tid —
load the file in ``chrome://tracing`` or https://ui.perfetto.dev.

The text flamegraph folds spans by their recorded parent chain
(tracks merged: the same stack on every rank aggregates), sums virtual
durations, and renders an indented tree with percentage bars — the
terminal-friendly "where did the time go" view.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.tracer import RUNTIME_TID, SpanTracer


def _tid_name(tid: int) -> str:
    return "runtime" if tid == RUNTIME_TID else f"rank {tid}"


def chrome_trace(tracer: SpanTracer,
                 metrics: Optional[dict] = None) -> dict:
    """The Chrome-trace JSON object for ``tracer``'s spans; a metrics
    snapshot (if given) rides along under ``otherData``."""
    events: List[dict] = []
    tids = sorted({s.tid for s in tracer.spans})
    for tid in tids:
        events.append({"name": "thread_name", "ph": "M", "pid": 0,
                       "tid": tid, "args": {"name": _tid_name(tid)}})
    rows: List[Tuple[int, float, int, dict]] = []
    for seq, span in enumerate(tracer.spans):
        args = dict(span.args) if span.args else {}
        if span.wall_dur:
            args["wall_ms"] = round(span.wall_dur * 1e3, 6)
        ev = {"name": span.name, "cat": span.cat or "span", "pid": 0,
              "tid": span.tid, "ts": span.ts * 1e6}
        if span.instant:
            ev["ph"] = "i"
            ev["s"] = "t"
        else:
            ev["ph"] = "X"
            ev["dur"] = (span.dur or 0.0) * 1e6
        if args:
            ev["args"] = args
        rows.append((span.tid, ev["ts"], seq, ev))
    rows.sort(key=lambda r: (r[0], r[1], r[2]))
    events.extend(ev for _, _, _, ev in rows)
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if metrics is not None:
        out["otherData"] = metrics
    return out


def write_chrome_trace(path: str, tracer: SpanTracer,
                       metrics: Optional[dict] = None) -> dict:
    data = chrome_trace(tracer, metrics)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    return data


# -- text flamegraph ---------------------------------------------------------

def _stack_path(tracer: SpanTracer, idx: int) -> Tuple[str, ...]:
    parts: List[str] = []
    span = tracer.spans[idx]
    while True:
        parts.append(span.name)
        if span.parent < 0:
            break
        span = tracer.spans[span.parent]
    return tuple(reversed(parts))


def fold_stacks(tracer: SpanTracer) -> Dict[Tuple[str, ...], float]:
    """Aggregate virtual duration by name-stack across all tracks."""
    folded: Dict[Tuple[str, ...], float] = {}
    for i, span in enumerate(tracer.spans):
        if span.instant or not span.dur:
            continue
        path = _stack_path(tracer, i)
        folded[path] = folded.get(path, 0.0) + span.dur
    return folded


def text_flamegraph(tracer: SpanTracer, width: int = 40) -> str:
    """Indented tree of folded stacks, widest first, with bars scaled to
    the largest top-level total."""
    folded = fold_stacks(tracer)
    if not folded:
        return "(no closed spans)\n"
    # children roll up into their ancestors' display totals
    totals: Dict[Tuple[str, ...], float] = {}
    children: Dict[Tuple[str, ...], set] = {}
    for path, dur in folded.items():
        for depth in range(1, len(path) + 1):
            prefix = path[:depth]
            totals[prefix] = totals.get(prefix, 0.0) + dur
            children.setdefault(prefix[:-1], set()).add(prefix[-1])
    top = max(v for p, v in totals.items() if len(p) == 1)
    lines: List[str] = []

    def render(prefix: Tuple[str, ...]) -> None:
        names = children.get(prefix, ())
        for name in sorted(names,
                           key=lambda x: (-totals[prefix + (x,)], x)):
            path = prefix + (name,)
            dur = totals[path]
            bar = "#" * max(1, int(width * dur / top)) if top > 0 else ""
            indent = "  " * (len(path) - 1)
            pad = max(4, 24 - len(indent))
            lines.append(f"{indent}{name:<{pad}} {dur:>12.6f}s  {bar}")
            render(path)

    render(())
    return "\n".join(lines) + "\n"
