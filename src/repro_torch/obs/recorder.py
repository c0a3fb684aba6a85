"""ObsRecorder: the one handle the runtimes wire through the stack (a copy
of ``repro/obs/recorder.py``).

A recorder bundles the three observability surfaces —

  * ``tracer``   (obs.tracer.SpanTracer): virtual-time spans,
  * ``metrics``  (obs.metrics.MetricsRegistry): counters / gauges /
    histograms,
  * ``links``    (obs.links.LinkUsage): per-link heat, attached
    only when the run has a topo cost model —

and implements the hook protocols the seams already expose:

  * transport send observer (``on_send``; registered via
    ``transport.add_observer``);
  * VirtualClock charge hook (``on_charge``; set by ``bind_clock``):
    every ledger charge becomes a labelled counter, and repair/restore
    charges feed the recovery-latency histogram;
  * CollectiveEngine hooks: transport collectives mirror every post
    (``on_collective``); completed switchboard instances arrive as ONE
    batch summary from the SoA arrival masks (``on_collective_batch``) —
    both keyed the way the engine keys matching, (kind, step, op-index);
  * the runtime step hook (``on_step``): per-rank step/comm spans, the
    cheap ``complete()`` path.

A tensor payload counts ``numel * element_size`` bytes
(``core.message_log.payload_nbytes``), an ndarray's ``nbytes`` for the
same values, so the byte counters of a tensor run equal the reference's.

Overhead contract (the JAX package's docs/obs_api.md): with ``obs=None``
the wired code
paths perform a single falsy check and allocate nothing; with a recorder
attached, the hot hooks are dict increments and one list append per
span — no formatting, no I/O, string keys cached per (tag, role) /
(component, label).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

from repro_torch.analyze.tags import band_owner
from repro_torch.core.message_log import payload_nbytes
from repro_torch.obs.links import LinkUsage
from repro_torch.obs.metrics import MetricsRegistry, time_distribution
from repro_torch.obs.tracer import RUNTIME_TID, SpanTracer

# components whose charges are recovery latencies (histogrammed)
_RECOVERY_COMPONENTS = frozenset({"repair", "restore"})

_BAND_SHORT = {
    "repro_torch.comm.collectives": "coll",
    "repro_torch.store.memstore": "store",
    "repro_torch.topo.algorithms": "topo",
    "repro_torch.pool.master": "pool",
}


class ObsRecorder:
    """Tracer + metrics + link usage behind the stack's observer seams."""

    def __init__(self, *, trace: bool = True, trace_steps: bool = True):
        self.metrics = MetricsRegistry()
        self.tracer: Optional[SpanTracer] = SpanTracer() if trace else None
        self.trace_steps = trace_steps
        self.links: Optional[LinkUsage] = None
        self.clock = None
        self.n = 0                       # logical ranks
        self.m = 0                       # replica workers
        self.injector_kind: Optional[str] = None
        # hot-path key caches: (tag, role) -> (msgs key, bytes key);
        # (component, label) -> counter key
        self._send_keys: Dict[Tuple[int, str], Tuple[str, str]] = {}
        self._charge_keys: Dict[Tuple[str, Optional[str]], str] = {}

    # -- wiring --------------------------------------------------------------

    def bind_clock(self, clock) -> "ObsRecorder":
        """Adopt the run's VirtualClock: charges flow into the metrics,
        and begin/end spans timestamp from ``clock.now``."""
        self.clock = clock
        clock.obs = self
        if self.tracer is not None:
            self.tracer.clock = clock
        return self

    def set_world(self, n: int, m: int,
                  injector_kind: Optional[str] = None) -> None:
        self.n = n
        self.m = m
        if injector_kind is not None:
            self.injector_kind = injector_kind

    def attach_links(self, cost_model) -> LinkUsage:
        """Build the per-link accumulator for a priced run; the caller
        assigns the return value to ``transport.link_usage``."""
        self.links = LinkUsage(cost_model)
        return self.links

    # -- transport send observer (hot path) ----------------------------------

    def on_send(self, role: str, src: int, dst: int, tag: int,
                send_id: int, payload: Any, step: int) -> None:
        keys = self._send_keys.get((tag, role))
        if keys is None:
            band = "app" if tag >= 0 else _BAND_SHORT.get(
                band_owner(tag), "reserved")
            keys = self._send_keys[(tag, role)] = (
                f"comm.msgs.{band}.{role}", f"comm.bytes.{band}.{role}")
        c = self.metrics.counters
        c[keys[0]] = c.get(keys[0], 0) + 1
        c[keys[1]] = c.get(keys[1], 0) + payload_nbytes(payload)

    # -- VirtualClock charge hook (hot path) ---------------------------------

    def on_charge(self, component: str, seconds: float,
                  label: Optional[str]) -> None:
        key = self._charge_keys.get((component, label))
        if key is None:
            key = self._charge_keys[(component, label)] = \
                f"time.{component}_s" if label is None \
                else f"time.{component}_s.{label}"
            if label is not None:
                # a labelled charge books under both the component total
                # and the labelled sub-key; register the total's cache
                # entry too so the recursion below stays one level deep
                self._charge_keys.setdefault((component, None),
                                             f"time.{component}_s")
        c = self.metrics.counters
        c[key] = c.get(key, 0) + seconds
        if label is not None:
            total = self._charge_keys[(component, None)]
            c[total] = c.get(total, 0) + seconds
        if component in _RECOVERY_COMPONENTS and seconds > 0:
            self.metrics.observe("recovery.latency_s", seconds)

    # -- CollectiveEngine post hook ------------------------------------------

    def on_collective(self, kind: str, role: str, rank: int, step: int,
                      idx: int) -> None:
        """One transport-collective post (bcast/gather/…; the switchboard
        reports per completed instance via ``on_collective_batch``)."""
        self.metrics.inc(f"collectives.posts.{kind}.{role}")
        tr = self.tracer
        if tr is not None and role == "cmp":
            # keyed the way the engine keys matching: (kind, step, idx)
            tr.instant(rank, kind, "collective",
                       step=step, idx=idx)

    def on_collective_batch(self, kind: str, step: int, idx: int,
                            cmp_ranks, n_rep: int) -> None:
        """One COMPLETED switchboard instance, summarized from its SoA
        arrival masks: the per-role post counters advance by the mask
        counts in two ``inc`` calls (not 2N per-post calls), and the
        trace gets one instant per computational rank."""
        if cmp_ranks:
            self.metrics.inc(f"collectives.posts.{kind}.cmp",
                             len(cmp_ranks))
        if n_rep:
            self.metrics.inc(f"collectives.posts.{kind}.rep", n_rep)
        tr = self.tracer
        if tr is not None:
            for rank in cmp_ranks:
                tr.instant(rank, kind, "collective", step=step, idx=idx)

    # -- runtime step hook ---------------------------------------------------

    def on_step(self, step_idx: int, t0: float, step_time: float,
                rolled_back: bool, n_ranks: int,
                comm_items: Iterable[Tuple[int, float]] = (),
                role_of=None) -> None:
        """Record one executed step: per-rank step spans plus per-rank
        comm-wait spans (from the transport's per-sender accrual, placed
        after the compute window — the schedule the clock itself books)."""
        self.metrics.inc("steps.rolled_back" if rolled_back
                         else "steps.executed")
        tr = self.tracer
        if tr is None or not self.trace_steps:
            return
        cat = "rollback" if rolled_back else "compute"
        args = {"step": step_idx}
        for r in range(n_ranks):
            tr.complete(r, "step", cat, t0, step_time, args)
        if role_of is not None:
            end = t0 + step_time
            for wid, seconds in comm_items:
                role, rank = role_of(wid)
                if rank < 0:        # sender died mid-step: no track
                    continue
                tr.complete(rank, "comm", "comm", end, seconds,
                            {"role": role, "step": step_idx})

    # -- span helpers (runtime recovery / checkpoint arcs) -------------------

    def span(self, name: str, cat: str = "", tid: int = RUNTIME_TID,
             **args: Any) -> None:
        """Open a nested span (no-op without a tracer)."""
        if self.tracer is not None:
            self.tracer.begin(tid, name, cat, **args)

    def end_span(self, tid: int = RUNTIME_TID, **args: Any) -> None:
        if self.tracer is not None:
            self.tracer.end(tid, **args)

    def mark(self, name: str, cat: str = "", tid: int = RUNTIME_TID,
             **args: Any) -> None:
        """A point event, child of the open span on ``tid`` (if any)."""
        if self.tracer is not None:
            self.tracer.instant(tid, name, cat, **args)

    # -- end-of-run sampling -------------------------------------------------

    def sample_transport(self, transport) -> None:
        """Gauge the transport's log / dedup / wildcard state."""
        m = self.metrics
        logs = transport.send_logs.values()
        m.set_gauge("log.live_bytes", sum(lg.bytes for lg in logs))
        m.set_gauge("log.live_msgs",
                    sum(len(lg.log) for lg in transport.send_logs.values()))
        m.set_gauge("log.recorded_msgs",
                    sum(lg.recorded_msgs
                        for lg in transport.send_logs.values()))
        m.set_gauge("log.recorded_bytes",
                    sum(lg.recorded_bytes
                        for lg in transport.send_logs.values()))
        m.set_gauge("log.evictions",
                    sum(lg.removal_events
                        for lg in transport.send_logs.values()))
        m.set_gauge("dedup.duplicates_skipped",
                    transport.duplicates_skipped)
        m.set_gauge("wc.matches",
                    sum(ep.wc_consumed
                        for ep in transport.endpoints.values()))

    def sample_store(self, store) -> None:
        """Gauge the in-memory checkpoint store's counters."""
        m = self.metrics
        m.set_gauge("store.pushes", store.pushes)
        m.set_gauge("store.acks", store.acks)
        m.set_gauge("store.fetches", store.fetches)
        m.set_gauge("store.local_reads", store.local_reads)
        m.set_gauge("store.gens_committed", store.gens_committed)
        m.set_gauge("store.gens_abandoned", store.gens_abandoned)
        m.set_gauge("store.committed_bytes", store.committed_bytes)

    # -- snapshot ------------------------------------------------------------

    def snapshot(self) -> dict:
        """The run report's metrics view: every instrument, the Fig 9
        time distribution, and the per-link heat tables."""
        out = self.metrics.snapshot()
        out["world"] = {"n": self.n, "m": self.m}
        if self.injector_kind is not None:
            out["world"]["injector"] = self.injector_kind
        if self.clock is not None:
            frac = self.m / (self.n + self.m) if self.m else 0.0
            out["time_distribution"] = time_distribution(
                self.clock.breakdown.as_dict(), frac)
        if self.links is not None:
            out["links"] = self.links.as_dict()
        return out
