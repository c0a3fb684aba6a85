"""repro_torch.obs: virtual-time tracing, metrics and per-link utilization
(the port of ``repro.obs``).

One recorder (:class:`ObsRecorder`) wires through the FT stack — the
transport's observer list, the VirtualClock's charge hook, the collective
engine, ``FTSession``'s step/recovery/checkpoint arcs and the serving
fan-out — and produces:

  * a virtual-time span timeline exportable as Chrome-trace JSON
    (``write_chrome_trace``) or a text flamegraph;
  * a counters/gauges/histograms registry snapshotted into the run result
    (``RunReport.obs_metrics``);
  * measured per-link byte/busy heat tables on priced (topo) runs.

Every span is host-side bookkeeping in virtual seconds (with wall-clock
annotations), as in the reference: the recorder adds no work on the card.
Default off: ``FTSession``/``ReplicatedServer``/``SimRuntime`` take
``obs=None`` and the wired hot paths then cost one falsy check and zero
allocations.  ``obs.demo.traced_hpcg_run`` (HPCG on the simulated runtime,
a node killed mid-run) is the scenario behind ``python -m repro_torch.obs``.
"""
from repro_torch.obs.exporters import (chrome_trace, text_flamegraph,
                                       write_chrome_trace)
from repro_torch.obs.links import LinkUsage
from repro_torch.obs.metrics import (Histogram, MetricsRegistry,
                                     time_distribution)
from repro_torch.obs.recorder import ObsRecorder
from repro_torch.obs.tracer import RUNTIME_TID, Span, SpanTracer

__all__ = [
    "ObsRecorder", "SpanTracer", "Span", "RUNTIME_TID",
    "MetricsRegistry", "Histogram", "time_distribution", "LinkUsage",
    "chrome_trace", "write_chrome_trace", "text_flamegraph",
]
