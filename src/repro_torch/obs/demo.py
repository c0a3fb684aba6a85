"""The canonical traced scenario: HPCG under the combined strategy with a
mid-run node kill (the port of ``repro/obs/demo.py``).

The workload behind ``python -m repro_torch.obs``: 64 logical ranks (fully
replicated: 128 workers), the in-memory checkpoint store, a fat-tree
topology pricing every message (so per-link heat is measured), and a
whole-node failure at mid-run — which promotes the node's replicas,
replays from the sender logs, and leaves failure / drain / replay /
promotion arcs in the trace.  HPCG runs on ``device`` (``None``: the
card, which raises without CUDA); the recorder is host bookkeeping in
virtual seconds.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.obs.recorder import ObsRecorder


def traced_hpcg_run(n_ranks: int = 64, *, steps: int = 12,
                    workers_per_node: int = 4,
                    kill_node: int = 0,
                    kill_time_s: Optional[float] = None,
                    topology: str = "fattree",
                    grid: Tuple[int, int, int] = (6, 6, 4),
                    trace_steps: bool = True,
                    obs: Optional[ObsRecorder] = None,
                    device=None):
    """Run the scenario; returns ``(runtime, result, recorder)``.

    ``kill_node`` selects which node's workers die (node 0 holds
    computational ranks, so the default exercises promotion + replay);
    ``kill_time_s`` defaults to mid-run.
    """
    from repro_torch.apps.hpcg import HPCG
    from repro_torch.configs.base import FTConfig
    from repro_torch.core.failure_sim import FailureEvent
    from repro_torch.simrt import CostModel, SimRuntime

    app = HPCG(n_ranks, nx=grid[0], ny=grid[1], nz=grid[2], device=device)
    ft = FTConfig(mode="combined", replication_degree=1.0,
                  ckpt_backend="memory", ckpt_interval_s=4.0,
                  store_partners=1, store_bands=2,
                  topology=topology)
    if kill_time_s is None:
        kill_time_s = steps * 0.5 + 0.25
    victims = tuple(range(kill_node * workers_per_node,
                          (kill_node + 1) * workers_per_node))
    events = [FailureEvent(time_s=kill_time_s, workers=victims)]
    recorder = obs if obs is not None else \
        ObsRecorder(trace_steps=trace_steps)
    rt = SimRuntime(app, ft,
                    costs=CostModel(step_time_s=1.0, ckpt_cost_s=0.02,
                                    restore_cost_s=0.02),
                    workers_per_node=workers_per_node,
                    failure_events=events, obs=recorder)
    res = rt.run(steps)
    return rt, res, recorder
