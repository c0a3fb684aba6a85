"""Paper Fig 10 from the port: the failure-free overhead of the FT layer
(port of ``benchmarks/fig10_overhead.py``).

The same train step, warm, is driven (a) by a bare Python loop and (b) by
``FTSession`` under ``replication`` with the FT machinery on
(coordinators, failure polling, replica-map bookkeeping, the data cursor)
but no failures, no checkpoints and ``simulate_replica`` off, so the
replica's redundant compute is left out of the wall time on both sides.
Each side is the least of 3 runs of ``steps`` steps. The virtual-time row
books the replica's processor-seconds as the ``redundant`` component.

The reference's arithmetic is kept: its FT timer wraps ``session.run``,
which calls ``workload.init_state()`` itself, while the bare loop's timer
starts after it. ``measure`` also times ``init_state`` alone (least of 3)
and reports the overhead without it, so that bias can be read apart.
Times are taken with the device synchronised at both ends.

  PYTHONPATH=src python -m repro_torch.figures.fig10_overhead --device cpu
  PYTHONPATH=src python -m repro_torch.figures.fig10_overhead --full \\
      --layers 2 --seq 512         # on the card: full width, 2 layers
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.configs import as_config
from repro_torch.configs.base import FTConfig
from repro_torch.launch.train import build_session

PAPER_OVERHEAD_PCT = 1.3


@dataclasses.dataclass
class Fig10:
    """One measurement: wall seconds of each side (the least of 3), of
    ``init_state`` alone, the last FT run's report and the last bare run's
    final state."""

    steps: int
    bare_s: float
    ft_s: float
    init_s: float
    wall_s: float
    report: Any
    bare_state: Any

    @property
    def overhead_pct(self) -> float:
        return (self.ft_s - self.bare_s) / self.bare_s * 100

    @property
    def overhead_without_init_pct(self) -> float:
        return (self.ft_s - self.init_s - self.bare_s) / self.bare_s * 100

    def rows(self) -> list:
        """The reference's two rows, under its names."""
        us = self.wall_s * 1e6
        return [("fig10/failure_free_overhead", us,
                 f"overhead={self.overhead_pct:+.2f}% (paper: "
                 f"{PAPER_OVERHEAD_PCT}%) "
                 f"bare={self.bare_s / self.steps * 1e3:.1f}ms/step "
                 f"ft={self.ft_s / self.steps * 1e3:.1f}ms/step"),
                ("fig10/ft_time_breakdown", us, self.report.time.summary())]

    def init_line(self) -> str:
        return (f"fig10/init_state init={self.init_s * 1e3:.1f}ms "
                f"overhead_without_init="
                f"{self.overhead_without_init_pct:+.2f}%")


def measure(arch="codeqwen1.5-7b", reduced: bool = True,
            n_layers: Optional[int] = None, batch: int = 4, seq: int = 64,
            steps: int = 40, warm: int = 6, device=None) -> Fig10:
    """Fig 10's measurement on ``device`` (CUDA unless told otherwise);
    ``n_layers`` cuts the depth of ``arch``."""
    # repro: allow[wallclock] -- genuine wall measurement
    t0 = time.perf_counter()
    dev = device_lib.resolve(device)
    cfg = as_config(arch, reduced)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    session, workload = build_session(cfg, batch=batch, seq=seq,
                                      ft=FTConfig(mode="replication"),
                                      device=dev)
    session.simulate_replica = False     # redundancy excluded (see above)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def clock():
        sync()
        # repro: allow[wallclock] -- genuine wall measurement
        return time.perf_counter()

    # warm the caches on the exact step both paths share
    state = workload.init_state()
    for i in range(warm):
        state, _ = workload.step(state, i)
    del state

    def init():
        t = clock()
        workload.init_state()
        return clock() - t

    last = {}

    def bare():
        last.pop("bare", None)
        s = workload.init_state()
        t = clock()
        for i in range(steps):
            s, _ = workload.step(s, i)
        dt = clock() - t
        last["bare"] = s
        return dt

    def ft():
        last.pop("ft", None)
        t = clock()
        rep = session.run(workload, steps)
        dt = clock() - t
        last["ft"] = rep
        return dt

    init_s = min(init() for _ in range(3))
    bare_s = min(bare() for _ in range(3))
    ft_s = min(ft() for _ in range(3))
    return Fig10(steps=steps, bare_s=bare_s, ft_s=ft_s, init_s=init_s,
                 # repro: allow[wallclock] -- genuine wall measurement
                 wall_s=time.perf_counter() - t0, report=last["ft"],
                 bare_state=last["bare"])


def run(arch="codeqwen1.5-7b", reduced: bool = True,
        n_layers: Optional[int] = None, batch: int = 4, seq: int = 64,
        steps: int = 40, warm: int = 6, device=None) -> list:
    """The reference's rows: ``fig10/failure_free_overhead`` (wall) and
    ``fig10/ft_time_breakdown`` (virtual time)."""
    return measure(arch, reduced, n_layers, batch, seq, steps, warm,
                   device).rows()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="codeqwen1.5-7b")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    default=True, help="full width (default: reduced)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--warm", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for tests)")
    args = ap.parse_args(argv)
    m = measure(args.arch, args.reduced, args.layers, args.batch, args.seq,
                args.steps, args.warm, args.device)
    print(m.init_line())
    for name, us, derived in m.rows():
        print(f"{name},{us:.0f},{derived}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
