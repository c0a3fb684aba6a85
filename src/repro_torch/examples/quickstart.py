"""Quickstart: the paper's headline mechanism on the port (port of
``examples/quickstart.py``).

Runs HPCG (conjugate gradient, the paper's main benchmark) on the
simulated runtime three ways and prints the outcome:
  1. failure-free baseline,
  2. pure checkpoint/restart under injected failures (rollback cost),
  3. pure replication under the same failures (promotion, no rollback),
and verifies all three produce the SAME residual — the paper's claim that
replication-based fault tolerance is transparent to the application.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.apps.hpcg import HPCG
from repro_torch.configs.base import FTConfig
from repro_torch.core.failure_sim import FailureEvent
from repro_torch.simrt import CostModel, SimRuntime

N_RANKS, STEPS = 4, 25
COSTS = CostModel(step_time_s=1.0, ckpt_cost_s=0.4, restore_cost_s=0.6)
FAILS = [FailureEvent(6.5, (1,)), FailureEvent(13.2, (2,)),
         FailureEvent(19.7, (0,))]


def run(mode, events, device=None):
    app = HPCG(n_ranks=N_RANKS, nx=16, ny=16, nz=8, device=device)
    ft = FTConfig(mode=mode, replication_degree=1.0, mtbf_s=1e9,
                  ckpt_interval_s=6.0)
    with tempfile.TemporaryDirectory() as d:
        rt = SimRuntime(app, ft, costs=COSTS, ckpt_dir=d,
                        failure_events=list(events), workers_per_node=2)
        return rt.run(STEPS)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for tests)")
    args = ap.parse_args(argv)
    base = run("none", [], args.device)
    ck = run("checkpoint", FAILS, args.device)
    rp = run("replication", FAILS, args.device)

    print(f"{'mode':14s} {'residual':>14s} {'time(s)':>8s} {'useful':>7s} "
          f"{'ckpt':>5s} {'rollbk':>6s} {'restarts':>8s} {'promos':>6s}")
    for name, r in [("failure-free", base), ("checkpoint", ck),
                    ("replication", rp)]:
        t = r.time
        print(f"{name:14s} {r.check_value:14.9f} {t.total:8.1f} "
              f"{t.useful:7.1f} {t.ckpt_write:5.1f} {t.rollback:6.1f} "
              f"{r.restarts:8d} {r.promotions:6d}")

    assert abs(ck.check_value - base.check_value) < 1e-12, "ckpt diverged!"
    assert abs(rp.check_value - base.check_value) < 1e-12, \
        "replication diverged!"
    print("\nAll three runs converge to the SAME residual (bitwise).")
    print(f"Replication paid {rp.time.rollback:.1f}s rollback vs "
          f"checkpoint's {ck.time.rollback:.1f}s — the paper's core result "
          f"in miniature.")
    return {"none": base, "checkpoint": ck, "replication": rp}


if __name__ == "__main__":
    main()
