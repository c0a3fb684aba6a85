"""Demo CLI for the elastic task pool: ``python -m repro_torch.pool``.

Runs the hyperparameter-sweep workload under a chosen FT mode with
Weibull failures and prints the pool ledger — a smoke-testable tour of
dispatch, replica-covered promotion and elastic rank retirement.  The
tasks run on the card unless ``--device cpu`` is given.
(This module is a CLI entry point: prints are exempt from the no-print
lint, see analyze.lint._CLI_MODULE_SUFFIXES.)
"""
from __future__ import annotations

import argparse

from repro_torch.pool.workloads import hyperparameter_sweep_tasks, run_pool


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.pool",
        description="elastic replica-aware master/worker task pool demo")
    ap.add_argument("--mode", default="replication",
                    choices=["none", "checkpoint", "replication",
                             "combined"])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--replication-degree", type=float, default=1.0)
    ap.add_argument("--mtbf", type=float, default=0.0,
                    help="Weibull MTBF in virtual seconds (0: no failures)")
    ap.add_argument("--policy", default="lpt", choices=["fifo", "lpt"])
    ap.add_argument("--speculate", action="store_true")
    ap.add_argument("--topology", default=None,
                    choices=[None, "flat", "fattree", "dragonfly",
                             "torus3d"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the tasks compute (default: the card)")
    args = ap.parse_args(argv)

    tasks = hyperparameter_sweep_tasks(pool_seed=args.seed)
    report, pool = run_pool(
        tasks, mode=args.mode, n_workers=args.workers,
        n_steps=args.steps, replication_degree=args.replication_degree,
        mtbf_s=args.mtbf or None, seed=args.seed, policy=args.policy,
        speculate=args.speculate, topology=args.topology,
        device=args.device)
    stats = pool.pool_stats(report.final_state)

    print(f"pool demo: mode={args.mode} workers={args.workers} "
          f"steps={report.steps} tasks={len(tasks)} device={pool.device}")
    print(f"  completed={stats['completed']} "
          f"dispatched={stats['dispatched']} "
          f"reassigned={stats['reassigned']} "
          f"replica_covered={stats['replica_covered']} "
          f"duplicates={stats['duplicates']}")
    print(f"  occupancy={stats['occupancy']:.2f} "
          f"latency_mean={stats['latency_mean_rounds']:.1f}r "
          f"p99={stats['latency_p99_rounds']:.0f}r "
          f"retired_ranks={stats['retired_ranks']}")
    print(f"  failures={report.failures} promotions={report.promotions} "
          f"restarts={report.restarts} "
          f"rolled_back={report.rolled_back_steps}")
    print(f"  time: useful={report.time.useful:.0f}s "
          f"redundant={report.time.redundant:.0f}s "
          f"repair={report.time.repair:.3f}s "
          f"comm={report.time.comm:.3f}s "
          f"efficiency={report.efficiency:.3f}")
    best = None
    for tid in sorted(report.final_state["ms"]["results"]):
        value = report.final_state["ms"]["results"][tid]
        if isinstance(value, dict) and "loss" in value:
            if best is None or value["loss"] < best[1]["loss"]:
                best = (tid, value)
    if best is not None:
        print(f"  best: {best[0]} loss={best[1]['loss']:.4f} "
              f"lr={best[1]['lr']} width={best[1]['width']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
