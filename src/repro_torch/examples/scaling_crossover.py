"""The paper's scaling crossover (Figs 7/8) from the port's policy model
(port of ``examples/scaling_crossover.py``): beyond a certain core count,
spending half the machine on replicas beats spending all of it on
computation + checkpoints. The model is host arithmetic: it runs no
kernel and takes no device.

  PYTHONPATH=src python -m repro_torch.examples.scaling_crossover
"""
from __future__ import annotations

import argparse

from repro_torch.core import ckpt_policy


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    # the paper's HPCG ladder: 1024 procs @ mu=16000s, C=46s -> 8192 @
    # 2000s/215s
    print(f"{'procs':>6} {'MTBF(s)':>8} {'C(s)':>6} {'tau*(s)':>8} "
          f"{'eff_ckpt':>9} {'eff_repl':>9} {'winner':>12}")
    points = ckpt_policy.scaling_study(base_procs=1024, base_mtbf_s=16000,
                                       base_ckpt_cost_s=46,
                                       runtime_s=3 * 3600, n_doublings=4)
    for pt in points:
        tau = ckpt_policy.young_daly_interval(pt.job_mtbf_s, pt.ckpt_cost_s)
        winner = "replication" if pt.repl_eff > pt.ckpt_eff else "checkpoint"
        print(f"{pt.n_procs:6d} {pt.job_mtbf_s:8.0f} {pt.ckpt_cost_s:6.0f} "
              f"{tau:8.1f} {pt.ckpt_eff:9.3f} {pt.repl_eff:9.3f} "
              f"{winner:>12}")

    cross = ckpt_policy.crossover_processes(1024, 16000, 46, 3 * 3600)
    print(f"\ncrossover at {cross} processes "
          f"(paper: 8192 cores at MTBF 2000 s).")

    # diskless combined mode (store/): pushing checkpoint shards to k
    # partner memories makes C network-bound and scale-free, so the
    # combined mode overtakes plain checkpoint/restart at a SMALLER
    # process count
    c_mem = ckpt_policy.memstore_ckpt_cost(1.4e9)     # ~1.4 GB/proc state
    r_disk = 46 + 1000.0                              # reload + relaunch
    r_mem = ckpt_policy.memstore_restore_cost(1.4e9)
    cross_disk = ckpt_policy.combined_crossover_processes(
        1024, 16000, 46, restart_cost_s=r_disk,
        combined_restart_cost_s=r_disk)
    cross_mem = ckpt_policy.combined_crossover_processes(
        1024, 16000, 46, combined_ckpt_cost_s=c_mem,
        restart_cost_s=r_disk, combined_restart_cost_s=r_mem)
    print(f"combined-mode crossover vs plain C/R: disk C -> {cross_disk} "
          f"procs, memstore C={c_mem:.2f}s -> {cross_mem} procs "
          f"(see benchmarks/fig14_memstore.py)")
    return {"points": points, "crossover": cross, "c_mem": c_mem,
            "crossover_disk": cross_disk, "crossover_mem": cross_mem}


if __name__ == "__main__":
    main()
