"""End-to-end training example on the port (port of
``examples/train_lm_ft.py``): train an LM under the FT framework
(checkpoint + replication) with injected failures, and verify the FT
theorem: the final parameters match a failure-free run exactly.

The training analogue of the paper's HPCG experiments, driven through
``FTSession`` + ``TrainWorkload``: the replica slice redundantly executes
every step; a computational-slice kill promotes the replica (no
rollback); a pair death falls back to the last Young-Daly checkpoint.

  PYTHONPATH=src python -m repro_torch.examples.train_lm_ft \\
      [--steps 200] [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.configs.base import FTConfig
from repro_torch.launch.train import build_session


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for tests)")
    args = ap.parse_args(argv)

    # the reduced config (a few M params); a full one on a real machine
    kills = {args.steps // 4: [0],              # cmp slice dies -> promote
             args.steps // 2: [1, 9],           # cmp + its replica -> restart
             3 * args.steps // 4: [10]}         # replica dies -> drop

    with tempfile.TemporaryDirectory() as d:
        ft = FTConfig(mode="combined", mtbf_s=1e9, ckpt_interval_s=25.0)
        session, workload = build_session(
            args.arch, reduced=True, batch=8, seq=128, ft=ft, ckpt_dir=d,
            kill_schedule=dict(kills), n_logical_workers=8,
            device=args.device)
        rep_f = session.run(workload, args.steps)

    clean_session, clean_workload = build_session(
        args.arch, reduced=True, batch=8, seq=128, ft=FTConfig(mode="none"),
        device=args.device)
    rep_c = clean_session.run(clean_workload, args.steps)

    print(f"faulty : steps={rep_f.steps} failures={rep_f.failures} "
          f"promotions={rep_f.promotions} restarts={rep_f.restarts} "
          f"ckpts={rep_f.ckpt_writes} loss={rep_f.losses[-1]:.5f}")
    print(f"clean  : steps={rep_c.steps} loss={rep_c.losses[-1]:.5f}")
    print("event stream:", [(e.step, e.kind) for e in rep_f.events])

    fa = rep_f.final_state["params"]
    cl = rep_c.final_state["params"]
    assert list(fa) == list(cl)
    worst = max(float((fa[k].float() - cl[k].float()).abs().max())
                for k in cl)
    print(f"max |param diff| faulty vs clean: {worst:.3e}")
    assert all(torch.equal(fa[k], cl[k]) for k in cl), \
        "FT theorem violated: failures changed the result"
    print("FT THEOREM HOLDS: failures + promotion + restart left training "
          "bitwise identical.")
    return {"faulty": rep_f, "clean": rep_c}


if __name__ == "__main__":
    main()
