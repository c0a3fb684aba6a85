"""Serving example on the port (port of ``examples/serve_with_failover.py``):
batched generation with mid-decode failover.

Generates from two replicated model slices (the decode loop is a
``DecodeWorkload`` driven by ``FTSession``); kills the computational slice
after 8 tokens and verifies the promoted replica continues the exact same
token stream (its KV cache is current — the paper's no-rollback
recovery). Without replication the same failure is fatal.

  PYTHONPATH=src python -m repro_torch.examples.serve_with_failover \\
      [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.launch.serve import ReplicatedServer

BATCH, PLEN, GEN = 4, 32, 16


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for tests)")
    args = ap.parse_args(argv)
    prompts = np.random.default_rng(0).integers(0, 500, (BATCH, PLEN),
                                                dtype=np.int32)

    def server(replication):
        return ReplicatedServer("qwen3-8b", batch=BATCH, prompt_len=PLEN,
                                replication=replication, device=args.device)

    t_clean = server(True).generate(prompts, GEN, kill_at=-1)
    faulty = server(True)
    t_fail = faulty.generate(prompts, GEN, kill_at=8)

    assert np.array_equal(t_clean, t_fail), "failover changed generation!"
    events = [(e.step, e.kind) for e in faulty.last_report.events]
    print(f"generated {t_fail.shape} tokens; failover after 8 tokens "
          f"(promotions={faulty.promotions}, events={events}) produced an "
          f"identical stream.")

    # without replication the same failure is fatal
    try:
        server(False).generate(prompts, GEN, kill_at=8)
        raise SystemExit("expected failure without replication")
    except RuntimeError as e:
        error = str(e)
        print(f"without replication: {e}")
    return {"clean": t_clean, "failover": t_fail, "events": events,
            "promotions": faulty.promotions, "unreplicated_error": error}


if __name__ == "__main__":
    main()
