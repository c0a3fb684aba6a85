"""CLI: run the traced demo scenario and export its artifacts.

    python -m repro_torch.obs trace run.json      # Chrome-trace JSON
    python -m repro_torch.obs metrics run.json    # metrics snapshot JSON
    python -m repro_torch.obs flame               # text flamegraph to stdout

All three run the canonical scenario (``obs.demo``): HPCG @ 64 ranks,
combined strategy over the in-memory store, fat-tree pricing, one
mid-run node kill.  ``--ranks/--steps/--kill-node`` rescale it.  HPCG runs
on the card unless ``--device cpu`` is given; without CUDA it raises.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.demo import traced_hpcg_run
from repro_torch.obs.exporters import text_flamegraph, write_chrome_trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    ap.add_argument("command", choices=("trace", "metrics", "flame"))
    ap.add_argument("path", nargs="?", default=None,
                    help="output file (trace/metrics)")
    ap.add_argument("--ranks", type=int, default=64)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--kill-node", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of the app (default: cuda)")
    args = ap.parse_args(argv)
    if args.command in ("trace", "metrics") and args.path is None:
        ap.error(f"{args.command} needs an output path")

    _rt, res, obs = traced_hpcg_run(args.ranks, steps=args.steps,
                                    kill_node=args.kill_node,
                                    device=args.device)
    snap = obs.snapshot()
    if args.command == "trace":
        data = write_chrome_trace(args.path, obs.tracer, snap)
        print(f"wrote {len(data['traceEvents'])} trace events "
              f"({res.failures} failures, {res.promotions} promotions, "
              f"{res.replays} replayed messages) -> {args.path}")
    elif args.command == "metrics":
        obs.metrics.to_json(args.path, time_distribution=snap.get(
            "time_distribution"), links=snap.get("links"),
            world=snap.get("world"))
        print(f"wrote metrics snapshot -> {args.path}")
    else:
        sys.stdout.write(text_flamegraph(obs.tracer))
    return 0


if __name__ == "__main__":
    sys.exit(main())
