"""The CLI: ``python -m repro_torch.analyze [lint|schedule|divergence|all]``
(port of ``repro/analyze/__main__.py``).

``lint`` runs the AST rules over ``src/repro_torch`` (or ``--path``);
``schedule`` traces the port's three apps at ``n_ranks=4`` and verifies
their op schedules; ``divergence`` seeds one bit flip into a replica's
state and shows the tripwire catching it.  The apps run on ``--device``
(default: the card; raises without CUDA).  Exit status is 1 when any
ERROR-severity finding survives; warnings print but pass.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List

from repro_torch.analyze.findings import (Finding, errors, format_report,
                                          warnings)


def _default_root() -> str:
    # src/repro_torch/analyze/__main__.py -> src/repro_torch
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _paper_apps(device):
    from repro_torch.apps.cloverleaf import CloverLeaf
    from repro_torch.apps.hpcg import HPCG
    from repro_torch.apps.pic import PIC
    return [("hpcg", HPCG(n_ranks=4, device=device)),
            ("pic", PIC(n_ranks=4, device=device)),
            ("cloverleaf", CloverLeaf(n_ranks=4, device=device))]


def run_lint(paths: List[str]) -> List[Finding]:
    from repro_torch.analyze.lint import lint_paths
    return lint_paths(paths)


def run_schedule(steps: int, device=None) -> List[Finding]:
    from repro_torch.analyze.schedule import verify_app
    findings: List[Finding] = []
    for name, app in _paper_apps(device):
        got = verify_app(app, steps=steps, label=name)
        print(f"  {name}: {len(got)} finding(s) over {steps} step(s)")
        findings.extend(got)
    return findings


def run_divergence_demo(device=None) -> List[Finding]:
    """Seed a single bit flip into one replica's state and show the
    detector catching it at the first divergent send."""
    import torch

    from repro_torch.analyze.divergence import ReplicaDivergence
    from repro_torch.apps.hpcg import HPCG
    from repro_torch.configs.base import FTConfig
    from repro_torch.simrt import SimRuntime

    ft = FTConfig(mode="replication", replication_degree=1.0)
    rt = SimRuntime(HPCG(n_ranks=2, nx=4, ny=4, nz=4, device=device), ft,
                    detect_divergence=True)
    # flip one mantissa bit in the halo plane one replica will send, on
    # the tensor's own device (an int64 view of the float64 bits)
    rep_wid = rt.rmap.rep[0]
    vec = rt.workers[rep_wid].state["p"]
    raw = vec.view(torch.int64)
    raw[0, 0, -1] ^= 1
    try:
        rt.run(2)
    except ReplicaDivergence as exc:
        print(f"  caught: {exc}")
        return []
    return [Finding("replica-divergence", "divergence-demo", 0,
                    "seeded bit flip was NOT detected")]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze",
        description="static + runtime correctness analysis of the port")
    parser.add_argument("pass_", nargs="?", default="all",
                        choices=["all", "lint", "schedule", "divergence"],
                        metavar="pass", help="which analysis to run")
    parser.add_argument("--path", action="append", default=None,
                        help="lint root(s); default src/repro_torch")
    parser.add_argument("--steps", type=int, default=2,
                        help="app steps to trace for schedule verify")
    parser.add_argument("--device", default=None,
                        help="where the apps run (default: the card)")
    args = parser.parse_args(argv)

    findings: List[Finding] = []
    if args.pass_ in ("all", "lint"):
        roots = args.path or [_default_root()]
        print(f"lint: {', '.join(roots)}")
        findings.extend(run_lint(roots))
    if args.pass_ in ("all", "schedule"):
        print("schedule verify (traced apps):")
        findings.extend(run_schedule(args.steps, args.device))
    if args.pass_ == "divergence":
        print("divergence demo (seeded bit flip):")
        findings.extend(run_divergence_demo(args.device))

    errs, warns = errors(findings), warnings(findings)
    if findings:
        print(format_report(findings))
    print(f"analyze: {len(errs)} error(s), {len(warns)} warning(s)")
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
