#!/usr/bin/env python3
"""The in-memory store's bytes, the port against the JAX package's, on the
CPU: the accounting behind ROADMAP.md's F8.

    python3 tools/store_bytes_check.py

Runs the traced HPCG demo (``obs.demo.traced_hpcg_run`` with 16 ranks, 8
steps, grid (4, 4, 2); combined strategy, a node killed) from both
packages, unpriced and under fattree pricing, and prints one JSON line
each: the store's counters (``comm.bytes.store.cmp``,
``comm.bytes.store.rep``), its committed bytes and the ledger's
``ckpt_write`` seconds, for the reference, the port, and the port with its
sender-log message class pickled under a module path as long as the
reference's (so the only share left, the port's longer module path, is
taken out). Imports the reference, so it runs where JAX does, never on the
card.
"""
from __future__ import annotations

import json
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro.obs.demo import traced_hpcg_run as ref_run  # noqa: E402
from repro_torch.core.message_log import LoggedMessage  # noqa: E402
from repro_torch.obs.demo import traced_hpcg_run as port_run  # noqa: E402

KILLED = dict(n_ranks=16, steps=8, grid=(4, 4, 2))
KEYS = (("counters", "comm.bytes.store.cmp"),
        ("counters", "comm.bytes.store.rep"),
        ("gauges", "store.committed_bytes"))


def _counts(report):
    m = report.obs_metrics
    out = {name: m[key][name] for key, name in KEYS}
    out["ckpt_write_s"] = report.time.ckpt_write
    return out


def _port_under_reference_length_path(topology):
    root = "x" * len("repro")
    names = (root, f"{root}.core", f"{root}.core.message_log")
    for name in names:
        sys.modules[name] = types.ModuleType(name)
    sys.modules[names[-1]].LoggedMessage = LoggedMessage
    LoggedMessage.__module__ = names[-1]
    try:
        return port_run(device="cpu", topology=topology, **KILLED)[1]
    finally:
        LoggedMessage.__module__ = "repro_torch.core.message_log"
        for name in names:
            del sys.modules[name]


def main() -> int:
    for topology in (None, "fattree"):
        ref = _counts(ref_run(topology=topology, **KILLED)[1])
        port = _counts(port_run(device="cpu", topology=topology,
                                **KILLED)[1])
        same = _counts(_port_under_reference_length_path(topology))
        print(json.dumps({
            "topology": topology, "reference": ref, "port": port,
            "port_minus_reference": {k: port[k] - ref[k] for k in ref},
            "port_reference_length_path": same,
            "equal_without_the_path_share": same == ref}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
