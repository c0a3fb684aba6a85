"""Nothing the benchmark runs loads JAX or the JAX package: in a fresh
process, import the harness and drive a whole tiny run on the CPU, then
look at ``sys.modules`` by whole top-level names (the port's name begins
with the JAX package's, so a prefix test would be wrong)."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = r"""
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(2)
from perfbench import bench, run, calibrate, weights
from perfbench.tests import tiny
for name in [w["name"] for w in json.load(open({manifest!r}))["workloads"]]:
    out = bench.run(tiny.cell(name), 5, 0.1, False, t_start=time.time(),
                    device="cpu")
    assert out["result"]["correct"], out["checks"]
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def test_no_jax_module_is_loaded():
    code = SCRIPT.format(root=str(ROOT), src=str(ROOT / "src"),
                         manifest=str(ROOT / "BENCHMARK.json"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "perfbench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_forbidden_names_are_whole_names(monkeypatch):
    from perfbench import bench
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert "repro" not in bench.forbidden_modules() or "repro" in {
        n.split(".")[0] for n in sys.modules}
