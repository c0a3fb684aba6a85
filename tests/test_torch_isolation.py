"""The port stands alone: no jax and nothing of the JAX package is
imported by ``src/repro_torch`` or ``chip_smoke.py``, and its entry points
run on the card unless told otherwise — without CUDA they raise."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch import device as device_lib
from repro_torch.launch.serve import ReplicatedServer

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}
NO_GPU = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
              CUDA_VISIBLE_DEVICES="")


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert not set(_imported_roots(path)) & FORBIDDEN


@pytest.mark.parametrize("package", ["analyze", "obs", "store", "ft",
                                     "core", "comm", "clock", "data",
                                     "optim", "checkpoint", "launch",
                                     "kernels", "models", "simrt", "apps",
                                     "pool"])
def test_scan_covers_the_package(package):
    """The AST scan and the blocked import walk every module of each
    package of the port, the observability layer, the checkpoint store,
    the training path (data, optim, checkpoint, launch.train, the
    kernels' autograd), the simulated runtime, the apps and the task pool
    included."""
    files = sorted((ROOT / "src" / "repro_torch" / package).glob("*.py"))
    assert files and all(f in PORT_FILES for f in files)


def test_port_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], env=NO_GPU,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_server_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReplicatedServer("qwen3-8b", batch=2, prompt_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_lib.resolve()
    assert device_lib.resolve("cpu") == torch.device("cpu")
    assert device_lib.resolve("meta") == torch.device("meta")


def test_serve_cli_on_cpu_and_without_cuda():
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--batch", "2",
           "--prompt-len", "16", "--gen", "6", "--kill-at", "2"]
    ok = subprocess.run(cmd + ["--device", "cpu"], env=NO_GPU, cwd=ROOT,
                        capture_output=True, text=True, timeout=300)
    assert ok.returncode == 0, ok.stderr
    assert "promotions=1" in ok.stdout and "tok/s=" in ok.stdout
    fatal = subprocess.run(cmd + ["--device", "cpu", "--no-replication"],
                           env=NO_GPU, cwd=ROOT, capture_output=True,
                           text=True, timeout=300)
    assert fatal.returncode != 0 and "RuntimeError" in fatal.stderr
    no_gpu = subprocess.run(cmd, env=NO_GPU, cwd=ROOT, capture_output=True,
                            text=True, timeout=300)
    assert no_gpu.returncode != 0
    assert "CUDA is not available" in no_gpu.stderr


def test_simulated_runtime_on_cpu_and_without_cuda(monkeypatch, tmp_path):
    """The apps, and so the simulated runtime and ``python -m
    repro_torch.obs``, run on the card unless told otherwise: without CUDA
    they raise; with ``--device cpu`` the CLI runs."""
    from repro_torch.apps.cloverleaf import CloverLeaf
    from repro_torch.apps.hpcg import HPCG
    from repro_torch.apps.pic import PIC
    from repro_torch.obs.demo import traced_hpcg_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for app in (HPCG, CloverLeaf, PIC):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            app(n_ranks=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        traced_hpcg_run(4, steps=2, grid=(2, 2, 2))
    cmd = [sys.executable, "-m", "repro_torch.obs", "metrics",
           str(tmp_path / "m.json"), "--ranks", "4", "--steps", "3"]
    ok = subprocess.run(cmd + ["--device", "cpu"], env=NO_GPU, cwd=ROOT,
                        capture_output=True, text=True, timeout=300)
    assert ok.returncode == 0, ok.stderr
    assert "wrote metrics snapshot" in ok.stdout
    no_gpu = subprocess.run(cmd, env=NO_GPU, cwd=ROOT, capture_output=True,
                            text=True, timeout=300)
    assert no_gpu.returncode != 0
    assert "CUDA is not available" in no_gpu.stderr


def test_chip_smoke_fails_without_cuda_and_outside_the_repo(tmp_path):
    run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=NO_GPU, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode != 0 and '"ok": true' not in run.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           env=dict(os.environ, PYTHONPATH=""),
                           capture_output=True, text=True, timeout=120)
    assert alone.returncode != 0 and '"ok": true' not in alone.stdout
