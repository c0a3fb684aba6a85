"""The repo's four examples on the port (``repro_torch.examples``), on the
CPU, each with its original's assertions (they run inside the modules'
``main``), and, where the original runs in seconds, against the original
itself (``runpy`` of ``examples/*.py``, the reference):

  quickstart           HPCG three ways at the original's size: the same
                       residual bitwise in each run (the original's
                       assertion); counters and the virtual-time
                       breakdown equal to the original's, the residual
                       within 1e-12 relative of it (torch and numpy sum
                       in other orders);
  scaling_crossover    the original's output, line for line;
  serve_with_failover  the original's size: the failover stream equal to
                       the clean one, one promotion at token 8, an
                       unreplicated kill raising;
  train_lm_ft          20 steps (the original's 200 take minutes on one
                       core), kills at 5 (promote), 10 (pair death:
                       restart from disk) and 15 (a replica drops): the
                       final params bitwise the clean run's.
"""
import contextlib
import io
import pathlib
import runpy
import sys

import numpy as np
import pytest
import torch

from repro_torch.examples import (quickstart, scaling_crossover,
                                  serve_with_failover, train_lm_ft)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _original(name, monkeypatch):
    """Run ``examples/<name>.py`` (the reference) and return its globals
    and its output."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(sys, "argv", [f"examples/{name}.py"])
    monkeypatch.setattr(sys, "path", list(sys.path))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        scope = runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                               run_name="__main__")
    return scope, out.getvalue()


def test_quickstart_matches_the_original(monkeypatch, capsys):
    got = quickstart.main(CPU)
    assert "SAME residual" in capsys.readouterr().out
    want, _ = _original("quickstart", monkeypatch)
    for mode, key in (("none", "base"), ("checkpoint", "ck"),
                      ("replication", "rp")):
        g, w = got[mode], want[key]
        assert g.time.as_dict() == w.time.as_dict(), mode
        assert (g.restarts, g.promotions) == (w.restarts, w.promotions)
        assert g.check_value == pytest.approx(w.check_value, rel=1e-12)
    assert got["replication"].promotions == 3
    assert got["checkpoint"].restarts == 3


def test_scaling_crossover_prints_the_originals_output(monkeypatch, capsys):
    got = scaling_crossover.main([])
    out = capsys.readouterr().out
    _, want = _original("scaling_crossover", monkeypatch)
    assert out == want
    assert got["crossover"] == 16384


def test_serve_with_failover(capsys):
    got = serve_with_failover.main(CPU)
    assert np.array_equal(got["clean"], got["failover"])
    assert got["clean"].shape == (4, 16)
    assert got["events"] == [(8, "promote")] and got["promotions"] == 1
    assert "restart + replay required" in got["unreplicated_error"]
    assert "identical stream" in capsys.readouterr().out


def test_train_lm_ft(capsys):
    got = train_lm_ft.main(CPU + ["--steps", "20"])
    faulty, clean = got["faulty"], got["clean"]
    assert [(e.step, e.kind) for e in faulty.events] == [
        (5, "promote"), (10, "restart_elastic"), (15, "continue")]
    assert (faulty.promotions, faulty.restarts) == (1, 1)
    assert faulty.final_state["params"].keys() == \
        clean.final_state["params"].keys()
    assert "FT THEOREM HOLDS" in capsys.readouterr().out


@pytest.mark.parametrize("module", [quickstart, serve_with_failover,
                                    train_lm_ft])
def test_examples_need_cuda_without_device(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(["--steps", "4"] if module is train_lm_ft else [])
