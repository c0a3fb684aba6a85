"""Paper Fig 10 (the FT layer's failure-free overhead) from the port, on
the CPU: the reference's ``benchmarks/fig10_overhead.py`` run with its
``repro`` names bound to the port (``build_session`` through
``functools.partial(..., device="cpu")``), and the port's own
``repro_torch.figures.fig10_overhead``. The wall-time row is a
measurement and differs from run to run; the virtual-time row
``fig10/ft_time_breakdown`` must equal the reference's own run of the
script, and the FT run's final state must be bitwise the bare loop's.
"""
import functools
import importlib
import re
import sys

import pytest
import torch

from repro_torch.configs import base as configs_base
from repro_torch.figures import fig10_overhead
from repro_torch.launch import train as port_train
from test_torch_fig_digests import (ROOT, _assert_port_only,  # noqa: F401
                                    _stand_in, repro_is_the_port)

NAMES = ["fig10/failure_free_overhead", "fig10/ft_time_breakdown"]
OVERHEAD = re.compile(r"overhead=[+-]\d+\.\d\d% \(paper: 1\.3%\) "
                      r"bare=\d+\.\dms/step ft=\d+\.\dms/step$")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the reduced model's ops are small, and the
    suite runs several workers a machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def reference_rows():
    """The reference's own run of the script (before any binding)."""
    mp = pytest.MonkeyPatch()
    mp.syspath_prepend(str(ROOT))
    try:
        mod = importlib.import_module("benchmarks.fig10_overhead")
        assert mod.build_session.__module__ == "repro.launch.train"
        return mod.run()
    finally:
        mp.undo()


@pytest.fixture
def fig10_is_the_port(repro_is_the_port, monkeypatch):
    """``repro_is_the_port`` with the train entry point bound as well."""
    launch_train = _stand_in(
        "repro.launch.train",
        build_session=functools.partial(port_train.build_session,
                                        device="cpu"))
    monkeypatch.setitem(sys.modules, "repro.launch",
                        _stand_in("repro.launch", train=launch_train))
    monkeypatch.setitem(sys.modules, "repro.launch.train",
                        launch_train)
    assert sys.modules["repro.configs.base"] is configs_base


def test_reference_script_runs_on_the_port(reference_rows,
                                           fig10_is_the_port):
    mod = importlib.import_module("benchmarks.fig10_overhead")
    _assert_port_only(mod)
    assert mod.build_session.func is port_train.build_session
    assert mod.FTConfig is configs_base.FTConfig
    rows = mod.run()
    assert [r[0] for r in rows] == [r[0] for r in reference_rows] == NAMES
    assert OVERHEAD.match(rows[0][2]), rows[0][2]
    assert rows[1][2] == reference_rows[1][2] == \
        "useful=40s redundant=40s total=80s"


def test_port_figure_module(reference_rows):
    """``run(device="cpu")`` at the reference's configuration: its names
    and its breakdown."""
    rows = fig10_overhead.run(device="cpu")
    assert [r[0] for r in rows] == NAMES
    assert OVERHEAD.match(rows[0][2]), rows[0][2]
    assert rows[1][2] == reference_rows[1][2]


def test_ft_run_ends_on_the_bare_loops_state():
    """``measure``: the init line, no failure, and the FT run's final state
    bitwise the bare loop's (both start from the seeded init)."""
    m = fig10_overhead.measure(steps=5, warm=1, device="cpu")
    assert re.match(r"fig10/init_state init=\d+\.\dms "
                    r"overhead_without_init=[+-]\d+\.\d\d%$", m.init_line())
    assert m.report.promotions == m.report.failures == 0
    assert m.report.steps == len(m.report.losses) == 5
    ft_state, bare = m.report.final_state, m.bare_state
    assert int(ft_state["opt"].step) == int(bare["opt"].step) == 5
    for k, v in bare["params"].items():
        assert torch.equal(ft_state["params"][k], v), k
    for a, b in ((ft_state["opt"].m, bare["opt"].m),
                 (ft_state["opt"].v, bare["opt"].v)):
        assert all(torch.equal(a[k], b[k]) for k in b)


def test_cli_prints_the_rows(capsys):
    assert fig10_overhead.main(["--device", "cpu", "--steps", "3",
                                "--warm", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("fig10/init_state init=")
    assert [line.split(",")[0] for line in out[1:]] == NAMES
    assert out[2].endswith("useful=3s redundant=3s total=6s")


def test_fig10_needs_cuda_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fig10_overhead.measure(steps=1, warm=0)
