"""Paper Figs 11-12 (CloverLeaf and PIC under failures, checkpointing
against replication at 2,048-8,192 processes) from the port alone, on the
CPU: the reference's ``benchmarks/fig11_12_apps.py`` run with every
``repro`` name it reaches bound to the port (the fixture
``repro_is_the_port`` of ``tests/test_torch_fig_digests.py``). Its rows
must hash to the reference's digest, and one ladder point (CloverLeaf at
8,192) must give the reference's results field by field, the reference
run live in the same test.

A file of its own, so that the suite's ``--dist loadfile`` puts it on a
worker of its own (the figure takes ~40 s on one core).
"""
import dataclasses
import importlib

import pytest
import torch

from repro_torch import simrt
from repro_torch.apps import cloverleaf
from test_torch_fig_digests import (ROOT, _assert_port_only,  # noqa: F401
                                    repro_is_the_port)

# ``benchmarks.pin_digests.digest_rows(benchmarks.fig11_12_apps.run())``
# computed from the reference (``PYTHONPATH=src:. python -c "from
# benchmarks import fig11_12_apps as m, pin_digests as p;
# print(p.digest_rows(m.run()))"``) on the CPU; the reference does not pin
# this figure in ``benchmarks/fig_digests.json``
FIG11_12_DIGEST = \
    "462af7b636d534886675b22b5b0c8a7322c8f5aa603b662bf7fbc1b6e2d7db6b"
POINT = ("CloverLeaf", 8192)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the apps' tensors are small, and the suite
    runs several workers a machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _point(run_median, table1):
    """The two runs of Figs 11-12 at POINT, as the figure makes them."""
    app, procs = POINT
    mu, c = {p: (m, c) for p, m, c in table1[app]}[procs]
    return (run_median(app, procs, mu, c, "checkpoint"),
            run_median(app, procs, mu, c, "replication",
                       step_time_mult=2.0))


@pytest.fixture
def reference_point(monkeypatch):
    """POINT through the reference's ``benchmarks.common``, run before
    the binding."""
    monkeypatch.syspath_prepend(str(ROOT))
    common = importlib.import_module("benchmarks.common")
    assert common.SimRuntime.__module__.startswith("repro.simrt")
    return [dataclasses.asdict(p)
            for p in _point(common.run_median, common.TABLE1)]


def test_fig11_12_from_the_port(reference_point, repro_is_the_port,
                                monkeypatch):
    common = importlib.import_module("benchmarks.common")
    mod = importlib.import_module("benchmarks.fig11_12_apps")
    pin = importlib.import_module("benchmarks.pin_digests")
    for m in (common, mod):
        _assert_port_only(m)
    assert common.SimRuntime is simrt.SimRuntime
    assert common.APPS["CloverLeaf"][0].func is cloverleaf.CloverLeaf
    seen = {}
    inner = mod.run_median

    def recording(app, procs, *args, **kw):
        out = inner(app, procs, *args, **kw)
        if (app, procs) == POINT:
            seen[args[-1]] = out
        return out
    monkeypatch.setattr(mod, "run_median", recording)
    rows = mod.run()
    assert pin.digest_rows(rows) == FIG11_12_DIGEST
    got = [dataclasses.asdict(seen[mode])
           for mode in ("checkpoint", "replication")]
    assert got == reference_point
    row = dict((name, derived) for name, _, derived in rows)[
        "fig11_12/cloverleaf_8192"]
    assert f"t_ckpt={reference_point[0]['total_s']:.0f}s" in row
    assert f"t_repl={reference_point[1]['total_s']:.0f}s" in row
