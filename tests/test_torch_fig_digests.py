"""The paper's figures from the port alone: the pinned digests of
``benchmarks/fig_digests.json`` reproduced bitwise, on the CPU.

The figure modules (``benchmarks/common.py``, ``fig13_log_replay``,
``fig14_memstore``, ``fig15_topology``, ``fig9_time_distribution``,
``fig7_8_hpcg``, ``fig16_taskpool``) import ``repro`` at module level and
inside functions.  For the length of a test, the fixture
``repro_is_the_port`` takes every ``repro`` module out of ``sys.modules``,
binds each name they import to its port counterpart (the apps and the
pool's ``run_pool`` through ``functools.partial(..., device="cpu")``; the
packages ``repro``, ``repro.apps``, ``repro.configs`` and
``repro.core`` as stand-ins whose attributes are the port's modules, since
``from repro.core import ckpt_policy`` reads an attribute of the package),
and puts a finder first on ``sys.meta_path`` that refuses any other
``repro`` import.  The figure modules are then loaded afresh, every object
reached from their namespaces is checked to come from ``repro_torch``
(so the gate cannot pass by running the reference), and the digest of
each module's ``run()`` must equal the pinned one.  Afterwards the modules
loaded under the binding are dropped and ``monkeypatch`` puts
``sys.modules`` and ``sys.meta_path`` back, so the reference's own tests
see the reference.  Nothing in ``benchmarks/`` is edited.

The digests hash only the derived (virtual-time) columns, which do not
depend on the numbers the apps compute, so the port's torch apps give the
reference's digests exactly.  Fig 16's rows read the pool's counters and
its priced ledger under fattree, where the in-memory checkpoints' bytes
enter C: the port's pickles are the reference's but for the module path of
the sender log's message class (``repro_torch.`` against ``repro.``, six
bytes a pickle), which moves no printed digit.
"""
import functools
import importlib
import json
import pathlib
import sys
import types

import pytest

from repro_torch.apps import cloverleaf, hpcg, pic
from repro_torch.configs import base as configs_base
from repro_torch.core import ckpt_policy, failure_sim
from repro_torch import obs, pool, simrt, topo

ROOT = pathlib.Path(__file__).resolve().parents[1]
PINNED = json.loads((ROOT / "benchmarks" / "fig_digests.json").read_text())
FIGURES = ["fig13_log_replay", "fig14_memstore", "fig15_topology",
           "fig9_time_distribution", "fig7_8_hpcg", "fig16_taskpool"]


def _stand_in(name, **attrs):
    mod = types.ModuleType(f"{name} (bound to repro_torch)")
    mod.__dict__.update(attrs)
    mod.__path__ = []                   # a package: submodules resolve
    return mod


def _cpu_pool():
    mod = types.ModuleType("repro_torch.pool (device='cpu')")
    mod.__dict__.update(
        hyperparameter_sweep_tasks=pool.hyperparameter_sweep_tasks,
        monte_carlo_tasks=pool.monte_carlo_tasks,
        run_pool=functools.partial(pool.run_pool, device="cpu"))
    return mod


def _cpu_app(module, cls_name):
    mod = types.ModuleType(f"{module.__name__} (device='cpu')")
    setattr(mod, cls_name, functools.partial(getattr(module, cls_name),
                                             device="cpu"))
    return mod


class _RefuseRepro:
    """A meta-path finder that refuses every ``repro`` import not bound
    to the port."""

    @staticmethod
    def find_spec(name, path=None, target=None):
        if name == "repro" or name.startswith("repro."):
            raise ImportError(f"{name} is not bound to the port")
        return None


def _bound_here(name):
    return name in ("repro", "benchmarks") or \
        name.startswith(("repro.", "benchmarks."))


@pytest.fixture
def repro_is_the_port(monkeypatch):
    """Bind the ``repro`` modules the figure benchmarks import to the
    port for the test; undone afterwards."""
    apps = {"hpcg": _cpu_app(hpcg, "HPCG"),
            "cloverleaf": _cpu_app(cloverleaf, "CloverLeaf"),
            "pic": _cpu_app(pic, "PIC")}
    bound = {
        "repro.apps.hpcg": apps["hpcg"],
        "repro.apps.cloverleaf": apps["cloverleaf"],
        "repro.apps.pic": apps["pic"],
        "repro.apps": _stand_in("repro.apps", **apps),
        "repro.configs.base": configs_base,
        "repro.configs": _stand_in("repro.configs", base=configs_base),
        "repro.core.failure_sim": failure_sim,
        "repro.core.ckpt_policy": ckpt_policy,
        "repro.core": _stand_in("repro.core", failure_sim=failure_sim,
                                ckpt_policy=ckpt_policy),
        "repro.simrt": simrt,
        "repro.topo": topo,
        "repro.obs": obs,
        "repro.pool": _cpu_pool(),
    }
    bound["repro"] = _stand_in(
        "repro", apps=bound["repro.apps"], configs=bound["repro.configs"],
        core=bound["repro.core"], simrt=simrt, topo=topo, obs=obs,
        pool=bound["repro.pool"])
    before = [name for name in sys.modules if _bound_here(name)]
    for name in before:
        monkeypatch.delitem(sys.modules, name)
    for name, mod in bound.items():
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.setattr(sys, "meta_path", [_RefuseRepro()] + sys.meta_path)
    monkeypatch.syspath_prepend(str(ROOT))
    yield
    # the figure modules loaded against the port go; monkeypatch then
    # restores the reference's modules
    for name in [n for n in sys.modules if _bound_here(n)]:
        if name not in bound:
            del sys.modules[name]


def _origins(obj, seen, depth=0):
    """The module names behind ``obj`` and whatever it holds (containers,
    partials, stand-in modules), two levels deep."""
    if id(obj) in seen or depth > 2:
        return
    seen.add(id(obj))
    if isinstance(obj, functools.partial):
        yield from _origins(obj.func, seen, depth)
        return
    if isinstance(obj, types.ModuleType):
        yield obj.__name__
        if obj.__name__.endswith("(bound to repro_torch)") or \
                "(device='cpu')" in obj.__name__:
            for v in vars(obj).values():
                yield from _origins(v, seen, depth + 1)
        return
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _origins(v, seen, depth + 1)
        return
    if isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _origins(v, seen, depth + 1)
        return
    module = getattr(obj, "__module__", None)
    if isinstance(module, str):
        yield module


def _assert_port_only(mod):
    for name, value in vars(mod).items():
        if name.startswith("__"):
            continue
        for origin in _origins(value, set()):
            assert origin != "repro" and not origin.startswith("repro."), \
                (mod.__name__, name, origin)


def test_the_finder_refuses_unbound_reference_modules(repro_is_the_port):
    with pytest.raises(ImportError, match="not bound to the port"):
        importlib.import_module("repro.comm")
    from repro.core import ckpt_policy as bound
    assert bound is ckpt_policy
    from repro.apps.hpcg import HPCG
    assert HPCG(n_ranks=2).device.type == "cpu"


@pytest.mark.parametrize("figure", FIGURES)
def test_pinned_digest_from_the_port(figure, repro_is_the_port):
    common = importlib.import_module("benchmarks.common")
    mod = importlib.import_module(f"benchmarks.{figure}")
    pin = importlib.import_module("benchmarks.pin_digests")
    for m in (common, mod):
        _assert_port_only(m)
    assert common.SimRuntime is simrt.SimRuntime
    assert common.APPS["HPCG"][0].func is hpcg.HPCG
    assert pin.digest_rows(mod.run()) == PINNED[figure]


def test_the_binding_is_undone(monkeypatch):
    """After the bound tests the reference's modules are back, and the
    figure modules load against the reference again."""
    import repro.simrt
    assert repro.simrt.__name__ == "repro.simrt"
    monkeypatch.syspath_prepend(str(ROOT))
    common = importlib.import_module("benchmarks.common")
    assert common.SimRuntime is repro.simrt.SimRuntime
