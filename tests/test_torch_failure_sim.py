"""The port's failure injectors and ``SimAppWorkload`` against the JAX
package's, on the CPU.

``repro_torch.core.failure_sim`` is a numpy copy of the reference's module,
so the same seeds draw the same Weibull and log-replay schedules and the
same synthetic Tsubame log, event for event (exact).  The injector
classes of ``repro_torch.ft.injector`` wrap them as the reference's do.
``SimAppWorkload`` runs the port's apps (torch, on the CPU) under the
sequential resolver: bitwise the simulated runtime's failure-free run,
within ``RTOL`` of the reference's apps (``tests/test_torch_simrt.py``
gives the reason), and bitwise the clean run after a promotion under
``FTSession``.

Ported: ``tests/test_failure_sim.py`` and ``tests/test_ft_session.py``'s
injector and app-workload tests (``:138-226``).
"""
import math
from collections import Counter

import numpy as np
import pytest
import torch

from repro.apps.hpcg import HPCG as RefHPCG
from repro.apps.pic import PIC as RefPIC
from repro.core import failure_sim as ref_failure_sim
from repro.ft import SimAppWorkload as RefSimAppWorkload
from repro.ft import WeibullFailureInjector as RefWeibullFailureInjector
from repro.ft.injector import LogReplayFailureInjector as RefLogReplay
from repro_torch.apps.hpcg import HPCG
from repro_torch.apps.pic import PIC
from repro_torch.configs.base import FTConfig
from repro_torch.core import failure_sim
from repro_torch.core.failure_sim import (FailureEvent, LogReplayInjector,
                                          WeibullInjector, synth_tsubame_log)
from repro_torch.ft import (FTSession, LogReplayFailureInjector, NoFailures,
                            SimAppWorkload, StepKillInjector,
                            TimedEventInjector, WeibullFailureInjector,
                            as_injector)
from repro_torch.ft import injector as injector_lib
from repro_torch.simrt import CostModel, SimRuntime

# tests/test_torch_simrt.py's agreement with the reference's apps
RTOL = 1e-12
STEPS = 12


def events(evs):
    return [(e.time_s, e.workers, e.node) for e in evs]


# --------------------------------------- tests/test_failure_sim.py, on the port

def test_weibull_mean_matches_mtbf():
    inj = WeibullInjector(mtbf_s=2000.0, shape=0.7, seed=3)
    draws = [inj.draw_interval() for _ in range(20000)]
    assert np.mean(draws) == pytest.approx(2000.0, rel=0.05)


def test_weibull_shape_burstier_than_exponential():
    """shape<1 => CV > 1 (bursty, like real failure traces)."""
    inj = WeibullInjector(2000.0, shape=0.7, seed=0)
    d = np.array([inj.draw_interval() for _ in range(20000)])
    cv = d.std() / d.mean()
    assert cv > 1.1


def test_schedule_within_horizon():
    inj = WeibullInjector(10.0, seed=1)
    ev = inj.schedule(100.0, alive_workers=range(8))
    assert all(0 < e.time_s < 100.0 for e in ev)
    assert all(0 <= e.workers[0] < 8 for e in ev)
    assert len(ev) > 2


def test_log_replay_node_mapping_and_scale():
    log = [(0.0, "nodeA"), (1000.0, "nodeB"), (2000.0, "nodeA")]
    inj = LogReplayInjector(log, workers_per_node=4, n_workers=8,
                            time_scale=0.01)
    ev = inj.schedule(1e9)
    assert len(ev) == 3
    assert ev[1].time_s == pytest.approx(10.0)
    # same node name -> same worker set (repeated-node failures, Fig 13)
    assert ev[0].workers == ev[2].workers
    assert len(ev[0].workers) == 4
    assert inj.mtbf_s == pytest.approx(10.0)


def test_synth_tsubame_log_statistics():
    log = synth_tsubame_log(n_nodes=64, n_events=200, mtbf_target_s=2308.0)
    times = [t for t, _ in log]
    gaps = np.diff(times)
    assert np.mean(gaps) == pytest.approx(2308.0, rel=1e-6)
    # heavy-tailed node counts: the most frequent node fails many times
    counts = Counter(n for _, n in log)
    assert counts.most_common(1)[0][1] >= 5
    # bursty: some gaps far below the mean
    assert (gaps < 0.1 * 2308).mean() > 0.1


# ------------------------------------------------- the port against repro

@pytest.mark.parametrize("mtbf,shape,seed,horizon,n", [
    (10.0, 0.7, 1, 100.0, 8), (4.0, 0.7, 5, 12.0, 8),
    (2000.0, 0.5, 3, 1e5, 64), (500.0, 1.0, 11, 3e4, 16)])
def test_weibull_schedules_equal_the_reference(mtbf, shape, seed, horizon,
                                               n):
    ours = WeibullInjector(mtbf, shape=shape, seed=seed)
    theirs = ref_failure_sim.WeibullInjector(mtbf, shape=shape, seed=seed)
    assert ours.scale == theirs.scale
    assert events(ours.schedule(horizon, range(n))) == \
        events(theirs.schedule(horizon, range(n)))
    # the generators stay in step after the schedule
    assert [ours.draw_interval() for _ in range(50)] == \
        [theirs.draw_interval() for _ in range(50)]
    a = ours.next_failure(3.0, range(n))
    b = theirs.next_failure(3.0, range(n))
    assert (a.time_s, a.workers) == (b.time_s, b.workers)


@pytest.mark.parametrize("kw", [
    dict(n_nodes=64, n_events=200, mtbf_target_s=2308.0),
    dict(n_nodes=256, n_events=400, mtbf_target_s=2308.0, seed=13),
    dict(n_nodes=16, n_events=30, mtbf_target_s=100.0, burstiness=0.6,
         seed=2)])
def test_tsubame_log_and_log_replay_equal_the_reference(kw):
    log = synth_tsubame_log(**kw)
    assert log == ref_failure_sim.synth_tsubame_log(**kw)
    for wpn, n_workers, scale in ((2, 4, 1.0), (4, 32, 0.01)):
        ours = LogReplayInjector(log, wpn, n_workers, time_scale=scale)
        theirs = ref_failure_sim.LogReplayInjector(log, wpn, n_workers,
                                                   time_scale=scale)
        assert ours.mtbf_s == theirs.mtbf_s
        assert events(ours.schedule(1e7)) == events(theirs.schedule(1e7))


def test_pair_mtti_equals_the_reference():
    assert failure_sim.empirical_pair_mtti(500.0, 16, seed=4, trials=50) \
        == ref_failure_sim.empirical_pair_mtti(500.0, 16, seed=4, trials=50)


def test_injector_classes_drain_like_the_reference():
    """The Weibull and log-replay injectors, prepared on the same horizon
    and workers, drain the same events at the same polls."""
    log = synth_tsubame_log(n_nodes=32, n_events=40, mtbf_target_s=10.0)
    pairs = [(WeibullFailureInjector(4.0, seed=2),
              RefWeibullFailureInjector(4.0, seed=2)),
             (LogReplayFailureInjector(log, 2, 8, time_scale=0.5),
              RefLogReplay(log, 2, 8, time_scale=0.5))]
    for ours, theirs in pairs:
        for inj in (ours, theirs):
            inj.prepare(60.0, list(range(8)))
        for step in range(30):
            assert events(ours.poll(step, 2.0 * step)) == \
                events(theirs.poll(step, 2.0 * step))


def test_one_failure_event_class():
    """``FailureEvent`` exists once in the port; the injector module
    re-exports it."""
    assert injector_lib.FailureEvent is FailureEvent
    assert FailureEvent(1.0, (0,)).node is None


# ---------------------- tests/test_ft_session.py's injector tests, on the port

class CounterWorkload:
    """Deterministic tensor state; step t is a pure function of (state, t),
    so failure-free and failover runs must agree bit for bit."""

    disk_checkpointable = False

    def init_state(self):
        return {"x": torch.tensor(1.0, dtype=torch.float64),
                "hist": torch.zeros(4, dtype=torch.float64)}

    def step(self, state, t):
        x = state["x"] * 1.0000001 + math.sin(0.1 * t)
        hist = torch.roll(state["hist"], 1)
        hist[0] = x
        return {"x": x, "hist": hist}, float(x)


def test_step_kill_injector_fires_once():
    inj = StepKillInjector({3: [1, 2]})
    assert inj.poll(2, 2.0) == []
    evs = inj.poll(3, 3.0)
    assert len(evs) == 1 and evs[0].workers == (1, 2)
    assert inj.poll(3, 3.0) == []                 # drained


def test_timed_injector_drains_by_time():
    inj = TimedEventInjector([FailureEvent(5.0, (1,)),
                              FailureEvent(2.0, (0,))])
    assert [e.workers for e in inj.poll(0, 2.5)] == [(0,)]
    assert [e.workers for e in inj.poll(1, 9.0)] == [(1,)]
    assert inj.poll(2, 99.0) == []


def test_as_injector_dispatch():
    assert isinstance(as_injector(None), NoFailures)
    assert isinstance(as_injector({1: [0]}), StepKillInjector)
    assert isinstance(as_injector([FailureEvent(1.0, (0,))]),
                      TimedEventInjector)
    inj = WeibullFailureInjector(mtbf_s=10.0, seed=3)
    assert as_injector(inj) is inj
    with pytest.raises(TypeError):
        as_injector([1, 2, 3])


def test_weibull_injector_prepare_then_poll():
    inj = WeibullFailureInjector(mtbf_s=5.0, seed=1)
    assert inj.poll(0, 1e9) == []                 # not prepared: no events
    inj.prepare(100.0, list(range(8)))
    evs = inj.poll(0, 100.0)
    assert len(evs) > 5                           # ~20 expected at mtbf 5
    assert all(0 <= e.workers[0] < 8 for e in evs)


def test_weibull_injector_through_session():
    clean = FTSession(ft=FTConfig(mode="none"), n_logical_workers=8,
                      workers_per_node=4).run(CounterWorkload(), STEPS)
    session = FTSession(ft=FTConfig(mode="replication"),
                        injector=WeibullFailureInjector(mtbf_s=4.0, seed=2),
                        n_logical_workers=8)
    rep = session.run(CounterWorkload(), STEPS)
    assert rep.failures > 0
    for key in ("x", "hist"):
        assert torch.equal(rep.final_state[key], clean.final_state[key])


# ------------------------------------------------------------ app workloads

def _hpcg(pkg_cls=HPCG, **kw):
    app = pkg_cls(n_ranks=2, nx=6, ny=6, nz=4, **kw)
    return (SimAppWorkload if pkg_cls is HPCG else RefSimAppWorkload)(app)


def test_simapp_hpcg_runs():
    w = _hpcg(device="cpu")
    state = w.init_state()
    for t in range(4):
        state, _ = w.step(state, t)
    assert state[0]["iters"] == 4


def test_simapp_hpcg_ft_theorem():
    w = _hpcg(device="cpu")
    clean = FTSession(ft=FTConfig(mode="none"),
                      n_logical_workers=2).run(w, 8)
    session = FTSession(ft=FTConfig(mode="replication"),
                        injector={3: [0]}, n_logical_workers=2)
    faulty = session.run(_hpcg(device="cpu"), 8)
    assert faulty.promotions == 1
    assert w.check(faulty.final_state) == w.check(clean.final_state)
    for r in range(2):
        for key in ("x", "r", "p", "rr"):
            assert torch.equal(faulty.final_state[r][key],
                               clean.final_state[r][key])


def _pic_workload(device="cpu"):
    return SimAppWorkload(PIC(n_ranks=3, cells_per_rank=8,
                              particles_per_rank=24, device=device))


def test_simapp_pic_ft_theorem():
    w = _pic_workload()
    clean = FTSession(ft=FTConfig(mode="none"), n_logical_workers=3).run(w, 6)
    faulty = FTSession(ft=FTConfig(mode="replication"), injector={2: [1]},
                       n_logical_workers=3).run(_pic_workload(), 6)
    assert faulty.promotions == 1
    assert w.check(faulty.final_state) == w.check(clean.final_state)
    for r in range(3):
        for key in ("pos", "vel"):
            assert torch.equal(faulty.final_state[r][key],
                               clean.final_state[r][key])


@pytest.mark.parametrize("which", ["hpcg", "pic"])
def test_simapp_equals_the_runtime_and_the_reference(which):
    """The sequential resolver's states: bitwise the simulated runtime's
    failure-free run of the same app, and within RTOL of the reference's
    ``SimAppWorkload`` over its numpy app."""
    if which == "hpcg":
        make = lambda cls, **kw: cls(n_ranks=3, nx=6, ny=6, nz=4, **kw)
        ours_app, theirs_app = make(HPCG, device="cpu"), make(RefHPCG)
    else:
        make = lambda cls, **kw: cls(n_ranks=3, cells_per_rank=8,
                                     particles_per_rank=24, **kw)
        ours_app, theirs_app = make(PIC, device="cpu"), make(RefPIC)
    steps = 6
    ours, theirs = SimAppWorkload(ours_app), RefSimAppWorkload(theirs_app)
    s_ours, s_theirs = ours.init_state(), theirs.init_state()
    for t in range(steps):
        s_ours, _ = ours.step(s_ours, t)
        s_theirs, _ = theirs.step(s_theirs, t)
    rt = SimRuntime(ours_app, FTConfig(mode="none"),
                    costs=CostModel(step_time_s=1.0), workers_per_node=2)
    res = rt.run(steps)
    for r in range(3):
        for key, want in s_theirs[r].items():
            got = s_ours[r][key]
            if isinstance(got, torch.Tensor):
                assert torch.equal(got, res.states[r][key])
                w = np.asarray(want)
                np.testing.assert_allclose(
                    got.numpy(), w, rtol=0,
                    atol=RTOL * float(np.abs(w).max()))
            else:
                assert got == res.states[r][key] == want
