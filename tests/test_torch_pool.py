"""The port's elastic task pool against the JAX package's, on the CPU.

Ported from ``tests/test_pool.py``: every test there runs here with the
same tasks and failure schedules through both pools (``repro.pool`` and
``repro_torch.pool`` with ``device="cpu"``), keeps the reference test's own
assertions on the port, and holds the two runs equal (``assert_same``):

* ``pool_stats``, the report's counters (failures, promotions, restarts,
  checkpoint writes, rolled-back steps) and its event stream: exactly;
* the ``TimeBreakdown``: virtual time does not depend on the values the
  tasks compute, so every component is equal exactly, but for the
  checkpoint write and restore times of a run that checkpoints.  The
  pool's checkpoint pickles its sender logs' messages, whose class the
  port names ``repro_torch.core.message_log`` where the reference names
  ``repro.core.message_log``: six bytes more a checkpoint, priced at the
  store's bandwidth (12.5 GB/s unpriced, the fat tree's links priced), so
  those two components may differ by at most 1e-9 s an operation;
* the ``recorded_schedule``: exactly;
* each task's value: ``mc_pi`` exactly (the same darts from the task's
  generator, the same comparisons), ``train_surrogate``'s loss within a
  relative 1e-15 (theta is the same float64 arithmetic step for step; the
  final dot product sums eight positive squares in another order, which
  rounds by at most 7 * 2**-53 relative), its ``lr`` and ``width``
  exactly.
"""
import numpy as np
import pytest
import torch

from repro import pool as ref_pool
from repro.analyze import verify_schedule as ref_verify_schedule
from repro.ft.injector import StepKillInjector as RefStepKillInjector
from repro_torch import pool as port_pool
from repro_torch.analyze import verify_schedule
from repro_torch.analyze.tags import band_owner, reserved_tags
from repro_torch.comm.recovery import RecoveryManager
from repro_torch.ft.injector import StepKillInjector
from repro_torch.pool import (TAG_POOL_STATUS, TAG_POOL_TASK, Task,
                              execute_task, hyperparameter_sweep_tasks,
                              make_policy, monte_carlo_tasks, run_pool,
                              task_seed)

W = 4                                     # worker ranks; master = rank W
STEPS = 40
LOSS_RTOL = 1e-15                         # module docstring
CKPT_S_PER_OP = 1e-9                      # module docstring


def sweep(pkg=port_pool):
    return pkg.hyperparameter_sweep_tasks()


def mc(pkg=port_pool):
    return pkg.monte_carlo_tasks()


def assert_values_equal(ours, theirs):
    """Result tables (task id -> value) equal: mc_pi exactly,
    train_surrogate's loss within LOSS_RTOL."""
    assert sorted(ours) == sorted(theirs)
    for tid, want in theirs.items():
        got = ours[tid]
        assert sorted(got) == sorted(want), tid
        for key, w in want.items():
            assert type(got[key]) is type(w), (tid, key)
            if key == "loss":
                assert got[key] == pytest.approx(w, rel=LOSS_RTOL, abs=0)
            else:
                assert got[key] == w, (tid, key)


def _events(rep):
    return [(e.step, e.kind, e.detail) for e in rep.events]


def assert_same(ours, theirs, *, schedule=False):
    """The port's run equals the reference's (module docstring)."""
    (rep, pool), (ref_rep, ref_pool_) = ours, theirs
    assert pool.pool_stats(rep.final_state) == \
        ref_pool_.pool_stats(ref_rep.final_state)
    for key in ("steps", "failures", "promotions", "restarts",
                "ckpt_writes", "rolled_back_steps"):
        assert getattr(rep, key) == getattr(ref_rep, key), key
    assert _events(rep) == _events(ref_rep)
    got, want = rep.time.as_dict(), ref_rep.time.as_dict()
    ckpt = ("ckpt_write", "restore", "total")
    assert {k: v for k, v in got.items() if k not in ckpt} == \
        {k: v for k, v in want.items() if k not in ckpt}
    ops = rep.ckpt_writes + rep.restarts
    for key in ckpt:
        assert abs(got[key] - want[key]) <= 2 * CKPT_S_PER_OP * ops, key
    if not ops:
        assert got == want
    assert_values_equal(rep.final_state["ms"]["results"],
                        ref_rep.final_state["ms"]["results"])
    if schedule:
        assert pool.recorded_schedule() == ref_pool_.recorded_schedule()


def run_both(tasks=sweep, kills=None, **kw):
    """The same tasks and kill schedule through both pools; the port's
    (report, pool) after ``assert_same``."""
    ours = run_pool(tasks(port_pool), device="cpu",
                    injector=StepKillInjector(kills) if kills else None,
                    **kw)
    theirs = ref_pool.run_pool(
        tasks(ref_pool),
        injector=RefStepKillInjector(kills) if kills else None, **kw)
    assert_same(ours, theirs, schedule=kw.get("record_schedule", False))
    return ours


@pytest.fixture(scope="module")
def baseline():
    """Failure-free replication run: the result table every FT run must
    reproduce."""
    rep, pool = run_both(mode="replication", n_workers=W, n_steps=STEPS)
    return rep, pool, rep.final_state["ms"]["results"]


# ---------------------------------------------------------------- vocabulary

def test_task_seed_deterministic_and_distinct():
    assert task_seed(7, 3) == task_seed(7, 3)
    seeds = [task_seed(0, i) for i in range(32)]
    assert len(set(seeds)) == 32
    assert seeds == [ref_pool.task_seed(0, i) for i in range(32)]


def test_task_roundtrip_and_execute_bitwise():
    t = sweep()[5]
    td = t.as_dict()
    assert Task.from_dict(td) == t
    a, b = execute_task(td, "cpu"), execute_task(dict(td), "cpu")
    assert a == b                          # same dict -> same bits
    assert td == sweep(ref_pool)[5].as_dict()
    assert_values_equal({"t": a}, {"t": ref_pool.execute_task(td)})


def test_policies_deterministic():
    tasks = monte_carlo_tasks()
    fifo = make_policy("fifo").order(tasks)
    assert fifo == list(tasks)
    lpt = make_policy("lpt").order(tasks)
    costs = [t.cost_rounds for t in lpt]
    assert costs == sorted(costs, reverse=True)
    assert make_policy("lpt").order(tasks) == lpt     # stable tie-breaks
    with pytest.raises(ValueError):
        make_policy("sjf")
    ref = ref_pool.make_policy("lpt").order(ref_pool.monte_carlo_tasks())
    assert [t.as_dict() for t in lpt] == [t.as_dict() for t in ref]


def test_pool_band_registered():
    assert band_owner(TAG_POOL_TASK) == "repro_torch.pool.master"
    assert band_owner(TAG_POOL_STATUS) == "repro_torch.pool.master"
    tags = reserved_tags()
    assert tags[TAG_POOL_TASK].endswith("TAG_POOL_TASK")
    assert tags[TAG_POOL_STATUS].endswith("TAG_POOL_STATUS")
    assert (TAG_POOL_TASK, TAG_POOL_STATUS) == \
        (ref_pool.TAG_POOL_TASK, ref_pool.TAG_POOL_STATUS)


# ---------------------------------------------------- failure-free behavior

def test_failure_free_completes_all(baseline):
    rep, pool, results = baseline
    stats = pool.pool_stats(rep.final_state)
    assert stats["completed"] == len(sweep())
    assert stats["reassigned"] == 0 and stats["duplicates"] == 0
    assert rep.restarts == 0 and rep.promotions == 0
    assert sorted(results) == sorted(t.task_id for t in sweep())


def test_master_rank_unreplicated(baseline):
    rep, pool, _ = baseline
    # replicas cover exactly the worker ranks; the master is pinned last
    assert pool.master_rank == W
    assert pool.session.rmap.rep[W] is None
    assert len(pool.session.rmap.replicated_ranks()) == W


def test_redundant_is_explicit_ledger_component(baseline):
    rep, _, _ = baseline
    # full replication of 4-of-5 ranks for 40 steps at 1 s/step
    assert rep.time.redundant == pytest.approx(STEPS * W / (W + 1))
    assert rep.time.useful == pytest.approx(STEPS)
    dist = rep.obs_metrics["time_distribution"] if rep.obs_metrics else None
    assert dist is None                    # baseline runs without obs


# ------------------------------------------------- forward recovery (kills)

def test_worker_kill_mid_task_promotes_bitwise(baseline):
    _, _, ref = baseline
    rep, pool = run_both(mode="replication", n_workers=W, n_steps=STEPS,
                         kills={3: [1]})
    stats = pool.pool_stats(rep.final_state)
    assert rep.promotions == 1
    assert rep.restarts == 0 and rep.rolled_back_steps == 0
    assert rep.restore_s == 0.0
    assert stats["replica_covered"] == 1   # the task was in flight
    assert rep.final_state["ms"]["results"] == ref


def test_node_kill_pair_death_restarts_bitwise(baseline):
    _, _, ref = baseline
    # cmp of rank 2 is wid 2; its replica is wid (W+1)+2 = 7
    rep, pool = run_both(mode="combined", n_workers=W, n_steps=STEPS,
                         ckpt_interval_s=5.0, kills={6: [2, 7]})
    assert rep.restarts == 1
    assert rep.final_state["ms"]["results"] == ref


def test_unreplicated_worker_kill_retires_rank_bitwise(baseline):
    _, _, ref = baseline
    # degree 0.5 replicates ranks 0..1; rank 3's cmp (wid 3) is bare
    rep, pool = run_both(mode="replication", n_workers=W, n_steps=STEPS,
                         replication_degree=0.5, kills={3: [3]})
    stats = pool.pool_stats(rep.final_state)
    assert rep.restarts == 0 and rep.rolled_back_steps == 0
    assert stats["retired_ranks"] == [3]
    assert stats["reassigned"] == 1
    assert stats["completed"] == len(sweep())
    assert rep.final_state["ms"]["results"] == ref
    ev = [e for e in rep.events if e.kind == "retire_rank"]
    assert len(ev) == 1 and ev[0].detail["rank"] == 3


def test_checkpoint_mode_same_kill_restores_and_replays(baseline):
    _, _, ref = baseline
    rep, pool = run_both(mode="checkpoint", n_workers=W, n_steps=STEPS,
                         ckpt_interval_s=5.0, kills={7: [1]})
    assert rep.restarts == 1               # no replica: restore + replay
    assert rep.rolled_back_steps > 0
    assert rep.final_state["ms"]["results"] == ref


def test_master_kill_restores_bitwise(baseline):
    _, _, ref = baseline
    rep, pool = run_both(mode="combined", n_workers=W, n_steps=STEPS,
                         ckpt_interval_s=5.0, kills={9: [W]})
    assert rep.restarts == 1
    assert rep.final_state["ms"]["results"] == ref


@pytest.mark.parametrize("mode,kills", [
    ("replication", {2: [0], 5: [6], 9: [3]}),
    ("combined", {2: [1], 6: [2, 7], 11: [0]}),
    ("checkpoint", {4: [2], 13: [W]}),
])
@pytest.mark.parametrize("topology", [None, "fattree"])
def test_bitwise_across_strategies_and_topologies(baseline, mode, kills,
                                                  topology):
    _, _, ref = baseline
    rep, pool = run_both(mode=mode, n_workers=W, n_steps=STEPS,
                         ckpt_interval_s=5.0, topology=topology,
                         kills=kills)
    assert rep.final_state["ms"]["results"] == ref
    if mode != "checkpoint":
        assert rep.rolled_back_steps == 0 or rep.restarts > 0


# --------------------------------------------------------- priced transport

def test_pool_traffic_priced_through_topology():
    rep, pool = run_both(mode="replication", n_workers=W, n_steps=STEPS,
                         topology="fattree")
    assert pool.transport.cost_model is not None
    assert rep.time.comm > 0.0


def test_promotion_repair_measured_not_flat():
    # kill at step 1: step-0 directives are still in flight, so the
    # promoted replica's repair replays >= 1 priced message — the session
    # books the measured drain/replay traffic, not the planner's 5 ms
    rep, _ = run_both(mode="replication", n_workers=W, n_steps=STEPS,
                      topology="fattree", kills={1: [0]})
    assert rep.promotions == 1
    assert 0.0 < rep.time.repair < 0.005


def test_priced_replay_through_recovery_manager():
    rep, pool = run_both(mode="replication", n_workers=W, n_steps=4,
                         topology="fattree")
    man = RecoveryManager(pool.transport, price_replay=True)
    assert man.price_replay and man.replays == 0


# ------------------------------------------------------- schedule property

def test_recorded_schedule_verifies_clean():
    rep, pool = run_both(mode="replication", n_workers=W, n_steps=20,
                         kills={1: [0]}, record_schedule=True)
    sched = pool.recorded_schedule()
    findings = verify_schedule(sched, n=W + 1, label="pool",
                               infra_owners=("repro_torch.pool.master",))
    assert findings == []
    # negative control: without the exemption the reserved band is caught
    flagged = verify_schedule(sched, n=W + 1, label="pool")
    assert any(f.rule == "tag-reserved" for f in flagged)
    ref_flagged = ref_verify_schedule(sched, n=W + 1, label="pool")
    assert [(f.rule, f.line) for f in flagged] == \
        [(f.rule, f.line) for f in ref_flagged]


def test_recorded_schedule_verifies_clean_after_restore():
    rep, pool = run_both(mode="checkpoint", n_workers=W, n_steps=20,
                         ckpt_interval_s=5.0, kills={7: [1]},
                         record_schedule=True)
    assert rep.restarts == 1
    findings = verify_schedule(pool.recorded_schedule(), n=W + 1,
                               label="pool-ckpt",
                               infra_owners=("repro_torch.pool.master",))
    assert findings == []


# ------------------------------------------------------------- work stealing

def test_speculation_is_idempotent():
    plain, p0 = run_both(mc, mode="none", n_workers=3, n_steps=STEPS,
                         policy="fifo")
    spec, p1 = run_both(mc, mode="none", n_workers=3, n_steps=STEPS,
                        policy="fifo", speculate=True)
    s = p1.pool_stats(spec.final_state)
    assert s["speculated"] >= 1
    assert s["duplicates"] >= 1            # late copies counted, not applied
    assert s["completed"] == len(mc())
    assert spec.final_state["ms"]["results"] == \
        plain.final_state["ms"]["results"]


# ------------------------------------------------------------- observability

def test_pool_obs_metrics_and_spans():
    ours = run_pool(sweep(), mode="replication", n_workers=W,
                    n_steps=STEPS, obs=True, device="cpu",
                    injector=StepKillInjector({3: [1]}))
    theirs = ref_pool.run_pool(sweep(ref_pool), mode="replication",
                               n_workers=W, n_steps=STEPS, obs=True,
                               injector=RefStepKillInjector({3: [1]}))
    assert_same(ours, theirs)
    rep, _ = ours
    m = rep.obs_metrics
    c = m["counters"]
    assert c["pool.tasks.dispatched"] == len(sweep())
    assert c["pool.tasks.completed_total"] == len(sweep())
    assert c["pool.tasks.replica_covered"] == 1
    assert m["gauges"]["pool.tasks.completed"] == len(sweep())
    assert 0.0 < m["gauges"]["pool.occupancy"] <= 1.0
    assert m["histograms"]["pool.task_latency_rounds"]["count"] == \
        len(sweep())
    # task-lifecycle spans + pool traffic on the "pool" band short name
    spans = [s for s in rep.obs.tracer.spans if s.cat == "pool.task"]
    assert len(spans) == len(sweep())
    assert c["comm.msgs.pool.cmp"] > 0
    # explicit redundant charge flows into the Fig 9 distribution once
    dist = m["time_distribution"]
    assert dist["redundant"] == pytest.approx(
        100.0 * rep.time.redundant / rep.time.total)
    # the whole snapshot is the reference's (no checkpoint in this run)
    ref_m = theirs[0].obs_metrics
    for key in ("counters", "gauges", "histograms", "world",
                "time_distribution"):
        assert m[key] == ref_m[key], key


# ------------------------------------------------------- the port's programs

@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_mc_pi_hits_equal_the_reference(seed):
    """16,000 darts (Fig 16's largest task) from the task's generator:
    the hit count, so the estimate, equals the reference's exactly."""
    td = {"task_id": "x", "program": "mc_pi", "seed": seed,
          "payload": {"n_samples": 16_000}, "cost_rounds": 1}
    got = execute_task(td, "cpu")
    want = ref_pool.execute_task(td)
    assert got == want
    assert type(got["pi"]) is float and type(got["n_samples"]) is int


@pytest.mark.parametrize("lr,width,steps", [
    (1e-3, 32, 50), (3e-2, 128, 50), (1e-2, 64, 1), (1e-2, 64, 0)])
def test_train_surrogate_within_tolerance(lr, width, steps):
    td = {"task_id": "x", "program": "train_surrogate", "seed": 99,
          "payload": {"lr": lr, "width": width, "steps": steps},
          "cost_rounds": 1}
    got = execute_task(td, "cpu")
    assert_values_equal({"x": got}, {"x": ref_pool.execute_task(td)})
    assert all(not isinstance(v, torch.Tensor) for v in got.values())


def test_pool_needs_the_card_unless_told(monkeypatch):
    """Without ``device`` the pool runs on the card, and raises where
    there is none; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_pool(sweep(), mode="none", n_workers=2, n_steps=2)


def test_demo_cli_prints_the_reference_ledger(capsys):
    from repro.pool.demo import main as ref_main
    from repro_torch.pool.demo import main
    argv = ["--mode", "combined", "--mtbf", "20", "--steps", "30",
            "--topology", "fattree", "--speculate"]
    assert main(argv + ["--device", "cpu"]) == 0
    ours = capsys.readouterr().out.splitlines()
    assert ref_main(argv) == 0
    theirs = capsys.readouterr().out.splitlines()
    assert ours[0] == theirs[0] + " device=cpu"
    assert ours[1:] == theirs[1:]


def test_snapshot_values_are_plain_python(baseline):
    """The result table and a checkpoint of the pool hold Python floats
    and ints, as the reference's do: no tensor reaches the store."""
    rep, pool, results = baseline
    snap = pool.snapshot(rep.final_state)
    for value in results.values():
        assert all(type(v) in (float, int) for v in value.values())

    def leaves(x):
        if isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                yield from leaves(v)
        else:
            yield x

    assert not any(isinstance(x, (torch.Tensor, np.ndarray))
                   for x in leaves(snap))
