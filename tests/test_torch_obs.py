"""The port's observability layer against the JAX package's.

``repro_torch.obs`` (tracer, metrics, links, exporters, recorder) and
``repro_torch.analyze.tags`` are copies of their ``repro`` counterparts,
wired through the same seams: the clock's charge hook, the transport's
observer list and per-link accumulator, the collective engine's post hook,
``FTSession``'s failure/recovery/checkpoint/step arcs, and the serving
fan-out. Each test drives both packages on the same inputs and compares
the metrics snapshots and Chrome traces exactly, except for the wall-clock
fields (``args.wall_ms``): the virtual times are the same arithmetic in
the same order, the counters integer or float sums in the same order.

Ported from ``tests/test_obs.py``: every test but the ``no-print`` lint
tests, which wait for the lint pass (ROADMAP.md, Queue 1 item 9b);
``test_fig9_uses_the_shared_accounting`` runs in
``tests/test_torch_fig_digests.py``, which binds ``repro`` to the port.
The ``killed_run`` tests drive the port's ``obs.demo.traced_hpcg_run``
(HPCG on the simulated runtime, on the CPU): its snapshot and Chrome trace
equal the reference's except where the in-memory store's bytes enter.
The port pickles a rank's checkpoint with HPCG's ``rr`` a 0-d array (the
reference's is a numpy scalar) and its sender log's messages under the
port's module path, so the store's bands are longer (``STORE_BYTES``);
without a topology nothing else moves, and under fattree pricing the
measured checkpoint cost C moves with them, shifting every later span by
at most the ``ckpt_write`` gap.
"""
import json

import numpy as np
import pytest
import torch

from repro.analyze import tags as ref_tags
from repro.clock import VirtualClock as RefClock
from repro.clock import pricing_from_ft as ref_pricing_from_ft
from repro.configs.base import FTConfig as RefFTConfig
from repro.obs.demo import traced_hpcg_run as ref_traced_hpcg_run
from repro.core.coordinator import ClusterTopology as RefClusterTopology
from repro.ft import FTSession as RefFTSession
from repro.obs import LinkUsage as RefLinkUsage
from repro.obs import chrome_trace as ref_chrome_trace
from repro.obs import text_flamegraph as ref_text_flamegraph
from repro.obs import time_distribution as ref_time_distribution
from repro_torch.analyze import tags
from repro_torch.clock import VirtualClock, pricing_from_ft
from repro_torch.comm import ReplicaTransport
from repro_torch.configs.base import FTConfig
from repro_torch.core.coordinator import ClusterTopology
from repro_torch.core.failure_sim import FailureEvent
from repro_torch.core.replica_map import ReplicaMap
from repro_torch.ft import FTSession
from repro_torch.launch.serve import ReplicatedServer
from repro_torch.obs import (RUNTIME_TID, Histogram, LinkUsage,
                             MetricsRegistry, ObsRecorder, SpanTracer,
                             chrome_trace, text_flamegraph,
                             time_distribution, write_chrome_trace)
from repro_torch.obs.demo import traced_hpcg_run
from repro_torch.simrt import SimRuntime

# bands the sender logs record (store pushes are sent with log=False)
LOGGED_BANDS = ("app", "coll", "topo", "reserved")
# the snapshot entries the store's band bytes enter (module docstring)
STORE_BYTES = {"counters": ("comm.bytes.store.cmp", "comm.bytes.store.rep"),
               "gauges": ("store.committed_bytes",)}


def _port_name(owner):
    return owner.replace("repro.", "repro_torch.", 1)


def strip_wall(trace):
    """A Chrome trace (after a JSON round trip) without its wall-clock
    annotations; an event whose only argument was the wall time loses
    its ``args``."""
    data = json.loads(json.dumps(trace))
    for ev in data["traceEvents"]:
        args = ev.get("args")
        if args is not None and "wall_ms" in args:
            del args["wall_ms"]
            if not args:
                del ev["args"]
    return data


def assert_nested_and_closed(tracer):
    assert tracer.open_spans() == []
    for s in tracer.spans:
        assert s.instant or s.dur is not None
        if s.parent >= 0:
            parent = tracer.spans[s.parent]
            assert parent.tid == s.tid
            assert s.ts >= parent.ts - 1e-9
            if s.dur is not None and parent.dur is not None:
                assert s.ts + s.dur <= parent.ts + parent.dur + 1e-9


# ----------------------------------------------------------------- tags

def test_tag_bands_equal_the_reference():
    """The band table (the pool's band included) and the registered tags
    equal the reference's, owners under the port's module names; the
    pool's tags join when the pool is ported."""
    assert tags.RESERVED_BANDS == tuple(
        (_port_name(o), lo, hi) for o, lo, hi in ref_tags.RESERVED_BANDS)
    for tag in range(-50, 6):
        want = ref_tags.band_owner(tag)
        assert tags.band_owner(tag) == (want and _port_name(want))
    want = {t: _port_name(name) for t, name in ref_tags.reserved_tags().items()
            if not name.startswith("repro.pool.")}
    assert tags.reserved_tags() == want
    assert len(want) == 20


# --------------------------------------------------------------- metrics

def test_metrics_registry_basics():
    m = MetricsRegistry()
    m.inc("a.b")
    m.inc("a.b", 2)
    m.set_gauge("g", 7.5)
    m.observe("h", 0.5)
    m.observe("h", 3.0)
    assert m.get("a.b") == 3 and m.get("g") == 7.5
    assert m.get("missing", -1) == -1
    snap = m.snapshot()
    assert snap["counters"] == {"a.b": 3}
    assert snap["gauges"] == {"g": 7.5}
    h = snap["histograms"]["h"]
    assert h["count"] == 2 and h["sum"] == 3.5
    assert h["min"] == 0.5 and h["max"] == 3.0 and h["mean"] == 1.75
    json.loads(json.dumps(snap))


def test_histogram_power_of_two_buckets():
    h = Histogram()
    for v in (0.3, 0.6, 1.5, 3.0, 0.0):
        h.observe(v)
    d = h.as_dict()
    assert d["buckets"] == {"-1": 1, "0": 2, "1": 1, "2": 1}
    assert d["count"] == 5 and d["max"] == 3.0 and d["min"] == 0.0


def test_time_distribution_pinning():
    bk = {"useful": 80.0, "comm": 10.0, "ckpt_write": 10.0,
          "redundant": 0.0, "total": 100.0}
    assert time_distribution(bk) == ref_time_distribution(bk)
    for frac in (0.5, 0.25, 0.1):
        assert time_distribution(bk, frac) == ref_time_distribution(bk, frac)
    comp = time_distribution(bk, 0.5)
    assert comp["useful"] == 40.0 and comp["redundant"] == 40.0
    with pytest.raises(ValueError):
        time_distribution(bk, 1.0)
    with pytest.raises(ValueError):
        time_distribution(bk, -0.1)
    assert set(time_distribution({"useful": 0.0}).values()) == {0.0}


# ---------------------------------------------------------------- tracer

def test_tracer_nesting_and_finish():
    tr = SpanTracer()
    clock = VirtualClock()
    tr.clock = clock
    outer = tr.begin(RUNTIME_TID, "outer", "test")
    clock.charge("useful", 1.0)
    inner = tr.begin(RUNTIME_TID, "inner", "test")
    mark = tr.instant(RUNTIME_TID, "mark", "test", x=1)
    assert mark.parent == inner
    clock.charge("useful", 0.5)
    tr.end(RUNTIME_TID, note="done")
    assert tr.spans[inner].dur == 0.5
    assert tr.spans[inner].parent == outer
    assert tr.spans[inner].args["note"] == "done"
    assert len(tr.open_spans()) == 1
    tr.finish()
    assert tr.open_spans() == []
    assert tr.spans[outer].dur == 1.5
    with pytest.raises(RuntimeError):
        tr.end(RUNTIME_TID)


def test_tracer_complete_is_parented_and_cheap():
    tr = SpanTracer()
    outer = tr.begin(3, "outer")
    tr.complete(3, "step", "compute", 2.0, 1.0, {"step": 2})
    tr.end(3)
    (step,) = tr.find("step")
    assert step.parent == outer and step.ts == 2.0 and step.dur == 1.0
    assert step.wall_ts == 0.0 and step.wall_dur == 0.0


def test_clock_charge_label_without_obs():
    clock = VirtualClock()
    clock.charge("ckpt_write", 1.0, label="MemBackend")
    assert clock.breakdown.ckpt_write == 1.0
    assert clock.obs is None


def test_clock_mirrors_charges_to_the_recorder():
    """Every charge reaches ``on_charge`` with its label, as the
    reference's clock hands it on."""
    snaps = []
    for clock_cls in (VirtualClock, RefClock):
        obs = ObsRecorder()
        clock = clock_cls()
        obs.bind_clock(clock)
        assert clock.obs is obs
        clock.charge("useful", 1.0)
        clock.charge("repair", 0.25, advance=False, label="promote")
        clock.charge("restore", 0.5, advance=False, label="MemBackend")
        snaps.append(obs.snapshot())
    assert snaps[0] == snaps[1]
    c = snaps[0]["counters"]
    assert c["time.repair_s.promote"] == c["time.repair_s"] == 0.25
    assert snaps[0]["histograms"]["recovery.latency_s"]["count"] == 2


# ------------------------------------------------ transport observer list

class _Probe:
    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def on_send(self, *args):
        self.calls.append(self.name)


def test_observer_list_ordering():
    """Observers run in list order, ``first=True`` prepends, re-adding is
    a no-op; each sees every logical send once, the replica's included."""
    calls = []
    rmap = ReplicaMap(2, 1)
    t = ReplicaTransport(rmap, 2)
    eps = {w: t.register(w) for w in rmap.alive()}
    a, b = _Probe("a", calls), _Probe("b", calls)
    t.add_observer(a)
    t.add_observer(b, first=True)
    t.add_observer(a)
    assert t.observers == [b, a]
    t.send(eps[rmap.cmp[0]], 1, 0, np.arange(3.0), 0, log=True)
    t.send(eps[rmap.rep[0]], 1, 0, np.arange(3.0), 0, log=False)
    assert calls == ["b", "a", "b", "a"]


def test_recorder_counts_tensor_sends_like_arrays():
    """A tensor payload counts the bytes of the ndarray with its values,
    per tag band and role."""
    snaps = []
    for payload in (np.arange(12, dtype=np.float32),
                    torch.arange(12, dtype=torch.float32)):
        obs = ObsRecorder()
        rmap = ReplicaMap(3, 3)
        t = ReplicaTransport(rmap, 3)
        eps = {w: t.register(w) for w in rmap.alive()}
        t.add_observer(obs)
        for tag in (0, -11, -21, -33, -42, -99):
            t.send(eps[rmap.cmp[0]], 1, tag, payload, 0, log=True)
            t.send(eps[rmap.rep[0]], 1, tag, payload, 0, log=True)
        snaps.append(obs.snapshot())
    assert snaps[0] == snaps[1]
    c = snaps[0]["counters"]
    for band in ("app", "coll", "store", "topo", "pool", "reserved"):
        assert c[f"comm.bytes.{band}.cmp"] == c[f"comm.bytes.{band}.rep"] \
            == 48


@pytest.mark.parametrize("topology", ["fattree", "dragonfly", "torus3d"])
def test_link_usage_equals_the_reference(topology):
    """The heat table of the same messages over the same priced graph:
    bytes, busy seconds, message counts and per-label attribution."""
    tables = []
    for pricing, ft_cls, cluster_cls, usage_cls in (
            (pricing_from_ft, FTConfig, ClusterTopology, LinkUsage),
            (ref_pricing_from_ft, RefFTConfig, RefClusterTopology,
             RefLinkUsage)):
        cm = pricing(ft_cls(topology=topology), cluster_cls(16, 2)).cost_model
        usage = usage_cls(cm)
        rng = np.random.default_rng(3)
        for _ in range(60):
            src, dst = (int(v) for v in rng.integers(0, 16, 2))
            tag = int(rng.choice([0, 5, -11, -21, -24, -31, -35, -43, -19]))
            usage.record(src, dst, tag if tag != -19 else None,
                         int(rng.integers(0, 1 << 16)))
        tables.append((usage.as_dict(), usage.table(top=4),
                       usage.max_contended("app")))
    assert tables[0] == tables[1]
    assert tables[0][0]["max_contended"]["busy_s"] > 0


# --------------------------------------------------------- FTSession path

class CounterWorkload:
    disk_checkpointable = False

    def init_state(self):
        return {"x": np.float64(1.0)}

    def step(self, state, t):
        x = state["x"] * 1.0000001 + np.sin(0.1 * t)
        return {"x": x}, float(x)


RUNS = {
    # test_obs.py::test_ft_session_obs_counters_and_spans
    "combined_promote": dict(mode="combined", ckpt_interval_s=4.0,
                             kills={6: [0]}, n=4, wpn=4, steps=12),
    # test_obs.py::test_recovery_latency_histogram
    "replication_latency": dict(mode="replication", kills={3: [0], 7: [1]},
                                n=4, wpn=4, steps=10),
    "combined_pair_death": dict(mode="combined", ckpt_interval_s=4.0,
                                ckpt_backend="memory", kills={4: [1], 8: [9]},
                                n=8, wpn=4, steps=12),
    "checkpoint_restart": dict(mode="checkpoint", ckpt_interval_s=3.0,
                               ckpt_backend="memory", kills={7: [2]}, n=8,
                               wpn=4, steps=12),
}


def _session_run(session_cls, ft_cls, name, topology=None, obs=True):
    spec = dict(RUNS[name])
    kills, n, wpn, steps = (spec.pop(k) for k in ("kills", "n", "wpn",
                                                   "steps"))
    session = session_cls(ft=ft_cls(topology=topology, **spec),
                          injector=dict(kills), n_logical_workers=n,
                          workers_per_node=wpn, obs=obs)
    return session, session.run(CounterWorkload(), steps)


@pytest.mark.parametrize("topology", [None, "fattree"])
@pytest.mark.parametrize("name", sorted(RUNS))
def test_session_metrics_and_trace_equal_the_reference(name, topology):
    """The whole recorder of an FTSession run — counters, gauges, the
    recovery-latency histogram, the Fig 9 time distribution, per-link heat
    when priced — and its Chrome trace, wall fields aside, as the
    reference's; spans closed and nested."""
    s_ours, ours = _session_run(FTSession, FTConfig, name, topology)
    s_theirs, theirs = _session_run(RefFTSession, RefFTConfig, name,
                                    topology)
    assert ours.obs_metrics == theirs.obs_metrics
    json.loads(json.dumps(ours.obs_metrics))
    assert strip_wall(chrome_trace(ours.obs.tracer, ours.obs_metrics)) == \
        strip_wall(ref_chrome_trace(theirs.obs.tracer, theirs.obs_metrics))
    assert text_flamegraph(ours.obs.tracer) == \
        ref_text_flamegraph(theirs.obs.tracer)
    assert_nested_and_closed(ours.obs.tracer)
    assert ours.obs is s_ours.obs and ours.failures >= 1
    assert ("links" in ours.obs_metrics) == (
        topology is not None and name != "replication_latency")


def test_ft_session_obs_counters_and_spans():
    session, rep = _session_run(FTSession, FTConfig, "combined_promote")
    assert rep.failures == 1 and rep.promotions == 1
    c = session.obs.metrics.counters
    assert c["ckpt.writes"] == rep.ckpt_writes >= 1
    assert c["failures.kills.worker"] == 1
    assert c["steps.executed"] == 12
    assert "time.ckpt_write_s.MemBackend" in c
    assert "time.repair_s.promote" in c
    tr = session.obs.tracer
    assert tr.open_spans() == []
    assert tr.find("ckpt.write") and tr.find("failure")
    (arc,) = [s for s in tr.spans if s.name == "recovery.promote"]
    assert arc.dur is not None
    assert rep.obs_metrics["counters"] == dict(sorted(c.items()))
    assert len(rep.metrics) == 12
    assert session.obs.metrics.gauges["store.gens_committed"] >= 1
    assert c["comm.msgs.store.cmp"] > 0


def test_recovery_latency_histogram():
    session, _ = _session_run(FTSession, FTConfig, "replication_latency")
    h = session.obs.metrics.histograms["recovery.latency_s"]
    assert h.count == 2 and h.max > 0


def test_restart_arcs_carry_the_restore():
    """A pair death records a restart arc holding the memory restore's
    span, which names the step it rolled back to."""
    session, rep = _session_run(FTSession, FTConfig, "combined_pair_death")
    tr = session.obs.tracer
    (arc,) = [i for i, s in enumerate(tr.spans)
              if s.name == "recovery.restart_elastic"]
    (restore,) = [s for s in tr.children_of(arc) if s.name == "ckpt.restore"]
    assert restore.args["to_step"] == 8 - rep.rolled_back_steps
    assert session.obs.metrics.gauges["store.fetches"] >= 0
    assert session.obs.metrics.gauges["store.local_reads"] > 0


def test_obs_off_wires_nothing():
    session = FTSession(ft=FTConfig(mode="combined", ckpt_interval_s=2.0,
                                    ckpt_backend="memory",
                                    topology="fattree"),
                        injector={3: [0]}, n_logical_workers=4,
                        workers_per_node=2)
    rep = session.run(CounterWorkload(), 6)
    assert session.obs is None and session.clock.obs is None
    store_transport = session.strategy.backend.store.transport
    assert store_transport.observers == []
    assert store_transport.link_usage is None
    assert rep.obs is None and rep.obs_metrics is None
    srv = ReplicatedServer("qwen3-8b", batch=2, prompt_len=16, device="cpu",
                           topology="fattree")
    assert srv.obs is None and srv.fanout.obs is None
    assert srv.fanout.transport.observers == []
    assert srv.fanout.transport.link_usage is None
    assert srv.fanout.engine.obs is None
    assert srv.session().obs is None
    rt = SimRuntime(PingApp(), FTConfig(mode="replication",
                                        replication_degree=1.0))
    assert rt.obs is None and rt.transport.observers == []
    assert rt.transport.link_usage is None
    assert rt.clock.obs is None and rt.engine.obs is None
    res = rt.run(2)
    assert res.obs is None and res.obs_metrics is None


# ---------------------------------------------------------- serving path

@pytest.mark.parametrize("topology", [None, "fattree"])
def test_served_run_with_a_recorder_equals_the_jax_servers(topology,
                                                            tmp_path):
    """The reduced qwen3-8b served with ``obs=True`` and a mid-stream kill:
    the recorder's snapshot and Chrome trace (wall fields aside) equal the
    JAX server's on the same config, batch and kill; the fan-out's band
    counters are the bytes ``BatchFanout`` logged; one promote arc; the
    trace written to disk loads as JSON; the tokens are the unobserved
    clean run's."""
    from repro.launch.serve import ReplicatedServer as JaxServer
    prompts = np.random.default_rng(7).integers(0, 400, (2, 16),
                                                dtype=np.int32)
    clean = ReplicatedServer("qwen3-8b", batch=2, prompt_len=16,
                             device="cpu").generate(prompts, 4)
    ours = ReplicatedServer("qwen3-8b", batch=2, prompt_len=16, device="cpu",
                            topology=topology, obs=True)
    toks = ours.generate(prompts, 4, kill_at=2)
    theirs = JaxServer("qwen3-8b", batch=2, prompt_len=16, topology=topology,
                       obs=True)
    theirs.generate(prompts.copy(), 4, kill_at=2)
    np.testing.assert_array_equal(toks, clean)
    snap = ours.last_report.obs_metrics
    assert snap == theirs.last_report.obs_metrics
    assert strip_wall(chrome_trace(ours.obs.tracer, snap)) == \
        strip_wall(ref_chrome_trace(theirs.obs.tracer, snap))
    c = snap["counters"]
    log = ours.fanout.transport.send_logs[ours.fanout.FRONTEND_RANK]
    assert c["comm.msgs.coll.cmp"] == log.recorded_msgs == 1
    assert c["comm.bytes.coll.cmp"] == log.recorded_bytes == 2 * 16 * 4
    assert c["collectives.posts.bcast.cmp"] == 2
    assert c["failures.kills.worker"] == 1
    tr = ours.obs.tracer
    assert_nested_and_closed(tr)
    (arc,) = [i for i, s in enumerate(tr.spans)
              if s.name == "recovery.promote"]
    assert tr.spans[arc].dur is not None
    assert ("links" in snap) == (topology is not None)
    if topology is not None:
        assert snap["links"]["max_contended"]["busy_s"] > 0
    path = tmp_path / "serve_trace.json"
    write_chrome_trace(str(path), tr, snap)
    with open(path) as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("argv,want", [
    (["--ckpt-mode", "combined", "--kill", "4:1", "--kill", "8:9"],
     ["mode=combined restarts=1", "restore_backend=memory",
      "promotions=1"]),
    (["--ckpt-mode", "checkpoint", "--kill", "7:2", "--topology",
      "fattree"], ["mode=checkpoint restarts=1", "restore_backend=memory"]),
    (["--kill-at", "3"], ["failures=1 promotions=1"])])
def test_serve_cli_checkpoint_modes(argv, want, capsys):
    """The serve CLI on the CPU: the checkpoint strategies over 8 logical
    ranks restart from partner memory."""
    from repro_torch.launch.serve import main
    assert main(["--device", "cpu", "--batch", "2", "--prompt-len", "16",
                 "--gen", "12"] + argv) == 0
    out = capsys.readouterr().out
    for text in want:
        assert text in out


# ------------------------------------------------------- simulated runtime

class PingApp:
    """Two ranks swap their state vector every step."""

    def __init__(self, n_ranks: int = 2):
        self.n_ranks = n_ranks

    def init_state(self, rank: int) -> dict:
        return {"v": torch.arange(4, dtype=torch.float64) + rank}

    def step(self, rank, state, t):
        peer = 1 - rank
        yield ("send", peer, 0, state["v"])
        got = yield ("recv", peer, 0)
        return {"v": state["v"] + got}


def test_divergence_detector_and_recorder_coexist():
    """The divergence tripwire and the recorder both see every send of a
    killed-and-replayed run, with the detector ordered first."""
    ft = FTConfig(mode="replication", replication_degree=1.0, mtbf_s=1e9)
    events = [FailureEvent(time_s=2.5, workers=(0,))]
    rt = SimRuntime(PingApp(), ft, detect_divergence=True,
                    failure_events=events, obs=True)
    assert rt.transport.observers[0] is rt.divergence
    assert rt.transport.observers[1] is rt.obs
    res = rt.run(6)
    assert res.failures == 1 and res.promotions == 1 and res.replays > 0
    assert rt.divergence.compared > 0 and rt.divergence.divergences == []
    c = rt.obs.metrics.counters
    assert c["comm.msgs.app.cmp"] > 0
    assert c["recovery.promotions"] == 1
    assert res.obs_metrics is not None


KILLED = dict(n_ranks=16, steps=8, grid=(4, 4, 2))


@pytest.fixture(scope="module")
def killed_run():
    """HPCG, combined strategy, fat-tree pricing, one node killed mid-run
    (the acceptance scenario at a test-sized scale), on the CPU."""
    return traced_hpcg_run(device="cpu", **KILLED)


@pytest.fixture(scope="module")
def ref_killed_run():
    return ref_traced_hpcg_run(**KILLED)


def _without(snapshot, skip):
    return {key: ({k: v for k, v in val.items() if k not in skip[key]}
                  if key in skip else val)
            for key, val in snapshot.items()}


def test_killed_run_unpriced_equals_the_reference():
    """Without a topology the whole snapshot and the Chrome trace, wall
    fields aside, equal the reference's; only the store's band bytes
    differ (module docstring)."""
    _rt, ours, obs_ours = traced_hpcg_run(device="cpu", topology=None,
                                          **KILLED)
    _rt, theirs, obs_theirs = ref_traced_hpcg_run(topology=None, **KILLED)
    a, b = ours.obs_metrics, theirs.obs_metrics
    assert _without(a, STORE_BYTES) == _without(b, STORE_BYTES)
    for key, names in STORE_BYTES.items():
        for name in names:
            assert a[key][name] > 0 and b[key][name] > 0
    trace_a = strip_wall(chrome_trace(obs_ours.tracer, a))
    trace_b = strip_wall(ref_chrome_trace(obs_theirs.tracer, b))
    assert trace_a["traceEvents"] == trace_b["traceEvents"]
    assert _without(trace_a["otherData"], STORE_BYTES) == \
        _without(trace_b["otherData"], STORE_BYTES)
    assert ours.time.as_dict() == theirs.time.as_dict()


def test_killed_run_equals_the_reference(killed_run, ref_killed_run):
    """Under fattree pricing: the counters but the store's bytes and the
    checkpoint seconds equal; every trace event equals the reference's but
    for its times, which move by at most the ``ckpt_write`` gap."""
    _rt, ours, obs_ours = killed_run
    _rt, theirs, obs_theirs = ref_killed_run
    a, b = ours.obs_metrics, theirs.obs_metrics
    skip = {"counters": STORE_BYTES["counters"] + ("time.ckpt_write_s",),
            "gauges": STORE_BYTES["gauges"]}
    for key in ("counters", "gauges", "histograms", "world"):
        assert _without(a, skip)[key] == _without(b, skip)[key]
    gap = abs(ours.time.ckpt_write - theirs.time.ckpt_write)
    assert 0 < gap < 1e-6          # seconds, over every checkpoint write
    got = {k: v for k, v in ours.time.as_dict().items() if k != "total"}
    want = dict(theirs.time.as_dict(), ckpt_write=ours.time.ckpt_write)
    del want["total"]
    assert got == pytest.approx(want, rel=0, abs=1e-12)
    ev_a = strip_wall(chrome_trace(obs_ours.tracer, a))["traceEvents"]
    ev_b = strip_wall(ref_chrome_trace(obs_theirs.tracer, b))["traceEvents"]
    assert len(ev_a) == len(ev_b)
    for x, y in zip(ev_a, ev_b):
        assert {k: v for k, v in x.items() if k not in ("ts", "dur")} == \
            {k: v for k, v in y.items() if k not in ("ts", "dur")}
        for k in ("ts", "dur"):
            if k in y:
                assert abs(x[k] - y[k]) <= gap * 1e6 + 1e-6, (x, y)


def test_killed_run_exercised_recovery(killed_run):
    _rt, res, obs = killed_run
    assert res.failures > 0 and res.promotions > 0 and res.replays > 0
    c = obs.metrics.counters
    assert c["failures.kills.node"] == res.failures
    assert c["recovery.promotions"] == res.promotions
    assert c["steps.executed"] >= 8


def test_trace_spans_all_closed_and_nested(killed_run):
    assert_nested_and_closed(killed_run[2].tracer)


def test_recovery_arcs_have_drain_replay_promotion(killed_run):
    tr = killed_run[2].tracer
    promotes = [i for i, s in enumerate(tr.spans)
                if s.name == "recovery.promote"]
    assert promotes
    for idx in promotes:
        kids = {s.name for s in tr.children_of(idx)}
        assert {"drain", "replay", "promotion"} <= kids
    assert tr.find("failure") and tr.find("ckpt.write") \
        and tr.find("store.push")


def test_chrome_trace_round_trip_monotone(killed_run):
    _rt, _res, obs = killed_run
    data = json.loads(json.dumps(chrome_trace(obs.tracer, obs.snapshot())))
    events = data["traceEvents"]
    names = {e["name"] for e in events}
    assert {"failure", "recovery.promote", "drain", "replay",
            "promotion"} <= names
    # thread_name metadata labels every track
    meta = {e["tid"]: e["args"]["name"] for e in events
            if e.get("ph") == "M"}
    assert meta[RUNTIME_TID] == "runtime" and meta[0] == "rank 0"
    last = {}
    for e in events:
        if e.get("ph") not in ("X", "i"):
            continue
        assert e["ts"] >= last.get(e["tid"], float("-inf"))
        last[e["tid"]] = e["ts"]


def test_text_flamegraph_renders(killed_run):
    out = text_flamegraph(killed_run[2].tracer)
    assert "step" in out and "recovery.promote" in out
    assert text_flamegraph(SpanTracer()) == "(no closed spans)\n"


def test_band_bytes_reconcile_with_sender_logs(killed_run):
    """The per-band cmp counters and the sender logs price the same
    traffic: store pushes are log=False, everything else is recorded."""
    rt, _res, obs = killed_run
    c = obs.metrics.counters
    obs_bytes = sum(c.get(f"comm.bytes.{b}.cmp", 0) for b in LOGGED_BANDS)
    obs_msgs = sum(c.get(f"comm.msgs.{b}.cmp", 0) for b in LOGGED_BANDS)
    log_bytes = sum(lg.recorded_bytes
                    for lg in rt.transport.send_logs.values())
    log_msgs = sum(lg.recorded_msgs
                   for lg in rt.transport.send_logs.values())
    assert obs_bytes == log_bytes > 0
    assert obs_msgs == log_msgs > 0
    # and the store band saw the checkpoint pushes the logs don't record
    assert c["comm.bytes.store.cmp"] > 0


def test_link_usage_measured(killed_run):
    rt, _res, obs = killed_run
    links = obs.links
    assert links is rt.transport.link_usage
    worst = links.max_contended()
    assert worst is not None and worst[1] > 0
    rows = links.table(top=5)
    assert rows and all(rows[i]["busy_s"] >= rows[i + 1]["busy_s"]
                        for i in range(len(rows) - 1))
    # traffic classes attributed: app halos + store pushes at minimum
    assert "app" in links.by_label
    assert any(lbl != "app" for lbl in links.by_label)
    d = links.as_dict()
    json.loads(json.dumps(d))
    assert d["max_contended"]["busy_s"] == worst[1]


def test_snapshot_time_distribution(killed_run):
    _rt, res, _obs = killed_run
    snap = res.obs_metrics
    td = snap["time_distribution"]
    # fully replicated run: useful == redundant by construction
    assert td["useful"] == pytest.approx(td["redundant"])
    assert sum(td.values()) == pytest.approx(100.0)
    assert snap["world"]["n"] == 16 and snap["world"]["m"] == 16
    json.loads(json.dumps(snap))


def test_cli_trace_and_metrics(tmp_path):
    from repro_torch.obs.__main__ import main
    trace_path = str(tmp_path / "run.json")
    metrics_path = str(tmp_path / "metrics.json")
    common = ["--ranks", "8", "--steps", "6", "--device", "cpu"]
    assert main(["trace", trace_path] + common) == 0
    assert main(["metrics", metrics_path] + common) == 0
    with open(trace_path) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    with open(metrics_path) as f:
        metrics = json.load(f)
    assert metrics["counters"]["steps.executed"] >= 6
    assert "time_distribution" in metrics
