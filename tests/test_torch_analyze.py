"""The port's schedule verifier and replica-divergence detector against the
JAX package's, on the CPU.

``repro_torch.analyze.{findings,schedule,divergence}`` are copies of their
``repro.analyze`` counterparts.  Exact comparisons:

* ``verify_schedule`` gives the reference's findings for every crafted
  schedule below (owners named under the port's module names);
* ``trace_app`` of each port app (torch, on the CPU) records the
  reference's trace of the reference app: the same op kinds, peers, tags,
  roots, redops and chunk counts (payloads stripped in both);
* ``payload_crc`` of a tensor equals the reference's CRC of an ndarray with
  the same values (numpy's dtype string, the shape, the C-order bytes),
  inside containers too.

* ``lint_source``/``lint_paths`` give the reference's findings (rule,
  line, severity) on the source of every lint test of
  ``tests/test_analyze.py``, each ``src/repro/...`` path mapped to
  ``src/repro_torch/...``: the port's path rules (deepcopy, per-rank-loop,
  the CLI exemption of the pool demo) police the port's paths.

Ported from ``tests/test_analyze.py``: the schedule tests (``:27-142``),
the lint tests (``:145-328``), the divergence tests (``:331-443``), with
tensor payloads and states, and the two CLI tests (``--device cpu``).
"""
import os
import re

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.analyze import lint_paths as ref_lint_paths
from repro.analyze import lint_source as ref_lint_source
from repro.analyze import payload_crc as ref_payload_crc
from repro.analyze import trace_app as ref_trace_app
from repro.analyze import verify_schedule as ref_verify_schedule
from repro.apps.cloverleaf import CloverLeaf as RefCloverLeaf
from repro.apps.hpcg import HPCG as RefHPCG
from repro.apps.pic import PIC as RefPIC
from repro_torch.analyze import (RULES, DivergenceDetector,
                                 ReplicaDivergence, band_owner, errors,
                                 lint_paths, lint_source, parse_allows,
                                 payload_crc, reserved_tags, trace_app, verify_app,
                                 verify_schedule, warnings)
from repro_torch.apps.cloverleaf import CloverLeaf
from repro_torch.apps.hpcg import HPCG, TAG_HALO
from repro_torch.apps.pic import PIC
from repro_torch.configs.base import FTConfig
from repro_torch.simrt import SimRuntime


def rules(findings):
    return {f.rule for f in findings}


# ----------------------------------------------------------- schedule verify

V = None
SCHEDULES = {
    "clean": ({
        0: [("send", 1, 5, V), ("recv", 1, 6),
            ("allreduce", V, "sum"), ("allreduce", V, "max"),
            ("barrier",), ("bcast", V, 0), ("gather", V, 1),
            ("allgather", V), ("alltoall", [V, V]),
            ("reduce_scatter", [V, V], "sum"), ("scan", V, "sum"),
            ("neighbor_allgather", V, (1,)),
            ("neighbor_alltoall", [V], (1,)),
            ("exchange", {1: V}, 7)],
        1: [("recv", 0, 5), ("send", 0, 6, V),
            ("allreduce", V, "sum"), ("allreduce", V, "max"),
            ("barrier",), ("bcast", V, 0), ("gather", V, 1),
            ("allgather", V), ("alltoall", [V, V]),
            ("reduce_scatter", [V, V], "sum"), ("scan", V, "sum"),
            ("neighbor_allgather", V, (0,)),
            ("neighbor_alltoall", [V], (0,)),
            ("exchange", {0: V}, 7)],
    }, 2),
    "unmatched_send": ({0: [("send", 1, 5, V)], 1: []}, 2),
    "unmatched_recv": ({0: [("recv", 1, 5)], 1: []}, 2),
    "head_to_head": ({0: [("recv", 1, 0), ("send", 1, 0, V)],
                      1: [("recv", 0, 0), ("send", 0, 0, V)]}, 2),
    "kind_mismatch": ({0: [("allreduce", V, "sum")], 1: [("barrier",)]}, 2),
    "redop_mismatch": ({0: [("allreduce", V, "sum")],
                        1: [("allreduce", V, "max")]}, 2),
    "missing_participant": ({0: [("barrier",)], 1: []}, 2),
    "asymmetric_neighbors": ({0: [("neighbor_allgather", V, (1,))],
                              1: []}, 2),
    "bad_chunks": ({0: [("alltoall", [V])], 1: [("alltoall", [V])]}, 2),
    "bad_neighbor_chunks": ({0: [("neighbor_alltoall", [V, V], (1,))],
                             1: [("neighbor_alltoall", [V], (0,))]}, 2),
    "reserved_coll_tag": ({0: [("send", 1, -11, V)],
                           1: [("recv", 0, -11)]}, 2),
    "reserved_store_tag": ({0: [("send", 1, -21, V)],
                            1: [("recv", 0, -21)]}, 2),
    "wildcard_ambiguity": ({0: [("recv_any", 7), ("recv_any", 7)],
                            1: [("send", 0, 7, V)],
                            2: [("send", 0, 7, V)]}, 3),
    "single_source_wildcard": ({0: [("recv_any", 7)],
                                1: [("send", 0, 7, V)]}, 2),
    "unknown_op": ({0: [("teleport", 1)], 1: []}, 2),
    "out_of_world_peer": ({0: [("send", 5, 1, V)], 1: []}, 2),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_findings_equal_the_reference(name):
    sched, n = SCHEDULES[name]
    ours = verify_schedule(sched, n, label=name)
    theirs = ref_verify_schedule(sched, n, label=name)
    assert [(f.rule, f.path, f.line, f.message, f.hint, f.severity)
            for f in ours] == \
        [(f.rule, f.path, f.line,
          f.message.replace("repro.", "repro_torch."), f.hint, f.severity)
         for f in theirs]


def test_clean_p2p_and_collective_schedule():
    assert verify_schedule(*SCHEDULES["clean"]) == []


def test_unmatched_send_located_at_sender():
    fs = verify_schedule({0: [("send", 1, 5, None)], 1: []}, 2,
                         label="t")
    assert rules(fs) == {"unmatched-send"}
    (f,) = fs
    assert f.path == "t rank 0" and f.line == 1


def test_unmatched_recv_when_no_sender_remains():
    assert rules(verify_schedule(*SCHEDULES["unmatched_recv"])) == \
        {"unmatched-recv"}


def test_head_to_head_recv_deadlock_cycle():
    fs = verify_schedule(*SCHEDULES["head_to_head"])
    assert rules(fs) == {"deadlock"}
    (f,) = fs
    assert "ranks [0, 1]" in f.message


def test_collective_kind_and_redop_mismatch_deadlock():
    # rank 1 calls barrier where rank 0 calls allreduce
    fs = verify_schedule(*SCHEDULES["kind_mismatch"])
    assert rules(fs) & {"deadlock", "collective-mismatch"}
    # same kind, different redop: different switchboard instances
    fs = verify_schedule(*SCHEDULES["redop_mismatch"])
    assert rules(fs) & {"deadlock", "collective-mismatch"}


def test_missing_collective_participant():
    assert rules(verify_schedule(*SCHEDULES["missing_participant"])) == \
        {"collective-mismatch"}


def test_asymmetric_neighbor_list_detected():
    # rank 0 lists rank 1 as a neighbor; rank 1 never reciprocates
    fs = verify_schedule(*SCHEDULES["asymmetric_neighbors"])
    assert {"unmatched-recv", "unmatched-send"} <= rules(fs)


def test_malformed_chunks_and_neighbors():
    assert "collective-mismatch" in rules(
        verify_schedule(*SCHEDULES["bad_chunks"]))
    assert "collective-mismatch" in rules(
        verify_schedule(*SCHEDULES["bad_neighbor_chunks"]))


def test_reserved_tag_use_reported_with_owner():
    fs = verify_schedule(*SCHEDULES["reserved_coll_tag"])
    assert "tag-reserved" in rules(fs)
    assert any("repro_torch.comm.collectives" in f.message for f in fs)
    fs = verify_schedule(*SCHEDULES["reserved_store_tag"])
    assert any("repro_torch.store.memstore" in f.message for f in fs)


def test_wildcard_ambiguity_is_a_warning():
    fs = verify_schedule(*SCHEDULES["wildcard_ambiguity"])
    assert errors(fs) == []
    assert rules(warnings(fs)) == {"wildcard-ambiguity"}


def test_single_source_wildcard_is_clean():
    assert verify_schedule(*SCHEDULES["single_source_wildcard"]) == []


def test_paper_app_schedules_verify_clean():
    for app in (HPCG(n_ranks=4, nx=4, ny=4, nz=4, device="cpu"),
                PIC(n_ranks=4, device="cpu"),
                CloverLeaf(n_ranks=4, device="cpu")):
        assert verify_app(app, steps=2) == []


def test_reserved_registry_matches_bands():
    for tag, name in reserved_tags().items():
        owner = band_owner(tag)
        assert owner is not None and name.startswith(owner), (tag, name)


TRACED = {
    "hpcg": ((HPCG, RefHPCG), dict(nx=4, ny=4, nz=4)),
    "pic": ((PIC, RefPIC), dict(cells_per_rank=16, particles_per_rank=64)),
    "cloverleaf": ((CloverLeaf, RefCloverLeaf), dict(nx=8, ny_local=4)),
}


@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("name", sorted(TRACED))
def test_trace_app_equals_the_reference(name, n):
    (ours, theirs), kw = TRACED[name]
    got = trace_app(ours(n_ranks=n, device="cpu", **kw), steps=3)
    want = ref_trace_app(theirs(n_ranks=n, **kw), steps=3)
    assert got == want
    assert len(got) == 3 and all(sorted(s) == list(range(n)) for s in got)
    assert all(any(s.values()) for s in got)       # ops were recorded


# --------------------------------------------------------------- divergence

class PingApp:
    """Two ranks swap their state vector every step — every byte of state
    crosses the transport, so any divergence is observable immediately."""

    device = torch.device("cpu")

    def __init__(self, n_ranks: int = 2):
        self.n_ranks = n_ranks

    def init_state(self, rank: int) -> dict:
        return {"v": torch.arange(4, dtype=torch.float64) + rank}

    def step(self, rank, state, t):
        peer = 1 - rank
        yield ("send", peer, 0, state["v"])
        got = yield ("recv", peer, 0)
        return {"v": state["v"] + got}


def _replicated_runtime(app, **kw):
    ft = FTConfig(mode="replication", replication_degree=1.0, mtbf_s=1e9)
    return SimRuntime(app, ft, detect_divergence=True, **kw)


def _flip_bit(t: torch.Tensor, index) -> None:
    t.view(torch.int64)[index] ^= 1


CRC_VALUES = [
    np.arange(8, dtype=np.float64),
    np.arange(12, dtype=np.float32).reshape(3, 4),
    np.arange(6, dtype=np.int64).reshape(2, 3)[:, ::2],      # a strided view
    np.array(2.5),                                            # 0-d
    np.zeros((0, 3)),
    np.array([True, False, True]),
    np.random.default_rng(0).standard_normal((4, 5, 6)),
]


@pytest.mark.parametrize("i", range(len(CRC_VALUES)))
def test_payload_crc_of_a_tensor_equals_the_reference(i):
    arr = CRC_VALUES[i]
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if arr.ndim == 2 and not arr.flags.c_contiguous:
        t = torch.from_numpy(arr.base.reshape(2, 3))[:, ::2]  # same view
    assert payload_crc(t) == ref_payload_crc(arr)
    # inside containers, beside other leaves
    assert payload_crc({"a": [t, (1, "x")], "b": None}) == \
        ref_payload_crc({"a": [arr, (1, "x")], "b": None})
    assert payload_crc(arr) == ref_payload_crc(arr)


def test_payload_crc_of_a_bf16_tensor_never_pickles(monkeypatch):
    import pickle
    t = torch.arange(6, dtype=torch.bfloat16)
    monkeypatch.setattr(pickle, "dumps", None)         # the fallback
    crc = payload_crc(t)
    u = t.clone()
    u.view(torch.int16)[2] ^= 1
    assert payload_crc(u) != crc
    assert payload_crc(t.clone()) == crc


def test_payload_crc_canonicalization():
    a = torch.arange(8, dtype=torch.float64)
    b = a.clone()
    assert payload_crc(a) == payload_crc(b)
    _flip_bit(b, 3)
    assert payload_crc(a) != payload_crc(b)
    # shape and dtype participate
    assert payload_crc(a) != payload_crc(a.reshape(2, 4))
    assert payload_crc(a) != payload_crc(a.to(torch.float32))
    # container structure participates; dict key order does not
    assert payload_crc([1, 2]) != payload_crc((1, 2))
    assert payload_crc({"x": 1, "y": 2}) == payload_crc({"y": 2, "x": 1})
    assert payload_crc(None) != payload_crc(0)


def test_bit_flip_caught_at_first_divergent_send():
    rt = _replicated_runtime(PingApp())
    _flip_bit(rt.workers[rt.rmap.rep[0]].state["v"], 0)
    with pytest.raises(ReplicaDivergence) as exc:
        rt.run(1)
    rec = exc.value.record
    assert (rec.src, rec.dst, rec.tag, rec.send_id) == (0, 1, 0, 0)
    assert rt.divergence.first == rec


def test_bit_flip_in_hpcg_halo_caught():
    rt = _replicated_runtime(HPCG(n_ranks=2, nx=4, ny=4, nz=4,
                                  device="cpu"))
    # corrupt the halo plane rank 0's replica sends to rank 1
    _flip_bit(rt.workers[rt.rmap.rep[0]].state["p"], (0, 0, -1))
    with pytest.raises(ReplicaDivergence) as exc:
        rt.run(2)
    rec = exc.value.record
    assert (rec.src, rec.dst, rec.tag, rec.send_id) == (0, 1, TAG_HALO, 0)


@pytest.mark.parametrize("app", [
    HPCG(n_ranks=2, nx=4, ny=4, nz=4, device="cpu"),
    CloverLeaf(n_ranks=3, nx=8, ny_local=4, device="cpu"),
    PIC(n_ranks=3, cells_per_rank=8, particles_per_rank=24, device="cpu")],
    ids=["hpcg", "cloverleaf", "pic"])
def test_clean_replicated_run_compares_and_stays_silent(app):
    rt = _replicated_runtime(app)
    rt.run(3)
    assert rt.divergence.divergences == []
    assert rt.divergence.compared > 0


def test_detector_collect_mode_and_findings():
    det = DivergenceDetector(raise_on_divergence=False)
    a = torch.arange(4, dtype=torch.float64)
    b = a.clone()
    _flip_bit(b, 1)
    det.on_send("cmp", 0, 1, 3, 0, a, 0)
    det.on_send("rep", 0, 1, 3, 0, b, 0)
    det.on_send("cmp", 0, 1, 3, 1, a, 0)
    det.on_send("rep", 0, 1, 3, 1, a, 0)
    assert len(det.divergences) == 1 and det.compared == 2
    rec = det.first
    assert rec.send_id == 0 and rec.cmp_crc == payload_crc(a) \
        and rec.rep_crc == payload_crc(b)
    (f,) = det.findings("demo")
    assert f.rule == "replica-divergence" and "send_id=0" in f.message


class HubApp:
    """Rank 0 drains wildcard receives from every peer."""

    TAG = 9

    def __init__(self, n_ranks: int = 3):
        self.n_ranks = n_ranks

    def init_state(self, rank: int) -> dict:
        return {"acc": torch.zeros(2, dtype=torch.float64)}

    def step(self, rank, state, t):
        if rank == 0:
            acc = state["acc"]
            for _ in range(self.n_ranks - 1):
                src, payload = yield ("recv_any", self.TAG)
                acc = acc + payload * (src + 1)
            total = yield ("bcast", acc, 0)
        else:
            yield ("send", 0, self.TAG,
                   torch.full((2,), float(rank + t), dtype=torch.float64))
            total = yield ("bcast", None, 0)
        return {"acc": total}


def test_wildcard_matches_metadata_pins_send_ids():
    rt = _replicated_runtime(HubApp(3), workers_per_node=2)
    rt.run(2)
    cmp_ep = rt.transport.endpoints[rt.rmap.cmp[0]]
    rep_ep = rt.transport.endpoints[rt.rmap.rep[0]]
    # both roles recorded the identical (src, tag, send_id) history,
    # which is exactly the cmp-chosen wc_order stream
    assert cmp_ep.wc_matches == rep_ep.wc_matches
    assert cmp_ep.wc_matches == rt.transport.wc_order[0]
    assert len(cmp_ep.wc_matches) == 2 * 2        # (n-1) matches x steps
    for src, tag, sid in cmp_ep.wc_matches:
        assert tag == HubApp.TAG and src in (1, 2) and sid >= 0


def test_wc_matches_snapshot_roundtrip_and_legacy_load():
    rt = _replicated_runtime(HubApp(3), workers_per_node=2)
    rt.run(1)
    ep = rt.transport.endpoints[rt.rmap.cmp[0]]
    snap = rt.transport.snapshot_rank(0, ep)
    assert snap["wc_matches"] == ep.wc_matches
    ep.wc_matches = []
    rt.transport.load_rank(0, ep, snap)
    assert ep.wc_matches == snap["wc_matches"]
    legacy = {k: v for k, v in snap.items() if k != "wc_matches"}
    rt.transport.load_rank(0, ep, legacy)
    assert ep.wc_matches == []


# --------------------------------------------------------------------- lint

PORT_ROOT = os.path.dirname(os.path.abspath(
    __import__("repro_torch").__file__))


def _port_path(path):
    return path.replace("src/repro/", "src/repro_torch/")


def _key(findings):
    return [(f.rule, f.line, f.severity) for f in findings]


def lint(source, path="<string>"):
    """The port's findings on ``source`` at the port's ``path``, after
    checking them against the reference's at the reference's path."""
    ours = lint_source(source, _port_path(path))
    assert _key(ours) == _key(ref_lint_source(source, path))
    return ours


def test_lint_rules_equal_the_reference():
    from repro.analyze import RULES as REF_RULES
    assert RULES == REF_RULES


def test_lint_wallclock_and_alias_resolution():
    fs = lint("import time\nt0 = time.perf_counter()\n")
    assert rules(fs) == {"wallclock"}
    fs = lint("import time as _t\nt0 = _t.time()\n")
    assert rules(fs) == {"wallclock"}
    fs = lint("from time import perf_counter\nt0 = perf_counter()\n")
    assert rules(fs) == {"wallclock"}


def test_lint_suppression_same_line_and_above():
    base = "import time\n"
    line = "t0 = time.perf_counter()"
    assert lint(base + line + "  # repro: allow[wallclock]\n") == []
    assert lint(base + "# repro: allow[wallclock]\n" + line + "\n") == []
    assert lint(base + "# repro: allow[*]\n" + line + "\n") == []
    # wrong rule id does not suppress
    assert rules(lint(
        base + line + "  # repro: allow[set-order]\n")) == {"wallclock"}


def test_lint_unseeded_rng():
    fs = lint("import numpy as np\nx = np.random.rand(3)\n")
    assert rules(fs) == {"unseeded-rng"}
    fs = lint("import random\nx = random.random()\n")
    assert rules(fs) == {"unseeded-rng"}
    fs = lint("import numpy as np\nr = np.random.default_rng()\n")
    assert rules(fs) == {"unseeded-rng"}
    assert lint("import numpy as np\nr = np.random.default_rng(0)\n") == []
    assert lint("import random\nr = random.Random(7)\n") == []
    assert lint("import numpy as np\n"
                "r = np.random.default_rng(0)\nx = r.random()\n") == []


def test_lint_deepcopy_on_comm_hot_path():
    src = "import copy\ny = copy.deepcopy(x)\n"
    fs = lint(src, path="src/repro/comm/transport.py")
    assert rules(fs) == {"deepcopy"}
    assert fs[0].path == "src/repro_torch/comm/transport.py"
    fs = lint("import copy as _c\ny = _c.deepcopy(x)\n",
              path="src/repro/comm/anything.py")
    assert rules(fs) == {"deepcopy"}
    # only the comm hot path is policed
    assert lint(src, path="src/repro/simrt/runtime.py") == []
    assert lint(src) == []
    assert lint(
        "import copy\ny = copy.deepcopy(x)  # repro: allow[deepcopy]\n",
        path="src/repro/comm/payload.py") == []
    # the port's rule names the port's paths, not the reference's
    assert lint_source(src, "src/repro/comm/transport.py") == []


def test_lint_per_rank_loop_in_collectives():
    src = ("def f(self):\n"
           "    for r in range(self.n):\n"
           "        pass\n")
    fs = lint(src, path="src/repro/comm/collectives.py")
    assert rules(fs) == {"per-rank-loop"}
    fs = lint("def f(e, r):\n"
              "    return [x for x in range(r + 1, e.n)]\n",
              path="src/repro/comm/collectives.py")
    assert rules(fs) == {"per-rank-loop"}
    assert lint(src, path="src/repro/comm/transport.py") == []
    assert lint("def f(n):\n    for r in range(n):\n        pass\n",
                path="src/repro/comm/collectives.py") == []
    assert lint("def f(self):\n"
                "    # repro: allow[per-rank-loop]\n"
                "    for dst in range(self.n):\n"
                "        pass\n",
                path="src/repro/comm/collectives.py") == []
    assert lint_source(src, "src/repro/comm/collectives.py") == []


def test_lint_set_iteration_order():
    fs = lint("s = {1, 2}\nfor x in s:\n    pass\n")
    assert rules(fs) == {"set-order"}
    fs = lint("xs = [p for p in {1, 2}]\n")
    assert rules(fs) == {"set-order"}
    fs = lint("s = set([1, 2])\nxs = list(s)\n")
    assert rules(fs) == {"set-order"}
    assert lint("s = {1, 2}\nfor x in sorted(s):\n    pass\n") == []
    assert lint("s = {1, 2}\nn = len(s)\nm = max(s)\n") == []
    assert lint("s = {1, 2}\nxs = sorted(list(s))\n") == []


def test_lint_unpriced_transport():
    src = ("from repro_torch.comm.transport import ReplicaTransport\n"
           "t = ReplicaTransport(rmap, 4)\n")
    assert rules(lint(src)) == {"unpriced-transport"}
    assert lint("from repro_torch.comm.transport import ReplicaTransport\n"
                "t = ReplicaTransport(rmap, 4, cost_model=cm)\n") == []


def test_lint_tag_band_membership():
    fs = lint("TAG_BOGUS = -99\n", "src/repro/comm/fake.py")
    assert rules(fs) == {"tag-range"}
    fs = lint("TAG_HALO = -11\n", "src/repro/apps/fake.py")
    assert rules(fs) == {"tag-range"}
    assert any("repro_torch.comm.collectives" in f.message for f in fs)
    assert lint("TAG_HALO = 1\n", "src/repro/apps/fake.py") == []
    assert lint("TAG_X = -12\n", "src/repro/comm/fake.py") == []
    assert lint("TAG_POOL_X = -43\n", "src/repro/pool/fake.py") == []


def test_lint_tag_collision_across_files(tmp_path):
    comm = tmp_path / "comm"
    comm.mkdir()
    (comm / "a.py").write_text("TAG_A = -11\n")
    (comm / "b.py").write_text("TAG_B = -11\n")
    fs = lint_paths([str(tmp_path)])
    assert rules(fs) == {"tag-range"}
    assert any("collides" in f.message for f in fs)
    assert _key(fs) == _key(ref_lint_paths([str(tmp_path)]))
    (comm / "b.py").write_text(
        "TAG_B = -11  # repro: allow[tag-range]\n")
    assert lint_paths([str(tmp_path)]) == []
    assert ref_lint_paths([str(tmp_path)]) == []


def test_port_tree_lints_clean():
    """``python -m repro_torch.analyze lint``'s property: src/repro_torch
    carries no unsuppressed violation."""
    assert lint_paths([PORT_ROOT]) == []


def test_port_pragmas_are_policed():
    """The port's pragmas are checked now: with them stripped, the lint
    finds the per-destination loops of the collective engine and the wall
    reads of the FT session and strategies, each at a line the pragma
    covered."""
    allow = re.compile(r"#\s*repro:\s*allow\[[^\]]*\].*$", re.M)
    for rel, rule, least in (("comm/collectives.py", "per-rank-loop", 5),
                             ("ft/session.py", "wallclock", 2),
                             ("ft/strategy.py", "wallclock", 4)):
        path = os.path.join(PORT_ROOT, rel)
        with open(path) as f:
            source = f.read()
        fs = lint_source(allow.sub("", source), path)
        assert len(fs) >= least and rules(fs) == {rule}, (rel, _key(fs))
        covered = parse_allows(source)
        for f in fs:
            assert any(rule in covered.get(at, ()) for at in
                       (f.line, f.line - 1)), (rel, f.line)


def test_pool_demo_is_a_cli_module():
    src = "def run():\n    print('x')\n"
    assert lint(src, "src/repro/pool/demo.py") == []
    assert rules(lint(src, "src/repro/pool/master.py")) == {"no-print"}


@settings(max_examples=30, deadline=None)
@given(allowed=st.lists(st.sampled_from(
    ["wallclock", "unseeded-rng", "set-order", "unpriced-transport",
     "tag-range", "*"]), min_size=0, max_size=3),
    same_line=st.booleans())
def test_lint_suppression_round_trip(allowed, same_line):
    annot = "# repro: allow[" + ",".join(allowed) + "]"
    line = "t0 = time.perf_counter()"
    if same_line:
        src = f"import time\n{line}  {annot}\n"
    else:
        src = f"import time\n{annot}\n{line}\n"
    fs = [f for f in lint(src) if f.rule == "wallclock"]
    suppressed = "wallclock" in allowed or "*" in allowed
    assert (fs == []) == suppressed


# ---------------------------------------------------------------------- CLI

def test_cli_schedule_pass_exits_clean(capsys):
    from repro_torch.analyze.__main__ import main
    assert main(["schedule", "--steps", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "0 error(s)" in out


def test_cli_lint_detects_violation(tmp_path):
    from repro_torch.analyze.__main__ import main
    bad = tmp_path / "bad.py"
    bad.write_text("import time\nt = time.time()\n")
    assert main(["lint", "--path", str(bad)]) == 1


def test_cli_divergence_demo_catches_the_flip(capsys):
    from repro_torch.analyze.__main__ import main
    assert main(["divergence", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "caught: replica divergence" in out and "tag=1" in out


def test_cli_default_lints_the_port_and_needs_the_card(monkeypatch,
                                                       capsys):
    from repro_torch.analyze.__main__ import main
    assert main(["lint"]) == 0
    assert PORT_ROOT in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["schedule"])
