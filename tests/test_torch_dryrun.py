"""The dry run (``launch/dryrun.py``) and its counter (``launch/op_cost.py``)
on the CPU:

  * the CLI runs whisper-tiny decode_32k on both production meshes in a
    subprocess, as ``tests/test_system.py`` runs the reference's, and
    writes the reference's fields (chips 256 and 512, per-device FLOPs
    above 0, a dominant term);
  * repeated units: a step traced at 1 and 2 layers (or loop iterations)
    and extrapolated equals the step traced whole, every count exactly:
    the reduced qwen3-8b's train step at 3 layers, the reduced
    xlstm-350m's with an 8-token sLSTM and its prefill;
  * ``FlopCounterMode`` over a meta step reads the kernels' formulas
    and agrees with the counter;
  * a train step's matmul FLOPs are 17/6 of its forward's for six
    ``tanh(c @ w)`` steps (the reference's 3x test: each step's dW and dC
    but the first step's dC);
  * over DTensor, the per-device count equals a count of the same step
    written on the local shards with its collective, on a 4 x 2 fake mesh;
    an op that DTensor cannot place is gathered only if it is named in
    ``op_cost.GATHERED_OPS``, and raises otherwise;
  * the card's check emulated: the dry run's FLOPs of the reduced qwen3's
    and mixtral's train steps and prefill on one device equal
    ``FlopCounterMode``'s count of the real step on the CPU, with each
    kernel standing in for its CUDA launch (its plain version run out of
    the counter's sight, its launch tallied as the wrapper tallies it),
    plus each kernel's ``kernels/cost.py`` work times its tally: what
    ``chip_smoke.py``'s ``phase_dryrun`` holds on the card.

Everything here is exact (integer counts)."""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_arch
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.kernels import cost, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.launch import dryrun, op_cost, step_fns
from repro_torch.launch.mesh import end_world, fake_world
from repro_torch.models import api, trips
from repro_torch.optim import adamw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------------ the CLI

def test_cli_whisper_decode_on_both_meshes(tmp_path):
    out = tmp_path / "cell.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--mesh", "both",
         "--report", "--out", str(out)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "2/2 cells OK" in proc.stdout
    assert "| whisper-tiny | decode_32k |" in proc.stdout
    for mesh, chips in (("single", 256), ("multi", 512)):
        res = json.loads((tmp_path / f"cell_{mesh}.json").read_text())
        assert len(res) == 1 and res[0]["ok"]
        t = res[0]["terms"]
        assert t["chips"] == chips
        assert t["flops_per_device"] > 0
        assert t["dominant"] in ("compute", "memory", "collective")
        for key in ("compute_s", "memory_s", "collective_s",
                    "useful_ratio", "roofline_fraction", "bound_time_s",
                    "collective_breakdown", "model_flops_global"):
            assert key in t
        mem = t["memory_per_device"]
        assert mem["argument"] == sum(mem["argument_parts"].values()) > 0
        assert "trace_s" in res[0]
        assert res[0]["torch"] == torch.__version__
        assert {"memory_s", "collective_s"} <= set(res[0]["plan_dependent"])


# ---------------------------------------------------------- repeated units

def _fields(rep):
    return (rep.flops, rep.bytes, rep.bytes_lb, rep.collective_bytes,
            rep.kernel_flops, {k: v for k, v in rep.bytes_by_op.items()
                               if v})


def _train_trace(cfg, b, s):
    model = api.build_model(cfg, device="meta")
    params = dict(model.state_dict())
    opt = adamw.init(params)._replace(step=torch.zeros((),
                                                       dtype=torch.int32))
    step, _ = step_fns.make_train_step(RunConfig(
        model=cfg, shape=ShapeConfig("t", s, b, "train"), remat="none",
        seq_chunk=s))
    batch = {k: torch.zeros((b, s), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    return op_cost.trace(lambda: step(params, opt, batch))


def test_layers_extrapolated_equal_a_full_trace():
    """qwen3-8b reduced, train step at 3 layers (2 x 16 tokens): from
    traces at 1 and 2 layers, every field equals the 3-layer trace's."""
    cfg = get_arch("qwen3-8b").reduced()
    whole = _train_trace(dataclasses.replace(cfg, n_layers=3), 2, 16)
    folded = op_cost.extrapolate(
        lambda c: _train_trace(dataclasses.replace(cfg, n_layers=c["layers"]),
                               2, 16), {"layers": 3})
    assert _fields(folded) == _fields(whole)
    assert whole.flops > 0 and whole.kernel_flops


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_slstm_tokens_extrapolated_equal_a_full_trace(kind):
    """xlstm-350m reduced at 8 tokens (one mLSTM chunk): its sLSTM loop
    run for 1 and 2 tokens and padded, then extrapolated to 8, equals the
    loop run over all 8, every field."""
    cfg = get_arch("xlstm-350m").reduced()
    b, s = 2, 8

    def run():
        if kind == "train":
            return _train_trace(cfg, b, s)
        model = api.build_model(cfg, device="meta")
        toks = torch.zeros((b, s), dtype=torch.int32, device="meta")
        return op_cost.trace(lambda: model.prefill({"tokens": toks}))

    whole = run()

    def at(c):
        with trips.folded({"slstm": c["slstm"]}):
            return run()
    folded = op_cost.extrapolate(at, {"slstm": s})
    assert _fields(folded) == _fields(whole)


def test_flop_counter_reads_the_kernels_formulas_on_meta():
    """``FlopCounterMode`` over a meta train step counts each kernel op
    at its ``kernels/cost.py`` work (the formulas ``kernels/meta.py``
    registers), so its total is ``op_cost``'s on one device."""
    cfg = get_arch("zamba2-7b").reduced()
    model = api.build_model(cfg, device="meta")
    params = dict(model.state_dict())
    opt = adamw.init(params)._replace(step=torch.zeros((),
                                                       dtype=torch.int32))
    step, _ = step_fns.make_train_step(RunConfig(
        model=cfg, shape=ShapeConfig("t", 32, 2, "train"), remat="none",
        seq_chunk=32))
    batch = {k: torch.zeros((2, 32), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    with FlopCounterMode(display=False) as fc:
        step(params, opt, batch)
    counted = op_cost.trace(lambda: step(params, opt, batch))
    by_op = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    assert fc.get_total_flops() == counted.flops
    assert by_op["repro_torch.mamba_chunk_scan"] == \
        counted.kernel_flops["mamba_chunk_scan"] > 0


def test_train_matmul_flops_are_17_of_6_forwards():
    """Six ``tanh(c @ w)`` steps and the sum of squares: the forward's six
    products, and for the gradient each step's dW and dC but the first
    step's dC (x needs none): 17 products, 2 n^3 each."""
    n = 128

    def loss(w, x):
        c = x
        for _ in range(6):
            c = torch.tanh(c @ w)
        return (c * c).sum()
    w = torch.empty((n, n), device="meta", requires_grad=True)
    x = torch.empty((n, n), device="meta")
    fwd = op_cost.trace(lambda: loss(w, x))
    train = op_cost.trace(lambda: torch.autograd.grad(loss(w, x), [w]))
    assert fwd.flops == 6 * 2 * n ** 3
    assert train.flops == 17 * 2 * n ** 3
    assert 2.0 < train.flops / fwd.flops < 4.5


# ------------------------------------------------------------- per device

def test_dtensor_count_equals_the_local_shards_count():
    """y = (x @ w1) @ w2 on a 4 x 2 (data, model) fake mesh, x's batch
    over data, w1 column- and w2 row-parallel over model, y summed over
    model: the per-device FLOPs and collective bytes over DTensor equal
    those of the same step written on rank 0's shards with an explicit
    all-reduce."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    fake_world(8)
    try:
        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("data", "model"))

        def dt(local, placements):
            return DTensor.from_local(torch.empty(local, device="meta"),
                                      mesh, placements, run_check=False)
        x = dt((4, 64), [Shard(0), Replicate()])
        w1 = dt((64, 16), [Replicate(), Shard(1)])
        w2 = dt((16, 64), [Replicate(), Shard(0)])

        def sharded():
            ((x @ w1) @ w2).redistribute(mesh, [Shard(0), Replicate()])

        def local():
            xl = torch.empty((4, 64), device="meta")
            y = (xl @ torch.empty((64, 16), device="meta")) @ \
                torch.empty((16, 64), device="meta")
            funcol.all_reduce(y, "sum", (mesh, 1))
        a, b = op_cost.trace(sharded), op_cost.trace(local)
        assert a.flops == b.flops == 2 * 4 * 64 * 16 * 2 + 4 * 64
        assert a.collective_breakdown == b.collective_breakdown == {
            "all-reduce": {"count": 1, "bytes": 4 * 64 * 4}}
    finally:
        end_world()


@pytest.mark.parametrize("op", ["view", "log_sigmoid_backward"])
def test_only_named_ops_run_on_gathered_inputs(op, monkeypatch):
    """An op that DTensor cannot place on its inputs (a view that would
    split a sharded dim unevenly; an op without a sharding strategy) runs
    on gathered inputs, counted under ``fallbacks`` with its all-gathers,
    only while ``op_cost.GATHERED_OPS`` names it; without the name it
    raises, so a fault under a mesh is not counted away."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    fake_world(8)
    try:
        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("data", "model"))
        x = DTensor.from_local(torch.empty((4, 6), device="meta"), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        run = {"view": lambda: x.view(16, 3, 4),
               "log_sigmoid_backward": lambda:
                   torch.ops.aten.log_sigmoid_backward(x, x, x)}[op]
        rep = op_cost.trace(run)
        assert rep.fallbacks == {op: 1}
        assert rep.collective_breakdown["all-gather"]["count"] >= 1
        monkeypatch.setattr(op_cost, "GATHERED_OPS",
                            op_cost.GATHERED_OPS - {op})
        with pytest.raises((RuntimeError, NotImplementedError)):
            op_cost.trace(run)
    finally:
        end_world()


# ------------------------------------------------- the card's check, emulated

@contextlib.contextmanager
def _cpu_kernels(monkeypatch, tally):
    """The CUDA route taken on CPU tensors, each kernel replaced by its
    plain version run with every dispatch mode off (as a ctypes launch is
    invisible to FlopCounterMode), each launch tallied under
    ``kernels/cost.py``'s arguments as the wrapper tallies it."""
    def launch(name, key, fn):
        tally.setdefault(name, {})
        tally[name][key] = tally[name].get(key, 0) + 1
        with _disable_current_modes(), torch.no_grad():
            return fn()

    def rmsnorm(x, w, *, eps=1e-5):
        return launch("rmsnorm", (tuple(x.shape), x.dtype),
                      lambda: ref.rmsnorm_ref(x, w, eps=eps))

    def add_rmsnorm(x, r, w, *, eps=1e-5):
        return launch("add_rmsnorm", (tuple(x.shape), x.dtype),
                      lambda: ref.add_rmsnorm_ref(x, r, w, eps=eps))

    def rmsnorm_bwd(dy, x, w, *, eps=1e-5):
        return launch("rmsnorm_bwd", (tuple(x.shape), x.dtype),
                      lambda: ref.rmsnorm_bwd_ref(dy, x, w, eps=eps))

    def add_rmsnorm_bwd(dy, ds, s, w, *, eps=1e-5):
        return launch("add_rmsnorm_bwd", (tuple(s.shape), s.dtype),
                      lambda: ref.add_rmsnorm_bwd_ref(dy, ds, s, w, eps=eps))

    def key(q, k, causal, window):
        b, hq, sq, d = q.shape
        return (b, hq, k.shape[1], sq, k.shape[2], d, q.dtype, bool(causal),
                int(window))

    def attention(q, k, v, *, causal=True, window=0, return_lse=False):
        def run():
            o = ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window)
            if return_lse:
                return o, ref.flash_attention_lse_ref(q, k, causal=causal,
                                                      window=window)
            return o
        return launch("flash_attention", key(q, k, causal, window), run)

    def attention_bwd(q, k, v, o, do, lse=None, *, causal=True, window=0):
        return launch("flash_attention_bwd", key(q, k, causal, window),
                      lambda: ref.flash_attention_bwd_ref(
                          q, k, v, do, causal=causal, window=window))

    monkeypatch.setattr(ops, "_use_kernel", lambda x, backend: True)
    for mod, name, fn in ((rn, "rmsnorm", rmsnorm),
                          (rn, "add_rmsnorm", add_rmsnorm),
                          (rn, "rmsnorm_bwd", rmsnorm_bwd),
                          (rn, "add_rmsnorm_bwd", add_rmsnorm_bwd),
                          (fa, "flash_attention", attention),
                          (fa, "flash_attention_bwd", attention_bwd)):
        monkeypatch.setattr(mod, name, fn)
    monkeypatch.setattr(ops, "_rmsnorm_cuda", rmsnorm)
    monkeypatch.setattr(ops, "_add_rmsnorm_cuda", add_rmsnorm)
    monkeypatch.setattr(ops, "_flash_cuda", attention)
    monkeypatch.setattr(fa, "check_layout", lambda *a: None)
    yield


def _card_count(step, monkeypatch):
    tally = {}
    with _cpu_kernels(monkeypatch, tally), \
            FlopCounterMode(display=False) as fc:
        step()
    kernels = {n: cost.tally_work(n, c).flops for n, c in tally.items()}
    return fc.get_total_flops() + sum(kernels.values()), kernels


@pytest.mark.parametrize("arch", ["qwen3-8b", "mixtral-8x7b"])
def test_dry_run_equals_the_emulated_card_count(arch, monkeypatch):
    cfg = get_arch(arch).reduced()
    b, s = 2, 32
    model = api.build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         dtype=torch.int32)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    opt = adamw.init(params)
    step, _ = step_fns.make_train_step(RunConfig(
        model=cfg, shape=ShapeConfig("t", s, b, "train"), remat="none",
        seq_chunk=s))
    batch = {"tokens": toks, "labels": toks}
    for kind, fn in (("train", lambda: step(params, opt, batch)),
                     ("prefill", lambda: model.prefill({"tokens": toks}))):
        card, kernels = _card_count(fn, monkeypatch)
        monkeypatch.undo()
        dry = dryrun.lower_cell(arch, kind, cfg=cfg,
                                shape=ShapeConfig(kind, s, b, kind),
                                one_device=True, seq_chunk=s)
        assert dry["terms"]["flops_per_device"] == card, kind
        names = {"mamba_scan": "mamba_chunk_scan"}
        assert {names.get(k, k): v for k, v in kernels.items()} == \
            dry["kernel_flops"], kind
