"""The output check and the readers, on the CPU.

A whole run of each family at the tiny size (``tiny.py``, float32) with
the cells' own limits: sound, it comes out correct; with the timed path
broken underneath (a step that leaves its state as it was; half of each
batch left out; one gradient altered where the optimizer receives it;
AdamW without its weight decay or with its betas exchanged) it does
not. The window's compared step is its last, and each fault moves the
window's number that is there for it. The control, the reference computed with fp8 products in the
program's place, is judged not correct too. The card's run of a cell
(``cuda`` marker) skips here."""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from perfbench import bench
from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _faults(name):
    """The faults a cell can have: half of the batch only with two rows
    or more; no exchange between GPUs on one GPU; AdamW without its
    weight decay or with its betas exchanged."""
    rows = bench.load_cell(name).traffic["batch"]
    return ["unchanged", "grad_altered", "no_decay", "betas_swapped"] + (
        ["half_batch"] if rows >= 2 else [])


def _run(name, fault=None):
    torch.set_num_threads(2)
    rows = min(bench.load_cell(name).traffic["batch"], 2)
    return bench.run(tiny.cell(name, batch=rows), 11, 0.1, False,
                     t_start=time.time(), device="cpu", fault=fault)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = _run(name)
    assert out["result"]["correct"], out["checks"]
    assert out["result"]["failed"] == 0
    assert out["checks"]["promotions"]["value"] == 1
    assert list(out["result"]) == ["correct", "attempted", "failed",
                                   "metrics"]


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS
                                        for f in _faults(n)])
def test_a_broken_step_is_not_correct(name, fault):
    out = _run(name, fault)
    assert not out["result"]["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = tiny.cell(name, batch=4, seq=64)
    torch.set_num_threads(2)
    ref = bench.reference_readings(cell, 3, "cpu")
    fp8 = bench.reference_readings(cell, 3, "cpu", matmul="fp8")
    numbers = bench.gaps(fp8, ref)
    assert not bench.judge(numbers, cell.limits["compare"]), numbers


def test_the_compared_step_is_the_windows_last():
    """The window's last step, on the promoted state, read at the sample:
    its loss is the window's last, and every unit of every parameter is
    read before and after it."""
    out = _run(CELLS[0])
    win = out["win"]
    cmp = win.compared
    assert cmp.t == win.steps - 1 > win.kill_step
    assert cmp.loss == win.losses[-1]
    assert set(cmp.before_step) == set(cmp.after_step)
    assert {u for rows in cmp.index.values() for u, _ in rows} == \
        set(cmp.before_step)
    assert cmp.pause_ms > 0


def test_the_sample_is_drawn_from_the_seed():
    params = {"small": torch.zeros(3, 5),
              "big": torch.zeros(bench.SAMPLE + 10)}
    a, b = bench.sample(params, 7), bench.sample(params, 7)
    assert torch.equal(a["small"][0][1], torch.arange(15))
    assert a["big"][0][1].numel() == bench.SAMPLE
    assert torch.equal(a["big"][0][1], b["big"][0][1])
    assert not torch.equal(a["big"][0][1], bench.sample(params, 8)["big"][0][1])


@pytest.mark.parametrize("kind,number", [
    ("unchanged", "window_update_gap"), ("no_decay", "window_decay_gap"),
    ("betas_swapped", "window_sq_gap"), ("grad_altered", "window_grad_gap")])
def test_each_fault_moves_its_window_number(kind, number):
    """Planted in the reference put in the program's place, each fault
    reads about 1 (the squares of a doubled gradient: 3) in the window's
    number that is there for it; the sound program reads round-off."""
    torch.set_num_threads(2)
    out = bench.run(tiny.cell(CELLS[0], batch=1), 13, 0.1, False,
                    t_start=time.time(), device="cpu", kinds=(kind,))
    assert out["readings"][kind][number] > 0.45
    assert out["readings"]["program"][number] < 1e-4


def _event(name, lo, hi, cuda):
    from torch.autograd import DeviceType
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=lo, end=hi), device_type=DeviceType.CUDA if cuda
        else DeviceType.CPU)


def test_profile_summary_unions_and_labels():
    events = [_event("perfbench.window", 0, 1000, False),
              _event("aten::copy_", 100, 400, False),
              _event("cudaStreamSynchronize", 450, 600, False),
              _event("k1", 0, 200, True), _event("k2", 150, 300, True),
              _event("perfbench.step.cmp", 0, 900, True),   # annotation
              _event("k3", 700, 1200, True)]
    prof = SimpleNamespace(events=lambda: events)
    s = bench.summarize_profile(prof, steps=1)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(600e-6)        # [0,300] + [700,1000]
    assert dict(s.idle_gaps) == pytest.approx(
        {"cudaStreamSynchronize": 400e-6})
    assert s.counts == {"k1": 1, "k2": 1, "k3": 1}


def _ctx(**win):
    cell = bench.load_cell(CELLS[0])
    base = dict(steps=4, kill_step=2, window_s=1.0, tokens=4096 * 4,
                peak_bytes=5e10, setup_s=20.0, paused_ms=10.0,
                profiled=(3, 3),
                optimizer_ms=[90.0, 110.0],
                spans=[(t, r, 250 * t + 100 * r, 250 * t + 100 * r + 100)
                       for t in range(4) for r in (0, 1)])
    base.update(win)
    return SimpleNamespace(cell=cell, model=cell.model, traffic=cell.traffic,
                           work=bench.family_module("work", "moe"),
                           kernel_names=json.loads(
                               (ROOT / "perfbench/work/kernels.json")
                               .read_text()),
                           win=SimpleNamespace(**base))


@pytest.mark.parametrize("name,want", [
    ("train_tokens_per_s", 16384.0), ("peak_mem_gb", 50.0),
    ("setup_s", 20.0), ("optimizer_ms", 100.0),
    # 1,000 ms - 10 paused - 8 x 100 in the steps, over 4 steps
    ("ft_gap_ms", 47.5),
    # the replica's step 1 ends at 450, the step 2 cmp starts at 500
    ("promote_ms", 50.0),
    # 4 steps less the profiled one (750 to 950 ms) and 10 ms paused:
    # 3 x 2 x the step's FLOPs in 790 ms at 989 TFLOP/s
    ("step_mfu", 100 * 6 * 13_393_436_082_176 / (0.79 * 989e12))])
def test_readers(name, want):
    assert bench.read_metric(name, _ctx()) == pytest.approx(want)


def test_trace_readers_read_nothing_without_a_trace():
    for name in ("kernels_roofline", "device_idle_pct"):
        assert bench.read_metric(name, _ctx()) is None
    assert bench.read_metric("step_mfu", _ctx(spans=None)) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_on_the_card(card, name):
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", name, "--seed",
         "2147483651", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
