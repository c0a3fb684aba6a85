"""The benchmark's run of one cell: set-up, the measured window, the traced
sub-window and the output check. ``run.py`` is its command line.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs/<config>.json``: the published config, what was cut, and under
``port`` the sizes as the port runs them), a traffic mix
(``traffic/<traffic>.json``: batch, sequence, FT mode, the kill, the
optimizer), and has its check's limits in ``limits/<cell>.json``. The
model family (``port.family``) picks ``work/<family>.py`` (FLOPs and the
kernels' launches) and ``reference/<family>.py`` (the plain f32 model).
Every metric is read by ``metrics/<name>.py``. So a new cell or metric is
new files and ``BENCHMARK.json`` entries; nothing here names a model.

A run, on the program (``repro_torch``, from ``src/``):

1. set-up: the benchmark's weights (``weights.py``) and the program's
   train step (``launch/train.build_workload``) with the benchmark's
   token feed; an ``FTSession`` in the cell's FT mode runs the warm-up
   steps with a promotion at ``warmup.kill_step``. The first
   ``compared_steps`` of them are the steps the output check compares:
   their losses, the first step's gradient norms (from the optimizer's
   first moment) and the change of every parameter over them.
2. the window: a second ``FTSession`` over the same workload and state,
   with worker ``kill_worker`` killed at a step drawn from the seed between
   the traffic's two ``kill_window`` fractions of the window's steps (both
   0.5: the middle, the same for every seed); it opens at the first step's start and closes when the
   card has finished the last step (CUDA events), and lasts the run's
   seconds to within a step, as timed in the warm-up. Its last step, on
   the promoted state, is compared too (``Compared``): the copies that
   read it are pauses taken out of the window's time.
3. the check: the program's state freed, the reference trains the same
   weights on the same batches for ``compared_steps`` steps and takes the
   window's last step from the state the program held before it, and
   each gap is held to its limit.

With ``trace`` every step call of either slice and every
``adamw.update`` call is bracketed by CUDA events, and ``torch.profiler``
records ``profile_steps`` steady steps after the promotion. The
profiler's start and stop (a synchronisation and its own work) are timed
as pauses, and the updates inside its steps are left out of
``optimizer_ms``.
"""
from __future__ import annotations

import bisect
import dataclasses
import gc
import importlib
import json
import math
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench import weights as W
from perfbench.reference import common

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def settings() -> None:
    """What bitwise replicas need on the card: deterministic kernels, no
    TF32 (``CUBLAS_WORKSPACE_CONFIG`` is set before CUDA starts, by the
    caller)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    # the switch would also fill every new tensor (one launch each)
    torch.utils.deterministic.fill_uninitialized_memory = False


# -- the cell ------------------------------------------------------------------

def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell ``name`` of ``BENCHMARK.json``, with its files read."""
    manifest = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _json(root / configs[w["config"]]["file"])

    def listed(metric):
        return name in metric.get("workloads", [name])

    return SimpleNamespace(
        name=name, chips=w["chips"], model=config["port"], config=config,
        traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in manifest["end_to_end"] if listed(m)],
        per_layer=[m for m in manifest["per_layer"] if listed(m)])


def family_module(kind: str, family: str):
    return importlib.import_module(f"perfbench.{kind}.{family}")


def read_metric(name: str, ctx) -> Optional[float]:
    return importlib.import_module(f"perfbench.metrics.{name}").read(ctx)


# -- the program ---------------------------------------------------------------

MODEL_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                "d_ff", "vocab_size", "ssm_state", "ssm_chunk", "expand",
                "conv_kernel", "attn_every", "sliding_window", "rope_theta",
                "n_experts", "n_experts_per_tok", "capacity_factor",
                "norm_eps", "dtype")


def program_config(m: dict):
    """The program's ``ModelConfig`` for the configuration's ``port``
    section: its arch with every listed size replaced."""
    from repro_torch.configs import get_arch
    cfg = get_arch(m["arch"])
    return dataclasses.replace(
        cfg, **{k: m[k] for k in MODEL_FIELDS if k in m})


def check_program(cfg, m: dict, opt: dict) -> None:
    """Raise unless the program runs what the configuration and traffic
    state: the SSM head width and the optimizer's constants."""
    from repro_torch.optim import adamw
    if m["family"] != cfg.family:
        raise ValueError(f"family {cfg.family} is not {m['family']}")
    if cfg.family == "hybrid":
        from repro_torch.models import mamba2
        if mamba2.dims(cfg)[2] != m["ssm_headdim"]:
            raise ValueError("the program's SSM head width differs")
    ac = adamw.AdamWConfig()
    for key in ("eps", "warmup_steps", "total_steps", "min_lr_frac"):
        if getattr(ac, key) != opt[key]:
            raise ValueError(f"the program's AdamW {key} is "
                             f"{getattr(ac, key)}, not {opt[key]}")
    from repro_torch.configs.base import RunConfig
    for key in ("weight_decay", "beta1", "beta2"):
        if getattr(RunConfig, key) != opt[key]:
            raise ValueError(f"the program's {key} differs")


class Feed:
    """The cell's token batches, a pure function of (seed, step): rows of
    ``seq + 1`` ids, u ** power * (V - 1) for u uniform on [0, 1) (a
    Zipf-like skew to the low ids), tokens the first ``seq`` and labels
    the last. Every step and every row differs."""

    def __init__(self, seed: int, traffic: dict, vocab: int, device):
        self.seed = int(seed) % (1 << 64)
        self.batch, self.seq = traffic["batch"], traffic["seq"]
        self.power = traffic["tokens"]["power"]
        self.vocab, self.device = vocab, device

    def host(self, t: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng([self.seed, int(t)])
        u = rng.random((self.batch, self.seq + 1), dtype=np.float32)
        tok = (u ** self.power * np.float32(self.vocab - 1)).astype(np.int32)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def __call__(self, t: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in self.host(t).items()}


class Driven:
    """The program's ``TrainWorkload`` as the session drives it, with the
    benchmark's hooks around each step call. The first call at a step
    index is the computational slice's, the second the replica's; the
    data cursor is the step index plus ``offset``."""

    def __init__(self, wl, state, offset: int = 0):
        self.wl, self._state, self.offset = wl, state, offset
        self.before: List[Callable] = []
        self.after: List[Callable] = []
        self._calls: Dict[int, int] = {}

    def init_state(self):
        state, self._state = self._state, None
        return state

    def step(self, state, t):
        role = self._calls.get(t, 0)
        self._calls[t] = role + 1
        for fn in self.before:
            fn(t, role, state)
        state, loss = self.wl.step(state, t + self.offset)
        for fn in self.after:
            fn(t, role, state, loss)
        return state, loss


def weights_seed(traffic: dict, seed: int) -> int:
    """The seed of the weights: the traffic's ``weights_seed`` where it
    names one (one draw for every run, so that the router's loads, and
    with them the work of a step, are the same for every seed), else the
    run's own."""
    return traffic.get("weights_seed", seed)


def make_session(traffic: dict, kill_step: int):
    from repro_torch.configs.base import FTConfig
    from repro_torch.ft import FTSession
    from repro_torch.ft.injector import StepKillInjector
    return FTSession(ft=FTConfig(mode=traffic["ft_mode"]),
                     n_logical_workers=traffic["n_logical_workers"],
                     workers_per_node=traffic["workers_per_node"],
                     injector=StepKillInjector(
                         {kill_step: [traffic["kill_worker"]]}))


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def program_setup(cell, seed: int, device, fault: Optional[str] = None):
    """Weights, the program's workload, and the warm-up under the cell's
    FT mode. Returns (Driven over the warmed state, the compared
    readings, ms a session step in the warm-up's last step)."""
    from repro_torch.launch.train import build_workload
    m, tr = cell.model, cell.traffic
    opt, wu = tr["optimizer"], tr["warmup"]
    cfg = program_config(m)
    check_program(cfg, m, opt)
    spec = W.layout(cfg)
    params, bufs = W.draw(spec, weights_seed(tr, seed), device)
    start = {k: b.clone() for k, b in bufs.items()}
    p0 = {}
    for name, t in params.items():
        base = start[str(t.dtype)]
        p0[name] = base.as_strided(t.shape, t.stride(), t.storage_offset())
    from repro_torch.optim import adamw
    state = {"params": params, "opt": adamw.init(params)}
    del params, bufs
    wl = build_workload(cfg, reduced=False, batch=tr["batch"], seq=tr["seq"],
                        seed=seed, lr=opt["lr"], device=device)
    wl.batch_fn = Feed(seed, tr, cfg.vocab_size, device)
    wl.init_state_fn = None
    plant(fault, wl)
    driven = Driven(wl, state)
    del state
    compared = wu["compared_steps"]
    read = {"losses": [None] * compared}
    timing = {}
    cuda = torch.device(device).type == "cuda"

    def after(t, role, state, loss):
        if role == 0 and t < compared:
            read["losses"][t] = loss
        if role == 0 and t == 0:
            ms = state["opt"].m
            read["grad_norms"] = common.leaf_norms(
                list(ms), ms.__getitem__, 1.0 / (1.0 - opt["beta1"]))
        if role == 0 and t == compared - 1:
            ps = state["params"]
            read["change_norms"] = common.leaf_norms(
                list(p0), lambda k: ps[k].float() - p0[k].float())
            p0.clear()
            start.clear()
        if cuda and t == wu["steps"] - 1 and role == 1:
            timing["end"] = _event()

    def before(t, role, state):
        if cuda and t == wu["steps"] - 1 and role == 0:
            timing["start"] = _event()

    driven.before.append(before)
    driven.after.append(after)
    session = make_session(tr, wu["kill_step"])
    rep = session.run(driven, wu["steps"])
    if rep.promotions != 1:
        raise RuntimeError(f"warm-up promoted {rep.promotions} times")
    driven._state = rep.final_state
    del rep, session
    driven.before.clear()
    driven.after.clear()
    driven._calls.clear()
    driven.offset = wu["steps"]
    read["losses"] = [float(x) for x in read["losses"]]
    if cuda:
        torch.cuda.synchronize()
    step_ms = timing["start"].elapsed_time(timing["end"]) if cuda else None
    return driven, read, step_ms


FAULTS = ("unchanged", "half_batch", "grad_altered", "no_decay",
          "betas_swapped")


def plant(fault: Optional[str], wl) -> None:
    """Break the program's timed path for the check's own tests:
    ``unchanged`` (a step leaves the state as it was), ``half_batch``
    (the step sees the first half of the rows, the mean over them),
    ``grad_altered`` (the largest gradient leaf doubled where the
    optimizer receives it), ``no_decay`` (AdamW without its weight
    decay), ``betas_swapped`` (AdamW's two betas exchanged)."""
    if fault is None:
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault == "half_batch":
        feed = wl.batch_fn
        wl.batch_fn = lambda t: {k: v[:max(1, v.shape[0] // 2)]
                                 for k, v in feed(t).items()}
        return
    from repro_torch.optim import adamw
    real = adamw.update

    def update(cfg, grads, state, params):
        if fault == "unchanged":
            return state
        if fault == "no_decay":
            return real(dataclasses.replace(cfg, weight_decay=0.0), grads,
                        state, params)
        if fault == "betas_swapped":
            return real(dataclasses.replace(cfg, beta1=cfg.beta2,
                                            beta2=cfg.beta1),
                        grads, state, params)
        name = max(grads, key=lambda k: grads[k].numel())
        grads = dict(grads)
        grads[name] = grads[name] * 2
        return real(cfg, grads, state, params)

    adamw.update = update
    wl._restore_update = real


# -- the window ----------------------------------------------------------------

def window_steps(seconds: float, step_ms: Optional[float], minimum: int = 4):
    if not step_ms:
        return minimum
    return max(minimum, int(round(1e3 * seconds / step_ms)))


def kill_step(seed: int, n: int, traffic: dict) -> int:
    lo_f, hi_f = traffic["kill_window"]
    lo = max(1, int(n * lo_f))
    hi = max(lo + 1, min(n - 1, int(math.ceil(n * hi_f))))
    rng = np.random.default_rng([int(seed) % (1 << 64), 1])
    return int(rng.integers(lo, hi))


class Trace:
    """The traced run's instruments: CUDA events around each step call
    and each ``adamw.update``, and the profiler over steps ``lo..hi``."""

    def __init__(self, lo: int, hi: int):
        from repro_torch.optim import adamw
        self.lo, self.hi = lo, hi
        self.calls, self.updates, self.paused = [], [], []
        self.prof = self.marker = None
        self.profiling = False
        self._adamw, self._real = adamw, adamw.update

        def update(*args, **kwargs):
            with torch.profiler.record_function("perfbench.adamw.update"):
                ev0 = _event()
                out = self._real(*args, **kwargs)
                if not self.profiling:
                    self.updates.append((ev0, _event()))
            return out

        adamw.update = update
        self._rf = {}

    def restore(self):
        self._adamw.update = self._real

    def before(self, t, role, state):
        if t == self.lo and role == 0:
            for fn in _wrappers().values():
                fn.calls.clear()
            pause = _event()
            torch.cuda.synchronize()
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
            self.marker = torch.profiler.record_function("perfbench.window")
            self.marker.__enter__()
            self.paused.append((pause, _event()))
            self.profiling = True
        rf = torch.profiler.record_function(
            "perfbench.step." + ("cmp" if role == 0 else "replica"))
        rf.__enter__()
        self._rf[(t, role)] = rf
        self.calls.append([t, role, _event(), None])

    def after(self, t, role, state, loss):
        self.calls[-1][3] = _event()
        self._rf.pop((t, role)).__exit__(None, None, None)
        if t == self.hi and role == 1:
            pause = _event()
            torch.cuda.synchronize()
            self.marker.__exit__(None, None, None)
            self.prof.stop()
            self.tallies = {k: dict(fn.calls)
                            for k, fn in _wrappers().items()}
            self.profiling = False
            self.paused.append((pause, _event()))


def _wrappers() -> Dict[str, Callable]:
    """The program's kernel wrappers, by ``work/cost.py``'s names; each
    tallies its launches in ``calls`` by the cost's arguments."""
    from repro_torch.kernels import flash_attention, mamba_scan, rmsnorm
    return {"rmsnorm": rmsnorm.rmsnorm, "add_rmsnorm": rmsnorm.add_rmsnorm,
            "rmsnorm_bwd": rmsnorm.rmsnorm_bwd,
            "add_rmsnorm_bwd": rmsnorm.add_rmsnorm_bwd,
            "attention": flash_attention.flash_attention,
            "attention_bwd": flash_attention.flash_attention_bwd,
            "mamba_scan": mamba_scan.mamba_chunk_scan,
            "mamba_scan_bwd": mamba_scan.mamba_chunk_scan_bwd}


def run_window(cell, seed: int, seconds: float, driven, step_ms, trace: bool,
               t_start: float, device) -> SimpleNamespace:
    """The measured window. Returns what the metrics read."""
    tr = cell.traffic
    n = window_steps(seconds, step_ms)
    k = kill_step(seed, n, tr)
    cuda = torch.device(device).type == "cuda"
    win = SimpleNamespace(steps=n, kill_step=k, losses=None)
    compared = Compared(n - 1, seed, cuda)
    driven.before.append(compared.before)
    tracer = None
    if trace and cuda:
        # the profiled steps: after the promotion, short of the compared one
        p = tr["profile_steps"]
        lo, hi = k + 1, min(n - 2, k + p)
        if lo > hi:
            lo, hi = max(0, k - p), k - 1
        tracer = Trace(lo, hi)
        driven.before.append(tracer.before)
        driven.after.append(tracer.after)
    driven.after.append(compared.after)

    def opened(t, role, state):
        if t == 0 and role == 0:
            win.setup_s = time.time() - t_start
            if cuda:
                torch.cuda.reset_peak_memory_stats()
                win.start = _event()
            win.host0 = time.perf_counter()

    driven.before.insert(0, opened)
    session = make_session(tr, k)
    try:
        rep = session.run(driven, n)
    finally:
        if tracer is not None:
            tracer.restore()
    if cuda:
        end = _event()
        torch.cuda.synchronize()
        win.window_s = win.start.elapsed_time(end) / 1e3
        win.peak_bytes = torch.cuda.max_memory_allocated()
    else:
        win.window_s = time.perf_counter() - win.host0
        win.peak_bytes = None
    win.window_s -= compared.pause_ms / 1e3
    win.compared = compared
    win.promotions = rep.promotions
    win.losses = [float(x) for x in rep.metrics]
    win.tokens = n * tr["batch"] * tr["seq"]
    if tracer is not None:
        _read_trace(win, tracer)
    del rep, session
    driven.before.clear()
    driven.after.clear()
    return win


def _read_trace(win, tracer: Trace) -> None:
    """Spans and updates as ms on the card's timeline from the window's
    start; the profiled sub-window's device intervals."""
    start = win.start
    win.spans = [(t, role, start.elapsed_time(e0), start.elapsed_time(e1))
                 for t, role, e0, e1 in tracer.calls]
    win.optimizer_ms = [e0.elapsed_time(e1) for e0, e1 in tracer.updates]
    win.paused_ms = sum(e0.elapsed_time(e1) for e0, e1 in tracer.paused)
    win.profiled = (tracer.lo, tracer.hi)
    win.profile = summarize_profile(tracer.prof, tracer.hi - tracer.lo + 1)
    win.profile.tallies = tracer.tallies


def summarize_profile(prof, steps: int) -> SimpleNamespace:
    """Device intervals of the ``perfbench.window`` span: busy seconds
    (their union), kernel time by name, and the idle gaps labelled by the
    innermost host event around each."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    mark = next(e for e in events if e.name == "perfbench.window")
    w0, w1 = mark.time_range.start, mark.time_range.end
    dev, host = [], []
    for e in events:
        lo, hi = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # a record_function also shows on the device's timeline, as a
            # span over the kernels inside it: no device work of its own
            if getattr(e, "is_user_annotation", False) or \
                    e.name.startswith("perfbench."):
                continue
            lo, hi = max(lo, w0), min(hi, w1)
            if hi > lo:
                dev.append((lo, hi, e.name))
        elif e is not mark and hi > w0 and lo < w1:
            host.append((lo, hi, e.name))
    dev.sort()
    busy, gaps, cur_lo, cur_hi = 0.0, [], None, w0
    for lo, hi, _ in dev:
        if cur_lo is None or lo > cur_hi:
            if cur_lo is not None:
                busy += cur_hi - cur_lo
            if lo > cur_hi:
                gaps.append((cur_hi, lo))
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_lo is not None:
        busy += cur_hi - cur_lo
    if w1 > cur_hi:
        gaps.append((cur_hi, w1))
    by_name: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for lo, hi, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (hi - lo) / 1e6
        counts[name] = counts.get(name, 0) + 1
    host.sort()
    starts = [h[0] for h in host]
    labelled: Dict[str, float] = {}
    for lo, hi in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        mid = 0.5 * (lo + hi)
        best = None
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            h = host[j]
            if h[1] >= mid:
                best = h[2]
                break
            if mid - h[0] > 5e6:            # no host event spans 5 s
                break
        label = best or "(no host event)"
        labelled[label] = labelled.get(label, 0.0) + (hi - lo) / 1e6
    return SimpleNamespace(
        window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6, steps=steps,
        kernels=by_name, counts=counts,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=sorted(labelled.items(), key=lambda kv: -kv[1])[:10])


# -- the window's compared step ------------------------------------------------

SAMPLE = 1 << 18        # elements of a unit that the compared step reads
MOVING = 0.1            # share of a unit's sample that has to move


def sample(params: Dict[str, torch.Tensor], seed: int) -> Dict[str, list]:
    """{parameter: [(unit, flat indices into the parameter)]} over the
    ``common.units`` of each: every element of a unit of at most
    ``SAMPLE``, else ``SAMPLE`` of them drawn from the seed."""
    gen = torch.Generator().manual_seed((int(seed) ^ 0x5A17) % (1 << 63))
    out = {}
    for name, t in params.items():
        rows = []
        for i, (unit, u) in enumerate(common.units(name, t)):
            n = u.numel()
            idx = torch.arange(n) if n <= SAMPLE else \
                torch.randint(n, (SAMPLE,), generator=gen).sort().values
            rows.append((unit, idx + i * n))
        out[name] = rows
    return out


class Compared:
    """The window's step ``t`` (its last, on the promoted state), read for
    the check: just before the computational slice's call, its whole
    params and, at ``sample``'s elements of each unit, its params and both
    moments go to the host; just after the call, those elements again,
    and the step's loss. Each copy is a pause, timed (CUDA events on the
    card) and taken out of the window's time: it is the check's work, not
    the program's."""

    def __init__(self, t: int, seed: int, cuda: bool):
        self.t, self.seed, self.cuda = t, seed, cuda
        self.params = self.index = self.before_step = self.after_step = None
        self.loss = None
        self.pause_ms = 0.0

    def _read(self, state) -> Dict[str, tuple]:
        ps, opt = state["params"], state["opt"]
        out = {}
        for name, rows in self.index.items():
            idx = torch.cat([i for _, i in rows]).to(ps[name].device)
            vals = [x.view(-1).index_select(0, idx).float().cpu()
                    for x in (ps[name], opt.m[name], opt.v[name])]
            at = 0
            for unit, i in rows:
                out[unit] = tuple(v[at:at + i.numel()] for v in vals)
                at += i.numel()
        return out

    def _pause(self, copy: Callable) -> None:
        if self.cuda:
            e0 = _event()
            copy()
            e1 = _event()
            torch.cuda.synchronize()
            self.pause_ms += e0.elapsed_time(e1)
        else:
            h0 = time.perf_counter()
            copy()
            self.pause_ms += 1e3 * (time.perf_counter() - h0)

    def before(self, t, role, state):
        if t != self.t or role != 0:
            return

        def copy():
            ps = state["params"]
            self.index = sample(ps, self.seed)
            self.params = {k: p.detach().to("cpu", copy=True)
                           for k, p in ps.items()}
            self.before_step = self._read(state)

        self._pause(copy)

    def after(self, t, role, state, loss):
        if t != self.t or role != 0:
            return

        def copy():
            self.after_step = self._read(state)
            self.loss = float(loss)

        self._pause(copy)


def adamw_sample(opt: dict, step: int, before: Dict[str, tuple],
                 grads: Dict[str, torch.Tensor], stored: Dict[str, bool],
                 fault: Optional[str] = None) -> Dict[str, tuple]:
    """AdamW step ``step`` at the sample, as ``common.train`` takes it:
    {unit: (params, m, v) after it}; a unit whose parameter is stored in
    bf16 (``stored``) is rounded to bf16. ``fault`` (in the reference put
    in the program's place): ``unchanged``, ``no_decay``,
    ``betas_swapped``."""
    b1, b2, eps, wd = opt["beta1"], opt["beta2"], opt["eps"], \
        opt["weight_decay"]
    if fault == "betas_swapped":
        b1, b2 = b2, b1
    if fault == "no_decay":
        wd = 0.0
    lr = common.lr_at(opt, step)
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    out = {}
    for unit, (p, m, v) in before.items():
        if fault == "unchanged":
            out[unit] = (p, m, v)
            continue
        g = grads[unit]
        m1 = m * b1 + g * (1 - b1)
        v1 = v * b2 + g * g * (1 - b2)
        p1 = p - lr * ((m1 / bc1) / ((v1 / bc2).sqrt() + eps) + wd * p)
        if stored[unit]:
            p1 = p1.to(torch.bfloat16).float()
        out[unit] = (p1, m1, v1)
    return out


def window_reference(cell, seed: int, cmp: Compared, device,
                     matmul: str = "f32") -> dict:
    """The plain reference's take of the window's compared step, from the
    state the program held before it (its params whole, its moments at
    the sample) and on the same batch: the loss, the gradient at the
    sample (``g``) and the params and moments after the update there
    (``after``). It follows the program from the program's own state; the
    warm-up's compared steps check the start from the seed."""
    m, tr = cell.model, cell.traffic
    batch = Feed(seed, tr, m["vocab_size"], device)(
        tr["warmup"]["steps"] + cmp.t)
    ref = family_module("reference", m["family"])
    leaves = {k: p.to(device).float().requires_grad_(True)
              for k, p in cmp.params.items()}
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        loss = ref.loss(m, leaves, batch, common.MATMULS[matmul])
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
    finally:
        torch.use_deterministic_algorithms(before)
    names = list(leaves)
    del leaves
    g = {}
    for name, grad in zip(names, grads):
        rows = cmp.index[name]
        idx = torch.cat([i for _, i in rows]).to(grad.device)
        vals = grad.reshape(-1).index_select(0, idx).cpu()
        at = 0
        for unit, i in rows:
            g[unit] = vals[at:at + i.numel()]
            at += i.numel()
    del grads
    out = {"loss": float(loss.detach()), "g": g}
    return compared_update(cell, cmp, out)


def compared_update(cell, cmp: Compared, ref: dict,
                    fault: Optional[str] = None) -> dict:
    """``ref`` with ``after``: its AdamW step at the sample (``fault``
    planted in it, or ``grad_altered``: the largest parameter's gradient
    doubled)."""
    g = dict(ref["g"])
    if fault == "grad_altered":
        name = max(cmp.params, key=lambda k: cmp.params[k].numel())
        for unit, _ in cmp.index[name]:
            g[unit] = g[unit] * 2
        fault = None
    stored = {unit: cmp.params[name].dtype == torch.bfloat16
              for name, rows in cmp.index.items() for unit, _ in rows}
    step = cell.traffic["warmup"]["steps"] + cmp.t + 1
    return {**ref, "g": g, "after": adamw_sample(
        cell.traffic["optimizer"], step, cmp.before_step, g, stored, fault)}


def _median(values) -> float:
    values = list(values)
    return statistics.median(values) if values else math.nan


def window_gaps(cell, cmp: Compared, prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers of the window's compared step, ``prog`` (the program's
    loss and params and moments after the step, at the sample) against
    ``ref`` (``window_reference``). Per unit: the gradient the program
    used, (m' - b1 m) / (1 - b1), and its square, (v' - b2 v) / (1 - b2),
    each by the gap of its norm from the reference's over the larger of
    the reference's norm and the median over the units whose reference
    gradient is not 0 (``window_grad_gap``,
    ``window_sq_gap``: the worst unit); on the units where the reference
    moves at least ``MOVING`` of the sample, the slope of the program's
    change on the reference's (``window_update_gap``: |1 - slope|) and
    the slope of the program's params after the step less the
    reference's on the params before it, in units of lr x weight decay
    (``window_decay_gap``: 1 where the decay is left out); the ``median_``
    numbers are the median unit's. The moments' differences are taken in
    f32, the program's precision, so that an element the step did not
    touch reads 0; the norms and slopes are summed in f64."""
    opt = cell.traffic["optimizer"]
    b1, b2 = opt["beta1"], opt["beta2"]
    step = cell.traffic["warmup"]["steps"] + cmp.t + 1
    decay = common.lr_at(opt, step) * opt["weight_decay"]
    norms = {k: {} for k in ("gp", "gr", "qp", "qr")}
    upd, dec = {}, {}
    for unit, (p0, m0, v0) in cmp.before_step.items():
        p1, m1, v1 = prog["after"][unit]
        gp = ((m1 - m0 * b1) / (1 - b1)).double()
        qp = ((v1 - v0 * b2) / (1 - b2)).double()
        p0, p1 = p0.double(), p1.double()
        r1 = ref["after"][unit][0].double()
        g = ref["g"][unit].double()
        norms["gp"][unit] = float(gp.norm())
        norms["gr"][unit] = float(g.norm())
        norms["qp"][unit] = float(qp.norm())
        norms["qr"][unit] = float((g * g).norm())
        dr = p0 - r1
        if float((dr != 0).double().mean()) >= MOVING:
            upd[unit] = abs(1 - float(((p0 - p1) * dr).sum()
                                      / (dr * dr).sum()))
            dec[unit] = abs(float(((p1 - r1) * p0).sum() / (p0 * p0).sum())
                            / decay)

    def gap(p, r):
        # an expert that the router gave no token has no gradient: the
        # median is the median of the units that have one
        base = statistics.median([x for x in r.values() if x > 0] or [1.0])
        return {k: abs(p[k] - r[k]) / max(r[k], base) for k in r}

    grad, sq = gap(norms["gp"], norms["gr"]), gap(norms["qp"], norms["qr"])
    # the units that read worst, with their norms, for the run's record
    cmp.worst_units = {
        name: [(k, by[k], norms[a][k], norms[b][k]) for k in
               sorted(by, key=by.get)[-3:]]
        for name, by, a, b in (("grad", grad, "gp", "gr"),
                               ("sq", sq, "qp", "qr"))}
    out = {"window_loss_gap": abs(prog["loss"] - ref["loss"]),
           "window_grad_gap": max(grad.values()),
           "median_window_grad_gap": statistics.median(grad.values()),
           "window_sq_gap": max(sq.values()),
           "median_window_sq_gap": statistics.median(sq.values())}
    for name, by in (("window_update_gap", upd), ("window_decay_gap", dec)):
        out[name] = max(by.values()) if by else math.nan
        out["median_" + name] = _median(by.values())
    return out


# -- the check -----------------------------------------------------------------

def reference_readings(cell, seed: int, device, matmul: str = "f32",
                       fault: Optional[str] = None) -> dict:
    """The plain reference's readings from the same weights and batches:
    ``compared_steps`` steps of AdamW in f32 (``matmul="fp8"``: the
    control)."""
    m, tr = cell.model, cell.traffic
    cfg = program_config(m)
    spec = W.layout(cfg)
    params, bufs = W.draw(spec, weights_seed(tr, seed), device)
    f32 = {k: t.float() for k, t in params.items()}
    stored = {k: t.dtype for k, t in params.items()}
    del params, bufs
    feed = Feed(seed, tr, m["vocab_size"], device)
    batches = [feed(t) for t in range(tr["warmup"]["compared_steps"])]
    ref = family_module("reference", m["family"])
    mm = common.MATMULS[matmul]
    # the reference's float cumsum has no deterministic CUDA kernel
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        return common.train(lambda p, b: ref.loss(m, p, b, mm), f32, stored,
                            batches, tr["optimizer"], fault=fault)
    finally:
        torch.use_deterministic_algorithms(before)


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers the check can compare; ``limits/<cell>.json`` names
    those it does. loss_gap: the largest |program loss - reference loss|
    over the compared steps; early_loss_gap: the same but for the last
    step. grad_gap and change_gap: over the leaves, the largest gap
    between the program's norm and the reference's, over the larger of
    the reference's norm of that leaf and of the median leaf (the
    ``median_`` numbers: the median leaf's gap); the change leaves out the
    leaves whose reference gradient is under a thousandth of the median
    leaf's (they move by round-off alone)."""
    loss = [abs(a - b) for a, b in zip(prog["losses"], ref["losses"])]
    gr = ref["grad_norms"]
    med = statistics.median(gr.values())

    def each(p, r, names):
        base = statistics.median(r[k] for k in names)
        return [abs(p[k] - r[k]) / max(r[k], base, 1e-30) for k in names]

    moving = [k for k in gr if gr[k] >= 1e-3 * med]
    grad = each(prog["grad_norms"], gr, list(gr))
    change = each(prog["change_norms"], ref["change_norms"], moving)
    return {"loss_gap": max(loss), "early_loss_gap": max(loss[:-1]),
            "grad_gap": max(grad), "change_gap": max(change),
            "median_grad_gap": statistics.median(grad),
            "median_change_gap": statistics.median(change)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that ``limits`` names is finite and within it."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= lim
               for k, lim in limits.items())


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def check_numbers(cell, seed: int, device, prog: dict, cmp: Compared,
                  kinds=()):
    """({"program": the program's numbers} and, for each of ``kinds``, the
    same numbers of ``control_fp8`` (the reference with fp8 products) or
    of a fault of ``FAULTS`` planted in the reference, each in the
    program's place and against the f32 reference; the reference's
    losses of the warm-up's compared steps and of the window's)."""
    ref = reference_readings(cell, seed, device)
    wref = window_reference(cell, seed, cmp, device)
    mine = {"loss": cmp.loss, "after": cmp.after_step}
    out = {"program": {**gaps(prog, ref),
                       **window_gaps(cell, cmp, mine, wref)}}
    for kind in kinds:
        if kind == "control_fp8":
            warm = reference_readings(cell, seed, device, matmul="fp8")
            other = window_reference(cell, seed, cmp, device, matmul="fp8")
        else:
            warm = reference_readings(cell, seed, device, fault=kind)
            other = compared_update(cell, cmp, wref, kind)
        out[kind] = {**gaps(warm, ref), **window_gaps(cell, cmp, other, wref)}
    return out, ref["losses"] + [wref["loss"]]


def run(cell, seed: int, seconds: float, trace: bool, *, t_start: float,
        device="cuda", fault: Optional[str] = None, kinds=()) -> dict:
    """One run of ``cell``: the result line's dict, and the checks
    (``kinds``: the other readings ``check_numbers`` takes, for the
    calibration)."""
    driven, prog, step_ms = program_setup(cell, seed, device, fault)
    win = run_window(cell, seed, seconds, driven, step_ms, trace, t_start,
                     device)
    restore = getattr(driven.wl, "_restore_update", None)
    if restore is not None:
        from repro_torch.optim import adamw
        adamw.update = restore
    del driven
    free(device)
    ctx = SimpleNamespace(cell=cell, model=cell.model, traffic=cell.traffic,
                          work=family_module("work", cell.model["family"]),
                          kernel_names=_json(HERE / "work" / "kernels.json"),
                          win=win)
    metrics = {}
    for spec in (cell.per_layer if trace else cell.end_to_end):
        val = read_metric(spec["name"], ctx)
        if val is not None:
            metrics[spec["name"]] = {"value": val, "unit": spec["unit"]}
    t_ref = time.perf_counter()
    readings, ref_losses = check_numbers(cell, seed, device, prog,
                                         win.compared, kinds)
    numbers = readings["program"]
    limits = cell.limits["compare"]
    failed = sum(not math.isfinite(x) for x in win.losses)
    ok = judge(numbers, limits) and win.promotions == 1 and failed == 0
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    checks["promotions"] = {"value": win.promotions, "limit": 1}
    out = {"correct": bool(ok), "attempted": win.steps, "failed": failed,
           "metrics": metrics}
    if trace and hasattr(win, "profile"):
        out["breakdown"] = {"device_ops": win.profile.device_ops,
                            "idle_gaps": win.profile.idle_gaps}
        from perfbench.metrics import _roofline
        win.launches = {k: [_roofline.seen(ctx, (k,)),
                            _roofline.expected(ctx, (k,))]
                        for k in ctx.kernel_names if k != "why"}
    return {"result": out, "checks": checks, "numbers": numbers, "win": win,
            "prog": prog, "readings": readings, "ref_losses": ref_losses,
            "reference_s": time.perf_counter() - t_ref}
