"""The port's hybrid training against the JAX package's, on the CPU, at the
reduced zamba2-7b (7 Mamba blocks: two groups of 3 behind the shared
attention block and a tail of 1; d 128, d_inner 256, 4 SSM heads of 64,
N 16, chunk 16; 4 attention heads of 32; vocab 512), with the reference's
weights carried over by ``convert.params_from_jax``: the loss and every
parameter's gradient, a five-step trajectory against the reference's own
workload, the FT theorem for training (promotion, pair-death restart from
disk, pure checkpoint, the combined mode on the in-memory store) on the
port's hybrid, whose final state must equal its clean run bitwise and whose
counters must equal the reference's, checkpoints restored across the two
packages bitwise, and the train CLI.

The hybrid's ``checkpoint`` schedule runs here only: on the card
(``chip_smoke.py``) its ~4 saves and a restore of the 14.5 GB state would
not fit the script's time limit.

Tolerances and why:
  * gradients, f32 config: 2e-5 of each leaf's largest |grad| (the f32
    Mamba block's F32_ALGO in ``tests/test_torch_mamba.py``), with the
    reference's two bf16 casts patched out for this test only (F5, the
    scan's score tile and x, ``repro/models/mamba2.py:138-140``, by
    ``test_torch_mamba.f32_scan``; F6, the softmax weights,
    ``repro/models/layers.py:108``, by ``test_torch_train.
    _online_update_f32``): the same f32 gradient in another order of sums
    (the port differentiates the exact per-step recurrence, the reference
    its chunked scan); measured 7.4e-6;
  * gradients, bf16 config: with both casts patched out, 6e-2 of each
    leaf's largest |grad|, as the bf16 Mamba block's forward is held
    (``tests/test_torch_mamba.py``'s BF16: bf16 roundings at other places
    in the two frameworks; measured 4.2e-2); with the reference as it
    stands, 0.2 (its bf16 softmax weights and score tile, and their
    gradients, rounded where the port keeps f32; measured 0.14, on the
    stacked C projection);
  * trajectory, bf16: each loss within 2e-3 relative; m and v within the
    as-is bf16 gradient tolerance (0.2 of each leaf's largest: the moments
    are sums of those gradients; measured 0.091), params within one bf16
    rounding or twice
    the summed lr (the dense family's rule, ``tests/test_torch_train.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.models.layers as JL
import repro.models.mamba2 as JM2
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import RunConfig as JRunConfig
from repro.configs import get_arch as jget_arch
from repro.configs.base import FTConfig as JFTConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import DataConfig as JDataConfig
from repro.data import TokenSource as JTokenSource
from repro.launch.step_fns import make_model as jmake_model
from repro.launch.train import build_trainer as jbuild_trainer
from repro.launch.train import build_workload as jbuild_workload
from repro.optim.adamw import AdamWState as JAdamWState
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_arch
from repro_torch.configs.base import FTConfig
from repro_torch.kernels.mamba_scan import (mamba_chunk_scan,
                                            mamba_chunk_scan_bwd)
from repro_torch.launch import train
from repro_torch.models import convert, zamba
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWState
from repro_torch.store.backend import DiskBackend, MemBackend
from test_torch_mamba import _Float32Jnp
from test_torch_mamba import f32_scan  # noqa: F401  (a fixture)
from test_torch_train import _online_update_f32

B, S, STEPS = 4, 32, 12
ARCH = "zamba2-7b"
CFG = get_arch(ARCH).reduced()


def _f32(x):
    x = np.asarray(x)
    if x.dtype == np.uint16:
        x = x.view(ml_dtypes.bfloat16)
    return x.astype(np.float32)


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU the scan's wrappers never launch."""
    mamba_chunk_scan.launches = mamba_chunk_scan_bwd.launches = 0
    yield
    assert mamba_chunk_scan.launches == mamba_chunk_scan_bwd.launches == 0


def test_reduced_config_exercises_both_stacks_and_the_tail():
    assert CFG.family == "hybrid" and CFG.n_layers == 7
    assert (CFG.n_layers // CFG.attn_every, CFG.n_layers % CFG.attn_every) \
        == (2, 1)


# ---------------------------------------------------------- the gradients

def _jax_run(dtype):
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(), dtype=dtype)
    return JRunConfig(model=jcfg, shape=JShapeConfig("t", seq_len=S,
                                                    global_batch=B,
                                                    kind="train"),
                      remat="none", seq_chunk=S, kv_block=S)


def _grad_gaps(dtype):
    """The port's loss and each gradient leaf against ``jax.value_and_grad``
    of the reference's ``Zamba.loss_fn``, from the reference's init:
    (port loss, reference loss, {path: (max gap, largest |ref grad|)})."""
    model = jmake_model(_jax_run(dtype))
    params = model.init(jax.random.key(0))
    batch = JTokenSource(JDataConfig(CFG.vocab_size, S, B, 0)).host_batch_at(3)
    want, jgrads = jax.jit(jax.value_and_grad(model.loss_fn))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = dataclasses.replace(CFG, dtype=dtype)
    sd = convert.params_from_jax(jax.device_get(params), cfg, "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in sd.items()}
    loss = zamba.loss_fn(cfg, leaves, {k: torch.from_numpy(v.copy())
                                       for k, v in batch.items()},
                         seq_chunk=S)
    assert loss.dtype == torch.float32 and loss.shape == ()
    grads = convert.params_to_jax(dict(zip(
        leaves, torch.autograd.grad(loss, list(leaves.values())))))
    paths = jax.tree_util.tree_flatten_with_path(jax.device_get(jgrads))[0]
    assert len(paths) == len(convert.stack_plan(sd))
    gaps = {}
    for path, g in paths:
        node = grads
        for k in path:
            node = node[k.key]
        want_g, got_g = _f32(g), _f32(node)
        assert got_g.shape == want_g.shape, path
        gaps[jax.tree_util.keystr(path)] = (
            float(np.abs(got_g - want_g).max()), float(np.abs(want_g).max()))
    return loss.item(), float(want), gaps


def test_f32_loss_and_every_gradient_match(f32_scan, monkeypatch):  # noqa: F811
    monkeypatch.setattr(JL, "_online_update", _online_update_f32)
    got, want, gaps = _grad_gaps("float32")
    np.testing.assert_allclose(got, want, rtol=1e-6)
    worst = max(gap / scale for gap, scale in gaps.values())
    print(f"f32 hybrid gradients: worst gap {worst:.3g} of the leaf's "
          f"largest")
    for path, (gap, scale) in gaps.items():
        assert scale > 0 and gap <= 2e-5 * scale, (path, gap, scale)


@pytest.mark.parametrize("casts,tol", [("patched", 6e-2), ("as-is", 0.2)])
def test_bf16_loss_and_every_gradient_match(casts, tol, monkeypatch):
    if casts == "patched":
        monkeypatch.setattr(JM2, "jnp", _Float32Jnp())
        monkeypatch.setattr(JL, "_online_update", _online_update_f32)
    got, want, gaps = _grad_gaps("bfloat16")
    np.testing.assert_allclose(got, want, rtol=2e-3)
    worst = max(gap / scale for gap, scale in gaps.values())
    print(f"bf16 hybrid gradients, casts {casts}: worst gap {worst:.3g} of "
          f"the leaf's largest")
    for path, (gap, scale) in gaps.items():
        assert scale > 0 and gap <= tol * scale, (path, gap, scale)


# ------------------------------------------------------------- trajectory

@pytest.fixture(scope="module")
def jax_workload():
    """The reference's train workload (reduced zamba2-7b, bf16), built and
    compiled once for the module."""
    return jbuild_workload(ARCH, reduced=True, batch=B, seq=S, seed=0)


def _state_gaps(port_state, jstate):
    """The port's final train state against the reference's: ``step`` as
    ints, and for params, m and v the largest |port - reference| of each
    leaf, with the reference leaf (f32)."""
    got = convert.train_state_to_jax(port_state)
    want = jax.device_get(jstate)
    jopt = want["opt"]
    steps = (int(got["opt"][0]), int(jopt.step))
    gaps = {}
    for part, g_tree, w_tree in (("params", got["params"], want["params"]),
                                 ("m", got["opt"][1], jopt.m),
                                 ("v", got["opt"][2], jopt.v)):
        for path, w in jax.tree_util.tree_flatten_with_path(w_tree)[0]:
            node = g_tree
            for k in path:
                node = node[k.key]
            w32, g32 = _f32(w), _f32(node)
            assert g32.shape == w32.shape, (part, path)
            gaps[(part, jax.tree_util.keystr(path))] = (
                np.abs(g32 - w32), w32)
    return steps, gaps


def test_five_step_trajectory_matches_the_reference(jax_workload):
    jstate = jax_workload.init_state()
    jparams = jax.device_get(jstate["params"])
    wl = train.build_workload(ARCH, batch=B, seq=S, seed=0, device="cpu",
                              jax_params=jparams)
    state = wl.init_state()
    want, got = [], []
    for t in range(5):
        jstate, jl = jax_workload.step(jstate, t)
        state, loss = wl.step(state, t)
        want.append(float(jl))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=2e-3)
    assert len(set(got)) == 5
    steps, gaps = _state_gaps(state, jstate)
    assert steps == (5, 5)
    lrs = 2 * sum(float(adamw.schedule(adamw.AdamWConfig(lr=1e-3), t))
                  for t in range(1, 6))
    worst = {}
    for (part, path), (gap, ref) in gaps.items():
        if part == "params":
            ulp = np.spacing(np.abs(ref).astype(ml_dtypes.bfloat16))
            limit = np.maximum(ulp.astype(np.float32), lrs)
            assert (gap <= limit).all(), path
        else:
            worst[part] = max(worst.get(part, 0.0),
                              float(gap.max() / np.abs(ref).max()))
            assert gap.max() <= 0.2 * np.abs(ref).max(), (part, path)
    print(f"hybrid trajectory: m, v worst gaps {worst}")


# ------------------------------------------------------- the FT theorem

SCHEDULES = {
    "promotion": (dict(mode="replication"), {5: [0]}, True),
    "pair_death": (dict(mode="combined", ckpt_interval_s=4.0),
                   {4: [1], 8: [9]}, True),
    "pure_checkpoint": (dict(mode="checkpoint", ckpt_interval_s=3.0),
                        {7: [2]}, True),
    "combined_memory": (dict(mode="combined", ckpt_interval_s=4.0),
                        {4: [1], 8: [9]}, False),
}
COUNTERS = ("failures", "promotions", "restarts", "ckpt_writes",
            "rolled_back_steps", "steps")


def _state_tensors(state):
    opt = state["opt"]
    return ([("step", opt.step)]
            + [(f"p/{k}", v) for k, v in state["params"].items()]
            + [(f"m/{k}", v) for k, v in opt.m.items()]
            + [(f"v/{k}", v) for k, v in opt.v.items()])


@pytest.fixture(scope="module")
def port_clean():
    tr = train.build_trainer(ARCH, batch=B, seq=S, device="cpu",
                             ft=FTConfig(mode="none"), kill_schedule={})
    return tr.run(STEPS)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_ft_theorem_on_the_port(name, port_clean, jax_workload, tmp_path):
    ft, kills, disk = SCHEDULES[name]
    ckpt = str(tmp_path / "port") if disk else None
    tr = train.build_trainer(ARCH, batch=B, seq=S, device="cpu",
                             ft=FTConfig(**ft), ckpt_dir=ckpt,
                             kill_schedule=kills)
    rep = tr.run(STEPS)
    backend = tr.session.strategy.backend
    if ft["mode"] != "replication":
        assert isinstance(backend, DiskBackend if disk else MemBackend)
    # the f32 a_log, d_skip and dt_bias among the bf16 leaves
    assert {t.dtype for _, t in _state_tensors(rep.final_state)} == \
        {torch.int32, torch.bfloat16, torch.float32}
    for (k, a), (_, b) in zip(_state_tensors(rep.final_state),
                              _state_tensors(port_clean.final_state)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    jtr = jbuild_trainer(ARCH, reduced=True, batch=B, seq=S,
                         ft=JFTConfig(**ft),
                         ckpt_dir=str(tmp_path / "ref") if disk else None,
                         kill_schedule=kills)
    jtr.workload = jax_workload                    # compiled once
    jrep = jtr.run(STEPS)
    assert {c: getattr(rep, c) for c in COUNTERS} == \
        {c: getattr(jrep, c) for c in COUNTERS}
    assert [e.kind for e in rep.events] == [e.kind for e in jrep.events]
    if name == "promotion":
        assert rep.promotions == 1 and rep.restarts == 0
    else:
        assert rep.restarts == 1
    if name in ("pair_death", "combined_memory"):
        assert rep.rolled_back_steps > 0
    assert np.isfinite(rep.losses).all() and len(rep.losses) == \
        STEPS + rep.rolled_back_steps


# ------------------------------------------- checkpoints across packages

@pytest.fixture(scope="module")
def jax_state():
    """A reference hybrid train state: its init (bf16 params, f32 a_log,
    d_skip, dt_bias), numpy-drawn f32 moments, step 7."""
    params = jmake_model(_jax_run("bfloat16")).init(jax.random.key(3))
    rng = np.random.default_rng(0)

    def moment(p):
        return jnp.asarray(rng.normal(size=p.shape).astype(np.float32))
    return {"params": params,
            "opt": JAdamWState(step=jnp.asarray(7, jnp.int32),
                               m=jax.tree.map(moment, params),
                               v=jax.tree.map(moment, params))}


def _port_state(jstate):
    host = jax.device_get(jstate)
    opt = host["opt"]
    return {"params": convert.params_from_jax(host["params"], CFG, "cpu"),
            "opt": AdamWState(step=torch.tensor(int(opt.step),
                                                dtype=torch.int32),
                              m=convert.params_from_jax(opt.m, CFG, "cpu"),
                              v=convert.params_from_jax(opt.v, CFG, "cpu"))}


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


def test_reference_hybrid_save_restored_by_the_port(jax_state, tmp_path):
    JCheckpointer(str(tmp_path)).save(7, jax_state)
    like = _port_state(jax_state)
    zeroed = {"params": {k: torch.zeros_like(v)
                         for k, v in like["params"].items()},
              "opt": AdamWState(torch.zeros((), dtype=torch.int32),
                                {k: torch.zeros_like(v)
                                 for k, v in like["opt"].m.items()},
                                {k: torch.zeros_like(v)
                                 for k, v in like["opt"].v.items()})}
    got, step, extra = Checkpointer(str(tmp_path)).restore(zeroed)
    assert step == 7 and extra == {}
    assert "mamba.1.2.a_log" in got["params"] and \
        "mamba_tail.0.in_x" in got["params"]
    for a, b in zip(_state_tensors(got), _state_tensors(like)):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        assert torch.equal(a[1], b[1]), a[0]


def test_port_hybrid_save_restored_by_the_reference(jax_state, tmp_path):
    Checkpointer(str(tmp_path)).save(7, _port_state(jax_state),
                                     extra={"mode": "combined"})
    like = jax.tree.map(jnp.zeros_like, jax_state)
    got, step, extra = JCheckpointer(str(tmp_path)).restore(like)
    assert step == 7 and extra == {"mode": "combined"}
    want = jax.tree_util.tree_flatten_with_path(jax_state)[0]
    have = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in want] == [p for p, _ in have]
    for (path, a), (_, b) in zip(want, have):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(_bits(a), _bits(b))


# -------------------------------------------------------------- the CLI

def test_train_cli_trains_the_hybrid(tmp_path, capsys):
    rc = train.main(["--arch", ARCH, "--device", "cpu", "--steps", "10",
                     "--seq", "32", "--batch", "4", "--ft-mode", "combined",
                     "--ckpt-interval", "3", "--ckpt-dir",
                     str(tmp_path / "ck"), "--kill", "3:0", "--kill", "6:8"])
    out = capsys.readouterr().out
    assert rc == 0
    for field in ("arch=zamba2-7b", "mode=combined", "steps=10",
                  "failures=2", "promotions=1", "restarts=1", "ckpts=3",
                  "rolled_back=2"):
        assert field in out, out
    assert (tmp_path / "ck" / "LATEST").exists()
