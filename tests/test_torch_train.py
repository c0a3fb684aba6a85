"""The port's training path against the JAX package's, on the CPU, at the
reduced qwen3-8b (d 128, 4 heads of 32, 1 KV head, vocab 512, 4 layers):
the chunked loss, the loss and every parameter's gradient, a five-step
trajectory from the reference's own init, and the FT theorem for training
(promotion, pair-death restart from disk, pure checkpoint, and the
combined mode on the in-memory store) on the port's model, whose final
state must equal the port's clean run bitwise and whose counters must equal
the reference's for the same schedules. The reference's FT-theorem tests
(``tests/test_ft_trainer.py:31-66``) run xlstm-350m reduced at batch 4 x
32; these run it too, under all four schedules, beside the reduced
qwen3-8b and (the promotion, the pure checkpoint) the reduced
whisper-tiny, and hold the port's clean xlstm trajectory against the
reference's own trainer.

Tolerances and why:
  * chunked loss, f32: 1e-6 relative (the same sums in another order);
  * gradients, f32 config: 1e-5 of each leaf's largest |grad|, with the
    reference's bf16 cast of the softmax weights before the PV product
    (``repro/models/layers.py:108``) patched out for this test only (the
    port keeps them in f32, as the TPU kernel does); measured ~1e-6;
  * gradients, bf16 config, reference as it stands: 3e-2 of each leaf's
    largest |grad| (bf16 roundings at other places, the bf16 softmax
    weights); measured ~1.5e-2;
  * trajectory, bf16: each loss within 2e-3 relative; the final m and v
    within 3e-2 of each leaf's largest, params within one bf16 rounding
    or twice the summed lr (see the test);
  * trajectory, f32 with one warmup step: see its test;
  * xlstm's clean 12-step trajectory against the reference's trainer
    (bf16, from the reference's init): each loss within 5e-3 relative;
    params within one bf16 rounding or twice the summed lr (the rule of
    the five-step test; its gradients are held in
    ``tests/test_torch_xlstm.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.models.layers as JL
from repro.configs import RunConfig as JRunConfig
from repro.configs import get_arch as jget_arch
from repro.configs.base import FTConfig as JFTConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import DataConfig as JDataConfig
from repro.data import TokenSource as JTokenSource
from repro.launch.step_fns import make_model as jmake_model
from repro.launch.train import build_trainer as jbuild_trainer
from repro.launch.train import build_workload as jbuild_workload
from repro_torch.configs import get_arch
from repro_torch.configs.base import FTConfig
from repro_torch.core.ft_runtime import FTTrainer, _copy_tree
from repro_torch.ft import TrainReport, TrainWorkload
from repro_torch.launch import train
from repro_torch.launch.step_fns import make_train_step
from repro_torch.configs import RunConfig
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import convert, layers, transformer
from repro_torch.store.backend import DiskBackend, MemBackend
from repro_torch.tree import copy_tree

B, S, STEPS = 4, 32, 12
ARCH = "qwen3-8b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's many small ops (the FT runs
    step whole models a dozen times): the suite runs several workers to a
    machine, and their thread pools would otherwise contend for its
    cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_run(dtype, seq_chunk=512):
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(), dtype=dtype)
    return JRunConfig(model=jcfg, shape=JShapeConfig("t", seq_len=S,
                                                    global_batch=B,
                                                    kind="train"),
                      remat="none", seq_chunk=seq_chunk, kv_block=S)


def _online_update_f32(carry, s, v):
    """The reference's streaming softmax step with p and v kept in f32."""
    m, l, acc = carry
    m_new = jnp.maximum(m, s.max(axis=-1))
    p = jnp.exp(s - m_new[..., None])
    corr = jnp.exp(m - m_new)
    l = l * corr + p.sum(axis=-1)
    pv = jnp.einsum("bhgqk,bkhd->bhgqd", p, v.astype(jnp.float32))
    return m_new, l, acc * corr[..., None] + pv


def _f32(x):
    x = np.asarray(x)
    if x.dtype == np.uint16:
        x = x.view(ml_dtypes.bfloat16)
    return x.astype(np.float32)


# ---------------------------------------------------------------- the loss

@pytest.mark.parametrize("seq_chunk", [16, 12, 64],
                         ids=["even", "remainder", "one-chunk"])
def test_chunked_lm_loss_matches_the_reference(seq_chunk):
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32")
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(), dtype="float32")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    emb = {"embed": rng.normal(size=(cfg.vocab_size, cfg.d_model))
           .astype(np.float32) * 0.1,
           "unembed": rng.normal(size=(cfg.d_model, cfg.vocab_size))
           .astype(np.float32) * 0.1}

    def jloss(xx, ee):
        return JL.chunked_lm_loss(jcfg, ee, xx, jnp.asarray(labels),
                                  seq_chunk)
    want, (jgx, jge) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in emb.items()})
    tx = torch.from_numpy(x).requires_grad_(True)
    te = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in emb.items()}
    got = layers.chunked_lm_loss(cfg, te, tx, torch.from_numpy(labels),
                                 seq_chunk)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    gx, gu = torch.autograd.grad(got, [tx, te["unembed"]])
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(gu.numpy(), np.asarray(jge["unembed"]),
                               rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------- the gradients

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
def test_loss_and_every_gradient_match(dtype, tol, monkeypatch):
    if dtype == "float32":
        monkeypatch.setattr(JL, "_online_update", _online_update_f32)
    run = _jax_run(dtype)
    model = jmake_model(run)
    params = model.init(jax.random.key(0))
    batch = JTokenSource(JDataConfig(512, S, B, 0)).host_batch_at(3)
    want, jgrads = jax.jit(jax.value_and_grad(model.loss_fn))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype=dtype)
    sd = convert.params_from_jax(jax.device_get(params), cfg, "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in sd.items()}
    loss = transformer.loss_fn(cfg, leaves, {
        k: torch.from_numpy(v.copy()) for k, v in batch.items()},
        seq_chunk=S)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(want),
                               rtol=tol if dtype == "bfloat16" else 1e-6)
    grads = convert.params_to_jax(dict(zip(
        leaves, torch.autograd.grad(loss, list(leaves.values())))))
    paths = jax.tree_util.tree_flatten_with_path(jax.device_get(jgrads))[0]
    assert len(paths) == len(convert.stack_plan(sd))
    for path, g in paths:
        node = grads
        for k in path:
            node = node[k.key]
        want_g, got_g = _f32(g), _f32(node)
        assert got_g.shape == want_g.shape
        scale = np.abs(want_g).max()
        assert np.abs(got_g - want_g).max() <= tol * scale, path


def test_families_without_a_train_port_raise():
    """Each names its item of ROADMAP.md's Queue 1 (the hybrid trains:
    ``tests/test_torch_zamba_train.py``; the VLM:
    ``tests/test_torch_vlm_train.py``)."""
    for arch, item in (("mixtral-8x7b", "item 5"),):
        cfg = get_arch(arch).reduced()
        run = RunConfig(model=cfg, shape=ShapeConfig("t", seq_len=8,
                                                    global_batch=1,
                                                    kind="train"))
        with pytest.raises(NotImplementedError, match=item):
            make_train_step(run)


# ------------------------------------------------------------- trajectory

@pytest.fixture(scope="module")
def jax_workloads():
    """The reference's train workload of an arch (reduced, bf16), built
    and compiled once for the module."""
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = jbuild_workload(arch, reduced=True, batch=B, seq=S,
                                         seed=0)
        return made[arch]
    return get


@pytest.fixture(scope="module")
def jax_workload(jax_workloads):
    return jax_workloads(ARCH)


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
    # the state the five updates left: the step count exactly; m and v
    # within the bf16 gradients' tolerance (3e-2 of each leaf's largest;
    # measured 1.2e-2); each bf16 param within one rounding of the
    # reference's, or, where the updates are larger than a rounding (|p|
    # near 0), within 2 x the five steps' summed lr, as far as Adam steps
    # of the other sign can take an element whose gradient is within the
    # two sides' bf16 noise of 0 (0.08% of the elements; measured 1.8e-4)
    steps, gaps = _state_gaps(state, jstate)
    assert steps == (5, 5)
    from repro_torch.optim import adamw
    lrs = 2 * sum(float(adamw.schedule(adamw.AdamWConfig(lr=1e-3), t))
                  for t in range(1, 6))
    for (part, path), (gap, ref) in gaps.items():
        if part == "params":
            ulp = np.spacing(np.abs(ref).astype(ml_dtypes.bfloat16))
            limit = np.maximum(ulp.astype(np.float32), lrs)
            assert (gap <= limit).all(), path
        else:
            assert gap.max() <= 3e-2 * np.abs(ref).max(), (part, path)


def test_f32_trajectory_with_one_warmup_step_matches_the_reference(
        monkeypatch):
    """The composed train step (grads, AdamW in place, the lr at step + 1)
    where the updates show: f32 weights and one warmup step, so lr 1e-3
    from the first update and the loss falls ~1.1 in five steps. The
    reference's bf16 cast of the softmax weights is patched out as in the
    f32 gradient test. Tolerances: losses 1e-6 relative (measured 8e-8);
    m and v 5e-5 of each leaf's largest (measured 1.2e-5); params 0.2 lr
    (an element whose gradient is within the two sides' f32 noise of 0
    can take an Adam step of another sign; measured 8.3e-5)."""
    import repro.launch.step_fns as jstep_fns
    from repro.optim import adamw as jadamw
    from repro_torch.launch import step_fns
    from repro_torch.optim import adamw

    monkeypatch.setattr(JL, "_online_update", _online_update_f32)
    lr = 1e-3
    for mod, opt in ((jstep_fns, jadamw), (step_fns, adamw)):
        monkeypatch.setattr(mod, "make_opt_cfg", lambda run, opt=opt:
                            opt.AdamWConfig(lr=run.learning_rate,
                                            weight_decay=run.weight_decay,
                                            beta1=run.beta1, beta2=run.beta2,
                                            warmup_steps=1))
    jrun = dataclasses.replace(_jax_run("float32", seq_chunk=S),
                               learning_rate=lr)
    jstep, model = jstep_fns.make_train_step(jrun)
    jstep = jax.jit(jstep)
    params = model.init(jax.random.key(0))
    jparams, jopt = params, jadamw.init(params)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32")
    run = RunConfig(model=cfg, shape=ShapeConfig("t", seq_len=S,
                                                global_batch=B, kind="train"),
                    remat="none", seq_chunk=S, kv_block=S, learning_rate=lr)
    step, _ = make_train_step(run)
    sd = dict(convert.params_from_jax(jax.device_get(params), cfg, "cpu"))
    opt = adamw.init(sd)
    data = JTokenSource(JDataConfig(cfg.vocab_size, S, B, 0))
    want, got = [], []
    for t in range(5):
        b = data.host_batch_at(t)
        jparams, jopt, jl = jstep(jparams, jopt,
                                  {k: jnp.asarray(v) for k, v in b.items()})
        sd, opt, loss = step(sd, opt, {k: torch.from_numpy(v.copy())
                                       for k, v in b.items()})
        want.append(float(jl))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert want[0] - want[-1] > 0.5
    steps, gaps = _state_gaps({"params": sd, "opt": opt},
                              {"params": jparams, "opt": jopt})
    assert steps == (5, 5)
    for (part, path), (gap, ref) in gaps.items():
        limit = 0.2 * lr if part == "params" else 5e-5 * np.abs(ref).max()
        assert gap.max() <= limit, (part, path, gap.max())


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


# (arch, schedule): the reduced qwen3-8b (ids kept as the schedule's
# name), the reference's own arch, xlstm-350m, under the same four, and
# whisper-tiny (zero frames, as the reference's trainer feeds them) under
# the promotion and the pure checkpoint (the schedule the card leaves to
# the CPU)
FT_CASES = ([pytest.param(ARCH, name, id=name) for name in sorted(SCHEDULES)]
            + [pytest.param("xlstm-350m", name, id=f"xlstm-350m-{name}")
               for name in sorted(SCHEDULES)]
            + [pytest.param("whisper-tiny", name, id=f"whisper-tiny-{name}")
               for name in ("promotion", "pure_checkpoint")])


@pytest.fixture(scope="module")
def port_clean_runs():
    """The port's clean 12-step run of an arch, made once."""
    made = {}

    def get(arch):
        if arch not in made:
            tr = train.build_trainer(arch, batch=B, seq=S, device="cpu",
                                     ft=FTConfig(mode="none"),
                                     kill_schedule={})
            made[arch] = tr.run(STEPS)
        return made[arch]
    return get


@pytest.mark.parametrize("arch,name", FT_CASES)
def test_ft_theorem_on_the_port(arch, name, port_clean_runs, jax_workloads,
                                tmp_path):
    ft, kills, disk = SCHEDULES[name]
    port_clean = port_clean_runs(arch)
    ckpt = str(tmp_path / "port") if disk else None
    tr = train.build_trainer(arch, batch=B, seq=S, device="cpu",
                             ft=FTConfig(**ft), ckpt_dir=ckpt,
                             kill_schedule=kills)
    rep = tr.run(STEPS)
    assert isinstance(rep, TrainReport)
    backend = tr.session.strategy.backend
    if ft["mode"] != "replication":
        assert isinstance(backend, DiskBackend if disk else MemBackend)
    for (k, a), (_, b) in zip(_state_tensors(rep.final_state),
                              _state_tensors(port_clean.final_state)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    # the same schedule on the reference: the same counters
    jtr = jbuild_trainer(arch, reduced=True, batch=B, seq=S,
                         ft=JFTConfig(**ft),
                         ckpt_dir=str(tmp_path / "ref") if disk else None,
                         kill_schedule=kills)
    jtr.workload = jax_workloads(arch)             # compiled once
    jrep = jtr.run(STEPS)
    assert {c: getattr(rep, c) for c in COUNTERS} == \
        {c: getattr(jrep, c) for c in COUNTERS}
    assert [e.kind for e in rep.events] == [e.kind for e in jrep.events]
    if name in ("promotion",):
        assert rep.promotions == 1 and rep.restarts == 0
    else:
        assert rep.restarts == 1
    if name in ("pair_death", "combined_memory"):
        assert rep.rolled_back_steps > 0
    assert np.isfinite(rep.losses).all() and len(rep.losses) == \
        STEPS + rep.rolled_back_steps


def test_xlstm_clean_trajectory_matches_the_reference_trainer(
        port_clean_runs, jax_workloads):
    """The reference's FT-theorem clean run (``tests/test_ft_trainer.py:
    23-27``: xlstm-350m reduced, batch 4 x 32, 12 steps) against the
    port's from the same init."""
    arch = "xlstm-350m"
    jrep = jbuild_trainer(arch, reduced=True, batch=B, seq=S,
                          ft=JFTConfig(mode="none"),
                          kill_schedule={}).run(STEPS)
    jparams = jax.device_get(jax_workloads(arch).init_state()["params"])
    rep = train.build_trainer(arch, batch=B, seq=S, device="cpu",
                              ft=FTConfig(mode="none"), kill_schedule={},
                              jax_params=jparams).run(STEPS)
    np.testing.assert_allclose(rep.losses, jrep.losses, rtol=5e-3)
    assert len(set(rep.losses)) == STEPS
    from repro_torch.optim import adamw
    lrs = 2 * sum(float(adamw.schedule(adamw.AdamWConfig(lr=1e-3), t))
                  for t in range(1, STEPS + 1))
    got = convert.params_to_jax(rep.final_state["params"])
    worst = 0.0
    for path, w in jax.tree_util.tree_flatten_with_path(
            jax.device_get(jrep.final_state["params"]))[0]:
        node = got
        for k in path:
            node = node[k.key]
        w32, g32 = _f32(w), _f32(node)
        ulp = np.spacing(np.abs(w32).astype(ml_dtypes.bfloat16))
        limit = np.maximum(ulp.astype(np.float32), lrs)
        worst = max(worst, float((np.abs(g32 - w32) / limit).max()))
        assert (np.abs(g32 - w32) <= limit).all(), path
    print(f"xlstm trajectory: losses {rep.losses[0]:.4f} -> "
          f"{rep.losses[-1]:.4f}, worst param gap {worst:.3g} of its limit")


def test_replica_and_snapshots_own_their_storage():
    """The in-place update must never reach the replica: the train state's
    copies (F1's cloning copy_tree, the shim's _copy_tree alias) own their
    storage."""
    assert _copy_tree is copy_tree
    wl = train.build_workload(ARCH, batch=2, seq=8, device="cpu")
    state = wl.init_state()
    twin = copy_tree(state)
    assert type(twin["opt"]) is type(state["opt"])
    state, _ = wl.step(state, 0)
    for (k, a), (_, b) in zip(_state_tensors(state), _state_tensors(twin)):
        assert a.data_ptr() != b.data_ptr(), k
    assert int(state["opt"].step) == 1 and int(twin["opt"].step) == 0
    assert not torch.equal(state["params"]["layers.0.attn.wq"],
                           twin["params"]["layers.0.attn.wq"])


def test_workload_surface(jax_workloads):
    wl = train.build_workload(ARCH, batch=2, seq=8, device="cpu")
    assert isinstance(wl, TrainWorkload) and wl.disk_checkpointable
    tr = FTTrainer(train_step=wl.train_step, init_state=wl.init_state_fn,
                   batch_fn=wl.batch_fn, ft=FTConfig(mode="replication"),
                   kill_schedule={1: [0]}, step_time_s=2.0)
    assert tr.session.step_time_s == 2.0 and tr.rmap.n == 8
    rep = tr.run(3)
    assert rep.promotions == 1 and len(rep.losses) == 3
    # simulate_replica=False (the reference's FTSession/FTTrainer
    # parameter): no replica is kept or executed, a promotion continues the
    # computational slice's state, and nothing is rolled back. The
    # reference's trainer, the port's trainer and the port's session run
    # the same schedule from the reference's init: the same counters,
    # events and virtual-time breakdown, losses within the bf16
    # trajectory's 2e-3, and the port's final state bitwise its clean run's
    from repro.core.ft_runtime import FTTrainer as JFTTrainer
    from repro_torch.ft import FTSession
    kills, steps = {5: [0]}, 8
    jwl = jax_workloads(ARCH)
    jparams = jax.device_get(jwl.init_state()["params"])
    jtr = JFTTrainer(train_step=jwl.train_step, init_state=jwl.init_state_fn,
                     batch_fn=jwl.batch_fn, ft=JFTConfig(mode="replication"),
                     kill_schedule=kills, simulate_replica=False)
    assert jtr.simulate_replica is False
    jrep = jtr.run(steps)
    wl = train.build_workload(ARCH, batch=B, seq=S, device="cpu",
                              jax_params=jparams)
    executed = []
    inner = wl.train_step
    wl.train_step = lambda st, b: executed.append(1) or inner(st, b)
    tr = FTTrainer(train_step=wl.train_step, init_state=wl.init_state_fn,
                   batch_fn=wl.batch_fn, ft=FTConfig(mode="replication"),
                   kill_schedule=kills, simulate_replica=False)
    assert tr.simulate_replica is False and \
        tr.session.simulate_replica is False
    reps = [tr.run(steps)]
    assert tr.session.strategy.replica_state is None
    assert len(executed) == steps              # no replica step executed
    reps.append(FTSession(ft=FTConfig(mode="replication"), injector=kills,
                          simulate_replica=False).run(wl, steps))
    assert len(executed) == 2 * steps
    clean = FTSession(ft=FTConfig(mode="none")).run(wl, steps)
    for rep in reps:
        assert {c: getattr(rep, c) for c in COUNTERS} == \
            {c: getattr(jrep, c) for c in COUNTERS}
        assert (rep.promotions, rep.restarts, rep.rolled_back_steps) == \
            (1, 0, 0)
        assert [(e.step, e.kind, e.detail) for e in rep.events] == \
            [(e.step, e.kind, e.detail) for e in jrep.events]
        assert rep.time.as_dict() == jrep.time.as_dict()
        np.testing.assert_allclose(rep.losses, jrep.losses, rtol=2e-3)
        for (k, a), (_, b) in zip(_state_tensors(rep.final_state),
                                  _state_tensors(clean.final_state)):
            assert a.dtype == b.dtype and torch.equal(a, b), k
    tr.simulate_replica = True
    assert tr.session.simulate_replica is True


# -------------------------------------------------------------- the CLI

def test_train_cli_on_the_cpu_with_kills(tmp_path, capsys):
    rc = train.main(["--device", "cpu", "--steps", "10", "--seq", "32",
                     "--batch", "4", "--ft-mode", "combined",
                     "--ckpt-interval", "3", "--ckpt-dir",
                     str(tmp_path / "ck"), "--kill", "3:0", "--kill", "6:8"])
    out = capsys.readouterr().out
    assert rc == 0
    for field in ("mode=combined", "steps=10", "failures=2",
                  "promotions=1", "restarts=1", "ckpts=3", "rolled_back=2"):
        assert field in out, out
    assert (tmp_path / "ck" / "LATEST").exists()


def test_train_cli_needs_cuda_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--steps", "1", "--seq", "8", "--batch", "2"])
