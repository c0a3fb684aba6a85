"""The port's VLM training (llama-3.2-vision: groups of one gated
cross-attention layer and ``cross_attn_every`` self layers) against the
JAX package's, on the CPU, at the reduced config (2 groups of 1 cross + 2
self layers, d 128, 4 heads of 32, 1 KV head, vocab 512, 16 image
tokens): the loss and every parameter's gradient on random image
embeddings with the gates at 0.5, so the cross path carries gradient;
exactly zero cross gradients on both sides with zero embeddings and zero
gates (what the trainers feed); the train state built from the
reference's init; the FT theorem under the four schedules of
``chip_smoke.py``'s ``TRAIN_RUNS``; and the train CLI.

Tolerances and why (each of a leaf's largest |reference gradient|):
  * F32_GRAD (1e-5): f32 with the reference's bf16 cast of the softmax
    weights before the PV product (F6, ``repro/models/layers.py:108``)
    patched out: summation order only, the dense family's tolerance
    (``tests/test_torch_train.py``). Measured at most 8.4e-6 on every
    leaf but the two in F32_CANCEL;
  * F32_CANCEL (5e-5), by path, for the two f32 leaves that sum terms
    which cancel: the 0-d gates' gradient is one sum of B S d = 16,384
    products whose magnitudes add to 86-428x the result (measured;
    3.2e-5), and the self layers' wk sums softmax gradients near
    cancellation (the attention is near uniform at this init; its
    largest gradient is ~130x smaller than wv's; 1.1e-5);
  * BF16_GRAD (0.2): bf16 as the reference stands, the hybrid's as-is
    tolerance (``tests/test_torch_zamba_train.py``): the reference's bf16
    softmax weights rounded where the port keeps f32, felt most by the
    self layers' small wq and wk gradients. Measured 0.109 (wk);
  * the gates in bf16 (GATE_BF16, 3e-2 of the f32 gate gradient's largest):
    the reference's XLA transposes the gated product's broadcast into a
    bf16 reduction, so with the 86-428x cancellation its bf16 gate
    gradients are off by 0.63 of the f32 ones' largest (F10); PyTorch sums
    the bf16 products in f32. The port's bf16 gate gradients are therefore held to
    the f32 ones (F6 patched) instead, at the dense family's bf16
    tolerance. Measured 3.8e-3;
  * the loss: 1e-6 relative in f32, 2e-3 in bf16 (the five-step
    trajectory's, ``tests/test_torch_train.py``).
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
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch.step_fns import make_model as jmake_model
from repro.launch.train import build_workload as jbuild_workload
from repro_torch.configs import get_arch
from repro_torch.configs.base import FTConfig
from repro_torch.launch import train
from repro_torch.models import convert, transformer
from repro_torch.models.convert import to_tensor
from test_torch_train import _online_update_f32

ARCH = "llama-3.2-vision-11b"
B, S, STEPS = 4, 32, 12
GATE = 0.5
# chip_smoke.py's TRAIN_RUNS: (mode, FTConfig fields, kills, on disk)
TRAIN_RUNS = [
    ("none", dict(mode="none"), {}, False),
    ("replication", dict(mode="replication"), {5: [0]}, False),
    ("combined", dict(mode="combined", ckpt_interval_s=4.0),
     {4: [1], 8: [9]}, True),
    ("checkpoint", dict(mode="checkpoint", ckpt_interval_s=3.0),
     {7: [2]}, True),
]
WANT = {"none": (0, 0), "replication": (1, 0), "combined": (1, 1),
        "checkpoint": (0, 1)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers a machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _f32(x):
    x = np.asarray(x)
    if x.dtype == np.uint16:
        x = x.view(ml_dtypes.bfloat16)
    return x.astype(np.float32)


def _jax_model(dtype):
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(), dtype=dtype)
    run = JRunConfig(model=jcfg, shape=JShapeConfig("t", seq_len=S,
                                                   global_batch=B,
                                                   kind="train"),
                     remat="none", seq_chunk=S, kv_block=S)
    return jmake_model(run)


def _batch(image, seed=3):
    """Token ids and labels from a seed, and the image embeddings given
    (a bf16 numpy array), as the reference's and the port's batches."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (B, S + 1)).astype(np.int32)
    host = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    jb["image_embeds"] = jnp.asarray(image)
    tb = {k: torch.from_numpy(v.copy()) for k, v in host.items()}
    tb["image_embeds"] = to_tensor(image)
    return jb, tb


def _random_image(seed=5):
    rng = np.random.default_rng(seed)
    cfg = get_arch(ARCH).reduced()
    x = rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model),
                            dtype=np.float32)
    return x.astype(ml_dtypes.bfloat16)


def _grads(dtype, gate, image):
    """(reference loss, its gradients, the port's loss, its gradients as
    the reference's tree) on the reference's init with every gate set to
    ``gate``."""
    model = _jax_model(dtype)
    params = model.init(jax.random.key(0))
    params["cross"]["gate"] = jnp.full_like(params["cross"]["gate"], gate)
    jb, tb = _batch(image)
    want, jgrads = jax.jit(jax.value_and_grad(model.loss_fn))(params, jb)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype=dtype)
    sd = convert.params_from_jax(jax.device_get(params), cfg, "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in sd.items()}
    loss = transformer.loss_fn(cfg, leaves, tb, seq_chunk=S)
    grads = convert.params_to_jax(dict(zip(
        leaves, torch.autograd.grad(loss, list(leaves.values())))))
    return float(want), jax.device_get(jgrads), loss, grads


def _pairs(jgrads, grads):
    paths = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for path, g in paths:
        node = grads
        for k in path:
            node = node[k.key]
        yield jax.tree_util.keystr(path), _f32(g), _f32(node)


F32_GRAD, BF16_GRAD, GATE_BF16 = 1e-5, 0.2, 3e-2
GATE_PATH = "['cross']['gate']"
F32_CANCEL = {GATE_PATH: 5e-5, "['layers']['attn']['wk']": 5e-5}


@pytest.mark.parametrize("dtype,tol", [("float32", F32_GRAD),
                                       ("bfloat16", BF16_GRAD)])
def test_loss_and_every_gradient_match(dtype, tol, monkeypatch):
    """Random image embeddings, gates 0.5: every leaf's gradient within
    ``tol`` of its largest |reference gradient| (in f32, F32_CANCEL's
    two leaves within theirs), the cross leaves included and nonzero
    (the bf16 gates: the next test)."""
    if dtype == "float32":
        monkeypatch.setattr(JL, "_online_update", _online_update_f32)
    want, jgrads, loss, grads = _grads(dtype, GATE, _random_image())
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(loss.item(), want,
                               rtol=1e-6 if dtype == "float32" else 2e-3)
    seen = set()
    for path, want_g, got_g in _pairs(jgrads, grads):
        assert got_g.shape == want_g.shape, path
        scale = np.abs(want_g).max()
        seen.add(path)
        if path.startswith("['cross']"):
            assert scale > 0, path               # the cross path is live
        if dtype == "bfloat16" and path == GATE_PATH:
            continue
        leaf_tol = F32_CANCEL.get(path, tol) if dtype == "float32" else tol
        assert np.abs(got_g - want_g).max() <= leaf_tol * scale, path
    assert len(seen) == len(jax.tree_util.tree_leaves(grads))
    assert GATE_PATH in seen


def test_bf16_gate_gradients_match_the_f32_ones(monkeypatch):
    """The port's bf16 gate gradients against the reference's f32 ones (F6
    patched), on the same embeddings and gates; the reference's own bf16
    gate gradients are printed beside them (F10)."""
    monkeypatch.setattr(JL, "_online_update", _online_update_f32)
    image = _random_image()
    _, j32, _, _ = _grads("float32", GATE, image)
    _, j16, _, t16 = _grads("bfloat16", GATE, image)
    pairs = {path: (w, g) for path, w, g in _pairs(j32, t16)}
    want_g, got_g = pairs[GATE_PATH]
    ref16 = dict((p, w) for p, w, _ in _pairs(j16, t16))[GATE_PATH]
    scale = np.abs(want_g).max()
    gap = np.abs(got_g - want_g).max() / scale
    print(f"gate gradients: f32 {want_g}, port bf16 {got_g} ({gap:.3g} of "
          f"the largest), reference bf16 {ref16} "
          f"({np.abs(ref16 - want_g).max() / scale:.3g})")
    assert gap <= GATE_BF16


def test_zero_embeddings_and_zero_gates_give_zero_cross_gradients():
    """What the trainers feed (zero embeddings, gates at their init 0):
    every cross leaf's gradient is exactly 0 on both sides, and the other
    leaves match at the bf16 tolerance."""
    cfg = get_arch(ARCH).reduced()
    image = np.zeros((B, cfg.n_image_tokens, cfg.d_model),
                     ml_dtypes.bfloat16)
    want, jgrads, loss, grads = _grads("bfloat16", 0.0, image)
    np.testing.assert_allclose(loss.item(), want, rtol=3e-2)
    n_cross = 0
    for path, want_g, got_g in _pairs(jgrads, grads):
        if path.startswith("['cross']"):
            n_cross += 1
            assert not want_g.any() and not got_g.any(), path
        else:
            scale = np.abs(want_g).max()
            assert np.abs(got_g - want_g).max() <= 3e-2 * scale, path
    assert n_cross == 5                 # wq, wk, wv, wo and the gate


@pytest.fixture(scope="module")
def jax_workload():
    return jbuild_workload(ARCH, reduced=True, batch=B, seq=S, seed=0)


def test_train_state_from_the_reference_init_is_bitwise(jax_workload):
    """A train state built from ``jax_params`` starts as the reference's:
    params bitwise, moments zero, step 0; the batches carry zero bf16
    image embeddings [B, n_image_tokens, d] on both sides."""
    jstate = jax.device_get(jax_workload.init_state())
    wl = train.build_workload(ARCH, batch=B, seq=S, device="cpu",
                              jax_params=jstate["params"])
    got = convert.train_state_to_jax(wl.init_state())
    step, m, v = got["opt"]
    jopt = jstate["opt"]
    assert int(step) == int(jopt.step) == 0
    for part, g_tree, w_tree in (("params", got["params"], jstate["params"]),
                                 ("m", m, jopt.m), ("v", v, jopt.v)):
        for path, w in jax.tree_util.tree_flatten_with_path(w_tree)[0]:
            node = g_tree
            for k in path:
                node = node[k.key]
            w, node = np.asarray(w), np.asarray(node)
            assert node.shape == w.shape, (part, path)
            if w.dtype == ml_dtypes.bfloat16:
                w = w.view(np.uint16)
            assert node.view(w.dtype).tobytes() == w.tobytes(), (part, path)
    cfg = get_arch(ARCH).reduced()
    tb, jb = wl.batch_fn(2), jax_workload.batch_fn(2)
    assert tb["image_embeds"].dtype == torch.bfloat16
    assert tuple(tb["image_embeds"].shape) == jb["image_embeds"].shape == \
        (B, cfg.n_image_tokens, cfg.d_model)
    assert not tb["image_embeds"].any()
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))


def _state_tensors(state):
    opt = state["opt"]
    return ([("step", opt.step)]
            + [(f"p/{k}", v) for k, v in state["params"].items()]
            + [(f"m/{k}", v) for k, v in opt.m.items()]
            + [(f"v/{k}", v) for k, v in opt.v.items()])


@pytest.fixture(scope="module")
def clean_run():
    return train.build_trainer(ARCH, batch=B, seq=S, device="cpu",
                               ft=FTConfig(mode="none"),
                               kill_schedule={}).run(STEPS)


@pytest.mark.parametrize("mode,ft,kills,disk", TRAIN_RUNS[1:],
                         ids=[r[0] for r in TRAIN_RUNS[1:]])
def test_ft_theorem(mode, ft, kills, disk, clean_run, tmp_path):
    """Each schedule's final params and moments bitwise the clean run's,
    with the promotions and restarts the schedule implies (a disk restart
    where it checkpoints)."""
    tr = train.build_trainer(ARCH, batch=B, seq=S, device="cpu",
                             ft=FTConfig(**ft),
                             ckpt_dir=str(tmp_path) if disk else None,
                             kill_schedule=kills)
    rep = tr.run(STEPS)
    assert (rep.promotions, rep.restarts) == WANT[mode]
    if disk:
        assert tr.session.strategy.backend.kind == "disk"
    assert np.isfinite(rep.losses).all() and \
        len(rep.losses) == STEPS + rep.rolled_back_steps
    assert len(set(clean_run.losses)) == STEPS
    for (k, a), (_, b) in zip(_state_tensors(rep.final_state),
                              _state_tensors(clean_run.final_state)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_train_cli_trains_the_vlm(tmp_path, capsys):
    rc = train.main(["--arch", ARCH, "--device", "cpu", "--steps", "10",
                     "--seq", "32", "--batch", "4", "--ft-mode", "combined",
                     "--ckpt-interval", "3", "--ckpt-dir",
                     str(tmp_path / "ck"), "--kill", "3:0", "--kill", "6:8"])
    out = capsys.readouterr().out
    assert rc == 0
    for field in (f"arch={ARCH}", "mode=combined", "steps=10", "failures=2",
                  "promotions=1", "restarts=1", "ckpts=3", "rolled_back=2"):
        assert field in out, out
