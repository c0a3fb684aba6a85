"""The port's MoE training against the JAX package's, on the CPU, at the
reduced mixtral-8x7b (4 layers, d 128, 4 experts of d_ff 256, top-2,
window 64, vocab 512): the load-balancing loss (``moe_aux_loss``), the
train loss (the LM loss plus 0.01 x the first layer's aux loss on the
normed backbone output) and every parameter's gradient against
``jax.value_and_grad``, the sharded path (``_moe_apply_sharded``) on a
4 x 2 gloo mesh against the reference's ``_moe_apply_local``, and the FT
theorem under replication.

Tolerances and why:
  * AUX (1e-6 relative): f32 router products in another summation order;
    the top-k choices and so the one-hot fractions are the same (checked).
  * F32_GRAD (1e-5 of each leaf's largest |reference gradient|): f32 with
    the reference's bf16 cast of the softmax weights (F6) patched out:
    summation order only, the dense family's tolerance. Measured 4.2e-6.
  * BF16_GRAD (0.75 of each leaf's largest): bf16 as the reference
    stands. A token whose two best router probabilities lie within the
    router product's bf16 rounding of each other goes to another expert
    on each side (the frameworks round that product at different points),
    which moves that token's whole contribution to the expert weights and
    everything downstream. Measured 0.66 (the unembedding); the
    reference's own bf16 gradients lie 0.66 from its f32 ones (F6
    patched), the port's 0.50, and the test holds the port's bf16
    gradients to the f32 ones no farther than the reference's are
    (BF16_VS_F32_SLACK 0.05 on top).
  * SHARDED (rtol = atol = 2e-5): f32, the reference's own check of its
    shard_map path (``tests/test_hlo_cost_slices.py``); the partial sums
    over the two ``model`` ranks add in another order.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import textwrap

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
from repro.models import moe as JM
from repro_torch.configs import get_arch
from repro_torch.configs.base import FTConfig
from repro_torch.launch import train
from repro_torch.models import convert, moe, transformer
from test_torch_train import _online_update_f32

ARCH = "mixtral-8x7b"
B, S = 4, 32
AUX = 1e-6
F32_GRAD, BF16_GRAD, BF16_VS_F32_SLACK = 1e-5, 0.75, 0.05
SHARDED = 2e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _cfg(dtype):
    return dataclasses.replace(get_arch(ARCH).reduced(), dtype=dtype)


def _jax_model(dtype):
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(), dtype=dtype)
    run = JRunConfig(model=jcfg, shape=JShapeConfig("t", seq_len=S,
                                                   global_batch=B,
                                                   kind="train"),
                     remat="none", seq_chunk=S, kv_block=S)
    return jmake_model(run)


def _init32():
    """The reference's init (bf16) as f32 arrays: both dtypes' runs start
    from the same values."""
    params = _jax_model("bfloat16").init(jax.random.key(0))
    return jax.tree.map(lambda a: a.astype(jnp.float32), params)


def _grads(dtype, params32):
    """(reference loss, its gradients, the port's loss, its gradients as
    the reference's tree) at ``params32`` cast to ``dtype``."""
    model = _jax_model(dtype)
    params = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)), params32)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (B, S + 1)).astype(np.int32)
    host = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    tb = {k: torch.from_numpy(v.copy()) for k, v in host.items()}
    want, jgrads = jax.jit(jax.value_and_grad(model.loss_fn))(params, jb)
    sd = convert.params_from_jax(jax.device_get(params), _cfg(dtype), "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in sd.items()}
    loss = transformer.loss_fn(_cfg(dtype), leaves, tb, seq_chunk=S)
    grads = convert.params_to_jax(dict(zip(
        leaves, torch.autograd.grad(loss, list(leaves.values())))))
    return float(want), jax.device_get(jgrads), loss, grads


def _pairs(jgrads, grads):
    for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        node = grads
        for k in path:
            node = node[k.key]
        yield jax.tree_util.keystr(path), _f32(g), _f32(node)


# ------------------------------------------------------------ the aux loss

@pytest.mark.parametrize("seed", [0, 1])
def test_aux_loss_matches(seed):
    """``moe_aux_loss`` on random x [B, S, d] and router (f32) equals the
    reference's, and so do the top-k choices it counts."""
    cfg = _cfg("float32")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    router = rng.standard_normal((cfg.d_model, cfg.n_experts),
                                 dtype=np.float32) * 0.2
    want = float(JM.moe_aux_loss(cfg, {"router": jnp.asarray(router)},
                                 jnp.asarray(x)))
    got = moe.moe_aux_loss(cfg, {"router": torch.from_numpy(router)},
                           torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), want, rtol=AUX)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, jtop = jax.lax.top_k(probs, cfg.n_experts_per_tok)
    tprobs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(router),
                           -1)
    ttop = torch.argsort(tprobs, dim=-1, descending=True,
                         stable=True)[..., :cfg.n_experts_per_tok]
    np.testing.assert_array_equal(ttop.numpy(), np.asarray(jtop))


def test_aux_loss_is_one_for_a_uniform_router():
    """A zero router: every probability 1/E and the stable top-k takes
    the first k experts for every token, so frac is 1/k on those and 0
    elsewhere, imp 1/E, and E * sum(frac * imp) = 1, as the
    reference's."""
    cfg = _cfg("float32")
    x = torch.ones((B, S, cfg.d_model))
    p = {"router": torch.zeros((cfg.d_model, cfg.n_experts))}
    want = float(JM.moe_aux_loss(cfg, {"router": jnp.zeros(
        (cfg.d_model, cfg.n_experts))}, jnp.ones((B, S, cfg.d_model))))
    assert moe.moe_aux_loss(cfg, p, x).item() == pytest.approx(want,
                                                               rel=AUX)


# --------------------------------------------------- the loss and gradients

def test_loss_and_every_gradient_match_f32(monkeypatch):
    """f32, F6 patched: the loss within 1e-6 and every leaf's gradient
    within F32_GRAD of its largest; the router's gradient nonzero (the aux
    loss and the combine weights reach it)."""
    monkeypatch.setattr(JL, "_online_update", _online_update_f32)
    want, jgrads, loss, grads = _grads("float32", _init32())
    np.testing.assert_allclose(loss.item(), want, rtol=1e-6)
    n = 0
    for path, want_g, got_g in _pairs(jgrads, grads):
        n += 1
        assert got_g.shape == want_g.shape, path
        scale = np.abs(want_g).max()
        assert scale > 0, path
        assert np.abs(got_g - want_g).max() <= F32_GRAD * scale, path
    assert n == len(jax.tree_util.tree_leaves(grads))


def test_loss_and_every_gradient_match_bf16(monkeypatch):
    """bf16 as the reference stands: the loss within 2e-3, every leaf
    within BF16_GRAD; and against the f32 gradients (F6 patched) the
    port's bf16 ones are no farther than the reference's bf16 ones."""
    params32 = _init32()
    want, j16, loss, t16 = _grads("bfloat16", params32)
    np.testing.assert_allclose(loss.item(), want, rtol=2e-3)
    for path, want_g, got_g in _pairs(j16, t16):
        scale = np.abs(want_g).max()
        assert np.abs(got_g - want_g).max() <= BF16_GRAD * scale, path
    monkeypatch.setattr(JL, "_online_update", _online_update_f32)
    _, j32, _, _ = _grads("float32", params32)
    ref_gap = port_gap = 0.0
    for (path, w, r16), (_, _, p16) in zip(_pairs(j32, j16),
                                           _pairs(j32, t16)):
        scale = np.abs(w).max()
        ref_gap = max(ref_gap, np.abs(_f32(r16) - w).max() / scale)
        port_gap = max(port_gap, np.abs(p16 - w).max() / scale)
    print(f"bf16 against f32: reference {ref_gap:.3f}, port {port_gap:.3f}")
    assert port_gap <= ref_gap + BF16_VS_F32_SLACK


# ---------------------------------------------------------------- training

def test_mixtral_trains_and_the_ft_theorem_holds():
    """``make_train_step`` takes the MoE family; 8 steps clean and under
    replication (the computational slice killed at step 5, the replica
    promoted) end on the same state, bitwise."""
    finals = {}
    for mode, kills in (("none", {}), ("replication", {5: [0]})):
        tr = train.build_trainer(ARCH, reduced=True, batch=2, seq=16,
                                 seed=0, device="cpu",
                                 ft=FTConfig(mode=mode), kill_schedule=kills)
        rep = tr.run(8)
        assert np.isfinite(rep.losses).all() and len(rep.losses) == 8
        assert rep.promotions == (mode == "replication")
        finals[mode] = rep.final_state
    a, b = finals["none"], finals["replication"]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
        assert torch.equal(a["opt"].m[k], b["opt"].m[k]), k


# ------------------------------------------------------- the sharded path

_WORKER = textwrap.dedent('''
    import dataclasses, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, port, out):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=8)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.configs import get_arch
        from repro_torch.distributed import sharding
        from repro_torch.distributed.context import use_batch_axes
        from repro_torch.launch.mesh import activate_mesh
        from repro_torch.models import moe
        cfg = dataclasses.replace(get_arch("mixtral-8x7b").reduced(),
                                  dtype="float32")
        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("data", "model"))
        data = np.load(os.path.join(out, "inputs.npz"))
        sizes = sharding.mesh_axes(mesh)
        x = distribute_tensor(torch.from_numpy(data["x"]), mesh,
                              sharding.placements(("data", None, None),
                                                  mesh))
        p = {}
        for k in ("router", "wi", "wg", "wo"):
            t = torch.from_numpy(data[k])
            spec = sharding.param_pspec("layers.0.ffn." + k, t.shape, sizes)
            p[k] = distribute_tensor(t, mesh, sharding.placements(spec, mesh))
        with activate_mesh(mesh), use_batch_axes(("data",)):
            assert moe._mesh_for_shard_map() is mesh
            y = moe.moe_apply(cfg, p, x)
        full = y.full_tensor()
        if rank == 0:
            np.save(os.path.join(out, "y.npy"), full.numpy())
            with open(os.path.join(out, "placements.txt"), "w") as f:
                f.write(repr(tuple(y.placements)) + " " +
                        repr(tuple(p["wi"].placements)))
        dist.destroy_process_group()

    if __name__ == "__main__":
        port, out = int(sys.argv[1]), sys.argv[2]
        mp.spawn(run, args=(port, out), nprocs=8, join=True)
''')


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sharded_moe_matches_the_reference_local_path(tmp_path):
    """``moe_apply`` under a 4 x 2 (data, model) gloo mesh takes
    ``_moe_apply_sharded`` (x's batch over data, the experts' d_ff over
    model, the partial outputs summed over model) and equals the
    reference's ``_moe_apply_local`` within SHARDED, in f32, drops
    present (capacity 1.25)."""
    cfg = _cfg("float32")
    rng = np.random.default_rng(7)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    arrs = {"x": rng.standard_normal((8, 16, d), dtype=np.float32),
            "router": rng.standard_normal((d, e), dtype=np.float32),
            "wi": rng.standard_normal((e, d, f), dtype=np.float32) / d ** .5,
            "wg": rng.standard_normal((e, d, f), dtype=np.float32) / d ** .5,
            "wo": rng.standard_normal((e, f, d), dtype=np.float32) / f ** .5}
    np.savez(tmp_path / "inputs.npz", **arrs)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, str(script), str(_free_port()),
                    str(tmp_path)], check=True, env=env, timeout=240)
    want = np.asarray(JM._moe_apply_local(
        cfg, {k: jnp.asarray(arrs[k]) for k in ("router", "wi", "wg", "wo")},
        jnp.asarray(arrs["x"])))
    got = np.load(tmp_path / "y.npy")
    np.testing.assert_allclose(got, want, rtol=SHARDED, atol=SHARDED)
    placed = (tmp_path / "placements.txt").read_text()
    assert placed == ("(Shard(dim=0), Replicate()) "
                      "(Replicate(), Shard(dim=2))")


def test_aux_loss_reads_the_normed_backbone_output(monkeypatch):
    """The loss adds 0.01 x the aux loss of layer 0's router, on the
    output of the final norm (what ``chunked_lm_loss`` reads)."""
    cfg = _cfg("float32")
    seen = {}
    inner = moe.moe_aux_loss

    def spy(c, p, x):
        seen["router"] = p["router"]
        seen["x"] = x
        return inner(c, p, x)
    monkeypatch.setattr(moe, "moe_aux_loss", spy)
    jparams = jax.device_get(_init32())
    sd = convert.params_from_jax(jparams, cfg, "cpu")
    tokens = torch.zeros((B, S), dtype=torch.int32)
    with torch.no_grad():
        loss = transformer.loss_fn(cfg, sd, {"tokens": tokens,
                                             "labels": tokens}, S)
    assert seen["router"] is sd["layers.0.ffn.router"]
    assert torch.isfinite(loss)
    # the normed output: its rows' RMS is the final norm's scale (1)
    rms = seen["x"].pow(2).mean(-1).sqrt()
    np.testing.assert_allclose(rms.numpy(), 1.0, rtol=1e-4)
