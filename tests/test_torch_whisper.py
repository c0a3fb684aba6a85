"""The port's whisper (the audio encoder/decoder) against the JAX package's,
on numpy-made inputs with seeded random frames (the served and trained
paths feed zeros, as the reference's server and trainer do, so these tests
are where the encoder and the cross-attention are held to the reference):
the encoder, the ungated cross-attention (through ``memory=`` and
``kv=``), the reduced whisper-tiny (2 encoder and 4 decoder layers, d 128,
4 heads of 32, 32 frames, vocab 512) with the reference's weights carried
over by ``convert``: prefill logits, 4 decode steps, the loss and every
gradient leaf, the prefill/decode consistency check of
``tests/test_models_smoke.py``, ``init_cache``, the convert round trip, the
parameter count, and serving on the CPU.

Tolerances and why (each relative to the largest reference value, or per
gradient leaf to its largest |grad|):
  F32 (2e-5)      f32 with the JAX attention's bf16 probability cast
                  removed (``f32_pv``, F6: the port keeps p in f32, as K2
                  does): summation order only.
  F32_PCAST       f32 as the reference stands, against F6's cast: about
  (1.5e-2)        one bf16 rounding of the softmax weights
                  (``tests/test_torch_model.py``'s).
  BF16 (6e-2)     bf16 end to end: the frameworks round matmul outputs at
                  different points; a few bf16 ulps (the dense model's).
  F32_GRAD (1e-5) f32 gradients with F6's cast removed (the dense
                  family's, ``tests/test_torch_train.py``).
  BF16_GRAD       bf16 gradients as the reference stands (3e-2, the dense
                  family's; measured 2.1e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
from repro.configs import get_arch as jax_arch
from repro.models import api as jax_api
from repro_torch.configs import get_arch
from repro_torch.launch.serve import ReplicatedServer
from repro_torch.models import api, convert
from repro_torch.models import layers as L
from repro_torch.models import whisper as W
from repro_torch.models.convert import (params_from_jax, params_to_jax,
                                        to_tensor)
from test_torch_model import f32_pv  # noqa: F401  (a fixture)
from test_torch_serve import _tensors

ARCH = "whisper-tiny"
F32, F32_PCAST, BF16 = 2e-5, 1.5e-2, 6e-2
F32_GRAD, BF16_GRAD = 1e-5, 3e-2
B, S = 2, 32
WHISPER_TINY_PARAMS = 56_355_844


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's many small ops: the suite
    runs several workers to a machine, and their thread pools would
    otherwise contend for its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(dtype):
    return (dataclasses.replace(jax_arch(ARCH).reduced(), dtype=dtype),
            dataclasses.replace(get_arch(ARCH).reduced(), dtype=dtype))


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _frames(seed, n_frames, d):
    """Seeded random bf16 frames on both sides (the stub frontend's
    dtype)."""
    x = np.random.default_rng(seed).standard_normal(
        (B, n_frames, d), dtype=np.float32)
    j = jnp.asarray(x).astype(jnp.bfloat16)
    return j, to_tensor(np.asarray(j))


@pytest.fixture(scope="module")
def models():
    """The reduced model in f32 and bf16 on both sides, the port's from
    the reference's weights."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jc, tc = _cfgs(dtype)
        jm = jax_api.build_model(jc, remat="none", kv_block=16, seq_chunk=S)
        params = jm.init(jax.random.key(0))
        tm = api.build_model(tc, device="cpu")
        tm.load_state_dict(params_from_jax(jax.device_get(params), tc))
        out[dtype] = (jm, params, tm)
    return out


def _prompt(seed=0, s=S):
    return np.random.default_rng(seed).integers(0, 512, (B, s),
                                                dtype=np.int32)


# ---------------------------------------------------------------- encoder

@pytest.mark.parametrize("dtype,pv,tol", [
    ("float32", "f32", F32), ("float32", "as-is", F32_PCAST),
    ("bfloat16", "as-is", BF16)])
def test_encode_matches_the_reference(dtype, pv, tol, models, request):
    if pv == "f32":
        request.getfixturevalue("f32_pv")
    jm, params, tm = models[dtype]
    jf, tf = _frames(1, tm.cfg.n_frames, tm.cfg.d_model)
    want = jax.jit(lambda p, f: jm.encode(p, f))(params, jf)
    got = W.encode(tm.cfg, tm, tf)
    assert got.shape == tf.shape and got.dtype == getattr(torch, dtype)
    _close(got, want, tol)


# ------------------------------------------------------- cross-attention

@pytest.mark.parametrize("s", [S, 1])
@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
@pytest.mark.parametrize("entry", ["memory", "kv"])
def test_ungated_cross_attention_matches(s, dtype, tol, entry, f32_pv):
    """A prompt (``ops.attention``, non-causal, Sq != Skv) and a decode
    token (the plain path) over random memory, through either entry; the
    gate is set nonzero in both trees and must not count."""
    jc, tc = _cfgs(dtype)
    jp = JL.cross_attention_params(jc, jax.random.key(2), jnp.dtype(dtype))
    jp["gate"] = jnp.asarray(0.7, jnp.dtype(dtype))
    tp = {k: to_tensor(np.asarray(v)) for k, v in jax.device_get(jp).items()}
    jmem, tmem = _frames(3, jc.n_frames, jc.d_model)
    rng = np.random.default_rng(s)
    jx = jnp.asarray(rng.standard_normal((B, s, jc.d_model),
                                         dtype=np.float32)).astype(dtype)
    tx = to_tensor(np.asarray(jx))
    if entry == "memory":
        want = JL.cross_attention_apply(jc, jp, jx, jmem, gated=False)
        got = L.cross_attention_apply(tc, tp, tx, tmem, gated=False)
    else:
        want = JL.cross_attention_apply(
            jc, jp, jx, kv=JL.cross_attention_kv(jc, jp, jmem), gated=False)
        got = L.cross_attention_apply(
            tc, tp, tx, kv=L.cross_attention_kv(tc, tp, tmem), gated=False)
    assert got.shape == (B, s, jc.d_model) and got.dtype == tx.dtype
    _close(got, want, tol)
    gated = L.cross_attention_apply(tc, tp, tx, tmem)
    assert not torch.equal(gated, got)


# ---------------------------------------------------------------- the model

def _batch(tm, seed=0, s=S):
    jf, tf = _frames(seed + 10, tm.cfg.n_frames, tm.cfg.d_model)
    toks = _prompt(seed, s)
    return ({"tokens": jnp.asarray(toks), "frames": jf},
            {"tokens": torch.as_tensor(toks), "frames": tf})


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_prefill_and_four_decode_steps_match(dtype, tol, models, f32_pv):
    jm, params, tm = models[dtype]
    jb, tb = _batch(tm)
    jl, jcache = jax.jit(lambda p, b: jm.prefill(p, b))(params, jb)
    tl, tcache = tm.prefill(tb)
    assert tl.shape == (B, 1, 512) and tl.dtype == getattr(torch, dtype)
    _close(tl, jl, tol)
    # the cache: each decoder layer's ring and the stacked cross K/V
    for name in ("k", "v"):
        assert tcache["cross"][name].shape == \
            (4, B, tm.cfg.n_frames, 4, 32)
        _close(tcache["cross"][name], jcache["cross"][name], tol)
    for i, ring in enumerate(tcache["self"]):
        assert ring["idx"] == int(jcache["self"]["idx"][i]) == S
        np.testing.assert_array_equal(ring["pos"].numpy(),
                                      np.asarray(jcache["self"]["pos"][i]))
        _close(ring["k"], jcache["self"]["k"][i], tol)
    decode = jax.jit(lambda p, c, t, q: jm.decode_step(p, c, t, q))
    pos = np.full((B, 1), S, np.int32)
    for _ in range(4):                 # teacher-forced by the reference
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        jl, jcache = decode(params, jcache, jnp.asarray(tok),
                            jnp.asarray(pos))
        tl, tcache = tm.decode_step(tcache, torch.from_numpy(tok.copy()),
                                    torch.from_numpy(pos.copy()))
        _close(tl, jl, tol)
        pos = pos + 1


@pytest.mark.parametrize("dtype,tol", [("float32", F32_GRAD),
                                       ("bfloat16", BF16_GRAD)])
def test_loss_and_every_gradient_match(dtype, tol, models, monkeypatch,
                                       request):
    """Random frames, so every encoder weight and the cross K/V
    projections have a gradient; the cross gate's is 0 on both sides."""
    if dtype == "float32":
        request.getfixturevalue("f32_pv")
    jm, params, tm = models[dtype]
    jb, tb = _batch(tm, seed=3, s=S + 1)
    tokens = np.asarray(jb["tokens"])
    jbatch = {"tokens": jnp.asarray(tokens[:, :S]),
              "labels": jnp.asarray(tokens[:, 1:]), "frames": jb["frames"]}
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b)))(params, jbatch)
    _, tc = _cfgs(dtype)
    sd = params_from_jax(jax.device_get(params), tc, "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in sd.items()}
    loss = W.loss_fn(tc, leaves, {
        "tokens": torch.from_numpy(tokens[:, :S].copy()),
        "labels": torch.from_numpy(tokens[:, 1:].copy()),
        "frames": tb["frames"]}, seq_chunk=S)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(loss.item(), float(want),
                               rtol=1e-6 if dtype == "float32" else 2e-3)
    grads = params_to_jax(dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()), allow_unused=True,
        materialize_grads=True))))
    paths = jax.tree_util.tree_flatten_with_path(jax.device_get(jgrads))[0]
    assert len(paths) == len(convert.stack_plan(sd))
    worst = 0.0
    for path, g in paths:
        node = grads
        for k in path:
            node = node[k.key]
        want_g = np.asarray(g, np.float32)
        got_g = to_tensor(np.asarray(node)).float().numpy()
        assert got_g.shape == want_g.shape, path
        scale = np.abs(want_g).max()
        if path[-1].key == "gate":       # ungated: read by no one
            assert scale == 0 and not got_g.any(), path
            continue
        gap = np.abs(got_g - want_g).max()
        worst = max(worst, gap / scale)
        assert scale > 0 and gap <= tol * scale, (path, gap, scale)
    print(f"whisper {dtype} gradients: worst gap {worst:.3g} of the leaf's "
          f"largest")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_consistency(dtype, models):
    """``tests/test_models_smoke.py:69-107`` on the port, at its
    tolerance (3e-2): decode after a prefill of S tokens gives the logits
    of a prefill of S + 1, on the same frames."""
    _, _, tm = models[dtype]
    _, tb = _batch(tm, seed=2, s=S + 1)
    want, _ = tm.prefill(tb)
    short = {"tokens": tb["tokens"][:, :S], "frames": tb["frames"]}
    _, cache = tm.prefill(short)
    got, _ = tm.decode_step(cache, tb["tokens"][:, S:],
                            torch.full((B, 1), S, dtype=torch.int32))
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=3e-2, atol=3e-2)


def test_init_cache_matches_the_reference(models):
    jm, _, tm = models["bfloat16"]
    want = jm.init_cache(3, 16)
    got = tm.init_cache(3, 16)
    for name in ("k", "v"):
        assert got["cross"][name].shape == want["cross"][name].shape
        assert got["cross"][name].dtype == torch.bfloat16
    assert len(got["self"]) == 4
    for i, ring in enumerate(got["self"]):
        assert ring["k"].shape == want["self"]["k"].shape[1:]
        np.testing.assert_array_equal(ring["pos"].numpy(),
                                      np.asarray(want["self"]["pos"][i]))
        assert ring["idx"] == 0


def test_convert_round_trip_is_bitwise(models):
    _, params, tm = models["bfloat16"]
    tree = jax.device_get(params)
    sd = tm.state_dict()
    back = params_to_jax(sd)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(convert.stack_plan(sd))
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        assert node.shape == leaf.shape, path
        np.testing.assert_array_equal(node, np.asarray(leaf).view(np.uint16))
    assert sd["dec_layers.3.xattn.gate"].shape == ()
    assert sd["enc_layers.1.mlp.wi"].shape == (128, 256)


def test_param_count_equals_the_reference():
    for cfg, jcfg in ((get_arch(ARCH), jax_arch(ARCH)),
                      (get_arch(ARCH).reduced(), jax_arch(ARCH).reduced())):
        assert api.param_count(cfg) == jax_api.param_count(jcfg)
    assert api.param_count(get_arch(ARCH)) == WHISPER_TINY_PARAMS < 1e8


def test_init_follows_the_reference_leaf_rules():
    model = api.build_model(get_arch(ARCH).reduced(), device="cpu").init(
        torch.Generator().manual_seed(0))
    assert torch.all(model.enc_layers[1]["ln2"]["scale"] == 1)
    assert float(model.dec_layers[2]["xattn"]["gate"]) == 0.0
    wi = model.dec_layers[0]["mlp"]["wi"].float()
    assert abs(wi.std().item() - 128 ** -0.5) < 0.01


# -------------------------------------------------------------- serving

def test_failover_ends_on_the_clean_stream_and_state():
    srv = ReplicatedServer(ARCH, batch=2, prompt_len=16, device="cpu")
    batch = srv.workload(_prompt(4, 16)).batch
    assert batch["frames"].shape == (2, 32, 128)
    assert batch["frames"].dtype == torch.bfloat16
    assert not bool(batch["frames"].any())
    prompts = _prompt(4, 16)
    clean = srv.generate(prompts, 8)
    clean_state = srv.last_report.final_state["cache"]
    faulty = srv.generate(prompts, 8, kill_at=3)
    faulty_state = srv.last_report.final_state["cache"]
    np.testing.assert_array_equal(clean, faulty)
    assert srv.promotions == 1 and srv.failures == 1
    a, b = _tensors(clean_state), _tensors(faulty_state)
    assert len(a) == len(b) == 3 * 4 + 2     # k, v, pos a ring; cross k, v
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(RuntimeError):
        ReplicatedServer(ARCH, batch=2, prompt_len=16, replication=False,
                         device="cpu").generate(prompts, 8, kill_at=2)


def test_stream_equals_the_jax_servers(f32_pv, monkeypatch):
    """Both servers at the reduced config in f32 (zero frames), the port
    on the JAX server's weights, both killed mid-stream."""
    import repro.launch.serve as jax_serve
    monkeypatch.setattr(jax_serve, "get_arch",
                        lambda name: dataclasses.replace(jax_arch(name),
                                                         dtype="float32"))
    theirs = jax_serve.ReplicatedServer(ARCH, batch=2, prompt_len=16)
    _, cfg = _cfgs("float32")
    ours = ReplicatedServer(cfg, batch=2, prompt_len=16, device="cpu")
    ours.model.load_state_dict(params_from_jax(
        jax.device_get(theirs.params), cfg))
    prompts = _prompt(5, 16)
    want = theirs.generate(prompts.copy(), 8, kill_at=3)
    got = ours.generate(prompts, 8, kill_at=3)
    np.testing.assert_array_equal(got, want)
    assert ours.promotions == theirs.promotions == 1
