"""The port's VLM (llama-3.2-vision: gated cross-attention image layers)
against the JAX package's, on numpy-made inputs: the cross-attention
layer, the reduced model (2 groups of 1 cross + 2 self layers, d 128, 16
image tokens) with random image embeddings and a nonzero gate set in both
trees, the plain K2 at Sq != Skv, ``init_cache`` and the convert round
trip.

The served path feeds zero embeddings through a gate initialised to 0, so
the cross-attention adds exactly 0 there; these tests are where it is
held to the reference.

Tolerances and why (each relative to the largest reference value):
  F32 (2e-5)      f32 with the JAX attention's bf16 probability cast
                  removed (``f32_pv``, F6): summation order only.
  BF16 (6e-2)     bf16 end to end: the frameworks round matmul outputs at
                  different points; a few bf16 ulps (the dense model's
                  tolerance, tests/test_torch_model.py).
  KERNEL          the plain K2 against ``repro.kernels.ref`` and the
                  Pallas kernel in interpret mode: tests/test_kernels.py's
                  (f32 2e-5; bf16 rtol 2e-2 / atol 3e-2, one rounding).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
from repro.configs import get_arch as jax_arch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import api as jax_api
from repro.models.transformer import Transformer as JaxTransformer
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models.convert import (params_from_jax, params_to_jax,
                                        to_tensor)
from repro_torch.models.transformer import Transformer
from test_torch_model import f32_pv  # noqa: F401  (a fixture)

F32 = 2e-5
BF16 = 6e-2
KERNEL = {"float32": dict(rtol=2e-5, atol=2e-5),
          "bfloat16": dict(rtol=2e-2, atol=3e-2)}
ARCH = "llama-3.2-vision-11b"
GATES = (0.7, -0.4)
B, S = 2, 32
LLAMA_VISION_PARAMS = 10_110_701_576


def _cfgs(dtype):
    return (dataclasses.replace(jax_arch(ARCH).reduced(), dtype=dtype),
            dataclasses.replace(get_arch(ARCH).reduced(), dtype=dtype))


def _bf16_pair(rng, shape):
    """The same bf16 values as a jax array and a torch tensor."""
    x = jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(
        jnp.bfloat16)
    return x, to_tensor(np.asarray(x))


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


# ------------------------------------------------------- cross-attention

@pytest.mark.parametrize("s", [S, 1])
@pytest.mark.parametrize("dtype,tol", [("float32", F32),
                                       ("bfloat16", BF16)])
def test_cross_attention_matches_the_reference(s, dtype, tol, f32_pv):
    """A prompt (``ops.attention``, non-causal, Sq 32 x Skv 16) and a
    decode token (the plain path), gate 0.7, memory and x random."""
    jc, tc = _cfgs(dtype)
    jp = JL.cross_attention_params(jc, jax.random.key(1), jnp.dtype(dtype))
    jp["gate"] = jnp.asarray(GATES[0], jnp.dtype(dtype))
    tp = {k: to_tensor(np.asarray(v)) for k, v in jax.device_get(jp).items()}
    rng = np.random.default_rng(s)
    jmem, tmem = _bf16_pair(rng, (B, jc.n_image_tokens, jc.d_model))
    x = rng.standard_normal((B, s, jc.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = to_tensor(np.asarray(jx))
    jkv = JL.cross_attention_kv(jc, jp, jmem)
    tkv = L.cross_attention_kv(tc, tp, tmem)
    for got, want in zip(tkv, jkv):
        assert got.dtype == tx.dtype
        _close(got, want, tol)
    want = JL.cross_attention_apply(jc, jp, jx, kv=jkv)
    got = L.cross_attention_apply(tc, tp, tx, kv=tkv)
    assert got.shape == (B, s, jc.d_model) and got.dtype == tx.dtype
    _close(got, want, tol)


def test_cross_attention_with_a_zero_gate_adds_zero():
    """The served path: gate 0 (its init), so y is exactly 0."""
    _, tc = _cfgs("bfloat16")
    model = Transformer(tc, device="cpu").init(
        torch.Generator().manual_seed(0))
    cp = model.cross[0]
    assert cp["gate"].shape == () and float(cp["gate"]) == 0.0
    x = torch.randn(B, S, tc.d_model, generator=torch.Generator()
                    .manual_seed(1)).to(torch.bfloat16)
    mem = torch.randn(B, tc.n_image_tokens, tc.d_model).to(torch.bfloat16)
    y = L.cross_attention_apply(tc, cp, x,
                                kv=L.cross_attention_kv(tc, cp, mem))
    assert torch.equal(y, torch.zeros_like(y))


# --------------------------------------------------- plain K2, Sq != Skv

@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
    (2, 4, 1, 32, 16, 32),        # the reduced model's cross shape
    (1, 4, 2, 40, 100, 64),       # ragged on both sides
    (1, 8, 2, 96, 40, 128),       # more queries than keys
    (1, 4, 1, 16, 1600, 128),     # llama-vision's 1,600 image tokens
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_noncausal_attention_sq_ne_skv(b, hq, hkv, sq, skv, d, dtype):
    rng = np.random.default_rng(sq + skv)
    pairs = []
    for h, s in ((hq, sq), (hkv, skv), (hkv, skv)):
        x = jnp.asarray(rng.standard_normal((b, h, s, d), dtype=np.float32)
                        ).astype(getattr(jnp, dtype))
        pairs.append((x, to_tensor(np.asarray(x))))
    (jq, tq), (jk, tk), (jv, tv) = pairs
    got = ops.attention(tq, tk, tv, causal=False)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    want = jref.flash_attention_ref(jq, jk, jv, causal=False)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **KERNEL[dtype])
    # the Pallas kernel reads a ragged last key block past Skv, which
    # interpret mode pads with NaN (0 x NaN in its PV product), so a
    # ragged Skv is held with one key block of all Skv keys
    pallas = jops.attention(jq, jk, jv, causal=False, q_block=64,
                            kv_block=64 if skv % 64 == 0 else skv,
                            backend="interpret")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32),
                               **KERNEL[dtype])


# ------------------------------------------------------ the reduced model

def _models(dtype):
    """Both models on the JAX init, the gates set to ``GATES`` in the JAX
    tree before it is carried across."""
    jc, tc = _cfgs(dtype)
    jm = JaxTransformer(jc, remat="none", kv_block=16)
    params = jm.init(jax.random.key(0))
    params["cross"]["gate"] = jnp.asarray(GATES, jnp.dtype(dtype))
    tm = Transformer(tc, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params), tc))
    return jm, params, tm


@pytest.mark.parametrize("dtype,tol", [("float32", F32),
                                       ("bfloat16", BF16)])
def test_prefill_and_decode_match_jax(dtype, tol, f32_pv):
    """Random image embeddings; prefill (logits, every self cache and the
    cross K/V), then eight teacher-forced decode steps."""
    jm, params, tm = _models(dtype)
    assert float(tm.cross[1]["gate"]) == pytest.approx(GATES[1], abs=4e-3)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    jmem, tmem = _bf16_pair(rng, (B, jm.cfg.n_image_tokens, jm.cfg.d_model))
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks),
                                 "image_embeds": jmem})
    tl, tc = tm.prefill({"tokens": torch.as_tensor(toks),
                         "image_embeds": tmem})
    assert tl.shape == (B, 1, 512) and tl.dtype == getattr(torch, dtype)
    _close(tl, jl, tol)
    groups, per = tm.n_groups, jm.cfg.cross_attn_every
    assert (groups, per) == (2, 2)
    for g in range(groups):
        for key in ("k", "v"):
            _close(tc["cross"][g][key], jc["cross"][key][g], tol)
        for j in range(per):
            c = tc["self"][g][j]
            for key in ("k", "v"):
                _close(c[key], jc["self"][key][g, j], tol)
            np.testing.assert_array_equal(c["pos"].numpy(),
                                          jc["self"]["pos"][g, j])
    pos = np.full((B, 1), S, np.int32)
    for _ in range(8):
        tok = np.asarray(jnp.argmax(jl[:, -1, :], axis=-1))[:, None].astype(
            np.int32)
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok),
                                jnp.asarray(pos))
        tl, tc = tm.decode_step(tc, torch.as_tensor(tok),
                                torch.as_tensor(pos))
        _close(tl, jl, tol)
        pos = pos + 1
    assert [c["idx"] for grp in tc["self"] for c in grp] == [S + 8] * 4


def test_image_embeddings_change_the_logits():
    """With a nonzero gate the image memory reaches the logits (zero
    embeddings and other random ones give other logits)."""
    _, _, tm = _models("float32")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, 512, (B, S)).astype(np.int32))
    shape = (B, tm.cfg.n_image_tokens, tm.cfg.d_model)
    zero, _ = tm.prefill({"tokens": toks,
                          "image_embeds": torch.zeros(shape)})
    rand, _ = tm.prefill({"tokens": toks,
                          "image_embeds": torch.randn(shape)})
    assert (zero - rand).abs().max() > 1e-3


def test_init_cache_matches_jax():
    jm, _, tm = _models("bfloat16")
    want = jm.init_cache(B, S)
    got = tm.init_cache(B, S)
    assert len(got["self"]) == len(got["cross"]) == tm.n_groups
    for g in range(tm.n_groups):
        for j, c in enumerate(got["self"][g]):
            for key in ("k", "v", "pos"):
                w = np.asarray(want["self"][key][g, j])
                assert c[key].dtype == to_tensor(w).dtype
                np.testing.assert_array_equal(c[key].float().numpy(),
                                              w.astype(np.float32))
            assert c["idx"] == int(want["self"]["idx"][g, j]) == 0
        for key in ("k", "v"):
            w = np.asarray(want["cross"][key][g])
            assert tuple(got["cross"][g][key].shape) == w.shape
            assert got["cross"][g][key].dtype == torch.bfloat16
            assert not bool(got["cross"][g][key].any())


def test_convert_round_trip_is_bitwise():
    """``layers/...[g, k]`` <-> ``layers.<g>.<k>....`` and ``cross/...[g]``
    <-> ``cross.<g>....`` (the 0-d gate stays 0-d), both ways bitwise."""
    jm, params, tm = _models("bfloat16")
    host = jax.device_get(params)
    sd = tm.state_dict()
    assert sd["cross.1.gate"].shape == ()
    assert sd["layers.1.0.attn.wq"].shape == host["layers"]["attn"]["wq"][
        1, 0].shape
    np.testing.assert_array_equal(
        sd["layers.1.0.ffn.wg"].view(torch.int16).numpy(),
        np.asarray(host["layers"]["ffn"]["wg"][1, 0]).view(np.int16))
    want = jax.tree_util.tree_flatten_with_path(host)[0]
    got = jax.tree_util.tree_flatten_with_path(params_to_jax(sd))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))
    again = params_from_jax(params_to_jax(sd), tm.cfg)
    assert sorted(again) == sorted(sd)
    assert all(torch.equal(again[k].view(torch.int16),
                           sd[k].view(torch.int16)) for k in sd)


def test_param_count_equals_jax_at_full_size():
    cfg = get_arch(ARCH)
    assert api.param_count(cfg) == jax_api.param_count(jax_arch(ARCH)) \
        == LLAMA_VISION_PARAMS
    assert api.param_count(cfg, active_only=True) == LLAMA_VISION_PARAMS


def test_init_follows_the_jax_leaf_rules():
    """Gates 0, norm scales 1, matrices normal * fan_in^-1/2."""
    _, tc = _cfgs("float32")
    model = Transformer(tc, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert all(float(cp["gate"]) == 0.0 for cp in model.cross)
    assert abs(model.cross[0]["wq"].std().item() - tc.d_model ** -0.5) < 0.01
    assert torch.all(model.layers[1][1]["ln2"]["scale"] == 1)
