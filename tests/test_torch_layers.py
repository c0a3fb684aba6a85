"""The port's dense layers (``repro_torch.models.layers``) against the JAX
package's (``repro.models.layers``), on the same numpy-made params and
inputs, in f32 and bf16, at the reduced qwen3-8b config (d = 128, 4 query
heads, 1 KV head: GQA 4).

Tolerances and why:
  F32 (2e-5)      f32 on both sides; only summation order differs.
  F32_PCAST       the JAX blockwise attention casts the probability tile to
  (1e-2)          bf16 before the PV product (layers.py:108); the port keeps
                  it in f32 like the TPU kernel. The ``f32_pv`` fixture
                  removes that cast on the JAX side (a test-local patch), and
                  the comparison is then held at F32.
  BF16 (6e-2)     bf16 weights and activations: the frameworks round the
                  matmul outputs at different points; a few bf16 ulps of
                  values of order 1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
from repro.configs import get_arch as jax_arch
from repro_torch.configs import get_arch
from repro_torch.models import layers as L
from repro_torch.models.convert import to_tensor

F32 = dict(rtol=2e-5, atol=2e-5)
F32_PCAST = dict(rtol=1e-2, atol=1e-2)
BF16 = dict(rtol=6e-2, atol=6e-2)
TOL = {"float32": F32, "bfloat16": BF16}


def _cfgs(dtype, **over):
    jc = dataclasses.replace(jax_arch("qwen3-8b").reduced(), dtype=dtype,
                             **over)
    tc = dataclasses.replace(get_arch("qwen3-8b").reduced(), dtype=dtype,
                             **over)
    return jc, tc


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape, dtype=np.float32) * scale)


def _to_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(getattr(jnp, dtype)),
                        tree)


def _to_torch(jtree):
    if isinstance(jtree, dict):
        return {k: _to_torch(v) for k, v in jtree.items()}
    return to_tensor(np.asarray(jtree))


def _attn_params(cfg, rng):
    d, h, hk, e = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    return {"wq": _np(rng, (d, h, e), d ** -0.5),
            "wk": _np(rng, (d, hk, e), d ** -0.5),
            "wv": _np(rng, (d, hk, e), d ** -0.5),
            "wo": _np(rng, (h, e, d), (h * e) ** -0.5),
            "q_norm": {"scale": 1 + _np(rng, (e,), 0.1)},
            "k_norm": {"scale": 1 + _np(rng, (e,), 0.1)}}


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.fixture
def f32_pv(monkeypatch):
    """Keep the JAX blockwise attention's PV product in f32."""
    def online_update(carry, s, v):
        m, l, acc = carry
        m_new = jnp.maximum(m, s.max(axis=-1))
        p = jnp.exp(s - m_new[..., None])
        corr = jnp.exp(m - m_new)
        l = l * corr + p.sum(axis=-1)
        pv = jnp.einsum("bhgqk,bkhd->bhgqd", p, v.astype(jnp.float32),
                        precision="highest")
        return m_new, l, acc * corr[..., None] + pv
    monkeypatch.setattr(JL, "_online_update", online_update)


# ------------------------------------------------------------------- rmsnorm

@pytest.mark.parametrize("shape", [(2, 8, 128), (2, 8, 4, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(shape, dtype):
    rng = np.random.default_rng(0)
    jx, jp = _to_jax((_np(rng, shape), {"scale": 1 + _np(rng, shape[-1:],
                                                         0.1)}), dtype)
    got = L.rmsnorm(_to_torch(jp), _to_torch(jx), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    _close(got, JL.rmsnorm(jp, jx, 1e-5), TOL[dtype])


# ---------------------------------------------------------------------- rope

@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(theta, dtype):
    rng = np.random.default_rng(1)
    x = _to_jax(_np(rng, (2, 16, 4, 32)), dtype)
    pos = rng.integers(0, 600, (2, 16)).astype(np.int32)
    got = L.rope(_to_torch(x), torch.as_tensor(pos), theta)
    # positions up to 600 turn angles of ~600 rad; sin/cos of the two
    # libraries differ by a few f32 ulps there
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else BF16
    _close(got, JL.rope(x, jnp.asarray(pos), theta), tol)


# ----------------------------------------------------------------- attention

def _attention_inputs(dtype, seed=2, s=32, **over):
    jc, tc = _cfgs(dtype, **over)
    rng = np.random.default_rng(seed)
    jp = _to_jax(_attn_params(jc, rng), dtype)
    jx = _to_jax(_np(rng, (2, s, jc.d_model)), dtype)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    return jc, tc, jp, jx, pos


def test_attention_prefill_f32_algorithm(f32_pv):
    jc, tc, jp, jx, pos = _attention_inputs("float32")
    want, _ = JL.attention_apply(jc, jp, jx, jnp.asarray(pos), kv_block=16)
    got, cache = L.attention_apply(tc, _to_torch(jp), _to_torch(jx),
                                   torch.as_tensor(pos))
    assert cache is None
    _close(got, want, F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_prefill(dtype):
    jc, tc, jp, jx, pos = _attention_inputs(dtype)
    want, _ = JL.attention_apply(jc, jp, jx, jnp.asarray(pos), kv_block=16)
    got, _ = L.attention_apply(tc, _to_torch(jp), _to_torch(jx),
                               torch.as_tensor(pos))
    _close(got, want, F32_PCAST if dtype == "float32" else BF16)


@pytest.mark.parametrize("window", [0, 8])
def test_attention_prefill_emits_the_same_cache(f32_pv, window):
    jc, tc, jp, jx, pos = _attention_inputs("float32", sliding_window=window)
    jcache0 = JL.empty_cache(jc, 2, 4, jnp.float32)
    want, jcache = JL.attention_apply(jc, jp, jx, jnp.asarray(pos),
                                      cache=jcache0, kv_block=16)
    got, cache = L.attention_apply(tc, _to_torch(jp), _to_torch(jx),
                                   torch.as_tensor(pos),
                                   cache=L.empty_cache(tc, 2, 4, torch.float32,
                                                       "cpu"))
    _close(got, want, F32)
    for key in ("k", "v"):
        _close(cache[key], jcache[key], F32)
    np.testing.assert_array_equal(cache["pos"].numpy(), jcache["pos"])
    assert cache["idx"] == int(jcache["idx"])
    assert cache["k"].shape[1] == (min(32, window) if window else 32 + 64)


def _decode_run(dtype, window, steps):
    """Prefill 16 tokens, then ``steps`` single-token decodes writing the
    ring cache; compare the output and the whole cache at every step.
    JAX decode attention is f32 throughout (no bf16 probability cast), so
    f32 is held at F32."""
    jc, tc, jp, jx, pos = _attention_inputs(dtype, seed=3, s=16,
                                            sliding_window=window)
    tp = _to_torch(jp)
    _, jcache = JL.attention_apply(jc, jp, jx, jnp.asarray(pos),
                                   cache=JL.empty_cache(jc, 2, 1, jx.dtype),
                                   kv_block=16)
    cache = {k: _to_torch(v) for k, v in jcache.items() if k != "idx"}
    cache["idx"] = int(jcache["idx"])
    rng = np.random.default_rng(4)
    tol = TOL[dtype]
    for t in range(steps):
        jtok = _to_jax(_np(rng, (2, 1, jc.d_model)), dtype)
        p = np.full((2, 1), 16 + t, np.int32)
        want, jcache = JL.attention_apply(jc, jp, jtok, jnp.asarray(p),
                                          cache=jcache)
        k_buf = cache["k"]
        got, cache = L.attention_apply(tc, tp, _to_torch(jtok),
                                       torch.as_tensor(p), cache=cache)
        assert cache["k"] is k_buf          # the ring write is in place
        _close(got, want, tol)
        for key in ("k", "v"):
            _close(cache[key], jcache[key], tol)
        np.testing.assert_array_equal(cache["pos"].numpy(), jcache["pos"])
        assert cache["idx"] == int(jcache["idx"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_decode_ring_cache_wraps(dtype):
    """A window of 8 slots: decode overwrites the oldest slot each step."""
    _decode_run(dtype, window=8, steps=10)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_decode_full_attention_headroom(dtype):
    """Full attention: the 64 headroom slots are appended to, in order."""
    _decode_run(dtype, window=0, steps=6)


def test_decode_attention_masks_empty_slots():
    rng = np.random.default_rng(5)
    q = _np(rng, (2, 1, 4, 32))
    kc, vc = _np(rng, (2, 12, 1, 32)), _np(rng, (2, 12, 1, 32))
    kpos = np.where(np.arange(12) < 7, np.arange(12), -1).astype(np.int32)
    kpos = np.tile(kpos, (2, 1))
    qpos = np.full((2, 1), 7, np.int32)
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(qpos),
                               jnp.asarray(kpos), window=4)
    got = L.decode_attention(*(torch.as_tensor(a) for a in
                               (q, kc, vc, qpos, kpos)), window=4)
    _close(got, want, F32)


# ---------------------------------------------------------- mlp, embeddings

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply(dtype):
    rng = np.random.default_rng(6)
    jp = _to_jax({"wi": _np(rng, (128, 256), 128 ** -0.5),
                  "wg": _np(rng, (128, 256), 128 ** -0.5),
                  "wo": _np(rng, (256, 128), 256 ** -0.5)}, dtype)
    jx = _to_jax(_np(rng, (2, 8, 128)), dtype)
    _close(L.mlp_apply(_to_torch(jp), _to_torch(jx)), JL.mlp_apply(jp, jx),
           TOL[dtype])


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_and_unembed(tied, dtype):
    jc, tc = _cfgs(dtype, tie_embeddings=tied)
    rng = np.random.default_rng(7)
    tree = {"embed": _np(rng, (jc.vocab_size, jc.d_model))}
    if not tied:
        tree["unembed"] = _np(rng, (jc.d_model, jc.vocab_size),
                              jc.d_model ** -0.5)
    jp = _to_jax(tree, dtype)
    tp = _to_torch(jp)
    toks = rng.integers(0, jc.vocab_size, (2, 8)).astype(np.int32)
    emb = L.embed_lookup(tp, torch.as_tensor(toks))
    np.testing.assert_array_equal(
        emb.float().numpy(),
        np.asarray(JL.embed_lookup(jp, jnp.asarray(toks)), np.float32))
    jx = _to_jax(_np(rng, (2, 8, jc.d_model), 0.1), dtype)
    _close(L.unembed(tc, tp, _to_torch(jx)), JL.unembed(jc, jp, jx),
           TOL[dtype])
