"""The port's Zamba2 hybrid against the JAX package's, with the JAX weights
carried across by ``repro_torch.models.convert``, at the reduced zamba2-7b
config (7 layers: 2 groups of [shared attention, 3 Mamba2 blocks] + 1 tail
block; d 128, window 64, d_inner 256, N 16, chunk 16).

Prompts of 96 tokens (longer than the window: windowed prefill) and 32
tokens (the attention cache is a ring of 32 slots, so the first decode step
overwrites the key of position 0 on both sides: ROADMAP.md, F3).

Tolerances and why:
  F32_ALGO (2e-5)   f32 with the JAX model's two bf16 casts removed by
                    test-local patches (the blockwise attention's
                    probability tile, ``layers.py:108``; the SSD scan's
                    score tile and x, ``mamba2.py:138-140``): the chunked
                    scan against the port's exact recurrence and the order
                    of sums, through 7 blocks. The recurrent state is held
                    relative to its largest entry (~50).
  F32 (3e-2)        f32 as the JAX model stands: the port keeps both
                    products in f32, as the TPU kernels do; about one bf16
                    rounding, compounded over 7 blocks, of logits ~4.
  BF16 (0.15)       bf16 end to end, the JAX casts on top: the frameworks
                    round matmul, conv and residual outputs at different
                    points; a few bf16 ulps of logits ~4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
import repro.models.mamba2 as JM2
from repro.configs import get_arch as jax_arch
from repro.models import api as jax_api
from repro.models.zamba import Zamba as JaxZamba
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba_scan import mamba_chunk_scan
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models import api
from repro_torch.models.convert import params_from_jax, to_tensor
from repro_torch.models.zamba import Zamba

F32_ALGO = dict(rtol=2e-5, atol=2e-5)
F32 = dict(rtol=3e-2, atol=3e-2)
BF16 = dict(rtol=0.15, atol=0.15)
B = 2
ZAMBA2_7B_PARAMS = 6_751_130_832


class _Float32Jnp:
    def __getattr__(self, name):
        return jnp.float32 if name == "bfloat16" else getattr(jnp, name)


@pytest.fixture
def f32_jax(monkeypatch):
    """Keep the JAX model's attention PV product and SSD intra-chunk
    product in f32."""
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
    monkeypatch.setattr(JM2, "jnp", _Float32Jnp())


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU the wrappers never launch: the counters stay at 0."""
    for k in (rmsnorm, flash_attention, mamba_chunk_scan):
        k.launches = 0
    yield
    assert rmsnorm.launches == flash_attention.launches == \
        mamba_chunk_scan.launches == 0


def _models(dtype):
    jcfg = dataclasses.replace(jax_arch("zamba2-7b").reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_arch("zamba2-7b").reduced(), dtype=dtype)
    jm = JaxZamba(jcfg, remat="none", kv_block=16)
    params = jm.init(jax.random.key(0))
    tm = Zamba(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params), tcfg))
    return jm, params, tm


def _prompt(seed, s):
    return np.random.default_rng(seed).integers(0, 512, (B, s)).astype(
        np.int32)


def _close(got, want, tol, scale=1.0):
    np.testing.assert_allclose(got.float().numpy() / scale,
                               np.asarray(want, np.float32) / scale, **tol)


def _check_cache(tc, jc, tol, jm):
    """Every leaf of the port's cache against the JAX model's stacked one."""
    g, k = jm.n_groups, jm.cfg.attn_every
    assert len(tc["attn"]) == g and [len(x) for x in tc["mamba"]] == [k] * g
    assert len(tc["mamba_tail"]) == jm.tail
    for i, c in enumerate(tc["attn"]):
        for key in ("k", "v"):
            _close(c[key], jc["attn"][key][i], tol)
        np.testing.assert_array_equal(c["pos"].numpy(), jc["attn"]["pos"][i])
        assert c["idx"] == int(jc["attn"]["idx"][i])
    states = [(tc["mamba"][a][b], jax.tree.map(lambda t: t[a, b],
                                               jc["mamba"]))
              for a in range(g) for b in range(k)]
    states += [(tc["mamba_tail"][a], jax.tree.map(lambda t: t[a],
                                                  jc["mamba_tail"]))
               for a in range(jm.tail)]
    for got, want in states:
        scale = float(np.abs(np.asarray(want["h"])).max())
        _close(got["h"], want["h"], tol, scale)
        _close(got["conv"], want["conv"], tol)


def _prefill(dtype, s, seed=0):
    jm, params, tm = _models(dtype)
    toks = _prompt(seed, s)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill({"tokens": torch.as_tensor(toks)})
    assert tl.shape == (B, 1, 512) and tl.dtype == getattr(torch, dtype)
    return jm, params, tm, (jl, jc), (tl, tc)


@pytest.mark.parametrize("s", [96, 32])
def test_prefill_and_cache_f32_algorithm(s, f32_jax):
    jm, _, _, (jl, jc), (tl, tc) = _prefill("float32", s)
    _close(tl, jl, F32_ALGO)
    _check_cache(tc, jc, F32_ALGO, jm)
    assert tc["attn"][0]["k"].shape[1] == min(s, 64)   # ring capacity


@pytest.mark.parametrize("s", [96, 32])
@pytest.mark.parametrize("dtype,tol", [("float32", F32),
                                       ("bfloat16", BF16)])
def test_prefill_matches_jax(s, dtype, tol):
    jm, _, _, (jl, jc), (tl, tc) = _prefill(dtype, s)
    _close(tl, jl, tol)
    _check_cache(tc, jc, tol, jm)


def _teacher_forced(dtype, s, tol):
    """Eight decode steps, both sides fed the JAX side's greedy tokens; the
    logits are compared at every step and the whole cache at the end."""
    jm, params, tm, (jl, jc), (_, tc) = _prefill(dtype, s, seed=1)
    pos = np.full((B, 1), s, np.int32)
    for _ in range(8):
        tok = np.asarray(jnp.argmax(jl[:, -1, :], axis=-1))[:, None].astype(
            np.int32)
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok),
                                jnp.asarray(pos))
        tl, tc = tm.decode_step(tc, torch.as_tensor(tok),
                                torch.as_tensor(pos))
        _close(tl, jl, tol)
        pos = pos + 1
    _check_cache(tc, jc, tol, jm)
    return tc


@pytest.mark.parametrize("s", [96, 32])
def test_decode_teacher_forced_f32_algorithm(s, f32_jax):
    tc = _teacher_forced("float32", s, F32_ALGO)
    if s == 32:
        # F3: the ring of 32 slots has been overwritten from position 0
        pos = tc["attn"][0]["pos"][0].tolist()
        assert pos[:8] == list(range(32, 40)) and pos[8] == 8


@pytest.mark.parametrize("s", [96, 32])
def test_decode_teacher_forced_bf16_matches_jax(s):
    _teacher_forced("bfloat16", s, BF16)


def test_init_cache_matches_jax():
    jm, _, tm = _models("bfloat16")
    want = jm.init_cache(B, 32)
    got = tm.init_cache(B, 32)
    for i, c in enumerate(got["attn"]):
        for key in ("k", "v", "pos"):
            assert c[key].dtype == to_tensor(np.asarray(
                want["attn"][key][i])).dtype
            np.testing.assert_array_equal(
                c[key].float().numpy(),
                np.asarray(want["attn"][key][i], np.float32))
        assert c["idx"] == 0
    for key in ("h", "conv"):
        np.testing.assert_array_equal(
            got["mamba"][1][2][key].float().numpy(),
            np.asarray(want["mamba"][key][1, 2], np.float32))
        assert got["mamba_tail"][0][key].shape == \
            want["mamba_tail"][key].shape[1:]


@pytest.mark.parametrize("dtype,tol", [("float32", dict(rtol=1e-4,
                                                         atol=1e-4)),
                                       ("bfloat16", dict(rtol=3e-2,
                                                         atol=3e-2))])
def test_prefill_decode_consistency(dtype, tol):
    """Port of ``test_models_smoke.py::test_prefill_decode_consistency``
    for zamba: decode(prefill(S), token_S) equals prefill(S + 1)'s last
    logits (S = 64 = the window; bf16 at that test's tolerance, f32 to
    summation order)."""
    cfg = dataclasses.replace(get_arch("zamba2-7b").reduced(), dtype=dtype)
    model = Zamba(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    toks = torch.as_tensor(_prompt(0, 65))
    want, _ = model.prefill({"tokens": toks})
    _, cache = model.prefill({"tokens": toks[:, :64]})
    got, _ = model.decode_step(cache, toks[:, 64:],
                               torch.full((B, 1), 64, dtype=torch.int32))
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_param_count_at_full_size():
    """Built on the meta device: no memory for 6.75 B parameters."""
    cfg = get_arch("zamba2-7b")
    assert api.param_count(cfg) == ZAMBA2_7B_PARAMS == \
        jax_api.param_count(jax_arch("zamba2-7b"))


def test_state_dict_names_dtypes_and_bits_carry_over():
    jm, params, tm = _models("bfloat16")
    host = jax.device_get(params)
    sd = params_from_jax(host, tm.cfg)
    assert set(sd) == set(tm.state_dict())
    assert "mamba.1.2.in_x" in sd and "mamba_tail.0.a_log" in sd
    got = sd["mamba.1.2.in_x"]
    want = np.asarray(host["mamba"]["in_x"][1, 2])
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    for leaf in ("a_log", "d_skip", "dt_bias"):
        assert sd[f"mamba_tail.0.{leaf}"].dtype == torch.float32
        assert tm.state_dict()[f"mamba.0.0.{leaf}"].dtype == torch.float32


def test_params_from_jax_rejects_wrong_stacking():
    jm, params, tm = _models("float32")
    host = jax.device_get(params)
    host["mamba"] = jax.tree.map(lambda a: a[:1], host["mamba"])
    with pytest.raises(ValueError, match="leading axes"):
        params_from_jax(host, tm.cfg)


def test_init_follows_the_jax_leaf_rules():
    cfg = get_arch("zamba2-7b").reduced()
    model = Zamba(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    blk = model.mamba[1][0]
    assert torch.all(blk["a_log"] == 0) and torch.all(blk["d_skip"] == 1)
    assert torch.all(blk["dt_bias"] == -2) and torch.all(blk["conv_b"] == 0)
    assert torch.all(blk["ln"]["scale"] == 1)
    assert torch.all(model.mamba_tail[0]["out_norm"]["scale"] == 1)
    conv = blk["conv_w"].float()                # fan_in K = 4, scale 2
    assert abs(conv.std().item() - 1.0) < 0.05
    wi = model.attn_mlp["wi"].float()
    assert abs(wi.std().item() - cfg.d_model ** -0.5) < 0.01
