"""The port's dense transformer against the JAX package's, with the JAX
weights carried across by ``repro_torch.models.convert``, at the reduced
qwen3-8b config (4 layers, d = 128, GQA 4).

Tolerances and why:
  F32 (2e-5)      f32 with the JAX attention's bf16 probability cast
                  removed by the ``f32_pv`` fixture (a test-local patch):
                  only summation order differs, through 4 layers.
  F32_PCAST       f32 as the JAX model stands: its blockwise attention casts
  (1.5e-2)        the probability tile to bf16 before the PV product
                  (layers.py:108), the port keeps it in f32 as the TPU
                  kernel does; about one bf16 rounding of logits of ~4.
  BF16 (6e-2)     bf16 end to end: the frameworks round matmul outputs at
                  different points; a few bf16 ulps of logits of ~4.
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
from repro.models.transformer import Transformer as JaxTransformer
from repro_torch.configs import get_arch
from repro_torch.models import api
from repro_torch.models.convert import params_from_jax, to_tensor
from repro_torch.models.transformer import Transformer

F32 = dict(rtol=2e-5, atol=2e-5)
F32_PCAST = dict(rtol=1.5e-2, atol=1.5e-2)
BF16 = dict(rtol=6e-2, atol=6e-2)
B, S = 2, 32


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


def _models(dtype, arch="qwen3-8b"):
    jcfg = dataclasses.replace(jax_arch(arch).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_arch(arch).reduced(), dtype=dtype)
    jm = JaxTransformer(jcfg, remat="none", kv_block=16)
    params = jm.init(jax.random.key(0))
    tm = Transformer(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params), tcfg))
    return jm, params, tm


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _prompt(seed=0, s=S):
    return np.random.default_rng(seed).integers(0, 512, (B, s)).astype(
        np.int32)


def _check_prefill(dtype, tol):
    jm, params, tm = _models(dtype)
    toks = _prompt()
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill({"tokens": torch.as_tensor(toks)})
    assert tl.shape == (B, 1, 512) and tl.dtype == getattr(torch, dtype)
    _close(tl, jl, tol)
    assert len(tc) == jm.cfg.n_layers
    for i, c in enumerate(tc):
        for key in ("k", "v"):
            _close(c[key], jc[key][i], tol)
        np.testing.assert_array_equal(c["pos"].numpy(), jc["pos"][i])
        assert c["idx"] == int(jc["idx"][i]) == S


def test_prefill_f32_algorithm(f32_pv):
    _check_prefill("float32", F32)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_PCAST),
                                       ("bfloat16", BF16)])
def test_prefill_matches_jax(dtype, tol):
    _check_prefill(dtype, tol)


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_decode_teacher_forced_matches_jax(dtype, tol, f32_pv):
    """Eight decode steps, both sides fed the JAX side's greedy tokens;
    the logits are compared at every step."""
    jm, params, tm = _models(dtype)
    toks = _prompt(1)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    _, tc = tm.prefill({"tokens": torch.as_tensor(toks)})
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
    assert [c["idx"] for c in tc] == [S + 8] * jm.cfg.n_layers


def test_init_cache_matches_jax():
    jm, _, tm = _models("bfloat16")
    want = jm.init_cache(B, S)
    got = tm.init_cache(B, S)
    assert len(got) == jm.cfg.n_layers
    for i, c in enumerate(got):
        for key in ("k", "v", "pos"):
            assert c[key].dtype == to_tensor(np.asarray(want[key][i])).dtype
            np.testing.assert_array_equal(
                c[key].float().numpy(), np.asarray(want[key][i], np.float32))
        assert c["idx"] == int(want["idx"][i]) == 0


def test_prefill_then_decode_equals_longer_prefill():
    """Decoding token S after a prefill of S tokens gives the logits a
    prefill of S + 1 tokens ends with (f32: the two paths differ in
    summation order only)."""
    cfg = dataclasses.replace(get_arch("qwen3-8b").reduced(),
                              dtype="float32")
    model = Transformer(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    toks = torch.as_tensor(_prompt(2, S + 1))
    _, cache = model.prefill({"tokens": toks[:, :S]})
    step, _ = model.decode_step(cache, toks[:, S:], torch.full((B, 1), S))
    full, _ = model.prefill({"tokens": toks})
    torch.testing.assert_close(step, full, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen3-8b", "codeqwen1.5-7b",
                                  "qwen1.5-110b", "command-r-35b",
                                  "zamba2-7b"])
def test_param_count_equals_jax_at_full_size(arch):
    """Built on the meta device: no memory for 8-110 B parameters."""
    assert api.param_count(get_arch(arch)) == \
        jax_api.param_count(jax_arch(arch))


def test_state_dict_names_and_bf16_bits_carry_over():
    jm, params, tm = _models("bfloat16")
    host = jax.device_get(params)
    sd = params_from_jax(host, tm.cfg)
    assert set(sd) == set(tm.state_dict())
    wq3 = np.asarray(host["layers"]["attn"]["wq"][3])
    got = tm.state_dict()["layers.3.attn.wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  wq3.view(np.int16))
    # a uint16 bit view (how checkpoints store bf16) reads the same
    np.testing.assert_array_equal(
        to_tensor(wq3.view(np.uint16)).view(torch.int16).numpy(),
        wq3.view(np.int16))


def test_init_matches_jax_distribution():
    cfg = get_arch("qwen3-8b").reduced()
    model = Transformer(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    wi = model.layers[0]["ffn"]["wi"].float()
    assert abs(wi.std().item() - cfg.d_model ** -0.5) < 0.01
    assert torch.all(model.layers[1]["attn"]["q_norm"]["scale"] == 1)
    assert torch.all(model.ln_f["scale"] == 1)


@pytest.mark.parametrize("arch,names", [
    ("mixtral-8x7b", ["layers.3.ffn.router", "layers.3.ffn.wi",
                      "layers.3.ffn.wg", "layers.3.ffn.wo"]),
    ("llama-3.2-vision-11b", ["layers.1.1.attn.wq", "layers.1.1.ffn.wi",
                              "cross.1.gate", "cross.1.wo"])])
def test_moe_and_vlm_families_build(arch, names):
    """MoE (Queue 1 item 5) and the VLM (item 6) build since they serve
    (slice 12); their state-dict names are the JAX tree's paths, each
    leaf's shape the stacked leaf's without its leading axes."""
    cfg = get_arch(arch).reduced()
    jtree = jax.eval_shape(jax_api.build_model(jax_arch(arch).reduced())
                           .init, jax.random.key(0))
    model = api.build_model(cfg, device="cpu")
    sd = model.state_dict()
    assert set(names) <= set(sd)
    stacked = {"/".join(k.key for k in path): leaf.shape
               for path, leaf in jax.tree_util.tree_flatten_with_path(
                   jtree)[0]}
    for name, t in sd.items():
        parts = name.split(".")
        path = "/".join(p for p in parts if not p.isdigit())
        lead = sum(p.isdigit() for p in parts)
        assert stacked[path][lead:] == tuple(t.shape), name
