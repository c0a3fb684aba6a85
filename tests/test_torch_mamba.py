"""The port's Mamba2 block against the JAX package's, at reduced dims
(d_model 128, d_inner 256, P 64, H 4, N 16, chunk 16): the same numpy-made
input and the JAX block's weights handed to both sides.

``mamba2_apply(return_state=True)`` is compared at S a multiple of the
chunk, S not a multiple (the padding path) and S < chunk, and
``mamba2_decode`` over four steps from the JAX prefill state.

Tolerances and why:
  F32_ALGO (2e-5)   f32, with the JAX scan's bf16 cast of the intra-chunk
                    score tile and x removed by the ``f32_scan`` fixture (a
                    test-local patch): the chunked SSD against the port's
                    exact per-step recurrence, summation order only.
  F32 (1e-2)        f32 as the JAX block stands (``mamba2.py:138-140``
                    casts the score tile and x to bf16 before their
                    product; the port keeps the scan in f32 as the TPU
                    kernel does): about one bf16 rounding of y_intra.
  BF16 (6e-2)       bf16 end to end: the frameworks round matmul and conv
                    outputs at different points; a few bf16 ulps.
The recurrent state is compared relative to its largest entry (it grows to
~30 over a sequence), the conv state exactly in f32 (the same bf16/f32
sums in the same order) and within one bf16 ulp in bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba2 as JM2
from repro.configs import get_arch as jax_arch
from repro_torch.configs import get_arch
from repro_torch.kernels.mamba_scan import mamba_chunk_scan
from repro_torch.models import mamba2 as M2
from repro_torch.models.convert import to_tensor
from repro_torch.tree import tree_map

F32_ALGO = dict(rtol=2e-5, atol=2e-5)
F32 = dict(rtol=1e-2, atol=1e-2)
BF16 = dict(rtol=6e-2, atol=6e-2)
B = 2


class _Float32Jnp:
    """``jax.numpy`` with ``bfloat16`` reading as ``float32``."""

    def __getattr__(self, name):
        return jnp.float32 if name == "bfloat16" else getattr(jnp, name)


@pytest.fixture
def f32_scan(monkeypatch):
    """Keep the JAX block's intra-chunk product in f32."""
    monkeypatch.setattr(JM2, "jnp", _Float32Jnp())


@pytest.fixture(autouse=True)
def _no_launches():
    mamba_chunk_scan.launches = 0
    yield
    assert mamba_chunk_scan.launches == 0


def _setup(dtype):
    jcfg = dataclasses.replace(jax_arch("zamba2-7b").reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_arch("zamba2-7b").reduced(), dtype=dtype)
    jprm = JM2.mamba2_params(jcfg, jax.random.key(0), getattr(jnp, dtype))
    tprm = tree_map(lambda a: to_tensor(np.asarray(a)), jax.device_get(jprm))
    return jcfg, tcfg, jprm, tprm


def _x(seed, s, d, dtype):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (B, s, d), dtype=np.float32)).astype(getattr(jnp, dtype))
    return x, to_tensor(np.asarray(x))


def _close(got, want, tol, scale=1.0):
    np.testing.assert_allclose(got.float().numpy() / scale,
                               np.asarray(want, np.float32) / scale, **tol)


def _check_state(got, want, tol):
    scale = float(np.abs(np.asarray(want["h"])).max())
    _close(got["h"], want["h"], tol, scale)
    assert got["h"].dtype == torch.float32
    assert got["conv"].dtype == to_tensor(np.asarray(want["conv"])).dtype
    _close(got["conv"], want["conv"],
           F32_ALGO if got["conv"].dtype == torch.float32 else BF16)


def test_dims_of_the_reduced_block():
    cfg = get_arch("zamba2-7b").reduced()
    assert M2.dims(cfg) == (256, 4, 64, 16) and cfg.ssm_chunk == 16
    assert M2.dims(get_arch("zamba2-7b")) == (7168, 112, 64, 64)


@pytest.mark.parametrize("s", [32, 24, 10])        # multiple, padded, < chunk
def test_apply_f32_algorithm(s, f32_scan):
    jcfg, tcfg, jprm, tprm = _setup("float32")
    jx, tx = _x(s, s, jcfg.d_model, "float32")
    jy, jst = JM2.mamba2_apply(jcfg, jprm, jx, return_state=True)
    ty, tst = M2.mamba2_apply(tcfg, tprm, tx, return_state=True)
    assert ty.shape == tx.shape and ty.dtype == tx.dtype
    _close(ty, jy, F32_ALGO)
    _check_state(tst, jst, F32_ALGO)


@pytest.mark.parametrize("s", [32, 24, 10])
@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_apply_matches_jax(s, dtype, tol):
    jcfg, tcfg, jprm, tprm = _setup(dtype)
    jx, tx = _x(s, s, jcfg.d_model, dtype)
    jy, jst = JM2.mamba2_apply(jcfg, jprm, jx, return_state=True)
    ty, tst = M2.mamba2_apply(tcfg, tprm, tx, return_state=True)
    assert ty.dtype == getattr(torch, dtype)
    _close(ty, jy, tol)
    _check_state(tst, jst, tol)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_ALGO),
                                       ("bfloat16", BF16)])
def test_decode_matches_jax(dtype, tol):
    """Four one-token steps from the JAX prefill state (the decode
    recurrence has no bf16 cast on either side)."""
    jcfg, tcfg, jprm, tprm = _setup(dtype)
    jx, _ = _x(0, 24, jcfg.d_model, dtype)
    _, jst = JM2.mamba2_apply(jcfg, jprm, jx, return_state=True)
    tst = tree_map(lambda a: to_tensor(np.asarray(a)), jax.device_get(jst))
    for step in range(4):
        jt, tt = _x(100 + step, 1, jcfg.d_model, dtype)
        jy, jst = JM2.mamba2_decode(jcfg, jprm, jt, jst)
        ty, tst = M2.mamba2_decode(tcfg, tprm, tt, tst)
        assert ty.shape == (B, 1, jcfg.d_model)
        _close(ty, jy, tol)
        _check_state(tst, jst, tol)


def test_prefill_state_continues_as_decode():
    """The state after S tokens, stepped once, equals the state after
    S + 1 tokens (f32: summation order only)."""
    cfg = dataclasses.replace(get_arch("zamba2-7b").reduced(),
                              dtype="float32")
    _, _, _, prm = _setup("float32")
    _, x = _x(7, 33, cfg.d_model, "float32")
    _, st = M2.mamba2_apply(cfg, prm, x[:, :32], return_state=True)
    y1, st1 = M2.mamba2_decode(cfg, prm, x[:, 32:], st)
    y_all, st_all = M2.mamba2_apply(cfg, prm, x, return_state=True)
    torch.testing.assert_close(y1, y_all[:, 32:], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st1["h"], st_all["h"], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st1["conv"], st_all["conv"], rtol=0, atol=0)


def test_causal_conv_state_is_last_inputs():
    _, _, _, prm = _setup("float32")
    xbc = torch.randn(B, 9, prm["conv_w"].shape[1])
    _, state = M2._causal_conv(xbc, prm["conv_w"], prm["conv_b"])
    torch.testing.assert_close(state, xbc[:, -3:], rtol=0, atol=0)
    short = xbc[:, :2]                          # shorter than K - 1
    _, state = M2._causal_conv(short, prm["conv_w"], prm["conv_b"])
    assert state.shape == (B, 3, xbc.shape[2])
    torch.testing.assert_close(state[:, 1:], short, rtol=0, atol=0)
    assert torch.all(state[:, 0] == 0)


def test_empty_state_matches_jax():
    jcfg, tcfg, _, _ = _setup("bfloat16")
    want = JM2.empty_state(jcfg, B, jnp.bfloat16)
    got = M2.empty_state(tcfg, B, torch.bfloat16, "cpu")
    for key in ("h", "conv"):
        assert got[key].dtype == to_tensor(np.asarray(want[key])).dtype
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      np.asarray(want[key], np.float32))
