"""The port's AdamW against the JAX package's on the same params and
grads (made by numpy). The port updates in place; the reference returns
new arrays.

Tolerances: the moments agree to 2e-6 relative (f32; XLA and ATen may
fuse the multiply-adds differently, a few ulp after three steps); f32
params to 1e-6; bf16 params within one bf16 rounding (2^-8 relative) of
the reference's, since an f32 result a few ulp off can round to the
neighbouring bf16 value; the schedule to 2 f32 ulp (``cos`` of XLA's and
numpy's libraries).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw

SHAPES = {"a": (64, 48), "b.c": (33,), "d": (5, 7, 3)}


def _draw(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 0.1
              for k, s in SHAPES.items()} for _ in range(3)]
    return params, grads


def _as(arr, dtype):
    if dtype == "bfloat16":
        return arr.astype(ml_dtypes.bfloat16)
    return arr


def _torch(arr):
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_updates_match_the_reference(dtype):
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    params, grads = _draw(0)
    jp = {k: jnp.asarray(_as(v, dtype)) for k, v in params.items()}
    js = jadamw.init(jp)
    tp = {k: _torch(_as(v, dtype)) for k, v in params.items()}
    ts = adamw.init(tp)
    ptrs = {k: t.data_ptr() for k, t in tp.items()}
    for g in grads:
        jp, js = jadamw.update(jcfg, {k: jnp.asarray(_as(v, dtype))
                                      for k, v in g.items()}, js, jp)
        ts = adamw.update(cfg, {k: _torch(_as(v, dtype))
                                for k, v in g.items()}, ts, tp)
    assert int(ts.step) == int(js.step) == 3
    assert ts.step.dtype == torch.int32
    for k in SHAPES:
        # in place: the same storage carries the new values
        assert tp[k].data_ptr() == ptrs[k]
        for got, want in ((ts.m[k], js.m[k]), (ts.v[k], js.v[k])):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=2e-6, atol=1e-12)
        got = tp[k].float().numpy()
        want = np.asarray(jp[k], np.float32)
        if dtype == "bfloat16":
            assert tp[k].dtype == torch.bfloat16
            np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("step", [1, 50, 100, 5000, 10000])
def test_schedule_matches_the_reference(step):
    cfg = adamw.AdamWConfig(lr=3e-4)
    got = adamw.schedule(cfg, step)
    want = np.asarray(jadamw.schedule(jadamw.AdamWConfig(lr=3e-4),
                                      jnp.float32(step)))
    assert got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want.astype(np.float32), maxulp=2)


def test_chunked_update_is_bitwise_the_whole_leaf(monkeypatch):
    """Large leaves go through in flat chunks (no leaf-sized f32
    temporaries); the result does not depend on the chunk size."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    params, grads = _draw(1)

    def run():
        tp = {k: _torch(_as(v, "bfloat16")) for k, v in params.items()}
        ts = adamw.init(tp)
        for g in grads:
            ts = adamw.update(cfg, {k: _torch(_as(v, "bfloat16"))
                                    for k, v in g.items()}, ts, tp)
        return tp, ts
    whole = run()
    monkeypatch.setattr(adamw, "CHUNK", 100)
    chunked = run()
    for k in SHAPES:
        assert torch.equal(whole[0][k], chunked[0][k])
        assert torch.equal(whole[1].m[k], chunked[1].m[k])
        assert torch.equal(whole[1].v[k], chunked[1].v[k])
