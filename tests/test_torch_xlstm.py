"""The port's xLSTM (mLSTM and sLSTM blocks, the SSM family) against the
JAX package's, on numpy-made inputs: each block (the mLSTM chunkwise over
one and several chunks, from zeros and from a given state; its one-token
update; the sLSTM scan from its start and from a given state), the reduced
xlstm-350m (4 blocks: two groups of one mLSTM and one sLSTM; d 128, 4
heads of 32, vocab 512) with the reference's weights carried over by
``convert``: prefill logits, 4 decode steps, the loss and every gradient
leaf, the prefill/decode consistency check of
``tests/test_models_smoke.py``, ``init_cache``, the convert round trip, the
parameter count, serving on the CPU (failover bitwise, the stream equal
to the JAX server's); and at full width one sLSTM block
(ROADMAP.md F7): chaotic under one-ulp noise, its gradient growing with
the sequence until it overflows, in the reference as in the port.

Neither block has a TPU kernel in the reference, so the port copies the
reference's arithmetic, its bf16 rounding of the mLSTM's weighted score
tile and v included (``xlstm.py:101-103``): the f32 model is held tightly.

Tolerances and why (each relative to the largest reference value, or per
gradient leaf to its largest |grad|):
  F32 (2e-5)      f32: the same operations, sums in another order (XLA's
                  einsum contractions against torch's): the sLSTM, the
                  mLSTM's states and its one-token update (measured
                  <= 1.2e-6).
  F32_CAST (3e-4) f32 outputs downstream of the copied bf16 rounding: the
                  mLSTM's output and the model's logits. Where the two
                  sides' f32 scores differ in the last bit, a weighted
                  score next to a bf16 rounding boundary rounds the other
                  way, and the output moves by up to 2^-8 of that one term
                  (measured 4e-5 at the test shapes, 1.6e-4 at 2 x 512).
                  Without the cast the gap is 7e-4 to 1.9e-3, which this
                  tolerance tells apart
                  (``test_mlstm_without_the_cast_misses_the_tolerance``).
  F32_GRAD (1e-5) f32 gradients with the bf16 rounding taken out of both
                  sides (the reference's by ``_Float32Jnp``, as
                  ``tests/test_torch_mamba.py`` patches the hybrid's): the
                  same gradient in another order of sums (measured
                  ~1e-6 on the sLSTM block alone).
  F32_GRAD_CAST   f32 gradients as both sides stand (5e-3): the flips of
                  F32_CAST, and of the same rounding of the score tile's
                  cotangent in the backward (both frameworks round it to
                  bf16), through four blocks (measured 1.8e-3).
  BF16 (6e-2)     bf16 end to end: the frameworks round matmul outputs at
                  different points; a few bf16 ulps of logits of ~4 (the
                  dense model's tolerance, tests/test_torch_model.py).
  BF16_GRAD (0.1) bf16 gradients, of each leaf's largest (the roundings
                  above, through the backward; measured 3.9e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.xlstm as JX
from repro.configs import get_arch as jax_arch
from repro.models import api as jax_api
from repro_torch.configs import get_arch
from repro_torch.launch.serve import ReplicatedServer
from repro_torch.models import api, convert
from repro_torch.models import xlstm as X
from repro_torch.models.convert import (params_from_jax, params_to_jax,
                                        to_tensor)
from repro_torch.tree import tree_map

ARCH = "xlstm-350m"
F32, F32_CAST, F32_GRAD, F32_GRAD_CAST = 2e-5, 3e-4, 1e-5, 5e-3
BF16, BF16_GRAD = 6e-2, 0.1
TOL = {"float32": F32, "bfloat16": BF16}
TOL_CAST = {"float32": F32_CAST, "bfloat16": BF16}
B, S = 2, 32
XLSTM_350M_PARAMS = 265_757_776


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


def _pair(rng, shape, dtype):
    """The same values (rounded to ``dtype``) as a jax array and a torch
    tensor."""
    x = jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(
        jnp.dtype(dtype))
    return x, to_tensor(np.asarray(x))


def _block(kind, dtype, seed=1):
    """One block's params (the reference's init, a forget bias of 3) on
    both sides."""
    jc, tc = _cfgs(dtype)
    make = JX.mlstm_params if kind == "mlstm" else JX.slstm_params
    jp = make(jc, jax.random.key(seed), jnp.dtype(dtype))
    tp = {k: (to_tensor(np.asarray(v)) if not isinstance(v, dict) else
              {kk: to_tensor(np.asarray(vv)) for kk, vv in v.items()})
          for k, v in jax.device_get(jp).items()}
    return jc, tc, jp, tp


def _state_pair(rng, shapes, dtype=np.float32):
    """A random recurrent state on both sides (f32, as the model keeps
    it)."""
    j, t = {}, {}
    for k, shape in shapes.items():
        a = rng.standard_normal(shape, dtype=np.float32).astype(dtype)
        j[k], t[k] = jnp.asarray(a), torch.from_numpy(a.copy())
    return j, t


# ---------------------------------------------------------------- mLSTM

@pytest.mark.parametrize("s,chunk", [(32, 256), (64, 16)],
                         ids=["one-chunk", "four-chunks"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("given_state", [False, True])
def test_mlstm_apply_matches_the_reference(s, chunk, dtype, given_state):
    jc, tc, jp, tp = _block("mlstm", dtype)
    rng = np.random.default_rng(s + chunk)
    jx, tx = _pair(rng, (B, s, jc.d_model), dtype)
    h, dh = jc.n_heads, jc.d_model // jc.n_heads
    jst = tst = None
    if given_state:
        jst, tst = _state_pair(rng, {"C": (B, h, dh, dh), "n": (B, h, dh)})
    want, jstate = JX.mlstm_apply(jc, jp, jx, chunk=chunk, state=jst,
                                  return_state=True)
    got, tstate = X.mlstm_apply(tc, tp, tx, chunk=chunk, state=tst,
                                return_state=True)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    _close(got, want, TOL_CAST[dtype])
    for k in ("C", "n"):
        assert tstate[k].dtype == torch.float32
        _close(tstate[k], jstate[k], TOL[dtype])


def test_mlstm_without_the_cast_misses_the_tolerance(monkeypatch):
    """The copied bf16 rounding of the score tile and v is what holds the
    f32 mLSTM within F32_CAST: without it the gap is several times that."""
    monkeypatch.setattr(X, "_bf16", lambda t: t)
    jc, tc, jp, tp = _block("mlstm", "float32")
    jx, tx = _pair(np.random.default_rng(80), (B, 64, jc.d_model),
                   "float32")
    want = np.asarray(JX.mlstm_apply(jc, jp, jx, chunk=16))
    got = X.mlstm_apply(tc, tp, tx, chunk=16).numpy()
    assert np.abs(got - want).max() > 2 * F32_CAST * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_decode_from_a_given_state_matches(dtype):
    jc, tc, jp, tp = _block("mlstm", dtype, seed=2)
    rng = np.random.default_rng(5)
    h, dh = jc.n_heads, jc.d_model // jc.n_heads
    jst, tst = _state_pair(rng, {"C": (B, h, dh, dh), "n": (B, h, dh)})
    for _ in range(3):
        jx, tx = _pair(rng, (B, 1, jc.d_model), dtype)
        want, jst = JX.mlstm_decode(jc, jp, jx, jst)
        got, tst = X.mlstm_decode(tc, tp, tx, tst)
        _close(got, want, TOL[dtype])
        for k in ("C", "n"):
            _close(tst[k], jst[k], TOL[dtype])


def test_mlstm_chunkwise_equals_the_recurrence():
    """The chunked prefill's output and state against the one-token
    update run over the same sequence (both sides of the port, f32): the
    carried state between chunks is the recurrence's (the bf16 rounding
    of the score tile only in the chunked form, so within its share)."""
    _, tc, _, tp = _block("mlstm", "float32", seed=3)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((B, 48, tc.d_model),
                                             dtype=np.float32))
    got, st = X.mlstm_apply(tc, tp, x, chunk=16, return_state=True)
    h, dh = tc.n_heads, tc.d_model // tc.n_heads
    rec = {"C": torch.zeros(B, h, dh, dh), "n": torch.zeros(B, h, dh)}
    outs = []
    for t in range(48):
        y, rec = X.mlstm_decode(tc, tp, x[:, t:t + 1], rec)
        outs.append(y)
    want = torch.cat(outs, 1)
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())
    for k in ("C", "n"):
        assert torch.allclose(st[k], rec[k], rtol=1e-4, atol=1e-4)


def test_mlstm_rejects_a_length_it_cannot_chunk():
    """The reference reshapes S into S // chunk chunks and cannot take a
    remainder; the port raises instead of dropping tokens."""
    _, tc, _, tp = _block("mlstm", "float32")
    x = torch.zeros(1, 40, tc.d_model)
    with pytest.raises(ValueError, match="neither at most 16"):
        X.mlstm_apply(tc, tp, x, chunk=16)
    assert X.mlstm_apply(tc, tp, x[:, :16], chunk=16).shape == (1, 16, 128)


# ---------------------------------------------------------------- sLSTM

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("given_state", [False, True])
def test_slstm_apply_matches_the_reference(dtype, given_state):
    jc, tc, jp, tp = _block("slstm", dtype, seed=4)
    # f_in = int(d 4 / 3) // 128 * 128
    assert tp["up"]["wi"].shape == (128, 128)
    rng = np.random.default_rng(7)
    jx, tx = _pair(rng, (B, S, jc.d_model), dtype)
    h, dh = jc.n_heads, jc.d_model // jc.n_heads
    jst = tst = None
    if given_state:
        jst, tst = _state_pair(rng, {k: (B, h, dh) for k in "hcm"})
        n = np.abs(rng.standard_normal((B, h, dh), dtype=np.float32)) + 0.5
        jst["n"], tst["n"] = jnp.asarray(n), torch.from_numpy(n)
    want, jstate = JX.slstm_apply(jc, jp, jx, state=jst, return_state=True)
    got, tstate = X.slstm_apply(tc, tp, tx, state=tst, return_state=True)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    _close(got, want, TOL[dtype])
    for k in "hcnm":
        assert tstate[k].shape == (B, h, dh)
        assert tstate[k].dtype == torch.float32
        _close(tstate[k], jstate[k], TOL[dtype])


def test_slstm_constants():
    """m starts at -30, n is clamped at 1e-6, f_in is 1,280 at d 1,024,
    the forget bias (mLSTM) is 3 after ``init``."""
    cfg = get_arch(ARCH)
    assert X.slstm_params(cfg, torch.bfloat16, "meta")["up"]["wi"].shape \
        == (1024, 1280)
    st = X._slstm_start(get_arch(ARCH).reduced(), 2, "cpu")
    assert torch.all(st["m"] == -30.0) and not st["h"].any()
    model = X.XLSTM(get_arch(ARCH).reduced(), device="cpu").init(
        torch.Generator().manual_seed(0))
    assert torch.all(model.mlstm[1][0]["bf"] == 3.0)
    assert not model.slstm[0]["b_gates"].any()
    assert torch.all(model.ln_f["scale"] == 1)
    # a shut input gate and an open forget gate over n = 0 leave n at its
    # floor (each head's gates are [z, i, f, o], dh wide)
    tc = get_arch(ARCH).reduced()
    p = {"r_gates": torch.zeros(4, 32, 128)}
    gx = torch.zeros((1, 1, 4, 4, 32))
    gx[..., 1, :], gx[..., 2, :] = -1e4, 1e4
    _, (_, _, n, _) = X._slstm_scan(tc, p, gx.reshape(1, 1, 512),
                                    *(torch.zeros(1, 4, 32),) * 4)
    assert torch.all(n == torch.tensor(1e-6))


# ---------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def models():
    """The reduced model in f32 and bf16 on both sides, the port's from
    the reference's weights."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jc, tc = _cfgs(dtype)
        jm = jax_api.build_model(jc, remat="none", seq_chunk=S)
        params = jm.init(jax.random.key(0))
        tm = api.build_model(tc, device="cpu")
        tm.load_state_dict(params_from_jax(jax.device_get(params), tc))
        out[dtype] = (jm, params, tm)
    return out


def _prompt(seed=0, s=S):
    return np.random.default_rng(seed).integers(0, 512, (B, s),
                                                dtype=np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_four_decode_steps_match(dtype, models):
    jm, params, tm = models[dtype]
    toks = _prompt()
    jl, jcache = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)})
    tl, tcache = tm.prefill({"tokens": torch.as_tensor(toks)})
    assert tl.shape == (B, 1, 512) and tl.dtype == getattr(torch, dtype)
    _close(tl, jl, TOL_CAST[dtype])
    # the cache: the reference's stacked [G, M, ...] / [G, ...] states
    for g in range(2):
        for k in ("C", "n"):
            _close(tcache["mlstm"][g][0][k], jcache["mlstm"][k][g, 0],
                   TOL[dtype])
        for k in "hcnm":
            _close(tcache["slstm"][g][k], jcache["slstm"][k][g], TOL[dtype])
    decode = jax.jit(jm.decode_step)
    pos = np.full((B, 1), S, np.int32)
    for _ in range(4):                 # teacher-forced by the reference
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        jl, jcache = decode(params, jcache, jnp.asarray(tok),
                            jnp.asarray(pos))
        tl, tcache = tm.decode_step(tcache, torch.from_numpy(tok.copy()),
                                    torch.from_numpy(pos.copy()))
        _close(tl, jl, TOL_CAST[dtype])
        pos = pos + 1


class _Float32Jnp:
    """``jax.numpy`` with ``bfloat16`` reading as ``float32``."""

    def __getattr__(self, name):
        return jnp.float32 if name == "bfloat16" else getattr(jnp, name)


@pytest.mark.parametrize("dtype,cast,tol", [
    ("float32", "removed", F32_GRAD), ("float32", "as-is", F32_GRAD_CAST),
    ("bfloat16", "as-is", BF16_GRAD)])
def test_loss_and_every_gradient_match(dtype, cast, tol, models,
                                       monkeypatch):
    if cast == "removed":
        monkeypatch.setattr(JX, "jnp", _Float32Jnp())
        monkeypatch.setattr(X, "_bf16", lambda t: t)
    jm, params, _ = models[dtype]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (B, S + 1), dtype=np.int32)
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:]}
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tc = _cfgs(dtype)
    sd = params_from_jax(jax.device_get(params), tc, "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in sd.items()}
    loss = X.loss_fn(tc, leaves, {k: torch.from_numpy(v.copy())
                                  for k, v in batch.items()}, seq_chunk=S)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(loss.item(), float(want),
                               rtol=1e-5 if dtype == "float32" else 2e-3)
    grads = params_to_jax(dict(zip(
        leaves, torch.autograd.grad(loss, list(leaves.values())))))
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
        gap = np.abs(got_g - want_g).max()
        worst = max(worst, gap / scale)
        assert scale > 0 and gap <= tol * scale, (path, gap, scale)
    print(f"xlstm {dtype} gradients, cast {cast}: worst gap {worst:.3g} "
          f"of the leaf's largest")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_consistency(dtype, models):
    """``tests/test_models_smoke.py:69-107`` on the port, at its
    tolerance (3e-2): decode after a prefill of S tokens gives the logits
    of a prefill of S + 1. The two differ by the chunked form's bf16
    rounding of the score tile, which the one-token update has not (as in
    the reference), so f32 is held no tighter."""
    tol = 3e-2
    _, _, tm = models[dtype]
    toks = _prompt(2, S + 1)
    want, _ = tm.prefill({"tokens": torch.as_tensor(toks)})
    _, cache = tm.prefill({"tokens": torch.as_tensor(toks[:, :S])})
    got, _ = tm.decode_step(cache, torch.as_tensor(toks[:, S:]),
                            torch.full((B, 1), S, dtype=torch.int32))
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)


def test_init_cache_matches_the_reference(models):
    jm, _, tm = models["bfloat16"]
    want = jm.init_cache(3, 16)
    got = tm.init_cache(3, 16)
    for g in range(2):
        for k in ("C", "n"):
            t = got["mlstm"][g][0][k]
            assert t.dtype == torch.float32 and not t.any()
            assert t.shape == want["mlstm"][k].shape[2:]
        for k in "hcnm":
            t = got["slstm"][g][k]
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(want["slstm"][k][g]))
    # no two state entries share storage
    ptrs = []
    tree_map(lambda t: ptrs.append(t.data_ptr()), got)
    assert len(ptrs) == len(set(ptrs)) == 2 * (2 + 4)


def test_convert_round_trip_is_bitwise(models):
    jm, params, tm = models["bfloat16"]
    tree = jax.device_get(params)
    back = params_to_jax(tm.state_dict())
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(convert.stack_plan(tm.state_dict()))
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        assert node.shape == leaf.shape, path
        np.testing.assert_array_equal(node, np.asarray(leaf).view(np.uint16))
    assert "mlstm.1.0.w_up" in tm.state_dict()
    assert "slstm.1.r_gates" in tm.state_dict()


def test_param_count_equals_the_reference():
    for cfg, jcfg in ((get_arch(ARCH), jax_arch(ARCH)),
                      (get_arch(ARCH).reduced(), jax_arch(ARCH).reduced())):
        assert api.param_count(cfg) == jax_api.param_count(jcfg)
    assert api.param_count(get_arch(ARCH)) == XLSTM_350M_PARAMS


# -------------------------------------------------------------- serving

def test_failover_ends_on_the_clean_stream_and_state():
    srv = ReplicatedServer(ARCH, batch=2, prompt_len=16, device="cpu")
    prompts = _prompt(4, 16)
    clean = srv.generate(prompts, 8)
    clean_state = srv.last_report.final_state["cache"]
    faulty = srv.generate(prompts, 8, kill_at=3)
    faulty_state = srv.last_report.final_state["cache"]
    np.testing.assert_array_equal(clean, faulty)
    assert srv.promotions == 1 and srv.failures == 1
    a, b = [], []
    tree_map(a.append, clean_state)
    tree_map(b.append, faulty_state)
    assert len(a) == len(b) == 2 * (2 + 4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(RuntimeError):
        ReplicatedServer(ARCH, batch=2, prompt_len=16, replication=False,
                         device="cpu").generate(prompts, 8, kill_at=2)


def test_stream_equals_the_jax_servers(monkeypatch):
    """Both servers at the reduced config in f32, the port on the JAX
    server's weights, both killed mid-stream."""
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



# --------------------------------------------- full width: F7 (ROADMAP.md)

def _full_width_slstm():
    jc = dataclasses.replace(jax_arch(ARCH), dtype="float32")
    tc = dataclasses.replace(get_arch(ARCH), dtype="float32")
    jp = JX.slstm_params(jc, jax.random.key(1), jnp.float32)
    tp = {k: (to_tensor(np.asarray(v)) if not isinstance(v, dict) else
              {kk: to_tensor(np.asarray(vv)) for kk, vv in v.items()})
          for k, v in jax.device_get(jp).items()}
    return jc, tc, jp, tp


def test_full_width_slstm_is_chaotic():
    """One-ulp noise in a full-width sLSTM block's r_gates (std H^-1/2 =
    0.5 over dh = 256 terms, the reference's init) moves its output a
    little after 8 tokens and by a large share after 32: two devices'
    streams part within tens of tokens (why ``chip_smoke.py`` holds
    xlstm-350m to the CPU block by block)."""
    _, tc, _, tp = _full_width_slstm()
    noisy = dict(tp, r_gates=tp["r_gates"] * (1 + 2 ** -24 * torch.randn(
        tp["r_gates"].shape, generator=torch.Generator().manual_seed(1))))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 32, 1024), dtype=np.float32))
    gaps = []
    for s in (8, 32):
        a = X.slstm_apply(tc, tp, x[:, :s])
        b = X.slstm_apply(tc, noisy, x[:, :s])
        gaps.append(float((a - b).abs().max() / a.abs().max()))
    assert gaps[0] < 1e-4 and gaps[1] > 1e-2, gaps


def test_full_width_slstm_gradient_explodes_in_the_reference_too():
    """The gradient through a full-width sLSTM block grows with the
    sequence, in the reference's arithmetic as in the port's: from 32 to
    96 tokens max |d r_gates| grows by more than 1e9 on both sides (the
    two within 10x of each other; it is non-finite by 256, and the whole
    model's largest gradient squared, AdamW's f32 second moment,
    overflows at 96: tools/xlstm_grad_check.py). So xlstm-350m trains at
    full width only on short sequences (``chip_smoke.py``'s
    TRAIN_SEQ_XLSTM)."""
    jc, tc, jp, tp = _full_width_slstm()
    rng = np.random.default_rng(0)
    tops = []
    for s in (32, 96):
        x = rng.standard_normal((1, s, 1024)).astype(np.float32)
        ct = rng.standard_normal((1, s, 1024)).astype(np.float32)
        jg = np.asarray(jax.grad(lambda p: jnp.sum(
            JX.slstm_apply(jc, p, jnp.asarray(x)) * ct))(jp)["r_gates"])
        leaf = tp["r_gates"].clone().requires_grad_(True)
        out = X.slstm_apply(tc, dict(tp, r_gates=leaf), torch.from_numpy(x))
        (tg,) = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                    [leaf])
        assert np.isfinite(jg).all() and bool(torch.isfinite(tg).all())
        jmax, tmax = float(np.abs(jg).max()), float(tg.abs().max())
        assert 0.1 < tmax / jmax < 10
        tops.append((jmax, tmax))
    assert all(b > 1e9 * a for a, b in zip(*tops))
