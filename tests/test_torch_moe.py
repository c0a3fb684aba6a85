"""The port's MoE (``repro_torch.models.moe``) and the reduced mixtral
model against the JAX package's, on numpy-made inputs (reduced
mixtral-8x7b: 4 layers, d 128, 4 experts top-2, window 64).

Tolerances and why:
  tables (exact)  expert, slot, kept flag and capacity of every assignment:
                  integer bookkeeping over the same probabilities.
  W (1e-6 rel.)   the f32 combine weights: XLA's and torch's exp differ by
                  an ulp (a few ulps after the normalisation); where the
                  probabilities are exact (all logits of a row equal) the
                  weights are equal.
  F32 (2e-5)      f32 ``moe_apply`` against ``_moe_apply_local``, drops
                  present: three matmuls' summation order, relative to the
                  output's largest entry.
  BF16 (3e-2)     bf16 ``moe_apply``: the frameworks round the router
                  logits and each expert product to bf16 at different
                  points; a few bf16 ulps (2^-8) of the largest entry.
  MODEL_F32       the f32 model with the JAX attention's bf16 probability
  (2e-5)          cast removed (``f32_pv``, F6), relative to the largest
                  logit: summation order through 4 layers.
  MODEL_BF16      bf16 end to end: a few bf16 ulps of the largest logit
  (6e-2)          (the dense model's tolerance, tests/test_torch_model.py).

bf16 route flips: a token's route can flip where two of its router
probabilities lie within the logits' bf16 rounding of each other, since
the two frameworks round the router product differently. The bf16 tests
compare the routes first: a token whose expert choices differ must be such
a near tie on the reference's own logits, and the outputs are compared on
the tokens whose tables agree (the flip is counted, never hidden by
drawing other data).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import api as jax_api
from repro.models import moe as JM
from repro.models.transformer import Transformer as JaxTransformer
from repro_torch.configs import get_arch
from repro_torch.models import api, moe
from repro_torch.models.convert import (params_from_jax, params_to_jax,
                                        to_tensor)
from repro_torch.models.transformer import Transformer
from test_torch_model import f32_pv  # noqa: F401  (a fixture)

W = dict(rtol=1e-6, atol=0)
F32 = 2e-5
BF16 = 3e-2
MODEL_F32 = 2e-5
MODEL_BF16 = 6e-2
ARCH = "mixtral-8x7b"
B = 2


def _cfgs(dtype="float32", **kw):
    jc = dataclasses.replace(jax_arch(ARCH).reduced(), dtype=dtype, **kw)
    tc = dataclasses.replace(get_arch(ARCH).reduced(), dtype=dtype, **kw)
    return jc, tc


def _tables_equal(got, want):
    flat_e, slot, w, keep, cap = got
    assert cap == want[4]
    for name, a, b in (("flat_e", flat_e, want[0]), ("slot", slot, want[1]),
                       ("keep", keep, want[3])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    return w.numpy(), np.asarray(want[2])


# ------------------------------------------------------------ dispatch

@pytest.mark.parametrize("s", [1, 32, 128])
@pytest.mark.parametrize("scale", [0.01, 1.0, 4.0])
def test_dispatch_tables_equal_the_reference(s, scale):
    jc, tc = _cfgs()
    logits = (np.random.default_rng(s).standard_normal((s, jc.n_experts))
              * scale).astype(np.float32)
    got = moe.dispatch(tc, torch.as_tensor(logits))
    want = JM._dispatch_one(jc, jnp.asarray(logits), s)
    w, w_ref = _tables_equal(got, want)
    np.testing.assert_allclose(w, w_ref, **W)


def _tied_logits(s, e, rng):
    """Rows with exact ties built in: all experts equal; the top two
    equal; a tie for the k-th place; a tie below it; random rows between."""
    rows = [np.zeros(e), np.r_[1.0, 3.0, 3.0, np.zeros(e - 3)],
            np.r_[3.0, 1.0, 1.0, np.zeros(e - 3)],
            np.r_[0.0, 2.0, 1.0, 1.0, np.zeros(e - 4)][:e],
            np.r_[np.zeros(e - 2), 5.0, 5.0]]
    out = np.stack([rows[i % len(rows)] if i % 2 == 0
                    else rng.standard_normal(e) for i in range(s)])
    return out.astype(np.float32)


@pytest.mark.parametrize("s", [1, 32, 128])
def test_dispatch_breaks_ties_as_lax_top_k(s):
    """Equal probabilities: the lower expert index first, as ``lax.top_k``
    orders them; the expert grouping stable in token order on both
    sides."""
    jc, tc = _cfgs()
    logits = _tied_logits(s, jc.n_experts, np.random.default_rng(7))
    got = moe.dispatch(tc, torch.as_tensor(logits))
    want = JM._dispatch_one(jc, jnp.asarray(logits), s)
    w, w_ref = _tables_equal(got, want)
    np.testing.assert_allclose(w, w_ref, **W)
    # a row of equal logits has exact probabilities on both sides
    np.testing.assert_array_equal(w[:jc.n_experts_per_tok],
                                  w_ref[:jc.n_experts_per_tok])
    assert got[0][:2].tolist() == [0, 1]          # all equal: experts 0, 1


def test_dispatch_of_a_batch_is_per_sequence():
    """The leading batch axis routes each sequence on its own (the
    reference vmaps ``_dispatch_one``)."""
    _, tc = _cfgs()
    logits = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (3, 40, tc.n_experts)).astype(np.float32))
    batched = moe.dispatch(tc, logits)
    for i in range(3):
        one = moe.dispatch(tc, logits[i])
        for a, b in zip(batched[:4], one[:4]):
            assert torch.equal(a[i], b)
        assert batched[4] == one[4]


@pytest.mark.parametrize("s", [1, 2, 16, 128, 512])
def test_capacity_equals_the_reference(s):
    jc, tc = _cfgs()
    full_j, full_t = jax_arch(ARCH), get_arch(ARCH)
    assert moe.capacity(tc, s) == JM._capacity(jc, s)
    assert moe.capacity(full_t, s) == JM._capacity(full_j, s)
    if s == 1:
        assert moe.capacity(full_t, s) == 1       # decode never drops
    if s == 512:
        assert moe.capacity(full_t, s) == 161


def test_moe_capacity_drops_are_bounded():
    """The reference's ``test_models_smoke.py::
    test_moe_capacity_drops_are_bounded``, ported: at capacity factor 1.25
    a near-uniform router keeps more than 85% of 128 tokens' assignments."""
    _, tc = _cfgs()
    gl = np.random.default_rng(3).standard_normal(
        (128, tc.n_experts)).astype(np.float32) * 0.01
    _, _, _, keep, _ = moe.dispatch(tc, torch.as_tensor(gl))
    assert float(keep.float().mean()) > 0.85


# ------------------------------------------------------------ moe_apply

def _moe_inputs(dtype, seed=0, s=64):
    """Reference params and x [B, s, d] in ``dtype`` on both sides."""
    jc, tc = _cfgs(dtype)
    params = JM.moe_params(jc, jax.random.key(seed), jnp.dtype(dtype))
    host = jax.device_get(params)
    rng = np.random.default_rng(seed)
    # a component every token shares skews the routes, so some expert
    # overflows its capacity and drops assignments
    x = (rng.standard_normal((B, s, jc.d_model))
         + 1.5 * rng.standard_normal(jc.d_model)).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    tp = {k: to_tensor(np.asarray(v)) for k, v in host.items()}
    tx = to_tensor(np.asarray(jx))
    return jc, tc, params, jx, tp, tx


def test_moe_apply_f32_matches_the_reference():
    jc, tc, params, jx, tp, tx = _moe_inputs("float32")
    want = np.asarray(JM._moe_apply_local(jc, params, jx))
    got = moe.moe_apply(tc, tp, tx).numpy()
    _, _, _, keep, _ = moe.dispatch(tc, tx @ tp["router"])
    assert not bool(keep.all())                   # drops present
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=F32, atol=F32 * scale)


@pytest.mark.parametrize("s,spread", [(64, 1.5), (32, 0.0), (1, 0.0)])
def test_gathered_buffers_equal_the_reference_scatter(s, spread):
    """The gathered expert buffers hold what the reference's
    ``zeros.at[flat_e, slot].set(xs[tok])`` puts in every slot below the
    capacity (the reference's own tables place each kept assignment), and
    zeros in row ``cap``; exact, with drops present at s 64."""
    jc, tc = _cfgs()
    rng = np.random.default_rng(s)
    x = (rng.standard_normal((B, s, jc.d_model))
         + spread * rng.standard_normal(jc.d_model)).astype(np.float32)
    router = rng.standard_normal((jc.d_model, jc.n_experts)).astype(
        np.float32)
    e, k = jc.n_experts, jc.n_experts_per_tok
    tx = torch.as_tensor(x)
    _, _, _, keep, cap, order, sorted_e = moe._dispatch(
        tc, tx @ torch.as_tensor(router))
    got = moe.buffers(tx, order, sorted_e, e, k, cap).numpy()
    assert got.shape == (e, B, cap + 1, jc.d_model)
    if spread:
        assert not bool(keep.all())               # drops present
    for i in range(B):
        gl = jnp.asarray(x[i] @ router)
        flat_e, slot, _, kept, jcap = JM._dispatch_one(jc, gl, s)
        assert jcap == cap
        flat_e, slot, kept = map(np.asarray, (flat_e, slot, kept))
        want = np.zeros((e, cap + 1, jc.d_model), np.float32)
        tok = np.repeat(np.arange(s), k)
        want[flat_e[kept], slot[kept]] = x[i][tok[kept]]
        np.testing.assert_array_equal(got[:, i], want)


def _flipped_tokens(jc, tc, params, jx, tp, tx):
    """Tokens (batch, seq) whose expert choices differ between the sides,
    checked to be near ties on the reference's own bf16 logits."""
    k = jc.n_experts_per_tok
    jl = np.asarray(jnp.einsum("bsd,de->bse", jx, params["router"]),
                    np.float32)
    tl = (tx @ tp["router"]).float().numpy()
    je = np.stack([np.asarray(JM._dispatch_one(jc, jnp.asarray(jl[i]),
                                               jl.shape[1])[0])
                   for i in range(jl.shape[0])])
    te = moe.dispatch(tc, torch.as_tensor(tl))[0].numpy()
    flips = np.argwhere((je != te).reshape(*je.shape[:1], -1, k).any(-1))
    for bi, si in flips:
        top = np.sort(jl[bi, si])[::-1]
        # the k-th and (k+1)-th logits within one bf16 rounding apart
        assert top[k - 1] - top[k] <= 2 * 2.0 ** -8 * np.abs(top).max()
    return flips, te, je


def test_moe_apply_bf16_matches_the_reference():
    """bf16: the routes are compared first (see the module docstring), the
    outputs on every token whose sequence's tables agree."""
    jc, tc, params, jx, tp, tx = _moe_inputs("bfloat16", seed=1)
    flips, _, _ = _flipped_tokens(jc, tc, params, jx, tp, tx)
    want = np.asarray(JM._moe_apply_local(jc, params, jx), np.float32)
    got = moe.moe_apply(tc, tp, tx).float().numpy()
    # a flip moves other tokens' slots in its expert: compare the
    # sequences without one
    same = sorted(set(range(B)) - {int(bi) for bi, _ in flips})
    assert len(same) >= 1
    scale = np.abs(want).max()
    np.testing.assert_allclose(got[same], want[same], rtol=BF16,
                               atol=BF16 * scale)


def test_decode_token_is_never_dropped():
    """One token (decode): capacity 1 and every assignment kept."""
    _, tc = _cfgs()
    full = get_arch(ARCH)
    for cfg in (tc, full):
        logits = torch.as_tensor(np.random.default_rng(5).standard_normal(
            (4, 1, cfg.n_experts)).astype(np.float32))
        _, slot, _, keep, cap = moe.dispatch(cfg, logits)
        assert cap == 1 and bool(keep.all()) and int(slot.max()) == 0


# --------------------------------------------------------- param counts

@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mixtral-8x22b"])
@pytest.mark.parametrize("active_only", [False, True])
def test_param_count_equals_jax_at_full_size(arch, active_only):
    """Built on the meta device; the experts count at k / E when
    ``active_only``."""
    assert api.param_count(get_arch(arch), active_only) == \
        jax_api.param_count(jax_arch(arch), active_only)


def test_param_count_of_the_served_cut():
    """mixtral-8x7b cut to 16 layers, as ``chip_smoke.py`` serves it."""
    cfg = dataclasses.replace(get_arch(ARCH), n_layers=16)
    jcfg = dataclasses.replace(jax_arch(ARCH), n_layers=16)
    assert api.param_count(cfg) == jax_api.param_count(jcfg) == 23_482_470_400
    assert api.param_count(cfg, True) == \
        jax_api.param_count(jcfg, True) == 6_571_036_672


# ------------------------------------------------------ the reduced model

def _models(dtype, **kw):
    jc, tc = _cfgs(dtype, **kw)
    jm = JaxTransformer(jc, remat="none", kv_block=16)
    params = jm.init(jax.random.key(0))
    tm = Transformer(tc, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params), tc))
    return jm, params, tm


def _prompt(seed, s):
    return np.random.default_rng(seed).integers(0, 512, (B, s)).astype(
        np.int32)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("dtype,tol", [("float32", MODEL_F32),
                                       ("bfloat16", MODEL_BF16)])
def test_prefill_and_decode_match_jax(dtype, tol, f32_pv):
    """Prefill of 32 tokens (drops present: capacity 17 of 64
    assignments), then eight teacher-forced decode steps, both sides fed
    the JAX side's greedy tokens; logits and the KV cache compared."""
    jm, params, tm = _models(dtype)
    s = 32
    toks = _prompt(0, s)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill({"tokens": torch.as_tensor(toks)})
    assert tl.shape == (B, 1, 512) and tl.dtype == getattr(torch, dtype)
    _close(tl, jl, tol)
    for i, c in enumerate(tc):
        for key in ("k", "v"):
            _close(c[key], jc[key][i], tol)
        np.testing.assert_array_equal(c["pos"].numpy(), jc["pos"][i])
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
    assert [c["idx"] for c in tc] == [s + 8] * jm.cfg.n_layers


def test_windowed_prefill_matches_jax(f32_pv):
    """A 96-token prompt, longer than the reduced window of 64: the
    windowed prefill and the 64-slot ring, f32."""
    jm, params, tm = _models("float32")
    toks = _prompt(4, 96)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill({"tokens": torch.as_tensor(toks)})
    _close(tl, jl, MODEL_F32)
    assert tc[0]["k"].shape[1] == 64
    np.testing.assert_array_equal(tc[0]["pos"].numpy(), jc["pos"][0])


def test_prefill_then_decode_equals_longer_prefill():
    """Decoding token S after a prefill of S tokens gives the logits a
    prefill of S + 1 ends with, f32, at the no-drop capacity factor E / k
    (the reference's own test sets it so: which tokens drop depends on the
    sequence length), with S the window, as there: the first decode step
    overwrites position 0 in the ring, which the window no longer sees."""
    _, tc = _cfgs("float32")
    tc = dataclasses.replace(
        tc, capacity_factor=float(tc.n_experts) / tc.n_experts_per_tok)
    model = Transformer(tc, device="cpu").init(
        torch.Generator().manual_seed(0))
    s = tc.sliding_window
    toks = torch.as_tensor(_prompt(2, s + 1))
    _, cache = model.prefill({"tokens": toks[:, :s]})
    step, _ = model.decode_step(cache, toks[:, s:], torch.full((B, 1), s))
    full, _ = model.prefill({"tokens": toks})
    scale = float(full.abs().max())
    torch.testing.assert_close(step, full, rtol=1e-4, atol=1e-4 * scale)


def test_state_dict_names_and_round_trip_are_bitwise():
    """The experts' leaves ``layers/ffn/wi`` [L, E, d, f] become
    ``layers.<l>.ffn.wi`` [E, d, f]; back again, every leaf's bits
    equal."""
    jm, params, tm = _models("bfloat16")
    host = jax.device_get(params)
    sd = tm.state_dict()
    cfg = tm.cfg
    assert sd["layers.2.ffn.wi"].shape == (cfg.n_experts, cfg.d_model,
                                           cfg.d_ff)
    assert sd["layers.0.ffn.router"].shape == (cfg.d_model, cfg.n_experts)
    np.testing.assert_array_equal(
        sd["layers.2.ffn.wo"].view(torch.int16).numpy(),
        np.asarray(host["layers"]["ffn"]["wo"][2]).view(np.int16))
    want = jax.tree_util.tree_flatten_with_path(host)[0]
    got = jax.tree_util.tree_flatten_with_path(params_to_jax(sd))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))


def test_init_follows_the_jax_leaf_rules():
    """Router and experts drawn normal * fan_in^-1/2 with the reference's
    fan-in, the leading dim (E for an expert stack)."""
    _, tc = _cfgs()
    model = Transformer(tc, device="cpu").init(
        torch.Generator().manual_seed(0))
    ffn = model.layers[1]["ffn"]
    assert abs(ffn["router"].std().item() - tc.d_model ** -0.5) < 0.01
    assert abs(ffn["wi"].std().item() - tc.n_experts ** -0.5) < 0.02
