"""The port's kernel layer against the JAX package's.

On the CPU the port's ``ops`` run the plain PyTorch versions; these are
held against ``repro.kernels.ref`` and against the Pallas kernels in
interpret mode over every shape of ``tests/test_kernels.py``, at that
file's tolerances (f32: 2e-5, summation order only; bf16: rtol 2e-2 /
atol 3e-2, one bf16 rounding of an f32 result; the Mamba2 scan 3e-4, the
chunked scan against the exact recurrence in f32). Inputs are made once with
numpy and handed to both sides. The CUDA kernels themselves are compared
with the plain versions in ``test_torch_cuda.py``, which runs on a card.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_attention import (bwd_scratch_floats,
                                                 check_layout,
                                                 flash_attention)
from repro_torch.kernels.mamba_scan import (_tma_copy, mamba_chunk_scan,
                                            tma_ready)
from repro_torch.kernels.rmsnorm import add_rmsnorm, rmsnorm, row_view
from repro_torch.models.convert import to_tensor

RTOL = {"float32": 2e-5, "bfloat16": 2e-2}
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _pair(rng, shape, dtype):
    """The same values as a jax array and a torch tensor (bf16 rounded
    once, by jax, and carried bitwise)."""
    x = jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(
        getattr(jnp, dtype))
    return x, to_tensor(np.asarray(x))


def _close(got, want, dtype):
    np.testing.assert_allclose(
        np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float32),
        np.asarray(want, np.float32), rtol=RTOL[dtype], atol=ATOL[dtype])


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU the wrappers never launch: the counters stay at 0."""
    rmsnorm.launches = flash_attention.launches = 0
    mamba_chunk_scan.launches = add_rmsnorm.launches = 0
    yield
    assert rmsnorm.launches == 0 and flash_attention.launches == 0
    assert mamba_chunk_scan.launches == 0 and add_rmsnorm.launches == 0


# ---------------------------------------------------------------- flash attn

def _attention_case(seed, b, hq, hkv, s, d, dtype, **kw):
    rng = np.random.default_rng(seed)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (b, h, s, d), dtype)
                                    for h in (hq, hkv, hkv))
    got = ops.attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    return got, (jq, jk, jv)


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 4, 4, 128, 64),        # MHA
    (2, 4, 2, 256, 64),        # GQA 2x
    (1, 8, 2, 128, 32),        # GQA 4x
    (2, 2, 1, 192, 128),       # ragged seq vs block
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_causal_matches_ref_and_pallas(b, hq, hkv, s, d, dtype):
    got, (q, k, v) = _attention_case(0, b, hq, hkv, s, d, dtype, causal=True)
    _close(got, jref.flash_attention_ref(q, k, v, causal=True), dtype)
    _close(got, jops.attention(q, k, v, causal=True, q_block=64, kv_block=64,
                               backend="interpret"), dtype)


@pytest.mark.parametrize("window", [64, 128, 192])
def test_attention_sliding_window_matches_ref_and_pallas(window):
    got, (q, k, v) = _attention_case(1, 1, 4, 2, 256, 64, "float32",
                                     causal=True, window=window)
    _close(got, jref.flash_attention_ref(q, k, v, causal=True,
                                         window=window), "float32")
    _close(got, jops.attention(q, k, v, causal=True, window=window,
                               q_block=64, kv_block=64, backend="interpret"),
           "float32")


def test_attention_noncausal_matches_ref_and_pallas():
    got, (q, k, v) = _attention_case(2, 1, 2, 2, 128, 64, "float32",
                                     causal=False)
    _close(got, jref.flash_attention_ref(q, k, v, causal=False), "float32")
    _close(got, jops.attention(q, k, v, causal=False, q_block=64,
                               kv_block=64, backend="interpret"), "float32")


@pytest.mark.parametrize("qb,kb", [(32, 64), (128, 32), (64, 64)])
def test_attention_matches_pallas_at_any_tiling(qb, kb):
    """The port has one tiling of its own; the TPU kernel's output does not
    depend on its tiles, so the port equals it at each of them."""
    got, (q, k, v) = _attention_case(3, 1, 2, 2, 128, 32, "float32")
    _close(got, jops.attention(q, k, v, q_block=qb, kv_block=kb,
                               backend="interpret"), "float32")


@pytest.mark.parametrize("b,h,s,causal,window,dtype", [
    (4, 32, 512, True, 0, "bfloat16"),     # zamba2-7b prefill, MHA
    (1, 2, 256, True, 64, "float32"),      # window of 64
    (1, 2, 128, False, 0, "float32"),      # non-causal
])
def test_attention_head_dim_112_matches_ref(b, h, s, causal, window, dtype):
    """zamba2's shared attention has head dim 112; the serve shape is held
    against the reference, the smaller ones against the Pallas kernel
    too."""
    got, (q, k, v) = _attention_case(7, b, h, h, s, 112, dtype,
                                     causal=causal, window=window)
    _close(got, jref.flash_attention_ref(q, k, v, causal=causal,
                                         window=window), dtype)
    if b * h * s <= 512:
        _close(got, jops.attention(q, k, v, causal=causal, window=window,
                                   q_block=64, kv_block=64,
                                   backend="interpret"), dtype)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (2, 4, 2, 130, 64, True, 0),
    (1, 4, 4, 96, 112, True, 40),
    (1, 2, 1, 70, 32, False, 0),
])
def test_flash_attention_lse_ref_is_the_logsumexp_of_masked_scores(
        b, hq, hkv, s, d, causal, window):
    """The plain version of the forward's optional output: torch.logsumexp
    over the keys each row sees of the reference's scaled scores, and the
    same in jnp on the same numpy inputs."""
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk) = (_pair(rng, (b, h, s, d), "float32")
                          for h in (hq, hkv))
    got = ref.flash_attention_lse_ref(tq, tk, causal=causal, window=window)
    scores = torch.einsum("bhqd,bhkd->bhqk", tq,
                          tk.repeat_interleave(hq // hkv, 1)) * d ** -0.5
    pos = torch.arange(s)
    mask = torch.ones(s, s, dtype=torch.bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    want = torch.logsumexp(torch.where(mask, scores, -torch.inf), -1)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    jscores = jnp.einsum("bhqd,bhkd->bhqk", jq,
                         jnp.repeat(jk, hq // hkv, axis=1)) * d ** -0.5
    jwant = jax.nn.logsumexp(jnp.where(jnp.asarray(mask.numpy()), jscores,
                                       -jnp.inf), axis=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-5,
                               atol=1e-5)


def test_bwd_scratch_pads_bf16_rows_to_whole_tiles():
    assert bwd_scratch_floats(torch.float32, 2, 4, 130) == 2 * 2 * 4 * 130
    assert bwd_scratch_floats(torch.bfloat16, 2, 4, 130) == 2 * 2 * 4 * 192
    assert bwd_scratch_floats(torch.bfloat16, 4, 32, 512) == 2 * 4 * 32 * 512


_BASE = 0x7F00_0000_0000      # a 16-byte aligned device address


def _bshd_view(b, s, h, d, dtype, width=None):
    """The model's [B, H, S, D] view of [B, S, H, width] storage."""
    return torch.empty((b, s, h, width or d), dtype=dtype)[..., :d] \
        .transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,d", [
    (4, 512, 32, 128),         # qwen3-8b prefill q
    (4, 512, 8, 128),          # its k, v
    (4, 512, 32, 112),         # zamba2-7b prefill, head dim 112
    (1, 40, 2, 112),           # a short prompt
])
def test_attention_layout_accepts_the_models_views(dtype, b, s, h, d):
    x = _bshd_view(b, s, h, d, dtype)
    check_layout(x.shape, x.stride(), dtype, _BASE)
    # a head slice of a fused [B, S, Hq + 2 Hkv, D] projection: its base
    # lies whole heads (224 or 256 bytes at D 112, 128) past the storage's
    fused = torch.empty((b, s, 3 * h, d), dtype=dtype)
    v = fused[:, :, 2 * h:].transpose(1, 2)
    check_layout(v.shape, v.stride(), dtype,
                 _BASE + 2 * h * d * dtype.itemsize)


def test_attention_layout_refuses_what_tma_cannot_map():
    bf, f32 = torch.bfloat16, torch.float32
    # rows padded to 132 elements: 264 bytes is no multiple of 16 in bf16,
    # 528 bytes is in f32
    x = _bshd_view(2, 64, 4, 128, bf, width=132)
    with pytest.raises(ValueError, match="multiples of 8"):
        check_layout(x.shape, x.stride(), bf, _BASE)
    y = _bshd_view(2, 64, 4, 128, f32, width=132)
    check_layout(y.shape, y.stride(), f32, _BASE)
    # a base 8 bytes off the 16-byte grid (a slice starting 4 bf16 in)
    z = _bshd_view(2, 64, 4, 128, bf)
    with pytest.raises(ValueError, match="aligned"):
        check_layout(z.shape, z.stride(), bf, _BASE + 8)
    with pytest.raises(ValueError, match="contiguous head dim"):
        t = z.transpose(2, 3)
        check_layout(t.shape, t.stride(), bf, _BASE)
    with pytest.raises(ValueError, match=r"\[B, H, S, D\]"):
        check_layout(z.shape[1:], z.stride()[1:], bf, _BASE)


def test_attention_strided_views_equal_contiguous():
    """The model hands [B, S, H, D] storage in as [B, H, S, D] views."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, 64, h, 32),
                                                   dtype=np.float32))
               for h in (4, 2, 2))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    want = ops.attention(*[t.contiguous() for t in views])
    torch.testing.assert_close(ops.attention(*views), want, rtol=0, atol=0)


# --------------------------------------------------------------- mamba scan

MAMBA_TOL = dict(rtol=3e-4, atol=3e-4)


def _mamba_inputs(seed, b, s, h, p, n, dtype="float32"):
    """x, B, C and dt, da (da = -dt * exp(noise), a negative log decay) as
    jax arrays and torch tensors of the same values."""
    rng = np.random.default_rng(seed)
    x, bm, cm = (_pair(rng, shape, dtype) for shape in
                 ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    da = -dt * np.exp(rng.standard_normal((h,), dtype=np.float32) * 0.1)
    f32 = [(jnp.asarray(a), torch.as_tensor(a)) for a in (dt, da)]
    return [j for j, _ in (x, bm, cm, *f32)], [t for _, t in (x, bm, cm,
                                                               *f32)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 64, 2, 8, 4, 16),
    (2, 128, 3, 16, 8, 32),
    (1, 96, 1, 8, 16, 32),
])
def test_mamba_chunk_scan_matches_ref_and_pallas(b, s, h, p, n, chunk):
    jin, tin = _mamba_inputs(5, b, s, h, p, n)
    y, hf = ops.mamba_chunk_scan(*tin, chunk=chunk)
    assert y.shape == (b, s, h, p) and y.dtype == torch.float32
    assert hf.shape == (b, h, p, n) and hf.dtype == torch.float32
    for want_y, want_h in (jref.mamba_chunk_scan_ref(*jin),
                           jops.mamba_chunk_scan(*jin, chunk=chunk,
                                                 backend="interpret")):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                   **MAMBA_TOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(want_h),
                                   **MAMBA_TOL)


def test_mamba_chunk_invariance():
    """The plain version does not depend on the chunking, and equals the
    Pallas kernel at each of two chunkings (tests/test_kernels.py's
    chunk-invariance case and tolerance)."""
    jin, tin = _mamba_inputs(6, 1, 128, 2, 8, 8)
    y32, h32 = ops.mamba_chunk_scan(*tin, chunk=32)
    y64, h64 = ops.mamba_chunk_scan(*tin, chunk=64)
    torch.testing.assert_close(y32, y64, rtol=0, atol=0)
    torch.testing.assert_close(h32, h64, rtol=0, atol=0)
    for chunk in (32, 64):
        wy, wh = jops.mamba_chunk_scan(*jin, chunk=chunk, backend="interpret")
        np.testing.assert_allclose(y32.numpy(), np.asarray(wy), **MAMBA_TOL)
        np.testing.assert_allclose(h32.numpy(), np.asarray(wh), **MAMBA_TOL)


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_mamba_chunk_scan_bf16_inputs_and_out_dtype(out_dtype):
    """bf16 x, B, C: the plain version computes in f32 and writes y in
    x's dtype (the TPU kernel's) or in ``out_dtype``; the state is f32."""
    jin, tin = _mamba_inputs(8, 2, 64, 3, 16, 8, "bfloat16")
    y, hf = ops.mamba_chunk_scan(*tin, chunk=16, out_dtype=out_dtype)
    assert y.dtype == (out_dtype or torch.bfloat16)
    assert hf.dtype == torch.float32
    wy, wh = jref.mamba_chunk_scan_ref(*jin)
    _close(y, wy, "bfloat16")
    np.testing.assert_allclose(hf.numpy(), np.asarray(wh), **MAMBA_TOL)
    wy, _ = jops.mamba_chunk_scan(*jin, chunk=16, backend="interpret")
    _close(y, wy, "bfloat16")


def test_mamba_chunk_scan_needs_a_dividing_chunk():
    _, tin = _mamba_inputs(9, 1, 48, 1, 8, 4)
    with pytest.raises(ValueError, match="chunk"):
        ops.mamba_chunk_scan(*tin, chunk=32)


def _emulate_tc_scan(x, b, c, dt, da, chunk, terms=3, f64_exponent=True):
    """The bf16 tensor-core kernel's arithmetic, chunk by chunk, in
    float64 sums rounded to f32 where the kernel keeps f32: S = C B^T exact;
    each f32 operand of a product (the decayed scores, h in C h, w_s B_s
    in the carry) as ``terms`` bf16 terms (3: hi + mid + lo, the kernel's;
    2: hi + lo, its earlier two-term design; 1: one rounding); y =
    y_intra + exp(ca_t) y_inter. The decay exponents ca_t - ca_s, ca_T -
    ca_s and ca_t are float64 differences of a float64 cumsum, rounded to
    f32 for exp (the kernel's), or with ``f64_exponent=False`` taken from
    an f32 cumsum (the earlier design's). Test-local: the port does not
    use it."""
    f64, f32, bf = torch.float64, torch.float32, torch.bfloat16

    def parts(v):
        out, rest = [], v
        for _ in range(terms):
            out.append(rest.to(bf).to(f32))
            rest = rest - out[-1]
        return out

    def dot(spec, a, vs):  # sum of the bf16 terms' products, f64 -> f32
        return sum(torch.einsum(spec, a.to(f64), v.to(f64))
                   for v in vs).to(f32)

    def expo(v):  # exp of an exponent formed in the cumsum's precision
        return torch.exp(v.to(f32))

    bsz, s, nh, p = x.shape
    xf, bf_, cf = x.to(f32), b.to(f32), c.to(f32)
    h = torch.zeros((bsz, nh, p, b.shape[-1]), dtype=f32)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    ys = []
    for k in range(s // chunk):
        sl = slice(k * chunk, (k + 1) * chunk)
        xc, bc, cc, dtc = xf[:, sl], bf_[:, sl], cf[:, sl], dt[:, sl]
        ca = torch.cumsum(da[:, sl].to(f64 if f64_exponent else f32), 1)
        cb = torch.einsum("btn,bsn->bts", cc.to(f64), bc.to(f64)).to(f32)
        w = expo(ca[:, :, None] - ca[:, None]) * dtc[:, None]   # [B,T,S,H]
        scores = torch.where(tri[None, :, :, None], cb[..., None] * w, 0.0)
        y_intra = dot("bshp,btsh->bthp", xc, parts(scores))
        y_inter = dot("btn,bhpn->bthp", cc, parts(h))
        ys.append(y_intra + expo(ca)[..., None] * y_inter)
        ca_t = ca[:, -1]                                         # [B,H]
        wb = (expo(ca_t[:, None] - ca) * dtc)[..., None] * \
            bc[:, :, None]                                       # [B,T,H,N]
        h = expo(ca_t)[..., None, None] * h + dot(
            "bshp,bshn->bhpn", xc, parts(wb))
    return torch.cat(ys, 1), h


def _emulate_tc_attention_bwd(q, k, v, o, do, lse, causal, window,
                              dq_parts=1, dq_keys=32, kv_parts=1):
    """The bf16 tensor-core backward's arithmetic (csrc/flash_attention_bwd.cu)
    in f32 on the CPU, for bf16 q, k, v, o, dO: L = lse log2(e) from the
    forward's logsumexp and D_row = rowsum(dO o o); S and dP as f32 sums of
    exact bf16 products; P = 2^(S c - L) (masked: 0) and dS = P (dP -
    D_row) in f32; P rounded to bf16 before dV = P^T dO, dS rounded to bf16
    before dQ = dS K and dK = dS^T Q, with f32 accumulation in the kernels'
    order: dQ over 32-key groups in key order, dK and dV over the (q head
    of the GQA group, 64-row q tile) pairs of each 64-key tile, heads outer;
    dq and dk scaled by D^-1/2 last, each output rounded once to bf16. At
    D 64 each warpgroup of the dk/dv kernel sums its own 64-key tile's
    pairs in that order, and where the dq kernel splits a row block's key
    tiles between its two warpgroups (``dq_parts`` 2: the even and the odd
    64-key tiles) each sums its tiles in key order and the two parts are
    added last. At D 128 for rows that see every key the dq kernel sums dQ
    over whole 64-key tiles in key order (``dq_keys`` 64), and the dk/dv
    kernel shares each 64-key tile's pairs out between its two warpgroups
    (``kv_parts`` 2: pair p, counted heads outer, to warpgroup p % 2), each
    summing its pairs in order; the odd pairs' sum is added to the even
    pairs' last. Sq and Skv may differ (a cross-attention). Test-local: the
    port does not use it."""
    f32, bf = torch.float32, torch.bfloat16
    b_, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = torch.tensor(d ** -0.5, dtype=f32)
    log2e = torch.tensor(1.4426950408889634, dtype=f32)
    c = scale * log2e
    qf, kf, vf, of, dof = (t.to(f32) for t in (q, k, v, o, do))
    L = (lse.to(f32) * log2e)[..., None]
    drow = (dof * of).sum(-1, keepdim=True)
    kr, vr = kf.repeat_interleave(g, 1), vf.repeat_interleave(g, 1)
    qi = torch.arange(sq)[:, None]
    kj = torch.arange(skv)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    sc = qf @ kr.transpose(-1, -2)                       # [B, Hq, Sq, Skv]
    p = torch.where(mask, torch.exp2(sc * c - L), 0.0)
    dp = dof @ vr.transpose(-1, -2)
    ds = (p * (dp - drow)).to(bf).to(f32)
    pb = p.to(bf).to(f32)
    del sc, dp
    dqs = [torch.zeros_like(qf) for _ in range(dq_parts)]
    for k0 in range(0, skv, dq_keys):                     # dQ: key order
        keys = slice(k0, k0 + dq_keys)
        dqs[k0 // 64 % dq_parts] += ds[..., keys] @ kr[:, :, keys]
    dq = dqs[0] if dq_parts == 1 else dqs[0] + dqs[1]
    dks = [torch.zeros_like(kf) for _ in range(kv_parts)]
    dvs = [torch.zeros_like(vf) for _ in range(kv_parts)]
    qs = qf.view(b_, hkv, g, sq, d)
    dos = dof.view(b_, hkv, g, sq, d)
    ps = pb.view(b_, hkv, g, sq, skv)
    dss = ds.view(b_, hkv, g, sq, skv)
    for k0 in range(0, skv, 64):                          # dK, dV: pairs
        pair = 0
        for h in range(g):
            for q0 in range(0, sq, 64):
                rows, keys = slice(q0, q0 + 64), slice(k0, k0 + 64)
                pt = ps[:, :, h, rows, keys].transpose(-1, -2)
                dst = dss[:, :, h, rows, keys].transpose(-1, -2)
                dvs[pair % kv_parts][:, :, keys] += pt @ dos[:, :, h, rows]
                dks[pair % kv_parts][:, :, keys] += dst @ qs[:, :, h, rows]
                pair += 1
    dk, dv = dks[0], dvs[0]
    if kv_parts == 2:
        dk, dv = dks[1] + dks[0], dvs[0] + dvs[1]
    return (dq * scale).to(bf), (dk * scale).to(bf), dv.to(bf)


def _share(got, want):
    """max |got - want| / (3e-2 + 2e-2 |want|): the bf16 tolerance's share
    that the worst element uses (<= 1 passes)."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) /
                        (ATOL["bfloat16"] + RTOL["bfloat16"] *
                         np.abs(want))))


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (4, 32, 8, 512, 128, True, 0),      # qwen3-8b's train shape
    (4, 32, 8, 512, 128, True, 100),    # the same, a window of 100
    (4, 32, 32, 512, 112, True, 0),     # zamba2-7b's train shape, D 112
    # whisper-tiny's non-causal D 64 shapes at batch 1 of its 4 (batches
    # are independent in the kernels): the encoder's 1,500 x 1,500, and
    # the cross-attention of the 448 text rows over the 1,500 frames
    (1, 6, 6, 1500, 64, False, 0),
    pytest.param(1, 6, 6, (448, 1500), 64, False, 0,
                 id="1-6-6-448x1500-64-False-0"),
    # the VLM's cross-attention at batch 1 of its 4: q 512 over 1,600
    # image keys, GQA 4, D 128 (dQ over 64-key tiles, the dk/dv pairs
    # shared out between two warpgroups)
    pytest.param(1, 32, 8, (512, 1600), 128, False, 0,
                 id="1-32-8-512x1600-128-False-0"),
])
def test_tc_attention_bwd_numerics_keep_the_tolerance(b, hq, hkv, s, d,
                                                      causal, window):
    """The bf16 backward kernels round P and dS to bf16 before their
    products (their one departure from the plain version, as the forward
    rounds P); emulated at the train shapes (``s`` is Sq = Skv, or the
    pair (Sq, Skv)), that arithmetic stays within the bf16 tolerance of
    autograd of the plain version and of the JAX package's gradient of its
    jnp attention, on the same numpy inputs. Each output's share is
    printed: the card's checks in ``chip_smoke.py`` report the kernels'
    own."""
    sq, skv = s if isinstance(s, tuple) else (s, s)
    # the dq kernel's split of each row block's key tiles, as its host
    # chooses it at whisper-tiny's train batch of 4 on the H100's 132 SMs
    dq_parts = 1
    if d == 64 and not causal and not window and hq == hkv and skv > 64:
        whole, half = (-(-sq // rows) * hq * 4 for rows in (128, 64))
        dq_parts = 2 if -(-half // 132) < 2 * -(-whole // 132) else 1
    # D 128 with every key visible: flash_bwd_dq128_tc and
    # flash_bwd_dkdv128_tc
    every_key = d == 128 and not causal and not window
    dq_keys, kv_parts = (64, 2) if every_key else (32, 1)
    rng = np.random.default_rng(21)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _pair(rng, (b, h, n, d), "bfloat16")
        for h, n in ((hq, sq), (hkv, skv), (hkv, skv), (hq, sq)))
    o = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    lse = ref.flash_attention_lse_ref(tq, tk, causal=causal, window=window)
    got = _emulate_tc_attention_bwd(tq, tk, tv, o, tdo, lse, causal, window,
                                    dq_parts, dq_keys, kv_parts)
    plain = ref.flash_attention_bwd_ref(tq, tk, tv, tdo, causal=causal,
                                        window=window)
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.flash_attention_ref(
        q_, k_, v_, causal=causal, window=window), jq, jk, jv)
    jgrads = vjp(jdo)
    names = ("dq", "dk", "dv")
    shares = {"plain": {n: _share(g_, w_.float())
                        for n, g_, w_ in zip(names, got, plain)},
              "jax": {n: _share(g_, np.asarray(w_, np.float32))
                      for n, g_, w_ in zip(names, got, jgrads)}}
    print(f"tc attention bwd {(b, hq, hkv, s, d, causal, window)}, dq in "
          f"{dq_parts} part(s) over {dq_keys}-key groups, dk/dv pairs in "
          f"{kv_parts} part(s): share of tolerance {shares}")
    for g_, w_, j_ in zip(got, plain, jgrads):
        _close(g_, w_.float(), "bfloat16")
        _close(g_, np.asarray(j_, np.float32), "bfloat16")


def _emulate_tc_attention_fwd64(q, k, v, parts, causal=False):
    """The 128-key bf16 forward kernels' arithmetic (``flash_fwd64_tc`` at
    D 64 and ``flash_fwd128_tc`` at D 128, with ``parts`` 1, in
    csrc/flash_attention.cu), query head h reading KV head h / group, in
    f32 on the CPU: each of
    ``parts`` warpgroups (2 where the kernel splits an item's keys, else 1)
    runs the online softmax over its 128-key tiles (tile t goes to part
    t % parts), in key order: S = Q K_t^T as f32 sums of exact bf16
    products, the running max m, corr = 2^((m_old - m) c) and p =
    2^(s c - m c) with c = D^-1/2 log2(e), l = l corr + rowsum(p), O =
    O corr + bf16(p) V_t; then the parts are merged in a fixed order (m =
    max(m0, m1), each part scaled by 2^((m_i - m) c)) and O / max(l,
    1e-30) is rounded once to bf16. ``causal`` (``flash_fwd128_tc<true>``,
    one part): each 128-row block q0.. takes the tiles of keys [0,
    min(Skv, q0 + 128)), and a key past a row's position is masked to
    -1e30 before the max. Test-local: the port does not use it."""
    f32, bf = torch.float32, torch.bfloat16
    d, sq, skv = q.shape[-1], q.shape[2], k.shape[2]
    c = torch.tensor(d ** -0.5, dtype=f32) * torch.tensor(
        1.4426950408889634, dtype=f32)
    group = q.shape[1] // k.shape[1]
    qf, kf, vf = (t.to(f32).repeat_interleave(group, 1) if t is not q
                  else t.to(f32) for t in (q, k, v))
    neg_inf = torch.tensor(-1e30, dtype=f32)
    blocks = range(0, sq, 128) if causal else [0]
    out = []
    for q0 in blocks:
        q1 = min(sq, q0 + 128) if causal else sq
        kv_hi = min(skv, q0 + 128) if causal else skv
        qb = qf[:, :, q0:q1]
        state = []
        for part in range(parts):
            m = torch.full(qb.shape[:-1] + (1,), -1e30, dtype=f32)
            l = torch.zeros_like(m)
            acc = torch.zeros_like(qb)
            for t0 in range(128 * part, kv_hi, 128 * parts):
                kt, vt = kf[:, :, t0:t0 + 128], vf[:, :, t0:t0 + 128]
                sc = qb @ kt.transpose(-1, -2)
                if causal:
                    keys = torch.arange(t0, t0 + kt.shape[2])
                    sc = torch.where(
                        keys[None, :] > torch.arange(q0, q1)[:, None],
                        neg_inf, sc)
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                corr = torch.exp2((m - m_new) * c)
                neg = torch.where(m_new == neg_inf, 0.0, -m_new * c)
                p = torch.exp2(sc * c + neg)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + p.to(bf).to(f32) @ vt
                m = m_new
            state.append((m, l, acc))
        m, l, acc = state[0]
        if parts == 2:
            (m0, l0, a0), (m1, l1, a1) = state
            m = torch.maximum(m0, m1)
            w0, w1 = torch.exp2((m0 - m) * c), torch.exp2((m1 - m) * c)
            l, acc = l0 * w0 + l1 * w1, a0 * w0 + a1 * w1
        out.append((acc / torch.clamp(l, min=1e-30)).to(bf))
    return torch.cat(out, 2)


@pytest.mark.parametrize("sq,skv", [(1500, 1500), (416, 1500)],
                         ids=["encoder", "cross"])
@pytest.mark.parametrize("parts", [1, 2])
def test_tc_attention_fwd64_numerics_keep_the_tolerance(sq, skv, parts):
    """The D 64 forward kernel at whisper-tiny's non-causal shapes (six
    heads, batch 1 of its 4: batches are independent in the kernel),
    emulated with its keys in one part or split between its two
    warpgroups and merged (at batch 4 on the H100's 132 SMs the host
    splits the encoder's 1,500 rows and not the cross-attention's 416),
    stays within the bf16 tolerance of the plain version and of the JAX
    package's reference on the same numpy inputs; each share printed."""
    rng = np.random.default_rng(23)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng, (1, 6, n, 64), "bfloat16") for n in (sq, skv, skv))
    got = _emulate_tc_attention_fwd64(tq, tk, tv, parts)
    plain = ref.flash_attention_ref(tq, tk, tv, causal=False)
    want = jref.flash_attention_ref(jq, jk, jv, causal=False)
    shares = {"plain": _share(got, plain.float()),
              "jax": _share(got, np.asarray(want, np.float32))}
    print(f"tc attention fwd D 64 {(sq, skv)}, {parts} part(s): share of "
          f"tolerance {shares}")
    _close(got, plain.float(), "bfloat16")
    _close(got, np.asarray(want, np.float32), "bfloat16")


def test_tc_attention_fwd128_numerics_keep_the_tolerance():
    """The D 128 forward kernel for rows that see every key
    (``flash_fwd128_tc``: 128-key tiles, P rounded to bf16 as it is
    formed) at the VLM's cross-attention, batch 1 of its 4 (batches are
    independent in the kernel): q [1, 32, 512, 128] over k/v [1, 8, 1600,
    128], GQA 4; emulated, it stays within the bf16 tolerance of the plain
    version and of the JAX package's reference on the same numpy inputs;
    each share printed."""
    rng = np.random.default_rng(29)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng, (1, h, n, 128), "bfloat16")
        for h, n in ((32, 512), (8, 1600), (8, 1600)))
    got = _emulate_tc_attention_fwd64(tq, tk, tv, 1)
    plain = ref.flash_attention_ref(tq, tk, tv, causal=False)
    want = jref.flash_attention_ref(jq, jk, jv, causal=False)
    shares = {"plain": _share(got, plain.float()),
              "jax": _share(got, np.asarray(want, np.float32))}
    print(f"tc attention fwd D 128 (512, 1600), GQA 4: share of tolerance "
          f"{shares}")
    _close(got, plain.float(), "bfloat16")
    _close(got, np.asarray(want, np.float32), "bfloat16")


@pytest.mark.parametrize("d", [128, 112])
def test_tc_attention_fwd128_causal_numerics_keep_the_tolerance(d):
    """The D 128 forward kernel for causal rows of unpaired heads
    (``flash_fwd128_tc<true>``: 128-row items over 128-key tiles, the
    tiles that cross the diagonal masked) at codeqwen1.5-7b's MHA, batch
    1 of its 4 (batches are independent in the kernel): q and k/v [1, 32,
    512, 128], causal; and at zamba2-7b's D 112, which the kernel pads to
    128 columns of zeros. Emulated, it stays within the bf16 tolerance of
    the plain version and of the JAX package's reference on the same
    numpy inputs; each share printed."""
    rng = np.random.default_rng(31)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng, (1, 32, 512, d), "bfloat16") for _ in range(3))
    got = _emulate_tc_attention_fwd64(tq, tk, tv, 1, causal=True)
    plain = ref.flash_attention_ref(tq, tk, tv, causal=True)
    want = jref.flash_attention_ref(jq, jk, jv, causal=True)
    shares = {"plain": _share(got, plain.float()),
              "jax": _share(got, np.asarray(want, np.float32))}
    print(f"tc attention fwd D {d} causal (512, 512), MHA: share of "
          f"tolerance {shares}")
    _close(got, plain.float(), "bfloat16")
    _close(got, np.asarray(want, np.float32), "bfloat16")


def _chunked_f64(x, b, c, dt, da, chunk):
    """The chunked scan (the TPU kernel's algorithm) with every operation
    in float64: the yardstick of the kernel's arithmetic."""
    x, b, c, dt, da = (t.to(torch.float64) for t in (x, b, c, dt, da))
    h = torch.zeros((x.shape[0], x.shape[2], x.shape[3], b.shape[-1]),
                    dtype=torch.float64)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    ys = []
    for k in range(x.shape[1] // chunk):
        sl = slice(k * chunk, (k + 1) * chunk)
        xc, bc, cc, dtc = x[:, sl], b[:, sl], c[:, sl], dt[:, sl]
        ca = torch.cumsum(da[:, sl], 1)
        w = torch.exp(ca[:, :, None] - ca[:, None]) * dtc[:, None]
        scores = torch.where(tri[None, :, :, None], torch.einsum(
            "btn,bsn->bts", cc, bc)[..., None] * w, 0.0)
        ys.append(torch.einsum("btsh,bshp->bthp", scores, xc)
                  + torch.exp(ca)[..., None]
                  * torch.einsum("btn,bhpn->bthp", cc, h))
        ca_t = ca[:, -1]
        h = torch.exp(ca_t)[..., None, None] * h + torch.einsum(
            "bshp,bsn,bsh->bhpn", xc, bc, torch.exp(ca_t[:, None] - ca) * dtc)
    return torch.cat(ys, 1), h


def _zamba_scan_case():
    """A reduced zamba2-7b scan (4 of 112 heads; P, N and the chunk as
    served), bf16 x, B, C; the references get the same values in f32."""
    jin, tin = _mamba_inputs(10, 2, 512, 4, 64, 64, "bfloat16")
    return [jnp.asarray(a, jnp.float32) for a in jin], tin


def _excess(got, want):
    """max |got - want| / (atol + rtol |want|) at MAMBA_TOL: <= 1 passes."""
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want)
    return float(np.max(err / (MAMBA_TOL["atol"] +
                               MAMBA_TOL["rtol"] * np.abs(want))))


@pytest.mark.parametrize("reference", ["ref", "pallas"])
def test_mamba_two_term_bf16_products_keep_the_tolerance(reference):
    """On a reduced draw both the kernel's earlier two-term design (two
    bf16 terms for each f32 operand, an f32 cumsum) and its arithmetic
    now (three terms, float64 exponents) stay within 3e-4 of the exact
    recurrence and of the Pallas kernel, on f32 y and h (the serve-shape
    draws below are where the two-term design failed)."""
    jin, tin = _zamba_scan_case()
    want_y, want_h = (jref.mamba_chunk_scan_ref(*jin) if reference == "ref"
                      else jops.mamba_chunk_scan(*jin, chunk=128,
                                                 backend="interpret"))
    for y, h in (_emulate_tc_scan(*tin, chunk=128, terms=2,
                                  f64_exponent=False),
                 _emulate_tc_scan(*tin, chunk=128)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                   **MAMBA_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h),
                                   **MAMBA_TOL)


def test_mamba_one_bf16_rounding_misses_the_tolerance():
    """Why the kernel splits: one bf16 rounding of each f32 operand (the
    JAX model's own cast of the score tile) misses 3e-4 many times over."""
    jin, tin = _zamba_scan_case()
    want_y, want_h = jref.mamba_chunk_scan_ref(*jin)
    y1, h1 = _emulate_tc_scan(*tin, chunk=128, terms=1, f64_exponent=False)
    y2, h2 = _emulate_tc_scan(*tin, chunk=128, terms=2, f64_exponent=False)
    assert _excess(y1, want_y) > 10 and _excess(h1, want_h) > 1
    assert _excess(y2, want_y) <= 1 and _excess(h2, want_h) <= 1


def _serve_draw(seed):
    """The zamba2-7b serve shape (x [4, 512, 112, 64] bf16, B and C
    [4, 512, 64] bf16, dt and da f32) drawn as ``chip_smoke.py`` draws its
    K3 inputs, from a CPU generator."""
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen)
    x, bm, cm = (rand(*shape).to(torch.bfloat16) for shape in
                 ((4, 512, 112, 64), (4, 512, 64), (4, 512, 64)))
    dt = torch.nn.functional.softplus(rand(4, 512, 112))
    da = -dt * torch.exp(rand(112) * 0.1)
    return x, bm, cm, dt, da


@pytest.mark.parametrize("seed", [10, 23])
def test_mamba_kernel_numerics_keep_a_margin_at_the_serve_shape(seed):
    """ROADMAP F4: on these serve-shape draws the earlier arithmetic (f32
    cumsum, two bf16 terms) used more than the whole 3e-4 tolerance on
    f32 y; the kernel's (float64 exponents, three terms) stays within a
    tenth of it on y and h, against the chunked scan in float64 and
    against the JAX reference (the exact f32 recurrence)."""
    tin = _serve_draw(seed)
    want_y, want_h = _chunked_f64(*tin, 128)
    old_y, _ = _emulate_tc_scan(*tin, chunk=128, terms=2,
                                f64_exponent=False)
    assert _excess(old_y, want_y) > 1
    del old_y
    y, h = _emulate_tc_scan(*tin, chunk=128)
    assert _excess(y, want_y) <= 0.1 and _excess(h, want_h) <= 0.1
    del want_y, want_h
    jy, jh = jref.mamba_chunk_scan_ref(*(jnp.asarray(t.float().numpy())
                                         for t in tin))
    assert _excess(y, jy) <= 0.1 and _excess(h, jh) <= 0.1


def _bf16_strided(shape, strides, offset=0):
    base = torch.zeros(offset + 1 + sum((n - 1) * st for n, st in
                                        zip(shape, strides)),
                       dtype=torch.bfloat16)
    return base.as_strided(shape, strides, offset)


def test_mamba_tma_layout_accepts_the_models_views():
    """The zamba2 conv output split into x, B, C views (112 heads of 64, N
    64) suits the tensor maps as it is: no copy on the serve path."""
    xbc = torch.zeros((4, 512, 112 * 64 + 2 * 64), dtype=torch.bfloat16)
    x = xbc[..., :112 * 64].reshape(4, 512, 112, 64)
    b, c = xbc[..., 112 * 64:112 * 64 + 64], xbc[..., 112 * 64 + 64:]
    assert all(tma_ready(t) for t in (x, b, c))
    assert tma_ready(torch.zeros((2, 128, 3, 16), dtype=torch.bfloat16))


@pytest.mark.parametrize("shape,strides,offset", [
    ((1, 64, 4), (256, 4, 1), 0),        # N = 4: rows of 8 bytes
    ((2, 64, 16), (1024, 16, 1), 3),     # base not 16-byte aligned
    ((2, 64, 2, 8), (2048, 20, 8, 1), 0),  # seq stride of 40 bytes
])
def test_mamba_tma_layout_copies_what_the_maps_cannot_address(
        shape, strides, offset):
    t = _bf16_strided(shape, strides, offset)
    t.copy_(torch.randn(shape).to(torch.bfloat16))
    assert not tma_ready(t)
    got = _tma_copy(t)
    assert tma_ready(got) and got.shape == t.shape
    assert torch.equal(got, t)


# ------------------------------------------------------------------- rmsnorm

@pytest.mark.parametrize("shape", [(8, 128), (3, 5, 256), (1, 1, 64),
                                   (6, 384), (2, 3, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_ref_and_pallas(shape, dtype):
    rng = np.random.default_rng(5)
    jx, tx = _pair(rng, shape, dtype)
    jw, tw = _pair(rng, shape[-1:], dtype)
    got = ops.rmsnorm(tx, tw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, jref.rmsnorm_ref(jx, jw), dtype)
    _close(got, jops.rmsnorm(jx, jw, backend="interpret", block_rows=4),
           dtype)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rmsnorm_eps_reaches_plain_version(eps):
    rng = np.random.default_rng(6)
    jx, tx = _pair(rng, (4, 64), "float32")
    jw, tw = _pair(rng, (64,), "float32")
    _close(ops.rmsnorm(tx * 1e-3, tw, eps=eps),
           jref.rmsnorm_ref(jx * 1e-3, jw, eps=eps), "float32")


@pytest.mark.parametrize("shape", [(8, 128), (2, 3, 256), (4, 1, 96),
                                   (6, 384), (2, 3, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rmsnorm_cpu_route_is_the_add_then_the_norm(shape, dtype):
    """The plain route of the fused entry is bitwise the pair the models
    ran before: ``x + r``, then ``rmsnorm_ref`` of the sum."""
    gen = torch.Generator().manual_seed(7)
    x, r = (torch.randn(shape, generator=gen).to(dtype) for _ in range(2))
    w = torch.randn(shape[-1:], generator=gen).to(dtype)
    s, y = ops.add_rmsnorm(x, r, w, eps=1e-6)
    assert s.dtype == y.dtype == dtype and s.shape == y.shape == shape
    torch.testing.assert_close(s, x + r, rtol=0, atol=0)
    torch.testing.assert_close(y, ops.rmsnorm(x + r, w, eps=1e-6), rtol=0,
                               atol=0)


@pytest.mark.parametrize("shape", [(8, 128), (3, 5, 256), (1, 1, 64),
                                   (6, 384), (2, 3, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_rmsnorm_matches_jax_add_and_pallas(shape, dtype):
    """Against JAX's ``x + h`` (the same rounding of the sum, bitwise) and
    the Pallas kernel on that sum in interpret mode."""
    rng = np.random.default_rng(8)
    (jx, tx), (jr, tr) = (_pair(rng, shape, dtype) for _ in range(2))
    jw, tw = _pair(rng, shape[-1:], dtype)
    s, y = ops.add_rmsnorm(tx, tr, tw)
    js = jx + jr
    np.testing.assert_array_equal(np.asarray(s.float()),
                                  np.asarray(js, np.float32))
    _close(y, jref.rmsnorm_ref(js, jw), dtype)
    _close(y, jops.rmsnorm(js, jw, backend="interpret", block_rows=4),
           dtype)


@pytest.mark.parametrize("shape", [(6, 128), (2, 3, 384), (4, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["plain", "fused", "fused_without_ds"])
def test_rmsnorm_bwd_plain_matches_jax_vjp(shape, dtype, kind):
    """The plain K1 backward (autograd of ``ref.rmsnorm_ref``, and of the
    add before it), which the card's backward kernel is held to, against
    ``jax.vjp`` of the JAX package's ``rmsnorm_ref`` on the same numpy
    inputs: (dx, dw), and for the fused entry (dsum, dw) with ds given or
    none (zeros on the JAX side). Tolerance, this file's: f32 2e-5, the
    two autodiffs sum mean(x^2), sum(x g) and dw's rows in other orders;
    bf16 rtol 2e-2 / atol 3e-2, one bf16 rounding of an f32 result (both
    sides add ds to the norm's rounded gradient in bf16)."""
    rng = np.random.default_rng(9)
    (jdy, tdy), (jx, tx) = (_pair(rng, shape, dtype) for _ in range(2))
    jw, tw = _pair(rng, shape[-1:], dtype)
    if kind == "plain":
        got = ref.rmsnorm_bwd_ref(tdy, tx, tw)
        want = jax.vjp(jref.rmsnorm_ref, jx, jw)[1](jdy)
    else:
        jds, tds = _pair(rng, shape, dtype)
        if kind == "fused_without_ds":
            jds, tds = jnp.zeros_like(jds), None
        got = ref.add_rmsnorm_bwd_ref(tdy, tds, tx, tw)
        want = jax.vjp(lambda s, w: (s, jref.rmsnorm_ref(s, w)), jx,
                       jw)[1]((jds, jdy))
    for g, w_ in zip(got, want):
        assert g.dtype == getattr(torch, dtype) and g.shape == w_.shape
        _close(g, w_, dtype)


def test_layers_add_rmsnorm_without_a_pending_branch_is_the_norm():
    """The first norm of a forward has nothing to add: the stream comes
    back as it is and the norm is the plain one."""
    from repro_torch.models import layers as L
    x, w = torch.randn(2, 3, 16), torch.randn(16)
    s, y = L.add_rmsnorm({"scale": w}, x, None)
    assert s is x
    torch.testing.assert_close(y, ops.rmsnorm(x, w), rtol=0, atol=0)


# -------------------------------------------------------------- dispatch

def test_ops_ref_backend_equals_auto_on_cpu():
    x = torch.randn(3, 16)
    w = torch.randn(16)
    torch.testing.assert_close(ops.rmsnorm(x, w, backend="ref"),
                               ops.rmsnorm(x, w), rtol=0, atol=0)


def test_ops_rejects_unknown_backend_and_device():
    """An unknown backend or device raises; a meta tensor takes the
    shape-only op of ``kernels/meta.py`` (the dry run's route)."""
    x = torch.randn(3, 16)
    with pytest.raises(ValueError, match="backend"):
        ops.rmsnorm(x, x[0], backend="pallas")
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="xpu"):
        ops._use_kernel(other, "auto")
    meta = torch.empty(3, 16, device="meta")
    y = ops.rmsnorm(meta, meta[0])
    assert y.device.type == "meta" and y.shape == meta.shape


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback inside a wrapper: it launches its kernel or raises."""
    x = torch.randn(2, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm(x, torch.ones(32))
    with pytest.raises(ValueError, match="CUDA"):
        add_rmsnorm(x, x, torch.ones(32))
    with pytest.raises(ValueError, match="one shape"):
        add_rmsnorm(x, x[0], torch.ones(32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        mamba_chunk_scan(x, x[..., 0, :], x[..., 0, :], x[..., 0],
                         x[..., 0])


@pytest.mark.parametrize("shape,index,want", [
    ((2, 3, 8), (slice(None),), (6, 6, 0, 8)),
    ((2, 3, 8), (slice(None), slice(0, 2)), (4, 2, 24, 8)),
    ((4, 6, 5, 8), (slice(None), slice(None), slice(0, 3)), (72, 3, 40, 8)),
    ((1, 1, 64), (slice(None),), (1, 1, 0, 0)),
])
def test_row_view_addresses_every_row(shape, index, want):
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).view(shape)
    view = x[index]
    rows, inner_n, outer, inner = row_view(view)
    assert (rows, inner_n, outer, inner) == want
    flat = x.reshape(-1)
    d = view.shape[-1]
    starts = [(r // inner_n) * outer + (r % inner_n) * inner
              for r in range(rows)]
    got = torch.stack([flat[s:s + d] for s in starts])
    torch.testing.assert_close(got, view.reshape(rows, d))


def test_row_view_rejects_what_the_kernel_cannot_address():
    x = torch.randn(4, 5, 6, 8)
    with pytest.raises(ValueError, match="two-level"):
        row_view(x[::2, ::2, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        row_view(x.transpose(-1, -2))


def test_build_keys_library_on_source_and_flags(monkeypatch, tmp_path):
    assert build.sources() == ["flash_attention", "flash_attention_bwd",
                               "mamba_scan", "mamba_scan_bwd", "rmsnorm",
                               "rmsnorm_bwd"]
    assert build.headers() == ["hopper_tc.cuh"]
    a = build.library_path("rmsnorm")
    assert a.name.startswith("rmsnorm-") and a.suffix == ".so"
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-G"])
    assert build.library_path("rmsnorm") != a
    # a shared header is part of every library's key
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build.library_path(n) for n in build.sources()}
    with open(tmp_path / "hopper_tc.cuh", "a") as f:
        f.write("// changed\n")
    after = {n: build.library_path(n) for n in build.sources()}
    assert all(before[n] != after[n] for n in before)


def test_build_use_source_moves_one_kernel(monkeypatch, tmp_path):
    # another version of one source builds from its own directory; the
    # other kernels keep the tree's libraries
    monkeypatch.setattr(build, "_SOURCE_DIRS", {})
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "libs")
    other = tmp_path / "parent"
    other.mkdir()
    for f in build.CSRC.iterdir():
        (other / f.name).write_bytes(f.read_bytes())
    with open(other / "mamba_scan_bwd.cu", "a") as f:
        f.write("// the parent's\n")
    tree = {n: build.library_path(n) for n in build.sources()}
    monkeypatch.setattr(build, "_start", lambda name: None)   # no nvcc here
    lib = build.use_source("mamba_scan_bwd", other)
    assert build.source_dir("mamba_scan_bwd") == other.resolve()
    assert lib == build.library_path("mamba_scan_bwd")
    assert lib != tree["mamba_scan_bwd"]
    assert all(build.library_path(n) == tree[n] for n in tree
               if n != "mamba_scan_bwd")
    assert build.source_dir("rmsnorm") == build.CSRC
    build._LIBS["rmsnorm"] = None           # loaded: too late to move it
    with pytest.raises(RuntimeError, match="already loaded"):
        build.use_source("rmsnorm", other)


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()
