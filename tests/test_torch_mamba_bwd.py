"""K3's backward on the CPU: the plain version
(``ref.mamba_chunk_scan_bwd_ref``, autograd of the exact recurrence)
against ``jax.vjp`` of the JAX package's scan, and the arithmetic of the
CUDA kernels (``kernels/csrc/mamba_scan_bwd.cu``: the f32 FMA route and
the bf16 tensor-core route), emulated here in their order of operations,
against float64 autograd of the plain version.

The kernel's tolerance, fixed here before any card run and used as it
stands by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``: for each
output, |kernel - plain| <= 3e-4 max|plain| + 3e-4 |plain|, the forward's
MAMBA_TOL scaled to the output's largest value (the gradients reach a few
hundred where y is ~10, and dda is a sum over a chunk of terms that
cancel); a bf16 output (dx, dB, dC for bf16 inputs) gets the bf16
tolerance (3e-2 + 2e-2 |plain|, one rounding of an f32 result) on top.
A card run that misses it is a fault of the kernel (ROADMAP.md, F4), not
of the draw.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.mamba_scan import (mamba_chunk_scan,
                                            mamba_chunk_scan_bwd)

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
NAMES = ("dx", "db", "dc", "ddt", "dda")


def bwd_bound(want, dtype):
    """The per-element bound of the tolerance above for one output."""
    want = want.double()
    atol, rtol = 3e-4 * float(want.abs().max()), 3e-4
    if dtype == BF16:
        atol, rtol = atol + 3e-2, rtol + 2e-2
    return atol + rtol * want.abs()


def shares(got, want):
    """Each output's largest |got - want| over its bound (<= 1 passes)."""
    return {name: float(((g.double() - w.double()).abs()
                         / bwd_bound(w, g.dtype)).max())
            for name, g, w in zip(NAMES, got, want)}


def inputs(seed, b, s, h, p, n, dtype=F32, dh=False):
    """x, B, C (``dtype``), dt = softplus(noise), da = -dt exp(0.1 noise),
    dy (f32) and, with ``dh``, a gradient of the final h, from numpy."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape,
                                                    dtype=np.float32))
    x, bm, cm = (rand(*shape).to(dtype) for shape in
                 ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = torch.nn.functional.softplus(rand(b, s, h))
    da = -dt * torch.exp(rand(h) * 0.1)
    return x, bm, cm, dt, da, rand(b, s, h, p), \
        (rand(b, h, p, n) if dh else None)


def emulate_scan_bwd(x, b, c, dt, da, dy, dh, chunk):
    """The kernel's backward, chunk by chunk: the two state passes (h_k
    forward, G_{k+1} in reverse, the forward's carry), then per chunk the
    products in f32 (SE = (C B^T) e^{ca_t - ca_s}, dx, K, dB, dC), ca a
    float64 cumsum, every exponent a float64 difference rounded to f32 for
    exp, q, col, row, r and dca in float64 and dda their reverse cumsum;
    dB and dC summed over heads in float64; outputs rounded once."""
    bsz, s, nh, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    X, B, C, DT, DY = (t.to(F32).reshape(bsz, nc, chunk, *t.shape[2:])
                       for t in (x, b, c, dt, dy))
    ca = torch.cumsum(da.to(F64).reshape(bsz, nc, chunk, nh), 2)
    ea = torch.exp(ca.to(F32))
    last = ca[:, :, -1:]
    wse = torch.exp((last - ca).to(F32))                  # e^{ca_T - ca_t}
    decay = torch.exp(last[:, :, 0].to(F32))              # [b, k, h]
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    e = torch.where(tri[None, None, :, :, None], torch.exp(
        (ca[:, :, :, None] - ca[:, :, None]).to(F32)), 0.0)  # [b,k,t,s,h]

    def carry(state, u, v, w, k):
        acc = torch.einsum("bthp,btn->bhpn", u[:, k] * w[..., None], v[:, k])
        return decay[:, k, :, None, None] * state + acc

    hs, state = [], torch.zeros(bsz, nh, p, n)
    for k in range(nc):
        hs.append(state)
        state = carry(state, X, B, wse[:, k] * DT[:, k], k)
    gs = [None] * nc
    state = torch.zeros(bsz, nh, p, n) if dh is None else dh.to(F32)
    for k in reversed(range(nc)):
        gs[k] = state
        state = carry(state, DY, C, ea[:, k], k)

    dx = torch.empty(bsz, nc, chunk, nh, p)
    db, dc = (torch.empty(bsz, nc, chunk, nh, n) for _ in range(2))
    ddt, dda = (torch.empty(bsz, nc, chunk, nh) for _ in range(2))
    for k in range(nc):
        x_, b_, c_, dt_, dy_, e_ = X[:, k], B[:, k], C[:, k], DT[:, k], \
            DY[:, k], e[:, k]
        g, h, w = gs[k], hs[k], wse[:, k]
        se = torch.einsum("btn,bsn->bts", c_, b_)[..., None] * e_
        acc1 = torch.einsum("btsh,bthp->bshp", se, dy_)
        gb = torch.einsum("bsn,bhpn->bshp", b_, g)
        dx[:, k] = dt_[..., None] * (acc1 + w[..., None] * gb)
        q = (x_.to(F64) * gb.to(F64)).sum(-1)
        col = (x_.to(F64) * acc1.to(F64)).sum(-1)
        kk = torch.einsum("bthp,bshp->btsh", dy_, x_) * e_ * dt_[:, None]
        xg = torch.einsum("bshp,bhpn->bshn", x_, g)
        db[:, k] = torch.einsum("btsh,btn->bshn", kk, c_) \
            + (dt_ * w)[..., None] * xg
        kb = torch.einsum("btsh,bsn->bthn", kk, b_)
        dyh = torch.einsum("bthp,bhpn->bthn", dy_, h)
        dc[:, k] = kb + ea[:, k, ..., None] * dyh
        row = (c_[:, :, None].to(F64) * kb.to(F64)).sum(-1)
        r = (c_[:, :, None].to(F64) * dyh.to(F64)).sum(-1)
        gh = (g.to(F64) * h.to(F64)).sum((-1, -2))
        dtd, wd = dt_.to(F64), w.to(F64)
        dca = row - dtd * col + ea[:, k].to(F64) * r - dtd * wd * q
        dca[:, -1] += decay[:, k].to(F64) * gh + (dtd * wd * q).sum(1)
        dda[:, k] = torch.flip(torch.cumsum(torch.flip(dca, [1]), 1),
                               [1]).to(F32)
        ddt[:, k] = (col + wd * q).to(F32)

    def flat(t):
        return t.reshape(bsz, s, *t.shape[3:])
    return (flat(dx).to(x.dtype), flat(db).to(F64).sum(2).to(b.dtype),
            flat(dc).to(F64).sum(2).to(c.dtype), flat(ddt), flat(dda))


def emulate_tc_scan_bwd(x, b, c, dt, da, dy, dh, chunk, terms=2, cross=1):
    """The bf16 tensor-core kernels' backward (``scan_bwd_tc_states``,
    ``scan_bwd_tc_chunks``), chunk by chunk, in float64 sums rounded to f32
    where the kernels keep f32. Every f32 operand of a product is split
    into ``terms`` bf16 terms (hi = bf16(v), mid = bf16(v - hi), ...; the
    kernels' 2): dy, G_{k+1} and h_k, the masked tiles SE and K, and w_t
    u_t in the state pass; a product of two such operands keeps the term
    pairs (i, j) with i + j <= ``cross`` (the kernels' 1: hi hi, hi mid,
    mid hi). S = C B^T is exact. D = dy x^T is formed once for both
    orientations; col_s = sum_t SE_ts D_ts and row_t = sum_s S_ts K_ts
    (float64 sums of f32 products), q_s = x_s . (B G^T)_s and r_t = C_t .
    (dy h)_t in float64; dx starts from
    e^{ca_T - ca_s} B G^T, dB from dt_s e^{ca_T - ca_s} x G and dC from
    e^{ca_t} dy h (each rounded to f32) before the masked products add
    in; h_k and G_{k+1} follow the FMA state pass's recurrence on the
    chunk-local sums. ca, the exponents, dca and dda as ``emulate_scan_bwd``
    (the order of float64 sums is not modelled)."""
    bsz, s, nh, p = x.shape
    n = b.shape[-1]
    nc = s // chunk

    def split(v):
        out, rest = [], v.to(F32)
        for _ in range(terms):
            out.append(rest.to(BF16).to(F32))
            rest = rest - out[-1]
        return out

    def passes(spec, a_terms, b_terms, pairs):  # f64 sums -> f32
        return sum(torch.einsum(spec, a_terms[i].to(F64), b_terms[j].to(F64))
                   for i, j in pairs).to(F32)

    single = [(i, 0) for i in range(terms)]
    single_b = [(0, j) for j in range(terms)]
    both = [(i, j) for i in range(terms) for j in range(terms)
            if i + j <= cross]
    X, B, C, DT, DY = (t.to(F32).reshape(bsz, nc, chunk, *t.shape[2:])
                       for t in (x, b, c, dt, dy))
    ca = torch.cumsum(da.to(F64).reshape(bsz, nc, chunk, nh), 2)
    ea = torch.exp(ca.to(F32))
    last = ca[:, :, -1:]
    wse = torch.exp((last - ca).to(F32))                  # e^{ca_T - ca_t}
    decay = torch.exp(last[:, :, 0].to(F32))              # [b, k, h]
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    e = torch.where(tri[None, None, :, :, None], torch.exp(
        (ca[:, :, :, None] - ca[:, :, None]).to(F32)), 0.0)  # [b,k,t,s,h]

    def carry(state, u, v, w, k):
        acc = passes("bthp,btn->bhpn", split(u[:, k] * w[..., None]),
                     [v[:, k]], single)
        return decay[:, k, :, None, None] * state + acc

    hs, state = [], torch.zeros(bsz, nh, p, n)
    for k in range(nc):
        hs.append(state)
        state = carry(state, X, B, wse[:, k] * DT[:, k], k)
    gs = [None] * nc
    state = torch.zeros(bsz, nh, p, n) if dh is None else dh.to(F32)
    for k in reversed(range(nc)):
        gs[k] = state
        state = carry(state, DY, C, ea[:, k], k)

    dx = torch.empty(bsz, nc, chunk, nh, p)
    db, dc = (torch.empty(bsz, nc, chunk, nh, n) for _ in range(2))
    ddt, dda = (torch.empty(bsz, nc, chunk, nh) for _ in range(2))
    for k in range(nc):
        x_, b_, c_, dt_, e_ = X[:, k], B[:, k], C[:, k], DT[:, k], e[:, k]
        g, h, w = split(gs[k]), split(hs[k]), wse[:, k]
        dyt = split(DY[:, k])
        st = passes("btn,bsn->bts", [c_], [b_], [(0, 0)])[..., None]
        dm = passes("bthp,bshp->btsh", dyt, [x_], single)
        se = st * e_                                      # [b, t, s, h]
        kk = dm * e_ * dt_[:, None]
        col = (se * dm).to(F64).sum(1)
        row = (st * kk).to(F64).sum(2)
        bg = passes("bsn,bhpn->bshp", [b_], g, single_b)
        q = (x_.to(F64) * bg.to(F64)).sum(-1)
        acc = (w[..., None] * bg).to(F64) + passes(
            "btsh,bthp->bshp", split(se), dyt, both).to(F64)
        dx[:, k] = dt_[..., None] * acc.to(F32)
        xg = passes("bshp,bhpn->bshn", [x_], g, single_b)
        acc = ((dt_ * w)[..., None] * xg).to(F64) + passes(
            "btsh,btn->bshn", split(kk), [c_], single).to(F64)
        db[:, k] = acc.to(F32)
        dyh = passes("bthp,bhpn->bthn", dyt, h, both)
        r = (c_[:, :, None].to(F64) * dyh.to(F64)).sum(-1)
        acc = (ea[:, k, ..., None] * dyh).to(F64) + passes(
            "btsh,bsn->bthn", split(kk), [b_], single).to(F64)
        dc[:, k] = acc.to(F32)
        gh = (gs[k].to(F64) * hs[k].to(F64)).sum((-1, -2))
        dtd, wd = dt_.to(F64), w.to(F64)
        dca = row - dtd * col + ea[:, k].to(F64) * r - dtd * wd * q
        dca[:, -1] += decay[:, k].to(F64) * gh + (dtd * wd * q).sum(1)
        dda[:, k] = torch.flip(torch.cumsum(torch.flip(dca, [1]), 1),
                               [1]).to(F32)
        ddt[:, k] = (col + wd * q).to(F32)

    def flat(t):
        return t.reshape(bsz, s, *t.shape[3:])
    return (flat(dx).to(x.dtype), flat(db).to(F64).sum(2).to(b.dtype),
            flat(dc).to(F64).sum(2).to(c.dtype), flat(ddt), flat(dda))


@pytest.fixture(autouse=True)
def _no_launches():
    mamba_chunk_scan.launches = mamba_chunk_scan_bwd.launches = 0
    yield
    assert mamba_chunk_scan.launches == mamba_chunk_scan_bwd.launches == 0


@pytest.mark.parametrize("b,s,h,p,n,dh", [
    (1, 64, 2, 8, 4, False), (1, 64, 2, 8, 4, True),
    (2, 48, 3, 16, 8, True), (1, 32, 1, 64, 16, False)])
def test_plain_scan_bwd_matches_jax_vjp(b, s, h, p, n, dh):
    """Autograd of the port's exact recurrence against ``jax.vjp`` of the
    reference's (``repro/kernels/ref.py:44``) on the same numpy inputs, f32,
    within 1e-5 of each output's largest value (f32 sums in another
    order; with dh the final h's cotangent, else zero)."""
    args = inputs(1, b, s, h, p, n, dh=dh)
    got = ref.mamba_chunk_scan_bwd_ref(*args)
    jin = [jnp.asarray(t.numpy()) for t in args[:5]]
    _, vjp = jax.vjp(jref.mamba_chunk_scan_ref, *jin)
    dhv = args[6] if dh else torch.zeros(b, h, p, n)
    want = vjp((jnp.asarray(args[5].numpy()), jnp.asarray(dhv.numpy())))
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        assert g.dtype == F32 and g.shape == w.shape, name
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dh", [False, True], ids=["h-unused", "dh"])
def test_scan_bwd_numerics_keep_the_tolerance(dtype, dh):
    """At the train shape's chunk, state and head widths (x [1, 512, 4,
    64], N 64, chunk 128) the kernel's arithmetic uses at most half of the
    tolerance against float64 autograd of the plain version on every
    output (the shares are printed; the card's checks report the kernel's
    own)."""
    args = inputs(2, 1, 512, 4, 64, 64, dtype, dh)
    got = emulate_scan_bwd(*args, chunk=128)
    want = ref.mamba_chunk_scan_bwd_ref(*(None if t is None else t.to(F64)
                                          for t in args))
    for g, w, t in zip(got, want, (args[0], args[1], args[2], args[3],
                                   args[3])):
        assert g.dtype == t.dtype and g.shape == w.shape
    share = shares(got, want)
    print(f"scan bwd emulation {dtype} dh={dh}: shares {share}")
    assert max(share.values()) <= 0.5, share


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 256, 3, 64, 64, 64),    # chunk 64
    (2, 64, 4, 64, 16, 16),     # the reduced zamba2-7b: P 64, N 16, chunk 16
    (1, 120, 5, 32, 8, 40),     # a ragged chunk and an odd head count
])
def test_scan_bwd_emulation_at_other_chunks(b, s, h, p, n, chunk):
    """The same arithmetic at the other shapes the card checks, within
    half of the tolerance against float64 autograd of the plain version."""
    args = inputs(3, b, s, h, p, n, F32, dh=True)
    got = emulate_scan_bwd(*args, chunk=chunk)
    want = ref.mamba_chunk_scan_bwd_ref(*(t.to(F64) for t in args))
    assert max(shares(got, want).values()) <= 0.5


@pytest.mark.parametrize("seed", [2, 3, 4])
@pytest.mark.parametrize("dh", [False, True], ids=["h-unused", "dh"])
def test_tc_scan_bwd_numerics_keep_the_tolerance(seed, dh):
    """The bf16 tensor-core route's arithmetic (two bf16 terms an f32
    operand, three passes where both operands are f32) at the train
    shape's chunk, state and head widths (x [1, 512, 4, 64] bf16, N 64,
    chunk 128, dy f32) uses at most half of the tolerance against float64
    autograd of the plain version on every output, over several draws
    (the shares are printed: ~0.18 on the bf16 outputs, their own
    rounding, ~0.01 on ddt and dda)."""
    args = inputs(seed, 1, 512, 4, 64, 64, BF16, dh)
    got = emulate_tc_scan_bwd(*args, chunk=128)
    want = ref.mamba_chunk_scan_bwd_ref(*(None if t is None else t.to(F64)
                                          for t in args))
    for g, w, t in zip(got, want, (args[0], args[1], args[2], args[3],
                                   args[3])):
        assert g.dtype == t.dtype and g.shape == w.shape
    share = shares(got, want)
    print(f"tc scan bwd emulation seed={seed} dh={dh}: shares {share}")
    assert max(share.values()) <= 0.5, share


@pytest.mark.parametrize("seed", [2, 3])
def test_tc_scan_bwd_without_cross_terms_misses_the_tolerance(seed):
    """Why SE^T dy and dy h take three passes: with hi hi alone (the next
    cheaper split, one pass fewer each) dx misses the tolerance on these
    draws (1.6x and 2.4x) while the kernels' split keeps it."""
    args = inputs(seed, 1, 512, 4, 64, 64, BF16)
    want = ref.mamba_chunk_scan_bwd_ref(*(None if t is None else t.to(F64)
                                          for t in args))
    cheap = shares(emulate_tc_scan_bwd(*args, chunk=128, cross=0), want)
    kept = shares(emulate_tc_scan_bwd(*args, chunk=128), want)
    assert cheap["dx"] > 1.5 and max(kept.values()) <= 0.5, (cheap, kept)


@pytest.mark.parametrize("b,s,h,p,n,chunk,dy_bf16", [
    (2, 256, 3, 64, 64, 64, True),   # chunk 64, dy in bf16
    (2, 64, 4, 64, 16, 16, False),   # the reduced zamba2-7b: P 64, N 16
    (1, 256, 5, 64, 64, 128, False),  # an odd head count
])
def test_tc_scan_bwd_emulation_at_other_chunks(b, s, h, p, n, chunk,
                                                dy_bf16):
    """The tensor-core route's arithmetic at the other bf16 shapes the
    card checks, with dh, within half of the tolerance against float64
    autograd of the plain version."""
    x, bm, cm, dt, da, dy, dh = inputs(3, b, s, h, p, n, BF16, dh=True)
    if dy_bf16:
        dy = dy.to(BF16)
    got = emulate_tc_scan_bwd(x, bm, cm, dt, da, dy, dh, chunk=chunk)
    want = ref.mamba_chunk_scan_bwd_ref(*(t.to(F64) for t in
                                          (x, bm, cm, dt, da, dy, dh)))
    assert max(shares(got, want).values()) <= 0.5


@pytest.mark.parametrize("out_dtype", [None, F32])
def test_ops_scan_on_the_cpu_gives_the_plain_gradient(out_dtype):
    """On the CPU ``ops.mamba_chunk_scan`` with grad is the plain version:
    its gradient equals ``mamba_chunk_scan_bwd_ref``'s bitwise, and no
    kernel launches (the autouse fixture)."""
    x, bm, cm, dt, da, dy, dh = inputs(4, 2, 32, 3, 8, 4, dh=True)
    leaves = [t.clone().requires_grad_(True) for t in (x, bm, cm, dt, da)]
    y, h = ops.mamba_chunk_scan(*leaves, chunk=16, out_dtype=out_dtype)
    assert y.grad_fn is not None and h.grad_fn is not None
    got = torch.autograd.grad([y, h], leaves, [dy.to(y.dtype), dh])
    want = ref.mamba_chunk_scan_bwd_ref(x, bm, cm, dt, da, dy.to(y.dtype),
                                        dh)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_scan_bwd_wrapper_refuses_cpu_tensors():
    x, bm, cm, dt, da, dy, _ = inputs(5, 1, 32, 1, 8, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        mamba_chunk_scan_bwd(x, bm, cm, dt, da, dy, chunk=16)
