"""``kernels/cost.py``: the work each kernel is charged, moved out of
``chip_smoke.py``'s inline formulas. Its bounds are PERF.md section 6's
at the shapes the tables name (to the digits the tables print), and each
function gives exactly what the old inline formula gave over a sweep of
shapes and dtypes (the formulas as ``chip_smoke.py`` wrote them up to
the slice that moved them, kept here as the witness)."""
import itertools

import pytest
import torch

from repro_torch.kernels import cost

BF, F32 = torch.bfloat16, torch.float32
B, S = 4, 512


def _ms(work):
    return cost.bound(work)["bound_ms"]


# (PERF.md's bound ms, its digits, the work at the table's shape)
PERF_BOUNDS = [
    # K1 forward: qwen3-8b's layer's four plain norms (ln1, q_norm,
    # k_norm, ln2), zamba2-7b's Mamba block (ln, out_norm), the fused
    # add + norm at d 4096 and 3584
    (0.0326, 4, [cost.rmsnorm((B, S, 4096), BF),
                 cost.rmsnorm((B, S, 32, 128), BF),
                 cost.rmsnorm((B, S, 8, 128), BF),
                 cost.rmsnorm((B, S, 4096), BF)]),
    (0.0263, 4, [cost.rmsnorm((B, S, 3584), BF),
                 cost.rmsnorm((B, S, 7168), BF)]),
    (0.0200, 4, [cost.add_rmsnorm((B, S, 4096), BF)]),
    (0.0175, 4, [cost.add_rmsnorm((B, S, 3584), BF)]),
    (0.00006, 5, [cost.rmsnorm((B, 1, 3584), BF),
                  cost.rmsnorm((B, 1, 7168), BF)]),
    # K1 at whisper-tiny's d 384 and xlstm-350m's 1,024
    (0.00550, 5, [cost.add_rmsnorm((B, 1500, 384), BF)]),
    (0.00275, 5, [cost.rmsnorm((B, 1500, 384), BF)]),
    (0.00153, 5, [cost.add_rmsnorm((B, 416, 384), BF)]),
    (0.00501, 5, [cost.add_rmsnorm((B, S, 1024), BF)]),
    (0.00250, 5, [cost.rmsnorm((B, S, 1024), BF)]),
    # K2 forward: qwen3-8b, zamba2-7b, the VLM's cross shape, codeqwen's
    # MHA, whisper-tiny's three
    (0.0125, 4, [cost.attention(B, 32, 8, S, S, 128, BF)]),
    (0.0175, 4, [cost.attention(B, 32, 32, S, S, 112, BF)]),
    (0.05428, 5, [cost.attention(B, 32, 8, S, 1600, 128, BF, False)]),
    (0.02003, 5, [cost.attention(B, 32, 32, S, S, 128, BF)]),
    (0.01398, 5, [cost.attention(B, 6, 6, 1500, 1500, 64, BF, False)]),
    (0.00388, 5, [cost.attention(B, 6, 6, 416, 1500, 64, BF, False)]),
    (0.00153, 5, [cost.attention(B, 6, 6, 416, 416, 64, BF)]),
    # K3 forward at zamba2-7b's serve shape, y in f32
    (0.0292, 4, [cost.mamba_scan(B, S, 112, 64, 64, 128, BF, F32)]),
    # backward kernels
    (0.01502, 5, [cost.rmsnorm_bwd((B, S, 32, 128), BF)]),
    (0.00376, 5, [cost.rmsnorm_bwd((B, S, 8, 128), BF)]),
    (0.02630, 5, [cost.rmsnorm_bwd((B, S, 7168), BF)]),
    (0.02004, 5, [cost.add_rmsnorm_bwd((B, S, 4096), BF)]),
    (0.00550, 5, [cost.add_rmsnorm_bwd((B, 1500, 384), BF)]),
    (0.00164, 5, [cost.add_rmsnorm_bwd((B, 448, 384), BF)]),
    (0.00501, 5, [cost.add_rmsnorm_bwd((B, S, 1024), BF)]),
    (0.00376, 5, [cost.rmsnorm_bwd((B, S, 1024), BF)]),
    (0.02504, 5, [cost.attention_bwd(B, 32, 8, S, S, 128, BF)]),
    (0.03506, 5, [cost.attention_bwd(B, 32, 32, S, S, 112, BF)]),
    (0.13571, 5, [cost.attention_bwd(B, 32, 8, S, 1600, 128, BF, False)]),
    (0.04006, 5, [cost.attention_bwd(B, 32, 32, S, S, 128, BF)]),
    (0.03494, 5, [cost.attention_bwd(B, 6, 6, 1500, 1500, 64, BF, False)]),
    (0.01044, 5, [cost.attention_bwd(B, 6, 6, 448, 1500, 64, BF, False)]),
    (0.00329, 5, [cost.attention_bwd(B, 6, 6, 448, 448, 64, BF)]),
    (0.03647, 5, [cost.mamba_scan_bwd(B, S, 112, 64, 64, 128, BF, F32)]),
]


@pytest.mark.parametrize("want,digits,works", PERF_BOUNDS)
def test_bounds_are_perf_mds(want, digits, works):
    assert round(sum(_ms(w) for w in works), digits) == want


def test_k3_backward_fp32_pipe_bound():
    """The FP32-pipe bound of K3's backward products (PERF.md: 0.28155)."""
    w = cost.mamba_scan_bwd(B, S, 112, 64, 64, 128, BF, F32)
    f32 = cost.Work(w.bytes, w.flops, F32)
    assert round(_ms(f32), 5) == 0.28155
    assert cost.bound(f32)["bound_by"] == "operations"


def test_cross_attention_is_operations_bound_at_53_7_gflop():
    w = cost.attention(B, 32, 8, S, 1600, 128, BF, causal=False)
    assert w.flops == 53_687_091_200
    assert cost.bound(w)["bound_by"] == "operations"


# -- the inline formulas as chip_smoke.py wrote them ---------------------

def _old_bound(n_bytes, n_ops, dtype=BF):
    by_bytes = 1e3 * n_bytes / 3.35e12
    by_ops = 1e3 * n_ops / (989e12 if dtype == BF else 67e12)
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _old_attention(b, hq, hkv, sq, skv, d, size, causal):
    q, kv = b * hq * sq * d, b * hkv * skv * d
    pairs = b * hq * (sq * (sq + 1) // 2 if causal else sq * skv)
    return (2 * q + 2 * kv) * size, 4 * d * pairs


def _old_attention_bwd(b, hq, hkv, sq, skv, d, causal):
    q, kv = b * hq * sq * d, b * hkv * skv * d
    pairs = b * hq * (sq * (sq + 1) // 2 if causal else sq * skv)
    return (3 * q + 2 * kv) * 2 + (q + 2 * kv) * 2, 10 * d * pairs


SHAPES = [(4, 512, 4096), (4, 1500, 384), (4, 1, 7168), (3, 17, 8, 128)]


@pytest.mark.parametrize("shape,dtype",
                         list(itertools.product(SHAPES, (BF, F32))))
def test_norms_equal_the_inline_formulas(shape, dtype):
    n, d = 1, shape[-1]
    for s in shape:
        n *= s
    size = 2 if dtype == BF else 4
    assert cost.bound(cost.rmsnorm(shape, dtype)) == \
        _old_bound((2 * n + d) * size, 4 * n, dtype)
    assert cost.bound(cost.add_rmsnorm(shape, dtype)) == \
        _old_bound((4 * n + d) * size, 5 * n, dtype)
    if dtype == BF:   # the backward's bounds were written for bf16
        assert cost.bound(cost.rmsnorm_bwd(shape, dtype)) == \
            _old_bound((3 * n + 2 * d) * 2, 7 * n)
        assert cost.bound(cost.add_rmsnorm_bwd(shape, dtype)) == \
            _old_bound((4 * n + 2 * d) * 2, 8 * n)


ATTENTION = [(4, 32, 8, 512, 512, 128, True), (4, 32, 8, 512, 1600, 128,
                                                 False),
             (4, 6, 6, 1500, 1500, 64, False), (4, 6, 6, 448, 448, 64, True),
             (2, 8, 2, 200, 200, 128, True), (1, 2, 2, 130, 130, 112, False)]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", ATTENTION)
def test_attention_equals_the_inline_formulas(b, hq, hkv, sq, skv, d,
                                              causal):
    for dtype, size in ((BF, 2), (F32, 4)):
        assert cost.bound(cost.attention(b, hq, hkv, sq, skv, d, dtype,
                                         causal)) == \
            _old_bound(*_old_attention(b, hq, hkv, sq, skv, d, size,
                                       causal), dtype)
    assert cost.bound(cost.attention_bwd(b, hq, hkv, sq, skv, d, BF,
                                         causal)) == \
        _old_bound(*_old_attention_bwd(b, hq, hkv, sq, skv, d, causal))


@pytest.mark.parametrize("s,h,p,n,chunk", [(512, 112, 64, 64, 128),
                                           (256, 8, 32, 16, 64)])
def test_scan_equals_the_inline_formulas(s, h, p, n, chunk):
    pairs = chunk * (chunk + 1) // 2
    fwd_ops = 2 * (pairs * n + pairs * p + 2 * chunk * p * n) * \
        (s // chunk) * B * h
    x, bc, g = B * s * h * p, B * s * n, B * s * h
    fwd_bytes = x * 2 + 2 * bc * 2 + 2 * g * 4 + x * 4 + B * h * p * n * 4
    assert cost.bound(cost.mamba_scan(B, s, h, p, n, chunk, BF, F32)) == \
        _old_bound(fwd_bytes, fwd_ops)
    bwd_ops = 2 * (pairs * (3 * n + 2 * p) + 5 * chunk * p * n) * \
        (s // chunk) * B * h
    bwd_bytes = 2 * x * 2 + 2 * 2 * bc * 2 + 4 * g * 4 + x * 4
    w = cost.mamba_scan_bwd(B, s, h, p, n, chunk, BF, F32)
    assert cost.bound(w) == _old_bound(bwd_bytes, bwd_ops)
    assert cost.bound(cost.Work(w.bytes, w.flops, F32)) == \
        _old_bound(bwd_bytes, bwd_ops, F32)


@pytest.mark.parametrize("sq,skv,causal,window", [
    (512, 512, True, 4096), (256, 256, True, 100), (64, 128, True, 0),
    (128, 64, True, 0), (100, 100, False, 30), (7, 7, True, 3)])
def test_visible_pairs_count_the_plain_mask(sq, skv, causal, window):
    """``visible_pairs`` is the number of True entries of the plain
    version's mask (``kernels/ref.py``): causal, windowed, Sq != Skv."""
    q = torch.arange(sq)[:, None]
    k = torch.arange(skv)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        mask &= k <= q
    if window:
        mask &= k > q - window
    assert cost.visible_pairs(sq, skv, causal, window) == int(mask.sum())


def test_tally_work_sums_a_wrappers_calls():
    calls = {((4, 512, 4096), BF): 3, ((4, 1, 4096), BF): 2}
    w = cost.tally_work("rmsnorm", calls)
    assert w.flops == 3 * 4 * 4 * 512 * 4096 + 2 * 4 * 4 * 4096
    assert w.bytes == sum(n * cost.rmsnorm(s, dt).bytes
                          for (s, dt), n in calls.items())
