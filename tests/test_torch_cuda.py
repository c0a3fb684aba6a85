"""The port on the card: each CUDA kernel (forward and backward) against
its plain PyTorch version, the kernel path of the
reduced models (serving, and a train step of the dense model, the VLM and
the hybrid) against its CPU path, the
in-memory checkpoint store and the recorder on card state, and the
simulated runtime's apps (HPCG, CloverLeaf, PIC: bitwise reruns, the card
against the CPU within ``SIMRT_TOL``, checkpoints across devices).

Every test here carries the ``cuda`` marker and skips without a card. The
file imports neither jax nor the JAX package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 2e-5 (summation order only); bf16 rtol 2e-2 / atol 3e-2
(one bf16 rounding of an f32 result; the bf16 attention kernel also
rounds its softmax weights p to bf16 before the PV product) —
``tests/test_kernels.py``'s; the Mamba2 scan 3e-4 on f32 outputs (the
chunked scan against the exact recurrence, that file's sweep tolerance);
its backward 3e-4 of each output's largest |plain| + 3e-4 |plain|, the
bf16 tolerance on top for a bf16 output (``tests/test_torch_mamba_bwd.py``);
the apps ``SIMRT_TOL`` of each state tensor's largest magnitude (float64
sums in other orders on the card: cuBLAS dots, reductions, the deposit's
sorted runs, the scan's products; ~1e-16 relative a sum, carried a few
steps), and the same particle count on every rank.
"""
import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import FTConfig
from repro_torch.ft import FTSession
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.mamba_scan import (mamba_chunk_scan,
                                            mamba_chunk_scan_bwd)
from repro_torch.kernels.rmsnorm import (add_rmsnorm, add_rmsnorm_bwd,
                                         rmsnorm, rmsnorm_bwd)
from repro_torch.launch import train
from repro_torch.launch.serve import ReplicatedServer
from repro_torch.models import transformer, zamba
from repro_torch.models.transformer import Transformer
from repro_torch.models.zamba import Zamba
from repro_torch.store.backend import MemBackend

# cuBLAS reproducibility under deterministic algorithms (the apps' tests)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

RTOL = {"float32": 2e-5, "bfloat16": 2e-2}
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
MAMBA_TOL = dict(rtol=3e-4, atol=3e-4)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               rtol=RTOL[dtype], atol=ATOL[dtype])


# (rows, d) of every K1 call of the served paths (qwen3-8b and zamba2-7b,
# prefill at 4 x 512 rows and decode at 4), then ragged row counts, other
# widths (the generic kernels) and a row longer than registers hold
K1_SHAPES = [(2048, 4096), (4, 512, 32, 128), (16384, 128), (2048, 3584),
             (2048, 7168), (4, 4096), (4, 3584), (4, 7168), (4, 1, 32, 128),
             (32, 128), (1003, 128), (3, 5, 256), (65541, 128), (1003, 4096),
             (37, 200), (9, 1000), (3, 40960)]


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("shape", K1_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain(cuda_device, shape, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = _rand(gen, shape, dtype)
    w = _rand(gen, shape[-1:], dtype)
    before = rmsnorm.launches
    got = ops.rmsnorm(x, w)
    assert rmsnorm.launches == before + 1
    _close(got, ref.rmsnorm_ref(x, w), dtype)
    assert torch.equal(got, ops.rmsnorm(x, w))         # bitwise rerun


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_reads_strided_and_unaligned_views(cuda_device,
                                                          dtype):
    """The qk-norm heads sliced out of a fused [B, S, Hq + 2 Hkv, D]
    projection (a two-level row view, no copy), and rows one element off
    the 16-byte grid (the scalar path)."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    fused = _rand(gen, (4, 512, 48, 128), dtype)
    unaligned = _rand(gen, (64, 4097), dtype)[:, 1:]
    for x in (fused[:, :, :32], fused[:, :, 32:40], unaligned,
              _rand(gen, (33, 131), dtype)):
        w = _rand(gen, x.shape[-1:], dtype)
        _close(ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w), dtype)


@pytest.mark.parametrize("shape", [(4, 512, 4096), (4, 512, 3584),
                                   (4, 1, 4096), (4, 1, 3584), (1003, 4096),
                                   (37, 200), (3, 40960)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_rmsnorm_is_bitwise_the_unfused_pair(cuda_device, shape, dtype):
    """The fused residual add + norm: s is bitwise ``x + r`` and y bitwise
    the plain kernel's norm of s (the same reduction); y also within the
    tolerance of the plain version; one launch, reruns bitwise."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x, r = _rand(gen, shape, dtype), _rand(gen, shape, dtype)
    w = _rand(gen, shape[-1:], dtype)
    before = add_rmsnorm.launches
    s, y = ops.add_rmsnorm(x, r, w)
    assert add_rmsnorm.launches == before + 1
    assert torch.equal(s, torch.add(x, r))
    assert torch.equal(y, ops.rmsnorm(s, w))
    _close(y, ref.add_rmsnorm_ref(x, r, w)[1], dtype)
    again = ops.add_rmsnorm(x, r, w)
    assert torch.equal(s, again[0]) and torch.equal(y, again[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_rmsnorm_scalar_path(cuda_device, dtype):
    """Unaligned x and r: s is still bitwise the add; y is held to the
    plain version (the scalar path reduces in another order than the
    vector path that s, a new tensor, takes)."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x, r = (_rand(gen, (64, 4097), dtype)[:, 1:] for _ in range(2))
    w = _rand(gen, (4096,), dtype)
    s, y = ops.add_rmsnorm(x, r, w)
    assert torch.equal(s, x + r)
    _close(y, ref.add_rmsnorm_ref(x, r, w)[1], dtype)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (4, 32, 8, 512, 128, True, 0),
    (2, 2, 1, 192, 128, True, 0),
    (1, 4, 2, 256, 64, True, 128),
    (1, 2, 2, 128, 64, False, 0),
    (1, 8, 2, 128, 32, True, 0),
    (4, 32, 32, 512, 112, True, 0),
    (1, 2, 2, 256, 112, True, 64),
    (1, 2, 2, 128, 112, False, 0),
    # what the bf16 tensor-core kernel must mask or pad: a key tail that
    # is no multiple of its 64-key tiles (GQA 4x), a prompt shorter than
    # one tile at D 112 (columns 112..127 of the second box padded), a
    # window that ends inside a tile, and no causal limit at all
    (2, 8, 2, 200, 128, True, 0),
    (1, 2, 2, 40, 112, True, 0),
    (1, 4, 4, 256, 112, True, 100),
    (1, 4, 2, 192, 128, False, 0),
    # rows whose first 64-key tile lies wholly before their window
    (3, 5, 5, 300, 64, True, 70),
    # codeqwen1.5-7b's MHA (group 1) at full width and reduced (Fig 10)
    (4, 32, 32, 512, 128, True, 0),
    (4, 4, 4, 64, 32, True, 0),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernel_matches_plain(cuda_device, b, hq, hkv, s, d,
                                        causal, window, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=cuda_device)
               .to(getattr(torch, dtype)).transpose(1, 2)
               for h in (hq, hkv, hkv))
    before = flash_attention.launches
    got = ops.attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == before + 1
    _close(got, ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window), dtype)
    assert torch.equal(got, ops.attention(q, k, v, causal=causal,
                                          window=window))   # bitwise rerun


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
    (4, 32, 8, 512, 1600, 128),   # llama-3.2-vision's cross-attention
    (1, 4, 2, 40, 1000, 128),     # ragged on both sides
    (2, 8, 2, 96, 40, 64),        # more queries than keys
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernel_sq_ne_skv_matches_plain(cuda_device, b, hq, hkv,
                                                  sq, skv, d, dtype):
    """Non-causal with Sq != Skv (the VLM's prompt over its image
    memory), as the model lays q and k/v out."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=cuda_device)
               .to(getattr(torch, dtype)).transpose(1, 2)
               for h, s in ((hq, sq), (hkv, skv), (hkv, skv)))
    before = flash_attention.launches
    at_shape = flash_attention.by_shape[(sq, skv, False)]
    got = ops.attention(q, k, v, causal=False)
    assert flash_attention.launches == before + 1
    assert flash_attention.by_shape[(sq, skv, False)] == at_shape + 1
    assert got.shape == q.shape
    _close(got, ref.flash_attention_ref(q, k, v, causal=False), dtype)
    assert torch.equal(got, ops.attention(q, k, v, causal=False))


def _mamba_inputs(dev, b, s, h, p, n, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x, bm, cm = (rand(*shape).to(dtype) for shape in
                 ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = torch.nn.functional.softplus(rand(b, s, h))
    da = -dt * torch.exp(rand(h) * 0.1)
    return x, bm, cm, dt, da


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (4, 512, 112, 64, 64, 128),     # zamba2-7b prefill
    (1, 64, 2, 8, 4, 16),           # tests/test_kernels.py's sweep
    (2, 128, 3, 16, 8, 32),
    (1, 96, 1, 8, 16, 32),
    (2, 40, 4, 64, 16, 40),         # T = S < 128, not a power of two
    # what the bf16 tensor-core kernel tiles: chunk 64, P and N below 64
    # (zero-filled columns), a ragged T of 40 at full P and N over several
    # chunks, and an odd head count (a CTA's second head is spare)
    (2, 256, 4, 64, 64, 64),
    (2, 128, 3, 32, 16, 64),
    (1, 120, 2, 64, 64, 40),
    (1, 256, 5, 64, 64, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_kernel_matches_plain(cuda_device, b, s, h, p, n, chunk,
                                         dtype):
    args = _mamba_inputs(cuda_device, b, s, h, p, n, getattr(torch, dtype))
    before = mamba_chunk_scan.launches
    y, hf = ops.mamba_chunk_scan(*args, chunk=chunk, out_dtype=torch.float32)
    assert mamba_chunk_scan.launches == before + 1
    wy, wh = ref.mamba_chunk_scan_ref(*args, out_dtype=torch.float32)
    torch.testing.assert_close(y, wy, **MAMBA_TOL)
    torch.testing.assert_close(hf, wh, **MAMBA_TOL)
    again = ops.mamba_chunk_scan(*args, chunk=chunk, out_dtype=torch.float32)
    assert torch.equal(y, again[0]) and torch.equal(hf, again[1])
    yb, _ = ops.mamba_chunk_scan(*args, chunk=chunk)     # y in x's dtype
    assert yb.dtype == args[0].dtype
    assert torch.equal(yb, y.to(yb.dtype))     # one rounding of the f32 y


@pytest.mark.parametrize("seed", [1, 2, 3, 5, 6, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_serve_shape_on_more_draws(cuda_device, seed, dtype):
    """The zamba2-7b serve shape on more draws, at the unchanged 3e-4: the
    worst of its 14.7M outputs is where the kernels' arithmetic shows
    (ROADMAP F4)."""
    args = _mamba_inputs(cuda_device, 4, 512, 112, 64, 64,
                         getattr(torch, dtype), seed)
    y, hf = ops.mamba_chunk_scan(*args, chunk=128, out_dtype=torch.float32)
    wy, wh = ref.mamba_chunk_scan_ref(*args, out_dtype=torch.float32)
    torch.testing.assert_close(y, wy, **MAMBA_TOL)
    torch.testing.assert_close(hf, wh, **MAMBA_TOL)


def test_mamba_scan_kernel_chunk_invariance(cuda_device):
    args = _mamba_inputs(cuda_device, 1, 128, 2, 8, 8, torch.float32)
    y32, h32 = ops.mamba_chunk_scan(*args, chunk=32)
    y64, h64 = ops.mamba_chunk_scan(*args, chunk=64)
    torch.testing.assert_close(y32, y64, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h32, h64, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_kernel_reads_strided_views(cuda_device, dtype):
    """The model hands in split views of its conv output; the result is
    bitwise that of contiguous inputs."""
    b, s, h, p, n = 2, 64, 4, 64, 16
    xbc = torch.randn(b, s, h * p + 2 * n, device=cuda_device).to(
        getattr(torch, dtype))
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    _, _, _, dt, da = _mamba_inputs(cuda_device, b, s, h, p, n,
                                    torch.float32)
    got = ops.mamba_chunk_scan(x, bm, cm, dt, da, chunk=32)
    want = ops.mamba_chunk_scan(x.contiguous(), bm.contiguous(),
                                cm.contiguous(), dt, da, chunk=32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _cuda_kernels(fn):
    """Names of the CUDA kernels that ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.parametrize("dtype,tensor_cores", [("bfloat16", True),
                                                ("float32", False)])
def test_mamba_scan_routes_by_dtype(cuda_device, dtype, tensor_cores):
    """bf16 runs the tensor-core kernel, f32 the FMA kernel."""
    args = _mamba_inputs(cuda_device, 1, 128, 2, 64, 64,
                         getattr(torch, dtype))
    names = [nm for nm in _cuda_kernels(lambda: ops.mamba_chunk_scan(
        *args, chunk=64, out_dtype=torch.float32)) if "mamba_ssd_scan" in nm]
    assert len(names) == 1, names
    assert ("mamba_ssd_scan_tc" in names[0]) == tensor_cores, names


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_tc_reruns_are_bitwise(cuda_device, out_dtype):
    """The serve shape three times, other launches in between: fixed
    scan, sums and launch, no atomics."""
    args = _mamba_inputs(cuda_device, 4, 512, 112, 64, 64, torch.bfloat16)
    first = ops.mamba_chunk_scan(*args, chunk=128, out_dtype=out_dtype)
    for _ in range(2):
        ops.mamba_chunk_scan(*args, chunk=64)
        again = ops.mamba_chunk_scan(*args, chunk=128, out_dtype=out_dtype)
        assert torch.equal(first[0], again[0])
        assert torch.equal(first[1], again[1])


def test_reduced_model_kernel_path_matches_cpu(cuda_device):
    cfg = dataclasses.replace(get_arch("qwen3-8b").reduced(), dtype="float32")
    cpu = Transformer(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = Transformer(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 96), dtype=np.int32))
    lc, _ = cpu.prefill({"tokens": toks})
    lg, _ = gpu.prefill({"tokens": toks.to(cuda_device)})
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)


def test_serve_failover_identical_stream_on_card(cuda_device):
    prompts = np.random.default_rng(0).integers(0, 400, (2, 16),
                                                dtype=np.int32)
    srv = ReplicatedServer("qwen3-8b", batch=2, prompt_len=16)
    clean = srv.generate(prompts, 8)
    faulty = srv.generate(prompts, 8, kill_at=3)
    np.testing.assert_array_equal(clean, faulty)
    assert srv.promotions == 1


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama-3.2-vision-11b"])
def test_reduced_moe_and_vlm_kernel_path_matches_cpu(cuda_device, arch):
    """Prefill (the VLM with random image embeddings and nonzero gates)
    and four greedy steps, f32: summation order only."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    cpu = Transformer(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    if cfg.family == "vlm":
        for i, cp in enumerate(cpu.cross):
            cp["gate"].fill_(0.5 - i)
    gpu = Transformer(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (2, 32), dtype=np.int32))}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.as_tensor(rng.standard_normal(
            (2, cfg.n_image_tokens, cfg.d_model), dtype=np.float32))
    lc, cc = cpu.prefill(batch)
    lg, cg = gpu.prefill({k: t.to(cuda_device) for k, t in batch.items()})
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)
    pos = torch.full((2, 1), 32, dtype=torch.int32)
    for _ in range(4):
        tok = torch.argmax(lc[:, -1], -1)[:, None].to(torch.int32)
        lc, cc = cpu.decode_step(cc, tok, pos)
        lg, cg = gpu.decode_step(cg, tok.to(cuda_device), pos.to(cuda_device))
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)
        pos = pos + 1


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama-3.2-vision-11b"])
def test_moe_and_vlm_serve_failover_identical_stream_on_card(cuda_device,
                                                             arch):
    prompts = np.random.default_rng(0).integers(0, 400, (2, 16),
                                                dtype=np.int32)
    srv = ReplicatedServer(arch, batch=2, prompt_len=16)
    clean = srv.generate(prompts, 8)
    clean_state = _tensors(srv.last_report.final_state["cache"])
    faulty = srv.generate(prompts, 8, kill_at=3)
    np.testing.assert_array_equal(clean, faulty)
    assert srv.promotions == 1
    assert all(torch.equal(a, b) for a, b in zip(
        clean_state, _tensors(srv.last_report.final_state["cache"])))


@pytest.mark.parametrize("s", [96, 32])
def test_reduced_zamba_kernel_path_matches_cpu(cuda_device, s):
    """Windowed prefill (96 > window 64) and the F3 ring overwrite (32),
    then four greedy steps; f32, summation order only."""
    cfg = dataclasses.replace(get_arch("zamba2-7b").reduced(),
                              dtype="float32")
    cpu = Zamba(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = Zamba(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, s), dtype=np.int32))
    lc, cc = cpu.prefill({"tokens": toks})
    lg, cg = gpu.prefill({"tokens": toks.to(cuda_device)})
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)
    pos = torch.full((2, 1), s, dtype=torch.int32)
    for _ in range(4):
        tok = torch.argmax(lc[:, -1], -1)[:, None].to(torch.int32)
        lc, cc = cpu.decode_step(cc, tok, pos)
        lg, cg = gpu.decode_step(cg, tok.to(cuda_device), pos.to(cuda_device))
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)
        pos = pos + 1


def test_zamba_serve_failover_identical_stream_on_card(cuda_device):
    prompts = np.random.default_rng(0).integers(0, 400, (2, 16),
                                                dtype=np.int32)
    srv = ReplicatedServer("zamba2-7b", batch=2, prompt_len=16)
    clean = srv.generate(prompts, 8)
    faulty = srv.generate(prompts, 8, kill_at=3)
    np.testing.assert_array_equal(clean, faulty)
    assert srv.promotions == 1


def _tensors(tree):
    out = []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            out += _tensors(v)
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int64, torch.bool])
def test_memory_backend_round_trips_card_state(cuda_device, dtype):
    """Card tensors through the store: bands are host arrays, and the
    restore puts every tensor back on the card, bitwise, each in storage
    of its own; a strided view stores only its elements."""
    g = torch.Generator(device="cuda").manual_seed(3)
    base = torch.randn((6, 64, 32), generator=g, device="cuda") * 50
    state = {"k": base.to(dtype), "v": base[:, ::4, 1:9].to(dtype)
             if dtype != torch.bool else base[:, ::4, 1:9] > 0,
             "pos": torch.arange(6, device="cuda", dtype=torch.int32)}
    session = FTSession(ft=FTConfig(mode="combined"), n_logical_workers=8,
                        workers_per_node=4)
    backend = MemBackend(session)
    backend.save(3, state)
    for ws in backend.store.stores.values():
        for ss in ws.values():
            assert all(isinstance(b, np.ndarray) and not b.flags.writeable
                       for b in ss.bands.values())
    like = {k: torch.zeros_like(v) for k, v in state.items()}
    got, step = backend.restore(like)
    assert step == 3
    for key, want in state.items():
        assert got[key].is_cuda and got[key].dtype == want.dtype
        assert torch.equal(got[key], want)
    ptrs = {t.untyped_storage().data_ptr() for t in _tensors(got)}
    assert len(ptrs) == 3


@pytest.mark.parametrize("mode,kills,interval", [
    ("combined", {4: [1], 8: [9]}, 4.0), ("checkpoint", {7: [2]}, 3.0)])
def test_served_restart_from_partner_memory_on_card(cuda_device, mode, kills,
                                                    interval):
    """The reduced qwen3-8b decode loop on the card under the checkpoint
    strategies: the restart restores the rings onto the card, and the
    stream and the final state equal the clean run's bit for bit."""
    prompts = np.random.default_rng(0).integers(0, 400, (2, 16),
                                                dtype=np.int32)
    srv = ReplicatedServer("qwen3-8b", batch=2, prompt_len=16)
    clean = srv.generate(prompts, 12)
    clean_state = _tensors(srv.last_report.final_state["cache"])
    session = FTSession(ft=FTConfig(mode=mode, ckpt_backend="memory",
                                    ckpt_interval_s=interval),
                        injector=dict(kills), n_logical_workers=8,
                        workers_per_node=4)
    rep = session.run(srv.workload(prompts), 12)
    assert rep.restarts == 1
    assert [e.detail["restore_backend"] for e in rep.events
            if e.kind == "restart_elastic"] == ["memory"]
    np.testing.assert_array_equal(
        np.concatenate(rep.final_state["out"], axis=1), clean)
    state = _tensors(rep.final_state["cache"])
    assert all(t.is_cuda for t in state)
    assert all(torch.equal(a, b) for a, b in zip(state, clean_state))


def test_recorder_launches_nothing_on_the_card(cuda_device):
    """A served run with the recorder attached launches the same kernels
    as one without it, and its fan-out counters carry the batch bytes."""
    prompts = np.random.default_rng(0).integers(0, 400, (2, 16),
                                                dtype=np.int32)
    launches = []
    for obs in (None, True):
        srv = ReplicatedServer("qwen3-8b", batch=2, prompt_len=16,
                               topology="fattree", obs=obs)
        for fn in (rmsnorm, add_rmsnorm, flash_attention):
            fn.launches = 0
        srv.generate(prompts, 6, kill_at=2)
        launches.append([fn.launches for fn in (rmsnorm, add_rmsnorm,
                                                flash_attention)])
    assert launches[0] == launches[1] and min(launches[0]) > 0
    c = srv.last_report.obs_metrics["counters"]
    assert c["comm.bytes.coll.cmp"] == 2 * 16 * 4
    assert srv.last_report.obs_metrics["links"]["max_contended"]["busy_s"] > 0


# ------------------------------------------------------ backward kernels

def _bwd_close(got, want, dtype, rows=None):
    """Backward tolerances are the forward's; K1's dw sums ``rows`` rows,
    each carrying its row's f32 rstd, so its f32 atol grows as
    sqrt(rows)."""
    for i, (g, w) in enumerate(zip(got, want)):
        atol = ATOL[dtype]
        if rows is not None and i == 1 and dtype == "float32":
            atol *= rows ** 0.5
        torch.testing.assert_close(g.float().cpu(), w.float().cpu(),
                                   rtol=RTOL[dtype], atol=atol)


@pytest.mark.parametrize("shape", [(4, 512, 32, 128), (2048, 4096),
                                   (2048, 3584), (1003, 128), (37, 200)],
                         ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_matches_plain(cuda_device, shape, dtype):
    gen = torch.Generator(device="cuda").manual_seed(5)
    dt = getattr(torch, dtype)
    dy, x = (torch.randn(shape, generator=gen, device="cuda").to(dt)
             for _ in range(2))
    w = torch.randn(shape[-1], generator=gen, device="cuda").to(dt)
    got = rmsnorm_bwd(dy, x, w)
    _bwd_close(got, ref.rmsnorm_bwd_ref(dy, x, w), dtype,
               rows=x.numel() // shape[-1])
    again = rmsnorm_bwd(dy, x, w)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ds = torch.randn(shape, generator=gen, device="cuda").to(dt)
    for d_s in (ds, None):
        got = add_rmsnorm_bwd(dy, d_s, x, w)
        _bwd_close(got, ref.add_rmsnorm_bwd_ref(dy, d_s, x, w), dtype,
                   rows=x.numel() // shape[-1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_reads_strided_and_unaligned_rows(cuda_device, dtype):
    gen = torch.Generator(device="cuda").manual_seed(6)
    dt = getattr(torch, dtype)
    fused = torch.randn(4, 64, 48, 128, generator=gen, device="cuda").to(dt)
    x = fused[:, :, :32]                        # a qk-norm head slice
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(dt)
    w = torch.randn(128, generator=gen, device="cuda").to(dt)
    _bwd_close(rmsnorm_bwd(dy, x, w), ref.rmsnorm_bwd_ref(dy, x, w), dtype,
               rows=4 * 64 * 32)
    xu = torch.randn(64, 4097, generator=gen, device="cuda").to(dt)[:, 1:]
    dyu = torch.randn(64, 4097, generator=gen, device="cuda").to(dt)[:, 1:]
    wu = torch.randn(4096, generator=gen, device="cuda").to(dt)
    _bwd_close(rmsnorm_bwd(dyu, xu, wu), ref.rmsnorm_bwd_ref(dyu, xu, wu),
               dtype, rows=64)


ATTENTION_BWD_CASES = [
    (4, 32, 8, 512, 128, True, 0),             # qwen3-8b's train shape
    (4, 32, 32, 512, 112, True, 0),            # zamba2-7b's train shape
    (2, 8, 2, 200, 128, True, 0),              # ragged tail, GQA 4x
    (1, 4, 2, 256, 64, True, 100),             # sliding window
    (1, 2, 2, 130, 112, False, 0),             # non-causal, D 112
    (1, 8, 2, 40, 32, True, 0),                # shorter than a tile
    (4, 32, 32, 512, 128, True, 0),            # codeqwen1.5-7b's MHA
    (4, 4, 4, 64, 32, True, 0),                # codeqwen1.5-7b reduced
]


def _bshd_cuda(gen, b, s, h, d, dt):
    return torch.randn(b, s, h, d, generator=gen,
                       device="cuda").to(dt).transpose(1, 2)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", ATTENTION_BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bwd_matches_plain(cuda_device, b, hq, hkv, s, d, causal,
                                     window, dtype):
    gen = torch.Generator(device="cuda").manual_seed(7)
    dt = getattr(torch, dtype)
    q, k, v, do = (_bshd_cuda(gen, b, s, h, d, dt)
                   for h in (hq, hkv, hkv, hq))
    o, lse = flash_attention(q, k, v, causal=causal, window=window,
                             return_lse=True)
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                              window=window)
    _bwd_close(got, ref.flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                                window=window), dtype)
    for g, t in zip(got, (q, k, v)):       # written in the inputs' layout
        assert g.shape == t.shape and g.stride() == t.stride()
    again = flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                window=window)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", ATTENTION_BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_lse_matches_plain_and_leaves_o_alone(
        cuda_device, b, hq, hkv, s, d, causal, window, dtype):
    """The forward's optional logsumexp against ``flash_attention_lse_ref``
    (f32 sums in another order: 1e-5 absolute and relative on values of
    order ln(Skv)); o is bitwise the same with and without it."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    dt = getattr(torch, dtype)
    q, k, v = (_bshd_cuda(gen, b, s, h, d, dt) for h in (hq, hkv, hkv))
    o, lse = flash_attention(q, k, v, causal=causal, window=window,
                             return_lse=True)
    assert lse.shape == (b, hq, s) and lse.dtype == torch.float32
    torch.testing.assert_close(
        lse.cpu(), ref.flash_attention_lse_ref(q, k, causal=causal,
                                               window=window).cpu(),
        rtol=1e-5, atol=1e-5)
    assert torch.equal(o, flash_attention(q, k, v, causal=causal,
                                          window=window))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bwd_sq_ne_skv_matches_plain(cuda_device, dtype):
    """The VLM's cross-attention in training: q [4, 32, 512, 128] over k/v
    [4, 8, 1600, 128] (the image memory), non-causal; a rerun bitwise."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    dt = getattr(torch, dtype)
    q, do = (_bshd_cuda(gen, 4, 512, 32, 128, dt) for _ in range(2))
    k, v = (_bshd_cuda(gen, 4, 1600, 8, 128, dt) for _ in range(2))
    o, lse = flash_attention(q, k, v, causal=False, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=False)
    _bwd_close(got, ref.flash_attention_bwd_ref(q, k, v, do, causal=False),
               dtype)
    for g, t in zip(got, (q, k, v)):
        assert g.shape == t.shape and g.stride() == t.stride()
    again = flash_attention_bwd(q, k, v, o, do, lse, causal=False)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


def test_attention_bwd_bf16_needs_the_forward_lse(cuda_device):
    q = torch.zeros(1, 2, 64, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, q, q, q, q)


def test_ops_route_grads_through_the_backward_kernels(cuda_device):
    """Under grad mode with an input that requires grad, ``ops`` goes
    through the autograd Functions, whose backward launches the kernels;
    under ``no_grad`` it launches the forward alone and builds no node."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    bf = torch.bfloat16
    x = torch.randn(2, 64, 256, generator=gen, device="cuda").to(bf)
    r = torch.randn_like(x)
    w = torch.ones(256, device="cuda", dtype=bf)
    q = torch.randn(2, 64, 4, 64, generator=gen, device="cuda").to(bf)
    counters = (rmsnorm_bwd, add_rmsnorm_bwd, flash_attention_bwd)
    for fn in counters:
        fn.launches = 0
    with torch.no_grad():
        xs = [t.clone().requires_grad_(True) for t in (x, r, q)]
        y = ops.rmsnorm(xs[0], w)
        s_, y2 = ops.add_rmsnorm(xs[0], xs[1], w)
        qt = xs[2].transpose(1, 2)
        o = ops.attention(qt, qt, qt)
    assert all(t.grad_fn is None for t in (y, s_, y2, o))
    leaves = [t.clone().requires_grad_(True) for t in (x, r, q)]
    y = ops.rmsnorm(leaves[0], w)
    s_, y2 = ops.add_rmsnorm(leaves[0], leaves[1], w)
    qt = leaves[2].transpose(1, 2)
    o = ops.attention(qt, qt, qt)
    assert [type(t.grad_fn).__name__ for t in (y, y2, o)] == [
        "RMSNormBackward", "AddRMSNormBackward", "FlashAttentionBackward"]
    assert [fn.launches for fn in counters] == [0, 0, 0]
    (y.float().sum() + y2.float().square().sum() + s_.float().sum()
     + o.float().sum()).backward()
    assert [fn.launches for fn in counters] == [1, 1, 1]


def test_reduced_train_step_on_card_matches_cpu(cuda_device):
    """The reduced qwen3-8b in f32: loss and every gradient through the
    kernels (forward and backward) on the card against the plain path on
    the CPU, from the same weights; a rerun on the card is bitwise."""
    cfg = dataclasses.replace(get_arch("qwen3-8b").reduced(),
                              dtype="float32")
    params = train.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}

    def grads(device):
        leaves = {k: v.to(device).requires_grad_(True)
                  for k, v in params.items()}
        loss = transformer.loss_fn(cfg, leaves, {
            k: v.to(device) for k, v in batch.items()}, seq_chunk=64)
        return loss, torch.autograd.grad(loss, list(leaves.values()))
    torch.backends.cuda.matmul.allow_tf32 = False
    loss_c, g_c = grads("cpu")
    loss_g, g_g = grads("cuda")
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-5, atol=1e-6)
    for a, b in zip(g_g, g_c):
        scale = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale + 1e-7
    loss_2, g_2 = grads("cuda")
    assert torch.equal(loss_2, loss_g)
    assert all(torch.equal(a, b) for a, b in zip(g_2, g_g))


def test_reduced_vlm_train_step_on_card_matches_cpu(cuda_device):
    """The reduced llama-3.2-vision-11b in f32 on random image embeddings
    with the gates at 0.5 (so the cross path carries gradient): loss and
    every gradient through the kernels (K2 non-causal over the memory,
    forward and backward) on the card against the plain path on the CPU,
    from the same weights; a rerun on the card is bitwise."""
    cfg = dataclasses.replace(get_arch("llama-3.2-vision-11b").reduced(),
                              dtype="float32")
    params = train.init_params(cfg, 0, "cpu")
    for k in params:
        if k.endswith(".gate"):
            params[k] = torch.full_like(params[k], 0.5)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
        (2, cfg.n_image_tokens, cfg.d_model), dtype=np.float32))

    def grads(device):
        leaves = {k: v.to(device).requires_grad_(True)
                  for k, v in params.items()}
        loss = transformer.loss_fn(cfg, leaves, {
            k: v.to(device) for k, v in batch.items()}, seq_chunk=64)
        return loss, torch.autograd.grad(loss, list(leaves.values()))
    torch.backends.cuda.matmul.allow_tf32 = False
    flash_attention_bwd.launches = 0
    loss_c, g_c = grads("cpu")
    loss_g, g_g = grads("cuda")
    groups = cfg.n_layers // cfg.cross_attn_every
    assert flash_attention_bwd.launches == cfg.n_layers + groups
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-5, atol=1e-6)
    for name, a, b in zip(params, g_g, g_c):
        scale = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale + 1e-7, name
        if ".gate" in name or name.startswith("cross."):
            assert scale > 0, name
    loss_2, g_2 = grads("cuda")
    assert torch.equal(loss_2, loss_g)
    assert all(torch.equal(a, b) for a, b in zip(g_2, g_g))


def _scan_bwd_close(got, want):
    """K3's backward tolerance, output by output (see the module doc)."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        w = w.float()
        atol, rtol = 3e-4 * float(w.abs().max()), 3e-4
        if g.dtype == torch.bfloat16:
            atol, rtol = atol + ATOL["bfloat16"], rtol + RTOL["bfloat16"]
        assert bool(((g.float() - w).abs() <= atol + rtol * w.abs()).all())


@pytest.mark.parametrize("b,s,h,p,n,chunk,dh", [
    (4, 512, 112, 64, 64, 128, False),   # zamba2-7b's train shape
    (2, 256, 3, 64, 64, 64, True),
    (2, 64, 4, 64, 16, 16, True),        # the reduced zamba2-7b
    (1, 120, 5, 32, 8, 40, True),        # a ragged chunk, odd heads
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_bwd_matches_plain(cuda_device, b, s, h, p, n, chunk, dh,
                                      dtype):
    x, bm, cm, dt, da = _mamba_inputs(cuda_device, b, s, h, p, n,
                                      getattr(torch, dtype), seed=3)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    dy = torch.randn((b, s, h, p), generator=gen, device=cuda_device)
    dhv = (torch.randn((b, h, p, n), generator=gen, device=cuda_device)
           if dh else None)
    before = mamba_chunk_scan_bwd.launches
    got = mamba_chunk_scan_bwd(x, bm, cm, dt, da, dy, dhv, chunk=chunk)
    assert mamba_chunk_scan_bwd.launches == before + 1
    _scan_bwd_close(got, ref.mamba_chunk_scan_bwd_ref(x, bm, cm, dt, da, dy,
                                                      dhv))
    again = mamba_chunk_scan_bwd(x, bm, cm, dt, da, dy, dhv, chunk=chunk)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.parametrize("dtype,tensor_cores", [("bfloat16", True),
                                                ("float32", False)])
def test_mamba_scan_bwd_routes_by_dtype(cuda_device, dtype, tensor_cores):
    """bf16 runs the tensor-core backward (``scan_bwd_tc_states``,
    ``scan_bwd_tc_chunks``), f32 the FMA kernels (``scan_bwd_states``,
    ``scan_bwd_chunks``); both end with ``scan_bwd_reduce``."""
    x, bm, cm, dt, da = _mamba_inputs(cuda_device, 1, 128, 2, 64, 64,
                                      getattr(torch, dtype))
    dy = torch.randn((1, 128, 2, 64), device=cuda_device)

    def calls():   # a trace can miss a launch made through ctypes
        for _ in range(4):
            mamba_chunk_scan_bwd(x, bm, cm, dt, da, dy, chunk=64)
    calls()
    names = {nm.replace("(anonymous namespace)::", "").split("(")[0]
             .split("::")[-1] for nm in _cuda_kernels(calls)
             if "scan_bwd" in nm}
    want = ({"scan_bwd_tc_states", "scan_bwd_tc_chunks"} if tensor_cores
            else {"scan_bwd_states", "scan_bwd_chunks"})
    assert names == want | {"scan_bwd_reduce"}, names


def test_ops_route_scan_grads_through_the_backward_kernel(cuda_device):
    """A CUDA scan that needs a gradient goes through
    ``autograd.MambaChunkScan``: y has a grad_fn, the backward launches the
    kernel once, and the gradients are the plain version's within the
    tolerance; under ``no_grad`` the forward launches alone."""
    args = _mamba_inputs(cuda_device, 2, 128, 3, 64, 16, torch.bfloat16,
                         seed=5)
    with torch.no_grad():
        y, _ = ops.mamba_chunk_scan(*[t.clone().requires_grad_(True)
                                      for t in args], chunk=64,
                                    out_dtype=torch.float32)
    assert y.grad_fn is None
    leaves = [t.clone().requires_grad_(True) for t in args]
    y, h = ops.mamba_chunk_scan(*leaves, chunk=64, out_dtype=torch.float32)
    assert type(y.grad_fn).__name__ == "MambaChunkScanBackward"
    dy = torch.randn_like(y)
    before = mamba_chunk_scan_bwd.launches
    got = torch.autograd.grad(y, leaves, dy)          # h unused: dh None
    assert mamba_chunk_scan_bwd.launches == before + 1
    _scan_bwd_close(got, ref.mamba_chunk_scan_bwd_ref(*args, dy))


def test_reduced_hybrid_train_step_on_card_matches_cpu(cuda_device):
    """The reduced zamba2-7b in f32: loss and every gradient through the
    kernels (K1, K2, K3 forward and backward) on the card against the
    plain path on the CPU, from the same weights; a rerun on the card is
    bitwise."""
    cfg = dataclasses.replace(get_arch("zamba2-7b").reduced(),
                              dtype="float32")
    params = train.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}

    def grads(device):
        leaves = {k: v.to(device).requires_grad_(True)
                  for k, v in params.items()}
        loss = zamba.loss_fn(cfg, leaves, {
            k: v.to(device) for k, v in batch.items()}, seq_chunk=64)
        return loss, torch.autograd.grad(loss, list(leaves.values()))
    torch.backends.cuda.matmul.allow_tf32 = False
    loss_c, g_c = grads("cpu")
    before = mamba_chunk_scan_bwd.launches
    loss_g, g_g = grads("cuda")
    assert mamba_chunk_scan_bwd.launches == before + cfg.n_layers
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-5, atol=1e-6)
    for a, b in zip(g_g, g_c):
        scale = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale + 1e-7
    loss_2, g_2 = grads("cuda")
    assert torch.equal(loss_2, loss_g)
    assert all(torch.equal(a, b) for a, b in zip(g_2, g_g))


# ------------------------------------------------ simulated runtime, apps

SIMRT_TOL = 1e-10
SIMRT_APPS = {"hpcg": dict(nx=32, ny=32, nz=16),
              "cloverleaf": dict(nx=128, ny_local=32),
              "pic": dict(cells_per_rank=256, particles_per_rank=16384)}


@pytest.fixture
def deterministic(cuda_device):
    torch.use_deterministic_algorithms(True)
    yield cuda_device
    torch.use_deterministic_algorithms(False)


def _simrt_app(name, device, n=4):
    from repro_torch.apps.cloverleaf import CloverLeaf
    from repro_torch.apps.hpcg import HPCG
    from repro_torch.apps.pic import PIC
    cls = {"hpcg": HPCG, "cloverleaf": CloverLeaf, "pic": PIC}[name]
    return cls(n_ranks=n, device=device, **SIMRT_APPS[name])


def _simrt_run(name, device, mode="replication", steps=4, ckpt_dir=None,
               kills=((1.5, (0,)),)):
    from repro_torch.core.failure_sim import FailureEvent
    from repro_torch.simrt import CostModel, SimRuntime
    rt = SimRuntime(_simrt_app(name, device),
                    FTConfig(mode=mode, replication_degree=1.0, mtbf_s=1e9,
                             ckpt_interval_s=2.0),
                    costs=CostModel(step_time_s=1.0), ckpt_dir=ckpt_dir,
                    failure_events=[FailureEvent(t, w) for t, w in kills],
                    workers_per_node=2)
    return rt, rt.run(steps)


def _states_close(card, cpu):
    for r, st in cpu.items():
        for key, want in st.items():
            got = card[r][key]
            if not isinstance(want, torch.Tensor):
                assert got == pytest.approx(want, rel=SIMRT_TOL), key
                continue
            assert got.device.type == "cuda" and got.shape == want.shape
            scale = float(want.abs().max()) if want.numel() else 0.0
            err = float((got.cpu() - want).abs().max()) if want.numel() \
                else 0.0
            assert err <= SIMRT_TOL * scale, (r, key, err, scale)


@pytest.mark.parametrize("name", sorted(SIMRT_APPS))
def test_app_on_card_reruns_bitwise_and_matches_cpu(deterministic, name):
    """Four steps with a promotion: a rerun on the card is bitwise, the
    card agrees with the CPU within SIMRT_TOL, and the runtime left every
    state on the card."""
    _, a = _simrt_run(name, "cuda")
    _, b = _simrt_run(name, "cuda")
    _, c = _simrt_run(name, "cpu")
    assert a.promotions == 1 and a.time.as_dict() == c.time.as_dict()
    for r in range(4):
        for key, v in a.states[r].items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, b.states[r][key]), (r, key)
            else:
                assert v == b.states[r][key]
    _states_close(a.states, c.states)


def test_pic_deposit_and_migration_on_card_match_cpu(deterministic):
    from repro_torch.apps.pic import inclusive_scan, migrate_blocks
    rng = np.random.default_rng(3)
    nc, n = 4096, 8
    x = torch.from_numpy(rng.random(1 << 20) * nc)

    def deposit(dev):
        xd = x.to(dev)
        cell = torch.floor(xd).to(torch.int64)
        frac = xd - cell
        rho = torch.zeros(nc + 2, dtype=torch.float64, device=dev)
        rho.index_put_((cell + 1,), 1.0 - frac, accumulate=True)
        rho.index_put_((cell + 2,), frac, accumulate=True)
        return rho, inclusive_scan(rho)

    (g, gs), (g2, gs2), (c, cs) = deposit("cuda"), deposit("cuda"), \
        deposit("cpu")
    assert torch.equal(g, g2) and torch.equal(gs, gs2)
    for got, want in ((g, c), (gs, cs)):
        assert float((got.cpu() - want).abs().max()) <= \
            SIMRT_TOL * float(want.abs().max())
    vel = torch.from_numpy(rng.standard_normal(x.numel()))
    owner = torch.floor(x / (nc / n)).to(torch.int64) % n
    card = migrate_blocks(x.cuda(), vel.cuda(), owner.cuda(), n)
    cpu = migrate_blocks(x, vel, owner, n)
    assert [b.shape for b in card] == [b.shape for b in cpu]
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))


@pytest.mark.parametrize("writer,reader", [("cuda", "cpu"),
                                           ("cpu", "cuda")])
def test_simrt_disk_checkpoint_restores_across_devices(deterministic,
                                                        writer, reader):
    """A rank checkpoint written by a runtime on one device restores onto
    the other (host arrays and a manifest on disk, never a pickled
    tensor), bitwise the writer's snapshot."""
    with tempfile.TemporaryDirectory() as d:
        rt_w, _ = _simrt_run("hpcg", writer, mode="checkpoint", steps=3,
                             ckpt_dir=d, kills=())
        rt_r = _simrt_run("hpcg", reader, mode="checkpoint", steps=0,
                          ckpt_dir=os.path.join(d, "reader"), kills=())[0]
        rt_r.ckpt_dir = d
        rt_r._restore_checkpoint()
        want = rt_w._ckpt_mem
        assert rt_r.step_idx == want["step"] > 0
        for r in range(4):
            state = rt_r.workers[rt_r.rmap.cmp[r]].state
            for key, v in want["ranks"][r]["state"].items():
                if isinstance(v, torch.Tensor):
                    assert state[key].device.type == reader
                    assert torch.equal(state[key].cpu(), v.cpu())
                else:
                    assert state[key] == v
