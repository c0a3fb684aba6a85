"""The port on the card: each CUDA kernel against its plain PyTorch
version, and the kernel path of the reduced model against its CPU path.

Every test here carries the ``cuda`` marker and skips without a card. The
file imports neither jax nor the JAX package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 2e-5 (summation order only); bf16 rtol 2e-2 / atol 3e-2
(one bf16 rounding of an f32 result) — ``tests/test_kernels.py``'s.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.launch.serve import ReplicatedServer
from repro_torch.models.transformer import Transformer

RTOL = {"float32": 2e-5, "bfloat16": 2e-2}
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               rtol=RTOL[dtype], atol=ATOL[dtype])


@pytest.mark.parametrize("shape", [(2048, 4096), (4, 512, 32, 128),
                                   (1003, 128), (3, 5, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain(cuda_device, shape, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda_device).to(
        getattr(torch, dtype))
    w = torch.randn(shape[-1:], generator=gen, device=cuda_device).to(x.dtype)
    before = rmsnorm.launches
    got = ops.rmsnorm(x, w)
    assert rmsnorm.launches == before + 1
    _close(got, ref.rmsnorm_ref(x, w), dtype)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (4, 32, 8, 512, 128, True, 0),
    (2, 2, 1, 192, 128, True, 0),
    (1, 4, 2, 256, 64, True, 128),
    (1, 2, 2, 128, 64, False, 0),
    (1, 8, 2, 128, 32, True, 0),
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
