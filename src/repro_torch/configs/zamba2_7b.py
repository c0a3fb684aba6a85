"""zamba2-7b [hybrid] — Mamba2 + shared attn blocks, ssm_state=64 [arXiv:2411.15242; unverified].

81 Mamba2 blocks; ONE shared-weight attention block is applied every
``attn_every`` blocks (Zamba2's parameter-sharing trick). Sub-quadratic:
long_500k runs (SSM state + windowed shared attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    ssm_state=64,
    ssm_chunk=128,
    attn_every=6,
    sliding_window=4096,   # shared attention runs windowed at long context
    expand=2,
    conv_kernel=4,
)
