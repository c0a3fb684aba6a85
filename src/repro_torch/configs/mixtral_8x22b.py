"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    sliding_window=4096,
    rope_theta=1e6,
    n_experts=8,
    n_experts_per_tok=2,
)
