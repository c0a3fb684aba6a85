"""llama-3.2-vision-11b [vlm] — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

Vision frontend is a STUB per the assignment: ``input_specs()`` feeds
precomputed patch embeddings (batch, n_image_tokens, d_model). A gated
cross-attention layer is inserted every 5th decoder layer (8 total).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    rope_theta=5e5,
    cross_attn_every=5,
    n_image_tokens=1600,
)
