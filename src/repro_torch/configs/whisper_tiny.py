"""whisper-tiny [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified].

The modality frontend is a STUB per the assignment: ``input_specs()`` feeds
precomputed frame embeddings of shape (batch, n_frames, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    is_encoder_decoder=True,
    n_encoder_layers=4,
    n_frames=1500,
    rope_theta=1e4,
)
