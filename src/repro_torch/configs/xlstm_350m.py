"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

d_ff=0 per the assignment: xLSTM blocks carry their own projection structure
(mLSTM expansion 2x; sLSTM gated feed-forward 4/3) instead of a separate FFN.
Every ``slstm_every``-th block is an sLSTM (recurrent scalar memory); the rest
are mLSTM (parallelizable matrix memory).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=256,
    slstm_every=6,
)
