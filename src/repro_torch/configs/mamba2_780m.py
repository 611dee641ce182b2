"""mamba2-780m [ssm] — SSD (state-space duality), arXiv:2405.21060.

48L d_model=1536, attention-free (d_ff=0: the SSD mixer is the whole block),
vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, SSM

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=48,            # d_inner(=2*1536=3072) / head_dim(64)
    n_kv_heads=48,
    d_ff=0,
    vocab_size=50280,
    block_pattern=(SSM,) * 48,
    norm="rmsnorm",
    pos_embedding="none",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    source="arXiv:2405.21060",
)
