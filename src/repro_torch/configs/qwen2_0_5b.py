"""qwen2-0.5b [dense] — GQA, QKV bias. 24L d_model=896, 14H (GQA kv=2),
d_ff=4864, vocab=151936. arXiv:2407.10671."""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    block_pattern=(ATTN,) * 24,
    act="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    source="arXiv:2407.10671",
)
