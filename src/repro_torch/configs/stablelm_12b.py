"""stablelm-12b [dense] — 40L d_model=5120, 32H (GQA kv=8), d_ff=13824,
vocab=100352; partial rotary (25%), LayerNorm, parallel residual per the
StableLM-2 family. hf:stabilityai/stablelm-2-12b."""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    block_pattern=(ATTN,) * 40,
    act="swiglu",
    norm="layernorm",
    rope_fraction=0.25,
    parallel_residual=True,
    qk_norm=True,           # stablelm-2-12b uses per-head qk layernorm
    rope_theta=10000.0,
    source="hf:stabilityai/stablelm-2-12b",
)
