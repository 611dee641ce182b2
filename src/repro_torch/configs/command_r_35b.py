"""command-r-35b [dense] — GQA, no-bias, parallel residual.
40L d_model=8192, 64H (GQA kv=8), d_ff=22528, vocab=256000.
hf:CohereForAI/c4ai-command-r-v01."""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    block_pattern=(ATTN,) * 40,
    act="swiglu",
    norm="layernorm",     # cohere uses LayerNorm (no bias)
    parallel_residual=True,
    rope_theta=8000000.0,
    tie_embeddings=True,
    qkv_bias=False,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
