"""musicgen-large [audio] — decoder-only over EnCodec tokens, arXiv:2306.05284.
48L d_model=2048, 32H (kv=32 -> full MHA), d_ff=8192, vocab=2048 (codebook).

The EnCodec frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings (sum of the 4 codebook embeddings, as in the delay-pattern
interleaving). Sinusoidal positions per the paper.
"""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    block_pattern=(ATTN,) * 48,
    act="gelu",
    norm="layernorm",
    pos_embedding="sinusoidal",
    input_mode="embeddings",
    source="arXiv:2306.05284",
)
