"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, 1:2 (Griffin pattern:
two recurrent blocks then one local-attention block). arXiv:2402.19427.
26L d_model=2560, 10H (MQA kv=1), d_ff=7680, vocab=256000, window=2048."""
from repro_torch.configs.base import ModelConfig, RGLRUConfig, RGLRU, ATTN_LOCAL

# (R, R, A) repeated; 26 = 8*3 + 2 -> trailing (R, R)
_PATTERN = tuple((RGLRU, RGLRU, ATTN_LOCAL) * 8) + (RGLRU, RGLRU)
assert len(_PATTERN) == 26

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=_PATTERN,
    act="geglu",
    norm="rmsnorm",
    local_window=2048,
    rope_theta=10000.0,
    tie_embeddings=True,
    rglru=RGLRUConfig(lru_width=2560, d_conv=4),
    source="arXiv:2402.19427",
)
