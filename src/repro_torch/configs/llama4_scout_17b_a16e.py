"""llama4-scout-17b-a16e [moe] — MoE, early fusion.

48L d_model=5120, 40H (GQA kv=8), d_ff=8192, vocab=202048, MoE 16e top-1
(+ shared expert, Llama-4 style). hf:meta-llama/Llama-4-Scout-17B-16E.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, ATTN

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=(ATTN,) * 48,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=500000.0,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192,
                  n_shared_experts=1, d_ff_shared=8192),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
