"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64e top-6.

48L d_model=2048, 16H (GQA kv=16 -> full MHA), d_ff=1408 per expert,
vocab=163840, MoE 64e top-6 + 2 shared experts (DeepSeek-style fine-grained).
hf:moonshotai/Moonlight-16B-A3B.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, ATTN

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    block_pattern=(ATTN,) * 48,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=50000.0,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared_experts=2, d_ff_shared=1408),
    source="hf:moonshotai/Moonlight-16B-A3B",
)
