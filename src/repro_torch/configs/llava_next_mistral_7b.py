"""llava-next-mistral-7b [vlm] — anyres tiling; the Mistral-7B backbone only.
32L d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=32000.

Per the assignment, the vision frontend (anyres patch tiling + projector) is a
STUB: ``input_specs()`` feeds precomputed patch/text embeddings directly into
the backbone (``input_mode="embeddings"``).
hf:llava-hf/llava-v1.6-mistral-7b-hf."""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=(ATTN,) * 32,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    input_mode="embeddings",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
