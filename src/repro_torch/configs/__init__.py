"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The port's own copy of ``repro/configs/__init__.py`` (plain dataclasses,
no framework import); held against it by ``tests/test_torch_layers.py``.

``get_config(arch)`` resolves any assigned architecture; ``reduced(cfg)``
produces the small same-family config used by CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401 (re-export)
    ATTN, ATTN_LOCAL, RGLRU, SSM,
    DEFAULT_POLICY, LONG_500K, DECODE_32K, PREFILL_32K, TRAIN_4K, SHAPES,
    ModelConfig, MoEConfig, PolicyConfig, RGLRUConfig, SSMConfig, ShapeConfig,
    applicable_shapes,
)

from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _llama4
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.llama3_2_3b import CONFIG as _llama32
from repro_torch.configs.command_r_35b import CONFIG as _commandr
from repro_torch.configs.qwen2_0_5b import CONFIG as _qwen2
from repro_torch.configs.stablelm_12b import CONFIG as _stablelm
from repro_torch.configs.llava_next_mistral_7b import CONFIG as _llava
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rgemma
from repro_torch.configs.paper_bench import BERT_BASE, BERT_LARGE

REGISTRY: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _mamba2, _llama4, _moonshot, _llama32, _commandr, _qwen2, _stablelm,
        _llava, _musicgen, _rgemma, BERT_BASE, BERT_LARGE,
    )
}

ASSIGNED_ARCHS = (
    "mamba2-780m",
    "llama4-scout-17b-a16e",
    "moonshot-v1-16b-a3b",
    "llama3.2-3b",
    "command-r-35b",
    "qwen2-0.5b",
    "stablelm-12b",
    "llava-next-mistral-7b",
    "musicgen-large",
    "recurrentgemma-2b",
)


def get_config(arch: str) -> ModelConfig:
    try:
        return REGISTRY[arch]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch!r}; known: {sorted(REGISTRY)}") from None


def reduced(cfg: ModelConfig, n_layers: int = 2, width_div: int = 8,
            vocab: int = 512) -> ModelConfig:
    """Small same-family config for CPU smoke tests.

    Keeps the block pattern *shape* (first ``n_layers`` entries of the real
    pattern, so hybrids keep their mixed block types), shrinks widths and
    vocab, keeps head_dim >= 8.
    """
    d_model = max(64, cfg.d_model // width_div)
    n_heads = max(2, cfg.n_heads // 4)
    while d_model % n_heads:
        n_heads -= 1
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    d_head = max(8, d_model // n_heads)
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, n_experts=max(4, cfg.moe.n_experts // 8),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=max(32, cfg.moe.d_ff_expert // width_div),
            d_ff_shared=max(32, cfg.moe.d_ff_shared // width_div)
            if cfg.moe.n_shared_experts else 0)
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=32)
    rglru = None
    if cfg.rglru is not None:
        rglru = dataclasses.replace(cfg.rglru, lru_width=d_model)
    pattern = cfg.pattern[:n_layers]
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=d_head,
        d_ff=0 if cfg.d_ff == 0 else max(64, cfg.d_ff // width_div),
        vocab_size=vocab,
        block_pattern=pattern,
        local_window=64,
        max_seq=2048,
        moe=moe, ssm=ssm, rglru=rglru,
    )
