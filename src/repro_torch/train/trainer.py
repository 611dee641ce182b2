"""``make_run_ctx``, held against ``repro/train/trainer.py``
(``make_run_ctx``, lines 91-111).  The train step itself arrives with the
training slice; the serving engine needs only this function.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, PolicyConfig
from repro_torch.models.transformer import RunCtx

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _dt(name: str) -> torch.dtype:
    return _DTYPES[name]


def make_run_ctx(cfg: ModelConfig, policy: PolicyConfig, mesh=None, *,
                 seq_len: Optional[int] = None, decode: bool = False,
                 batch: Optional[int] = None) -> RunCtx:
    """``seq_len`` / ``decode`` / ``batch`` key the reference's tuned-tile
    lookup; the CUDA kernels take no tile arguments yet, so they are
    accepted and unused until the autotuner is ported."""
    del cfg, seq_len, decode, batch
    if mesh is not None:
        raise NotImplementedError(
            "meshes are not ported yet: ROADMAP queue A item 7 (the parallel "
            "layer)")
    if policy.attn_impl not in ("kernel", "full"):
        raise ValueError(f"attn_impl {policy.attn_impl!r} not in "
                         f"('kernel', 'full')")
    return RunCtx(compute_dtype=_dt(policy.compute_dtype),
                  attn_impl=policy.attn_impl)
