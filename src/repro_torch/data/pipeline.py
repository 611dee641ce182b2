"""Synthetic token batches, held against ``repro/data/pipeline.py``
(``SyntheticDataset``, lines 44-73, and ``make_batch``, lines 314-318).

Deterministic per (seed, step, shard), numpy only, so every host makes its
own shard without coordination; equal arguments give arrays identical to
the reference's.  The rest of the reference's file (I/O workload models,
storage pricing, the prefetcher) is ROADMAP queue A item 6.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class SyntheticDataset:
    """Deterministic LM batches: tokens ~ Zipf-ish over the vocab."""
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0

    def batch_at(self, step: int, *, shard: int = 0, n_shards: int = 1
                 ) -> Dict[str, np.ndarray]:
        """The (shard)th slice of the global batch for ``step``."""
        B = self.shape.global_batch // n_shards
        S = self.shape.seq_len
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        V = self.cfg.vocab_size
        # zipf-flavoured ids (clipped); cheap and stationary
        raw = rng.zipf(1.3, size=(B, S + 1))
        toks = np.minimum(raw - 1, V - 1).astype(np.int32)
        if self.cfg.input_mode == "embeddings":
            x = rng.standard_normal(
                (B, S, self.cfg.d_model)).astype(np.float32)
            return {"inputs": x, "labels": toks[:, 1:S + 1]}
        return {"inputs": toks[:, :S], "labels": toks[:, 1:S + 1]}

    def batch_bytes(self) -> int:
        B, S = self.shape.global_batch, self.shape.seq_len
        if self.cfg.input_mode == "embeddings":
            return B * S * self.cfg.d_model * 4 + B * S * 4
        return B * (S + 1) * 4


def make_batch(cfg: ModelConfig, shape: ShapeConfig, *, step: int = 0,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """One full global batch as numpy arrays (the train step moves them to
    its device)."""
    return SyntheticDataset(cfg, shape, seed).batch_at(step)
