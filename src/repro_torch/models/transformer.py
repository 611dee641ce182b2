"""Composable decoder stacks, held against ``repro/models/transformer.py``.

The reference compiles a ``block_pattern`` into *segments* that it scans
over; PyTorch runs eagerly, so the stack here is a plain ``nn.ModuleList``
with one ``Block`` per layer and caches are a list with one entry per layer.
``plan_segments`` is kept because the reference's parameter pytree is
stacked by segment and ``convert.from_reference`` has to unstack it.

With ``RunCtx.remat == "block"`` each block runs under
``torch.utils.checkpoint`` (non-reentrant) wherever autograd records: its
activations are dropped after the forward and recomputed in the backward,
as ``jax.checkpoint`` does per scanned unit in the reference
(``transformer.py:241-242``; only ``"block"`` triggers it there too).

Ported block types: ``attn`` (global attention), ``attn_local`` (sliding
window, ring-buffer caches), ``ssm`` (the Mamba-2 mixer; ``d_ff == 0`` gives
mamba2 its FFN-free block) and ``rglru`` (the Griffin recurrent block), with
and without ``parallel_residual``.  ``RunCtx.attn_impl`` picks the kernels
(``"kernel"``) or their plain versions (``"full"``) for every mixer's
prefill.  MoE FFNs raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, RGLRU, SSM,
                                      ModelConfig)
from repro_torch.models import attention, layers, rglru, ssm

_BLOCKS = (ATTN, ATTN_LOCAL, SSM, RGLRU)
_MOE = "ROADMAP queue A item 5 (MoE / BERT / vision)"


# ---------------------------------------------------------------------------
# run context (how to execute; orthogonal to the params)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RunCtx:
    compute_dtype: Any = torch.bfloat16
    attn_impl: str = "kernel"         # kernel | full
    cache_capacity: int = 0
    remat: str = "block"              # none | block


# ---------------------------------------------------------------------------
# segment planning
# ---------------------------------------------------------------------------
def plan_segments(pattern: Sequence[str]) -> List[Tuple[Tuple[str, ...], int]]:
    """[(unit, repeats), ...] -- unit*repeats (+ prefix remainder) ==
    pattern."""
    pattern = tuple(pattern)
    L = len(pattern)
    for u in range(1, L + 1):
        unit = pattern[:u]
        k = L // u
        if unit * k == pattern[:u * k] and pattern[u * k:] == unit[:L - u * k]:
            segs = [(unit, k)]
            rem = pattern[u * k:]
            if rem:
                segs.append((rem, 1))
            return segs
    raise AssertionError("unreachable")


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------
def _has_ffn(cfg: ModelConfig) -> bool:
    return cfg.d_ff > 0 or cfg.moe is not None


def _check_ported(cfg: ModelConfig, blk: str) -> None:
    if blk not in _BLOCKS:
        raise ValueError(blk)
    if cfg.moe is not None:
        raise NotImplementedError(
            f"MoE FFNs ({cfg.name}) are not ported yet: {_MOE}")


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, blk: str, *, generator=None,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        _check_ported(cfg, blk)
        self.cfg, self.blk = cfg, blk
        kw = dict(dtype=dtype, device=device)
        self.norm1 = layers.Norm(cfg.norm, cfg.d_model, eps=cfg.norm_eps,
                                 **kw)
        if blk == SSM:
            self.ssm = ssm.SSM(cfg, generator=generator, **kw)
        elif blk == RGLRU:
            self.rglru = rglru.RGLRU(cfg, generator=generator, **kw)
        else:
            self.attn = attention.Attention(cfg, generator=generator, **kw)
        if _has_ffn(cfg):
            if not cfg.parallel_residual:
                self.norm2 = layers.Norm(cfg.norm, cfg.d_model,
                                         eps=cfg.norm_eps, **kw)
            self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, cfg.act,
                                  generator=generator, **kw)

    def forward(self, x, ctx: RunCtx, *, positions, cache=None,
                kv_mask=None, rope=None):
        """Returns (x, new_cache)."""
        cfg, cd = self.cfg, ctx.compute_dtype
        h = self.norm1(x)
        if self.blk in (SSM, RGLRU):
            apply = ssm.apply_ssm if self.blk == SSM else rglru.apply_rglru
            mix, new_cache = apply(
                getattr(self, self.blk), h, cfg, compute_dtype=cd,
                cache=cache if isinstance(cache, dict) else None,
                build_cache=cache == "init", token_mask=kv_mask,
                impl="plain" if ctx.attn_impl == "full" else "kernel")
        else:
            mix, new_cache = attention.apply_attention(
                self.attn, h, cfg, local=self.blk == ATTN_LOCAL,
                positions=positions, compute_dtype=cd, impl=ctx.attn_impl,
                cache=cache, kv_mask=kv_mask,
                cache_capacity=ctx.cache_capacity, rope=rope)
        if not _has_ffn(cfg):
            return x + mix.to(x.dtype), new_cache
        if cfg.parallel_residual:
            f = self.mlp(h, cd)
            return x + (mix + f).to(x.dtype), new_cache
        x = x + mix.to(x.dtype)
        f = self.mlp(self.norm2(x), cd)
        return x + f.to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# cache scaffolding
# ---------------------------------------------------------------------------
def init_block_cache(cfg: ModelConfig, blk: str, batch: int, max_seq: int,
                     dtype=torch.bfloat16, device="cpu"):
    """As the reference: attention caches in ``dtype``, the recurrent
    blocks' caches in their own default (fp32 conv tails and states)."""
    _check_ported(cfg, blk)
    if blk == SSM:
        return ssm.init_ssm_cache(cfg, batch, device=device)
    if blk == RGLRU:
        return rglru.init_rglru_cache(cfg, batch, device=device)
    return attention.init_decode_cache(cfg, batch, max_seq,
                                       local=blk == ATTN_LOCAL, dtype=dtype,
                                       device=device)


def init_stack_cache(cfg: ModelConfig, batch: int, max_seq: int,
                     dtype=torch.bfloat16, device="cpu"):
    """One cache dict per layer (the reference stacks them per segment)."""
    return [init_block_cache(cfg, blk, batch, max_seq, dtype, device)
            for blk in cfg.pattern]


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------
class Stack(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator=None,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            Block(cfg, blk, generator=generator, dtype=dtype, device=device)
            for blk in cfg.pattern)

    def forward(self, x, ctx: RunCtx, *, positions, caches=None,
                kv_mask=None):
        """Returns (x, new_caches|None).

        ``caches``: None (no cache), "init" (prefill -> build caches), or a
        list with one cache per layer (decode / chunk).
        """
        new_caches: Optional[list] = None if caches is None else []
        cfg, rope = self.cfg, None
        if cfg.pos_embedding == "rope":
            # the same for every layer: made once per forward pass
            rope = layers.rope_tables(
                positions, cfg.head_dim, ctx.compute_dtype,
                fraction=cfg.rope_fraction, theta=cfg.rope_theta)
        remat = ctx.remat == "block" and caches is None and \
            torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            if remat:
                x = checkpoint(self._run_block, block, x, ctx, positions,
                               kv_mask, rope, use_reentrant=False)
                continue
            c_in = caches if caches is None or isinstance(caches, str) \
                else caches[i]
            x, nc = block(x, ctx, positions=positions, cache=c_in,
                          kv_mask=kv_mask, rope=rope)
            if new_caches is not None:
                new_caches.append(nc)
        return x, new_caches

    @staticmethod
    def _run_block(block, x, ctx, positions, kv_mask, rope):
        return block(x, ctx, positions=positions, kv_mask=kv_mask,
                     rope=rope)[0]
