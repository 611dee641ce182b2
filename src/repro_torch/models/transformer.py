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
prefill.  Where the config has ``moe``, a block's FFN is ``models.moe.MoE``
on its sorted dispatch at the default capacity, and the stack returns the
sum of the blocks' load-balance terms (the reference's ``apply_stack``
aux).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, RGLRU, SSM,
                                      ModelConfig)
from repro_torch.core import hierarchy
from repro_torch.models import attention, layers, moe, rglru, ssm

_BLOCKS = (ATTN, ATTN_LOCAL, SSM, RGLRU)


# ---------------------------------------------------------------------------
# run context (how to execute; orthogonal to the params)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """Mesh-aware execution context, held against the reference's (None
    mesh = one device).  The port's model sees plain local tensors: a batch
    a rank holds is its piece over the dp axes, and a parameter that the
    tensor-parallel computation splits its work along is its piece over
    ``tp_axis`` (heads, the FFN width, the vocabulary, the SSM's inner
    channels, the experts).  Where the mesh has ``tp_axis`` (size 1 too:
    a one-rank mesh runs the collectives a wider one does), blocks run
    their tensor- and expert-parallel paths and count every collective into
    ``traffic`` (``core/hierarchy``)."""
    mesh: Any = None
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: Optional[str] = "model"
    fsdp_experts: bool = True
    traffic: Any = dataclasses.field(default=None, compare=False)
    # groups, and the mesh's facts read once (a block asks for them many
    # times a step)
    _groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)
    _memo: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    # ------------------------------------------------------------ axes --
    def _facts(self):
        facts = self._memo.get("facts")
        if facts is None:
            axes = {} if self.mesh is None else dict(zip(
                self.mesh.mesh_dim_names,
                (int(n) for n in self.mesh.mesh.shape)))
            on = self.mesh is not None and self.tp_axis in axes
            facts = self._memo["facts"] = (axes, on,
                                           axes[self.tp_axis] if on else 1)
        return facts

    @property
    def tp_on(self) -> bool:
        """The tensor- and expert-parallel paths run (a mesh with the tp
        axis, of any size)."""
        return self._facts()[1]

    @property
    def tp(self) -> int:
        return self._facts()[2]

    @property
    def tp_rank(self) -> int:
        rank = self._memo.get("tp_rank")
        if rank is None:
            rank = self._memo["tp_rank"] = (
                self.mesh.get_local_rank(self.tp_axis) if self.tp_on else 0)
        return rank

    @property
    def dp_names(self) -> Tuple[str, ...]:
        return tuple(a for a in self.mesh.mesh_dim_names
                     if a in self.dp_axes) if self.mesh is not None else ()

    def group(self, axes):
        """The ``hierarchy.Group`` of ``axes`` (made once, counted into
        ``traffic``)."""
        key = tuple(a for a in self.mesh.mesh_dim_names if a in set(axes))
        if key not in self._groups:
            if self.traffic is None:
                object.__setattr__(self, "traffic", hierarchy.Traffic())
            self._groups[key] = hierarchy.axis_group(self.mesh, key,
                                                     self.traffic)
        return self._groups[key]

    @property
    def tp_group(self):
        group = self._memo.get("tp_group")
        if group is None:
            group = self._memo["tp_group"] = self.group((self.tp_axis,))
        return group

    # ---------------------------------------------- the region's edges --
    def copy(self, x):
        return hierarchy.tp_copy(x, self.tp_group)

    def reduce(self, x):
        return hierarchy.tp_reduce(x, self.tp_group)

    def psum(self, x):
        return hierarchy.tp_psum(x, self.tp_group)

    def gather(self, x, dim: int):
        return hierarchy.tp_gather(x, self.tp_group, dim)

    def split(self, x, dim: int):
        return hierarchy.tp_split(x, self.tp_group, dim)

    def all_gather(self, x, dim: int):
        """The pieces joined (no gradient: serving)."""
        return hierarchy.all_gather(x, self.tp_group, dim)

    # ----------------------------------------------------------- pieces --
    def cut(self, t, dim: int, full: int):
        """This rank's block along ``dim`` of a tensor whose whole size
        there is ``full``: ``t`` itself where it is that block already (a
        piece), else ``t`` zero-padded to a multiple of the tp axis and cut
        (a leaf held whole, or gathered)."""
        tp = self.tp
        padded = -(-full // tp) * tp
        n = padded // tp
        size = t.shape[dim]
        if size == full:
            if tp == 1:
                return t
            if padded != full:
                pad = [0, 0] * (t.dim() - 1 - dim) + [0, padded - full]
                t = torch.nn.functional.pad(t, pad)
            return t.narrow(dim, self.tp_rank * n, n)
        if size == n and full % tp == 0:
            return t
        raise ValueError(f"dim {dim} of {tuple(t.shape)}: neither the whole "
                         f"{full} nor a piece of it over {self.tp} ranks")


@dataclasses.dataclass(frozen=True)
class RunCtx:
    compute_dtype: Any = torch.bfloat16
    attn_impl: str = "kernel"         # kernel | full
    cache_capacity: int = 0
    remat: str = "block"              # none | block
    moe_impl: str = "sorted"          # dense | sorted | ep
    pctx: ParallelCtx = ParallelCtx()
    # the dp axes of ``pctx.mesh`` that split this step's rows (a mesh
    # train step's batch, a mesh decode step's slots): the sorted MoE then
    # takes the global batch's capacity and order over them
    moe_dp: Tuple[str, ...] = ()


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


def _check_block(blk: str) -> None:
    if blk not in _BLOCKS:
        raise ValueError(blk)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, blk: str, *, generator=None,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        _check_block(blk)
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
            if cfg.moe is not None:
                self.moe = moe.MoE(cfg, generator=generator, **kw)
            else:
                self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, cfg.act,
                                      generator=generator, **kw)

    def _ffn(self, h, ctx: RunCtx):
        """(FFN output, the MoE's aux or None).  Under a mesh's tp axis the
        MLP is column- then row-parallel (its width over the axis) and the
        MoE runs ``ctx.moe_impl`` (``"ep"``: experts over the axis); the
        sorted MoE over rows split by ``ctx.moe_dp`` takes the global
        batch's order."""
        pctx = ctx.pctx if ctx.pctx.tp_on else None
        if self.cfg.moe is None:
            return self.mlp(h, ctx.compute_dtype, pctx=pctx), None
        group = ctx.pctx.group(ctx.moe_dp) \
            if ctx.moe_dp and ctx.moe_impl == "sorted" else None
        return moe.apply_moe(self.moe, h, self.cfg,
                             compute_dtype=ctx.compute_dtype,
                             impl=ctx.moe_impl, pctx=pctx, dp_group=group)

    def forward(self, x, ctx: RunCtx, *, positions, cache=None,
                kv_mask=None, rope=None):
        """Returns (x, new_cache, aux): ``aux`` the MoE's load-balance term,
        None for a block without MoE."""
        cfg, cd = self.cfg, ctx.compute_dtype
        pctx = ctx.pctx if ctx.pctx.tp_on else None
        h = self.norm1(x)
        if self.blk == RGLRU:
            mix, new_cache = rglru.apply_rglru(
                self.rglru, h, cfg, compute_dtype=cd,
                cache=cache if isinstance(cache, dict) else None,
                build_cache=cache == "init", token_mask=kv_mask,
                impl="plain" if ctx.attn_impl == "full" else "kernel",
                pctx=pctx)
        elif self.blk == SSM:
            mix, new_cache = ssm.apply_ssm(
                self.ssm, h, cfg, compute_dtype=cd,
                cache=cache if isinstance(cache, dict) else None,
                build_cache=cache == "init", token_mask=kv_mask,
                impl="plain" if ctx.attn_impl == "full" else "kernel",
                pctx=pctx)
        else:
            mix, new_cache = attention.apply_attention(
                self.attn, h, cfg, local=self.blk == ATTN_LOCAL,
                positions=positions, compute_dtype=cd, impl=ctx.attn_impl,
                cache=cache, kv_mask=kv_mask,
                cache_capacity=ctx.cache_capacity, rope=rope, pctx=pctx)
        if not _has_ffn(cfg):
            return x + mix.to(x.dtype), new_cache, None
        if cfg.parallel_residual:
            f, aux = self._ffn(h, ctx)
            return x + (mix + f).to(x.dtype), new_cache, aux
        x = x + mix.to(x.dtype)
        f, aux = self._ffn(self.norm2(x), ctx)
        return x + f.to(x.dtype), new_cache, aux


# ---------------------------------------------------------------------------
# cache scaffolding
# ---------------------------------------------------------------------------
def init_block_cache(cfg: ModelConfig, blk: str, batch: int, max_seq: int,
                     dtype=torch.bfloat16, device="cpu"):
    """As the reference: attention caches in ``dtype``, the recurrent
    blocks' caches in their own default (fp32 conv tails and states)."""
    _check_block(blk)
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
        """Returns (x, new_caches|None, aux): ``aux`` the sum of the MoE
        blocks' load-balance terms (fp32), None without MoE.

        ``caches``: None (no cache), "init" (prefill -> build caches), or a
        list with one cache per layer (decode / chunk).
        """
        new_caches: Optional[list] = None if caches is None else []
        aux_total = None
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
                x, aux = checkpoint(self._run_block, block, x, ctx,
                                    positions, kv_mask, rope,
                                    use_reentrant=False)
            else:
                c_in = caches if caches is None or isinstance(caches, str) \
                    else caches[i]
                x, nc, aux = block(x, ctx, positions=positions, cache=c_in,
                                   kv_mask=kv_mask, rope=rope)
                if new_caches is not None:
                    new_caches.append(nc)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        return x, new_caches, aux_total

    @staticmethod
    def _run_block(block, x, ctx, positions, kv_mask, rope):
        x, _, aux = block(x, ctx, positions=positions, kv_mask=kv_mask,
                          rope=rope)
        return x, aux
