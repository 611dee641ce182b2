"""LM wrapper: embeddings -> stack -> final norm -> head, and the loss,
held against ``repro/models/lm.py``.

Input modes: ``tokens`` (int token ids) and ``embeddings`` (precomputed
(B, S, d_model) inputs fed straight to the stack).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, transformer
from repro_torch.models.transformer import RunCtx


def require_device(device) -> torch.device:
    """The device an entry point runs on: the GPU unless the caller names the
    CPU.  Raises (no silent CPU fallback) when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions on the "
            "CPU")
    return dev


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator=None,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        self.embed = nn.Parameter(layers.embed_init(
            generator, (cfg.padded_vocab, cfg.d_model), **kw))
        self.stack = transformer.Stack(cfg, generator=generator, **kw)
        self.final_norm = layers.Norm(cfg.norm, cfg.d_model,
                                      eps=cfg.norm_eps, **kw)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(layers.embed_init(
                generator, (cfg.padded_vocab, cfg.d_model), **kw))
        if cfg.pos_embedding == "learned":
            self.pos_embed = nn.Parameter(layers.embed_init(
                generator, (cfg.max_seq, cfg.d_model), **kw))

    @classmethod
    def init(cls, cfg: ModelConfig, *, seed: int = 0, dtype=torch.float32,
             device="cuda") -> "LM":
        """Random weights drawn on ``device`` from ``seed`` (the
        counterpart of ``init_lm(key, cfg)``); each tensor is drawn in fp32
        and cast to ``dtype``."""
        dev = require_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return cls(cfg, generator=gen, dtype=dtype, device=dev)

    def cast_weights_(self, dtype) -> "LM":
        """Cast, once and in place, every parameter that the forward pass
        casts to the compute dtype anyway (matmul weights, biases,
        embeddings); norm scales and biases stay as they are because norms
        compute in fp32.  Same values and arithmetic as casting on every
        call, without re-reading the fp32 copy each step.  Leaves that the
        reference keeps in fp32 whatever the dtype (a module's
        ``FP32_LEAVES``: the SSM's ``A_log``, ``D``, ``dt_bias``, the
        RG-LRU's gates and ``lam``) stay fp32 too."""
        keep = {id(p) for m in self.modules()
                if isinstance(m, layers.Norm)
                for p in m.parameters(recurse=False)}
        keep |= {id(getattr(m, n)) for m in self.modules()
                 for n in getattr(m, "FP32_LEAVES", ())}
        for p in self.parameters():
            if id(p) not in keep and p.dtype != dtype:
                p.data = p.data.to(dtype)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def embed_inputs(self, inputs, ctx: RunCtx, positions):
        cfg, cd = self.cfg, ctx.compute_dtype
        if cfg.input_mode == "embeddings":
            x = inputs.to(cd)
        elif ctx.pctx.tp_on:
            x = layers.embed_tokens(self.embed, inputs, cd, pctx=ctx.pctx,
                                    vocab=cfg.padded_vocab)
        else:
            x = layers.embed_tokens(self.embed, inputs, cd)
        if cfg.pos_embedding == "sinusoidal":
            x = x + layers.sinusoidal_positions(positions, cfg.d_model, cd)
        elif cfg.pos_embedding == "learned":
            # a gather, as the tokens': its backward sums a position's B
            # repeats in fp32 at once, where indexing summed them one by
            # one in the compute dtype
            x = x + layers.embed_tokens(self.pos_embed, positions, cd)
        return x

    def head_table(self):
        return self.embed if self.cfg.tie_embeddings else self.head

    def logits(self, hidden, ctx: RunCtx):
        """The whole vocabulary's logits of ``hidden`` (B, S, d): under a
        mesh's tp axis each rank's block (``layers.unembed``), gathered."""
        cd = ctx.compute_dtype
        if not ctx.pctx.tp_on:
            return layers.unembed(self.head_table(), hidden, cd)
        V = self.cfg.padded_vocab
        return layers.gather_logits(layers.unembed(
            self.head_table(), hidden, cd, pctx=ctx.pctx, vocab=V),
            ctx.pctx, V)

    def forward(self, inputs, ctx: RunCtx, *, positions=None, caches=None,
                kv_mask=None, return_hidden: bool = False):
        """Returns (logits_or_hidden, new_caches, aux).  ``aux`` is the sum
        of the MoE blocks' load-balance terms, as the reference's (fp32 zero
        without MoE).  Under a mesh's tp axis (``ctx.pctx``) the logits are
        this rank's vocabulary block, as the reference's ``logits_spec``
        lays them out."""
        B, S = inputs.shape[0], inputs.shape[1]
        if positions is None:
            positions = torch.arange(
                S, dtype=torch.int32, device=inputs.device).expand(B, S)
        x = self.embed_inputs(inputs, ctx, positions)
        x, new_caches, aux = self.stack(x, ctx, positions=positions,
                                        caches=caches, kv_mask=kv_mask)
        x = self.final_norm(x)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if return_hidden:
            return x, new_caches, aux
        logits = layers.unembed(
            self.head_table(), x, ctx.compute_dtype,
            pctx=ctx.pctx if ctx.pctx.tp_on else None,
            vocab=self.cfg.padded_vocab)
        return logits, new_caches, aux


def lm_loss(model: LM, batch, ctx: RunCtx, *, xent_chunk: int = 0,
            aux_weight: float = 0.01):
    """Held against ``repro/models/lm.py:76-92``.  batch: {"inputs":
    tokens|embeds, "labels": (B,S) int, optional "mask": (B,S)}.  Returns
    (loss, {"loss", "xent", "aux"}).  Logits and the loss run over the
    padded vocabulary, as in the reference."""
    hidden, _, aux = model(batch["inputs"], ctx, return_hidden=True)
    table = model.head_table()
    mask = batch.get("mask")
    S = hidden.shape[1]
    chunked = bool(xent_chunk) and S % xent_chunk == 0
    if ctx.pctx.tp_on or chunked:
        # under a tp axis the logits are split by ``logits_spec``: the
        # vocabulary-parallel loss, in one chunk where none divides S
        xent = layers.chunked_softmax_xent(
            hidden, table, batch["labels"],
            chunk=xent_chunk if chunked else S,
            compute_dtype=ctx.compute_dtype, mask=mask,
            pctx=ctx.pctx if ctx.pctx.tp_on else None,
            vocab=model.cfg.padded_vocab)
    else:
        logits = layers.unembed(table, hidden, ctx.compute_dtype)
        xent = layers.softmax_xent(logits, batch["labels"], mask)
    loss = xent + aux_weight * aux
    return loss, {"loss": loss, "xent": xent, "aux": aux}
