"""BERT-base / BERT-large with the SQuAD QA head (the paper's NLP
benchmarks), held against ``repro/models/bert.py``.

``BertQA`` holds the port's ``LM`` (``causal=False``, learned positions, QKV
bias, layernorm, tanh-GELU: ``configs/paper_bench.BERT_BASE``) plus
``segment_embed`` (2, d_model) and the QA head ``qa_head.w`` (d_model, 2),
``qa_head.b`` (2,).  As in the reference (``:31-45``), the segment embedding
is added to the hidden state **after** the final norm, not to the input as
in published BERT; the span logits are computed in fp32.

On ``attn_impl="kernel"`` the bidirectional attention runs the flash
kernels (B2 under autograd, B1 without a gradient).  They take no key mask:
a batch with ``"mask"`` raises there (``models/attention.py``) and runs on
``attn_impl="full"``, which masks as the reference's ``"full"`` path does.
(The reference's default flash path drops the mask: ROADMAP queue C.)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.lm import LM, require_device
from repro_torch.models.transformer import RunCtx


class QAHead(nn.Module):
    def __init__(self, generator, d_model, *, dtype, device):
        super().__init__()
        self.w = nn.Parameter(layers.dense_init(
            generator, (d_model, 2), dtype=dtype, device=device))
        self.b = nn.Parameter(torch.zeros(2, dtype=dtype, device=device))


class BertQA(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator=None,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        self.lm = LM(cfg, generator=generator, **kw)
        self.segment_embed = nn.Parameter(layers.embed_init(
            generator, (2, cfg.d_model), **kw))
        self.qa_head = QAHead(generator, cfg.d_model, **kw)

    @classmethod
    def init(cls, cfg: ModelConfig, *, seed: int = 0, dtype=torch.float32,
             device="cuda") -> "BertQA":
        """Random weights drawn on ``device`` from ``seed`` (the counterpart
        of ``init_bert_qa(key, cfg)``)."""
        dev = require_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return cls(cfg, generator=gen, dtype=dtype, device=dev)

    @property
    def device(self) -> torch.device:
        return self.lm.device


def forward_qa(model: BertQA, tokens, ctx: RunCtx, *, segments=None,
               attn_mask=None):
    """tokens (B, S) -> (start_logits, end_logits), each (B, S) fp32."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    kv_mask = None if attn_mask is None else attn_mask.bool()
    hidden, _, _ = model.lm(tokens, ctx, positions=positions,
                            kv_mask=kv_mask, return_hidden=True)
    if segments is not None:
        # a gather (``F.embedding``): its backward sums the two rows' B * S
        # repeats in fp32 at once, where indexing summed them one by one
        hidden = hidden + layers.embed_tokens(model.segment_embed, segments,
                                              hidden.dtype)
    logits = (hidden.float() @ model.qa_head.w.float()
              + model.qa_head.b.float())
    return logits[..., 0], logits[..., 1]


def qa_loss(model: BertQA, batch, ctx: RunCtx):
    """batch: tokens (B, S), start / end (B,) int, optional segments and
    mask (B, S).  The mean of the start and end span NLLs, halved."""
    start_l, end_l = forward_qa(model, batch["tokens"], ctx,
                                segments=batch.get("segments"),
                                attn_mask=batch.get("mask"))

    def span_nll(logit, pos):
        logp = F.log_softmax(logit, dim=-1)
        return -logp.gather(-1, pos.long()[:, None])[:, 0]

    loss = (span_nll(start_l, batch["start"])
            + span_nll(end_l, batch["end"])).mean() / 2.0
    return loss, {"loss": loss}
