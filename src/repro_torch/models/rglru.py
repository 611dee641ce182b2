"""RG-LRU recurrent block (Griffin / RecurrentGemma), held against
``repro/models/rglru.py``.

Recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)            # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            # input gate
    log a_t = -c * softplus(Lambda) * r_t
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill (and the training forward) runs the recurrence through
``kernels.ops.rglru`` -- the hand-written kernel under ``impl="kernel"``
(the default; under autograd ``RGLRUFn``, whose backward is the
hand-written reverse scan), the plain log-depth scan under ``"plain"``
(differentiated by autograd); the reference's model path runs
``rglru_scan_chunked``, an associative scan that XLA differentiates.  The
gates, the block-diagonal products and ``causal_conv1d`` are plain torch
ops, differentiated by autograd as the reference's are by JAX.  Decode is the single-step
recurrence in plain PyTorch, as in the reference.  Gates are block-diagonal
(8 blocks), in fp32.  The full recurrent block is:
    x -> [linear -> gelu]  (gate branch)
      -> [linear -> causal conv1d -> RG-LRU] (recurrent branch)
    y = gate * recurrent -> linear out

The reference's ``batch_axes`` / ``model_axis`` sharding pins exist only
under a mesh and are dropped.  Decode caches are updated **in place** (the
conv cache keeps the dtype it was made with).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.ssm import causal_conv1d

N_GATE_BLOCKS = 8


class RGLRU(nn.Module):
    """The leaves of the reference's ``init_rglru``, in its layouts.  The
    gate weights and biases and ``lam`` are fp32 whatever ``dtype`` is (as
    in the reference) and stay so when the model's weights are cast."""

    FP32_LEAVES = ("wa", "ba", "wx", "bx", "lam")

    def __init__(self, cfg: ModelConfig, *, generator=None,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        r = cfg.rglru
        d = cfg.d_model
        w = r.lru_width or d
        nb = N_GATE_BLOCKS
        if w % nb:
            raise ValueError(f"lru_width {w} is not a multiple of {nb}")
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        # Lambda init so that a^c in [0.9, 0.999] at r=1 (Griffin appendix)
        u = torch.rand((w,), generator=generator, **f32) \
            * (0.999 ** 2 - 0.9 ** 2) + 0.9 ** 2
        conv = torch.randn((r.d_conv, w), generator=generator, **f32)
        self.in_gate = nn.Parameter(layers.dense_init(generator, (d, w),
                                                      **kw))
        self.in_rec = nn.Parameter(layers.dense_init(generator, (d, w), **kw))
        self.conv_w = nn.Parameter((conv / math.sqrt(r.d_conv)).to(dtype))
        self.conv_b = nn.Parameter(torch.zeros((w,), **kw))
        self.wa = nn.Parameter(layers.dense_init(
            generator, (nb, w // nb, w // nb), **f32))
        self.ba = nn.Parameter(torch.zeros((w,), **f32))
        self.wx = nn.Parameter(layers.dense_init(
            generator, (nb, w // nb, w // nb), **f32))
        self.bx = nn.Parameter(torch.zeros((w,), **f32))
        self.lam = nn.Parameter(torch.log(torch.expm1(
            -torch.log(u) / (2 * r.c))))
        self.out_proj = nn.Parameter(layers.dense_init(generator, (w, d),
                                                       **kw))


def _block_diag(x, w, b):
    """x (..., W) with W = nb * bs; w (nb, bs, bs)."""
    nb, bs, _ = w.shape
    xb = x.reshape(x.shape[:-1] + (nb, bs))
    y = torch.einsum("...nb,nbc->...nc", xb, w)
    return y.reshape(x.shape[:-1] + (nb * bs,)) + b


def rglru_gates(params: RGLRU, x, c: float):
    """x (B,S,W) -> (log_a (B,S,W), gated_in (B,S,W)), both fp32."""
    xf = x.float()
    r = torch.sigmoid(_block_diag(xf, params.wa, params.ba))
    i = torch.sigmoid(_block_diag(xf, params.wx, params.bx))
    log_a = -c * F.softplus(params.lam) * r
    a2 = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * xf)
    return log_a, gated


def rglru_decode_step(log_a, gated, h):
    return torch.exp(log_a) * h + gated


def apply_rglru(params: RGLRU, x, cfg: ModelConfig, *,
                compute_dtype=torch.bfloat16, cache: Optional[dict] = None,
                build_cache: bool = False, token_mask=None, impl="kernel"):
    """x (B,S,d_model) -> (y, new_cache|None).

    cache = {"conv": (B,K-1,W), "state": (B,W) fp32}: single-token decode,
    the cache updated in place and returned.  ``token_mask`` (B,S) bool,
    True = real token: right-padded positions become identity recurrence
    steps (a = 1, input contribution 0), so the cached state is exactly the
    state after the last real token; the conv cache is rebuilt from the true
    tail.  ``impl`` "kernel" | "plain" picks the prefill's scan.
    """
    r = cfg.rglru
    cd = compute_dtype
    xc = x.to(cd)
    gate = F.gelu(xc @ params.in_gate.to(cd), approximate="tanh")
    rec = xc @ params.in_rec.to(cd)
    lengths = None
    if token_mask is not None and cache is None:
        lengths = token_mask.to(torch.int32).sum(dim=1)
    conv_cache = cache["conv"] if cache is not None else None
    rec, new_conv = causal_conv1d(rec, params.conv_w, cache=conv_cache,
                                  length=lengths)
    rec = rec + params.conv_b.to(rec.dtype)
    log_a, gated = rglru_gates(params, rec, r.c)
    if lengths is not None:
        keep = token_mask[:, :, None]
        log_a = torch.where(keep, log_a, 0.0)     # a = 1: state unchanged
        gated = torch.where(keep, gated, 0.0)     # no padded input folded in

    if cache is not None:
        h = rglru_decode_step(log_a[:, 0], gated[:, 0], cache["state"])
        hs = h[:, None]
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(h)
        new_cache = cache
    else:
        hs = ops.rglru(log_a.contiguous(), gated.contiguous(), impl=impl)
        new_cache = ({"conv": new_conv, "state": hs[:, -1]}
                     if build_cache else None)

    y = (hs.to(cd) * gate) @ params.out_proj.to(cd)
    return y, new_cache


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cpu"):
    r = cfg.rglru
    w = r.lru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, r.d_conv - 1, w), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }
