"""Shared neural-net building blocks, held against ``repro/models/layers.py``.

Conventions:
  * plain functions on tensors plus small ``nn.Module``s that own the
    parameters (``Norm``, ``MLP``); weights keep the reference's layouts
    (``x @ wi`` with ``wi (d_model, d_ff)``), so converted parameters drop in;
  * the compute dtype is passed explicitly; norms compute in fp32;
  * wherever the reference takes a PRNG key, an explicit ``torch.Generator``
    is taken here.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(generator: Optional[torch.Generator], shape, *,
               dtype=torch.float32, device="cpu",
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init; drawn in fp32 on ``device``
    from ``generator`` (which must live on that device), then cast."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                          generator=generator)
    return (w * std).to(dtype)


def embed_init(generator: Optional[torch.Generator], shape, *,
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    w = torch.randn(tuple(shape), generator=generator, device=device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def apply_norm(params, x, kind: str, eps: float = 1e-5, *, psum=None,
               width: int = 0):
    """``params`` has ``scale`` (and ``bias`` for layernorm): a ``Norm``
    module or a dict.  fp32 inside, input dtype out.  ``psum`` (rmsnorm):
    the last dim is this rank's piece of ``width`` over a tp axis, and
    ``psum`` sums the squares over the axis."""
    get = params.__getitem__ if isinstance(params, dict) else \
        (lambda n: getattr(params, n))
    dt = x.dtype
    xf = x.float()
    if kind == "rmsnorm":
        if psum is None:
            var = xf.square().mean(dim=-1, keepdim=True)
        else:
            var = psum(xf.square().sum(dim=-1, keepdim=True)) / width
        y = xf * torch.rsqrt(var + eps) * get("scale").float()
        return y.to(dt)
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * get("scale").float() + get("bias").float()
        return y.to(dt)
    raise ValueError(kind)


class Norm(nn.Module):
    """rmsnorm (scale) or layernorm (scale + bias) over the last dim."""

    def __init__(self, kind: str, d: int, *, eps: float = 1e-5,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm"):
            raise ValueError(kind)
        self.kind, self.eps = kind, eps
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        if kind == "layernorm":
            self.bias = nn.Parameter(
                torch.zeros(d, dtype=dtype, device=device))

    def forward(self, x):
        return apply_norm(self, x, self.kind, self.eps)


# ---------------------------------------------------------------------------
# rotary / positional embeddings
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, fraction: float, theta: float):
    rot_dim = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (np.arange(0, rot_dim, 2, dtype=np.float32)
                           / rot_dim))
    return rot_dim, inv.astype(np.float32)


_INV_FREQ: dict = {}    # (head_dim, fraction, theta, device) -> (rot, inv)


def _device_frequencies(head_dim: int, fraction: float, theta: float,
                        device):
    """``rope_frequencies`` with the table placed on ``device`` once: a
    host-to-device copy in every call would make the host wait for the GPU
    in every layer of every step."""
    key = (head_dim, fraction, theta, str(device))
    if key not in _INV_FREQ:
        rot_dim, inv = rope_frequencies(head_dim, fraction, theta)
        _INV_FREQ[key] = (rot_dim, torch.from_numpy(inv).to(device))
    return _INV_FREQ[key]


def rope_tables(positions, head_dim: int, dtype, *, fraction: float = 1.0,
                theta: float = 10000.0):
    """(cos, sin), each (..., S, 1, rot/2) in ``dtype``, for ``apply_rope``.
    They depend on the positions alone, so a stack computes them once per
    forward pass and hands them to every layer."""
    rot_dim, inv = _device_frequencies(head_dim, fraction, theta,
                                       positions.device)
    if rot_dim == 0:
        return None
    ang = positions[..., :, None].float() * inv            # (..., S, rot/2)
    # like the reference, cos/sin are cast to the working dtype *before*
    # the multiply
    return (torch.cos(ang)[..., None, :].to(dtype),
            torch.sin(ang)[..., None, :].to(dtype))


def apply_rope(x, positions, *, fraction: float = 1.0,
               theta: float = 10000.0, tables=None):
    """x: (..., S, H, D); positions: broadcastable to (..., S).  ``tables``:
    ``rope_tables(positions, D, x.dtype, ...)`` where the caller has them."""
    d = x.shape[-1]
    rot_dim = int(d * fraction) // 2 * 2
    if rot_dim == 0:
        return x
    if tables is None:
        tables = rope_tables(positions, d, x.dtype, fraction=fraction,
                             theta=theta)
    cos, sin = tables
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out, x_pass], dim=-1) if rot_dim < d else out


def sinusoidal_positions(positions, d_model: int, dtype=torch.float32):
    half = d_model // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# MLP (dense FFN)
# ---------------------------------------------------------------------------
def apply_mlp(params, x, act: str, compute_dtype=torch.bfloat16, *,
              pctx=None, d_ff: Optional[int] = None):
    """``params`` has ``wi``, ``wo`` (and ``wg`` for the gated acts): an
    ``MLP`` module or a dict.  Under ``pctx`` (a ``ParallelCtx`` whose mesh
    has the tp axis) the MLP is column- then row-parallel: this rank's
    columns of ``wi`` / ``wg`` and rows of ``wo`` (its piece of the width
    ``d_ff``, or its block of a whole leaf, zero-padded where the width
    does not divide), one *copy* in and one *reduce* out."""
    get = params.__getitem__ if isinstance(params, dict) else \
        (lambda n: getattr(params, n))
    cd = compute_dtype
    x = x.to(cd)
    wi, wo = get("wi"), get("wo")
    wg = get("wg") if act in ("swiglu", "geglu") else None
    if pctx is not None:
        width = d_ff if d_ff is not None else params.d_ff
        x = pctx.copy(x)
        wi, wo = pctx.cut(wi, 1, width), pctx.cut(wo, 0, width)
        wg = pctx.cut(wg, 1, width) if wg is not None else None
    h = x @ wi.to(cd)
    if act == "swiglu":
        h = F.silu(h) * (x @ wg.to(cd))
    elif act == "geglu":
        h = F.gelu(h, approximate="tanh") * (x @ wg.to(cd))
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default form
    else:
        raise ValueError(act)
    y = h @ wo.to(cd)
    return pctx.reduce(y) if pctx is not None else y


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, act: str, *,
                 generator=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.act, self.d_ff = act, d_ff
        kw = dict(dtype=dtype, device=device)
        self.wi = nn.Parameter(dense_init(generator, (d_model, d_ff), **kw))
        if act in ("swiglu", "geglu"):
            self.wg = nn.Parameter(
                dense_init(generator, (d_model, d_ff), **kw))
        self.wo = nn.Parameter(dense_init(generator, (d_ff, d_model), **kw))

    def forward(self, x, compute_dtype=torch.bfloat16, pctx=None):
        return apply_mlp(self, x, self.act, compute_dtype, pctx=pctx)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------
def embed_tokens(table, tokens, compute_dtype=torch.bfloat16, *, pctx=None,
                 vocab: Optional[int] = None):
    """table (V, d); tokens int -> (..., d) in the compute dtype.

    Under ``pctx`` (the tp axis) the table is vocabulary-parallel: this
    rank looks up the ids in its block of ``vocab`` rows (its piece, or its
    block of a whole table), zeros the others, and the ranks' rows are
    summed (*reduce*; one of them is non-zero, so the sum is exact)."""
    if pctx is None:
        return F.embedding(tokens.long(), table).to(compute_dtype)
    tab = pctx.cut(table, 0, vocab)
    n = tab.shape[0]
    ids = tokens.long() - pctx.tp_rank * n
    inside = (ids >= 0) & (ids < n)
    rows = F.embedding(ids.clamp(0, n - 1), tab)
    rows = rows * inside[..., None].to(rows.dtype)
    return pctx.reduce(rows).to(compute_dtype)


def unembed(table, x, compute_dtype=torch.bfloat16, *, pctx=None,
            vocab: Optional[int] = None):
    """Logits; under ``pctx`` this rank's vocabulary block of them (the
    reference's ``logits_spec``: the vocabulary over the tp axis), from a
    *copy* of ``x``."""
    if pctx is None:
        return x.to(compute_dtype) @ table.to(compute_dtype).T
    tab = pctx.cut(table, 0, vocab)
    return pctx.copy(x.to(compute_dtype)) @ tab.to(compute_dtype).T


def gather_logits(logits, pctx, vocab: int):
    """The whole vocabulary's logits from each rank's block (all-gather over
    the tp axis, the zero-padded tail cut off); no gradient."""
    return pctx.all_gather(logits, logits.dim() - 1)[..., :vocab]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _gold_logit(logits, labels):
    """logits[..., labels] (the reference's masked reduction picks the same
    single value)."""
    return logits.gather(-1, labels.long()[..., None])[..., 0]


def softmax_xent(logits, labels, mask=None):
    """Mean next-token cross entropy; logits (..., V) any float dtype,
    labels int."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - _gold_logit(logits, labels)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


class _ChunkedXent(torch.autograd.Function):
    """Forward: per sequence chunk, (B, chunk, V) logits -> per-token NLL,
    then discarded.  Backward: each chunk's logits are recomputed from the
    saved hidden states and per-token log-sum-exp, so the full (B, S, V)
    logits never exist in either pass.  The table's gradient is summed over
    chunks in fp32 (the reference's scan carries it in the compute dtype:
    the same in fp32, a rounding apart in bf16).

    With a tp ``group`` the table is this rank's vocabulary block (its
    rows, the first ``v0``, the whole ``vocab``): per chunk, the row max
    over the axis (a MAX all-reduce), then one sum all-reduce of the
    exponentials' sum and of the target's logit (from the rank whose block
    holds it).  Backward: the local logits' gradient, so the hidden state's
    is partial, summed by the *copy* the caller put before ``x``; the table
    block's is whole."""

    @staticmethod
    def forward(ctx, x, table, labels, mask, chunk, compute_dtype, v0,
                vocab, group):
        B, S, _ = x.shape
        tab = table.to(compute_dtype)
        lse = torch.empty((B, S), dtype=torch.float32, device=x.device)
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, S, chunk):
            sl = slice(c0, c0 + chunk)
            logits = _vocab_logits(x[:, sl], tab, v0, vocab, compute_dtype)
            lse[:, sl], gold = _lse_gold(logits, labels[:, sl].long() - v0,
                                         group)
            nll = (lse[:, sl] - gold) * mask[:, sl]
            tot = tot + nll.sum()
        cnt = mask.sum().clamp_min(1.0)
        ctx.save_for_backward(x, table, labels, mask, lse, cnt)
        ctx.chunk, ctx.compute_dtype, ctx.v0, ctx.vocab = \
            chunk, compute_dtype, v0, vocab
        return tot / cnt

    @staticmethod
    def backward(ctx, g):
        x, table, labels, mask, lse, cnt = ctx.saved_tensors
        cd, chunk, v0 = ctx.compute_dtype, ctx.chunk, ctx.v0
        B, S, D = x.shape
        tab = table.to(cd)
        n = tab.shape[0]
        dx = torch.empty_like(x)
        dtab = torch.zeros(table.shape, dtype=torch.float32,
                           device=table.device)
        w = mask * (g / cnt)                     # d loss / d nll, per token
        for c0 in range(0, S, chunk):
            sl = slice(c0, c0 + chunk)
            xc = x[:, sl].to(cd)
            logits = _vocab_logits(xc, tab, v0, ctx.vocab, cd)
            # d nll / d logits = softmax - onehot(label), the onehot on the
            # rank whose block holds the label
            dl = torch.exp(logits - lse[:, sl, None])
            local = labels[:, sl].long() - v0
            inside = (local >= 0) & (local < n)
            dl.scatter_add_(-1, local.clamp(0, n - 1)[..., None],
                            -inside[..., None].to(dl.dtype))
            dl = (dl * w[:, sl, None]).to(cd)
            dx[:, sl] = (dl @ tab).to(x.dtype)
            dtab += (dl.reshape(-1, dl.shape[-1]).T
                     @ xc.reshape(-1, D)).float()
        return (dx, dtab.to(table.dtype), None, None, None, None, None,
                None, None)


def _vocab_logits(x, tab, v0: int, vocab: Optional[int], compute_dtype):
    """fp32 logits of a vocabulary block; rows past ``vocab`` (the zero
    padding of a block that does not divide) never win the softmax."""
    logits = (x.to(compute_dtype) @ tab.T).float()
    if vocab is not None and v0 + tab.shape[0] > vocab:
        live = torch.arange(v0, v0 + tab.shape[0], device=x.device) < vocab
        logits = torch.where(live, logits, float("-inf"))
    return logits


def _lse_gold(logits, local, group):
    """(log-sum-exp, the target's logit) of each row; ``local`` the targets'
    ids in this block.  With a tp ``group`` the block is one of the axis's:
    one MAX and one sum all-reduce join the ranks' parts."""
    if group is None:
        return torch.logsumexp(logits, dim=-1), _gold_logit(logits, local)
    from repro_torch.core import hierarchy
    n = logits.shape[-1]
    m = hierarchy.all_reduce(logits.amax(dim=-1), group, op="max")
    inside = (local >= 0) & (local < n)
    gold = torch.where(inside, logits.gather(
        -1, local.clamp(0, n - 1)[..., None])[..., 0], 0.0)
    sums = torch.stack([torch.exp(logits - m[..., None]).sum(-1), gold])
    s, gold = hierarchy.all_reduce(sums, group).unbind(0)
    return torch.log(s) + m, gold


def chunked_softmax_xent(x, embed_table, labels, *, chunk: int,
                         compute_dtype=torch.bfloat16, mask=None, pctx=None,
                         vocab: Optional[int] = None):
    """Cross entropy without materialising the full (B, S, V) logits.

    x: (B, S, D) final hidden states; embed_table: (V, D).  Each chunk of
    ``chunk`` positions computes (B, chunk, V) logits, reduces them to
    per-token NLL and discards them; the backward recomputes them chunk by
    chunk (the reference's docstring intends this; its ``lax.scan`` is
    differentiated by JAX).

    ``pctx`` (a mesh's tp axis): the logits split by the reference's
    ``logits_spec`` (the ``vocab`` rows over the axis); ``embed_table`` is
    this rank's block of the table, or the whole, and ``x`` the same on
    every rank of the axis.  The loss is the same on every rank."""
    B, S, _ = x.shape
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    if pctx is None:
        return _ChunkedXent.apply(x, embed_table, labels, mask.float(),
                                  chunk, compute_dtype, 0, None, None)
    tab = pctx.cut(embed_table, 0, vocab)
    return _ChunkedXent.apply(
        pctx.copy(x), tab, labels, mask.float(), chunk, compute_dtype,
        pctx.tp_rank * tab.shape[0], vocab, pctx.tp_group)
