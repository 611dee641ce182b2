"""Mamba-2 (SSD, state-space duality) mixer, held against
``repro/models/ssm.py``.

Prefill runs the chunked SSD scan through ``kernels.ops.ssd`` -- the
hand-written kernel under ``impl="kernel"`` (the default), the plain version
(a copy of the reference's ``ssd_chunked``) under ``"plain"``.  Training
reaches the same call with inputs that need gradients: ``ops.ssd`` then goes
through ``SSDFn`` (the forward kernel and the hand-written SSD backward);
``A_log``, ``D`` and ``dt_bias`` stay fp32 and get fp32 gradients.  Decode is the
single-step linear recurrence ``h <- exp(dt*A) h + dt*B x^T`` in plain
PyTorch, as in the reference, which has no kernel for it.

The input projections are split per stream (z / x / B / C / dt) with
per-stream causal convs, in the reference's parameter layout.  Decode
caches are updated **in place**: ``conv_*`` keep the dtype they were made
with (fp32 from ``init_ssm_cache``, as the reference's slot caches are made)
and are written with the same values the reference's new caches hold.

``ssd_sharded`` (the reference's ``shard_map`` over a mesh) waits for the
parallel layer.

Shapes: x (B, S, H, P); dt (B, S, H); A (H,); B/C (B, S, G, N); state
(B, H, N, P).  H heads in G groups (heads share B/C within a group).
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

_MESH = ("ssd_sharded (the SSD core under a mesh) is not ported yet: "
         "ROADMAP queue A item 7 (the parallel layer)")


def ssd_sharded(x, dt, A, Bm, Cm, *, chunk: int, mesh, dp_axes, tp_axis):
    raise NotImplementedError(_MESH)


def ssd_decode_step(x, dt, A, Bm, Cm, h):
    """One token. x (B,H,P); dt (B,H); B/C (B,G,N); h (B,H,N,P) -> (y
    (B,H,P) fp32, h_new (B,H,N,P) fp32)."""
    H, G = x.shape[1], Bm.shape[1]
    hpg = H // G
    x = x.float()
    dt = dt.float()
    a = torch.exp(dt * A.float())                            # (B,H)
    Bh = Bm.float().repeat_interleave(hpg, dim=1)            # (B,H,N)
    Ch = Cm.float().repeat_interleave(hpg, dim=1)
    h_new = a[..., None, None] * h + \
        (dt[..., None] * Bh)[..., None] * x[:, :, None, :]   # (B,H,N,P)
    y = torch.einsum("bhn,bhnp->bhp", Ch, h_new)
    return y, h_new


# ---------------------------------------------------------------------------
# causal depthwise conv1d (+ cache)
# ---------------------------------------------------------------------------
def causal_conv1d(x, w, cache=None, length=None):
    """x (B, S, C); w (K, C) depthwise.  Returns (y, new_cache (B,K-1,C)).

    K shift-and-multiply taps, as the reference.  ``length`` (B,) int: real
    (unpadded) sequence lengths; when given, ``new_cache`` holds the K-1
    inputs *preceding position length* rather than the tail of the
    (right-padded) array, so padded columns never reach the decode-side conv
    state.
    """
    K = w.shape[0]
    S = x.shape[1]
    if cache is not None:
        x_pad = torch.cat([cache.to(x.dtype), x], dim=1)
    else:
        x_pad = F.pad(x, (0, 0, K - 1, 0))
    y = None
    for j in range(K):
        tap = x_pad[:, j:j + S] * w[j].to(x.dtype)
        y = tap if y is None else y + tap
    if K <= 1:
        return y, None
    if length is None:
        return y, x_pad[:, -(K - 1):]
    # x_pad index of real position p is p + K - 1, so the tail inputs at
    # positions [length-K+1, length-1] sit at x_pad[length .. length+K-2]
    idx = length.long()[:, None] + torch.arange(K - 1, device=x.device)
    new_cache = torch.take_along_dim(x_pad, idx[:, :, None], dim=1)
    return y, new_cache


# ---------------------------------------------------------------------------
# the Mamba-2 block's parameters
# ---------------------------------------------------------------------------
class SSM(nn.Module):
    """The leaves of the reference's ``init_ssm``, in its layouts.
    ``A_log``, ``D`` and ``dt_bias`` are fp32 whatever ``dtype`` is (as in
    the reference) and stay so when the model's weights are cast."""

    FP32_LEAVES = ("A_log", "D", "dt_bias")

    def __init__(self, cfg: ModelConfig, *, generator=None,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        s = cfg.ssm
        d = cfg.d_model
        d_in = s.expand * d
        H = d_in // s.head_dim
        gn = s.n_groups * s.d_state
        kw = dict(dtype=dtype, device=device)

        def dense(shape):
            return nn.Parameter(layers.dense_init(generator, shape, **kw))

        def conv(width):
            w = torch.randn((s.d_conv, width), generator=generator,
                            device=device, dtype=torch.float32)
            return nn.Parameter((w / math.sqrt(s.d_conv)).to(dtype))

        def uniform(n):
            return torch.rand((n,), generator=generator, device=device,
                              dtype=torch.float32)

        lo, hi = s.a_init_range
        A = lo + (hi - lo) * uniform(H)
        self.in_z, self.in_x = dense((d, d_in)), dense((d, d_in))
        self.in_b, self.in_c = dense((d, gn)), dense((d, gn))
        self.in_dt = dense((d, H))
        self.conv_x_w = conv(d_in)
        self.conv_x_b = nn.Parameter(torch.zeros((d_in,), **kw))
        self.conv_b_w = conv(gn)
        self.conv_b_b = nn.Parameter(torch.zeros((gn,), **kw))
        self.conv_c_w = conv(gn)
        self.conv_c_b = nn.Parameter(torch.zeros((gn,), **kw))
        self.A_log = nn.Parameter(torch.log(A))
        self.D = nn.Parameter(torch.ones((H,), dtype=torch.float32,
                                         device=device))
        dt0 = torch.exp(uniform(H) * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
        self.dt_bias = nn.Parameter(torch.log(torch.expm1(dt0)))
        self.norm = layers.Norm("rmsnorm", d_in, eps=cfg.norm_eps, **kw)
        self.out_proj = dense((d_in, d))


def apply_ssm(params: SSM, x, cfg: ModelConfig, *,
              compute_dtype=torch.bfloat16, cache: Optional[dict] = None,
              build_cache: bool = False, token_mask=None, impl="kernel"):
    """x (B,S,d_model) -> (y, new_cache|None).

    cache = {"conv_x"/"conv_b"/"conv_c": (B,K-1,*), "state": (B,H,N,P)}:
    single-token decode, the cache updated in place and returned.
    ``token_mask`` (B,S) bool, True = real token: right-padded positions get
    dt = 0 (decay 1, zero input -- the state passes through unchanged) and
    the conv caches are rebuilt from the true tail.  ``impl`` "kernel" |
    "plain" picks the prefill's SSD scan.
    """
    s = cfg.ssm
    cd = compute_dtype
    B, S, _ = x.shape
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    xc = x.to(cd)

    z = xc @ params.in_z.to(cd)
    xs = xc @ params.in_x.to(cd)
    bs = xc @ params.in_b.to(cd)
    cs = xc @ params.in_c.to(cd)
    dt = xc @ params.in_dt.to(cd)

    lengths = None
    if token_mask is not None and cache is None:
        lengths = token_mask.to(torch.int32).sum(dim=1)

    cx = cache["conv_x"] if cache is not None else None
    cb = cache["conv_b"] if cache is not None else None
    cc = cache["conv_c"] if cache is not None else None
    xs, ncx = causal_conv1d(xs, params.conv_x_w, cache=cx, length=lengths)
    bs, ncb = causal_conv1d(bs, params.conv_b_w, cache=cb, length=lengths)
    cs, ncc = causal_conv1d(cs, params.conv_c_w, cache=cc, length=lengths)
    xs = F.silu(xs + params.conv_x_b.to(xs.dtype))
    bs = F.silu(bs + params.conv_b_b.to(bs.dtype))
    cs = F.silu(cs + params.conv_c_b.to(cs.dtype))

    xin = xs.reshape(B, S, H, s.head_dim)
    Bm = bs.reshape(B, S, s.n_groups, s.d_state)
    Cm = cs.reshape(B, S, s.n_groups, s.d_state)
    dtv = F.softplus(dt.float() + params.dt_bias)
    if lengths is not None:
        dtv = torch.where(token_mask[:, :, None], dtv, 0.0)
    A = -torch.exp(params.A_log)

    if cache is not None:
        y, h_new = ssd_decode_step(xin[:, 0], dtv[:, 0], A, Bm[:, 0],
                                   Cm[:, 0], cache["state"])
        y = y[:, None]
        for name, new in (("conv_x", ncx), ("conv_b", ncb),
                          ("conv_c", ncc), ("state", h_new)):
            cache[name].copy_(new)
        new_cache = cache
    else:
        y, h_final = ops.ssd(xin.contiguous(), dtv.contiguous(), A,
                             Bm.contiguous(), Cm.contiguous(),
                             chunk=s.chunk, impl=impl)
        new_cache = ({"conv_x": ncx, "conv_b": ncb, "conv_c": ncc,
                      "state": h_final} if build_cache else None)

    y = y + params.D[:, None] * xin.float()
    y = y.reshape(B, S, d_in).to(cd)
    y = layers.apply_norm(params.norm, y * F.silu(z), "rmsnorm",
                          cfg.norm_eps)
    out = y.to(cd) @ params.out_proj.to(cd)
    return out, new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device="cpu"):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    gn = s.n_groups * s.d_state
    kw = dict(dtype=dtype, device=device)
    return {
        "conv_x": torch.zeros((batch, s.d_conv - 1, d_in), **kw),
        "conv_b": torch.zeros((batch, s.d_conv - 1, gn), **kw),
        "conv_c": torch.zeros((batch, s.d_conv - 1, gn), **kw),
        "state": torch.zeros((batch, H, s.d_state, s.head_dim),
                             dtype=torch.float32, device=device),
    }
