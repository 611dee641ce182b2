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

Under a mesh's tp axis (``pctx``) the mixer is tensor-parallel (held
against ``repro/models/ssm.py:104-153, 310-313``): ``in_z`` / ``in_x``
give this rank's channels (heads over the axis), ``in_b`` / ``in_c`` /
``in_dt`` and the small conv weights are replicated and each rank takes
its channels' columns, ``ssd_sharded`` runs B4 on ``H / tp`` heads, the
gated RMSNorm sums its squares over the axis (``d_in`` is split), and
``out_proj`` is row-parallel with one *reduce*.  Where ``H % tp`` the
channels are gathered, the whole SSD runs on every rank (the reference's
fallback) and each keeps its piece.  Decode gathers its pieces, runs the
whole single-step recurrence, and keeps each cache leaf's piece under
``core/policy.cache_specs``.

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

def ssd_sharded(x, dt, A, Bm, Cm, *, chunk: int, pctx, heads=None,
                impl="kernel"):
    """The SSD core with heads over the tp axis, held against
    ``repro/models/ssm.py:104-153``: the batch is the rank's piece over the
    dp axes already; B/C are replicated; x / dt / A of every head (or of
    this rank's ``H / tp``; ``heads``: the whole H, default x's) are cut to
    this rank's and ``kernels.ops.ssd`` (B4) runs on them.  Returns this
    rank's (y (B, S, H/tp, P), h (B, H/tp, N, P)).  Where ``H % tp`` it
    falls back to the whole SSD on every rank, as the reference does, and
    returns every head's."""
    H = heads if heads is not None else x.shape[2]
    if H % pctx.tp:
        if x.shape[2] != H:
            raise ValueError(f"{H} heads over {pctx.tp}: the fallback "
                             f"takes every head, not {x.shape[2]}")
        return ops.ssd(x.contiguous(), dt.contiguous(), A, Bm.contiguous(),
                       Cm.contiguous(), chunk=chunk, impl=impl)
    x, dt, A = pctx.cut(x, 2, H), pctx.cut(dt, 2, H), pctx.cut(A, 0, H)
    return ops.ssd(x.contiguous(), dt.contiguous(), A.contiguous(),
                   Bm.contiguous(), Cm.contiguous(), chunk=chunk, impl=impl)


def _cache_tp_dim(shape, tp: int):
    """The dim of a recurrent cache leaf (batch first, whole shape) that
    ``core/policy.cache_spec`` splits over a tp axis of ``tp`` ranks: the
    largest that divides and is at least ``2 tp``."""
    cands = [(shape[d], d) for d in range(1, len(shape))
             if shape[d] % tp == 0 and shape[d] >= 2 * tp]
    return max(cands)[1] if cands else None


def _whole(t, dim, pctx):
    """The pieces of ``t`` along ``dim`` joined over the tp axis (no
    gradient: serving); ``t`` without a mesh or a dim."""
    return t if pctx is None or dim is None else pctx.all_gather(t, dim)


def _keep(t, dim, pctx):
    """This rank's piece of a whole cache leaf (``_cache_tp_dim``'s)."""
    if pctx is None or dim is None:
        return t
    n = t.shape[dim] // pctx.tp
    return t.narrow(dim, pctx.tp_rank * n, n).contiguous()


def _param_whole(w, dim: int, full: int, pctx):
    """A replicated leaf as it is; the pieces of one joined (no gradient:
    the decode step's)."""
    return w if w.shape[dim] == full else pctx.all_gather(w, dim)


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
              build_cache: bool = False, token_mask=None, impl="kernel",
              pctx=None):
    """x (B,S,d_model) -> (y, new_cache|None).

    cache = {"conv_x"/"conv_b"/"conv_c": (B,K-1,*), "state": (B,H,N,P)}:
    single-token decode, the cache updated in place and returned.
    ``token_mask`` (B,S) bool, True = real token: right-padded positions get
    dt = 0 (decay 1, zero input -- the state passes through unchanged) and
    the conv caches are rebuilt from the true tail.  ``impl`` "kernel" |
    "plain" picks the prefill's SSD scan.  ``pctx``: the tensor-parallel
    mixer (module docstring); without it every cut, gather and reduce
    below is the identity.
    """
    s = cfg.ssm
    cd = compute_dtype
    B, S, _ = x.shape
    d_in = s.expand * cfg.d_model
    P = s.head_dim
    H = d_in // P
    gn = s.n_groups * s.d_state
    tp, rank = (pctx.tp, pctx.tp_rank) if pctx is not None else (1, 0)
    if d_in % tp:
        raise NotImplementedError(f"the SSM's {d_in} inner channels over a "
                                  f"model axis of {tp}")
    split = H % tp == 0               # heads over the axis, else gathered

    def cut(t, dim, full):
        return t if pctx is None else pctx.cut(t, dim, full)

    xc = x.to(cd) if pctx is None else pctx.copy(x.to(cd))
    z = xc @ cut(params.in_z, 1, d_in).to(cd)             # my channels
    xs = xc @ cut(params.in_x, 1, d_in).to(cd)
    bs = xc @ params.in_b.to(cd)
    cs = xc @ params.in_c.to(cd)
    in_dt = cut(params.in_dt, 1, H) if split and cache is None \
        else params.in_dt
    dt = xc @ in_dt.to(cd)

    lengths = None
    if token_mask is not None and cache is None:
        lengths = token_mask.to(torch.int32).sum(dim=1)
    shapes = {"conv_x": (B, s.d_conv - 1, d_in),
              "conv_b": (B, s.d_conv - 1, gn),
              "conv_c": (B, s.d_conv - 1, gn),
              "state": (B, H, s.d_state, P)}
    dims = {n: _cache_tp_dim(sh, tp) if pctx is not None else None
            for n, sh in shapes.items()}
    whole = None
    if cache is not None:
        whole = {n: _whole(cache[n], dims[n], pctx) for n in shapes}
    n_ch = d_in // tp
    cx = whole["conv_x"].narrow(2, rank * n_ch, n_ch) \
        if whole is not None else None
    cb = whole["conv_b"] if whole is not None else None
    cc = whole["conv_c"] if whole is not None else None
    if cache is None:
        wb, wc = params.conv_b_w, params.conv_c_w
        bb, bc = params.conv_b_b, params.conv_c_b
    else:
        wb, wc = (_param_whole(params.conv_b_w, 1, gn, pctx),
                  _param_whole(params.conv_c_w, 1, gn, pctx))
        bb, bc = (_param_whole(params.conv_b_b, 0, gn, pctx),
                  _param_whole(params.conv_c_b, 0, gn, pctx))
    xs, ncx = causal_conv1d(xs, cut(params.conv_x_w, 1, d_in), cache=cx,
                            length=lengths)
    bs, ncb = causal_conv1d(bs, wb, cache=cb, length=lengths)
    cs, ncc = causal_conv1d(cs, wc, cache=cc, length=lengths)
    xs = F.silu(xs + cut(params.conv_x_b, 0, d_in).to(xs.dtype))
    bs = F.silu(bs + bb.to(bs.dtype))
    cs = F.silu(cs + bc.to(cs.dtype))
    Bm = bs.reshape(B, S, s.n_groups, s.d_state)
    Cm = cs.reshape(B, S, s.n_groups, s.d_state)

    new_cache = None
    if cache is not None:
        # decode: every channel on each rank, the whole recurrence
        xw = _whole(xs, 2, pctx).reshape(B, S, H, P)
        dtv = F.softplus(dt.float() + params.dt_bias)
        A = -torch.exp(params.A_log)
        y, h_new = ssd_decode_step(xw[:, 0], dtv[:, 0], A, Bm[:, 0],
                                   Cm[:, 0], whole["state"])
        y = (y[:, None] + params.D[:, None] * xw.float()).reshape(B, S,
                                                                  d_in)
        y = y.narrow(2, rank * n_ch, n_ch)
        new = {"conv_x": _whole(ncx, 2, pctx), "conv_b": ncb,
               "conv_c": ncc, "state": h_new}
        for name, t in new.items():
            cache[name].copy_(_keep(t, dims[name], pctx))
        new_cache = cache
    else:
        if split:
            xin = xs.reshape(B, S, H // tp, P)
            dtv = F.softplus(dt.float() + cut(params.dt_bias, 0, H))
            A = -torch.exp(cut(params.A_log, 0, H))
            D = cut(params.D, 0, H)
        else:
            xin = pctx.gather(xs, 2).reshape(B, S, H, P)
            dtv = F.softplus(dt.float() + params.dt_bias)
            A = -torch.exp(params.A_log)
            D = params.D
        if lengths is not None:
            dtv = torch.where(token_mask[:, :, None], dtv, 0.0)
        if pctx is None:
            y, h_final = ops.ssd(xin.contiguous(), dtv.contiguous(), A,
                                 Bm.contiguous(), Cm.contiguous(),
                                 chunk=s.chunk, impl=impl)
        else:
            y, h_final = ssd_sharded(xin, dtv, A, Bm, Cm, chunk=s.chunk,
                                     pctx=pctx, heads=H, impl=impl)
        y = y + D[:, None] * xin.float()
        y = y.reshape(B, S, -1)
        if not split:
            y = pctx.split(y, 2)
        if build_cache:
            state = _whole(h_final, 1, pctx) if split else h_final
            new = {"conv_x": _whole(ncx, 2, pctx), "conv_b": ncb,
                   "conv_c": ncc, "state": state}
            new_cache = {n: _keep(t, dims[n], pctx) for n, t in new.items()}

    # the gated RMSNorm over all of d_in: under a tp axis its squares are
    # summed over the axis (d_in is split)
    y = layers.apply_norm(
        {"scale": cut(params.norm.scale, 0, d_in)}, y.to(cd) * F.silu(z),
        "rmsnorm", cfg.norm_eps,
        psum=pctx.psum if pctx is not None else None, width=d_in)
    out = y.to(cd) @ cut(params.out_proj, 0, d_in).to(cd)
    return (out if pctx is None else pctx.reduce(out)), new_cache


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
