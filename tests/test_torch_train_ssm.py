"""Port vs reference: training mamba2-780m -- its SSM blocks through
``SSDFn`` (the SSD forward, then the hand-written SSD backward).

The same numpy inputs (made from a seed) go through the JAX function and its
``repro_torch`` counterpart, everything on the CPU in fp32; on CPU tensors
the kernel wrappers run their plain versions (``ssd_plain`` forward,
``ssd_bwd_plain`` backward), so ``impl="kernel"`` exercises the
differentiable Function.  ``ssd_bwd_plain`` is written out, not autograd:
it is held to torch autograd of ``ssd_plain`` and to ``jax.vjp`` of the
reference's ``ssd_chunked``, and the CUDA kernel's five launches are walked
here in plain PyTorch at its 64-step chunks.  Tolerances are stated per test
with their reason.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import PolicyConfig as RefPolicy
from repro.models import lm as ref_lm
from repro.models import ssm as ref_ssm
from repro.optim import adamw as ref_adamw
from repro.train import trainer as ref_trainer

from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import PolicyConfig, ShapeConfig
from repro_torch.data import make_batch
from repro_torch.kernels import ops
from repro_torch.kernels.ssd import (SSDFn, ssd, ssd_bwd, ssd_bwd_plain,
                                     ssd_plain)
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import LM
from repro_torch.models.ssm import SSM
from repro_torch.optim import AdamWConfig
from repro_torch.train import trainer

ARCH = "mamba2-780m"
# S = 96: three of the reduced config's 32-step chunks
SHAPE = ShapeConfig("t", 96, 2, "train")
POLICY = PolicyConfig(compute_dtype="float32", remat="block",
                      attn_impl="kernel", zero_stage=0)
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")
KC = 64         # the kernel's chunk length (csrc SSD_C)


def _inputs(B, S, H, P, G, N, seed=0):
    """The model's init ranges (small dt, A in [-16, -1]: the state
    carries across chunks), dy, dh_final and h0."""
    r = np.random.RandomState(seed)
    x = r.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((B, S, H)) - 2.0)).astype(
        np.float32)
    A = (-(1.0 + 15.0 * r.rand(H))).astype(np.float32)
    Bm, Cm = ((r.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
              for _ in range(2))
    dy = r.standard_normal((B, S, H, P)).astype(np.float32)
    dh, h0 = (r.standard_normal((B, H, N, P)).astype(np.float32)
              for _ in range(2))
    return (x, dt, A, Bm, Cm), dy, dh, h0


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in arrays]


def _close_rel(got, want, tol, what):
    """Within ``tol`` of the largest |want|."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0,
                               err_msg=what)


# ---------------------------------------------------------------------------
# (1) the analytical backward against two independent gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("S", [64, 100])
def test_ssd_bwd_plain_matches_autograd_and_jax_vjp(S, G, with_h0, with_dh):
    """ssd_bwd_plain (32-step chunks, as the reduced config's) against torch
    autograd of ssd_plain and jax.vjp of the reference's ssd_chunked, at S
    a whole and a ragged number of chunks, G = 1 and 2, with and without h0
    and a gradient of h_final: within 5e-4 of each gradient's max-abs, the
    reference's gradient tolerance (``tests/test_kernels_bwd.py``)."""
    B, H, P, N = 2, 4, 8, 16
    ins, dy, dh, h0 = _inputs(B, S, H, P, G, N, seed=S + G)
    dh = dh if with_dh else None
    h0 = h0 if with_h0 else None
    got = ssd_bwd_plain(*_t(*ins, dy), dh_final=_t(dh)[0], h0=_t(h0)[0],
                        chunk=32)
    assert (got[5] is None) == (h0 is None)

    leaves = [t.requires_grad_() for t in _t(*ins, *([h0] if with_h0
                                                    else []))]
    y, h = ssd_plain(*leaves[:5], chunk=32,
                     h0=leaves[5] if with_h0 else None)
    loss = (y * torch.from_numpy(dy)).sum()
    if with_dh:
        loss = loss + (h * torch.from_numpy(dh)).sum()
    auto = torch.autograd.grad(loss, leaves)

    jargs = [jnp.asarray(a) for a in ins + ((h0,) if with_h0 else ())]

    def f(*a):
        return ref_ssm.ssd_chunked(*a[:5], chunk=32,
                                   h0=a[5] if with_h0 else None)
    (_, hf), vjp = jax.vjp(f, *jargs)
    ct_h = jnp.asarray(dh) if with_dh else jnp.zeros_like(hf)
    ref = vjp((jnp.asarray(dy), ct_h))
    for source, want in (("autograd of ssd_plain", auto),
                         ("jax.vjp of ssd_chunked", ref)):
        for name, a, b in zip(NAMES, got, want):
            _close_rel(a.numpy(), np.asarray(b), 5e-4, f"{name} vs {source}")


# ---------------------------------------------------------------------------
# (2) the kernel's five launches, walked in plain PyTorch
# ---------------------------------------------------------------------------
def ssd_bwd_kernel_stages(x, dt, A, Bm, Cm, dy, *, dh_final=None, h0=None,
                          c=KC):
    """``repro_ssd_bwd`` as ``csrc/ssd.cu`` arranges it, fp32: the forward's
    chunk states first (what ``repro_ssd_fwd`` leaves in ``states``), then
    (a') u_c = sum_l exp(acum_l) C_l dy_l^T per chunk; (b') the reverse
    pass overwriting u_c with G_c, the gradient of the state leaving chunk
    c, from dh_final; (c') per (chunk, head) dx, ddt and the per-head dB /
    dC partials from W, K, E = V dt (where the clip passes), V and the row
    sums the kernel keeps (rowE, colE, colV, z, the inter-chunk terms),
    this chunk's share of dA; (d') the partials summed over each group's
    heads and dA over (batch, chunk).  Positions past S act as dt = 0."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    nc = -(-S // c)
    pad = nc * c - S
    f = torch.nn.functional.pad
    xc = f(x, (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, c, H, P)
    dyc = f(dy, (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, c, H, P)
    dtc = f(dt, (0, 0, 0, pad)).reshape(Bsz, nc, c, H)
    Bc = f(Bm, (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, c, G, N)
    Cc = f(Cm, (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, c, G, N)
    acum = torch.cumsum(dtc * A, dim=2)
    aend = acum[:, :, -1]
    # the forward's states: the state entering each chunk
    w = dtc * torch.exp(torch.clamp(aend[:, :, None] - acum, min=-60.0))
    local = torch.einsum("bjmhn,bjmhp->bjhnp",
                         Bc.repeat_interleave(hpg, 3) * w[..., None], xc)
    h = torch.zeros((Bsz, H, N, P)) if h0 is None else h0
    states = []
    for j in range(nc):
        states.append(h)
        h = torch.exp(aend[:, j])[..., None, None] * h + local[:, j]
    states = torch.stack(states, 1)
    # (a')
    gstates = torch.einsum(
        "bjlhn,bjlhp->bjhnp",
        Cc.repeat_interleave(hpg, 3) * torch.exp(acum)[..., None], dyc)
    # (b')
    g = torch.zeros((Bsz, H, N, P)) if dh_final is None else dh_final
    gs = [None] * nc
    for j in reversed(range(nc)):
        gs[j] = g
        g = torch.exp(aend[:, j])[..., None, None] * g + gstates[:, j]
    gstates = torch.stack(gs, 1)
    dh0 = None if h0 is None else g
    # (c')
    dx = torch.zeros((Bsz, nc, c, H, P))
    ddt = torch.zeros((Bsz, nc, c, H))
    dB_part = torch.zeros((Bsz, nc, c, H, N))
    dC_part = torch.zeros((Bsz, nc, c, H, N))
    dA_part = torch.zeros((Bsz, nc, H))
    lower = torch.ones((c, c), dtype=torch.bool).tril()
    for b in range(Bsz):
        for j in range(nc):
            for hh in range(H):
                gg = hh // hpg
                X, DY = xc[b, j, :, hh], dyc[b, j, :, hh]
                Bs, Cs = Bc[b, j, :, gg], Cc[b, j, :, gg]
                dts, acs = dtc[b, j, :, hh], acum[b, j, :, hh]
                Hs, Gs = states[b, j, hh], gstates[b, j, hh]
                a_end = acs[-1]
                d = acs[:, None] - acs[None, :]
                D = torch.exp(torch.clamp(d, -60.0, 0.0))
                CB, Q = Cs @ Bs.T, DY @ X.T
                V = torch.where(lower, CB * D * Q, 0.0)
                W = torch.where(lower, CB * D * dts[None], 0.0)
                K = torch.where(lower, Q * D * dts[None], 0.0)
                E = torch.where(lower & (d >= -60.0) & (d <= 0.0),
                                V * dts[None], 0.0)
                rowE, colE, colV = E.sum(1), E.sum(0), V.sum(0)
                rest = a_end - acs
                dtR = dts * torch.exp(torch.clamp(rest, min=-60.0))
                dx[b, j, :, hh] = W.T @ DY + dtR[:, None] * (Bs @ Gs)
                XG, DH = X @ Gs.T, DY @ Hs.T
                dB_part[b, j, :, hh] = K.T @ Cs + dtR[:, None] * XG
                dC_part[b, j, :, hh] = K @ Bs + \
                    torch.exp(acs)[:, None] * DH
                z = torch.exp(torch.clamp(rest, min=-60.0)) * \
                    (Bs * XG).sum(1)
                s = torch.where(rest >= -60.0, dts * z, 0.0)
                gac = rowE - colE + torch.exp(acs) * (Cs * DH).sum(1) - s
                gac[-1] += torch.exp(a_end) * (Gs * Hs).sum() + s.sum()
                ga = torch.flip(torch.cumsum(torch.flip(gac, [0]), 0), [0])
                ddt[b, j, :, hh] = A[hh] * ga + colV + z
                dA_part[b, j, hh] = (dts * ga).sum()
    # (d')
    dB = dB_part.reshape(Bsz, nc, c, G, hpg, N).sum(4)
    dC = dC_part.reshape(Bsz, nc, c, G, hpg, N).sum(4)
    dA = dA_part.reshape(-1, H).sum(0)
    return (dx.reshape(Bsz, nc * c, H, P)[:, :S],
            ddt.reshape(Bsz, nc * c, H)[:, :S], dA,
            dB.reshape(Bsz, nc * c, G, N)[:, :S],
            dC.reshape(Bsz, nc * c, G, N)[:, :S], dh0)


STAGE_CASES = [
    # B, S, H, G, h0, dh_final
    (1, 100, 2, 1, False, False),       # ragged last chunk
    (1, 40, 2, 2, True, True),          # S shorter than one chunk, G = 2
    (2, 192, 4, 2, True, False),        # three whole chunks, B = 2
    (2, 130, 3, 1, False, True),        # three heads in one group
]


@pytest.mark.parametrize("B,S,H,G,with_h0,with_dh", STAGE_CASES)
def test_kernel_stages_match_the_plain_backward(B, S, H, G, with_h0,
                                                 with_dh):
    """The five launches' arithmetic at the kernel's 64-step chunks against
    ssd_bwd_plain at its 256-step chunks: 1e-5 of each gradient's max-abs
    (fp32; the chunk length changes only the order of summation here, as
    no decay reaches the -60 clip), dA at 1e-4: it sums dt * ga over every
    step, and ga's terms cancel -- held to an fp64 run, the plain version's
    dA is off by up to 3.5e-5 of its max-abs at these cases."""
    ins, dy, dh, h0 = _inputs(B, S, H, 8, G, 16, seed=B * S)
    dh = _t(dh)[0] if with_dh else None
    h0 = _t(h0)[0] if with_h0 else None
    got = ssd_bwd_kernel_stages(*_t(*ins, dy), dh_final=dh, h0=h0)
    want = ssd_bwd_plain(*_t(*ins, dy), dh_final=dh, h0=h0)
    for name, a, b in zip(NAMES, got, want):
        if b is None:
            assert a is None
            continue
        _close_rel(a.numpy(), b.numpy(), 1e-4 if name == "dA" else 1e-5,
                   name)


def _split(t, lo=True):
    """t ~ hi + lo, each rounded to bf16 (16 significant bits of t's 24);
    ``lo=False`` drops the lo half."""
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float() if lo else torch.zeros_like(t)


def ssd_bwd_tc_walk(x, dt, A, Bm, Cm, dy, *, dh_final=None, h0=None,
                    k=None, c=KC, lo=True):
    """The tensor-core design of ``repro_ssd_bwd`` (bf16 x, B, C) as
    ``csrc/ssd.cu`` arranges it, fp32 einsums on bf16-valued operands:
    every fp32 operand of a product split into bf16 hi + lo (``_split``),
    a product with one fp32 operand as two products, with two as three (hi
    hi, hi lo, lo hi).  (a') u_c = C^T (exp(acum) dy), the scaled dy split;
    (b') the reverse pass in fp32; (c') one block per (slice of ``k`` heads
    of a group, chunk, batch row): the group's B C^T once, then each head
    in order -- the (m, l) products x dy^T, W^T = (B C^T) D dt and K^T
    (split), V and E in fp32 with their row and column sums; dx = W^T dy +
    dt R (B G_c), z = R rowdot(x, B G_c); the slice's running dB += K^T C
    + dt R (x G_c^T) and dC += K B + exp(acum) (dy h_c^T), gi = rowdot(C,
    dy h_c^T), <G_c, h_c> in fp32, ddt and the chunk's share of dA;
    (d') the slices' partials summed in order, dA over (batch, chunk).
    Returns fp32 (dx, ddt, dA, dB, dC, dh0) before the kernel's cast of
    dx, dB, dC to bf16.  ``lo=False`` drops every lo half."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    k = hpg if k is None else k
    nsl = hpg // k
    nc = -(-S // c)
    pad = nc * c - S
    f = torch.nn.functional.pad
    xc = f(x, (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, c, H, P)
    dyc = f(dy, (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, c, H, P)
    dtc = f(dt, (0, 0, 0, pad)).reshape(Bsz, nc, c, H)
    Bc = f(Bm, (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, c, G, N)
    Cc = f(Cm, (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, c, G, N)
    acum = torch.cumsum(dtc * A, dim=2)
    aend = acum[:, :, -1]
    w = dtc * torch.exp(torch.clamp(aend[:, :, None] - acum, min=-60.0))
    local = torch.einsum("bjmhn,bjmhp->bjhnp",
                         Bc.repeat_interleave(hpg, 3) * w[..., None], xc)
    h = torch.zeros((Bsz, H, N, P)) if h0 is None else h0
    states = []
    for j in range(nc):
        states.append(h)
        h = torch.exp(aend[:, j])[..., None, None] * h + local[:, j]
    states = torch.stack(states, 1)
    # (a')
    eh, el = _split(torch.exp(acum)[..., None] * dyc, lo)
    Ch = Cc.repeat_interleave(hpg, 3)
    gstates = torch.einsum("bjlhn,bjlhp->bjhnp", Ch, eh) + \
        torch.einsum("bjlhn,bjlhp->bjhnp", Ch, el)
    # (b')
    g = torch.zeros((Bsz, H, N, P)) if dh_final is None else dh_final
    gs = [None] * nc
    for j in reversed(range(nc)):
        gs[j] = g
        g = torch.exp(aend[:, j])[..., None, None] * g + gstates[:, j]
    gstates = torch.stack(gs, 1)
    dh0 = None if h0 is None else g
    # (c')
    dx = torch.zeros((Bsz, nc, c, H, P))
    ddt = torch.zeros((Bsz, nc, c, H))
    dB_part = torch.zeros((Bsz, nc, c, G, nsl, N))
    dC_part = torch.zeros((Bsz, nc, c, G, nsl, N))
    dA_part = torch.zeros((Bsz, nc, H))
    upper = torch.ones((c, c), dtype=torch.bool).triu()     # (m, l): l >= m
    for b in range(Bsz):
        for j in range(nc):
            for gg in range(G):
                Bs, Cs = Bc[b, j, :, gg], Cc[b, j, :, gg]
                CBt = Bs @ Cs.T                             # (m, l)
                for sl in range(nsl):
                    dB_run = torch.zeros((c, N))
                    dC_run = torch.zeros((c, N))
                    for hh in range(gg * hpg + sl * k,
                                    gg * hpg + (sl + 1) * k):
                        X, DY = xc[b, j, :, hh], dyc[b, j, :, hh]
                        dts, acs = dtc[b, j, :, hh], acum[b, j, :, hh]
                        Gh, Gl = _split(gstates[b, j, hh], lo)
                        Hh, Hl = _split(states[b, j, hh], lo)
                        Dh, Dl = _split(DY, lo)
                        d = acs[None, :] - acs[:, None]     # acum_l - acum_m
                        D = torch.exp(torch.clamp(d, -60.0, 0.0))
                        Qt = X @ Dh.T + X @ Dl.T            # (m, l)
                        Wt = torch.where(upper, CBt * D * dts[:, None], 0.0)
                        Kt = torch.where(upper, Qt * D * dts[:, None], 0.0)
                        V = torch.where(upper, CBt * D * Qt, 0.0)
                        E = torch.where(upper & (d >= -60.0) & (d <= 0.0),
                                        V * dts[:, None], 0.0)
                        colV, colE, rowE = V.sum(1), E.sum(1), E.sum(0)
                        Wh, Wl = _split(Wt, lo)
                        Kh, Kl = _split(Kt, lo)
                        rest = acs[-1] - acs
                        R = torch.exp(torch.clamp(rest, min=-60.0))
                        st = Bs @ Gh + Bs @ Gl              # (m, p)
                        dx[b, j, :, hh] = Wh @ Dh + Wh @ Dl + Wl @ Dh + \
                            (dts * R)[:, None] * st
                        z = R * (X * st).sum(1)
                        XG = X @ Gh.T + X @ Gl.T            # (m, n)
                        dB_run += Kh @ Cs + Kl @ Cs + (dts * R)[:, None] * XG
                        DH = Dh @ Hh.T + Dh @ Hl.T + Dl @ Hh.T  # (l, n)
                        e = torch.exp(acs)
                        dC_run += Kh.T @ Bs + Kl.T @ Bs + e[:, None] * DH
                        gi = (Cs * DH).sum(1)
                        gh = (gstates[b, j, hh] * states[b, j, hh]).sum()
                        s = torch.where(rest >= -60.0, dts * z, 0.0)
                        gac = rowE - colE + e * gi - s
                        gac[-1] += torch.exp(acs[-1]) * gh + s.sum()
                        ga = torch.flip(torch.cumsum(torch.flip(gac, [0]), 0),
                                        [0])
                        ddt[b, j, :, hh] = A[hh] * ga + colV + z
                        dA_part[b, j, hh] = (dts * ga).sum()
                    dB_part[b, j, :, gg, sl] = dB_run
                    dC_part[b, j, :, gg, sl] = dC_run
    # (d')
    dB, dC = dB_part.sum(4), dC_part.sum(4)
    dA = dA_part.reshape(-1, H).sum(0)
    return (dx.reshape(Bsz, nc * c, H, P)[:, :S],
            ddt.reshape(Bsz, nc * c, H)[:, :S], dA,
            dB.reshape(Bsz, nc * c, G, N)[:, :S],
            dC.reshape(Bsz, nc * c, G, N)[:, :S], dh0)


# dx, dB, dC leave the tensor-core design in bf16: its rounding (half a
# unit in the last of 8 significant bits, 2^-9 of an element) bounds them,
# twice that of the largest element; ddt, dA, dh0 stay fp32, at SSD_TOL of
# chip_smoke.py (2e-4): other summation orders, the split's 2^-17
TC_TOL = {"dx": 2 ** -8, "dB": 2 ** -8, "dC": 2 ** -8, "ddt": 2e-4,
          "dA": 2e-4, "dh0": 2e-4}
# STAGE_CASES at the reference's widths (P = N = 16, bf16 x, B, C), the
# group's heads in one slice, and one case of two slices (k = 2 of 4)
TC_CASES = [case + (None,) for case in STAGE_CASES] + \
    [(2, 192, 4, 1, True, True, 2)]


def _tc_case(B, S, H, G, with_h0, with_dh, seed):
    ins, dy, dh, h0 = _inputs(B, S, H, 16, G, 16, seed=seed)
    x, dt, A, Bm, Cm = _t(*ins)
    x, Bm, Cm = (t.bfloat16().float() for t in (x, Bm, Cm))
    return ((x, dt, A, Bm, Cm), torch.from_numpy(dy),
            _t(dh)[0] if with_dh else None, _t(h0)[0] if with_h0 else None)


def _tc_errors(got, want):
    """Each output's error over its largest |want|, dx / dB / dC rounded
    to bf16 as the kernel writes them."""
    out = {}
    for name, a, b in zip(NAMES, got, want):
        if b is None:
            assert a is None
            continue
        if name in ("dx", "dB", "dC"):
            a = a.bfloat16().float()
        out[name] = float((a - b).abs().max() / b.abs().max())
    return out


@pytest.mark.parametrize("B,S,H,G,with_h0,with_dh,k", TC_CASES)
def test_tc_walk_matches_the_plain_backward(B, S, H, G, with_h0, with_dh,
                                            k):
    """The tensor-core design's arithmetic (split operands, k-head slices,
    the group's B C^T once) against ssd_bwd_plain on the same bf16-valued
    inputs, within TC_TOL of each output's max-abs; in the first case also
    against jax.vjp of the reference's ssd_chunked at 5e-4 (the gradient
    tolerance of ``tests/test_kernels_bwd.py``), before the bf16 cast."""
    ins, dy, dh, h0 = _tc_case(B, S, H, G, with_h0, with_dh, seed=B * S + H)
    got = ssd_bwd_tc_walk(*ins, dy, dh_final=dh, h0=h0, k=k)
    want = ssd_bwd_plain(*ins, dy, dh_final=dh, h0=h0)
    errs = _tc_errors(got, want)
    assert all(v <= TC_TOL[n] for n, v in errs.items()), errs
    if (B, S, H, G) != TC_CASES[0][:4]:
        return

    def f(*a):
        return ref_ssm.ssd_chunked(*a, chunk=32)
    (_, hf), vjp = jax.vjp(f, *(jnp.asarray(t.numpy()) for t in ins))
    ref = vjp((jnp.asarray(dy.numpy()), jnp.zeros_like(hf)))
    for name, a, b in zip(NAMES, got, ref):
        _close_rel(a.numpy(), np.asarray(b), 5e-4, f"{name} vs jax.vjp")


def test_tc_walk_without_lo_halves_fails_the_comparison():
    """The same walk with every lo half dropped (the fp32 operands in bf16
    alone) fails the comparison above: it can tell the split from plain
    bf16."""
    B, S, H, G, with_h0, with_dh, k = TC_CASES[-1]
    ins, dy, dh, h0 = _tc_case(B, S, H, G, with_h0, with_dh, seed=7)
    want = ssd_bwd_plain(*ins, dy, dh_final=dh, h0=h0)
    split = _tc_errors(ssd_bwd_tc_walk(*ins, dy, dh_final=dh, h0=h0, k=k),
                       want)
    hi_only = _tc_errors(ssd_bwd_tc_walk(*ins, dy, dh_final=dh, h0=h0, k=k,
                                         lo=False), want)
    assert all(v <= TC_TOL[n] for n, v in split.items()), split
    assert any(v > TC_TOL[n] for n, v in hi_only.items()), hi_only


def test_kernel_stages_see_a_zeroed_carry():
    """The stage walk with the reverse pass's carry into the first chunk
    zeroed (its gradient computed from dh_final alone) is rejected by the
    same comparison: the test can see a lost carry."""
    ins, dy, _, _ = _inputs(1, 128, 2, 8, 1, 16, seed=9)
    x, dt, A, Bm, Cm = _t(*ins)
    dy = torch.from_numpy(dy)
    want = ssd_bwd_plain(x, dt, A, Bm, Cm, dy)
    head = ssd_bwd_kernel_stages(x[:, :KC], dt[:, :KC], A, Bm[:, :KC],
                                 Cm[:, :KC], dy[:, :KC])
    worst = max(float((a - b[:, :KC]).abs().max() / b.abs().max())
                for a, b in zip((head[0], head[3]), (want[0], want[3])))
    assert worst > 1e-2


# ---------------------------------------------------------------------------
# (3) the wrapper and SSDFn on CPU tensors
# ---------------------------------------------------------------------------
def test_ssd_fn_through_ops_runs_the_plain_versions_on_cpu():
    ins, dy, dh, h0 = _inputs(2, 100, 4, 8, 2, 16, seed=4)
    x, dt, A, Bm, Cm = _t(*ins)
    dy, dh, h0 = _t(dy, dh, h0)
    before = dict(ops.launch_counts())
    # the wrapper: the plain backward, outputs in the inputs' dtypes
    got = ssd_bwd(x, dt, A, Bm, Cm, dy, dh_final=dh, h0=h0, chunk=32)
    want = ssd_bwd_plain(x, dt, A, Bm, Cm, dy, dh_final=dh, h0=h0, chunk=32)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    half = [t.to(torch.bfloat16) for t in (x, Bm, Cm)]
    got16 = ssd_bwd(half[0], dt, A, half[1], half[2], dy)
    assert [t.dtype for t in got16[:5]] == [torch.bfloat16, torch.float32,
                                            torch.float32, torch.bfloat16,
                                            torch.bfloat16]
    assert got16[5] is None
    assert ssd(x, dt, A, Bm, Cm, keep_states=True)[2:] == (None, None)
    with pytest.raises(ValueError):
        ssd_bwd(x, dt, A, Bm, Cm, dy[:, :5])
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_bwd(*(t.to("meta") for t in (x, dt, A, Bm, Cm, dy)))
    # ops.ssd takes SSDFn where autograd needs a gradient, and SSDFn's
    # gradients are the wrapper's
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, h = ops.ssd(*leaves, chunk=32)
    assert type(y.grad_fn).__name__ == "SSDFnBackward"
    assert ops.ssd(x, dt, A, Bm, Cm).__class__ is tuple
    assert ops.ssd(x, dt, A, Bm, Cm)[0].grad_fn is None
    grads = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), leaves)
    want = ssd_bwd_plain(x, dt, A, Bm, Cm, dy, dh_final=dh, chunk=32)
    for name, a, b in zip(NAMES, grads, want):
        assert torch.equal(a, b), name
    # h_final unused: its gradient arrives as None and the pass starts at 0
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    grads = torch.autograd.grad((ops.ssd(*leaves, chunk=32)[0] * dy).sum(),
                                leaves)
    want = ssd_bwd_plain(x, dt, A, Bm, Cm, dy, chunk=32)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    # h0 through SSDFn itself
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, h0)]
    y, _ = SSDFn.apply(*leaves, 32)
    grads = torch.autograd.grad((y * dy).sum(), leaves)
    want = ssd_bwd_plain(x, dt, A, Bm, Cm, dy, h0=h0, chunk=32)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    assert ops.launch_counts() == before        # CPU: nothing launched
    assert "ssd_bwd" in ops.launch_counts()


def test_fp32_leaves_get_fp32_gradients_under_a_bf16_model():
    """A_log, D and dt_bias stay fp32 in a bf16 model (as in the
    reference) and get fp32 gradients through SSDFn; the other leaves get
    gradients in their own dtype."""
    cfg = reduced(get_config(ARCH), n_layers=1)
    model = LM.init(cfg, seed=1, dtype=torch.bfloat16, device="cpu")
    policy = dataclasses.replace(POLICY, compute_dtype="bfloat16")
    loss, _ = trainer.make_loss_fn(cfg, policy)(
        model, trainer._device_batch(make_batch(cfg, SHAPE, step=0), "cpu"))
    loss.backward()
    ssm = next(m for m in model.modules() if isinstance(m, SSM))
    for name, p in ssm.named_parameters():
        want = torch.float32 if name in SSM.FP32_LEAVES else torch.bfloat16
        assert p.dtype == p.grad.dtype == want, name
        assert bool(torch.isfinite(p.grad.float()).all()), name
        assert bool(p.grad.abs().sum() > 0), name


# ---------------------------------------------------------------------------
# (4) one whole train step against the reference's jitted step
# ---------------------------------------------------------------------------
def numpy_params(ref_cfg, seed=0):
    """The reference's parameter tree with every leaf redrawn by numpy
    around its init (weights keep their spread, biases and norm scales move
    off their init); A_log stays where the init puts it."""
    tree = ref_lm.init_lm(jax.random.PRNGKey(0), ref_cfg)
    r = np.random.RandomState(seed)

    def redraw(a):
        a = np.asarray(a)
        std = float(a.std()) or 0.1
        return (float(a.mean())
                + r.standard_normal(a.shape) * std).astype(np.float32)

    return jax.tree.map(redraw, tree)


def _cfgs(n_layers):
    return (ref_reduced(ref_get_config(ARCH), n_layers=n_layers),
            reduced(get_config(ARCH), n_layers=n_layers))


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("n_layers", [1, 2])
def test_train_step_matches_the_reference_jitted_step(n_layers):
    """Reduced mamba2-780m, one SSM block (nothing stacked) and two (the
    reference stacks them), fp32, remat per block, clip active, from the
    same weights and batch: the reference's jitted step (XLA's gradient of
    its chunked scan) against the port's through SSDFn.

    Tolerances, those of the llama3.2-3b and recurrentgemma-2b step tests:
    loss and grad norm 1e-5 relative; gradients 1e-5 of each leaf's max-abs
    (fp32, different reduction orders: the reference differentiates its
    scan, the port runs the written-out backward).  Updated parameters 1e-6
    where |g| > 1e-6, else |difference| <= 2 lr.  1-D leaves of a stacked
    segment -- the norm scales, A_log, D, dt_bias and the conv biases -- are
    (repeats, W) in the reference, which decays them (ndim >= 2); the
    port's are 1-D and, by the same rule on its own tensors, are not: there
    the port's value is the reference's plus lr * weight_decay * old value
    (ROADMAP queue C)."""
    ref_cfg, cfg = _cfgs(n_layers)
    params = numpy_params(ref_cfg, seed=5)
    batch = make_batch(cfg, SHAPE, step=2)
    lr, wd = 1e-3, 0.1
    ref_policy = RefPolicy(compute_dtype="float32", remat="block",
                           attn_impl="xla", zero_stage=0)
    ref_opt = ref_adamw.AdamWConfig(lr=lr, weight_decay=wd)
    jp = jax.tree.map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_state = ref_trainer.TrainState(jp, ref_adamw.init(jp, ref_opt))
    wstate, wm = jax.jit(ref_trainer.make_train_step(
        ref_cfg, ref_policy, ref_opt))(ref_state, jb)
    wgrads = jax.jit(jax.grad(lambda p: ref_trainer.make_loss_fn(
        ref_cfg, ref_policy)(p, jb)[0]))(jp)

    model = convert.from_reference(params, cfg, device="cpu")
    old = convert.to_reference(model)
    dims = _flat(convert.to_reference(
        model, leaf=lambda p: torch.tensor(float(p.dim()))))
    state = trainer.TrainState.create(model, POLICY,
                                      AdamWConfig(lr=lr, weight_decay=wd))
    before = dict(ops.launch_counts())
    state, m = trainer.make_train_step(
        cfg, POLICY, AdamWConfig(lr=lr, weight_decay=wd))(state, batch)
    assert ops.launch_counts() == before        # CPU: the plain versions ran

    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(wm["grad_norm"]),
                               rtol=1e-5)
    assert float(m["grad_norm"]) > 1.0                  # the clip is active
    g_port = _flat(convert.to_reference(model, leaf=lambda p: p.grad))
    g_ref = _flat(wgrads)
    p_port, p_ref, p_old = (_flat(convert.to_reference(model)),
                            _flat(wstate.params), _flat(old))
    assert sorted(g_port) == sorted(g_ref) == sorted(p_ref)
    assert any("A_log" in k for k in g_ref)
    stacked_1d = {k for k in p_ref if p_ref[k].ndim >= 2 and
                  np.all(dims[k] == 1)}
    assert bool(stacked_1d) == (n_layers == 2)
    if n_layers == 2:
        assert {k.split("'")[-2] for k in stacked_1d} == {
            "scale", "A_log", "D", "dt_bias", "conv_x_b", "conv_b_b",
            "conv_c_b"}
    for k in g_ref:
        scale = np.abs(g_ref[k]).max()
        np.testing.assert_allclose(g_port[k], g_ref[k], atol=1e-5 * scale,
                                   rtol=0, err_msg=k)
        want = p_ref[k]
        if k in stacked_1d:
            want = want + lr * wd * p_old[k]
        sure = np.abs(g_ref[k]) > 1e-6
        np.testing.assert_allclose(p_port[k][sure], want[sure], atol=1e-6,
                                   rtol=1e-6, err_msg=k)
        assert np.all(np.abs(p_port[k] - want) <= 2 * lr + 1e-6), k


# ---------------------------------------------------------------------------
# (5) activation checkpointing
# ---------------------------------------------------------------------------
def test_remat_leaves_loss_and_gradients_unchanged():
    """remat="block" recomputes each block's forward in the backward pass
    (torch.utils.checkpoint; SSDFn's saved tensors are dropped and made
    again): on the CPU the recompute runs the same operations on the same
    values, so the loss and every gradient are exactly those of
    remat="none"."""
    ref_cfg, cfg = _cfgs(2)
    params = numpy_params(ref_cfg, seed=6)
    batch = make_batch(cfg, SHAPE, step=1)
    out = {}
    for remat in ("none", "block"):
        model = convert.from_reference(params, cfg, device="cpu")
        policy = dataclasses.replace(POLICY, remat=remat)
        grads, loss, _ = trainer._accum_grads(
            trainer.make_loss_fn(cfg, policy), model,
            trainer._device_batch(batch, "cpu"), 1)
        out[remat] = (float(loss), grads)
    assert out["none"][0] == out["block"][0]
    for n, g in out["none"][1].items():
        assert torch.equal(g, out["block"][1][n]), n


# ---------------------------------------------------------------------------
# (6) the launcher
# ---------------------------------------------------------------------------
def test_launch_train_runs_mamba2_on_cpu(capsys):
    rc = launch_train.main(["--device", "cpu", "--arch", ARCH, "--reduced",
                            "--steps", "2", "--batch", "2", "--seq", "96",
                            "--log-every", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "training mamba2-780m-reduced" in out
    losses = [float(line.split("loss")[1].split()[0])
              for line in out.splitlines() if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
