"""The tile walks of the warpgroup attention kernels, on the CPU.

``flash_fwd_wgmma_kernel`` walks, for each block of BM query positions of one
head, the key tiles ``flash_attention.live_key_tiles`` gives;
``flash_bwd_dkv_wgmma_kernel`` walks, for each block of BN keys of one KV
head, the query tiles ``flash_attention_bwd.live_query_tiles`` gives, once
per head of the group; ``flash_bwd_dq_wgmma_kernel`` walks, for each block of
BM query positions of one head, the 64-key tiles of ``live_key_tiles``.  The
``.cu`` sources compute the same bounds (``csrc/hopper.cuh``).  Here plain
PyTorch versions walk exactly those tiles -- an online-softmax forward, a
dK/dV that sums over the group, a dQ -- and are held to the port's plain
versions in fp32 at 1e-5 (summation order only) and to the reference's
oracle (``repro.kernels.ref.attention_ref`` and ``jax.grad`` of it) at the
reference's 5e-4, so a bound that drops a live tile fails here before any
time on the card.  At stablelm-12b's D = 160 the forward walks 128-key tiles,
dK/dV 32-query tiles and dQ 64-key tiles (``D160_CASES``); at
recurrentgemma-2b's D = 256 the forward walks 64-key tiles, dQ 48-key tiles,
and dK/dV work items of 64 keys and one slice of the group's heads
(``flash_attention_bwd.dkv_d256_slices``), each walking 64-query tiles with
S^T and dP^T computed once a pair and split by the two warpgroups' 128
columns, the slices' partials summed in slice order (``D256_CASES``: MQA
with G = 10, a window, ragged S).  Each
walks with plain products or on the kernels' column panels: the bf16
warpgroup kernels keep a head's D columns in shared memory as panels of
``panel_cols(D)`` columns, the layout the TMA writes (``csrc/hopper.cuh``):
64 at D = 64, 128 and 256, five of 32 at D = 160.  The score products (S = Q K^T, dP = dO V^T; S^T = K Q^T and
dP^T = V dO^T) walk D / 16 k-steps of 16 columns, PW / 16 a panel; the
products with an MN-major operand (O += P V, dV += P^T dO, dK += dS^T Q,
dQ += dS K) take column n of their result from panel n // PW (at D = 160
one m64n160k16 whose descriptor's LBO steps from panel to panel).  A walk
that leaves the tail panel out -- columns 128-159 at D = 160, as a split of
160 columns into 64-column panels would; columns 192-255 at D = 256 -- must
fail the comparison that the whole walk passes, and so must a D = 256
backward walk with one warpgroup's column half left out (columns 128-255
of dk, dv and dq), or with one head slice's partial dropped or counted
twice.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import attention_ref as ref_attention_ref

from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels.flash_attention import (NEG_INF, attention_plain,
                                                 live_key_tiles)
from repro_torch.kernels.flash_attention_bwd import live_query_tiles

BN = 128        # keys per tile (forward) and per block (dK/dV)
DQ_BN = 64      # keys per tile of the dQ kernel (csrc DQ_BN)

CASES = [
    # B, S, T, H, K, D, causal, window, softcap
    (1, 300, 300, 4, 2, 32, True, 0, 0.0),        # causal, several tiles
    (2, 260, 260, 6, 2, 32, True, 50, 0.0),       # window 50, GQA G = 3
    (1, 100, 77, 6, 2, 32, True, 0, 0.0),         # ragged S = 100, T = 77
    (1, 96, 200, 4, 4, 32, False, 0, 0.0),        # S != T, bidirectional
    (1, 96, 300, 6, 1, 32, False, 0, 0.0),        # MQA G = 6, S != T
    (1, 200, 200, 3, 1, 32, True, 0, 0.0),        # GQA G = 3
    (1, 180, 300, 6, 2, 32, True, 50, 30.0),      # soft-cap 30, window
]
# stablelm-12b's head dim: the warpgroup forward at BM = 128 with 128-key
# tiles, dK/dV at 32-query tiles of 128-key blocks
D160_CASES = [
    # B, S, T, H, K, D, causal, window, softcap
    (1, 300, 300, 4, 2, 160, True, 0, 0.0),       # causal, several tiles
    (1, 100, 77, 4, 1, 160, True, 0, 30.0),       # ragged, MQA, soft-cap
    (2, 130, 200, 4, 2, 160, False, 0, 0.0),      # S != T, bidirectional
    (1, 260, 260, 4, 2, 160, True, 50, 0.0),      # window 50
]
D160_DKV_BM = 32    # query positions per tile of the D = 160 dK/dV (csrc)
# recurrentgemma-2b's MQA heads: the warpgroup forward at BM = 128 with
# 64-key tiles (csrc FwdLayout<256>::BN) on four 64-column panels
D256_CASES = [
    # B, S, T, H, K, D, causal, window, softcap
    (1, 300, 300, 10, 1, 256, True, 50, 0.0),     # window 50, ragged S
    (1, 250, 250, 10, 1, 256, True, 50, 30.0),    # soft-cap 30
    (2, 140, 200, 10, 1, 256, True, 0, 0.0),      # B = 2, S != T
]
D256_BN = 64
# the D = 256 backward (csrc Dkv256Layout, Dq256Layout): dK/dV's keys a
# work item and query positions a pair, dQ's keys a tile
D256_DKV_BN, D256_DKV_BM, D256_DQ_BN = (fab.D256_DKV_BN, fab.D256_DKV_BM,
                                        fab.D256_DQ_BN)
# the same walks on llama's 64-column panels (D = 128) and at D = 64
PANEL64_CASES = [
    (1, 200, 200, 4, 2, 128, True, 0, 0.0),
    (1, 130, 100, 2, 1, 64, True, 40, 30.0),
]
KSTEP = 16      # columns of one k-step of a wgmma (bf16)
# Every query row of these cases sees at least one key.  A row that sees
# none has no agreed output: the oracle and the plain versions give the mean
# of all V (a uniform softmax over -1e30 scores), the reference's Pallas
# kernel and the port's kernels the mean of V over the tiles they walk, or
# zero where they walk none (ROADMAP queue C).


def _inputs(B, S, T, H, K, D, seed=11):
    r = np.random.RandomState(seed)
    return tuple(r.standard_normal(s).astype(np.float32) for s in
                 ((B, S, H, D), (B, T, K, D), (B, T, K, D), (B, S, H, D)))


def panel_cols(D: int) -> int:
    """Columns of one panel (``csrc/hopper.cuh`` ``kPanelCols``)."""
    return 64 if D % 64 == 0 else 32


def panels(x, pw):
    """(..., rows, D) -> (NP, ..., rows, pw): the panel layout."""
    assert x.shape[-1] % pw == 0
    return torch.stack(x.split(pw, dim=-1))


def kstep_product(a, b, pw=None, n_panels=None):
    """a (..., M, D) b (..., N, D) -> a b^T; with a panel width ``pw``, as
    the K-major products walk it: k-step ks = p * (pw / 16) + c reads
    columns c * 16 .. c * 16 + 15 of panel p, and the k-steps' products
    are summed; ``n_panels`` below NP leaves the tail out."""
    if pw is None:
        return a @ b.transpose(-1, -2)

    def ksteps(x):                  # (..., rows, n, pw / 16, 16)
        x = panels(x, pw)[:n_panels].movedim(0, -2)
        return x.unflatten(-1, (pw // KSTEP, KSTEP))
    return torch.einsum("...mpck,...npck->...mn", ksteps(a), ksteps(b))


def panel_product(a, b, pw=None, n_panels=None, first=0):
    """a (..., M, C) @ b (..., C, D); with a panel width ``pw``, b MN-major
    in panels: column n of the result from panel n // pw, column n % pw (as
    the wide instruction's LBO steps); only panels ``first`` to
    ``n_panels`` (exclusive) give columns, the others stay zero."""
    if pw is None:
        return a @ b
    wide = panels(b, pw)[first:n_panels].movedim(0, -2).flatten(-2)
    out = torch.zeros(a.shape[:-1] + (b.shape[-1],))
    out[..., first * pw:first * pw + wide.shape[-1]] = a @ wide
    return out


def _scores(qt, kt, scale, softcap, pw=None):
    s = kstep_product(qt, kt, pw) * scale
    return softcap * torch.tanh(s / softcap) if softcap > 0 else s


def _dead(qpos, kpos, S, T, causal, window):
    """(len(qpos), len(kpos)) bool: the pairs that the mask kills."""
    diff = qpos[:, None] - kpos[None, :]
    dead = (qpos[:, None] >= S) | (kpos[None, :] >= T)
    if causal:
        dead |= diff < 0
    if window > 0:
        dead |= diff >= window
    return dead


def forward_tile_walk(q, k, v, *, causal, window, softcap, BM, BN=BN,
                      pw=None, n_panels=None):
    """The warpgroup forward's walk in fp32: per head and block of BM
    positions, online softmax over the BN-key tiles of ``live_key_tiles``;
    the products on ``pw``-column panels where ``pw`` is given, the output's
    from the first ``n_panels`` only.  Returns (o, m, l) as
    ``attention_fwd_stats_plain`` does."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    o = torch.zeros_like(q)
    m_out = torch.zeros((B, S, H))
    l_out = torch.zeros((B, S, H))
    for h in range(H):
        for m0 in range(0, S, BM):
            rows = torch.arange(m0, min(m0 + BM, S))
            qt = q[:, rows, h]                          # (B, rows, D)
            m_i = torch.full((B, len(rows)), NEG_INF)
            l_i = torch.zeros((B, len(rows)))
            acc = torch.zeros((B, len(rows), D))
            n_begin, n_end = live_key_tiles(m0, BM, BN, T, causal, window)
            assert n_begin % BN == 0
            for n0 in range(n_begin, n_end, BN):
                keys = torch.arange(n0, min(n0 + BN, T))
                s = _scores(qt, k[:, keys, h // G], scale, softcap, pw)
                s = s.masked_fill(_dead(rows, keys, S, T, causal, window),
                                  NEG_INF)
                m_new = torch.maximum(m_i, s.amax(-1))
                corr = torch.exp(m_i - m_new)
                p = torch.exp(s - m_new[..., None])
                l_i = l_i * corr + p.sum(-1)
                acc = acc * corr[..., None] + panel_product(
                    p, v[:, keys, h // G], pw, n_panels)
                m_i = m_new
            o[:, rows, h] = acc / l_i.clamp_min(1e-30)[..., None]
            m_out[:, rows, h] = m_i
            l_out[:, rows, h] = l_i.clamp_min(1e-30)
    return o, m_out, l_out


def dkv_tile_walk(q, k, v, do, m, l, delta, *, causal, window, softcap, BM,
                  BN=BN, pw=None, n_panels=None):
    """The warpgroup dK/dV's walk in fp32: per KV head and block of BN keys,
    the (query tile, group head) pairs of ``live_query_tiles``; p from the
    saved statistics, the exact soft-cap derivative, dK and dV summed over
    the group in the block; the products on ``pw``-column panels where
    ``pw`` is given, dK's and dV's from the first ``n_panels`` only."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for kh in range(K):
        for n0 in range(0, T, BN):
            keys = torch.arange(n0, min(n0 + BN, T))
            kt, vt = k[:, keys, kh], v[:, keys, kh]     # (B, keys, D)
            dk_acc = torch.zeros((B, len(keys), D))
            dv_acc = torch.zeros((B, len(keys), D))
            m_begin, m_end = live_query_tiles(n0, BN, BM, S, causal, window)
            assert m_begin % BM == 0
            for m0 in range(m_begin, m_end, BM):
                rows = torch.arange(m0, min(m0 + BM, S))
                for g in range(G):
                    h = kh * G + g
                    qt, dot = q[:, rows, h], do[:, rows, h]
                    st = _scores(kt, qt, scale, softcap, pw)  # keys x queries
                    dead = _dead(rows, keys, S, T, causal, window).T
                    pt = torch.where(dead, 0.0, torch.exp(
                        st - m[:, rows, h][:, None]) / l[:, rows, h][:, None])
                    dpt = kstep_product(vt, dot, pw)
                    dst = pt * (dpt - delta[:, rows, h][:, None])
                    if softcap > 0:
                        dst = dst * (1.0 - (st / softcap) ** 2)
                    dv_acc += panel_product(pt, dot, pw, n_panels)
                    dk_acc += panel_product(dst * scale, qt, pw, n_panels)
            dk[:, keys, kh] = dk_acc
            dv[:, keys, kh] = dv_acc
    return dk, dv


def d256_dkv_items(B, T, K, G, nsl=None):
    """The D = 256 dK/dV's work items in launch order (``csrc``
    ``flash_bwd_dkv_d256_kernel``): (key tile n0, slice, its first head,
    its heads, KV head, batch row), key tiles in order, within a tile the
    slices with one head more first."""
    nsl = fab.dkv_d256_slices(B, T, K, G) if nsl is None else nsl
    items = []
    for n0 in range(0, T, D256_DKV_BN):
        for s in range(nsl):
            gs = G // nsl + (s < G % nsl)
            g0 = s * (G // nsl) + min(s, G % nsl)
            items += [(n0, s, g0, gs, kh, b) for kh in range(K)
                      for b in range(B)]
    return items, nsl


def dkv_d256_walk(q, k, v, do, m, l, delta, *, causal, window, softcap,
                  pw=None, warpgroups=(0, 1), nsl=None, fault=None):
    """The D = 256 dK/dV's walk in fp32: per work item (64 keys, one slice
    of the group's heads) the (query tile of 64 positions, head of the
    slice) pairs of ``live_query_tiles``; S^T and dP^T computed once a pair,
    P^T and dS^T shared by the warpgroups, each of ``warpgroups`` adding
    dV += P^T dO and dK += dS^T Q for its 128 columns (two 64-column panels
    where ``pw`` is given); each slice's dK and dV kept as a partial, the
    partials summed in slice order.  ``fault``: ("dropped" or "doubled",
    item index) plants that fault in the sum."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    items, nsl = d256_dkv_items(B, T, K, G, nsl)
    part_k = torch.zeros((nsl,) + k.shape)
    part_v = torch.zeros((nsl,) + v.shape)
    for i, (n0, s, g0, gs, kh, b) in enumerate(items):
        keys = torch.arange(n0, min(n0 + D256_DKV_BN, T))
        kt, vt = k[b, keys, kh], v[b, keys, kh]         # (keys, D)
        dk_acc = torch.zeros((len(keys), D))
        dv_acc = torch.zeros((len(keys), D))
        m_begin, m_end = live_query_tiles(n0, D256_DKV_BN, D256_DKV_BM, S,
                                          causal, window)
        for m0 in range(m_begin, m_end, D256_DKV_BM):
            rows = torch.arange(m0, min(m0 + D256_DKV_BM, S))
            for h in range(kh * G + g0, kh * G + g0 + gs):
                qt, dot = q[b, rows, h], do[b, rows, h]
                st = _scores(kt, qt, scale, softcap, pw)   # keys x queries
                dead = _dead(rows, keys, S, T, causal, window).T
                pt = torch.where(dead, 0.0, torch.exp(
                    st - m[b, rows, h]) / l[b, rows, h])
                dst = pt * (kstep_product(vt, dot, pw) - delta[b, rows, h])
                if softcap > 0:
                    dst = dst * (1.0 - (st / softcap) ** 2)
                for w in warpgroups:      # columns 128 w .. 128 w + 127
                    if pw:                    # panels 2 w and 2 w + 1
                        dv_acc += panel_product(pt, dot, pw, 2 * w + 2,
                                                2 * w)
                        dk_acc += panel_product(dst * scale, qt, pw,
                                                2 * w + 2, 2 * w)
                    else:
                        cols = slice(128 * w, 128 * w + 128)
                        dv_acc[:, cols] += pt @ dot[:, cols]
                        dk_acc[:, cols] += (dst * scale) @ qt[:, cols]
        times = 1
        if fault is not None and fault[1] == i:
            times = {"dropped": 0, "doubled": 2}[fault[0]]
        part_k[s, b, keys, kh] += times * dk_acc
        part_v[s, b, keys, kh] += times * dv_acc
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for s in range(nsl):                # the sum launch: slice order
        dk += part_k[s]
        dv += part_v[s]
    return dk, dv


def dq_tile_walk(q, k, v, do, m, l, delta, *, causal, window, softcap, BM,
                 BN=DQ_BN, pw=None, n_panels=None):
    """The warpgroup dQ's walk in fp32: per head and block of BM positions,
    the BN-key tiles of ``live_key_tiles``; p from the saved statistics,
    the exact soft-cap derivative, dQ accumulated over the tiles; the
    products on ``pw``-column panels where ``pw`` is given, dQ's from the
    first ``n_panels`` only."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    dq = torch.zeros_like(q)
    for h in range(H):
        for m0 in range(0, S, BM):
            rows = torch.arange(m0, min(m0 + BM, S))
            qt, dot = q[:, rows, h], do[:, rows, h]     # (B, rows, D)
            acc = torch.zeros((B, len(rows), D))
            n_begin, n_end = live_key_tiles(m0, BM, BN, T, causal, window)
            assert n_begin % BN == 0
            for n0 in range(n_begin, n_end, BN):
                keys = torch.arange(n0, min(n0 + BN, T))
                kt, vt = k[:, keys, h // G], v[:, keys, h // G]
                s = _scores(qt, kt, scale, softcap, pw)  # queries x keys
                p = torch.where(
                    _dead(rows, keys, S, T, causal, window), 0.0,
                    torch.exp(s - m[:, rows, h][..., None])
                    / l[:, rows, h][..., None])
                ds = p * (kstep_product(dot, vt, pw)
                          - delta[:, rows, h][..., None])
                if softcap > 0:
                    ds = ds * (1.0 - (s / softcap) ** 2)
                acc += panel_product(ds * scale, kt, pw, n_panels)
            dq[:, rows, h] = acc
    return dq


@functools.lru_cache(maxsize=None)
def _oracle(case):
    """The reference's forward and its jax.grad (dq, dk, dv) for
    ``case``."""
    B, S, T, H, K, D, causal, window, softcap = case
    q, k, v, do = _inputs(B, S, T, H, K, D)

    def f(q, k, v):
        return ref_attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    out = np.asarray(f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    dq, dk, dv = jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * do),
                          argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    return out, np.asarray(dq), np.asarray(dk), np.asarray(dv)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


@pytest.mark.parametrize("BM", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_forward_tile_walk_matches_plain_and_oracle(case, BM):
    B, S, T, H, K, D, causal, window, softcap = case
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(B, S, T, H, K, D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, m, l = forward_tile_walk(q, k, v, BM=BM, **kw)
    o2, m2, l2 = fab.attention_fwd_stats_plain(q, k, v, **kw)
    _close(o, attention_plain(q, k, v, **kw), 1e-5, "o vs attention_plain")
    _close(m, m2, 1e-5, "m vs attention_fwd_stats_plain")
    _close(l, l2, 1e-5, "l vs attention_fwd_stats_plain")
    _close(o, _oracle(case)[0], 5e-4, "o vs attention_ref")


@pytest.mark.parametrize("BM", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_dkv_tile_walk_matches_plain_and_oracle(case, BM):
    B, S, T, H, K, D, causal, window, softcap = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, S, T, H, K, D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, m, l = fab.attention_fwd_stats_plain(q, k, v, **kw)
    delta = fab.attention_delta(o, do)
    dk, dv = dkv_tile_walk(q, k, v, do, m, l, delta, BM=BM, **kw)
    _, dk2, dv2 = fab.attention_bwd_plain(q, k, v, do, m, l, delta, **kw)
    _close(dk, dk2, 1e-5, "dk vs attention_bwd_plain")
    _close(dv, dv2, 1e-5, "dv vs attention_bwd_plain")
    _, _, dk3, dv3 = _oracle(case)
    _close(dk, dk3, 5e-4, "dk vs jax.grad of attention_ref")
    _close(dv, dv3, 5e-4, "dv vs jax.grad of attention_ref")


@pytest.mark.parametrize("BM", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_dq_tile_walk_matches_plain_and_oracle(case, BM):
    B, S, T, H, K, D, causal, window, softcap = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, S, T, H, K, D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, m, l = fab.attention_fwd_stats_plain(q, k, v, **kw)
    delta = fab.attention_delta(o, do)
    dq = dq_tile_walk(q, k, v, do, m, l, delta, BM=BM, **kw)
    dq2 = fab.attention_bwd_plain(q, k, v, do, m, l, delta, **kw)[0]
    _close(dq, dq2, 1e-5, "dq vs attention_bwd_plain")
    _close(dq, _oracle(case)[1], 5e-4, "dq vs jax.grad of attention_ref")


@pytest.mark.parametrize("pw", [None, 32])
@pytest.mark.parametrize("case", D160_CASES)
def test_forward_tile_walk_d160_matches_plain_and_oracle(case, pw):
    B, S, T, H, K, D, causal, window, softcap = case
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(B, S, T, H, K, D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, m, l = forward_tile_walk(q, k, v, BM=128, pw=pw, **kw)
    o2, m2, l2 = fab.attention_fwd_stats_plain(q, k, v, **kw)
    _close(o, o2, 1e-5, "o vs attention_fwd_stats_plain")
    _close(m, m2, 1e-5, "m vs attention_fwd_stats_plain")
    _close(l, l2, 1e-5, "l vs attention_fwd_stats_plain")
    _close(o, _oracle(case)[0], 5e-4, "o vs attention_ref")


@pytest.mark.parametrize("pw", [None, 32])
@pytest.mark.parametrize("case", D160_CASES)
def test_dkv_tile_walk_d160_matches_plain_and_oracle(case, pw):
    B, S, T, H, K, D, causal, window, softcap = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, S, T, H, K, D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, m, l = fab.attention_fwd_stats_plain(q, k, v, **kw)
    delta = fab.attention_delta(o, do)
    dk, dv = dkv_tile_walk(q, k, v, do, m, l, delta, BM=D160_DKV_BM, pw=pw,
                           **kw)
    _, dk2, dv2 = fab.attention_bwd_plain(q, k, v, do, m, l, delta, **kw)
    _close(dk, dk2, 1e-5, "dk vs attention_bwd_plain")
    _close(dv, dv2, 1e-5, "dv vs attention_bwd_plain")
    _, _, dk3, dv3 = _oracle(case)
    _close(dk, dk3, 5e-4, "dk vs jax.grad of attention_ref")
    _close(dv, dv3, 5e-4, "dv vs jax.grad of attention_ref")


@pytest.mark.parametrize("pw", [None, 32])
@pytest.mark.parametrize("case", D160_CASES)
def test_dq_tile_walk_d160_matches_plain_and_oracle(case, pw):
    B, S, T, H, K, D, causal, window, softcap = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, S, T, H, K, D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, m, l = fab.attention_fwd_stats_plain(q, k, v, **kw)
    delta = fab.attention_delta(o, do)
    dq = dq_tile_walk(q, k, v, do, m, l, delta, BM=128, pw=pw, **kw)
    dq2 = fab.attention_bwd_plain(q, k, v, do, m, l, delta, **kw)[0]
    _close(dq, dq2, 1e-5, "dq vs attention_bwd_plain")
    _close(dq, _oracle(case)[1], 5e-4, "dq vs jax.grad of attention_ref")


@pytest.mark.parametrize("pw", [None, 64])
@pytest.mark.parametrize("case", D256_CASES)
def test_forward_tile_walk_d256_matches_plain_and_oracle(case, pw):
    B, S, T, H, K, D, causal, window, softcap = case
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(B, S, T, H, K, D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, m, l = forward_tile_walk(q, k, v, BM=128, BN=D256_BN, pw=pw, **kw)
    o2, m2, l2 = fab.attention_fwd_stats_plain(q, k, v, **kw)
    _close(o, attention_plain(q, k, v, **kw), 1e-5, "o vs attention_plain")
    _close(m, m2, 1e-5, "m vs attention_fwd_stats_plain")
    _close(l, l2, 1e-5, "l vs attention_fwd_stats_plain")
    _close(o, _oracle(case)[0], 5e-4, "o vs attention_ref")


@pytest.mark.parametrize("case", D256_CASES)
def test_dropped_last_panel_d256_fails(case):
    """Three of the four 64-column panels: o misses columns 192-255, and
    the comparison that the whole walk passes rejects it."""
    B, S, T, H, K, D, causal, window, softcap = case
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(B, S, T, H, K, D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o = forward_tile_walk(q, k, v, BM=128, BN=D256_BN, pw=64, n_panels=3,
                          **kw)[0]
    want = attention_plain(q, k, v, **kw)
    assert torch.equal(o[..., 192:], torch.zeros_like(o[..., 192:]))
    _close(o[..., :192], want[..., :192], 1e-5, "o columns 0-191")
    with pytest.raises(AssertionError):
        _close(o, want, 1e-5, "o")


@pytest.mark.parametrize("pw", [None, 64])
@pytest.mark.parametrize("case", D256_CASES)
def test_dkv_tile_walk_d256_matches_plain_and_oracle(case, pw):
    """Work items of 64 keys and a head slice, 64-query tiles, the scores
    once a pair, two warpgroups' column halves, the slices' partials summed
    in order."""
    B, S, T, H, K, D, causal, window, softcap = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, S, T, H, K, D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, m, l = fab.attention_fwd_stats_plain(q, k, v, **kw)
    delta = fab.attention_delta(o, do)
    dk, dv = dkv_d256_walk(q, k, v, do, m, l, delta, pw=pw, **kw)
    _, dk2, dv2 = fab.attention_bwd_plain(q, k, v, do, m, l, delta, **kw)
    _close(dk, dk2, 1e-5, "dk vs attention_bwd_plain")
    _close(dv, dv2, 1e-5, "dv vs attention_bwd_plain")
    _, _, dk3, dv3 = _oracle(case)
    _close(dk, dk3, 5e-4, "dk vs jax.grad of attention_ref")
    _close(dv, dv3, 5e-4, "dv vs jax.grad of attention_ref")


@pytest.mark.parametrize("pw", [None, 64])
@pytest.mark.parametrize("case", D256_CASES)
def test_dq_tile_walk_d256_matches_plain_and_oracle(case, pw):
    """48-key tiles under blocks of 128 positions."""
    B, S, T, H, K, D, causal, window, softcap = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, S, T, H, K, D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, m, l = fab.attention_fwd_stats_plain(q, k, v, **kw)
    delta = fab.attention_delta(o, do)
    dq = dq_tile_walk(q, k, v, do, m, l, delta, BM=128, BN=D256_DQ_BN,
                      pw=pw, **kw)
    dq2 = fab.attention_bwd_plain(q, k, v, do, m, l, delta, **kw)[0]
    _close(dq, dq2, 1e-5, "dq vs attention_bwd_plain")
    _close(dq, _oracle(case)[1], 5e-4, "dq vs jax.grad of attention_ref")


@pytest.mark.parametrize("case", D256_CASES)
def test_dropped_column_half_d256_fails(case):
    """The first warpgroup's columns alone (the second warpgroup lost): dk
    and dv miss columns 128-255; a dQ walk over the first two of the four
    panels misses the same columns of dq; the comparison that the whole
    walk passes rejects each of them."""
    B, S, T, H, K, D, causal, window, softcap = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, S, T, H, K, D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, m, l = fab.attention_fwd_stats_plain(q, k, v, **kw)
    delta = fab.attention_delta(o, do)
    dk, dv = dkv_d256_walk(q, k, v, do, m, l, delta, pw=64, warpgroups=(0,),
                           **kw)
    dq = dq_tile_walk(q, k, v, do, m, l, delta, BM=128, BN=D256_DQ_BN,
                      pw=64, n_panels=2, **kw)
    dq2, dk2, dv2 = fab.attention_bwd_plain(q, k, v, do, m, l, delta, **kw)
    for name, got, want in (("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2)):
        assert torch.equal(got[..., 128:], torch.zeros_like(got[..., 128:]))
        _close(got[..., :128], want[..., :128], 1e-5, f"{name} columns 0-127")
        with pytest.raises(AssertionError):
            _close(got, want, 1e-5, name)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 50), (True, 200),
                                           (False, 64)])
def test_d256_dq_tile_bounds_skip_only_dead_tiles(causal, window):
    """The integer check for the D = 256 dQ's 48-key tiles under blocks of
    128 positions (its dK/dV items are checked below)."""
    BNq = D256_DQ_BN
    for S, T in ((1, 1), (100, 77), (77, 100), (129, 300), (300, 129),
                 (513, 513)):
        live = ~_dead(torch.arange(S), torch.arange(T), S, T, causal,
                      window).numpy()
        seen = np.zeros_like(live)
        for m0 in range(0, S, 128):
            n_begin, n_end = live_key_tiles(m0, 128, BNq, T, causal, window)
            assert n_begin % BNq == 0
            for n0 in range(n_begin, n_end, BNq):
                seen[m0:m0 + 128, n0:n0 + BNq] = True
        assert not (live & ~seen).any(), (S, T, "dQ, 48-key tiles")


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 50), (True, 200),
                                           (False, 64)])
def test_d256_dkv_items_cover_each_live_pair_once(causal, window):
    """The integer check for the D = 256 dK/dV's work items: over every
    (query, key, head) -- B = 2, G = 10 and G = 3 over two KV heads, the
    slice rule's count and others -- each live pair lies in exactly one
    walked (64-query tile, 64-key item, head), and no pair in two."""
    for S, T in ((1, 1), (100, 77), (77, 100), (129, 300), (300, 129),
                 (513, 513)):
        live = ~_dead(torch.arange(S), torch.arange(T), S, T, causal,
                      window).numpy()
        for B, K, G, nsl in ((2, 1, 10, None), (1, 2, 3, None),
                             (1, 1, 10, 1), (1, 1, 10, 3), (1, 1, 10, 4)):
            items, nsl = d256_dkv_items(B, T, K, G, nsl)
            assert 1 <= nsl <= G
            seen = np.zeros((B, S, T, K * G), np.int32)
            for n0, s, g0, gs, kh, b in items:
                m_begin, m_end = live_query_tiles(n0, D256_DKV_BN,
                                                  D256_DKV_BM, S, causal,
                                                  window)
                assert m_begin % D256_DKV_BM == 0
                heads = slice(kh * G + g0, kh * G + g0 + gs)
                for m0 in range(m_begin, m_end, D256_DKV_BM):
                    seen[b, m0:m0 + D256_DKV_BM, n0:n0 + D256_DKV_BN,
                         heads] += 1
            assert seen.max() <= 1, (S, T, B, K, G, nsl, "a pair twice")
            assert (seen[:, live] == 1).all(), (S, T, B, K, G, nsl,
                                                "a live pair not walked")


def test_d256_dkv_slice_rule():
    """The slices of a key tile: about D256_DKV_ITEMS work items, at most
    one slice per head; recurrentgemma-2b's trained shape (2 x 4096, 10
    heads over 1) takes four (heads 3, 3, 2, 2: 512 items on 132 SMs)."""
    assert fab.dkv_d256_slices(2, 4096, 1, 10) == 4
    assert fab.dkv_d256_slices(1, 4096, 1, 10) == 7
    assert fab.dkv_d256_slices(1, 300, 1, 10) == 10
    assert fab.dkv_d256_slices(8, 65536, 1, 10) == 1
    items, nsl = d256_dkv_items(2, 4096, 1, 10)
    assert len(items) == 512
    assert [gs for _, s, _, gs, _, b in items[:8] if b == 0] == [3, 3, 2, 2]


@pytest.mark.parametrize("fault", ["dropped", "doubled"])
def test_d256_slice_partial_fault_fails(fault):
    """One work item's partial dropped from the slices' sum, or counted
    twice: the comparison that the whole walk passes rejects it."""
    case = D256_CASES[0]
    B, S, T, H, K, D, causal, window, softcap = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, S, T, H, K, D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, m, l = fab.attention_fwd_stats_plain(q, k, v, **kw)
    delta = fab.attention_delta(o, do)
    _, dk2, dv2 = fab.attention_bwd_plain(q, k, v, do, m, l, delta, **kw)
    items, nsl = d256_dkv_items(B, T, K, H // K, 3)
    at = next(i for i, it in enumerate(items) if it[0] == 128 and it[1] == 1)
    dk, dv = dkv_d256_walk(q, k, v, do, m, l, delta, nsl=3,
                           fault=(fault, at), **kw)
    for name, got, want in (("dk", dk, dk2), ("dv", dv, dv2)):
        _close(got[:, :128], want[:, :128], 1e-5, f"{name} other keys")
        with pytest.raises(AssertionError):
            _close(got, want, 1e-5, name)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 50), (True, 200),
                                           (False, 64)])
def test_d160_tile_bounds_skip_only_dead_tiles(causal, window):
    """The same integer check for the D = 160 dK/dV's 32-query tiles of
    128-key blocks (the forward's tiles are D = 128's, checked above)."""
    for S, T in ((1, 1), (100, 77), (77, 100), (129, 300), (300, 129),
                 (513, 513)):
        live = ~_dead(torch.arange(S), torch.arange(T), S, T, causal,
                      window).numpy()
        seen = np.zeros_like(live)
        for n0 in range(0, T, BN):
            m_begin, m_end = live_query_tiles(n0, BN, D160_DKV_BM, S, causal,
                                              window)
            assert m_begin % D160_DKV_BM == 0
            for m0 in range(m_begin, m_end, D160_DKV_BM):
                seen[m0:m0 + D160_DKV_BM, n0:n0 + BN] = True
        assert not (live & ~seen).any(), (S, T, "dK/dV, 32-query tiles")


@pytest.mark.parametrize("D", [64, 128, 160, 256])
def test_panels_cover_every_column_once(D):
    """The panel layout holds each column once, in order, and the k-steps
    walk every 16-column slice once."""
    pw = panel_cols(D)
    x = torch.arange(3 * D, dtype=torch.float32).reshape(3, D)
    p = panels(x, pw)
    assert p.shape == (D // pw, 3, pw)
    assert torch.equal(p.movedim(0, -2).flatten(-2), x)
    seen = [divmod(ks, pw // KSTEP) for ks in range(D // KSTEP)]
    cols = sorted(p_ * pw + c * KSTEP for p_, c in seen)
    assert cols == list(range(0, D, KSTEP))


@pytest.mark.parametrize("walk", ["forward", "dkv", "dq"])
@pytest.mark.parametrize("case", PANEL64_CASES)
def test_panel_walks_at_64_column_panels(case, walk):
    """D = 64 and 128 run the same panel code on 64-column panels."""
    B, S, T, H, K, D, causal, window, softcap = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, S, T, H, K, D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, m, l = fab.attention_fwd_stats_plain(q, k, v, **kw)
    if walk == "forward":
        got = forward_tile_walk(q, k, v, BM=128, pw=panel_cols(D), **kw)[0]
        _close(got, o, 1e-5, "o vs attention_fwd_stats_plain")
        return
    delta = fab.attention_delta(o, do)
    if walk == "dq":
        dq = dq_tile_walk(q, k, v, do, m, l, delta, BM=128, pw=panel_cols(D),
                          **kw)
        dq2 = fab.attention_bwd_plain(q, k, v, do, m, l, delta, **kw)[0]
        _close(dq, dq2, 1e-5, "dq vs attention_bwd_plain")
        return
    dk, dv = dkv_tile_walk(q, k, v, do, m, l, delta, BM=64, pw=panel_cols(D),
                           **kw)
    _, dk2, dv2 = fab.attention_bwd_plain(q, k, v, do, m, l, delta, **kw)
    _close(dk, dk2, 1e-5, "dk vs attention_bwd_plain")
    _close(dv, dv2, 1e-5, "dv vs attention_bwd_plain")


@pytest.mark.parametrize("case", D160_CASES)
def test_dropped_tail_panel_fails(case):
    """Four of the five panels (columns 0-127, a 64-column split of 160):
    o, dq, dk and dv miss their last 32 columns, and the comparison that the
    whole walk passes rejects each of them; so does a score walk over the
    first 128 columns only."""
    B, S, T, H, K, D, causal, window, softcap = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, S, T, H, K, D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o2, m, l = fab.attention_fwd_stats_plain(q, k, v, **kw)
    delta = fab.attention_delta(o2, do)
    o = forward_tile_walk(q, k, v, BM=128, pw=32, n_panels=4, **kw)[0]
    dk, dv = dkv_tile_walk(q, k, v, do, m, l, delta, BM=D160_DKV_BM, pw=32,
                           n_panels=4, **kw)
    dq = dq_tile_walk(q, k, v, do, m, l, delta, BM=128, pw=32, n_panels=4,
                      **kw)
    dq2, dk2, dv2 = fab.attention_bwd_plain(q, k, v, do, m, l, delta, **kw)
    for name, got, want in (("o", o, o2), ("dq", dq, dq2), ("dk", dk, dk2),
                            ("dv", dv, dv2)):
        assert torch.equal(got[..., 128:], torch.zeros_like(got[..., 128:]))
        _close(got[..., :128], want[..., :128], 1e-5, f"{name} columns 0-127")
        with pytest.raises(AssertionError):
            _close(got, want, 1e-5, name)
    with pytest.raises(AssertionError):
        _close(kstep_product(q, q, 32, n_panels=4), kstep_product(q, q, 32),
               1e-5, "scores")


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 50), (True, 200),
                                           (False, 64)])
def test_tile_bounds_skip_only_dead_tiles(causal, window):
    """Integer check over many lengths: every live (query, key) pair lies in
    a walked tile of all three walks, and each walk starts on a tile
    boundary."""
    for S, T in ((1, 1), (100, 77), (77, 100), (128, 128), (129, 300),
                 (300, 129), (513, 513)):
        for BM in (64, 128):
            live = ~_dead(torch.arange(S), torch.arange(T), S, T, causal,
                          window).numpy()
            seen = np.zeros_like(live)
            for m0 in range(0, S, BM):
                n_begin, n_end = live_key_tiles(m0, BM, BN, T, causal,
                                                window)
                assert n_begin % BN == 0
                for n0 in range(n_begin, n_end, BN):
                    seen[m0:m0 + BM, n0:n0 + BN] = True
            assert not (live & ~seen).any(), (S, T, BM, "forward")
            seen[:] = False
            for m0 in range(0, S, BM):
                n_begin, n_end = live_key_tiles(m0, BM, DQ_BN, T, causal,
                                                window)
                assert n_begin % DQ_BN == 0
                for n0 in range(n_begin, n_end, DQ_BN):
                    seen[m0:m0 + BM, n0:n0 + DQ_BN] = True
            assert not (live & ~seen).any(), (S, T, BM, "dQ")
            seen[:] = False
            for n0 in range(0, T, BN):
                m_begin, m_end = live_query_tiles(n0, BN, BM, S, causal,
                                                  window)
                assert m_begin % BM == 0
                for m0 in range(m_begin, m_end, BM):
                    seen[m0:m0 + BM, n0:n0 + BN] = True
            assert not (live & ~seen).any(), (S, T, BM, "dK/dV")
