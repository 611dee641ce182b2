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
time on the card.
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
# Every query row of these cases sees at least one key.  A row that sees
# none has no agreed output: the oracle and the plain versions give the mean
# of all V (a uniform softmax over -1e30 scores), the reference's Pallas
# kernel and the port's kernels the mean of V over the tiles they walk, or
# zero where they walk none (ROADMAP queue C).


def _inputs(B, S, T, H, K, D, seed=11):
    r = np.random.RandomState(seed)
    return tuple(r.standard_normal(s).astype(np.float32) for s in
                 ((B, S, H, D), (B, T, K, D), (B, T, K, D), (B, S, H, D)))


def _scores(qt, kt, scale, softcap):
    s = qt @ kt.transpose(-1, -2) * scale
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


def forward_tile_walk(q, k, v, *, causal, window, softcap, BM):
    """The warpgroup forward's walk in fp32: per head and block of BM
    positions, online softmax over the key tiles of ``live_key_tiles``.
    Returns (o, m, l) as ``attention_fwd_stats_plain`` does."""
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
                s = _scores(qt, k[:, keys, h // G], scale, softcap)
                s = s.masked_fill(_dead(rows, keys, S, T, causal, window),
                                  NEG_INF)
                m_new = torch.maximum(m_i, s.amax(-1))
                corr = torch.exp(m_i - m_new)
                p = torch.exp(s - m_new[..., None])
                l_i = l_i * corr + p.sum(-1)
                acc = acc * corr[..., None] + p @ v[:, keys, h // G]
                m_i = m_new
            o[:, rows, h] = acc / l_i.clamp_min(1e-30)[..., None]
            m_out[:, rows, h] = m_i
            l_out[:, rows, h] = l_i.clamp_min(1e-30)
    return o, m_out, l_out


def dkv_tile_walk(q, k, v, do, m, l, delta, *, causal, window, softcap, BM):
    """The warpgroup dK/dV's walk in fp32: per KV head and block of BN keys,
    the (query tile, group head) pairs of ``live_query_tiles``; p from the
    saved statistics, the exact soft-cap derivative, dK and dV summed over
    the group in the block."""
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
                    st = _scores(kt, qt, scale, softcap)   # keys x queries
                    dead = _dead(rows, keys, S, T, causal, window).T
                    pt = torch.where(dead, 0.0, torch.exp(
                        st - m[:, rows, h][:, None]) / l[:, rows, h][:, None])
                    dpt = vt @ dot.transpose(-1, -2)
                    dst = pt * (dpt - delta[:, rows, h][:, None])
                    if softcap > 0:
                        dst = dst * (1.0 - (st / softcap) ** 2)
                    dv_acc += pt @ dot
                    dk_acc += (dst * scale) @ qt
            dk[:, keys, kh] = dk_acc
            dv[:, keys, kh] = dv_acc
    return dk, dv


def dq_tile_walk(q, k, v, do, m, l, delta, *, causal, window, softcap, BM):
    """The warpgroup dQ's walk in fp32: per head and block of BM positions,
    the DQ_BN-key tiles of ``live_key_tiles``; p from the saved statistics,
    the exact soft-cap derivative, dQ accumulated over the tiles."""
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
            n_begin, n_end = live_key_tiles(m0, BM, DQ_BN, T, causal,
                                            window)
            assert n_begin % DQ_BN == 0
            for n0 in range(n_begin, n_end, DQ_BN):
                keys = torch.arange(n0, min(n0 + DQ_BN, T))
                kt, vt = k[:, keys, h // G], v[:, keys, h // G]
                s = _scores(qt, kt, scale, softcap)     # queries x keys
                p = torch.where(
                    _dead(rows, keys, S, T, causal, window), 0.0,
                    torch.exp(s - m[:, rows, h][..., None])
                    / l[:, rows, h][..., None])
                ds = p * (dot @ vt.transpose(-1, -2)
                          - delta[:, rows, h][..., None])
                if softcap > 0:
                    ds = ds * (1.0 - (s / softcap) ** 2)
                acc += (ds * scale) @ kt
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
