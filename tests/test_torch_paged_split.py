"""The split-KV design of ``csrc/paged_attention.cu``, walked on the CPU.

The kernel cuts each row's token axis into pieces of whole pages
(``split_pieces``: about 128 tokens), computes one fp32 partial ``(m, l,
acc)`` per (piece, kv head, sequence) over the piece's live tokens -- a
piece that starts at or past ``lengths[b]`` computes nothing -- and merges
the live pieces of each (sequence, kv head) as ``sum_i f_i acc_i /
max(sum_i f_i l_i, 1e-30)`` with ``f_i = exp(m_i - max m)``, in one pass
with a running max.  Here a plain
PyTorch version walks exactly those pieces and that merge, in fp32, and is
held to ``paged_attention_plain`` at 1e-5 (summation order only) and to the
reference's Pallas ``paged_decode_attention`` in interpret mode at 1e-5, as
``tests/test_torch_kernels.py`` runs it.  The cases cover stablelm-12b's
D = 160 with G = 4, lengths at and one past a piece boundary, a row shorter
than one piece, a zero-length row, pieces with no live token, and the
soft-cap at 0 and 30.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import (
    paged_decode_attention as ref_paged_decode_attention)

from repro_torch.kernels.paged_attention import (NEG_INF, PIECE_TOKENS,
                                                 paged_attention_plain,
                                                 split_pieces)

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(B, T, D, G, K, ps, lengths, seed=0):
    """Random q and a paged K/V pool with per-row exclusive, shuffled
    tables; one page no table names."""
    H, P = G * K, T // ps
    r = np.random.RandomState(seed)
    q = r.standard_normal((B, H, D)).astype(np.float32)
    kp = r.standard_normal((B * P + 1, ps, K, D)).astype(np.float32)
    vp = r.standard_normal((B * P + 1, ps, K, D)).astype(np.float32)
    tables = r.permutation(B * P).reshape(B, P).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def split_partials(q, k_pages, v_pages, tables, lengths, *, softcap=0.0):
    """Each piece's fp32 ``(m, l, acc)`` as the split kernel computes it:
    (B, K, pieces, G), (B, K, pieces, G), (B, K, pieces, G, D).  A piece
    with no live token keeps m = NEG_INF, l = 0, acc = 0."""
    B, H, D = q.shape
    ps, K = k_pages.shape[1], k_pages.shape[2]
    P = tables.shape[1]
    G = H // K
    pages, n_pieces = split_pieces(P, ps)
    pt = pages * ps
    m = torch.full((B, K, n_pieces, G), NEG_INF)
    l = torch.zeros((B, K, n_pieces, G))
    acc = torch.zeros((B, K, n_pieces, G, D))
    qg = q.float().reshape(B, K, G, D)
    for b in range(B):
        n = min(int(lengths[b]), P * ps)
        for i in range(n_pieces):
            t0, t1 = i * pt, min(n, (i + 1) * pt)
            if t0 >= n:
                continue                      # the block returns at once
            t = torch.arange(t0, t1)
            pg = tables[b].long()[t // ps]
            k = k_pages[pg, t % ps].float()   # (n, K, D)
            v = v_pages[pg, t % ps]
            s = torch.einsum("kgd,tkd->kgt", qg[b], k) / math.sqrt(D)
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            mi = s.max(dim=-1).values
            p = torch.exp(s - mi[..., None])
            m[b, :, i] = mi
            l[b, :, i] = p.sum(-1)
            # p rounded to V's dtype before the PV product
            acc[b, :, i] = torch.einsum("kgt,tkd->kgd", p.to(v.dtype).float(),
                                        v.float())
    return m, l, acc


def merge(m, l, acc, lengths, piece_tokens, *, only_live=True):
    """The merge launch: the pieces below ``lengths[b]`` (or all of them)
    in one pass with a running max, the sums rescaled by exp(m_old - m_new)
    when it rises, then num / max(den, 1e-30) -> (B, K, G, D)."""
    B, K, n_pieces, G = m.shape
    out = torch.zeros(acc.shape[:2] + acc.shape[3:])
    for b in range(B):
        n_live = -(-max(0, int(lengths[b])) // piece_tokens)
        hi = min(n_live, n_pieces) if only_live else n_pieces
        mm = torch.full((K, G), NEG_INF)
        num = torch.zeros(acc.shape[1:2] + acc.shape[3:])
        den = torch.zeros((K, G))
        for i in range(hi):
            m_new = torch.maximum(mm, m[b, :, i])
            c = torch.exp(mm - m_new)
            f = torch.exp(m[b, :, i] - m_new)
            num = num * c[..., None] + f[..., None] * acc[b, :, i]
            den = den * c + f * l[b, :, i]
            mm = m_new
        out[b] = num / torch.clamp(den, min=1e-30)[..., None]
    return out


def split_kv(q, k_pages, v_pages, tables, lengths, *, softcap=0.0,
             only_live=True):
    B, H, D = q.shape
    pages, _ = split_pieces(tables.shape[1], k_pages.shape[1])
    parts = split_partials(q, k_pages, v_pages, tables, lengths,
                           softcap=softcap)
    out = merge(*parts, lengths, pages * k_pages.shape[1],
                only_live=only_live)
    return out.reshape(B, H, D)


CASES = [
    # B, T, D, G, K, page_size, lengths
    (3, 384, 160, 4, 2, 16, [129, 128, 0]),     # one past / at a boundary,
                                                # a zero-length row
    (2, 512, 160, 4, 1, 16, [512, 40]),         # whole table; one short row
    (2, 256, 128, 3, 2, 16, [255, 1]),          # a single-token history
    (2, 96, 160, 2, 2, 12, [95, 3]),            # 120-token pieces
]


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("B,T,D,G,K,ps,lengths", CASES)
def test_split_kv_matches_plain_and_reference_kernel(B, T, D, G, K, ps,
                                                     lengths, softcap):
    inputs = _inputs(B, T, D, G, K, ps, lengths)
    t = [torch.from_numpy(a) for a in inputs]
    got = split_kv(*t, softcap=softcap)
    want = paged_attention_plain(*t, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    ref = ref_paged_decode_attention(
        *(jnp.asarray(a) for a in inputs), block_k=128, softcap=softcap,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    for b, n in enumerate(lengths):
        if n == 0:
            assert torch.equal(got[b], torch.zeros_like(got[b]))


def test_pieces_without_a_live_token_contribute_nothing():
    """Merged over every piece -- the dead ones with m = NEG_INF, l = 0 --
    the result is the same and finite: exp(NEG_INF - max m) is 0, and a row
    with no live piece at all gives 0 / 1e-30 = 0, not NaN."""
    inputs = _inputs(3, 768, 160, 4, 2, 16, [700, 129, 0])
    t = [torch.from_numpy(a) for a in inputs]
    m, l, acc = split_partials(*t)
    assert bool((m[1, :, 2:] == NEG_INF).all())      # 129 tokens: 2 pieces
    assert bool((l[2] == 0).all())
    live = split_kv(*t)
    every = split_kv(*t, only_live=False)
    assert bool(torch.isfinite(every).all())
    np.testing.assert_allclose(every.numpy(), live.numpy(), **TOL)
    assert torch.equal(every[2], torch.zeros_like(every[2]))


@pytest.mark.parametrize("P,ps,pages,n", [
    (128, 16, 8, 16),        # the served table: 2048 tokens, 16 pieces
    (8, 12, 10, 1),          # page 12: pieces of 10 pages (120 tokens)
    (3, 256, 1, 3),          # pages above PIECE_TOKENS: one page a piece
    (17, 16, 8, 3),          # a ragged last piece
])
def test_split_pieces_are_whole_pages_covering_the_table(P, ps, pages, n):
    assert split_pieces(P, ps) == (pages, n)
    assert pages * ps <= max(PIECE_TOKENS, ps)
    assert (n - 1) * pages < P <= n * pages
