"""The tile walks of the warpgroup attention kernels at recurrentgemma-2b's
D = 256, on the CPU: the second half of ``tests/test_torch_tiling.py``
(split from it so that the two halves run on two test workers), with its
helpers and cases.  The forward walks 64-key tiles, dQ 48-key tiles, and
dK/dV work items of 64 keys and one slice of the group's heads
(``flash_attention_bwd.dkv_d256_slices``), each walking 64-query tiles with
S^T and dP^T computed once a pair and split by the two warpgroups' 128
columns, the slices' partials summed in slice order (``D256_CASES``: MQA
with G = 10, a window, ragged S).  Each is held to the port's plain
versions in fp32 at 1e-5 and to the reference's oracle at 5e-4; a walk
that leaves the tail panel (columns 192-255) or one warpgroup's column half
out, or drops or doubles one head slice's partial, must fail.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 live_key_tiles)
from repro_torch.kernels.flash_attention_bwd import live_query_tiles

from test_torch_tiling import (D256_BN, D256_CASES, D256_DKV_BM,
                               D256_DKV_BN, D256_DQ_BN, _close, _dead,
                               _inputs, _oracle, d256_dkv_items,
                               dkv_d256_walk, dq_tile_walk,
                               forward_tile_walk)


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
