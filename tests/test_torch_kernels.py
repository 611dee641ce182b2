"""Port vs reference: the kernel modules and their dispatch.

On the CPU the port's wrappers run the plain PyTorch versions kept beside the
kernels (the CUDA kernels themselves are held against those plain versions on
the card by ``chip_smoke.py``).  Here the plain versions are held against the
reference's Pallas kernels, run in interpret mode exactly as
``tests/test_kernels.py`` and ``tests/test_paged_attention.py`` run them, on
the reference's own cases with numpy inputs handed to both sides.

Tolerances are the reference's own: attention 2e-5 in fp32 (different
summation order: tiled online softmax vs one softmax) and 2e-2 in bf16 (bf16
rounding of inputs, probabilities and outputs); paged decode 1e-5 (fp32);
attention gradients 5e-4 (``tests/test_kernels_bwd.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.flash_attention_bwd import (
    flash_attention_vjp as ref_flash_attention_vjp)
from repro.kernels.paged_attention import (
    paged_decode_attention as ref_paged_decode_attention)
from repro.kernels.ref import attention_ref as ref_attention_ref

from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention)
from repro_torch.kernels.paged_attention import (paged_attention_plain,
                                                 paged_decode_attention)

ATTN_CASES = [
    # B, S, T, H, K, D, causal, window, dtype  (tests/test_kernels.py)
    (2, 128, 128, 8, 2, 32, True, 0, "float32"),
    (1, 256, 256, 4, 4, 64, True, 0, "float32"),
    (2, 128, 128, 6, 1, 32, False, 0, "float32"),   # MQA, bidirectional
    (1, 256, 256, 8, 2, 32, True, 64, "float32"),   # sliding window
    (1, 128, 128, 4, 2, 64, True, 0, "bfloat16"),
    (1, 64, 64, 2, 2, 128, True, 32, "float32"),    # head_dim 128
]


def _qkv(B, S, T, H, K, D, seed=7):
    r = np.random.RandomState(seed)
    return (r.standard_normal((B, S, H, D)).astype(np.float32),
            r.standard_normal((B, T, K, D)).astype(np.float32),
            r.standard_normal((B, T, K, D)).astype(np.float32))


@pytest.mark.parametrize("B,S,T,H,K,D,causal,window,dtype", ATTN_CASES)
def test_flash_attention_matches_reference_kernel(B, S, T, H, K, D, causal,
                                                  window, dtype):
    q, k, v = _qkv(B, S, T, H, K, D)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = ref_ops.attention(
        jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
        jnp.asarray(v).astype(jdt), causal=causal, window=window,
        impl="pallas", block_q=64, block_k=64, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    want = np.asarray(want.astype(jnp.float32))
    for fn in (flash_attention, attention_plain, ref.attention_ref):
        got = fn(tq, tk, tv, causal=causal, window=window)
        assert got.dtype == tdt and got.shape == (B, S, H, D)
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol, err_msg=fn.__name__)


def test_flash_attention_softcap_matches_reference_kernel():
    q, k, v = _qkv(1, 128, 128, 4, 2, 32, seed=3)
    want = ref_ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             softcap=30.0, impl="pallas", block_q=64,
                             block_k=64, interpret=True)
    got = ops.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                        softcap=30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_attention_ragged_and_unequal_lengths():
    """No divisibility needed (a superset of the reference's assertion), and
    S != T is allowed: plain version == oracle."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 50, 77, 6, 2, 32))
    a = flash_attention(q, k, v, causal=False)
    b = ref.attention_ref(q, k, v, causal=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-5)


def test_flash_wrapper_rejects_bad_inputs_and_counts_no_cpu_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 4, 2, 32))
    before = dict(ops.launch_counts())
    flash_attention(q, k, v)
    assert ops.launch_counts() == before        # CPU: the plain version ran
    with pytest.raises(ValueError):
        flash_attention(q[:, :, :3], k, v)      # 3 heads over 2 kv heads
    with pytest.raises(TypeError):
        flash_attention(q.bfloat16(), k, v)
    with pytest.raises(ValueError):
        ops.attention(q, k, v, impl="pallas")


def test_kernel_wrappers_refuse_misaligned_tensors():
    """The warpgroup kernels read q, k, v through TMA tensor maps (and the
    others with 16-byte vector loads): a base pointer off a 16-byte boundary
    -- a contiguous view with an odd storage offset -- must be refused
    before any launch."""
    from repro_torch.kernels.flash_attention import check_aligned
    base = torch.zeros(4 * 64 + 8, dtype=torch.bfloat16)
    check_aligned(base, base[8:])               # 16 bytes in: fine
    for view in (base[1:], base[4:]):           # 2 and 8 bytes in
        assert view.is_contiguous()
        with pytest.raises(ValueError, match="16-byte aligned"):
            check_aligned(base, view)


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------
def _paged_inputs(B, T, D, G, K, ps, lengths, seed=0):
    """Random q + paged K/V pool with per-row exclusive, shuffled tables."""
    H = G * K
    P = T // ps
    n_pages = B * P + 1                      # +1 unreferenced page
    r = np.random.RandomState(seed)
    q = r.standard_normal((B, H, D)).astype(np.float32)
    kp = r.standard_normal((n_pages, ps, K, D)).astype(np.float32)
    vp = r.standard_normal((n_pages, ps, K, D)).astype(np.float32)
    tables = r.permutation(B * P).reshape(B, P).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


PAGED_CASES = [
    # B, T, D, G, K, page_size, block_k, lengths (tests/test_paged_attention)
    (2, 64, 32, 2, 2, 16, 32, [64, 40]),       # ragged, mid-page end
    (1, 128, 64, 1, 4, 16, 48, [96]),          # non-pow2 ppb=3, MHA
    (4, 64, 32, 4, 1, 8, 256, [64, 8, 17, 33]),  # MQA, block_k > T clamps
    (2, 64, 32, 2, 2, 16, 16, [16, 32]),       # exact page boundaries
    (3, 32, 64, 2, 2, 8, 8, [1, 31, 32]),      # single-token history
]


def _both_paged(inputs, bk, softcap=0.0):
    want = ref_paged_decode_attention(
        *(jnp.asarray(a) for a in inputs), block_k=bk, softcap=softcap,
        interpret=True)
    t = [torch.from_numpy(a) for a in inputs]
    got = paged_decode_attention(*t, block_k=bk, softcap=softcap)
    return np.asarray(want), got.numpy(), t


@pytest.mark.parametrize("B,T,D,G,K,ps,bk,lengths", PAGED_CASES)
def test_paged_attention_matches_reference_kernel(B, T, D, G, K, ps, bk,
                                                  lengths):
    inputs = _paged_inputs(B, T, D, G, K, ps, lengths)
    want, got, t = _both_paged(inputs, bk)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    oracle = ref.paged_attention_ref(*t)
    np.testing.assert_allclose(got, oracle.numpy(), atol=1e-5, rtol=1e-5)


def test_paged_zero_length_row_is_zero_and_finite():
    inputs = _paged_inputs(2, 64, 32, 2, 2, 16, [0, 64])
    want, got, _ = _both_paged(inputs, 32)
    assert np.isfinite(got).all()
    assert np.all(got[0] == 0)               # empty history -> zeros
    assert np.all(want[0] == 0)              # as the reference kernel gives
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=1e-5)


def test_paged_softcap_matches_reference_kernel():
    inputs = _paged_inputs(2, 64, 32, 2, 2, 16, [64, 50])
    want, got, _ = _both_paged(inputs, 32, softcap=30.0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_paged_ignores_slots_past_lengths():
    """Garbage in every slot at or past ``lengths[b]`` (stale K/V of a
    recycled page) and in the unreferenced page must not change the result.
    (Finite garbage here: the plain version masks dead slots; the CUDA
    kernel never reads them, which ``chip_smoke.py`` checks with NaNs.)"""
    q, kp, vp, tables, lens = _paged_inputs(2, 64, 32, 2, 2, 16, [40, 17])
    clean = paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, tables, lens)))
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[-1] = vp2[-1] = 1e30
    for b, n in enumerate(lens):
        for t in range(n, 64):
            kp2[tables[b, t // 16], t % 16] = 1e30
            vp2[tables[b, t // 16], t % 16] = -1e30
    dirty = paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp2, vp2, tables, lens)))
    assert torch.isfinite(dirty).all()
    assert torch.equal(clean, dirty)


def test_paged_ops_dispatch_and_checks():
    inputs = [torch.from_numpy(a) for a in
              _paged_inputs(2, 64, 32, 2, 2, 16, [64, 40])]
    a = ops.paged_attention(*inputs, impl="kernel")
    b = ops.paged_attention(*inputs, impl="plain")
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        ops.paged_attention(*inputs, impl="xla")
    with pytest.raises(ValueError):
        paged_decode_attention(inputs[0][:, :3], *inputs[1:])
    with pytest.raises(ValueError):
        paged_decode_attention(*inputs[:4], inputs[4][:1])


# ---------------------------------------------------------------------------
# the differentiable path (stats-emitting forward, dK/dV, dQ)
# ---------------------------------------------------------------------------
BWD_CASES = [
    # B, S, T, H, K, D, causal, window, softcap
    (2, 128, 128, 4, 2, 32, True, 0, 0.0),     # tests/test_kernels_bwd.py
    (1, 128, 128, 4, 4, 64, True, 0, 0.0),     # MHA
    (1, 128, 128, 6, 1, 32, False, 0, 0.0),    # MQA, bidirectional
    (1, 256, 256, 4, 2, 32, True, 64, 0.0),    # sliding window
    (1, 50, 77, 6, 2, 32, True, 0, 0.0),       # S < T, ragged
    (1, 77, 50, 6, 3, 32, True, 0, 0.0),       # S > T, ragged
    (2, 70, 70, 6, 1, 64, True, 30, 30.0),     # MQA, window, soft-cap
    (1, 128, 128, 4, 2, 32, True, 0, 30.0),    # soft-cap
]


def _bwd_inputs(B, S, T, H, K, D, seed=11):
    r = np.random.RandomState(seed)
    return (r.standard_normal((B, S, H, D)).astype(np.float32),
            r.standard_normal((B, T, K, D)).astype(np.float32),
            r.standard_normal((B, T, K, D)).astype(np.float32),
            r.standard_normal((B, S, H, D)).astype(np.float32))


def _port_grads(q, k, v, ct, causal, window, softcap):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fab.flash_attention_vjp(*leaves, causal, window, softcap)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), leaves)
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_grads(fn, q, k, v, ct):
    return [np.asarray(g) for g in jax.grad(
        lambda q, k, v: jnp.sum(fn(q, k, v) * ct), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _oracle_grads(q, k, v, ct, causal, window, softcap):
    return _jax_grads(lambda q, k, v: ref_attention_ref(
        q, k, v, causal=causal, window=window, softcap=softcap), q, k, v, ct)


@pytest.mark.parametrize("B,S,T,H,K,D,causal,window,softcap", BWD_CASES)
def test_flash_vjp_grads_match_the_reference_oracle(B, S, T, H, K, D, causal,
                                                    window, softcap):
    q, k, v, ct = _bwd_inputs(B, S, T, H, K, D)
    out, got = _port_grads(q, k, v, ct, causal, window, softcap)
    want = _oracle_grads(q, k, v, ct, causal, window, softcap)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=5e-4, err_msg=name)
    # its forward is the forward-only path's output
    t = [torch.from_numpy(a) for a in (q, k, v)]
    np.testing.assert_allclose(
        out, flash_attention(*t, causal=causal, window=window,
                             softcap=softcap).numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", [0, 3])
def test_flash_vjp_matches_the_reference_kernels_without_softcap(case):
    """Against the reference's Pallas backward in interpret mode, as
    tests/test_kernels_bwd.py runs it (blocks 64/64)."""
    B, S, T, H, K, D, causal, window, _ = BWD_CASES[case]
    q, k, v, ct = _bwd_inputs(B, S, T, H, K, D)
    _, got = _port_grads(q, k, v, ct, causal, window, 0.0)
    want = _jax_grads(lambda q, k, v: ref_flash_attention_vjp(
        q, k, v, causal, window, 0.0, 64, 64, True), q, k, v, ct)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=5e-4, err_msg=name)


def test_reference_softcap_backward_is_wrong_and_the_port_is_not():
    """The reference kernel scales dS by 1 - tanh(s/c)**2 with s the score
    *after* the cap (flash_attention_bwd.py:156-160, :204-206); the exact
    factor is 1 - (s/c)**2.  At c = 5 its dq and dk miss jax.grad of the
    oracle by more than 1e-2 (gradients of max-abs ~2); the port matches the
    oracle at 5e-4."""
    q, k, v, ct = _bwd_inputs(1, 128, 128, 4, 2, 32)
    want = _oracle_grads(q, k, v, ct, True, 0, 5.0)
    _, got = _port_grads(q, k, v, ct, True, 0, 5.0)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=5e-4, err_msg=name)
    ref = _jax_grads(lambda q, k, v: ref_flash_attention_vjp(
        q, k, v, True, 0, 5.0, 64, 64, True), q, k, v, ct)
    assert np.abs(ref[0] - want[0]).max() > 1e-2         # dq
    assert np.abs(ref[1] - want[1]).max() > 1e-2         # dk
    np.testing.assert_allclose(ref[2], want[2], atol=5e-4, rtol=5e-4)  # dv


def test_stats_and_backward_plain_versions_agree_with_autograd():
    """The plain versions the CUDA kernels are held against on the card:
    stats give the softmax back, and the backward equals autograd of the
    plain forward, in fp32 and bf16."""
    q, k, v, ct = (torch.from_numpy(a) for a in _bwd_inputs(2, 40, 56, 6, 2,
                                                          32))
    for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        tq, tk, tv, tct = (x.to(dt) for x in (q, k, v, ct))
        kw = dict(causal=True, window=9, softcap=20.0)
        o, m, l = fab.attention_fwd_stats_plain(tq, tk, tv, **kw)
        assert m.shape == l.shape == (2, 40, 6) and m.dtype == torch.float32
        assert torch.equal(o, attention_plain(tq, tk, tv, **kw))
        delta = fab.attention_delta(o, tct)
        dq, dk, dv = fab.attention_bwd_plain(tq, tk, tv, tct, m, l, delta,
                                             **kw)
        assert (dq.dtype, dk.dtype, dv.dtype) == (dt, dt, dt)
        leaves = [x.float().clone().requires_grad_() for x in (tq, tk, tv)]
        want = torch.autograd.grad(
            (attention_plain(*leaves, **kw) * tct.float()).sum(), leaves)
        for a, b in zip((dq, dk, dv), want):
            np.testing.assert_allclose(a.float().numpy(), b.numpy(),
                                       atol=tol, rtol=tol)


def test_a_query_row_with_no_live_key_gets_zero_gradients():
    q, k, v, ct = (torch.from_numpy(a) for a in _bwd_inputs(1, 40, 8, 2, 1,
                                                          32))
    kw = dict(causal=True, window=4, softcap=0.0)  # rows 11.. see no key
    _, m, l = fab.flash_attention_fwd_stats(q, k, v, **kw)
    delta = torch.zeros_like(m)
    dq = fab.flash_attention_bwd_dq(q, k, v, ct, m, l, delta, **kw)
    assert torch.isfinite(dq).all() and (dq[:, 11:] == 0).all()
    assert (dq[:, :11].abs() > 0).any()


def test_forward_only_wrappers_raise_where_autograd_needs_a_gradient():
    """Fault 1 of the first slice: the forward-only kernel's output has no
    grad_fn, so a backward through it gave q/k/v no gradient and no error.
    The wrappers now refuse, on either device; ops.attention takes the
    differentiable path instead."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 4, 2, 32))
    qg = q.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(qg, k, v)
    with torch.no_grad():
        flash_attention(qg, k, v)                    # no gradient needed
    pin = [torch.from_numpy(a) for a in
           _paged_inputs(2, 64, 32, 2, 2, 16, [64, 40])]
    with pytest.raises(RuntimeError, match="forward-only"):
        paged_decode_attention(pin[0].requires_grad_(), *pin[1:])
    before = dict(ops.launch_counts())
    out = ops.attention(qg, k, v)
    (g,) = torch.autograd.grad(out.sum(), [qg])
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    assert ops.launch_counts() == before         # CPU: the plain versions


def test_backward_wrappers_check_their_statistics():
    q, k, v, ct = (torch.from_numpy(a) for a in _bwd_inputs(1, 8, 8, 4, 2,
                                                          32))
    _, m, l = fab.flash_attention_fwd_stats(q, k, v)
    with pytest.raises(ValueError):
        fab.flash_attention_bwd_dkv(q, k, v, ct, m[:, :4], l, m)
    with pytest.raises(ValueError):
        fab.flash_attention_bwd_dq(q, k, v, ct, m.double(), l, m)


def test_launch_counters_cover_all_five_wrappers():
    counts = ops.launch_counts()
    assert sorted(counts) == sorted([
        "flash_attention", "paged_decode_attention",
        "flash_attention_fwd_stats", "flash_attention_bwd_dkv",
        "flash_attention_bwd_dq", "ssd", "ssd_bwd", "rglru", "rglru_bwd"])
    fab.flash_attention_bwd_dq.launches += 3
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# on the card (skipped where there is none)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card "
                    "(python3 chip_smoke.py holds them against their plain "
                    "versions there)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_the_card(cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _qkv(1, 100, 77, 6, 2, 64))
    got = flash_attention(q, k, v)
    np.testing.assert_allclose(got.cpu().numpy(),
                               attention_plain(q, k, v).cpu().numpy(),
                               atol=2e-5, rtol=2e-5)
    t = [torch.from_numpy(a).to(cuda_device)
         for a in _paged_inputs(3, 32, 64, 2, 2, 8, [1, 31, 0])]
    got = paged_decode_attention(*t)
    np.testing.assert_allclose(got.cpu().numpy(),
                               paged_attention_plain(*t).cpu().numpy(),
                               atol=1e-5, rtol=1e-5)
    assert ops.launch_counts()["flash_attention"] > 0
    q, k, v, ct = (torch.from_numpy(a).to(cuda_device)
                   for a in _bwd_inputs(1, 100, 77, 6, 2, 64))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad((ops.attention(*leaves) * ct).sum(), leaves)
    want = torch.autograd.grad((attention_plain(*leaves) * ct).sum(), leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=5e-4, rtol=5e-4)
    assert ops.launch_counts()["flash_attention_bwd_dkv"] > 0


@pytest.mark.gpu
def test_warpgroup_designs_match_plain_versions_on_the_card(cuda_device):
    """bf16 at D = 64, 128 and 160 runs on the warpgroup designs: the
    forward (with statistics), dK/dV and dQ against their plain versions,
    several 128-key tiles, G = 3, ragged S; the served forward at D = 256
    (64-key tiles) under a window with G = 10 and ragged S; the
    chunk-parallel SSD at a ragged multi-chunk shape on the tensor cores,
    against its plain version."""
    from repro_torch.kernels.flash_attention import design
    from repro_torch.kernels.ssd import design as ssd_design
    from repro_torch.kernels.ssd import ssd, ssd_plain
    bf16 = torch.bfloat16
    assert design(128, bf16) == design(64, bf16) == "wgmma"
    assert fab.design_dkv(128, bf16) == "wgmma"
    assert fab.design_dq(128, bf16) == fab.design_dq(64, bf16) == "wgmma"
    assert design(32, bf16) == fab.design_dkv(32, bf16) == "mma.sync"
    assert fab.design_dq(32, bf16) == "mma.sync"
    assert design(160, bf16) == fab.design_dkv(160, bf16) == "wgmma"
    assert design(256, bf16) == fab.design_dq(160, bf16) == "wgmma"
    assert ssd_design(64, 128, bf16) == "mma.sync"
    for D in (64, 128, 160):
        q, k, v, ct = (torch.from_numpy(a).to(cuda_device, bf16)
                       for a in _bwd_inputs(2, 300, 300, 6, 2, D))
        kw = dict(causal=True, window=0, softcap=0.0)
        o, m, l = fab.flash_attention_fwd_stats(q, k, v, **kw)
        o2, m2, l2 = fab.attention_fwd_stats_plain(q, k, v, **kw)
        for a, b in ((o, o2), (m, m2), (l, l2)):
            np.testing.assert_allclose(a.float().cpu().numpy(),
                                       b.float().cpu().numpy(), atol=2e-2,
                                       rtol=2e-2)
        delta = fab.attention_delta(o, ct)
        got = fab.flash_attention_bwd_dkv(q, k, v, ct, m, l, delta, **kw)
        got += (fab.flash_attention_bwd_dq(q, k, v, ct, m, l, delta, **kw),)
        dq, dk, dv = fab.attention_bwd_plain(q, k, v, ct, m, l, delta, **kw)
        for a, b in zip(got, (dk, dv, dq)):
            np.testing.assert_allclose(a.float().cpu().numpy(),
                                       b.float().cpu().numpy(), atol=2e-2,
                                       rtol=2e-2)
    q, k, v = (torch.from_numpy(a).to(cuda_device, bf16)
               for a in _qkv(1, 300, 300, 10, 1, 256))
    for softcap in (0.0, 30.0):
        kw = dict(causal=True, window=50, softcap=softcap)
        np.testing.assert_allclose(
            flash_attention(q, k, v, **kw).float().cpu().numpy(),
            attention_plain(q, k, v, **kw).float().cpu().numpy(), atol=2e-2,
            rtol=2e-2)
    # SSD: S = 200 is three chunks and a ragged fourth, G = 3
    r = np.random.RandomState(5)
    B, S, H, P, G, N = 2, 200, 6, 64, 3, 128
    x = torch.from_numpy(r.standard_normal((B, S, H, P)).astype(np.float32))
    dt = torch.nn.functional.softplus(
        torch.from_numpy(r.standard_normal((B, S, H)).astype(np.float32)))
    A = -torch.exp(torch.from_numpy(r.standard_normal(H).astype(np.float32)))
    Bm, Cm = (torch.from_numpy((r.standard_normal((B, S, G, N)) * 0.5)
                               .astype(np.float32)) for _ in range(2))
    ins = [t.to(cuda_device) for t in (x, dt, A, Bm, Cm)]
    for i in (0, 3, 4):
        ins[i] = ins[i].to(bf16)
    got = ssd(*ins)
    want = ssd_plain(*ins)
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=2e-4 * scale, rtol=0)
