"""Dispatch wrappers ``impl="kernel" | "plain"`` per kernel, held against
``repro/kernels/ops.py`` (same signatures minus ``interpret``): attention
(B1, and B2 under autograd), paged decode attention (B3), the Mamba-2 SSD
scan (B4) and the RG-LRU recurrence (B5).

``"kernel"`` is the hand-written CUDA kernel (for a CPU tensor, the plain
version beside it -- the wrappers decide that by the tensor's device alone);
``"plain"`` is the plain PyTorch version wherever the tensors lie.  The block
and chunk arguments are the reference's TPU tiling knobs: accepted and
ignored until the autotuner is ported (``ssd``'s plain version takes the
reference's default chunk of 256).

``attention(impl="kernel")`` goes through ``FlashAttentionFn`` (the
stats-emitting forward, then the dK/dV and dQ kernels in the backward) when
autograd needs a gradient of q, k or v -- the reference's
``impl="pallas_vjp"`` -- and through the forward-only kernel otherwise.
``rglru(impl="kernel")`` and ``ssd(impl="kernel")`` go the same way
through ``RGLRUFn`` and ``SSDFn`` (the forward kernel, then a hand-written
backward kernel; the reference has none and differentiates its XLA scans).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import rglru as _rg
from repro_torch.kernels import ssd as _sd

IMPLS = ("kernel", "plain")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")


def attention(q, k, v, *, causal=True, window=0, softcap=0.0, impl="kernel",
              block_q=None, block_k=None):
    """q (B,S,H,D); k/v (B,T,K,D) -> (B,S,H,D)."""
    del block_q, block_k
    _check_impl(impl)
    if impl == "plain":
        return _fa.attention_plain(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if _fa.needs_grad(q, k, v):
        return _fab.flash_attention_vjp(q, k, v, causal, window, softcap)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)


def paged_attention(q, k_pages, v_pages, tables, lengths, *, softcap=0.0,
                    impl="kernel", block_k=None):
    """Decode attention straight off the paged KV pool.

    q (B,H,D); k/v pages (N,ps,K,D); tables (B,P) int32; lengths (B,)."""
    _check_impl(impl)
    if impl == "plain":
        return _pa.paged_attention_plain(q, k_pages, v_pages, tables,
                                         lengths, softcap=softcap)
    return _pa.paged_decode_attention(q, k_pages, v_pages, tables, lengths,
                                      block_k=block_k, softcap=softcap)


def ssd(x, dt, A, Bm, Cm, *, chunk=None, impl="kernel"):
    """Mamba-2 chunked SSD.  x (B,S,H,P); dt (B,S,H); A (H,); B/C
    (B,S,G,N) -> (y (B,S,H,P) fp32, h_final (B,H,N,P) fp32)."""
    _check_impl(impl)
    chunk = _sd.CHUNK if chunk is None else chunk
    if impl == "plain":
        return _sd.ssd_plain(x, dt, A, Bm, Cm, chunk=chunk)
    if _fa.needs_grad(x, dt, A, Bm, Cm):
        return _sd.SSDFn.apply(x, dt, A, Bm, Cm, None, chunk)
    return _sd.ssd(x, dt, A, Bm, Cm, chunk=chunk)


def rglru(log_a, gated, *, block_seq=None, impl="kernel"):
    """h_t = exp(log_a_t) * h_{t-1} + gated_t.  log_a/gated (B,S,W) -> hs
    (B,S,W) fp32."""
    del block_seq
    _check_impl(impl)
    if impl == "plain":
        return _rg.rglru_plain(log_a, gated)
    if _fa.needs_grad(log_a, gated):
        return _rg.RGLRUFn.apply(log_a, gated, None)
    return _rg.rglru(log_a, gated)


# ---------------------------------------------------------------------------
# launch counters (one plain integer on each wrapper)
# ---------------------------------------------------------------------------
_WRAPPERS = (_fa.flash_attention, _pa.paged_decode_attention,
             _fab.flash_attention_fwd_stats, _fab.flash_attention_bwd_dkv,
             _fab.flash_attention_bwd_dq, _sd.ssd, _sd.ssd_bwd, _rg.rglru,
             _rg.rglru_bwd)


def launch_counts() -> Dict[str, int]:
    return {w.__name__: w.launches for w in _WRAPPERS}


def reset_launch_counts() -> None:
    for w in _WRAPPERS:
        w.launches = 0


def add_launch_counts(delta: Dict[str, int]) -> None:
    """Add ``delta`` (wrapper name -> launches) to the counts: a replayed
    CUDA graph calls no wrapper, so the serving graphs add what their
    capture recorded (``serve/graphs.py``)."""
    for w in _WRAPPERS:
        w.launches += delta.get(w.__name__, 0)
