"""Dispatch wrappers ``impl="kernel" | "plain"`` per kernel, held against
``repro/kernels/ops.py`` (same signatures minus ``interpret``).

``"kernel"`` is the hand-written CUDA kernel (for a CPU tensor, the plain
version beside it -- the wrappers decide that by the tensor's device alone);
``"plain"`` is the plain PyTorch version wherever the tensors lie.  The block
arguments are the reference's TPU tiling knobs: accepted and ignored until
the autotuner is ported.

``attention(impl="kernel")`` goes through ``FlashAttentionFn`` (the
stats-emitting forward, then the dK/dV and dQ kernels in the backward) when
autograd needs a gradient of q, k or v -- the reference's
``impl="pallas_vjp"`` -- and through the forward-only kernel otherwise.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import paged_attention as _pa

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


# ---------------------------------------------------------------------------
# launch counters (one plain integer on each wrapper)
# ---------------------------------------------------------------------------
_WRAPPERS = (_fa.flash_attention, _pa.paged_decode_attention,
             _fab.flash_attention_fwd_stats, _fab.flash_attention_bwd_dkv,
             _fab.flash_attention_bwd_dq)


def launch_counts() -> Dict[str, int]:
    return {w.__name__: w.launches for w in _WRAPPERS}


def reset_launch_counts() -> None:
    for w in _WRAPPERS:
        w.launches = 0
