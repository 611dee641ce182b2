"""Dispatch wrappers ``impl="kernel" | "plain"`` per kernel, held against
``repro/kernels/ops.py`` (same signatures minus ``interpret``): attention
(B1, and B2 under autograd), paged decode attention (B3), the Mamba-2 SSD
scan (B4) and the RG-LRU recurrence (B5).

``"kernel"`` is the hand-written CUDA kernel (for a CPU tensor, the plain
version beside it -- the wrappers decide that by the tensor's device alone);
``"plain"`` is the plain PyTorch version wherever the tensors lie.

The tiling knobs.  A knob left at ``None`` resolves on the host, when the
kernel is called, from the tuned-config registry (``kernels.registry``,
filled on the card by ``kernels.autotune``), as the reference's dispatch
does; with no registry installed every kernel launches as it does untuned.
``paged_attention(block_k=)`` is the tokens a split-KV piece (whole pages;
``paged_attention.PIECE_TOKENS`` on a miss); ``rglru(block_seq=)`` the
forward scan's steps a chunk (``rglru.fit_chunk`` of it; ``rglru.CHUNK`` on
a miss); ``ssd(chunk=)`` the plain version's chunk (the reference's 256 on a
miss; the kernel runs its own ``ssd.KERNEL_CHUNK``).  Neither a tuned value
nor a default is fitted to the shape: the port's kernels take any S and cut
whole pages themselves (the reference's resolvers in ``kernels.registry``
fit them to divide S or T, as its Pallas grids need; ``piece_tokens``,
``rglru_chunk`` and ``ssd_chunk`` here are the port's).  ``attention``'s
``block_q`` / ``block_k`` name the one tile the design for (head_dim, dtype)
launches (``flash_attention.tile``): ``None`` or that tile is accepted, any
other value raises, and the registry is not read, since it can hold no
other tile.  Inside a captured serving graph a resolution is paid once, at
capture.

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
from repro_torch.kernels import registry as _reg
from repro_torch.kernels import rglru as _rg
from repro_torch.kernels import ssd as _sd

IMPLS = ("kernel", "plain")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")


def attention(q, k, v, *, causal=True, window=0, softcap=0.0, impl="kernel",
              block_q=None, block_k=None):
    """q (B,S,H,D); k/v (B,T,K,D) -> (B,S,H,D)."""
    _check_impl(impl)
    _check_tile(q, block_q, block_k)
    if impl == "plain":
        return _fa.attention_plain(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if _fa.needs_grad(q, k, v):
        return _fab.flash_attention_vjp(q, k, v, causal, window, softcap)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)


def _check_tile(q, block_q, block_k):
    """``block_q`` / ``block_k`` each None or the design's own tile."""
    if block_q is None and block_k is None:
        return
    want = _fa.tile(q.shape[3], q.dtype)
    got = (want[0] if block_q is None and want else block_q,
           want[1] if block_k is None and want else block_k)
    if got != want:
        raise ValueError(
            f"attention: the design for head_dim {q.shape[3]} {q.dtype} "
            f"launches the tile (block_q, block_k) = {want}, not "
            f"({block_q}, {block_k})")


def paged_attention(q, k_pages, v_pages, tables, lengths, *, softcap=0.0,
                    impl="kernel", block_k=None):
    """Decode attention straight off the paged KV pool.

    q (B,H,D); k/v pages (N,ps,K,D); tables (B,P) int32; lengths (B,).
    ``block_k`` (tokens a split-KV piece): None resolves from the registry's
    ``decode_attention`` cell of (B, table tokens, D, G) (``piece_tokens``).
    """
    _check_impl(impl)
    if impl == "plain":
        return _pa.paged_attention_plain(q, k_pages, v_pages, tables,
                                         lengths, softcap=softcap)
    if block_k is None:
        block_k = piece_tokens(q.shape[0], tables.shape[1] * k_pages.shape[1],
                               q.shape[2], q.shape[1] // k_pages.shape[2],
                               q.dtype)
    return _pa.paged_decode_attention(q, k_pages, v_pages, tables, lengths,
                                      block_k=block_k, softcap=softcap)


def ssd(x, dt, A, Bm, Cm, *, chunk=None, impl="kernel"):
    """Mamba-2 chunked SSD.  x (B,S,H,P); dt (B,S,H); A (H,); B/C
    (B,S,G,N) -> (y (B,S,H,P) fp32, h_final (B,H,N,P) fp32)."""
    _check_impl(impl)
    if chunk is None:
        chunk = ssd_chunk(x.shape[1], x.shape[2], x.shape[3], Bm.shape[2],
                          Bm.shape[3], x.dtype)
    if impl == "plain":
        return _sd.ssd_plain(x, dt, A, Bm, Cm, chunk=chunk)
    if _fa.needs_grad(x, dt, A, Bm, Cm):
        return _sd.SSDFn.apply(x, dt, A, Bm, Cm, None, chunk)
    return _sd.ssd(x, dt, A, Bm, Cm, chunk=chunk)


def rglru(log_a, gated, *, block_seq=None, impl="kernel"):
    """h_t = exp(log_a_t) * h_{t-1} + gated_t.  log_a/gated (B,S,W) -> hs
    (B,S,W) fp32.  ``block_seq`` (the forward's steps a chunk): None
    resolves from the registry's ``rglru`` cell of (S, W) (``rglru_chunk``);
    a value given is fitted to the kernel (``rglru.fit_chunk``)."""
    _check_impl(impl)
    if impl == "plain":
        return _rg.rglru_plain(log_a, gated)
    chunk = (rglru_chunk(log_a.shape[1], log_a.shape[2], log_a.dtype)
             if block_seq is None else _rg.fit_chunk(block_seq))
    if _fa.needs_grad(log_a, gated):
        return _rg.RGLRUFn.apply(log_a, gated, None, chunk)
    return _rg.rglru(log_a, gated, chunk=chunk)


# ---------------------------------------------------------------------------
# the knobs at dispatch
# ---------------------------------------------------------------------------
def _tuned(kernel: str, knob: str, default: int, dtype, variant: str = "",
           **dims: int) -> int:
    """The active registry's ``knob`` for the cell, else ``default``; with
    no registry it returns at once."""
    reg = _reg.get_registry()
    if reg is None:
        return default
    return reg.lookup(kernel, {knob: default}, dtype=_reg._dtype_name(dtype),
                      variant=variant, **dims)[knob]


def piece_tokens(B: int, T: int, D: int, G: int, dtype) -> int:
    """Tokens a split-KV piece for a decode step of ``B`` rows over tables
    of ``T`` tokens: the registry's, else ``PIECE_TOKENS``."""
    return _tuned("decode_attention", "block_k", _pa.PIECE_TOKENS, dtype,
                  variant=_reg.attention_variant(True, 0), b=B, d=D, g=G,
                  t=T)


def rglru_chunk(S: int, W: int, dtype) -> int:
    """The RG-LRU forward's steps a chunk: the registry's ``block_seq``,
    else ``rglru.CHUNK``, as ``rglru.fit_chunk`` gives it to the kernel."""
    return _rg.fit_chunk(_tuned("rglru", "block_seq", _rg.CHUNK, dtype, s=S,
                                w=W))


def ssd_chunk(S: int, H: int, P: int, G: int, N: int, dtype) -> int:
    """The SSD plain version's chunk: the registry's, else ``ssd.CHUNK``."""
    return _tuned("ssd", "chunk", _sd.CHUNK, dtype, s=S, h=H, p=P, g=G, n=N)


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
