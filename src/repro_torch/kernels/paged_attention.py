"""Paged decode attention: wrapper of the CUDA kernel
``csrc/paged_attention.cu`` and, beside it, its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/paged_attention.py``
(``paged_decode_attention`` / ``_paged_kernel``): one decode token per
sequence attends over K/V read *directly from the page pool*
(``serve/kvcache.PagePool`` layout ``(n_pages + 1, page_size, K, D)`` per
layer) through per-sequence block tables, so the decode step never builds the
dense ``(B, W, K, D)`` view that ``kvcache.gather_dense`` makes.

On this card the function is bounded by bytes: every live K/V byte is read
once and used by the G heads of one group only.  The kernel splits each
row's token axis into pieces of whole pages (``split_pieces``: ``block_k``
tokens rounded down to whole pages, ``PIECE_TOKENS`` by default), runs one
block per (piece, kv head, sequence) -- a block whose piece starts at or
past ``lengths[b]`` returns at once, so no page past it is read -- writes
each piece's fp32 partial ``(m, l, acc)`` to a workspace that the wrapper
allocates, and merges the live pieces in a second launch from the same C
call.  The number of pieces follows from the table width alone, so the host
never reads ``lengths``.  The source note in the ``.cu`` file has the rest.

``paged_decode_attention`` launches the kernel for CUDA tensors -- or raises:
there is no fallback -- and runs ``paged_attention_plain`` only for tensors
that lie on the CPU.  ``paged_decode_attention.launches`` counts calls that
launched (one per call: the pieces and their merge), and
``paged_decode_attention.last_split`` holds the last launch's ``(pages a
piece, pieces)``.
It has no backward, and raises on either device where autograd would need a
gradient of q or the pages.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import check_aligned, needs_grad

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 160)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# tokens a piece of the split-KV kernel aims at (rounded to whole pages)
# where no ``block_k`` is given
PIECE_TOKENS = 128
# page ids a block of the kernel stages (csrc/paged_attention.cu)
MAX_PIECE_PAGES = 128

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load().repro_paged_decode_attention
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        _fn = fn
    return _fn


def split_pieces(P: int, page_size: int, piece_tokens: int = PIECE_TOKENS):
    """(pages per piece, pieces) of the split-KV kernel for a table of
    ``P`` pages: pieces of ``piece_tokens`` tokens rounded down to whole
    pages (at least one), enough of them to cover the table.  Raises where
    a piece would be more than ``MAX_PIECE_PAGES`` pages."""
    pages = max(1, piece_tokens // page_size)
    if pages > MAX_PIECE_PAGES:
        raise ValueError(f"paged_decode_attention: a piece of {piece_tokens} "
                         f"tokens is {pages} pages of {page_size}; the "
                         f"kernel stages at most {MAX_PIECE_PAGES}")
    return pages, -(-P // pages)


def paged_attention_plain(q, k_pages, v_pages, tables, lengths, *,
                          softcap: float = 0.0):
    """The kernel's arithmetic in plain PyTorch: gather the tables into the
    dense view, mask slot ``t`` unless ``t < lengths[b]``, fp32 softmax cast
    to V's dtype before the PV product.  A zero-length row gives zeros.

    q (B,H,D); k/v pages (N,ps,K,D); tables (B,P); lengths (B,) -> (B,H,D).
    """
    B, H, D = q.shape
    ps, K = k_pages.shape[1], k_pages.shape[2]
    P = tables.shape[1]
    G = H // K
    idx = tables.long()
    k = k_pages[idx].reshape(B, P * ps, K, D)
    v = v_pages[idx].reshape(B, P * ps, K, D)
    qg = q.reshape(B, K, G, D)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float())
    s = s * (1.0 / math.sqrt(D))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    t = torch.arange(P * ps, device=q.device)[None, :]
    live = t < lengths.long()[:, None]                       # (B, T)
    s = s.masked_fill(~live[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    # an empty history has no live slot: the kernel's l = 0 gives zeros
    p = (p * live[:, None, None, :]).to(v.dtype)
    o = torch.einsum("bkgt,btkd->bkgd", p, v)
    return o.reshape(B, H, D).to(q.dtype)


def _check(q, k_pages, v_pages, tables, lengths):
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"paged_decode_attention: want q (B,H,D), pages (N,ps,K,D); got "
            f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
            f"{tuple(v_pages.shape)}")
    B, H, D = q.shape
    if k_pages.shape[3] != D or H % k_pages.shape[2]:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} and "
                         f"pages {tuple(k_pages.shape)} do not form GQA "
                         f"groups")
    if tables.dim() != 2 or tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"paged_decode_attention: want tables (B,P) and "
                         f"lengths (B,); got {tuple(tables.shape)}, "
                         f"{tuple(lengths.shape)}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError("paged_decode_attention: q and pages must share one "
                        "dtype")
    devs = {t.device for t in (q, k_pages, v_pages, tables, lengths)}
    if len(devs) != 1:
        raise ValueError(f"paged_decode_attention: tensors on {devs}")


def paged_decode_attention(q, k_pages, v_pages, tables, lengths, *,
                           block_k=None, softcap: float = 0.0):
    """q (B,H,D) one decode token per sequence; k/v pages (N,ps,K,D); tables
    (B,P) page ids; lengths (B,) valid-token counts -> (B,H,D).

    ``block_k`` is the tokens a split-KV piece, rounded down to whole pages
    (``split_pieces``); None means ``PIECE_TOKENS``.  A value under one page,
    or over ``MAX_PIECE_PAGES`` pages, raises on either device.
    """
    _check(q, k_pages, v_pages, tables, lengths)
    ps = k_pages.shape[1]
    if block_k is None:
        block_k = PIECE_TOKENS
    elif block_k < ps:
        raise ValueError(f"paged_decode_attention: block_k={block_k} tokens "
                         f"fit no whole page of {ps}")
    pages, n_pieces = split_pieces(tables.shape[1], ps, block_k)
    if needs_grad(q, k_pages, v_pages):
        raise RuntimeError(
            "paged_decode_attention is forward-only (a decode step) and "
            "q/pages need a gradient: run it under torch.no_grad()")
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, tables, lengths,
                                     softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    B, H, D = q.shape
    K, P = k_pages.shape[2], tables.shape[1]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_decode_attention kernel takes float32 or "
                        f"bfloat16, not {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged_decode_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, not {D}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode_attention kernel takes int32 tables "
                        "and lengths")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention kernel takes a "
                             f"contiguous {name}")
    check_aligned(q, k_pages, v_pages)     # 16-byte copies of every row
    out = torch.empty_like(q)
    # each piece's (m, l, acc[G][D]) partial, fp32, from the caching
    # allocator: no cudaMalloc and no host sync in a decode step
    ws = torch.empty(B * H * n_pieces * (D + 2), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        fn = _kernel()
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                ws.data_ptr(), B, H, K, D, ps, P, pages, n_pieces,
                _DTYPE_CODE[q.dtype], float(softcap),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"paged_decode_attention kernel launch failed (code {rc}) for q "
            f"{tuple(q.shape)} pages {tuple(k_pages.shape)} {q.dtype}")
    paged_decode_attention.launches += 1
    paged_decode_attention.last_split = (pages, n_pieces)
    return out


paged_decode_attention.launches = 0
paged_decode_attention.last_split = None
