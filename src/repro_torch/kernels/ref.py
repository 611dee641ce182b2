"""Plain-PyTorch oracles for the kernels, held against
``repro/kernels/ref.py``.

Like the reference's, the attention oracles delegate to the model zoo's own
attention functions, so the kernels (and the plain versions kept beside
them) are validated against exactly the math the models serve with.  The
SSD and RG-LRU oracles are the plain versions beside their kernels: copies
of the reference model path's ``ssd_chunked`` and of ``rglru_scan``'s
combine rule.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru import rglru_plain
from repro_torch.kernels.ssd import ssd_plain
from repro_torch.models.attention import decode_attention, full_attention


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q (B,S,H,D); k/v (B,T,K,D) -> (B,S,H,D)."""
    return full_attention(q, k, v, causal=causal, window=window,
                          softcap=softcap)


def paged_attention_ref(q, k_pages, v_pages, tables, lengths, *,
                        softcap=0.0):
    """Dense oracle for the paged decode kernel: gather the block tables
    into the dense ``(B, T, K, D)`` cache view (what the engine's chunk path
    materialises), then run ``decode_attention`` with the positional mask
    the pool maintains.

    q (B,H,D); k/v pages (N,ps,K,D); tables (B,P) int; lengths (B,) valid
    token counts -> (B,H,D).
    """
    B = q.shape[0]
    ps = k_pages.shape[1]
    P = tables.shape[1]
    idx = tables.long()
    k = k_pages[idx].reshape((B, P * ps) + tuple(k_pages.shape[2:]))
    v = v_pages[idx].reshape((B, P * ps) + tuple(v_pages.shape[2:]))
    t = torch.arange(P * ps, dtype=torch.int32, device=q.device)[None, :]
    cache_pos = torch.where(t < lengths[:, None].to(torch.int32), t,
                            torch.full_like(t, -1))
    return decode_attention(q[:, None], k, v, cache_pos,
                            softcap=softcap)[:, 0]


ssd_ref = ssd_plain          # (x, dt, A, B, C, *, chunk, h0) -> (y, h_final)
rglru_ref = rglru_plain      # (log_a, gated, h0) -> hs
