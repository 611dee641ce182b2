"""Attention: projections + execution paths, held against
``repro/models/attention.py``.

Paths:
  * ``full``    -- materialises (S, T) scores; the oracle, and short
                   sequences (``attn_impl="full"``).
  * ``kernel``  -- cache-less prefill goes through the hand-written flash
                   attention kernel (``kernels.ops.attention``); a decode step
                   over the page pool goes through the paged decode kernel
                   (``kernels.ops.paged_attention``).
  * ``decode`` / ``chunk`` -- single-token / prompt-chunk attention over a
                   dense KV cache, plain PyTorch as in the reference.

All paths support GQA (H = K * G query groups), causal masking and sliding
windows (``attn_local`` blocks, ``window = cfg.local_window``): cache-less
prefill passes the window to the flash kernel where the reference runs
``local_flash_xla``; decode and chunked prefill keep a ring buffer of ``W =
min(local_window, max_seq)`` slots (slot = position % W).  Shapes: q (B, S,
H, D); k/v (B, T, Kh, D).  Caches are updated **in place** (``index_put_``)
where the reference builds new arrays with ``.at[].set``.

Not ported yet (asking for them raises ``NotImplementedError``): the mesh
paths ``sharded_decode`` / ``sharded_flash`` (ROADMAP queue A item 7, the
parallel layer).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers

NEG_INF = -1e30

_MESH = ("mesh-sharded attention is not ported yet: ROADMAP queue A item 7 "
         "(the parallel layer)")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """QKV/output projections in the reference's layouts:
    ``wq (d, H, hd)``, ``wk/wv (d, K, hd)``, ``wo (H, hd, d)``."""

    def __init__(self, cfg: ModelConfig, *, generator=None,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(dtype=dtype, device=device)
        self.wq = nn.Parameter(layers.dense_init(generator, (d, H, hd), **kw))
        self.wk = nn.Parameter(layers.dense_init(generator, (d, K, hd), **kw))
        self.wv = nn.Parameter(layers.dense_init(generator, (d, K, hd), **kw))
        self.wo = nn.Parameter(layers.dense_init(
            generator, (H, hd, d), scale=1.0 / math.sqrt(H * hd), **kw))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros((H, hd), **kw))
            self.bk = nn.Parameter(torch.zeros((K, hd), **kw))
            self.bv = nn.Parameter(torch.zeros((K, hd), **kw))
        if cfg.qk_norm:
            self.q_norm = layers.Norm("layernorm", hd, eps=cfg.norm_eps, **kw)
            self.k_norm = layers.Norm("layernorm", hd, eps=cfg.norm_eps, **kw)


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------
def _mask_value(q_pos, k_pos, causal: bool, window: int):
    """Additive mask for (..., Sq, Tk) given absolute positions."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    m = torch.zeros(diff.shape, dtype=torch.float32, device=diff.device)
    if causal:
        m = torch.where(diff < 0, NEG_INF, m)
    if window > 0:
        m = torch.where(diff >= window, NEG_INF, m)
    return m


def full_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                   kv_mask=None, softcap=0.0):
    """Oracle path. q (B,S,H,D), k/v (B,T,K,D)."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    s = s / math.sqrt(D)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(S, device=q.device) + q_offset
    k_pos = torch.arange(T, device=q.device)
    s = s + _mask_value(q_pos, k_pos, causal, window)
    if kv_mask is not None:  # (B, T) True = attend
        s = torch.where(kv_mask[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", p, v)
    return o.reshape(B, S, H, D)


def chunk_decode_attention(q, k_cache, v_cache, cache_pos, q_pos, *,
                           window=0, softcap=0.0):
    """Multi-token attention of a prompt *chunk* against a KV cache.

    q (B,S,H,D) is a contiguous chunk of new tokens at absolute positions
    ``q_pos`` (B,S); the caches (B,W,K,D) already contain the chunk's own
    K/V (written by the caller) plus all earlier history, with ``cache_pos``
    (B,W) giving each slot's absolute position (-1 = empty).  Masking is
    purely positional -- a query attends to every valid slot at a position
    <= its own (and within ``window``) -- so the result does not depend on
    how the prompt was chunked.  The chunked-prefill primitive of the
    serving stack.
    """
    B, S, H, D = q.shape
    K = k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                     k_cache.float()) / math.sqrt(D)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    valid = (cache_pos >= 0)[:, None, :]                  # (B,1,W)
    diff = q_pos[:, :, None] - cache_pos[:, None, :]      # (B,S,W)
    keep = valid & (diff >= 0)
    if window > 0:
        keep = keep & (diff < window)
    s = torch.where(keep[:, None, None, :, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", p, v_cache)
    return o.reshape(B, S, H, D)


def decode_attention(q, k_cache, v_cache, cache_pos, *, window=0,
                     softcap=0.0):
    """q (B,1,H,D); caches (B,W,K,D); cache_pos (B,W) absolute positions of
    each cache slot (-1 = empty)."""
    B, _, H, D = q.shape
    K = k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, D)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(),
                     k_cache.float()) / math.sqrt(D)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    valid = cache_pos >= 0
    if window > 0:
        cur = cache_pos.max(dim=-1, keepdim=True).values
        valid = valid & (cur - cache_pos < window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bkgt,btkd->bkgd", p, v_cache)
    return o.reshape(B, 1, H, D)


# ---------------------------------------------------------------------------
# block-level apply (projections + path dispatch + cache management)
# ---------------------------------------------------------------------------
def project_qkv(params: Attention, x, cfg: ModelConfig, positions,
                compute_dtype, rope=None):
    """``rope``: the (cos, sin) tables of ``layers.rope_tables`` for these
    positions in the compute dtype, where the caller made them once for all
    layers; computed here when absent."""
    cd = compute_dtype
    x = x.to(cd)
    d = x.shape[-1]
    B, S = x.shape[0], x.shape[1]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # einsum("bsd,dhe->bshe") as one matmul against the (d, H*hd) view
    q = (x @ params.wq.to(cd).reshape(d, H * hd)).view(B, S, H, hd)
    k = (x @ params.wk.to(cd).reshape(d, K * hd)).view(B, S, K, hd)
    v = (x @ params.wv.to(cd).reshape(d, K * hd)).view(B, S, K, hd)
    if cfg.qkv_bias:
        q = q + params.bq.to(cd)
        k = k + params.bk.to(cd)
        v = v + params.bv.to(cd)
    if cfg.qk_norm:
        q = layers.apply_norm(params.q_norm, q, "layernorm", cfg.norm_eps)
        k = layers.apply_norm(params.k_norm, k, "layernorm", cfg.norm_eps)
    if cfg.pos_embedding == "rope":
        if rope is None:
            rope = layers.rope_tables(positions, hd, q.dtype,
                                      fraction=cfg.rope_fraction,
                                      theta=cfg.rope_theta)
        q = layers.apply_rope(q, positions, fraction=cfg.rope_fraction,
                              theta=cfg.rope_theta, tables=rope)
        k = layers.apply_rope(k, positions, fraction=cfg.rope_fraction,
                              theta=cfg.rope_theta, tables=rope)
    return q, k, v


def _project_out(params: Attention, o, compute_dtype):
    """einsum("bshe,hed->bsd") as one matmul against the (H*hd, d) view."""
    cd = compute_dtype
    B, S, H, hd = o.shape
    return o.to(cd).reshape(B, S, H * hd) @ params.wo.to(cd).reshape(
        H * hd, -1)


@dataclasses.dataclass
class PagedDecodeCache:
    """One layer's view of the serving page pool for a decode step.

    ``k``/``v`` ``(n_pages + 1, page_size, K, D)`` and ``pos``
    ``(n_pages + 1, page_size)`` are that layer's pool tensors (written in
    place); ``tables`` (B, P) int32 page ids; ``slot`` (B,) int64 says where
    each row's new token goes, as ``page * page_size + offset`` into the
    pool flattened over (page, offset) (the scratch page for an invalid
    row); ``new_pos`` (B,) int32 is the position written there (-1 for an invalid
    row) and ``lengths`` (B,) int32 the live-token count *after* the write
    (0 for an invalid row).  The engine computes the index tensors once per
    step and shares them among the layers.
    """
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    tables: torch.Tensor
    slot: torch.Tensor
    new_pos: torch.Tensor
    lengths: torch.Tensor


def apply_attention(params: Attention, x, cfg: ModelConfig, *, local: bool,
                    positions, compute_dtype=torch.bfloat16, impl="kernel",
                    cache=None, kv_mask=None, cache_capacity: int = 0,
                    mesh=None, rope=None):
    """Returns (out (B,S,d_model), new_cache_or_None).

    cache (decode): dict(k=(B,W,K,D), v=(B,W,K,D), pos=(B,W) int32), updated
    in place and returned; or a ``PagedDecodeCache`` (single-token decode off
    the page pool).  For prefill (cache is the string "init"), returns the
    filled cache.
    """
    if mesh is not None:
        raise NotImplementedError(_MESH)
    window = cfg.local_window if local else 0
    B = x.shape[0]
    cd = compute_dtype

    if isinstance(cache, PagedDecodeCache):
        # ---- decode straight off the page pool (no dense view) ----
        if window > 0:
            raise ValueError("the page pool holds full-attention layers "
                             "only; windowed layers use ring caches")
        if x.shape[1] != 1:
            raise ValueError("the paged decode path takes one token per row")
        q, k_new, v_new = project_qkv(params, x, cfg, positions, cd, rope)
        n_slots = cache.k.shape[0] * cache.k.shape[1]
        kv_shape = (n_slots,) + tuple(cache.k.shape[2:])
        cache.k.view(kv_shape).index_copy_(0, cache.slot,
                                           k_new[:, 0].to(cache.k.dtype))
        cache.v.view(kv_shape).index_copy_(0, cache.slot,
                                           v_new[:, 0].to(cache.v.dtype))
        cache.pos.view(n_slots).index_copy_(0, cache.slot, cache.new_pos)
        o = ops.paged_attention(
            q[:, 0].contiguous(), cache.k, cache.v, cache.tables,
            cache.lengths, softcap=cfg.logit_softcap,
            impl=("plain" if impl == "full" else "kernel"))
        return _project_out(params, o[:, None], cd), cache

    if cache is not None and not isinstance(cache, str):
        S = x.shape[1]
        q, k_new, v_new = project_qkv(params, x, cfg, positions, cd, rope)
        pos_l = positions.long()
        W = cache["k"].shape[1]
        if S > 1 and window > 0:
            # ---- chunked prefill into a ring ----
            # attend over [pre-write ring || full chunk] -- a ring write
            # first would drop keys that early chunk queries still need
            # whenever S > W; then apply the ring rule (the last min(S, W)
            # tokens survive, slot = pos % W), matching
            # build_cache_from_prefill and the single-token decode write
            kc, vc = cache["k"], cache["v"]
            o = chunk_decode_attention(
                q, torch.cat([kc, k_new.to(kc.dtype)], 1),
                torch.cat([vc, v_new.to(vc.dtype)], 1),
                torch.cat([cache["pos"], positions.to(cache["pos"].dtype)],
                          1),
                positions, window=window, softcap=cfg.logit_softcap)
            m = min(S, W)
            bidx = torch.arange(B, device=x.device)[:, None]
            slots = pos_l[:, -m:] % W
            kc.index_put_((bidx, slots), k_new[:, -m:].to(kc.dtype))
            vc.index_put_((bidx, slots), v_new[:, -m:].to(vc.dtype))
            cache["pos"].index_put_(
                (bidx, slots), positions[:, -m:].to(cache["pos"].dtype))
            return _project_out(params, o, cd), cache
        if S > 1:
            # ---- chunked prefill: S new tokens appended to the cache ----
            bidx = torch.arange(B, device=x.device)[:, None]
            cache["k"].index_put_((bidx, pos_l), k_new.to(cache["k"].dtype))
            cache["v"].index_put_((bidx, pos_l), v_new.to(cache["v"].dtype))
            cache["pos"].index_put_((bidx, pos_l),
                                    positions.to(cache["pos"].dtype))
            o = chunk_decode_attention(q, cache["k"], cache["v"],
                                       cache["pos"], positions,
                                       softcap=cfg.logit_softcap)
            return _project_out(params, o, cd), cache
        # ---- decode: single new token at absolute position `positions`
        # (ring slot position % W for a windowed layer) ----
        bidx = torch.arange(B, device=x.device)
        slot = pos_l[:, 0] % W if window > 0 else pos_l[:, 0]
        cache["k"].index_put_((bidx, slot), k_new[:, 0].to(cache["k"].dtype))
        cache["v"].index_put_((bidx, slot), v_new[:, 0].to(cache["v"].dtype))
        cache["pos"].index_put_((bidx, slot),
                                positions[:, 0].to(cache["pos"].dtype))
        o = decode_attention(q, cache["k"], cache["v"], cache["pos"],
                             window=window, softcap=cfg.logit_softcap)
        return _project_out(params, o, cd), cache

    # ---- cache-less prefill ----
    q, k, v = project_qkv(params, x, cfg, positions, cd, rope)
    if impl == "full":
        o = full_attention(q, k, v, causal=cfg.causal, window=window,
                           kv_mask=kv_mask, softcap=cfg.logit_softcap)
    elif impl == "kernel":
        # right padding plus the causal mask keeps padded keys out of every
        # real query row, so the kernel needs no kv_mask; a bidirectional
        # model with padding has no such guarantee
        if kv_mask is not None and not cfg.causal:
            raise NotImplementedError(
                "kv_mask with a non-causal model needs attn_impl='full'")
        o = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=cfg.causal, window=window,
                          softcap=cfg.logit_softcap)
    else:
        raise ValueError(f"attn_impl {impl!r} not in ('kernel', 'full')")
    out = _project_out(params, o, cd)

    new_cache = None
    if cache == "init":
        new_cache = build_cache_from_prefill(
            k, v, positions, window=window, capacity=cache_capacity,
            kv_mask=kv_mask)
    return out, new_cache


def build_cache_from_prefill(k, v, positions, *, window: int,
                             capacity: int = 0, kv_mask=None):
    """Turn prefill K/V into a decode cache.

    Global attention: cache slot = absolute position (capacity >= S + decode
    budget).  Local attention: ring buffer of ``W = min(window, capacity)``
    slots (``window`` when no capacity is given), slot = pos % W -- the
    decode-side write rule and the slot layout of ``init_decode_cache``.
    (The reference always makes ``window`` slots here, so its dense engine
    cannot scatter a prefill into a slot when ``max_seq < window``; ROADMAP
    queue C.  A ring of ``capacity`` slots loses nothing: no position
    reaches ``capacity``.)

    ``kv_mask`` (B, S) bool, True = real token (pow2-bucketed prefill):
    right-padded entries must not enter the cache.  Full caches mark the
    padded slots empty (``pos = -1``); ring caches gather the last
    ``window`` *real* tokens of each row instead of the array tail.
    """
    B, S = k.shape[0], k.shape[1]
    pos = torch.broadcast_to(positions, (B, S)).to(torch.int32)
    if window > 0:
        W = min(window, capacity) if capacity > 0 else window
        if kv_mask is not None:
            # slot w holds the newest real index p = w (mod W); per-row
            # lengths make this a gather, matching the decode write rule
            L = kv_mask.to(torch.int64).sum(dim=1)              # (B,)
            w_ids = torch.arange(W, device=k.device)[None, :]
            p = (L[:, None] - 1) - torch.remainder(L[:, None] - 1 - w_ids, W)
            valid = p >= 0
            pc = p.clamp(min=0)

            def gather(a):
                idx = pc.reshape((B, W) + (1,) * (a.dim() - 2))
                return torch.take_along_dim(a, idx, dim=1)

            live = valid.reshape(B, W, 1, 1)
            cache_k = gather(k).masked_fill(~live, 0)
            cache_v = gather(v).masked_fill(~live, 0)
            cache_p = torch.where(valid, torch.take_along_dim(pos, pc, 1),
                                  -1).to(torch.int32)
            return {"k": cache_k, "v": cache_v, "pos": cache_p}
        m = min(S, W)
        slots = torch.arange(S - m, S, device=k.device) % W
        cache_k = k.new_zeros((B, W) + tuple(k.shape[2:]))
        cache_v = v.new_zeros((B, W) + tuple(v.shape[2:]))
        cache_p = pos.new_full((B, W), -1)
        cache_k[:, slots] = k[:, -m:]
        cache_v[:, slots] = v[:, -m:]
        cache_p[:, slots] = pos[:, -m:]
        return {"k": cache_k, "v": cache_v, "pos": cache_p}
    if kv_mask is not None:
        pos = torch.where(kv_mask, pos, -1)      # padded slots stay empty
    cap = max(capacity, S)
    if cap == S:
        return {"k": k, "v": v, "pos": pos.contiguous()}
    cache_k = k.new_zeros((B, cap) + tuple(k.shape[2:]))
    cache_v = v.new_zeros((B, cap) + tuple(v.shape[2:]))
    cache_p = pos.new_full((B, cap), -1)
    cache_k[:, :S] = k
    cache_v[:, :S] = v
    cache_p[:, :S] = pos
    return {"k": cache_k, "v": cache_v, "pos": cache_p}


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
                      local: bool, dtype=torch.bfloat16, device="cpu"):
    W = min(cfg.local_window, max_seq) if local else max_seq
    K, D = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, W, K, D), dtype=dtype, device=device),
        "v": torch.zeros((batch, W, K, D), dtype=dtype, device=device),
        "pos": torch.full((batch, W), -1, dtype=torch.int32, device=device),
    }
