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

Under a mesh's tp axis (``pctx``, a ``transformer.ParallelCtx``) the block
is tensor-parallel: ``project_qkv`` gives this rank's heads (GQA K/V
repeated to H, H zero-padded to a multiple of the axis, as the reference's
``sharded_flash`` lays them out), ``sharded_flash`` runs the flash kernel
on them (G = 1), and the output projection takes this rank's rows of
``wo`` and one *reduce*.  Decode splits the cache's length over the axis
(``core/policy.cache_specs``): ``sharded_decode`` writes the new token on
the rank that owns its slot and combines the ranks' partial softmaxes with
one max and two sum all-reduces.

The paged and chunked paths (the paged engine's pool, ``serve/kvcache``)
split **heads**, not length: the pool is paged along length and B3 reads a
whole block table, so a rank's pool holds the KV heads its query heads
read (``pool_kv_heads``): its ``K / tp`` where both head counts divide the
axis, else K/V repeated to H, zero-padded and cut as ``sharded_flash``
lays them out (G = 1; a KV head may then live on two ranks, and a rank of
padded heads only holds zeros).  The paged decode (B3) and the chunked
prefill over the pool run on this rank's heads, then the row-parallel
``wo`` and one *reduce*.  This differs from the dense cache's length split
(``core/policy.cache_specs``): a dict cache of one new token a row is the
dense engines' (length split), one of a chunk of several is the paged
engine's dense view of its pool (heads split).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hierarchy
from repro_torch.kernels import ops
from repro_torch.models import layers

NEG_INF = -1e30

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
# tensor parallelism (the reference's shard_map bodies on local tensors)
# ---------------------------------------------------------------------------
def cache_w_split(W: int, tp: int) -> bool:
    """Whether a decode cache of length ``W`` is split over a tp axis of
    ``tp`` ranks: the reference's ``cache_specs`` rule (``W % tp == 0`` and
    ``W >= 2 tp``), which a one-rank axis meets too."""
    return W % tp == 0 and W >= 2 * tp


def _kv_split(H: int, K: int, tp: int) -> bool:
    """Whether the K/V projections give this rank its ``K / tp`` KV heads
    (both head counts divide the axis), else every KV head."""
    return K % tp == 0 and H % tp == 0


def _repeat_heads(t, G: int):
    return t.repeat_interleave(G, dim=2) if G > 1 else t


def pool_kv_heads(H: int, K: int, tp: int) -> int:
    """The KV heads of a rank's page pool on a tp axis of ``tp`` ranks
    (module docstring): ``K / tp``, or one per padded query head."""
    return K // tp if _kv_split(H, K, tp) else -(-H // tp)


def _pool_heads(t, pctx, heads):
    """New K or V (B, S, K | K/tp, D) from ``project_qkv`` as this rank's
    pool holds them (``pool_kv_heads``); ``t`` itself without ``pctx``."""
    if pctx is None:
        return t
    H, K = heads
    if _kv_split(H, K, pctx.tp):
        return t
    return pctx.cut(_repeat_heads(t, H // K), 2, H)


def _rank_heads(q, k, v, pctx, heads):
    """q, k, v of this rank's ``Hp / tp`` heads (G = 1), from q of every
    head or of this rank's, and k / v of every KV head or of this rank's
    ``K / tp`` (``heads`` = (H, K), the whole counts)."""
    H, K = heads
    G = H // K
    tp = pctx.tp
    if q.shape[2] == H:
        q = pctx.cut(q, 2, H)
    out = [q]
    for t in (k, v):
        if t.shape[2] == K:
            t = pctx.cut(_repeat_heads(t, G), 2, H)
        elif t.shape[2] * tp == K and H % tp == 0:
            t = _repeat_heads(t, G)
        else:
            raise ValueError(f"{tuple(t.shape)}: neither every KV head nor "
                             f"this rank's of {K} over {tp}")
        out.append(t.contiguous())
    return out


def _attend(q, k, v, *, causal, window, softcap, impl, kv_mask):
    """Cache-less attention: ``kernels.ops.attention`` (B1; B2 under
    autograd) on a CUDA tensor, its plain version on a CPU one;
    ``impl="full"`` the oracle."""
    if impl == "full":
        return full_attention(q, k, v, causal=causal, window=window,
                              kv_mask=kv_mask, softcap=softcap)
    if impl == "kernel":
        # right padding plus the causal mask keeps padded keys out of every
        # real query row, so the kernel needs no kv_mask; a bidirectional
        # model with padding has no such guarantee
        if kv_mask is not None and not causal:
            raise NotImplementedError(
                "kv_mask with a non-causal model needs attn_impl='full'")
        return ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=causal, window=window, softcap=softcap)
    raise ValueError(f"attn_impl {impl!r} not in ('kernel', 'full')")


def sharded_flash(q, k, v, *, pctx, heads=None, causal=True, window=0,
                  softcap=0.0, impl="kernel", kv_mask=None,
                  whole: bool = False):
    """Flash attention with heads over the tp axis, held against
    ``repro/models/attention.py:465-540``: GQA K/V repeated to H *before*
    the split, H zero-padded to a multiple of the axis, and each rank runs
    the unsharded attention (``_attend``) on its own ``Hp / tp`` heads at
    G = 1.  The batch is the rank's piece over the dp axes already.

    q (B, S, H or H/tp, D); k/v (B, S, K or K/tp, D); ``heads`` (H, K)
    (default: q's and k's, every head).  Returns this rank's heads (B, S,
    Hp/tp, D), or with ``whole`` every rank's joined, padding cut: (B, S,
    H, D).  The reference's ``S % q_block`` fallback belongs to its XLA
    tiles; the kernels take any S."""
    H, K = heads if heads is not None else (q.shape[2], k.shape[2])
    ql, kl, vl = _rank_heads(q, k, v, pctx, (H, K))
    o = _attend(ql, kl, vl, causal=causal, window=window, softcap=softcap,
                impl=impl, kv_mask=kv_mask)
    if whole:
        return pctx.all_gather(o, 2)[:, :, :H]
    return o


def sharded_decode(q, k_new, v_new, cache, positions, *, pctx, W: int,
                   window=0, softcap=0.0):
    """One decode step with the cache's length over the tp axis, held
    against ``repro/models/attention.py:367-462``: each rank holds slots
    ``[r W/tp, (r+1) W/tp)`` of the (B, W, K, D) history; the new token is
    written only by the rank that owns its slot (``cur % W`` for a windowed
    layer); each rank computes its partial max ``m_l``, sum ``l_l`` and
    accumulator ``acc_l`` (its slots' softmax times V), combined by one MAX
    and two sum all-reduces over the axis.  q / k_new / v_new: every head
    (B, 1, H | K, D); ``cache``: this rank's piece, updated in place.
    Returns (out (B, 1, H, D), cache),
    or None -- the caller takes the dense path -- where the reference
    does: ``W % tp`` or ``W < 2 tp`` (the batch is the rank's piece already,
    so its ``B % n_dp`` case does not arise)."""
    tp = pctx.tp
    if tp > 1 and not cache_w_split(W, tp):
        return None
    B, _, H, D = q.shape
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    Wl, K = ck.shape[1], ck.shape[2]
    G = H // K
    cur = positions[:, :1].long()
    slot_g = cur[:, 0] % W if window > 0 else cur[:, 0]
    slot_l = slot_g - pctx.tp_rank * Wl
    ok = (slot_l >= 0) & (slot_l < Wl)
    safe = slot_l.clamp(0, Wl - 1)
    bidx = torch.arange(B, device=q.device)
    ck.index_put_((bidx, safe), torch.where(
        ok[:, None, None], k_new[:, 0].to(ck.dtype), ck[bidx, safe]))
    cv.index_put_((bidx, safe), torch.where(
        ok[:, None, None], v_new[:, 0].to(cv.dtype), cv[bidx, safe]))
    cp.index_put_((bidx, safe), torch.where(
        ok, cur[:, 0].to(cp.dtype), cp[bidx, safe]))

    qg = q.reshape(B, K, G, D)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), ck.float()) / \
        math.sqrt(D)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    valid = cp >= 0
    if window > 0:
        valid = valid & (cur - cp < window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    # the partial softmax of this rank's slots, normalised here and
    # reweighted after: o = sum_r (l_r exp(m_r - m) / L) (p_r V_r), with
    # p_r V_r in the cache's dtype as ``decode_attention`` computes its
    # whole, so that one rank gives that function's value bit for bit
    m_l = s.amax(dim=-1)                                    # (B, K, G)
    l_l = torch.where(valid[:, None, None, :],
                      torch.exp(s - m_l[..., None]), 0.0).sum(dim=-1)
    p = torch.softmax(s, dim=-1).to(cv.dtype)
    acc_l = torch.einsum("bkgt,btkd->bkgd", p, cv)
    group = pctx.tp_group
    m = hierarchy.all_reduce(m_l.clone(), group, op="max")
    lf = l_l * torch.exp(m_l - m)
    L = hierarchy.all_reduce(lf.clone(), group)
    w = torch.where(L > 0, lf / L.clamp_min(1e-30), 0.0)
    out = hierarchy.all_reduce(acc_l.float() * w[..., None], group)
    out = out.to(q.dtype)
    return out.reshape(B, 1, H, D), cache


def _every_head(t, pctx, whole: int):
    """Every head of ``t`` from this rank's (an all-gather over the tp axis,
    padding cut), or ``t`` where it holds every head already."""
    if t.shape[2] == whole:
        return t
    return pctx.all_gather(t, 2)[:, :, :whole]


# ---------------------------------------------------------------------------
# block-level apply (projections + path dispatch + cache management)
# ---------------------------------------------------------------------------
def project_qkv(params: Attention, x, cfg: ModelConfig, positions,
                compute_dtype, rope=None, pctx=None):
    """``rope``: the (cos, sin) tables of ``layers.rope_tables`` for these
    positions in the compute dtype, where the caller made them once for all
    layers; computed here when absent.

    ``pctx``: inside the tensor-parallel region (``x`` after the *copy*), q
    of this rank's ``Hp / tp`` heads (its columns of ``wq``: a piece by
    heads, or its block of the whole leaf, zero-padded where H does not
    divide); k / v of this rank's ``K / tp`` KV heads where both H and K
    divide the axis, else of every KV head."""
    cd = compute_dtype
    x = x.to(cd)
    d = x.shape[-1]
    B, S = x.shape[0], x.shape[1]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    wq, wk, wv = params.wq, params.wk, params.wv
    bq, bk, bv = ((params.bq, params.bk, params.bv) if cfg.qkv_bias
                  else (None, None, None))
    if pctx is not None:
        wq = pctx.cut(wq, 1, H)
        bq = pctx.cut(bq, 0, H) if bq is not None else None
        if _kv_split(H, K, pctx.tp):
            wk, wv = pctx.cut(wk, 1, K), pctx.cut(wv, 1, K)
            if bk is not None:
                bk, bv = pctx.cut(bk, 0, K), pctx.cut(bv, 0, K)
    # einsum("bsd,dhe->bshe") as one matmul against the (d, H*hd) view
    q = (x @ wq.to(cd).reshape(d, -1)).view(B, S, -1, hd)
    k = (x @ wk.to(cd).reshape(d, -1)).view(B, S, -1, hd)
    v = (x @ wv.to(cd).reshape(d, -1)).view(B, S, -1, hd)
    if cfg.qkv_bias:
        q = q + bq.to(cd)
        k = k + bk.to(cd)
        v = v + bv.to(cd)
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


def _project_out(params: Attention, o, compute_dtype, pctx=None,
                 heads: int = 0):
    """einsum("bshe,hed->bsd") as one matmul against the (H*hd, d) view;
    under ``pctx`` this rank's heads through its rows of ``wo`` (of
    ``heads``, the whole H), then the *reduce* over the tp axis."""
    cd = compute_dtype
    B, S = o.shape[0], o.shape[1]
    wo = params.wo if pctx is None else pctx.cut(params.wo, 0, heads)
    y = o.to(cd).reshape(B, S, -1) @ wo.to(cd).reshape(-1, wo.shape[-1])
    return y if pctx is None else pctx.reduce(y)


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
                    rope=None, pctx=None):
    """Returns (out (B,S,d_model), new_cache_or_None).

    cache (decode): dict(k=(B,W,K,D), v=(B,W,K,D), pos=(B,W) int32), updated
    in place and returned; or a ``PagedDecodeCache`` (single-token decode off
    the page pool).  For prefill (cache is the string "init"), returns the
    filled cache.  ``pctx``: the tensor-parallel paths (module docstring);
    the prefill's cache is then this rank's piece of its length.  Without
    it every cut and reduce below is the identity.
    """
    window = cfg.local_window if local else 0
    B = x.shape[0]
    H, K = cfg.n_heads, cfg.n_kv_heads
    cd = compute_dtype
    if pctx is not None:
        x = pctx.copy(x.to(cd))

    def project_out(o):
        return _project_out(params, o, cd, pctx, H)

    if isinstance(cache, PagedDecodeCache):
        # ---- decode straight off the page pool (no dense view) ----
        if window > 0:
            raise ValueError("the page pool holds full-attention layers "
                             "only; windowed layers use ring caches")
        if x.shape[1] != 1:
            raise ValueError("the paged decode path takes one token per row")
        q, k_new, v_new = project_qkv(params, x, cfg, positions, cd, rope,
                                      pctx)
        k_new, v_new = (_pool_heads(t, pctx, (H, K)) for t in (k_new, v_new))
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
        return project_out(o[:, None]), cache

    q, k, v = project_qkv(params, x, cfg, positions, cd, rope, pctx)
    if cache is not None and not isinstance(cache, str):
        S = x.shape[1]
        pos_l = positions.long()
        W = cache["k"].shape[1]
        if S > 1:
            # a chunk over the paged engine's dense view: this rank's heads
            k, v = _pool_heads(k, pctx, (H, K)), _pool_heads(v, pctx, (H, K))
        if S > 1 and window > 0:
            # ---- chunked prefill into a ring ----
            # attend over [pre-write ring || full chunk] -- a ring write
            # first would drop keys that early chunk queries still need
            # whenever S > W; then apply the ring rule (the last min(S, W)
            # tokens survive, slot = pos % W), matching
            # build_cache_from_prefill and the single-token decode write
            kc, vc = cache["k"], cache["v"]
            o = chunk_decode_attention(
                q, torch.cat([kc, k.to(kc.dtype)], 1),
                torch.cat([vc, v.to(vc.dtype)], 1),
                torch.cat([cache["pos"], positions.to(cache["pos"].dtype)],
                          1),
                positions, window=window, softcap=cfg.logit_softcap)
            m = min(S, W)
            bidx = torch.arange(B, device=x.device)[:, None]
            slots = pos_l[:, -m:] % W
            kc.index_put_((bidx, slots), k[:, -m:].to(kc.dtype))
            vc.index_put_((bidx, slots), v[:, -m:].to(vc.dtype))
            cache["pos"].index_put_(
                (bidx, slots), positions[:, -m:].to(cache["pos"].dtype))
            return project_out(o), cache
        if S > 1:
            # ---- chunked prefill: S new tokens appended to the cache ----
            bidx = torch.arange(B, device=x.device)[:, None]
            cache["k"].index_put_((bidx, pos_l), k.to(cache["k"].dtype))
            cache["v"].index_put_((bidx, pos_l), v.to(cache["v"].dtype))
            cache["pos"].index_put_((bidx, pos_l),
                                    positions.to(cache["pos"].dtype))
            o = chunk_decode_attention(q, cache["k"], cache["v"],
                                       cache["pos"], positions,
                                       softcap=cfg.logit_softcap)
            return project_out(o), cache
        # ---- decode: single new token at absolute position `positions`
        # (ring slot position % W for a windowed layer); under ``pctx``
        # every head on each rank and the cache's length split ----
        res = None
        if pctx is not None:
            q = _every_head(q, pctx, H)
            k, v = _every_head(k, pctx, K), _every_head(v, pctx, K)
            if pctx.tp > 1 and not cache_capacity:
                raise ValueError("decode under a model axis needs the "
                                 "cache's capacity (RunCtx.cache_capacity)")
            Wg = cache_capacity or W
            res = sharded_decode(q, k, v, cache, positions, pctx=pctx,
                                 W=min(window, Wg) if window > 0 else Wg,
                                 window=window, softcap=cfg.logit_softcap)
        if res is None:
            # the whole cache on this rank (the reference's dense path)
            bidx = torch.arange(B, device=x.device)
            slot = pos_l[:, 0] % W if window > 0 else pos_l[:, 0]
            cache["k"].index_put_((bidx, slot), k[:, 0].to(cache["k"].dtype))
            cache["v"].index_put_((bidx, slot), v[:, 0].to(cache["v"].dtype))
            cache["pos"].index_put_((bidx, slot),
                                    positions[:, 0].to(cache["pos"].dtype))
            o = decode_attention(q, cache["k"], cache["v"], cache["pos"],
                                 window=window, softcap=cfg.logit_softcap)
        else:
            o, cache = res
        if pctx is not None:
            o = pctx.cut(o, 2, H)
        return project_out(o), cache

    # ---- cache-less prefill ----
    att = dict(causal=cfg.causal, window=window, softcap=cfg.logit_softcap,
               impl=impl, kv_mask=kv_mask)
    if pctx is None:
        o = _attend(q, k, v, **att)
    else:
        o = sharded_flash(q, k, v, pctx=pctx, heads=(H, K), **att)
    out = project_out(o)

    new_cache = None
    if cache == "init":
        if pctx is not None and _kv_split(H, K, pctx.tp):
            # re-lay the prefill's K/V once: every KV head (they left the
            # projections by heads), then this rank's piece of the cache's
            # length (``core/policy.cache_specs``)
            k, v = pctx.all_gather(k, 2), pctx.all_gather(v, 2)
        new_cache = build_cache_from_prefill(
            k, v, positions, window=window, capacity=cache_capacity,
            kv_mask=kv_mask)
        W = new_cache["k"].shape[1]
        if pctx is not None and cache_w_split(W, pctx.tp):
            n = W // pctx.tp
            new_cache = {name: t.narrow(1, pctx.tp_rank * n, n).contiguous()
                         for name, t in new_cache.items()}
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
