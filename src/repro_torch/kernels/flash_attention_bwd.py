"""Differentiable fused GQA attention: wrappers of the CUDA kernels that the
training path runs (``csrc/flash_attention.cu`` with row statistics,
``csrc/flash_attention_bwd.cu``), their plain PyTorch versions, and the
``torch.autograd.Function`` that joins them.

Replaces the TPU kernels of ``repro/kernels/flash_attention_bwd.py``:

  * ``flash_attention_fwd_stats`` -- ``_fwd`` / ``_fwd_kernel`` (line 238):
    the forward kernel, also writing each query row's softmax statistics;
  * ``flash_attention_bwd_dkv``   -- ``_bwd`` / ``_bwd_dkv_kernel`` (line 280);
  * ``flash_attention_bwd_dq``    -- ``_bwd`` / ``_bwd_dq_kernel`` (line 313);
  * ``flash_attention_vjp``       -- the reference's ``jax.custom_vjp`` of the
    same name.

Layouts: q, o, dO (B,S,H,D); k, v (B,T,K,D); the statistics ``m``, ``l`` and
``delta = rowsum(dO * O)`` are fp32 (B,S,H) -- q's layout without its last
axis, where the reference transposes everything to (B,K,G,S,...).  The rows
of one KV head then come in the kernels' flattened (position, group-head)
order, so no transpose is paid per layer.

Gradients are exact, including under a soft-cap: the derivative of
``c * tanh(x / c)`` at the capped score ``s`` is ``1 - (s / c)**2``.  The
reference's kernel multiplies by ``1 - tanh(s / c)**2`` instead -- tanh
applied to the already capped score -- which is off by up to a few percent
of the gradient at small ``c`` (ROADMAP queue C).  A pair that the mask
kills has ``p = 0`` exactly, so a query row with no live key gets zero,
finite gradients.

Designs (the C dispatch's switch, ``design_dkv`` and ``design_dq``): fp32 on
the CUDA cores; in bf16 the stats forward is the forward's design
(``flash_attention.design``), and dK/dV and dQ run on warpgroup products
(``wgmma``) fed by the TMA at D = 64, 128, 160 and 256 and on ``mma.sync``
at D = 32.
The dK/dV block of the warpgroup design owns 128 keys and walks the (query
tile, group head) pairs of ``live_query_tiles`` (tiles of 64 query
positions, 32 above D = 128).  At D = 256 a block owns 64 keys and one
slice of the group's heads (``dkv_d256_slices`` slices a key tile, heaviest
tiles first) and walks pairs of 64 query positions and a head: the two
warpgroups compute S^T and dP^T once a pair, each for 32 of the queries,
exchange P^T and dS^T through shared memory, and each accumulates dK and dV
for 128 of the 256 columns; with more than one slice the slices' fp32
partials are summed in slice order by a second launch.  The dQ block owns
128 query positions of one head and walks the key tiles of
``flash_attention.live_key_tiles`` (64 keys, 48 at D = 256): the same
bounds as the ``.cu`` files compute.  At D = 160 all of them keep a head's
columns as five 32-column panels, elsewhere as 64-column panels.

Every wrapper launches its kernel for CUDA tensors -- or raises: there is no
fallback -- and runs the plain version only for tensors on the CPU.  Each
counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (_DTYPE_CODE, DESIGNS,
                                                 NEG_INF, _check,
                                                 attention_plain,
                                                 check_aligned)

# the training kernels take the head dims of the trainable archs (llama3.2-3b
# 128, stablelm-12b 160, qwen2-0.5b 64, recurrentgemma-2b 256)
BWD_HEAD_DIMS = (32, 64, 128, 160, 256)

_fns: dict = {}


def _kernel(name: str, n_ptr: int):
    """The C entry point ``name`` of the kernels' library: ``n_ptr``
    pointers, then B, S, T, H, K, D, dtype, causal, window, the soft-cap and
    the stream."""
    if name not in _fns:
        fn = getattr(build.load(), name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        _fns[name] = fn
    return _fns[name]


def _design(entry: str, head_dim: int, dtype) -> str:
    fn = getattr(build.load(), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    return DESIGNS[fn(int(head_dim), _DTYPE_CODE[dtype])]


def design_dkv(head_dim: int, dtype) -> str:
    """The design the dK/dV kernels launch for (``head_dim``, ``dtype``), as
    the library's dispatch reports it; builds the library if needed."""
    return _design("repro_flash_attention_bwd_dkv_design", head_dim, dtype)


def design_dq(head_dim: int, dtype) -> str:
    """The design the dQ kernels launch for (``head_dim``, ``dtype``), as
    the library's dispatch reports it; builds the library if needed."""
    return _design("repro_flash_attention_bwd_dq_design", head_dim, dtype)


# the bf16 D = 256 backward (csrc/flash_attention_bwd.cu Dkv256Layout,
# Dq256Layout): dK/dV's keys of a work item, query positions of a pair and
# work items aimed at (three per SM of an H100); dQ's keys of a tile
D256_DKV_BN, D256_DKV_BM, D256_DKV_ITEMS = 64, 64, 396
D256_DQ_BN = 48


def dkv_d256_slices(B: int, T: int, K: int, G: int) -> int:
    """Head slices per 64-key tile of the bf16 D = 256 dK/dV: enough work
    items for about ``D256_DKV_ITEMS``, at most one per head of the group
    (``csrc`` ``dkv256_slices``, the same rule).  Slice ``s`` of ``n`` holds
    ``G // n`` heads, one more for ``s < G % n``."""
    tiles = B * K * -(-T // D256_DKV_BN)
    return min(G, -(-D256_DKV_ITEMS // tiles))


def dkv_slices(B: int, T: int, H: int, K: int, D: int, dtype) -> int:
    """The head slices ``flash_attention_bwd_dkv``'s kernel sums partials
    over at (shape, dtype), as the library reports it (1: no scratch);
    builds the library if needed."""
    fn = build.load().repro_flash_attention_bwd_dkv_slices
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 6
    return fn(int(B), int(T), int(H), int(K), int(D), _DTYPE_CODE[dtype])


def live_query_tiles(n0: int, BN: int, BM: int, S: int, causal: bool,
                     window: int):
    """Query positions ``[m_begin, m_end)`` for which any key of ``n0 ..
    n0+BN-1`` is live; ``m_begin`` is a multiple of ``BM``.  The warpgroup
    dK/dV kernel walks the query tiles ``range(m_begin, m_end, BM)`` of each
    block of ``BN`` keys, each for every head of the group
    (``csrc/hopper.cuh`` ``live_query_tiles``, the same bounds)."""
    m_begin, m_end = 0, S
    if causal:
        m_begin = min(n0, S) // BM * BM
    if window > 0:
        m_end = min(S, n0 + BN - 1 + window)
    return m_begin, m_end


def _dead(S: int, T: int, causal: bool, window: int, device):
    """(S, T) bool: the pairs that the mask kills (query i at position i,
    key j at position j)."""
    diff = (torch.arange(S, device=device)[:, None]
            - torch.arange(T, device=device)[None, :])
    dead = torch.zeros((S, T), dtype=torch.bool, device=device)
    if causal:
        dead |= diff < 0
    if window > 0:
        dead |= diff >= window
    return dead


def _scores(q, k, causal: bool, window: int, softcap: float):
    """fp32 scaled, soft-capped scores (B,K,G,S,T) and the mask (S,T)."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, K, H // K, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    s = s * (1.0 / math.sqrt(D))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    return s, _dead(S, T, causal, window, q.device)


def _to_bkgs(x, K: int):
    """(B,S,H) -> (B,K,G,S) view."""
    B, S, H = x.shape
    return x.reshape(B, S, K, H // K).permute(0, 2, 3, 1)


def _from_bkgs(x):
    """(B,K,G,S) -> (B,S,H)."""
    B, K, G, S = x.shape
    return x.permute(0, 3, 1, 2).reshape(B, S, K * G)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def attention_fwd_stats_plain(q, k, v, *, causal: bool = True,
                              window: int = 0, softcap: float = 0.0):
    """The stats-emitting forward in plain PyTorch: ``(o, m, l)`` with ``o``
    exactly ``attention_plain``'s output and, per query row, ``m`` the max of
    the masked scores and ``l = max(sum exp(s - m), 1e-30)``, fp32 (B,S,H).
    """
    s, dead = _scores(q, k, causal, window, softcap)
    s = s.masked_fill(dead, NEG_INF)
    m = s.amax(dim=-1)
    l = torch.exp(s - m[..., None]).sum(dim=-1).clamp_min(1e-30)
    o = attention_plain(q, k, v, causal=causal, window=window,
                        softcap=softcap)
    return o, _from_bkgs(m), _from_bkgs(l)


def attention_delta(o, do):
    """``delta = rowsum(dO * O)`` in fp32 (B,S,H), computed outside the
    kernels as the reference does (``flash_attention_bwd.py:276-278``)."""
    return (do.float() * o.float()).sum(dim=-1)


def attention_bwd_plain(q, k, v, do, m, l, delta, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """The backward kernels' arithmetic in plain PyTorch, step by step as
    the reference's ``_recompute_p`` / ``_bwd_*_kernel`` (all fp32): p from
    the saved statistics (0 on masked pairs), ``dS = p (dP - delta)``, the
    exact soft-cap derivative, the scale.  Returns ``(dq, dk, dv)`` in the
    inputs' dtypes; dK and dV are summed over the G heads of a group."""
    B, S, H, D = q.shape
    K = k.shape[2]
    s, dead = _scores(q, k, causal, window, softcap)
    mb, lb, db = (_to_bkgs(x, K)[..., None] for x in (m, l, delta))
    p = torch.where(dead, 0.0, torch.exp(s - mb) / lb)
    dog = do.reshape(B, S, K, H // K, D).float()
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.float())
    ds = p * (dp - db)
    if softcap > 0:
        ds = ds * (1.0 - (s / softcap) ** 2)
    ds = ds * (1.0 / math.sqrt(D))
    dk = torch.einsum("bkgst,bskgd->btkd", ds,
                      q.reshape(B, S, K, H // K, D).float())
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()).reshape(B, S, H, D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _kernel_args(q, k, *tensors):
    """Checks shared by the three launches on CUDA tensors."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernels: unsupported device "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention kernels take float32 or bfloat16, "
                        f"not {q.dtype}")
    D = q.shape[3]
    if D not in BWD_HEAD_DIMS:
        raise ValueError(f"flash attention training kernels take head_dim "
                         f"in {BWD_HEAD_DIMS}, not {D}")
    for t in (q, k) + tensors:
        if not t.is_contiguous():
            raise ValueError("flash attention kernels take contiguous "
                             "tensors")
    check_aligned(q, k, *tensors)


def _check_stats(q, *stats):
    B, S, H, _ = q.shape
    for t in stats:
        if t.shape != (B, S, H) or t.dtype != torch.float32 or \
                t.device != q.device:
            raise ValueError(f"flash attention backward: statistics must be "
                             f"fp32 {(B, S, H)} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _launch(fn, q, k, ptrs, causal, window, softcap, what):
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        rc = fn(*ptrs, B, S, T, H, K, D, _DTYPE_CODE[q.dtype],
                int(bool(causal)), int(window), float(softcap),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed (code {rc}) for q "
                           f"{tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")


def flash_attention_fwd_stats(q, k, v, *, causal: bool = True,
                              window: int = 0, softcap: float = 0.0):
    """q (B,S,H,D); k/v (B,T,K,D) -> ``(o, m, l)``: the attention output
    (B,S,H,D) and the fp32 (B,S,H) row statistics the backward needs."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_fwd_stats_plain(q, k, v, causal=causal,
                                         window=window, softcap=softcap)
    _kernel_args(q, k, v)
    B, S, H, _ = q.shape
    o = torch.empty_like(q)
    m = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    _launch(_kernel("repro_flash_attention_fwd_stats", 6), q, k,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             m.data_ptr(), l.data_ptr()), causal, window, softcap,
            "flash_attention_fwd_stats")
    flash_attention_fwd_stats.launches += 1
    return o, m, l


def flash_attention_bwd_dkv(q, k, v, do, m, l, delta, *, causal: bool = True,
                            window: int = 0, softcap: float = 0.0):
    """-> ``(dk, dv)`` (B,T,K,D) in k's dtype, summed over each group's G
    query heads."""
    _check(q, k, v)
    _check_stats(q, m, l, delta)
    if q.device.type == "cpu":
        _, dk, dv = attention_bwd_plain(q, k, v, do, m, l, delta,
                                        causal=causal, window=window,
                                        softcap=softcap)
        return dk, dv
    _kernel_args(q, k, v, do, m, l, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    nsl = dkv_slices(B, T, H, K, D, q.dtype)
    # the head slices' fp32 partials of dK and dV (bf16, D = 256)
    ws = torch.empty(2 * nsl * k.numel(), dtype=torch.float32,
                     device=q.device) if nsl > 1 else None
    _launch(_kernel("repro_flash_attention_bwd_dkv", 10), q, k,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             m.data_ptr(), l.data_ptr(), delta.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), None if ws is None else ws.data_ptr()), causal,
            window, softcap, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, m, l, delta, *, causal: bool = True,
                           window: int = 0, softcap: float = 0.0):
    """-> ``dq`` (B,S,H,D) in q's dtype."""
    _check(q, k, v)
    _check_stats(q, m, l, delta)
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, do, m, l, delta, causal=causal,
                                   window=window, softcap=softcap)[0]
    _kernel_args(q, k, v, do, m, l, delta)
    dq = torch.empty_like(q)
    _launch(_kernel("repro_flash_attention_bwd_dq", 8), q, k,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             m.data_ptr(), l.data_ptr(), delta.data_ptr(), dq.data_ptr()),
            causal, window, softcap, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_fwd_stats.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
class FlashAttentionFn(torch.autograd.Function):
    """The same on both devices: the wrappers above decide, by the tensors'
    device alone, between the kernels and their plain versions.  Saves q, k,
    v, the output and the two statistics (under activation checkpointing
    these are dropped and the forward runs again in the backward pass)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        o, m, l = flash_attention_fwd_stats(q, k, v, causal=causal,
                                            window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(o, do)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, m, l, delta, **ctx.opts)
        dq = flash_attention_bwd_dq(q, k, v, do, m, l, delta, **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention_vjp(q, k, v, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """Differentiable fused attention, after the reference's function of the
    same name (without its TPU tiling and interpret arguments).
    q (B,S,H,D); k/v (B,T,K,D) -> (B,S,H,D)."""
    return FlashAttentionFn.apply(q, k, v, causal, window, softcap)
