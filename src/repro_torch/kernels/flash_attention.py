"""Fused GQA attention forward: wrapper of the CUDA kernel
``csrc/flash_attention.cu`` and, beside it, its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``).  On this card the function is
bounded by operations (4*S*T*D flops per head against S*D-sized inputs), so
the kernel keeps the score matrix out of device memory and shares every K/V
tile among the G query heads of its group; the source note in the ``.cu``
file says how.

Which design serves a call depends on (head_dim, dtype) alone, as the C
dispatch's switch says (``design``): fp32 on the CUDA cores; bf16 at
D = 64, 128, 160 and 256 on warpgroup products (``wgmma``) fed by the TMA,
with one producer warp and two consumer warpgroups (at D = 160 the head's
columns are five 32-column panels; at D = 256 the key tiles are 64 keys);
bf16 at D = 32 on warp-level ``mma.sync``.  The TMA reads q, k and v
through tensor maps, which
need 16-byte aligned base pointers: the wrapper checks that for every
launch.  ``live_key_tiles`` is the key-tile walk of the warpgroup design,
the same bounds as the ``.cu`` file computes.

``flash_attention`` launches the kernel for CUDA tensors -- or raises: there
is no fallback -- and runs ``attention_plain`` only for tensors that lie on
the CPU.  ``flash_attention.launches`` counts kernel launches.  It has no
backward: called where autograd needs a gradient of q, k or v it raises on
either device (``flash_attention_bwd.flash_attention_vjp`` is the
differentiable path).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 160, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the C dispatch's design codes (csrc/common.cuh DESIGN_*)
DESIGNS = {0: None, 1: "cuda-cores", 2: "mma.sync", 3: "wgmma"}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load().repro_flash_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        _fn = fn
    return _fn


def design(head_dim: int, dtype) -> str:
    """The design the forward kernels launch for (``head_dim``, ``dtype``),
    as the library's dispatch reports it ("cuda-cores", "mma.sync",
    "wgmma"); builds the library if it is not built yet."""
    fn = build.load().repro_flash_attention_fwd_design
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    return DESIGNS[fn(int(head_dim), _DTYPE_CODE[dtype])]


def tile(head_dim: int, dtype):
    """(block_q, block_k) that the forward design for (``head_dim``,
    ``dtype``) launches, or None where no design serves: the warpgroup
    design's 128 positions of one query head by 128 keys (64 at D = 256,
    ``csrc/flash_attention.cu`` ``WG_BM`` x ``FwdLayout::BN``); the
    ``mma.sync`` (bf16, D = 32) and CUDA-core (fp32) designs' 64 rows of the
    flattened (position, group head) axis by 64 keys (``BM`` x ``BN``).
    Each design has this one tile, and the stats-emitting forward of
    training launches it too."""
    if head_dim not in HEAD_DIMS or dtype not in _DTYPE_CODE:
        return None
    if dtype == torch.bfloat16 and head_dim != 32:
        return 128, (64 if head_dim > 160 else 128)
    return 64, 64


def live_key_tiles(m0: int, BM: int, BN: int, T: int, causal: bool,
                   window: int):
    """Keys ``[n_begin, n_end)`` that any query position of ``m0 ..
    m0+BM-1`` sees (query i at position i, key j at j); ``n_begin`` is a
    multiple of ``BN``.  The warpgroup forward kernel walks the key tiles
    ``range(n_begin, n_end, BN)`` of each block of ``BM`` positions (BN =
    128, 64 at D = 256; ``csrc/hopper.cuh`` ``live_key_tiles``, the same
    bounds)."""
    n_begin, n_end = 0, T
    if causal:
        n_end = min(T, m0 + BM)
    if window > 0 and m0 - window + 1 > 0:
        n_begin = (m0 - window + 1) // BN * BN
    return n_begin, n_end


def attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """The kernel's arithmetic in plain PyTorch (scores materialised):
    fp32 scores, ``1/sqrt(D)`` scale, optional tanh soft-cap, additive
    ``-1e30`` mask, fp32 softmax cast to V's dtype before the PV product.

    q (B,S,H,D); k/v (B,T,K,D); H = K*G -> (B,S,H,D) in q's dtype.
    """
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    s = s * (1.0 / math.sqrt(D))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    diff = (torch.arange(S, device=q.device)[:, None]
            - torch.arange(T, device=q.device)[None, :])
    dead = torch.zeros((S, T), dtype=torch.bool, device=q.device)
    if causal:
        dead |= diff < 0
    if window > 0:
        dead |= diff >= window
    s = s.masked_fill(dead, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", p, v)
    return o.reshape(B, S, H, D).to(q.dtype)


def needs_grad(*tensors) -> bool:
    """True where autograd would need a gradient of one of ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check_aligned(*tensors) -> None:
    """The kernels read through TMA tensor maps and 16-byte vector loads:
    each base pointer must be 16-byte aligned (a contiguous view with a
    storage offset may not be).  The SSD kernels share the rule."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"the kernels need 16-byte aligned "
                             f"tensors; got one at address {t.data_ptr():#x} "
                             f"(storage offset {t.storage_offset()})")


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: want q (B,S,H,D), k/v (B,T,K,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not form GQA groups")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k, v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v must share one device")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q (B,S,H,D); k/v (B,T,K,D) -> (B,S,H,D).  H = K*G (GQA); any G,
    ``S != T`` allowed (query i sits at position i, key j at position j).
    Ragged last tiles are masked inside the kernel, so no divisibility of S
    or T is required -- a superset of the reference, which asserts it.
    """
    _check(q, k, v)
    if needs_grad(q, k, v):
        raise RuntimeError(
            "flash_attention is forward-only and q/k/v need a gradient: use "
            "flash_attention_bwd.flash_attention_vjp (or ops.attention, "
            "which picks it)")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, not {D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous q, k, v")
    check_aligned(q, k, v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        fn = _kernel()
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, T, H, K, D, _DTYPE_CODE[q.dtype], int(bool(causal)),
                int(window), float(softcap),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed (code {rc}) for q "
            f"{tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
