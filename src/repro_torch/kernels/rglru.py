"""RG-LRU linear recurrence: wrapper of the CUDA kernel ``csrc/rglru.cu`` and,
beside it, its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/rglru.py`` (``rglru`` /
``_rglru_kernel``): ``h_t = exp(log_a_t) * h_{t-1} + gated_t`` in fp32.
``rglru_plain`` is a log-depth (Hillis-Steele) scan in torch ops with the
combine rule of the model path's ``rglru_scan``
(``repro/models/rglru.py:100-114``), and an optional ``h0`` folded into the
first step as there.  On this card the function is bounded by bytes.  The
kernel is a chunked scan over ``CHUNK``-step chunks: each chunk's composite
(the product of its decays and its scan from zero) into a workspace that the
wrapper allocates, then the carries across chunks, then each chunk again
from its entering carry; the source note in the ``.cu`` file has the rest.

``rglru`` launches the kernel for CUDA tensors -- or raises: there is no
fallback -- and runs ``rglru_plain`` only for tensors that lie on the CPU.
``rglru.launches`` counts calls that launched (one per call: the three
passes).  The kernel has no backward (nor
has the reference's): called on CUDA tensors where autograd needs a
gradient, it raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import needs_grad

# steps per chunk of the kernel's scan (csrc/rglru.cu RG_CHUNK; the C entry
# point refuses a workspace cut for another length)
CHUNK = 64

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load().repro_rglru_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        _fn = fn
    return _fn


def rglru_plain(log_a, gated, h0=None):
    """log_a/gated (B,S,W); h0 (B,W) or None -> hs (B,S,W) fp32.

    Hillis-Steele inclusive scan over S with the combine
    ``(a1, b1), (a2, b2) -> (a1 * a2, a2 * b1 + b2)``: log2(S) rounds, each
    combining every position with the one ``d`` steps before it."""
    a = torch.exp(log_a.float())
    b = gated.float()
    if h0 is not None:
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * h0.float()
    S = a.shape[1]
    d = 1
    while d < S:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        a_cur, b_cur = a[:, d:], b[:, d:]
        a = torch.cat([a[:, :d], a_prev * a_cur], dim=1)
        b = torch.cat([b[:, :d], a_cur * b_prev + b_cur], dim=1)
        d *= 2
    return b


def _check(log_a, gated, h0):
    if log_a.dim() != 3 or gated.shape != log_a.shape:
        raise ValueError(f"rglru: want log_a, gated (B,S,W); got "
                         f"{tuple(log_a.shape)}, {tuple(gated.shape)}")
    if h0 is not None and h0.shape != (log_a.shape[0], log_a.shape[2]):
        raise ValueError(f"rglru: h0 {tuple(h0.shape)} is not (B,W)")
    tensors = [log_a, gated] + ([h0] if h0 is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("rglru: all inputs must share one device")


def rglru(log_a, gated, *, h0=None):
    """log_a/gated (B,S,W) -> hs (B,S,W) fp32, h starting at ``h0`` (B,W)
    or zero.  Any S."""
    _check(log_a, gated, h0)
    if log_a.device.type == "cpu":
        return rglru_plain(log_a, gated, h0=h0)
    if log_a.device.type != "cuda":
        raise ValueError(f"rglru: unsupported device {log_a.device}")
    if needs_grad(log_a, gated, *([h0] if h0 is not None else [])):
        raise RuntimeError(
            "the rglru kernel has no backward (nor has the reference's) and "
            "an input needs a gradient: training the recurrent archs is "
            "ROADMAP queue A item 10")
    ins = (log_a, gated) + ((h0,) if h0 is not None else ())
    if not all(t.dtype == torch.float32 for t in ins):
        raise TypeError(f"rglru kernel takes float32, not "
                        f"{[t.dtype for t in ins]}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("rglru kernel takes contiguous inputs")
    B, S, W = log_a.shape
    y = torch.empty_like(log_a)
    n_chunks = -(-S // CHUNK)
    # each chunk's (product of decays, scan from zero), then the carries
    ws = torch.empty(2 * B * n_chunks * W, dtype=torch.float32,
                     device=log_a.device)
    with torch.cuda.device(log_a.device):
        rc = _kernel()(log_a.data_ptr(), gated.data_ptr(),
                       h0.data_ptr() if h0 is not None else None,
                       y.data_ptr(), ws.data_ptr(), n_chunks, B, S, W,
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rglru kernel launch failed (code {rc}) for "
                           f"{tuple(log_a.shape)}")
    rglru.launches += 1
    return y


rglru.launches = 0
