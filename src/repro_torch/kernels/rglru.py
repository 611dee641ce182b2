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
passes).  The forward kernel records no graph: called on CUDA tensors where
autograd needs a gradient, it raises, and ``RGLRUFn`` is the differentiable
form.

The backward has no TPU kernel: the reference differentiates its XLA scan
(``rglru_scan_chunked``, ``repro/models/rglru.py:134``).  ``rglru_bwd``
wraps the hand-written ``repro_rglru_bwd`` (the adjoint
``lam_t = dy_t + a_{t+1} lam_{t+1}`` as the forward's chunked scan run from
the end, then ``d gated = lam``, ``d log_a_t = lam_t a_t h_{t-1}``,
``d h0 = a_0 lam_0``), ``rglru_bwd_plain`` is the same reverse scan in torch
ops, and ``RGLRUFn`` joins the forward and the backward; it saves the
forward's output ``hs`` and ``log_a``.  ``rglru_bwd.launches`` counts as
``rglru.launches`` does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import needs_grad

# steps per chunk of the kernel's scan (csrc/rglru.cu RG_CHUNK; the C entry
# point refuses a workspace cut for another length)
CHUNK = 64

_fns: dict = {}


def _kernel(name: str, n_ptr: int):
    """The C entry point ``name``: ``n_ptr`` pointers, then n_chunks, B, S,
    W and the stream."""
    if name not in _fns:
        fn = getattr(build.load(), name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        _fns[name] = fn
    return _fns[name]


def _scan(a, b):
    """Hillis-Steele inclusive scan over axis 1 of ``h_t = a_t h_{t-1} +
    b_t`` from zero, with the combine ``(a1, b1), (a2, b2) -> (a1 * a2,
    a2 * b1 + b2)``: log2(S) rounds, each combining every position with the
    one ``d`` steps before it."""
    S = a.shape[1]
    d = 1
    while d < S:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        a_cur, b_cur = a[:, d:], b[:, d:]
        a = torch.cat([a[:, :d], a_prev * a_cur], dim=1)
        b = torch.cat([b[:, :d], a_cur * b_prev + b_cur], dim=1)
        d *= 2
    return b


def rglru_plain(log_a, gated, h0=None):
    """log_a/gated (B,S,W); h0 (B,W) or None -> hs (B,S,W) fp32: the scan
    of ``_scan`` with ``h0`` folded into the first step."""
    a = torch.exp(log_a.float())
    b = gated.float()
    if h0 is not None:
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * h0.float()
    return _scan(a, b)


def rglru_bwd_plain(log_a, hs, dy, h0=None):
    """The backward as a reverse scan in torch ops: the adjoint
    ``lam_t = dy_t + a_{t+1} lam_{t+1}`` is ``_scan`` over the reversed
    sequence with the decays shifted by one step.  log_a, hs (the forward's
    output), dy (B,S,W) -> ``(d log_a, d gated, d h0)`` fp32, ``d h0``
    None without ``h0``."""
    a = torch.exp(log_a.float())
    # a_{t+1} carries lam_{t+1} into step t; past the end nothing comes back
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    lam = _scan(a_next.flip(1), dy.float().flip(1)).flip(1)
    first = torch.zeros_like(a[:, 0]) if h0 is None else h0.float()
    h_prev = torch.cat([first[:, None], hs.float()[:, :-1]], dim=1)
    dh0 = None if h0 is None else a[:, 0] * lam[:, 0]
    return lam * a * h_prev, lam, dh0


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
            "the rglru forward kernel records no autograd graph and an "
            "input needs a gradient: use RGLRUFn (ops.rglru routes there)")
    y = torch.empty_like(log_a)
    _launch("repro_rglru_fwd", (log_a, gated, h0), (y,), "rglru")
    rglru.launches += 1
    return y


def _launch(name, ins, outs, what):
    """Checks the fp32 contiguous inputs and launches ``name`` on
    ``ins + outs`` (None for a null pointer) and a fresh workspace: each
    chunk's (product of decays, scan from zero), then the carries."""
    given = [t for t in ins if t is not None]
    if not all(t.dtype == torch.float32 for t in given):
        raise TypeError(f"{what} kernel takes float32, not "
                        f"{[t.dtype for t in given]}")
    if not all(t.is_contiguous() for t in given):
        raise ValueError(f"{what} kernel takes contiguous inputs")
    B, S, W = ins[0].shape
    n_chunks = -(-S // CHUNK)
    ws = torch.empty(2 * B * n_chunks * W, dtype=torch.float32,
                     device=ins[0].device)
    ptrs = [None if t is None else t.data_ptr() for t in ins + outs]
    with torch.cuda.device(ins[0].device):
        rc = _kernel(name, len(ptrs) + 1)(
            *ptrs, ws.data_ptr(), n_chunks, B, S, W,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed (code {rc}) for "
                           f"{tuple(ins[0].shape)}")


def rglru_bwd(log_a, hs, dy, *, h0=None):
    """log_a, hs (the forward's output), dy (B,S,W) fp32; h0 (B,W) or None
    -> ``(d log_a, d gated, d h0)`` (B,S,W) fp32, ``d h0`` (B,W) or None."""
    _check(log_a, hs, h0)
    _check(log_a, dy, h0)
    if log_a.device.type == "cpu":
        return rglru_bwd_plain(log_a, hs, dy, h0=h0)
    if log_a.device.type != "cuda":
        raise ValueError(f"rglru_bwd: unsupported device {log_a.device}")
    dla, dg = torch.empty_like(log_a), torch.empty_like(log_a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    _launch("repro_rglru_bwd", (log_a, hs, dy, h0), (dla, dg, dh0),
            "rglru_bwd")
    rglru_bwd.launches += 1
    return dla, dg, dh0


rglru.launches = 0
rglru_bwd.launches = 0


class RGLRUFn(torch.autograd.Function):
    """The differentiable recurrence, the same on both devices: ``rglru``
    and ``rglru_bwd`` decide, by the tensors' device alone, between the
    kernels and their plain versions.  Saves ``log_a``, the output ``hs``
    and ``h0`` (under activation checkpointing these are dropped and the
    forward runs again in the backward pass)."""

    @staticmethod
    def forward(ctx, log_a, gated, h0):
        hs = rglru(log_a, gated, h0=h0)
        ctx.save_for_backward(log_a, hs, h0)
        return hs

    @staticmethod
    def backward(ctx, dy):
        log_a, hs, h0 = ctx.saved_tensors
        dla, dg, dh0 = rglru_bwd(log_a, hs, dy.contiguous(), h0=h0)
        return dla, dg, dh0
