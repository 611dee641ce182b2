"""Mamba-2 chunked SSD scan: wrapper of the CUDA kernels ``csrc/ssd.cu`` and,
beside them, their plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/ssd.py`` (``ssd`` / ``_ssd_kernel``);
``ssd_plain`` is a copy of the model path's ``ssd_chunked``
(``repro/models/ssm.py:38-106``), padding and all, with an optional ``h0``.
The kernel is chunk-parallel: one call launches three kernels on the current
stream -- the chunks' local states, the state passing across chunks, the
chunks' outputs -- with two scratch tensors that the wrapper allocates.  The
source note in the ``.cu`` file says how they are laid out, and ``design``
which products run where (bf16 on the tensor cores with fp32 operands split
into two bf16 halves, fp32 on the CUDA cores).

``ssd`` launches the kernels for CUDA tensors -- or raises: there is no
fallback -- and runs ``ssd_plain`` only for tensors that lie on the CPU.
``ssd.launches`` counts calls that launched: one per call, whatever number
of CUDA kernels the call takes.  The kernel has no backward (nor has the
reference's): called on CUDA tensors where autograd needs a gradient, it
raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (DESIGNS, check_aligned,
                                                 needs_grad)

CHUNK = 256      # the plain version's chunk: the reference's DEFAULT_SSD_CHUNK
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_fn = None
_chunk = None


def _kernel():
    global _fn, _chunk
    if _fn is None:
        lib = build.load()
        fn = lib.repro_ssd_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + \
            [ctypes.c_void_p]
        lib.repro_ssd_chunk.restype = ctypes.c_int
        lib.repro_ssd_chunk.argtypes = []
        _chunk = lib.repro_ssd_chunk()
        _fn = fn
    return _fn


def kernel_chunk() -> int:
    """The chunk length of the kernels' scratch tensors (``csrc/ssd.cu``
    ``SSD_C``), read once with the entry point; builds the library if
    needed."""
    _kernel()
    return _chunk


def design(head_dim: int, d_state: int, dtype) -> str:
    """The design ``ssd`` launches for heads of ``head_dim`` (P) and a state
    of ``d_state`` (N) in ``dtype``: "mma.sync" (tensor cores) or
    "cuda-cores", both chunk-parallel; builds the library if needed."""
    fn = build.load().repro_ssd_design
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    return DESIGNS[fn(int(head_dim), int(d_state), _DTYPE_CODE[dtype])]


def ssd_plain(x, dt, A, Bm, Cm, *, chunk: int = CHUNK, h0=None):
    """The reference's chunked dual form in plain PyTorch, all math fp32.

    x (B,S,H,P); dt (B,S,H); A (H,); B/C (B,S,G,N); h0 (B,H,N,P) or None.
    Returns (y (B,S,H,P) fp32, h_final (B,H,N,P) fp32).  A ragged last chunk
    is padded with dt = 0 steps (decay 1, zero input: the state passes
    through unchanged).
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    S_orig = S
    if S % chunk:
        pad = chunk - S % chunk
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // chunk
    x, dt, A, Bm, Cm = (t.float() for t in (x, dt, A, Bm, Cm))
    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    idx = torch.arange(chunk, device=x.device)
    causal = idx[:, None] >= idx[None, :]                   # (L, L)
    ys = []
    for j in range(nc):
        sl = slice(j * chunk, (j + 1) * chunk)
        xc, dtc, Bc, Cc = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        a = dtc * A                                         # (B,L,H)
        acum = torch.cumsum(a, dim=1)
        # intra-chunk (attention-like dual form)
        CB = torch.einsum("blgn,bmgn->bglm", Cc, Bc)        # (B,G,L,L)
        CB = CB.repeat_interleave(hpg, dim=1)               # (B,H,L,L)
        decay = torch.exp(torch.clamp(
            acum[:, :, None, :] - acum[:, None, :, :], -60.0, 0.0))
        decay = torch.where(causal[None, :, :, None], decay, 0.0)
        W = CB.permute(0, 2, 3, 1) * decay * dtc[:, None, :, :]
        y_intra = torch.einsum("blmh,bmhp->blhp", W, xc)
        # inter-chunk (contribution of the incoming state)
        Ch = Cc.repeat_interleave(hpg, dim=2)               # (B,L,H,N)
        y_inter = torch.exp(acum)[..., None] * torch.einsum(
            "blhn,bhnp->blhp", Ch, h)
        # state update
        rest = torch.exp(torch.clamp(acum[:, -1:, :] - acum, min=-60.0))
        Bh = Bc.repeat_interleave(hpg, dim=2)
        contrib = torch.einsum("bmhn,bmhp->bhnp",
                               Bh * (dtc * rest)[..., None], xc)
        h = torch.exp(acum[:, -1, :])[..., None, None] * h + contrib
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    return y[:, :S_orig], h


def _check(x, dt, A, Bm, Cm, h0):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4 or \
            Cm.shape != Bm.shape:
        raise ValueError(
            f"ssd: want x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,G,N); got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
            f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    Bsz, S, H, P = x.shape
    if dt.shape != (Bsz, S, H) or A.shape != (H,) or \
            Bm.shape[:2] != (Bsz, S) or H % Bm.shape[2]:
        raise ValueError(
            f"ssd: shapes do not agree: x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, A {tuple(A.shape)}, B {tuple(Bm.shape)}")
    if h0 is not None and h0.shape != (Bsz, H, Bm.shape[3], P):
        raise ValueError(f"ssd: h0 {tuple(h0.shape)} is not (B,H,N,P)")
    tensors = [x, dt, A, Bm, Cm] + ([h0] if h0 is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("ssd: all inputs must share one device")


def ssd(x, dt, A, Bm, Cm, *, chunk: int = CHUNK, h0=None):
    """x (B,S,H,P); dt (B,S,H); A (H,); B/C (B,S,G,N) -> (y (B,S,H,P) fp32,
    h_final (B,H,N,P) fp32).  Any S (ragged ends act as dt = 0) and any
    G dividing H.  ``chunk`` is the plain version's chunk length; the kernel
    uses its own (``kernel_chunk``: SSD does not depend on the chunk length
    beyond rounding)."""
    _check(x, dt, A, Bm, Cm, h0)
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: unsupported device {x.device}")
    if needs_grad(x, dt, A, Bm, Cm, *([h0] if h0 is not None else [])):
        raise RuntimeError(
            "the ssd kernel has no backward (nor has the reference's) and "
            "an input needs a gradient: training the recurrent archs is "
            "ROADMAP queue A item 10")
    if x.dtype not in _DTYPE_CODE or not (x.dtype == Bm.dtype == Cm.dtype):
        raise TypeError(f"ssd kernel takes x, B, C in one of float32 / "
                        f"bfloat16, not {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if not (dt.dtype == A.dtype == torch.float32) or \
            (h0 is not None and h0.dtype != torch.float32):
        raise TypeError("ssd kernel takes dt, A and h0 in float32")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    ins = (x, dt, A, Bm, Cm) + ((h0,) if h0 is not None else ())
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("ssd kernel takes contiguous inputs")
    check_aligned(*ins)
    nc = -(-S // kernel_chunk())
    y = torch.empty((Bsz, S, H, P), dtype=torch.float32, device=x.device)
    hout = torch.empty((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    # scratch: each chunk's local state, overwritten with the state entering
    # it, and each chunk's acum_end
    states = torch.empty((Bsz, nc, H, N, P), dtype=torch.float32,
                         device=x.device)
    aend = torch.empty((Bsz, nc, H), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _kernel()(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                       Bm.data_ptr(), Cm.data_ptr(),
                       h0.data_ptr() if h0 is not None else None,
                       y.data_ptr(), hout.data_ptr(), states.data_ptr(),
                       aend.data_ptr(), nc, Bsz, S, H, P, G, N,
                       _DTYPE_CODE[x.dtype],
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"ssd kernel launch failed (code {rc}) for x {tuple(x.shape)} "
            f"B {tuple(Bm.shape)} {x.dtype}")
    ssd.launches += 1
    return y, hout


ssd.launches = 0
