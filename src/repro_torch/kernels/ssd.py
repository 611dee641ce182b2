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
of CUDA kernels the call takes.  The forward kernel records no graph:
called on CUDA tensors where autograd needs a gradient, it raises, and
``SSDFn`` is the differentiable form.  ``ssd(..., keep_states=True)`` also
returns the two scratch tensors (the state entering each of the kernel's
chunks and each chunk's acum_end), which the backward reads.

The backward has no TPU kernel: the reference differentiates its XLA scan
(``ssd_chunked``, ``repro/models/ssm.py:38``).  ``ssd_bwd`` wraps the
hand-written ``repro_ssd_bwd`` (the forward's three stages mirrored: each
chunk's C^T dy, the state gradients passed from the last chunk to the first,
each chunk's dx, ddt and dB / dC, then the sums over a group's partials and
over the chunks for dA, in a fixed order).  ``bwd_design`` says which
design serves a width and dtype: bf16 on the tensor cores (split fp32
operands as in the forward; one block walks a slice of a group's heads and
keeps their dB / dC sums), fp32 on the CUDA cores (one partial per head).
``ssd_bwd_plain`` is the same analytical backward in chunked torch ops,
independent of autograd; ``SSDFn`` joins the forward and the backward.  It
saves x, dt, A, B, C, h0 and the forward's chunk states (under activation
checkpointing these are dropped and the forward runs again in the backward
pass).  ``ssd_bwd.launches`` counts as ``ssd.launches`` does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (DESIGNS, check_aligned,
                                                 needs_grad)

CHUNK = 256      # the plain version's chunk: the reference's DEFAULT_SSD_CHUNK
# the kernels' own chunk length (csrc/ssd.cu SSD_C, which ``kernel_chunk``
# reads from the library): they run it whatever ``chunk`` they are passed
KERNEL_CHUNK = 64
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


def ssd(x, dt, A, Bm, Cm, *, chunk: int = CHUNK, h0=None,
        keep_states: bool = False):
    """x (B,S,H,P); dt (B,S,H); A (H,); B/C (B,S,G,N) -> (y (B,S,H,P) fp32,
    h_final (B,H,N,P) fp32).  Any S (ragged ends act as dt = 0) and any
    G dividing H.  ``chunk`` is the plain version's chunk length; the kernel
    uses its own (``kernel_chunk``: SSD does not depend on the chunk length
    beyond rounding).  ``keep_states``: also return the kernel's scratch,
    (states (B,chunks,H,N,P), the state entering each chunk, and aend
    (B,chunks,H)) -- both None for CPU tensors, whose plain version has
    none."""
    _check(x, dt, A, Bm, Cm, h0)
    if x.device.type == "cpu":
        out = ssd_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
        return out + (None, None) if keep_states else out
    if x.device.type != "cuda":
        raise ValueError(f"ssd: unsupported device {x.device}")
    if needs_grad(x, dt, A, Bm, Cm, *([h0] if h0 is not None else [])):
        raise RuntimeError(
            "the ssd forward kernel records no autograd graph and an input "
            "needs a gradient: use SSDFn (ops.ssd routes there)")
    _check_kernel_inputs(x, dt, A, Bm, Cm, h0, "ssd")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
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
    return (y, hout, states, aend) if keep_states else (y, hout)


def _check_kernel_inputs(x, dt, A, Bm, Cm, h0, what, more=()):
    """The dtypes, contiguity and alignment the kernels take; ``more`` are
    further fp32 inputs (dy, dh_final, the saved states)."""
    if x.dtype not in _DTYPE_CODE or not (x.dtype == Bm.dtype == Cm.dtype):
        raise TypeError(f"{what} kernel takes x, B, C in one of float32 / "
                        f"bfloat16, not {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    fp32 = [dt, A] + [t for t in (h0, *more) if t is not None]
    if not all(t.dtype == torch.float32 for t in fp32):
        raise TypeError(f"{what} kernel takes dt, A, h0 (and dy, dh_final, "
                        f"the saved states) in float32")
    ins = [x, Bm, Cm] + fp32
    if not all(t.is_contiguous() for t in ins):
        raise ValueError(f"{what} kernel takes contiguous inputs")
    check_aligned(*ins)


def ssd_bwd_plain(x, dt, A, Bm, Cm, dy, *, dh_final=None, h0=None,
                  chunk: int = CHUNK):
    """The SSD's backward, written out (not autograd) in chunked torch ops,
    all math fp32.  dy (B,S,H,P) and dh_final (B,H,N,P) or None are the
    gradients of y and h_final.  Returns (dx, ddt, dA, dB, dC, dh0) fp32,
    dB / dC summed over the heads of each group, dh0 None without ``h0``.

    Per chunk, with W_lm = (C_l . B_m) D_lm dt_m (D_lm = exp(clip(acum_l -
    acum_m, -60, 0)), m <= l), R_m = exp(max(acum_end - acum_m, -60)), h_c
    the state entering chunk c and G_c the gradient of the state leaving it
    (G_{c-1} = exp(acum_end) G_c + sum_l exp(acum_l) C_l dy_l^T, from
    dh_final): dx = W^T dy + dt R B G_c; dB = K^T C + dt R x G_c^T and
    dC = K B + exp(acum) dy h_c^T with K_lm = (dy_l . x_m) D_lm dt_m; ddt
    the direct terms plus A times the reverse cumsum over the chunk of the
    gradient of acum.  That gradient collects the clipped decays' +/- terms,
    exp(acum_l) dy_l . (C_l h_c), the -dt_m R_m (B_m . G_c x_m) of each
    state term and, at the chunk's last step, exp(acum_end) <G_c, h_c> plus
    the same state terms with the opposite sign.  A clipped exp passes no
    gradient to its argument."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    L = chunk
    nc = -(-S // L)
    pad = nc * L - S
    f = torch.nn.functional.pad
    x, dt, A, Bm, Cm, dy = (t.float() for t in (x, dt, A, Bm, Cm, dy))
    x, dy = (f(t, (0, 0, 0, 0, 0, pad)) for t in (x, dy))
    dt = f(dt, (0, 0, 0, pad))
    Bm, Cm = (f(t, (0, 0, 0, 0, 0, pad)) for t in (Bm, Cm))
    xc = x.reshape(Bsz, nc, L, H, P)
    dyc = dy.reshape(Bsz, nc, L, H, P)
    dtc = dt.reshape(Bsz, nc, L, H)
    Bh = Bm.reshape(Bsz, nc, L, G, N).repeat_interleave(hpg, dim=3)
    Ch = Cm.reshape(Bsz, nc, L, G, N).repeat_interleave(hpg, dim=3)
    acum = torch.cumsum(dtc * A, dim=2)                     # (B,nc,L,H)
    aend = acum[:, :, -1]                                   # (B,nc,H)
    rest = aend[:, :, None] - acum
    R = torch.exp(torch.clamp(rest, min=-60.0))
    dtR = dtc * R

    # the state entering each chunk (forward), then the gradient of the
    # state leaving each chunk (from the last chunk back)
    local = torch.einsum("bjmhn,bjmhp->bjhnp", Bh * dtR[..., None], xc)
    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    hin = []
    for j in range(nc):
        hin.append(h)
        h = torch.exp(aend[:, j])[..., None, None] * h + local[:, j]
    hin = torch.stack(hin, dim=1)                           # (B,nc,H,N,P)
    u = torch.einsum("bjlhn,bjlhp->bjhnp", Ch * torch.exp(acum)[..., None],
                     dyc)
    g = torch.zeros_like(h) if dh_final is None else dh_final.float()
    gout = [None] * nc
    for j in reversed(range(nc)):
        gout[j] = g
        g = torch.exp(aend[:, j])[..., None, None] * g + u[:, j]
    dh0 = None if h0 is None else g
    gout = torch.stack(gout, dim=1)                         # (B,nc,H,N,P)

    # the chunks' local terms, (l, m) = (output step, input step)
    at = acum.permute(0, 1, 3, 2)                           # (B,nc,H,L)
    diff = at[..., :, None] - at[..., None, :]              # (B,nc,H,L,L)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    D = torch.where(causal, torch.exp(torch.clamp(diff, -60.0, 0.0)), 0.0)
    live = causal & (diff >= -60.0) & (diff <= 0.0)
    dt_m = dtc.permute(0, 1, 3, 2)[..., None, :]            # (B,nc,H,1,L)
    CB = torch.einsum("bjlhn,bjmhn->bjhlm", Ch, Bh)
    Q = torch.einsum("bjlhp,bjmhp->bjhlm", dyc, xc)         # dy_l . x_m
    W = CB * D * dt_m
    K = Q * D * dt_m
    V = CB * D * Q
    E = torch.where(live, V * dt_m, 0.0)
    XG = torch.einsum("bjmhp,bjhnp->bjmhn", xc, gout)
    DH = torch.einsum("bjlhp,bjhnp->bjlhn", dyc, hin)
    dx = torch.einsum("bjhlm,bjlhp->bjmhp", W, dyc) + dtR[..., None] * \
        torch.einsum("bjmhn,bjhnp->bjmhp", Bh, gout)
    dBh = torch.einsum("bjhlm,bjlhn->bjmhn", K, Ch) + dtR[..., None] * XG
    dCh = torch.einsum("bjhlm,bjmhn->bjlhn", K, Bh) + \
        torch.exp(acum)[..., None] * DH
    z = R * (Bh * XG).sum(-1)                               # (B,nc,L,H)
    s = torch.where(rest >= -60.0, dtc * z, 0.0)
    gacum = (E.sum(-1) - E.sum(-2)).permute(0, 1, 3, 2) + \
        torch.exp(acum) * (Ch * DH).sum(-1) - s
    last = torch.exp(aend) * (gout * hin).sum((-2, -1)) + s.sum(2)
    gacum = torch.cat([gacum[:, :, :-1], gacum[:, :, -1:] + last[:, :, None]],
                      dim=2)
    ga = torch.flip(torch.cumsum(torch.flip(gacum, [2]), 2), [2])
    ddt = A * ga + V.sum(-2).permute(0, 1, 3, 2) + z
    dA = (dtc * ga).sum((0, 1, 2))
    dB = dBh.reshape(Bsz, nc, L, G, hpg, N).sum(4)
    dC = dCh.reshape(Bsz, nc, L, G, hpg, N).sum(4)
    return (dx.reshape(Bsz, nc * L, H, P)[:, :S],
            ddt.reshape(Bsz, nc * L, H)[:, :S], dA,
            dB.reshape(Bsz, nc * L, G, N)[:, :S],
            dC.reshape(Bsz, nc * L, G, N)[:, :S], dh0)


_bwd_fn = None
_slices_fn = None


def _bwd_kernel():
    global _bwd_fn, _slices_fn
    if _bwd_fn is None:
        lib = build.load()
        fn = lib.repro_ssd_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 8 + \
            [ctypes.c_void_p]
        lib.repro_ssd_bwd_slices.restype = ctypes.c_int
        lib.repro_ssd_bwd_slices.argtypes = [ctypes.c_int] * 4
        _slices_fn = lib.repro_ssd_bwd_slices
        _bwd_fn = fn
    return _bwd_fn


def bwd_design(head_dim: int, d_state: int, dtype) -> str:
    """The design ``ssd_bwd`` launches for (P, N, dtype): "mma.sync"
    (tensor cores) or "cuda-cores"; builds the library if needed."""
    fn = build.load().repro_ssd_bwd_design
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    return DESIGNS[fn(int(head_dim), int(d_state), _DTYPE_CODE[dtype])]


def bwd_slices(heads_per_group: int, head_dim: int, d_state: int,
               dtype) -> int:
    """The number of dB / dC partials per group in ``ssd_bwd``'s scratch:
    one per head on the CUDA cores, one per slice of heads that a block
    walks on the tensor cores; builds the library if needed."""
    _bwd_kernel()
    return _slices_fn(int(heads_per_group), int(head_dim), int(d_state),
                      _DTYPE_CODE[dtype])


def ssd_bwd(x, dt, A, Bm, Cm, dy, *, states=None, aend=None, dh_final=None,
            h0=None, chunk: int = CHUNK):
    """The SSD's backward: x, dt, A, B, C, h0 as ``ssd`` took them, dy
    (B,S,H,P) fp32, dh_final (B,H,N,P) fp32 or None (zero), and on the card
    the forward's ``states`` and ``aend`` (``ssd(..., keep_states=True)``).
    Returns (dx in x's dtype, ddt fp32, dA (H,) fp32, dB and dC in B's dtype
    summed over each group's heads, dh0 fp32 or None without ``h0``).  For
    CPU tensors the plain version runs (at ``chunk``; the states are not
    read)."""
    _check(x, dt, A, Bm, Cm, h0)
    if dy.shape != x.shape or (dh_final is not None and
                               dh_final.shape != (x.shape[0], x.shape[2],
                                                  Bm.shape[3], x.shape[3])):
        raise ValueError(f"ssd_bwd: dy {tuple(dy.shape)} / dh_final "
                         f"{None if dh_final is None else tuple(dh_final.shape)}"
                         f" do not match x {tuple(x.shape)}")
    if x.device.type == "cpu":
        dx, ddt, dA, dB, dC, dh0 = ssd_bwd_plain(
            x, dt, A, Bm, Cm, dy, dh_final=dh_final, h0=h0, chunk=chunk)
        return (dx.to(x.dtype), ddt, dA, dB.to(Bm.dtype), dC.to(Cm.dtype),
                dh0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_bwd: unsupported device {x.device}")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S // kernel_chunk())
    if states is None or aend is None or \
            states.shape != (Bsz, nc, H, N, P) or aend.shape != (Bsz, nc, H):
        raise ValueError("ssd_bwd on the card reads the forward's states "
                         "(B,chunks,H,N,P) and aend (B,chunks,H): pass those "
                         "of ssd(..., keep_states=True)")
    _check_kernel_inputs(x, dt, A, Bm, Cm, h0, "ssd_bwd",
                         (dy, dh_final, states, aend))
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    ddt = torch.empty((Bsz, S, H), **f32)
    dA = torch.empty((H,), **f32)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dh0 = None if h0 is None else torch.empty((Bsz, H, N, P), **f32)
    # scratch: each chunk's C^T dy, overwritten with the gradient of the
    # state leaving it; dB / dC partials of each group; dA per (batch,
    # chunk, head)
    gstates = torch.empty((Bsz, nc, H, N, P), **f32)
    nsl = bwd_slices(H // G, P, N, x.dtype)
    dB_part = torch.empty((Bsz, S, G * nsl, N), **f32)
    dC_part = torch.empty((Bsz, S, G * nsl, N), **f32)
    dA_part = torch.empty((Bsz, nc, H), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        rc = _bwd_kernel()(
            *map(ptr, (x, dt, A, Bm, Cm, dy, dh_final, states, aend, dx,
                       ddt, dA, dB, dC, dh0, gstates, dB_part, dC_part,
                       dA_part)),
            nc, Bsz, S, H, P, G, N, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"ssd_bwd kernel launch failed (code {rc}) for x "
            f"{tuple(x.shape)} B {tuple(Bm.shape)} {x.dtype}")
    ssd_bwd.launches += 1
    return dx, ddt, dA, dB, dC, dh0


ssd.launches = 0
ssd_bwd.launches = 0


class SSDFn(torch.autograd.Function):
    """The differentiable SSD, the same on both devices: ``ssd`` and
    ``ssd_bwd`` decide, by the tensors' device alone, between the kernels
    and their plain versions.  ``apply(x, dt, A, B, C, h0, chunk)`` -> (y,
    h_final).  A gradient of h_final that autograd does not need arrives as
    None, and the backward's state pass then starts from zero."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0, chunk):
        y, h, states, aend = ssd(x, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                                 keep_states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, h0, states, aend)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, Bm, Cm, h0, states, aend = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx, ddt, dA, dB, dC, dh0 = ssd_bwd(
            x, dt, A, Bm, Cm, dy.contiguous(), states=states, aend=aend,
            dh_final=None if dh is None else dh.contiguous(), h0=h0,
            chunk=ctx.chunk)
        return dx, ddt, dA, dB, dC, dh0, None
