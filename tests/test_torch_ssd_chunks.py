"""The chunk-parallel SSD design of ``csrc/ssd.cu``, walked on the CPU.

The kernel computes the scan in three stages over chunks of 64 steps: (a)
each chunk's local state s_c = sum_m B_m (dt_m exp(clip(acum_end - acum_m,
-60))) x_m^T from a zero start, (b) the states entering the chunks by the
scalar recurrence h_c = exp(acum_end) h_{c-1} + s_c from ``h0``, (c) each
chunk's output (C B^T o decay o dt) x + exp(acum) C h_entering.  Here a
plain PyTorch version computes exactly those stages in fp32 and is held to
``ssd_plain`` at the same chunk length at 1e-5 (summation order only) and to
the reference -- its Pallas SSD kernel in interpret mode where S is a
multiple of the chunk, as ``tests/test_torch_ssm.py`` runs it, else its
padding oracle; ``ssd_chunked`` with ``h0`` -- at the reference's 2e-4.  The
cases cover a ragged last chunk, S shorter than one chunk, G > 1, ``h0``,
and B > 1 with a state that carries over several chunks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import ssm as ref_ssm

from repro_torch.kernels.ssd import ssd_plain

C = 64          # the kernel's chunk length (csrc SSD_C)
TOL = dict(atol=1e-5, rtol=1e-5)
TOL_REF = dict(atol=2e-4, rtol=2e-4)

CASES = [
    # B, S, H, P, G, N, small_dt
    (1, 256, 4, 16, 1, 32, False),    # four whole chunks
    (3, 100, 4, 16, 4, 16, False),    # ragged last chunk, G = 4
    (1, 40, 2, 16, 1, 32, False),     # S shorter than one chunk
    (2, 300, 6, 16, 3, 16, True),     # B > 1, G = 3, 5 chunks, slow decay
    (2, 192, 4, 32, 2, 16, True),     # B > 1, three whole chunks
]


def _inputs(B, S, H, P, G, N, small_dt, seed=0):
    """The reference tests' distributions; ``small_dt`` takes dt and A from
    the model's init ranges instead, so the state carries across chunks."""
    r = np.random.RandomState(seed)
    x = r.standard_normal((B, S, H, P)).astype(np.float32)
    z = r.standard_normal((B, S, H)) - (3.0 if small_dt else 0.0)
    dt = np.log1p(np.exp(z)).astype(np.float32)
    A = (-(1.0 + 15.0 * r.rand(H)) if small_dt
         else -np.exp(r.standard_normal(H))).astype(np.float32)
    Bm = (r.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    Cm = (r.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


def ssd_three_stage(x, dt, A, Bm, Cm, *, h0=None, c=C):
    """The kernel's three stages in plain PyTorch, fp32.  x (B,S,H,P); dt
    (B,S,H); A (H,); B/C (B,S,G,N); h0 (B,H,N,P) or None -> (y, h_final).
    Positions past S act as dt = 0."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S // c)
    pad = nc * c - S
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    Bm = torch.nn.functional.pad(Bm, (0, 0, 0, 0, 0, pad))
    Cm = torch.nn.functional.pad(Cm, (0, 0, 0, 0, 0, pad))
    xc = x.reshape(Bsz, nc, c, H, P)
    dtc = dt.reshape(Bsz, nc, c, H)
    Bh = Bm.reshape(Bsz, nc, c, G, N).repeat_interleave(H // G, dim=3)
    Ch = Cm.reshape(Bsz, nc, c, G, N).repeat_interleave(H // G, dim=3)
    acum = torch.cumsum(dtc * A, dim=2)                     # (B,nc,c,H)
    a_end = acum[:, :, -1]                                  # (B,nc,H)

    # (a) each chunk's local state, from zero
    w = dtc * torch.exp(torch.clamp(a_end[:, :, None] - acum, min=-60.0))
    s = torch.einsum("bjmhn,bjmhp->bjhnp", Bh * w[..., None], xc)

    # (b) the state entering each chunk, one scalar recurrence per element
    h = torch.zeros((Bsz, H, N, P)) if h0 is None else h0
    entering = []
    for j in range(nc):
        entering.append(h)
        h = torch.exp(a_end[:, j])[..., None, None] * h + s[:, j]
    hin = torch.stack(entering, dim=1)                      # (B,nc,H,N,P)

    # (c) each chunk's output
    at = acum.permute(0, 1, 3, 2)                           # (B,nc,H,c)
    decay = torch.exp(torch.clamp(at[..., :, None] - at[..., None, :],
                                  -60.0, 0.0))
    causal = torch.ones((c, c), dtype=torch.bool).tril()
    W = torch.einsum("bjlhn,bjmhn->bjhlm", Ch, Bh) * decay \
        * dtc.permute(0, 1, 3, 2)[..., None, :]
    W = torch.where(causal, W, 0.0)
    y = torch.einsum("bjhlm,bjmhp->bjlhp", W, xc) + \
        torch.exp(acum)[..., None] * torch.einsum("bjlhn,bjhnp->bjlhp", Ch,
                                                  hin)
    return y.reshape(Bsz, nc * c, H, P)[:, :S], h


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _reference(ins, S):
    js = [jnp.asarray(a) for a in ins]
    if S % C == 0:
        return ref_ops.ssd(*js, chunk=C, impl="pallas", interpret=True)
    # the reference's kernel asserts S % chunk == 0; its oracle pads
    return ref_ref.ssd_ref(*js, chunk=C)


@pytest.mark.parametrize("B,S,H,P,G,N,small_dt", CASES)
def test_three_stage_matches_plain_and_reference(B, S, H, P, G, N,
                                                 small_dt):
    ins = _inputs(B, S, H, P, G, N, small_dt)
    y, h = ssd_three_stage(*_t(*ins))
    assert y.shape == (B, S, H, P) and h.shape == (B, H, N, P)
    y2, h2 = ssd_plain(*_t(*ins), chunk=C)
    np.testing.assert_allclose(y.numpy(), y2.numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), h2.numpy(), **TOL)
    y3, h3 = _reference(ins, S)
    np.testing.assert_allclose(y.numpy(), np.asarray(y3), **TOL_REF)
    np.testing.assert_allclose(h.numpy(), np.asarray(h3), **TOL_REF)


@pytest.mark.parametrize("S", [160, 100])
def test_three_stage_with_initial_state(S):
    """A given h0 enters the first chunk's state passing: against
    ``ssd_plain(h0=...)`` and the reference's ``ssd_chunked(h0=...)``."""
    B, H, P, G, N = 2, 4, 16, 2, 16
    ins = _inputs(B, S, H, P, G, N, True, seed=3)
    h0 = np.random.RandomState(4).standard_normal(
        (B, H, N, P)).astype(np.float32)
    y, h = ssd_three_stage(*_t(*ins), h0=torch.from_numpy(h0))
    y2, h2 = ssd_plain(*_t(*ins), chunk=C, h0=torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), y2.numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), h2.numpy(), **TOL)
    if S % 32 == 0:
        y3, h3 = ref_ssm.ssd_chunked(*(jnp.asarray(a) for a in ins),
                                     chunk=32, h0=jnp.asarray(h0))
        np.testing.assert_allclose(y.numpy(), np.asarray(y3), **TOL_REF)
        np.testing.assert_allclose(h.numpy(), np.asarray(h3), **TOL_REF)


def test_three_stage_state_carries_and_chunks_are_independent():
    """Stage (b) is the only link between chunks: each chunk's output
    depends on the chunks before it only through the state entering it, so
    running the second half alone from the first half's final state gives
    the same outputs."""
    ins = _t(*_inputs(1, 256, 4, 16, 1, 32, True, seed=5))
    y, h = ssd_three_stage(*ins)
    first = [t[:, :128] if t.dim() > 1 else t for t in ins]
    second = [t[:, 128:] if t.dim() > 1 else t for t in ins]
    _, h_mid = ssd_three_stage(*first)
    y2, h2 = ssd_three_stage(*second, h0=h_mid)
    np.testing.assert_allclose(y[:, 128:].numpy(), y2.numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), h2.numpy(), **TOL)
    # and the state did carry: a zero start changes the second half
    y3, _ = ssd_three_stage(*second)
    assert float((y3 - y2).abs().max()) > 1e-3
