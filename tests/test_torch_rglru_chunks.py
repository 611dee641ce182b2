"""The chunked RG-LRU scan of ``csrc/rglru.cu``, walked on the CPU.

The kernel computes ``h_t = exp(log_a_t) h_{t-1} + gated_t`` over chunks of
``CHUNK`` = 64 steps in three passes: (a) each chunk's composite, ``A_c``
(the product of its decays, multiplied step by step) and ``e_c`` (its scan
from zero); (b) the carries ``h_c = A_c h_{c-1} + e_c`` from ``h0`` or zero;
(c) each chunk again from its entering carry with the serial arithmetic.
Here a plain PyTorch version runs exactly those passes in fp32 and is held
to ``rglru_plain`` at 1e-5 and to the reference's Pallas RG-LRU in interpret
mode at 2e-5, as ``tests/test_torch_rglru.py`` runs it.  The cases cover a
ragged last chunk, S shorter than one chunk, B > 1 and ``h0``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops

from repro_torch.kernels.rglru import CHUNK, rglru_plain

TOL = dict(atol=1e-5, rtol=1e-5)
TOL_REF = dict(atol=2e-5, rtol=2e-5)


def _inputs(B, S, W, seed=0):
    r = np.random.RandomState(seed)
    log_a = -np.log1p(np.exp(r.standard_normal((B, S, W)))).astype(
        np.float32)
    gated = r.standard_normal((B, S, W)).astype(np.float32)
    h0 = r.standard_normal((B, W)).astype(np.float32)
    return log_a, gated, h0


def _walk(log_a, gated, h, y=None):
    """Steps of one chunk from ``h`` (B, W), one at a time as a thread of
    the kernel walks them: returns (product of the decays, h)."""
    a = torch.ones_like(h)
    for t in range(log_a.shape[1]):
        at = torch.exp(log_a[:, t])
        a = a * at
        h = at * h + gated[:, t]
        if y is not None:
            y[:, t] = h
    return a, h


def rglru_three_pass(log_a, gated, h0=None, c=CHUNK):
    """The kernel's three passes in plain PyTorch, fp32: log_a/gated
    (B,S,W), h0 (B,W) or None -> hs (B,S,W)."""
    B, S, W = log_a.shape
    nc = -(-S // c)
    zero = torch.zeros((B, W))
    # (a) each chunk's composite from zero; the last chunk's is not needed
    comp = [_walk(log_a[:, j * c:(j + 1) * c], gated[:, j * c:(j + 1) * c],
                  zero) for j in range(nc - 1)]
    # (b) the carry entering each chunk
    h = zero if h0 is None else h0
    entering = []
    for j in range(nc):
        entering.append(h)
        if j < nc - 1:
            a_c, e_c = comp[j]
            h = a_c * h + e_c
    # (c) each chunk from its entering carry
    y = torch.empty((B, S, W))
    for j in range(nc):
        sl = slice(j * c, (j + 1) * c)
        _walk(log_a[:, sl], gated[:, sl], entering[j], y[:, sl])
    return y


CASES = [
    # B, S, W
    (1, 200, 48),      # a ragged last chunk (3 x 64 + 8)
    (2, 40, 32),       # S shorter than one chunk, B > 1
    (3, 256, 16),      # B > 1, four whole chunks
    (1, 1, 24),        # one step
]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,W", CASES)
def test_three_passes_match_plain_and_reference_kernel(B, S, W, with_h0):
    log_a, gated, h0 = _inputs(B, S, W)
    la, g = torch.from_numpy(log_a), torch.from_numpy(gated)
    h = torch.from_numpy(h0) if with_h0 else None
    got = rglru_three_pass(la, g, h)
    np.testing.assert_allclose(got.numpy(), rglru_plain(la, g, h0=h).numpy(),
                               **TOL)
    if with_h0:
        return          # the reference's Pallas kernel takes no h0
    # the reference's kernel asserts that its block divides S
    want = ref_ops.rglru(jnp.asarray(log_a), jnp.asarray(gated),
                         block_seq=math.gcd(S, 64), impl="pallas",
                         interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_REF)


def test_chunk_zero_is_the_serial_arithmetic_exactly():
    """The first chunk runs from h0 with the serial arithmetic itself; only
    a later chunk's entering carry is rounded differently (A_c h + e_c)."""
    log_a, gated, h0 = _inputs(2, 150, 8, seed=3)
    la, g, h = (torch.from_numpy(x) for x in (log_a, gated, h0))
    got = rglru_three_pass(la, g, h)
    serial = torch.empty_like(got)
    _walk(la, g, h, serial)
    assert torch.equal(got[:, :CHUNK], serial[:, :CHUNK])
    np.testing.assert_allclose(got.numpy(), serial.numpy(), **TOL)
