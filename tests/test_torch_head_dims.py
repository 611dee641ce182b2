"""Head dims: every full-size arch the port builds must find its head_dim
among those the attention kernels take on the card, and the port's plain
forward and backward at stablelm-12b's D = 160 must match the reference.

On the CPU the wrappers run their plain versions at any D, so a head dim the
CUDA kernels lack shows only on the card -- where the wrapper raises (no
fallback).  The first test reads the lists the wrappers check
(``HEAD_DIMS`` of ``flash_attention`` and ``paged_attention``,
``BWD_HEAD_DIMS`` of ``flash_attention_bwd``) against each arch's paths:
dense prefill (any attention block), paged decode (causal patterns of global
attention only: ``mode="auto"`` picks paged serving for them) and training
(any attention block: every block kind trains, ``ssm`` blocks through the
SSD backward, so a hybrid of SSM and attention blocks trains its attention
through B2 too).  All ten assigned archs are walked, the two MoE archs
(head dim 128) among them.

The D = 160 tests hold the plain forward to the reference's Pallas flash
kernel in interpret mode (2e-5) and the plain backward, through
``flash_attention_vjp``, to ``jax.grad`` of the reference's oracle (5e-4),
the tolerances of ``tests/test_torch_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.ref import attention_ref as ref_attention_ref

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.base import ATTN, ATTN_LOCAL
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels.flash_attention import (HEAD_DIMS as FWD_DIMS,
                                                 attention_plain)
from repro_torch.kernels.paged_attention import HEAD_DIMS as PAGED_DIMS


def _paths(cfg):
    """The kernels an arch's served and trained paths launch."""
    attn = set(cfg.pattern) & {ATTN, ATTN_LOCAL}
    global_only = all(b == ATTN for b in cfg.pattern)
    return {"flash_attention": bool(attn),
            "paged_decode_attention": global_only and cfg.causal,
            "flash_attention_bwd": bool(attn)}


# every assigned full-size arch, and the paper's BERT encoders (trained
# bidirectionally, never decoded)
BUILT = list(ASSIGNED_ARCHS) + ["bert-base", "bert-large"]


@pytest.mark.parametrize("arch", BUILT)
def test_every_built_arch_has_its_head_dim_in_the_kernels(arch):
    cfg = get_config(arch)
    lists = {"flash_attention": FWD_DIMS,
             "paged_decode_attention": PAGED_DIMS,
             "flash_attention_bwd": fab.BWD_HEAD_DIMS}
    missing = [name for name, used in _paths(cfg).items()
               if used and cfg.head_dim not in lists[name]]
    assert not missing, (f"{arch}: head_dim {cfg.head_dim} is not taken by "
                         f"{missing}")


def test_stablelm_12b_runs_every_attention_kernel_at_d160():
    cfg = get_config("stablelm-12b")
    assert cfg.head_dim == 160
    assert all(_paths(cfg).values())


def _inputs(B, S, T, H, K, D, seed=5):
    r = np.random.RandomState(seed)
    return [r.standard_normal(shape).astype(np.float32) for shape in
            ((B, S, H, D), (B, T, K, D), (B, T, K, D), (B, S, H, D))]


D160_CASES = [
    # B, S, T, H, K, causal, window
    (1, 128, 128, 8, 2, True, 0),      # stablelm's G = 4
    (2, 64, 64, 4, 1, True, 32),       # MQA, a window
    (1, 64, 128, 4, 4, False, 0),      # MHA, bidirectional, S != T
]


@pytest.mark.parametrize("B,S,T,H,K,causal,window", D160_CASES)
def test_plain_forward_at_d160_matches_the_reference_kernel(B, S, T, H, K,
                                                            causal, window):
    q, k, v, _ = _inputs(B, S, T, H, K, 160)
    want = ref_ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window, impl="pallas",
                             block_q=64, block_k=64, interpret=True)
    got = attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("B,S,T,H,K,causal,window", D160_CASES)
def test_plain_backward_at_d160_matches_jax_grad_of_the_oracle(
        B, S, T, H, K, causal, window):
    q, k, v, ct = _inputs(B, S, T, H, K, 160)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fab.flash_attention_vjp(*leaves, causal, window, 0.0)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), leaves)
    want = jax.grad(lambda q, k, v: jnp.sum(ref_attention_ref(
        q, k, v, causal=causal, window=window) * ct), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4,
                                   rtol=5e-4, err_msg=name)
