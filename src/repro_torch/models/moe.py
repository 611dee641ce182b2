"""Mixture-of-Experts FFN, held against ``repro/models/moe.py``.

Two execution paths, as in the reference:

  * ``dense``  -- every expert for every token, weighted by the gates: the
                  numerical oracle (``moe_dense``);
  * ``sorted`` -- sort-based dispatch under a capacity (``moe_sorted``):
                  each expert takes at most ``C`` of its assignments, in the
                  stable order of a sort by expert; the rest are dropped.

The reference's third path, ``ep`` (expert parallelism over a mesh), waits
for the parallel layer and raises.

Routing, sorting, dispatch and combine are plain PyTorch ops, as they are
XLA ops in the reference; the expert products are ``torch.bmm`` over the
expert axis (the reference's ``jnp.einsum``).  Nothing on the sorted path
reads a value back to the host and every shape follows from ``T`` alone, so
a serving step that runs it can be captured in a CUDA graph.  Nothing on it
accumulates by atomics either, so two runs give the same bits:

  * the counts per expert are an integer ``scatter_add_``;
  * dispatch writes each kept assignment to its own row of an
    ``(E * C + 1, d)`` buffer (``index_copy_``); dropped assignments write
    zeros to the one scratch row past the ``E * C`` slots, which is cut off;
  * combine gathers each token's ``k`` gate-weighted expert outputs into
    ``(T, k, d)`` (``index_select`` by the slot of each assignment, in the
    assignments' own order) and sums them over ``k``; the reference's
    scatter-add ``y.at[tid_s].add`` sums the same terms in another order.

Their gradients are gathers and sums of the same shape, so the backward has
no index-put with repeated indices either.

Shared experts are one wide ``layers.MLP`` of width ``n_shared_experts *
d_ff_shared`` (a sum of independent MLPs is a block-diagonal wide MLP).  The
router is fp32 whatever the model's dtype (``init_moe``: ``:37``), and stays
fp32 through ``LM.cast_weights_`` (one of the ``FP32_LEAVES``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

_EP = ("expert parallelism (impl='ep') is not ported yet: ROADMAP queue A "
       "item 7 (the parallel layer)")


class MoE(nn.Module):
    """The reference's ``init_moe`` layout: ``router`` (d, E) fp32, ``wi``
    and ``wg`` (E, d, f), ``wo`` (E, f, d), and ``shared`` (an ``MLP``)
    where the config has shared experts."""

    FP32_LEAVES = ("router",)

    def __init__(self, cfg: ModelConfig, *, generator=None,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        m, d = cfg.moe, cfg.d_model
        kw = dict(dtype=dtype, device=device)
        self.router = nn.Parameter(layers.dense_init(
            generator, (d, m.n_experts), dtype=torch.float32, device=device))
        self.wi = nn.Parameter(layers.dense_init(
            generator, (m.n_experts, d, m.d_ff_expert), **kw))
        self.wg = nn.Parameter(layers.dense_init(
            generator, (m.n_experts, d, m.d_ff_expert), **kw))
        self.wo = nn.Parameter(layers.dense_init(
            generator, (m.n_experts, m.d_ff_expert, d), **kw))
        if m.n_shared_experts:
            self.shared = layers.MLP(d, m.n_shared_experts * m.d_ff_shared,
                                     cfg.act, generator=generator, **kw)


def route(x2d, router_w, top_k: int):
    """x2d (T, d) -> gates (T, k) fp32 (renormalised), idx (T, k) int64,
    and the Switch load-balance term ``E * sum_e f_e p_e`` (``f_e`` from
    each token's first choice)."""
    logits = x2d.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    T, E = logits.shape
    me = probs.mean(dim=0)
    first = torch.zeros(E, dtype=torch.float32, device=x2d.device)
    first.scatter_add_(0, idx[:, 0], torch.ones_like(gates[:, 0]))
    aux = E * torch.sum(me * (first / T))
    return gates, idx, aux


def _expert_ffn(xe, wi, wg, wo, act: str):
    """xe (E, C, d); weights (E, d, f) / (E, f, d) -> (E, C, d)."""
    h = torch.bmm(xe, wi)
    if act == "swiglu":
        h = F.silu(h) * torch.bmm(xe, wg)
    elif act == "geglu":
        h = F.gelu(h, approximate="tanh") * torch.bmm(xe, wg)
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default form
    else:
        raise ValueError(act)
    return torch.bmm(h, wo)


def default_capacity(T: int, E: int, k: int, cf: float) -> int:
    c = int(math.ceil(T * k / E * cf))
    return max(4, min(T, c))


def moe_sorted(params: MoE, x2d, cfg: ModelConfig, *,
               compute_dtype=torch.bfloat16, capacity: Optional[int] = None,
               expert_slice: Optional[Tuple[int, int]] = None):
    """Sort-based dispatch under a capacity on one token set: (y (T, d) in
    the compute dtype, aux).

    ``expert_slice``: (start, count), computing only experts ``[start,
    start + count)``; assignments to the others contribute zero.  ``params``
    may then hold all experts or just that slice."""
    m, cd = cfg.moe, compute_dtype
    T, d = x2d.shape
    E, k = m.n_experts, m.top_k
    gates, idx, aux = route(x2d, params.router, k)
    C = capacity if capacity is not None else default_capacity(
        T, E, k, m.capacity_factor)
    dev = x2d.device

    eid = idx.reshape(-1)                              # (T*k,) t-major
    order = torch.argsort(eid, stable=True)
    eid_s = eid[order]
    counts = torch.zeros(E, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, eid_s, torch.ones_like(eid_s))
    offsets = torch.cumsum(counts, 0) - counts
    pos_s = torch.arange(T * k, device=dev) - offsets[eid_s]
    # each assignment's place in its expert's list, in assignment order
    pos = torch.empty_like(pos_s).scatter_(0, order, pos_s)
    keep = pos < C

    wi, wg, wo = params.wi, params.wg, params.wo
    erow, n_local = eid, E
    if expert_slice is not None:
        e0, en = expert_slice
        if wi.shape[0] != en:
            wi, wg, wo = wi[e0:e0 + en], wg[e0:e0 + en], wo[e0:e0 + en]
        keep = keep & (eid >= e0) & (eid < e0 + en)
        erow, n_local = eid - e0, en

    slot = erow * C + pos                              # (T*k,)
    scratch = n_local * C
    kept = keep.to(cd)[:, None]
    xk = x2d.to(cd)[:, None, :].expand(T, k, d).reshape(T * k, d) * kept
    buf = torch.zeros((scratch + 1, d), dtype=cd, device=dev)
    buf = buf.index_copy(0, torch.where(keep, slot, scratch), xk)
    ye = _expert_ffn(buf[:scratch].view(n_local, C, d), wi.to(cd),
                     wg.to(cd), wo.to(cd), cfg.act).reshape(scratch, d)
    contrib = ye.index_select(0, torch.where(keep, slot, 0)) * \
        (gates.reshape(-1) * keep)[:, None].to(cd)
    return contrib.view(T, k, d).sum(dim=1), aux


def moe_dense(params: MoE, x2d, cfg: ModelConfig,
              compute_dtype=torch.bfloat16):
    """Oracle: every expert for every token, gate-weighted."""
    m, cd = cfg.moe, compute_dtype
    gates, idx, aux = route(x2d, params.router, m.top_k)
    full = torch.zeros((x2d.shape[0], m.n_experts), dtype=torch.float32,
                       device=x2d.device).scatter_add(1, idx, gates)
    xe = x2d.to(cd)[None].expand((m.n_experts,) + tuple(x2d.shape))
    ye = _expert_ffn(xe, params.wi.to(cd), params.wg.to(cd),
                     params.wo.to(cd), cfg.act)        # (E, T, d)
    return torch.einsum("etd,te->td", ye, full.to(cd)), aux


def apply_moe(params: MoE, x, cfg: ModelConfig, *,
              compute_dtype=torch.bfloat16, impl: str = "sorted",
              capacity: Optional[int] = None):
    """x (B, S, d) -> (y (B, S, d), aux), the shared experts added."""
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    if impl == "dense":
        y2d, aux = moe_dense(params, x2d, cfg, compute_dtype)
    elif impl == "sorted":
        y2d, aux = moe_sorted(params, x2d, cfg, compute_dtype=compute_dtype,
                              capacity=capacity)
    elif impl == "ep":
        raise NotImplementedError(_EP)
    else:
        raise ValueError(f"MoE impl {impl!r} not in ('sorted', 'dense', "
                         f"'ep')")
    y = y2d.reshape(B, S, d)
    if cfg.moe.n_shared_experts:
        y = y + layers.apply_mlp(params.shared, x, cfg.act, compute_dtype)
    return y, aux
