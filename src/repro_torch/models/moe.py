"""Mixture-of-Experts FFN, held against ``repro/models/moe.py``.

Two execution paths, as in the reference:

  * ``dense``  -- every expert for every token, weighted by the gates: the
                  numerical oracle (``moe_dense``);
  * ``sorted`` -- sort-based dispatch under a capacity (``moe_sorted``):
                  each expert takes at most ``C`` of its assignments, in the
                  stable order of a sort by expert; the rest are dropped.

and the reference's third, ``ep`` (``_moe_ep``): experts over a mesh's tp
axis, tokens replicated over it.  The router runs on every rank of the axis
(the same tokens, the same gates); each rank dispatches to, computes and
combines its ``E / tp`` experts only (``moe_sorted`` with an expert slice)
under the capacity of its data shard, and the ranks' outputs are summed.

Under a mesh without the tp axis the sorted path is the reference's
GSPMD partitioning of the global batch's function
(``repro/train/trainer.py:91-111``, ``moe.py:76-99``): with ``dp_group``
(the dp axes that split the rows) each rank routes its own tokens, one
all-gather of the ranks' per-expert counts (E integers) gives each
assignment its place in the global batch's stable order (the counts of the
ranks before it plus its local place), the capacity is the global batch's,
and the load-balance term is made of all-reduced means.  The experts run
locally on the kept tokens; nothing else crosses ranks.

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


def route(x2d, router_w, top_k: int, dp_group=None):
    """x2d (T, d) -> gates (T, k) fp32 (renormalised), idx (T, k) int64,
    and the Switch load-balance term ``E * sum_e f_e p_e`` (``f_e`` from
    each token's first choice).  With ``dp_group`` the rows are this rank's
    of a global batch of ``T * size`` (equal pieces) and the term is the
    global batch's: ``p_e`` the ranks' means summed at ``1 / size`` each
    (its gradient summed back over the ranks), ``f_e`` the summed counts."""
    logits = x2d.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    T, E = logits.shape
    me = probs.mean(dim=0)
    first = torch.zeros(E, dtype=torch.float32, device=x2d.device)
    first.scatter_add_(0, idx[:, 0], torch.ones_like(gates[:, 0]))
    if dp_group is not None:
        from repro_torch.core import hierarchy
        n = dp_group.size
        me = hierarchy.tp_psum(me * (1.0 / n), dp_group)
        first = hierarchy.all_reduce(first, dp_group)
        T = T * n
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
               expert_slice: Optional[Tuple[int, int]] = None,
               dp_group=None):
    """Sort-based dispatch under a capacity on one token set: (y (T, d) in
    the compute dtype, aux).

    ``expert_slice``: (start, count), computing only experts ``[start,
    start + count)``; assignments to the others contribute zero.  ``params``
    may then hold all experts or just that slice.  ``dp_group``: ``x2d`` is
    this rank's rows of the global batch (module docstring)."""
    gates, idx, aux = route(x2d, params.router, cfg.moe.top_k,
                            dp_group=dp_group)
    return _dispatch(params.wi, params.wg, params.wo, x2d, gates, idx, cfg,
                     compute_dtype, capacity, expert_slice,
                     dp_group), aux


def _dispatch(wi, wg, wo, x2d, gates, idx, cfg: ModelConfig, compute_dtype,
              capacity: Optional[int], expert_slice, dp_group=None):
    """``moe_sorted``'s dispatch, expert products and combine for routed
    tokens (``route``'s gates and expert ids).  With ``dp_group`` the
    capacity and each assignment's place are the global batch's (module
    docstring); a kept assignment's row in its expert's buffer is its local
    place, which is below the global one."""
    m, cd = cfg.moe, compute_dtype
    T, d = x2d.shape
    E, k = m.n_experts, m.top_k
    n_dp = dp_group.size if dp_group is not None else 1
    C = capacity if capacity is not None else default_capacity(
        T * n_dp, E, k, m.capacity_factor)
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
    if dp_group is not None:
        # the ranks' rows in rank order: the assignments of the ranks
        # before this one come first in each expert's list
        import torch.distributed as dist
        from repro_torch.core import hierarchy
        every = hierarchy.all_gather(counts[None], dp_group, 0)   # (n, E)
        before = every[:dist.get_rank(dp_group.pg)].sum(dim=0)
        keep = pos + before[eid] < C
    else:
        keep = pos < C

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
    return contrib.view(T, k, d).sum(dim=1)


def _moe_ep(params: MoE, x2d, cfg: ModelConfig, compute_dtype, pctx,
            capacity: Optional[int]):
    """Expert parallelism, held against ``repro/models/moe.py:175-254``:
    the experts over ``pctx``'s tp axis, the tokens (this rank's data
    shard) replicated over it.  Every rank routes every token (outside the
    tensor-parallel region: the router's gradient is whole on each rank);
    the gates enter the region by a *copy*; each rank runs ``moe_sorted``'s
    dispatch on its experts ``[r E/tp, (r+1) E/tp)`` under the capacity of
    the whole data shard (``default_capacity(T, ...)``), and ``y`` is
    *reduce*d over the axis.  ``aux`` is the global mean over the tp and
    dp axes (the reference's ``psum / (n_tp n_dp)``).  With
    ``pctx.fsdp_experts`` expert weights that arrive split over the dp axes
    too (ZeRO-3) are all-gathered here, their gradients reduce-scattered
    back."""
    from repro_torch.core import hierarchy
    m = cfg.moe
    tp = pctx.tp
    if m.n_experts % tp:
        raise ValueError(f"{m.n_experts} experts over {tp} ranks")
    e_local = m.n_experts // tp
    full = {"wi": (m.n_experts, cfg.d_model, m.d_ff_expert),
            "wg": (m.n_experts, cfg.d_model, m.d_ff_expert),
            "wo": (m.n_experts, m.d_ff_expert, cfg.d_model)}
    ws = {}
    for name, shape in full.items():
        w = pctx.cut(getattr(params, name), 0, shape[0])
        for dim in (1, 2):
            if w.shape[dim] != shape[dim]:
                if not pctx.fsdp_experts:
                    raise ValueError(f"moe.{name} {tuple(w.shape)} is split "
                                     f"over the dp axes without "
                                     f"fsdp_experts")
                w = hierarchy.gather_param(w, pctx.group(pctx.dp_names),
                                           dim)
        ws[name] = w
    T = x2d.shape[0]
    gates, idx, aux = route(x2d, params.router, m.top_k)
    cap = capacity if capacity is not None else default_capacity(
        T, m.n_experts, m.top_k, m.capacity_factor)
    y = _dispatch(ws["wi"], ws["wg"], ws["wo"], pctx.copy(x2d),
                  pctx.copy(gates), idx, cfg, compute_dtype, cap,
                  (pctx.tp_rank * e_local, e_local))
    y = pctx.reduce(y)
    everyone = pctx.group((pctx.tp_axis,) + pctx.dp_names)
    aux = hierarchy.tp_psum(aux, everyone) / everyone.size
    return y, aux


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
              capacity: Optional[int] = None, pctx=None, dp_group=None):
    """x (B, S, d) -> (y (B, S, d), aux), the shared experts added.
    ``impl="ep"`` takes ``pctx`` (a ``ParallelCtx`` whose mesh has the tp
    axis); there the shared experts are a tensor-parallel MLP.
    ``dp_group``: the sorted path over this rank's rows of a global batch
    split over the group's ranks (module docstring)."""
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    if impl == "dense":
        y2d, aux = moe_dense(params, x2d, cfg, compute_dtype)
    elif impl == "sorted":
        y2d, aux = moe_sorted(params, x2d, cfg, compute_dtype=compute_dtype,
                              capacity=capacity, dp_group=dp_group)
    elif impl == "ep":
        if pctx is None or not pctx.tp_on:
            raise ValueError("impl='ep' needs a ParallelCtx whose mesh has "
                             "the tp axis")
        y2d, aux = _moe_ep(params, x2d, cfg, compute_dtype, pctx, capacity)
    else:
        raise ValueError(f"MoE impl {impl!r} not in ('sorted', 'dense', "
                         f"'ep')")
    y = y2d.reshape(B, S, d)
    if cfg.moe.n_shared_experts:
        y = y + layers.apply_mlp(params.shared, x, cfg.act, compute_dtype,
                                 pctx=pctx)
    return y, aux
