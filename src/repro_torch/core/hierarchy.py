"""Gradient exchange across the composed fabric, held against
``repro/core/hierarchy.py``: the flat all-reduce, the int8 error-feedback
all-reduce over the slow (pod) axis, and their analytic prices.

The paper's fixed 8-GPU topology only allows a flat NCCL all-reduce.  At
production scale the composed fabric is *hierarchical* -- fast links inside
a pod ("local"), slow links between pods ("switch" / network) -- and the
slow hop can ride int8 error-feedback compression (``optim/compress.py``),
cutting its wire bytes ~4x.

Where the reference writes ``psum`` / ``pmax`` / ``all_gather`` over a named
axis inside a ``shard_map``, the port calls ``torch.distributed`` on the
process group of one or more ``DeviceMesh`` axes (a ``Group``).  Every
collective here adds its calls and bytes to the group's ``Traffic``, so a
step can report what it moved on each axis.  The tensor-parallel paths
enter and leave their regions through autograd functions of these
collectives: ``tp_copy`` / ``tp_reduce`` (Megatron-LM's f and g), and
``tp_psum``, ``tp_gather``, ``tp_split``, ``gather_param``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.compress import int8_decode, int8_encode

# the single-tensor collectives under their current names (older releases
# have only the ``*_into_tensor`` / ``*_tensor`` ones, with the same
# signatures)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

# ring wire bytes per rank as a share of the payload, on n ranks
_WIRE = {"all_reduce": lambda n: 2.0 * (n - 1) / n,
         "all_gather": lambda n: (n - 1) / n,
         "reduce_scatter": lambda n: (n - 1) / n}


class Traffic:
    """Calls and payload bytes of each collective kind on each group.  The
    payload is the whole tensor an all-reduce reduces, an all-gather
    produces or a reduce-scatter consumes; ``report`` adds the ring's wire
    bytes per rank (``2 (n-1)/n`` of the payload for an all-reduce,
    ``(n-1)/n`` for the others)."""

    def __init__(self):
        self.rows: Dict[Tuple[str, str], list] = {}

    def add(self, group: "Group", kind: str, nbytes: int) -> None:
        row = self.rows.setdefault((group.name, kind), [0, 0, group.size])
        row[0] += 1
        row[1] += int(nbytes)

    def reset(self) -> None:
        self.rows.clear()

    def report(self) -> Dict[str, Dict[str, Any]]:
        return {f"{axes}/{kind}": {
            "calls": calls, "payload_bytes": nbytes, "ranks": n,
            "wire_bytes_per_rank": _WIRE[kind](n) * nbytes}
            for (axes, kind), (calls, nbytes, n) in sorted(self.rows.items())}


@dataclasses.dataclass(frozen=True)
class Group:
    """The process group of one or more mesh axes (``name``: the axes
    joined by ``+``, outermost first), and the ``Traffic`` it counts into."""
    pg: Any
    name: str
    size: int
    traffic: Traffic


def axis_group(mesh, axes: Sequence[str], traffic: Traffic) -> Group:
    """The group of ``mesh``'s ``axes``.  One axis is its ``DeviceMesh``
    group; several are the world's group where they span the world, else
    one ``new_group`` per coset of the other axes (every rank joins every
    ``new_group`` call, in the same order, and keeps its own coset's)."""
    axes = tuple(a for a in mesh.mesh_dim_names if a in axes)
    if not axes:
        raise ValueError("a group needs at least one mesh axis")
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    size = 1
    for a in axes:
        size *= int(sizes[a])
    if len(axes) == 1:
        pg = mesh.get_group(axes[0])
    elif size == dist.get_world_size() == mesh.mesh.numel():
        pg = dist.group.WORLD
    else:
        pg = _coset_group(mesh, axes)
    return Group(pg, "+".join(axes), size, traffic)


def _coset_group(mesh, axes: Tuple[str, ...]):
    """The process group of this rank's coset of ``axes``: the ranks that
    differ from it only along ``axes``.  Every rank of the world calls
    ``new_group`` for every coset, in the mesh's order (a rank past the
    mesh, too), as ``torch.distributed`` asks."""
    names = list(mesh.mesh_dim_names)
    keep = [names.index(a) for a in axes]
    other = [i for i in range(len(names)) if i not in keep]
    ranks = mesh.mesh.permute(other + keep).reshape(
        -1, int(torch.tensor([mesh.mesh.shape[i] for i in keep]).prod()))
    me, mine = dist.get_rank(), None
    for row in ranks.tolist():
        pg = dist.new_group(row)
        if me in row:
            mine = pg
    return mine


def _count(group: Group, kind: str, t: torch.Tensor) -> None:
    group.traffic.add(group, kind, t.numel() * t.element_size())


def all_reduce(x: torch.Tensor, group: Group, op: str = "sum"
               ) -> torch.Tensor:
    """``x`` reduced (``"sum"`` or ``"max"``) over the group, in place."""
    _count(group, "all_reduce", x)
    dist.all_reduce(x, op=_OPS[op], group=group.pg)
    return x


def all_gather(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """The group's pieces of ``x`` joined along ``dim`` in rank order."""
    n = group.size
    x = x.contiguous()
    # the ranks' pieces stacked along a flat first dimension
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _count(group, "all_gather", out)
    _ALL_GATHER(out, x, group=group.pg)
    return out.unflatten(0, (n, x.shape[0])).movedim(0, dim).flatten(
        dim, dim + 1)


def reduce_scatter(x: torch.Tensor, group: Group, dim: int = 0
                   ) -> torch.Tensor:
    """This rank's piece (along ``dim``) of the group's sum of ``x``."""
    n = group.size
    parts = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)
    out = torch.empty(parts.shape[1:], dtype=x.dtype, device=x.device)
    _count(group, "reduce_scatter", x)
    _REDUCE_SCATTER(out, parts.contiguous().flatten(0, 1), group=group.pg)
    return out


# ---------------------------------------------------------------------------
# the entry and exit of a tensor-parallel region (Megatron-LM's f and g,
# Shoeybi et al., arXiv:1909.08053 section 3), and the reference's psum and
# ZeRO-style gather inside a manual region, as autograd functions
# ---------------------------------------------------------------------------
class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _GatherAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group.pg)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim] // group.size
        r = dist.get_rank(group.pg)
        return x.narrow(dim, r * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.group, ctx.dim), None, None


def _recorded(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def tp_copy(x: torch.Tensor, group: Group) -> torch.Tensor:
    """*f*, the entry of a tensor-parallel region: ``x`` (the same on every
    rank of ``group``) forward; the ranks' partial gradients summed
    backward."""
    return _Copy.apply(x, group) if _recorded(x) else x


def tp_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    """*g*, the exit: the ranks' partial results summed forward; the
    gradient (the same on every rank) passed through backward.  Where no
    gradient is recorded the sum is taken in place: pass a tensor nothing
    else reads."""
    return _Reduce.apply(x, group) if _recorded(x) else all_reduce(x, group)


def tp_psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The reference's ``psum`` where every rank goes on with its own use
    of the sum: summed forward, and the ranks' gradients summed backward
    (in place where no gradient is recorded, as ``tp_reduce``)."""
    return _Psum.apply(x, group) if _recorded(x) else all_reduce(x, group)


def tp_gather(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """The ranks' pieces joined along ``dim`` forward, for a use that every
    rank repeats; backward, this rank's piece of the (same) gradient."""
    return _GatherAct.apply(x, group, dim) if _recorded(x) else \
        all_gather(x, group, dim)


def tp_split(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """This rank's piece along ``dim`` of ``x`` (the same on every rank)
    forward; the pieces' gradients joined backward."""
    return _Split.apply(x, group, dim)


def gather_param(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """A parameter's pieces joined along ``dim`` (ZeRO-3's all-gather, the
    reference's ``all_gather(..., tiled=True)`` inside ``_moe_ep``); the
    ranks' gradients of the whole reduce-scattered back to the piece."""
    return _GatherSum.apply(x, group, dim)


def allreduce_flat(tree: Mapping[str, torch.Tensor], group: Group
                   ) -> Mapping[str, torch.Tensor]:
    """Plain sum over the group (the paper's NCCL all-reduce; ``psum`` in
    the reference), leaf by leaf and in place."""
    for g in tree.values():
        all_reduce(g, group)
    return tree


def allreduce_int8_ef(tree: Mapping[str, torch.Tensor],
                      residual: Mapping[str, torch.Tensor], group: Group,
                      *, scale_group: Optional[Group] = None,
                      scale_keys: Optional[Mapping[str, Any]] = None
                      ) -> Tuple[Dict[str, torch.Tensor],
                                 Dict[str, torch.Tensor]]:
    """Int8 error-feedback all-reduce over ``group``.

    For each leaf: add the carried residual, quantize to int8 against a
    globally-agreed scale (one scalar MAX all-reduce, over ``scale_group``
    where the leaf is a piece of a tensor sharded over more axes than
    ``group``), exchange int8 (an all-gather: 1 byte an element on the
    wire, never an int8 all-reduce, whose sums would overflow), sum in
    int32, divide by the group's size, and carry the local quantization
    error into the next step.  Returns (mean-reduced tree, new residuals).

    ``scale_keys`` (leaf name -> key): the leaves of one key share one
    scale, the largest over all of them (the layers of a segment that the
    reference scans are one leaf there, with one scale); by default each
    leaf is its own key.
    """
    n = group.size
    outs, news = {}, {}
    peaks: Dict[Any, torch.Tensor] = {}
    for name, g in tree.items():
        key = scale_keys[name] if scale_keys is not None else name
        m = (g.to(torch.float32) + residual[name]).abs().max()
        peaks[key] = m if key not in peaks else torch.maximum(peaks[key], m)
    for m in peaks.values():
        all_reduce(m, scale_group or group, op="max")
    for name, g in tree.items():
        key = scale_keys[name] if scale_keys is not None else name
        y = g.to(torch.float32) + residual[name]
        q, scale = int8_encode(y, lambda _: peaks[key])
        gathered = all_gather(q.unsqueeze(0), group)       # (n, ...) int8
        total = gathered.to(torch.int32).sum(0)
        out = int8_decode(total, scale) / n
        news[name] = y - int8_decode(q.to(torch.int32), scale)
        outs[name] = out.to(g.dtype)
    return outs, news


def init_residual(tree: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Zero error-feedback residuals matching the (sharded) grad tree."""
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in tree.items()}


def hierarchical_time(nbytes: float, fast_n: int, slow_n: int,
                      fast_bw: float, slow_bw: float,
                      compress: float = 1.0) -> float:
    """Analytic cost of the hierarchical exchange for ``nbytes`` of grads.

    reduce-scatter(fast) + all-gather(fast) + all-reduce(slow on 1/F payload
    x compress).  The cost of encoding and decoding is not in it."""
    t_fast = 2.0 * (fast_n - 1) / fast_n * nbytes / fast_bw
    shard = nbytes / max(fast_n, 1) * compress
    t_slow = 2.0 * (slow_n - 1) / slow_n * shard / slow_bw
    return t_fast + t_slow


def flat_time(nbytes: float, total_n: int, slow_bw: float) -> float:
    """Flat ring allreduce over the slowest link (the paper's baseline)."""
    return 2.0 * (total_n - 1) / total_n * nbytes / slow_bw
