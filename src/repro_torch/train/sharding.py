"""A training state laid out on a data-parallel ``DeviceMesh``: what the
reference's ``jit`` does with ``state_specs`` and ``batch_specs``
(``repro/train/trainer.py:114-137, 272-280``) and what ``device_put``
under a ``NamedSharding`` does in its checkpoint restore.  No module of
the reference has this one's job; ``train/trainer.py`` (the mesh step) and
``train/checkpoint.py`` are its callers.

Each rank holds, for every leaf, its piece under the leaf's spec
(``core/policy``): the rank's block of each sharded dimension, the whole
tensor where the spec replicates.  ZeRO-3 parameters are the model's own
``nn.Parameter`` objects holding their pieces; ``unsharded`` gathers them
per block for the forward (``Block`` forward hooks) and again for the remat
recompute, and reduce-scatters their gradients in the backward.

With a tp axis (``model``) in the mesh, a leaf whose spec splits it over
that axis along the dim its block's tensor-parallel computation splits its
work along (heads of ``wq`` / ``wk`` / ``wv`` / ``wo``, the FFN width, the
vocabulary, the SSM's inner channels, the experts) is used as that piece;
a leaf that the rule split along another dim (``_pick_tp_dim``'s generic
fallback: qwen2-0.5b's ``wq`` over ``d`` at ``model`` = 4) is all-gathered
over the axis before use, with ZeRO-3's gathers, and its gradient
reduce-scattered back.  A replicated leaf that a rank uses only a slice of
(the SSM's ``D``, ``dt_bias``, ``A_log``, conv weights and norm scale; a
small ``wq``; the RG-LRU's conv, ``wa`` / ``wx`` by gate block and ``ba`` /
``bx`` / ``lam`` by channel) gets a partial gradient, summed over the
axis; leaves used whole (block norms, the router, the RG-LRU's gate leaves
where a rank's channels cover part of a gate block and the gates are
computed whole) are not summed.

Two departures from the reference's specs, one rule: where every fsdp axis
of the mesh has size 1 (a one-rank mesh), the reference's rule replicates
every leaf, and ZeRO would be DP's program.  ``specs`` then takes the rule
with ``fsdp_min=1`` (``core/policy.param_spec``), which shards over those
size-1 axes, so that one rank runs the program a wider mesh runs (the
gathers per block, the reduce-scatters); every piece is still the whole
tensor.  A tp axis of size 1 is taken the same way (``tp_min=1``), so a
one-rank mesh runs the tensor- and expert-parallel program.  It costs that
rank the collectives (copies on one rank), which is what the one-card
ladder and ``tp`` lines measure.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import re
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, PolicyConfig
from repro_torch.core import hierarchy, policy as pol
from repro_torch.core.policy import Spec, entry_axes


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names,
                    (int(s) for s in mesh.mesh.shape)))


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    return tuple(a for e in spec for a in entry_axes(e))


def _index(entry, mesh) -> int:
    """This rank's position along ``entry``'s axes, the first outermost."""
    idx = 0
    sizes = mesh_axes(mesh)
    for a in entry_axes(entry):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def piece(t, spec: Spec, mesh):
    """This rank's piece of ``t`` (a tensor or numpy array) under ``spec``:
    a view (a slice of an array)."""
    sizes = mesh_axes(mesh)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n = pol.axis_entry_size(entry, sizes)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide "
                             f"over {entry!r} ({n})")
        s = t.shape[d] // n
        i = _index(entry, mesh)
        t = t.narrow(d, i * s, s) if torch.is_tensor(t) else \
            t[(slice(None),) * d + (slice(i * s, (i + 1) * s),)]
    return t


def full_tensor(local: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor whose piece under ``spec`` this rank holds (every
    rank of the mesh calls it): a ``DTensor`` of the spec's placements,
    gathered."""
    from torch.distributed.tensor import DTensor
    if not spec_axes(spec):
        return local
    return DTensor.from_local(local, mesh, pol.placements(spec, mesh),
                              run_check=False).full_tensor()


def fsdp_min(policy: PolicyConfig, axes: Mapping[str, int]) -> int:
    """``param_spec``'s ``fsdp_min`` on a mesh of ``axes``: 1 where the mesh
    has fsdp axes and each has size 1 (module docstring), else 2, the
    reference's rule."""
    sizes = [axes[a] for a in policy.fsdp_axes if a in axes]
    return 1 if sizes and max(sizes) == 1 else 2


def tp_min(policy: PolicyConfig, axes: Mapping[str, int]) -> int:
    """``param_spec``'s ``tp_min``: 1 where the mesh's tp axis has size 1
    (module docstring), else 2, the reference's rule."""
    return 1 if axes.get(policy.tp_axis or "", 0) == 1 else 2


def specs(model, cfg: ModelConfig, policy: PolicyConfig,
          axes: Mapping[str, int]) -> Tuple[Dict[str, Spec],
                                            Dict[str, Spec]]:
    """(parameter specs, optimizer-state specs) of ``model`` (any device,
    ``meta`` too) as the port lays them out on a mesh of ``axes``."""
    m, t = fsdp_min(policy, axes), tp_min(policy, axes)
    return (pol.param_specs(model, cfg, policy, axes, fsdp_min=m, tp_min=t),
            pol.opt_state_specs(model, cfg, policy, axes, fsdp_min=m,
                                tp_min=t))


# the dim (of the port's unstacked leaf) along which a block's
# tensor-parallel computation splits its work, by leaf name
_WORK_DIMS = (
    (r"attn\.w[qkv]$", 1), (r"attn\.wo$", 0), (r"attn\.b[qkv]$", 0),
    (r"(mlp|shared)\.w[ig]$", 1), (r"(mlp|shared)\.wo$", 0),
    (r"^(embed|head)$", 0),
    (r"ssm\.in_[zx]$", 1), (r"ssm\.out_proj$", 0),
    (r"ssm\.conv_x_w$", 1), (r"ssm\.conv_x_b$", 0),
    (r"ssm\.norm\.scale$", 0),
    (r"moe\.w[igo]$", 0),
    (r"rglru\.in_(gate|rec)$", 1), (r"rglru\.out_proj$", 0),
    (r"rglru\.conv_w$", 1), (r"rglru\.conv_b$", 0),
)
# leaves used whole where the heads do not divide (the SSM's replicated
# region) and cut by heads where they do
_SSM_HEAD_LEAVES = (r"ssm\.(in_dt|dt_bias|A_log|D)$",
                    r"ssm\.(in_b|in_c|conv_[bc]_[wb])$")


def work_dim(name: str, cfg: ModelConfig, tp: int) -> Optional[int]:
    """The dim a rank takes its block of for its tensor-parallel work (the
    heads, the width, ...; ``_WORK_DIMS``), or None for a leaf used whole
    on every rank (norms, the router, the SSM's B / C / dt path where its
    heads do not divide the axis)."""
    for pat, d in _WORK_DIMS:
        if re.search(pat, name):
            return d
    if re.search(r"attn\.(q|k)_norm\.", name):
        return -1                     # applied to this rank's heads only
    if re.search(r"rglru\.(wa|wx|ba|bx|lam)$", name):
        # the gates' leaves: cut to a rank's channels where they cover
        # whole gate blocks, else used whole on the gathered conv output
        from repro_torch.models.rglru import gate_blocks_split
        return 0 if gate_blocks_split(tp) else None
    if cfg.ssm is not None and any(re.search(p, name)
                                   for p in _SSM_HEAD_LEAVES):
        H = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
        if H % tp == 0:
            return 1 if re.search(r"in_dt$", name) else (
                0 if re.search(r"(dt_bias|A_log|D)$", name) else -1)
    return None


def leaf_specs(pspecs: Mapping[str, Spec], mspecs: Mapping[str, Spec],
               state) -> Dict[str, Spec]:
    """Checkpoint key -> the spec of the piece each rank holds
    (``train/checkpoint``'s keys: ``params/<name>``,
    ``opt/{m,v,master}/<name>``, ``opt/step``; ``ef/<name>``: the pod axis
    first) for a ``TrainState`` with these specs."""
    out = {"opt/step": ()}
    for n in pspecs:
        out[f"params/{n}"] = pspecs[n]
        for part in ("m", "v") + (("master",) if state.opt.master
                                  is not None else ()):
            out[f"opt/{part}/{n}"] = mspecs[n]
        if state.ef_residual is not None:
            out[f"ef/{n}"] = ("pod",) + mspecs[n]
    return out


class _Gather(torch.autograd.Function):
    """A ZeRO-3 piece -> the whole parameter (all-gather); its backward
    reduce-scatters the whole gradient back to the piece."""

    @staticmethod
    def forward(ctx, local, layout, spec):
        ctx.layout, ctx.spec = layout, spec
        return layout.gather(local, spec)

    @staticmethod
    def backward(ctx, grad):
        return ctx.layout.scatter(grad, ctx.spec), None, None


class Layout:
    """The specs of a model's parameters and optimizer state on ``mesh``
    under ``policy``, the mesh's groups (those of ``pctx``, the
    ``ParallelCtx`` the model runs under), and the ``hierarchy.Traffic``
    their collectives count into.

    Per leaf: ``pspecs`` / ``mspecs`` the pieces a rank holds of it and of
    its optimizer state; ``use_specs`` the piece its block computes with
    (the tp entry where it is a work split, module docstring); ``zero3``
    the leaves gathered before use (ZeRO-3's over the fsdp axes, the tp
    fallback's over the tp axis) by ``unsharded``; ``partial`` the
    replicated leaves whose gradient is summed over the tp axis."""

    def __init__(self, cfg: ModelConfig, policy: PolicyConfig, mesh):
        from repro_torch.models.lm import LM
        from repro_torch.models.transformer import ParallelCtx
        axes = mesh_axes(mesh)
        tp = policy.tp_axis if policy.tp_axis in axes else None
        self.tp = tp
        self.cfg, self.policy, self.mesh, self.axes = cfg, policy, mesh, axes
        from repro_torch.convert import reference_paths
        meta = LM(cfg, device="meta")
        self.shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
        self.pspecs, self.mspecs = specs(meta, cfg, policy, axes)
        # each parameter's leaf in the reference's pytree: the layers of a
        # scanned segment share one, and with it one int8 scale
        self.ref_paths = {n: path for n, (path, _) in
                          reference_paths(meta).items()}
        self.traffic = hierarchy.Traffic()
        self.pctx = ParallelCtx(mesh=mesh, dp_axes=tuple(policy.dp_axes),
                                tp_axis=policy.tp_axis,
                                fsdp_experts=policy.zero_stage >= 3,
                                traffic=self.traffic)
        n_tp = axes.get(tp, 1) if tp else 1
        ep = cfg.moe is not None and tp is not None
        self.use_specs: Dict[str, Spec] = {}
        self.gather_specs: Dict[str, Spec] = {}
        self.partial = set()
        for n, spec in self.pspecs.items():
            wd = work_dim(n, cfg, n_tp) if tp else None
            use = [None] * len(spec)
            gath = list(spec)
            for d, e in enumerate(spec):
                if tp in entry_axes(e):
                    if d == wd:
                        use[d], gath[d] = e, None
                    elif wd is None:
                        raise NotImplementedError(
                            f"{n}: split over {tp!r} along dim {d}, but "
                            f"every rank uses it whole")
            if ep and n.endswith(("moe.wi", "moe.wg", "moe.wo")):
                # gathered over the dp axes inside ``_moe_ep``
                gath = [None] * len(spec)
            self.use_specs[n] = tuple(use)
            self.gather_specs[n] = tuple(gath)
            if wd is not None and tp not in spec_axes(spec):
                self.partial.add(n)
        self.zero3 = {n for n, s in self.gather_specs.items()
                      if spec_axes(s)}
        # the gradient exchange: over the dp axes of the mesh (size 1
        # included: one rank runs the same collectives), the pod axis by
        # int8 error feedback where the policy asks for it (the reference's
        # manual-pod exchange, ``trainer.py:199-266``)
        self.exchange = ("pod" if policy.grad_compression == "int8_ef"
                         and axes.get("pod", 1) > 1 else None)
        self.dp = tuple(a for a in mesh.mesh_dim_names
                        if a in policy.dp_axes and a != self.exchange)
        if self.exchange and "pod" in spec_axes(
                tuple(e for s in self.mspecs.values() for e in s)):
            raise NotImplementedError("the int8 pod exchange with state "
                                      "sharded over the pod axis")

    # --------------------------------------------------------- groups --
    def group(self, axes: Iterable[str]) -> hierarchy.Group:
        return self.pctx.group(axes)

    def same(self, other: Optional["Layout"]) -> bool:
        return other is not None and (
            other.axes == self.axes and other.pspecs == self.pspecs
            and other.mspecs == self.mspecs
            and other.exchange == self.exchange)

    # --------------------------------------------------------- pieces --
    def gather(self, local: torch.Tensor, spec: Spec) -> torch.Tensor:
        for d, entry in enumerate(spec):
            if entry is not None:
                local = hierarchy.all_gather(local, self.group(
                    entry_axes(entry)), dim=d)
        return local

    def scatter(self, full: torch.Tensor, spec: Spec) -> torch.Tensor:
        for d, entry in enumerate(spec):
            if entry is not None:
                full = hierarchy.reduce_scatter(full, self.group(
                    entry_axes(entry)), dim=d)
        return full

    def _extra(self, n: str) -> Spec:
        """The entries of ``n``'s optimizer spec that its parameter spec
        lacks (ZeRO-1's fsdp entries)."""
        ps, ms = self.pspecs[n], self.mspecs[n]
        return tuple(m if (not ps or ps[d] != m) else None
                     for d, m in enumerate(ms))

    def opt_params(self, model) -> Dict[str, torch.Tensor]:
        """Each parameter's piece under its optimizer spec: the parameter
        itself (its piece already), else a view of it (ZeRO-1) that an
        in-place update writes through."""
        return {n: piece(p.data, self._extra(n), self.mesh)
                if spec_axes(self._extra(n)) else p
                for n, p in model.named_parameters()}

    def lay_out(self, model) -> None:
        """Cut every parameter of a whole ``model`` to its piece."""
        for n, p in model.named_parameters():
            if spec_axes(self.pspecs[n]):
                p.data = piece(p.data, self.pspecs[n], self.mesh).clone()

    def rows_axes(self, n_rows: int) -> Tuple[str, ...]:
        """The dp axes (of size above 1) that split a batch of ``n_rows``
        rows (``batch_piece``'s rule, the pod exchange's axis aside)."""
        if self.exchange:
            n_rows //= self.axes["pod"]
        dp_pol = dataclasses.replace(self.policy, dp_axes=self.dp)
        return entry_axes(pol.dp_spec_for_batch(n_rows, dp_pol, self.axes))

    def batch_piece(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a global batch: split over the pod axis
        first under the pod exchange (the reference's ``P("pod")`` batch
        spec there), then over the dp axes that divide (the ranks of the tp
        axis take the same rows)."""
        axes = dict(self.axes)
        if self.exchange:
            batch = {k: piece(v, ("pod",), self.mesh)
                     for k, v in batch.items()}
        dp_pol = dataclasses.replace(self.policy, dp_axes=self.dp)
        bspecs = pol.batch_specs(batch, dp_pol, axes)
        return {k: piece(v, bspecs[k][:1], self.mesh)
                for k, v in batch.items()}

    # ------------------------------------------------- ZeRO-3 gathers --
    @contextlib.contextmanager
    def unsharded(self, model):
        """Within: every gathered parameter (``zero3``) reads as the piece
        its block uses -- a block's when the block runs (again in its remat
        recompute), the others' (tables, final norm) throughout -- and its
        gradient is reduce-scattered to its piece in the backward.  Run
        the forward and the backward inside."""
        if not self.zero3:
            yield
            return
        blocks: Dict[int, list] = {}
        top: list = []
        for n, p in model.named_parameters():
            if n not in self.zero3:
                continue
            owner, _, leaf = n.rpartition(".")
            entry = (model.get_submodule(owner) if owner else model, leaf, p,
                     self.gather_specs[n])
            parts = n.split(".")
            if parts[:2] == ["stack", "blocks"]:
                blocks.setdefault(int(parts[2]), []).append(entry)
            else:
                top.append(entry)
        handles = []
        for i, entries in blocks.items():
            blk = model.stack.blocks[i]
            handles.append(blk.register_forward_pre_hook(
                functools.partial(_swap_in, self, entries)))
            handles.append(blk.register_forward_hook(
                functools.partial(_swap_out, entries)))
        everything = top + [e for es in blocks.values() for e in es]
        from torch.utils.checkpoint import set_checkpoint_early_stop
        try:
            _swap_in(self, top)
            # the recompute runs each block to its end, forward hook too
            with set_checkpoint_early_stop(False):
                yield
        finally:
            for h in handles:
                h.remove()
            _swap_out(everything)

    # ------------------------------------------------------- reductions --
    def reduce_grads(self, grads: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """Each gradient summed over the dp axes (the exchange axis
        excepted), as the piece of its optimizer spec: a gathered leaf's
        arrives reduce-scattered over its gathered entries already (the tp
        fallback's over the tp axis too); a ZeRO-1 gradient is
        reduce-scattered here; the rest is all-reduced.  A ``partial``
        leaf's is first summed over the tp axis."""
        out, flat = {}, {}
        partial = {n: grads[n] for n in grads if n in self.partial}
        if partial:
            hierarchy.allreduce_flat(partial, self.group((self.tp,)))
        for n, g in grads.items():
            spec = self.mspecs[n]
            extra = self._extra(n)
            if spec_axes(extra):
                g = self.scatter(g, extra)
            rest = tuple(a for a in self.dp if a not in spec_axes(spec))
            out[n] = g
            if rest:
                flat.setdefault(rest, {})[n] = g
        for rest, tree in flat.items():
            hierarchy.allreduce_flat(tree, self.group(rest))
        return out

    def global_norm(self, grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The norm of the whole gradient from the pieces: each leaf's
        squares summed over the ranks that hold its pieces (one all-reduce
        of a vector a group), a replicated leaf counted once, then the
        leaves summed in order as ``adamw.global_norm`` sums them, so that
        one rank gets that function's value bit for bit."""
        sqs = [g.float().square().sum() for g in grads.values()]
        by_axes: Dict[Tuple[str, ...], List[int]] = {}
        for i, n in enumerate(grads):
            axes = spec_axes(self.mspecs[n])
            if axes:
                by_axes.setdefault(axes, []).append(i)
        for axes, idx in by_axes.items():
            summed = hierarchy.all_reduce(torch.stack([sqs[i] for i in idx]),
                                          self.group(axes))
            for i, sq in zip(idx, summed.unbind(0)):
                sqs[i] = sq
        return torch.sqrt(sum(sqs))

    def gather_params(self, model) -> None:
        """ZeRO-1: each rank updated its piece of a parameter; join the
        pieces."""
        for n, p in model.named_parameters():
            extra = self._extra(n)
            if spec_axes(extra):
                p.data.copy_(self.gather(piece(p.data, extra, self.mesh),
                                         extra))

    # ------------------------------------------------------ the state --
    def leaf_specs(self, state) -> Dict[str, Spec]:
        """``leaf_specs`` of ``state`` under this layout."""
        return leaf_specs(self.pspecs, self.mspecs, state)


def _swap_in(layout: Layout, entries: List, *_):
    for mod, leaf, p, spec in entries:
        mod._parameters[leaf] = _Gather.apply(p, layout, spec)


def _swap_out(entries: List, *_):
    for mod, leaf, p, _spec in entries:
        mod._parameters[leaf] = p
