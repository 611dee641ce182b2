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

One departure from the reference's specs: where every fsdp axis of the
mesh has size 1 (a one-rank mesh), the reference's rule replicates every
leaf, and ZeRO would be DP's program.  ``specs`` then takes the rule with
``fsdp_min=1`` (``core/policy.param_spec``), which shards over those
size-1 axes, so that one rank runs the program a wider mesh runs (the
gathers per block, the reduce-scatters); every piece is still the whole
tensor.  It costs that rank the collectives (copies on one rank), which
is what the one-card ladder measures.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
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


def specs(model, cfg: ModelConfig, policy: PolicyConfig,
          axes: Mapping[str, int]) -> Tuple[Dict[str, Spec],
                                            Dict[str, Spec]]:
    """(parameter specs, optimizer-state specs) of ``model`` (any device,
    ``meta`` too) as the port lays them out on a mesh of ``axes``."""
    m = fsdp_min(policy, axes)
    return (pol.param_specs(model, cfg, policy, axes, fsdp_min=m),
            pol.opt_state_specs(model, cfg, policy, axes, fsdp_min=m))


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
    under ``policy``, the mesh's groups, and the ``hierarchy.Traffic`` its
    collectives count into."""

    def __init__(self, cfg: ModelConfig, policy: PolicyConfig, mesh):
        from repro_torch.models.lm import LM
        axes = mesh_axes(mesh)
        tp = policy.tp_axis
        if tp and axes.get(tp, 1) > 1:
            raise NotImplementedError(
                f"a {tp!r} axis of {axes[tp]}: tensor and expert "
                f"parallelism are not ported yet (ROADMAP queue A item 7); "
                f"this layer is data-parallel")
        self.cfg, self.policy, self.mesh, self.axes = cfg, policy, mesh, axes
        from repro_torch.convert import reference_paths
        meta = LM(cfg, device="meta")
        self.shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
        self.pspecs, self.mspecs = specs(meta, cfg, policy, axes)
        # each parameter's leaf in the reference's pytree: the layers of a
        # scanned segment share one, and with it one int8 scale
        self.ref_paths = {n: path for n, (path, _) in
                          reference_paths(meta).items()}
        if policy.zero_stage >= 3 and self.pspecs != self.mspecs:
            raise NotImplementedError("ZeRO-3 with parameter and optimizer "
                                      "specs that differ")
        self.zero3 = {n for n, s in self.pspecs.items() if spec_axes(s)}
        self.traffic = hierarchy.Traffic()
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
        self._groups: Dict[Tuple[str, ...], hierarchy.Group] = {}

    # --------------------------------------------------------- groups --
    def group(self, axes: Iterable[str]) -> hierarchy.Group:
        key = tuple(a for a in self.mesh.mesh_dim_names if a in set(axes))
        if key not in self._groups:
            self._groups[key] = hierarchy.axis_group(self.mesh, key,
                                                     self.traffic)
        return self._groups[key]

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

    def opt_params(self, model) -> Dict[str, torch.Tensor]:
        """Each parameter's piece under its optimizer spec: the parameter
        itself (replicated, or a ZeRO-3 piece already), else a view of it
        (ZeRO-1) that an in-place update writes through."""
        return {n: p if n in self.zero3 else piece(p.data, self.mspecs[n],
                                                   self.mesh)
                for n, p in model.named_parameters()}

    def lay_out(self, model) -> None:
        """Cut the ZeRO-3 parameters of a whole ``model`` to their pieces."""
        for n, p in model.named_parameters():
            if n in self.zero3:
                p.data = piece(p.data, self.pspecs[n], self.mesh).clone()

    def batch_piece(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a global batch: split over the pod axis
        first under the pod exchange (the reference's ``P("pod")`` batch
        spec there), then over the dp axes that divide."""
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
        """Within: every ZeRO-3 parameter reads as the whole tensor -- a
        block's when the block runs (again in its remat recompute), the
        others' (tables, final norm) throughout -- and its gradient is
        reduce-scattered to its piece in the backward.  Run the forward
        and the backward inside."""
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
                     self.pspecs[n])
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
        excepted), as the piece of its optimizer spec: a ZeRO-3 gradient
        arrives reduce-scattered over its spec's axes already; a ZeRO-1
        gradient is reduce-scattered here; the rest is all-reduced."""
        out, flat = {}, {}
        for n, g in grads.items():
            spec = self.mspecs[n]
            axes = spec_axes(spec)
            if axes and n not in self.zero3:
                g = self.scatter(g, spec)
            rest = tuple(a for a in self.dp if a not in axes)
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
        """ZeRO-1: each rank updated its piece of a replicated parameter;
        join the pieces."""
        for n, p in model.named_parameters():
            spec = self.mspecs[n]
            if n not in self.zero3 and spec_axes(spec):
                p.data.copy_(self.gather(piece(p.data, spec, self.mesh),
                                         spec))

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
