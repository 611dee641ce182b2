"""Sharding-policy engine: PolicyConfig -> a spec for every tensor, held
against ``repro/core/policy.py``.

This is the software ladder the paper measures in §V-4, rendered as specs:

  * DP   (paper "Data Parallel")            -- ``zero_stage=0``: params and
    optimizer state replicated; batch over the dp axes; gradients
    all-reduced.
  * DDP  (paper "Distributed Data Parallel") -- the same placement; only
    ``ladder()`` tells the two apart (``hierarchical_allreduce``), and the
    step is the same program (``train/trainer.py``).
  * mixed precision                          -- ``compute_dtype=bf16``.
  * sharded (paper "sharded training", ZeRO) -- ``zero_stage=1``: optimizer
    state sharded over the fsdp axes; ``zero_stage=3``: parameters too.

A spec is a plain tuple with one entry a dimension: ``None``, a mesh axis
name, or a tuple of names (the dimension split over those axes, the first
the outermost).  It is the reference's ``PartitionSpec`` without JAX, entry
for entry; ``()`` is replicated.  ``placements`` turns one into the
``Shard`` / ``Replicate`` placements of a ``torch`` ``DeviceMesh``.

The rules are those of the reference, over the reference's leaf paths
(``stack/seg0/slot0/attn/wq``, ``embed/table``) and its stacked shapes:
``param_specs`` / ``opt_state_specs`` take the port's ``LM``, whose layers
are not stacked, evaluate each parameter on the path and stacked shape that
``convert.reference_paths`` gives it, and drop the stack entry.  So a
leaf that is small alone but large stacked (llama3.2-3b's norm scales:
3072 elements, 86016 over its 28 layers) is sharded where the reference
shards it.

``cache_specs`` (decode caches: batch over the dp axes, the attention
cache's length over the tp axis, recurrent state channels over it where
they divide) and ``logits_spec`` are the reference's rules over its cache
paths (``seg0/slot0/k``); ``stack_cache_specs`` maps them onto the port's
per-layer caches, and ``placed_cache_specs`` gives the pieces the port
places (the two differ on a segment that repeats once).  ``constrain`` has
no GSPMD to pin: here it is "this rank's piece of a whole tensor under
``spec``", the whole tensor without a mesh.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig, PolicyConfig
from repro_torch.models.transformer import plan_segments

Entry = Any                       # None | axis name | tuple of axis names
Spec = Tuple[Entry, ...]


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------
def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def axis_entry_size(entry, mesh_axes: Mapping[str, int]) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return mesh_axes[entry]
    return _prod(mesh_axes[a] for a in entry)


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, outermost first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape: Sequence[int], spec: Spec,
                mesh_axes: Mapping[str, int]) -> Tuple[int, ...]:
    """The shape of one rank's piece of a ``shape`` tensor laid out by
    ``spec`` (every sharded dimension divides: the rules check it)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = axis_entry_size(entry, mesh_axes)
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {entry!r} ({n})")
        out[d] //= n
    return tuple(out)


def placements(spec: Spec, mesh) -> List[Any]:
    """The DTensor placements ``spec`` means on ``mesh`` (a ``DeviceMesh``
    or anything with ``mesh_dim_names``): ``Shard(d)`` on each mesh
    dimension that splits tensor dimension ``d``, ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard
    dims = {}
    for d, entry in enumerate(spec):
        for a in entry_axes(entry):
            dims[a] = d
    return [Shard(dims[a]) if a in dims else Replicate()
            for a in mesh.mesh_dim_names]


# ---------------------------------------------------------------------------
# parameter sharding rules
# ---------------------------------------------------------------------------
# (regex over path, preferred TP dim index *after* any leading stack dim).
# -1 means last dim. None means "never TP-shard".
_TP_RULES: Tuple[Tuple[str, Optional[int]], ...] = (
    (r"moe/w[igo]$", 0),            # expert dim (EP)
    (r"moe/router$", None),
    (r"attn/wq$", 1),               # (d, H, hd) -> heads
    (r"attn/w[kv]$", 1),            # (d, K, hd) -> kv heads
    (r"attn/wo$", 0),               # (H, hd, d) -> heads
    (r"attn/b[qkv]$", 0),
    (r"(mlp|shared)/w[ig]$", -1),   # (d, F) -> hidden
    (r"(mlp|shared)/wo$", 0),       # (F, d) -> hidden
    (r"(embed|head)/table$", 0),    # (V, d) -> vocab
    (r"pos_embed$", None),
    (r"ssm/in_[zx]$", -1),          # (d, d_in) -> inner dim (heads x P)
    (r"ssm/in_(b|c|dt)$", None),    # grouped B/C + dt: small, replicate
    (r"ssm/out_proj$", 0),          # (d_in, d)
    (r"ssm/conv_\w+$", -1),
    (r"rglru/in_(gate|rec)$", -1),  # (d, W)
    (r"rglru/out_proj$", 0),
    (r"rglru/conv_[wb]$", -1),
    (r"rglru/(wa|wx)$", None),      # block-diag gates: small, replicate
    (r"norm", None),
)

_REPLICATE_BELOW = 1 << 16          # leaves smaller than 64K elems replicate


def _pick_tp_dim(pstr: str, shape: Tuple[int, ...], skip: int,
                 tp_size: int) -> Optional[int]:
    """Dim index (absolute) to shard over the tp axis, or None."""
    for pat, dim in _TP_RULES:
        if re.search(pat, pstr):
            if dim is None:
                return None
            d = dim if dim >= 0 else len(shape) - 1
            d = d + skip if dim >= 0 else d
            if d < len(shape) and d >= skip and shape[d] % tp_size == 0:
                return d
            break   # rule matched but indivisible -> generic fallback
    # generic: largest divisible dim (excluding stack dims)
    cands = [(shape[d], d) for d in range(skip, len(shape))
             if shape[d] % tp_size == 0]
    if not cands:
        return None
    size, d = max(cands)
    return d if size >= tp_size else None


def _pick_fsdp_dim(shape: Tuple[int, ...], skip: int, taken: Optional[int],
                   fsdp_size: int) -> Optional[int]:
    cands = [(shape[d], d) for d in range(skip, len(shape))
             if d != taken and shape[d] % fsdp_size == 0]
    if not cands:
        return None
    size, d = max(cands)
    return d if size >= fsdp_size else None


def _stack_skip(pstr: str, cfg: ModelConfig) -> int:
    """1 if this param carries a leading scan-stacked layer dim."""
    m = re.match(r"stack/seg(\d+)/", pstr)
    if not m:
        return 0
    segs = plan_segments(cfg.pattern)
    si = int(m.group(1))
    return 1 if si < len(segs) and segs[si][1] > 1 else 0


def param_spec(pstr: str, shape: Tuple[int, ...], cfg: ModelConfig,
               policy: PolicyConfig, mesh_axes: Mapping[str, int],
               *, shard_fsdp: bool, is_opt: bool = False,
               fsdp_min: int = 2, tp_min: int = 2) -> Spec:
    """The spec of one leaf of the reference's pytree: ``pstr`` its path,
    ``shape`` its (stacked) shape.  An fsdp axis of the mesh takes part
    from size ``fsdp_min`` on, the tp axis from size ``tp_min``: 2 is the
    reference's rule; 1 shards over axes of size 1 too, whose pieces are
    the whole tensor (``train/sharding.py``)."""
    if _prod(shape) < _REPLICATE_BELOW:
        return ()
    skip = _stack_skip(pstr, cfg)
    entries: list = [None] * len(shape)

    tp = policy.tp_axis
    tp_size = mesh_axes.get(tp, 1) if tp else 1
    tp_dim = None
    if tp and tp in mesh_axes and tp_size >= tp_min:
        tp_dim = _pick_tp_dim(pstr, shape, skip, tp_size)
        if tp_dim is not None:
            entries[tp_dim] = tp

    # vocab tables (params only): V over tp only -- FSDP-sharding the D
    # (contraction) dim turns every logits chunk into a partial-sum
    # all-reduce over data; optimizer states never feed a matmul, so they
    # keep the full fsdp sharding for memory
    if (not is_opt and tp_dim is not None
            and re.search(r"(embed|head)/table$", pstr)):
        return tuple(entries)

    if shard_fsdp and policy.fsdp_axes:
        fs = tuple(a for a in policy.fsdp_axes
                   if a in mesh_axes and mesh_axes[a] >= fsdp_min)
        if fs:
            fsdp_size = _prod(mesh_axes[a] for a in fs)
            fd = _pick_fsdp_dim(shape, skip, tp_dim, fsdp_size)
            if fd is not None:
                entries[fd] = fs if len(fs) > 1 else fs[0]
    return tuple(entries)


def _specs(model, cfg: ModelConfig, policy: PolicyConfig,
           mesh_axes: Mapping[str, int], *, shard_fsdp: bool,
           is_opt: bool, fsdp_min: int, tp_min: int) -> Dict[str, Spec]:
    from repro_torch.convert import reference_paths
    out = {}
    for name, (path, shape) in reference_paths(model).items():
        spec = param_spec(path, shape, cfg, policy, mesh_axes,
                          shard_fsdp=shard_fsdp, is_opt=is_opt,
                          fsdp_min=fsdp_min, tp_min=tp_min)
        out[name] = spec[_stack_skip(path, cfg):] if spec else spec
    return out


def param_specs(model, cfg: ModelConfig, policy: PolicyConfig,
                mesh_axes: Mapping[str, int], *,
                fsdp_min: int = 2, tp_min: int = 2) -> Dict[str, Spec]:
    """Parameter name -> spec for the port's ``LM`` (any device, ``meta``
    too): the reference's spec of the leaf, its stack entry dropped
    (``fsdp_min``, ``tp_min``: ``param_spec``'s)."""
    return _specs(model, cfg, policy, mesh_axes,
                  shard_fsdp=policy.zero_stage >= 3, is_opt=False,
                  fsdp_min=fsdp_min, tp_min=tp_min)


def opt_state_specs(model, cfg: ModelConfig, policy: PolicyConfig,
                    mesh_axes: Mapping[str, int], *,
                    fsdp_min: int = 2, tp_min: int = 2) -> Dict[str, Spec]:
    """Adam moment (and fp32 master) sharding: ZeRO-1+ shards optimizer
    state even when the params themselves are replicated (paper's "sharded
    training")."""
    return _specs(model, cfg, policy, mesh_axes,
                  shard_fsdp=policy.zero_stage >= 1, is_opt=True,
                  fsdp_min=fsdp_min, tp_min=tp_min)


# ---------------------------------------------------------------------------
# batch sharding
# ---------------------------------------------------------------------------
def dp_spec_for_batch(batch: int, policy: PolicyConfig,
                      mesh_axes: Mapping[str, int]):
    """The batch-dim entry: the largest prefix of dp axes that divides."""
    axes = [a for a in policy.dp_axes if mesh_axes.get(a, 1) > 1]
    while axes and batch % _prod(mesh_axes[a] for a in axes):
        axes = axes[1:]      # drop outermost (pod) first
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def batch_specs(example: Any, policy: PolicyConfig,
                mesh_axes: Mapping[str, int], *,
                seq_axis: Optional[str] = None) -> Any:
    """Specs for a batch (a dict, list or tuple of arrays, nested): dim 0 =
    batch over the dp axes; optional sequence sharding of dim 1 over
    ``seq_axis`` (context parallel)."""
    if isinstance(example, Mapping):
        return {k: batch_specs(v, policy, mesh_axes, seq_axis=seq_axis)
                for k, v in example.items()}
    if isinstance(example, (list, tuple)):
        return type(example)(batch_specs(v, policy, mesh_axes,
                                         seq_axis=seq_axis) for v in example)
    if example.ndim == 0:
        return ()
    dp = dp_spec_for_batch(example.shape[0], policy, mesh_axes)
    entries: list = [dp] + [None] * (example.ndim - 1)
    if (seq_axis and example.ndim >= 2
            and example.shape[1] % mesh_axes.get(seq_axis, 1) == 0
            and example.shape[1] >= 2 * mesh_axes.get(seq_axis, 1)):
        entries[1] = seq_axis
    return tuple(entries)


# ---------------------------------------------------------------------------
# decode caches, logits, activation pieces
# ---------------------------------------------------------------------------
def _tree_leaves(tree, path=()):
    """(path joined by ``/``, leaf) of a tree of dicts and lists, as
    ``jax.tree_util`` keys join (list items by index)."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _tree_leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _rebuild(tree, specs, path=()):
    if isinstance(tree, Mapping):
        return {k: _rebuild(v, specs, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, specs, path + (str(i),))
                          for i, v in enumerate(tree))
    return specs["/".join(path)]


def cache_spec(pstr: str, shape: Sequence[int], policy: PolicyConfig,
               mesh_axes: Mapping[str, int], *, tp_min: int = 2) -> Spec:
    """The spec of one decode-cache leaf at path ``pstr`` (the reference's
    rule, ``repro/core/policy.py:233-273``): batch over the dp axes; the
    attention cache's length W over the tp axis where it divides and is at
    least twice the axis; a recurrent leaf's largest such channel dim over
    it.  A leaf under ``seg*/slot*`` has a stacked layer dim first (the
    reference treats every one so).  The tp axis takes part from size
    ``tp_min`` (2 is the reference's rule)."""
    shape = tuple(int(s) for s in shape)
    nd = len(shape)
    tp = policy.tp_axis
    tp_size = mesh_axes.get(tp, 1) if tp else 1
    skip = 1 if re.search(r"seg\d+/slot\d+", pstr) and nd >= 1 else 0
    entries: list = [None] * nd
    bdim = skip
    if nd > bdim:
        entries[bdim] = dp_spec_for_batch(shape[bdim], policy, mesh_axes)
    if tp and tp in mesh_axes and tp_size >= tp_min and nd > bdim + 1:
        if re.search(r"/(k|v|pos)$", pstr):
            wdim = bdim + 1
            if shape[wdim] % tp_size == 0 and shape[wdim] >= 2 * tp_size:
                entries[wdim] = tp
        else:
            cands = [(shape[d], d) for d in range(bdim + 1, nd)
                     if shape[d] % tp_size == 0 and shape[d] >= 2 * tp_size]
            if cands:
                entries[max(cands)[1]] = tp
    return tuple(entries)


def cache_specs(caches: Any, policy: PolicyConfig,
                mesh_axes: Mapping[str, int], *, tp_min: int = 2) -> Any:
    """``cache_spec`` of every leaf of ``caches`` (nested dicts and lists of
    anything with a ``shape``, laid out as the reference's stacked cache
    tree), in the tree's structure."""
    specs = {p: cache_spec(p, leaf.shape, policy, mesh_axes, tp_min=tp_min)
             for p, leaf in _tree_leaves(caches)}
    return _rebuild(caches, specs)


def stack_cache_specs(cfg: ModelConfig, caches: Sequence[Mapping[str, Any]],
                      policy: PolicyConfig, mesh_axes: Mapping[str, int], *,
                      tp_min: int = 2) -> List[Dict[str, Spec]]:
    """The spec of each leaf of the port's per-layer caches (a list of one
    dict a layer): ``cache_spec`` on the leaf's path and stacked shape in
    the reference's tree (``seg{i}/slot{j}/<name>``, the segment's repeat
    count first where it scans), the stack entry dropped."""
    out, layer = [], 0
    for si, (unit, k) in enumerate(plan_segments(cfg.pattern)):
        for rep in range(k):
            for slot in range(len(unit)):
                row = {}
                for name, leaf in caches[layer].items():
                    shape = tuple(leaf.shape)
                    spec = cache_spec(f"seg{si}/slot{slot}/{name}",
                                      ((k,) + shape) if k > 1 else shape,
                                      policy, mesh_axes, tp_min=tp_min)
                    row[name] = spec[1:] if k > 1 else spec
                out.append(row)
                layer += 1
    return out


def placed_cache_specs(caches: Sequence[Mapping[str, Any]],
                       policy: PolicyConfig, mesh_axes: Mapping[str, int], *,
                       tp_min: int = 2) -> List[Dict[str, Spec]]:
    """The pieces of the port's per-layer caches that each rank computes
    on: every layer's leaf laid out as a scanned segment's is (batch over
    the dp axes, the attention cache's length or a recurrent leaf's largest
    channel dim over the tp axis), whether or not its segment scans.  It
    equals ``stack_cache_specs`` but on a segment that repeats once, where
    the reference's rule (``_is_stacked``, ``repro/core/policy.py:
    276-282``) takes the batch dim for a layer dim: recurrentgemma-2b's
    ``(R, R)`` remainder, whose state's batch entry falls on its width and
    whose channels stay whole, while the RG-LRU block computes on its
    rank's ``W / tp`` channels (ROADMAP queue C)."""
    return [{name: cache_spec(f"seg0/slot0/{name}", (1,) + tuple(
        leaf.shape), policy, mesh_axes, tp_min=tp_min)[1:]
        for name, leaf in layer.items()} for layer in caches]


def logits_spec(policy: PolicyConfig, mesh_axes: Mapping[str, int],
                batch: int, *, tp_min: int = 2) -> Spec:
    """(B, S, V) logits: batch over the dp axes, the vocabulary over the tp
    axis (``tp_min`` as ``cache_spec``'s)."""
    dp = dp_spec_for_batch(batch, policy, mesh_axes)
    tp = policy.tp_axis if (policy.tp_axis in mesh_axes and mesh_axes[
        policy.tp_axis] >= tp_min) else None
    return (dp, None, tp)


def constrain(x, spec: Optional[Spec], mesh=None):
    """This rank's piece of the whole tensor ``x`` under ``spec`` (a view);
    ``x`` itself without a mesh or a spec.  The reference pins a layout for
    GSPMD (``with_sharding_constraint``, a no-op without a mesh); the port
    has no GSPMD, and a tensor that every rank holds whole is cut here."""
    if spec is None or mesh is None:
        return x
    from repro_torch.train.sharding import piece
    return piece(x, spec, mesh)


# ---------------------------------------------------------------------------
# the paper's software-optimization ladder as named policies
# ---------------------------------------------------------------------------
def ladder(policy: PolicyConfig) -> Dict[str, PolicyConfig]:
    """Fig-16 ladder: DP -> DDP -> +mixed precision -> +ZeRO sharding."""
    base = dataclasses.replace(policy, zero_stage=0,
                               compute_dtype="float32",
                               hierarchical_allreduce=False)
    return {
        "DP": base,
        "DDP": dataclasses.replace(base, hierarchical_allreduce=True),
        "DDP+mixed": dataclasses.replace(base, compute_dtype="bfloat16",
                                         hierarchical_allreduce=True),
        "DDP+mixed+sharded": dataclasses.replace(
            base, compute_dtype="bfloat16", hierarchical_allreduce=True,
            zero_stage=3),
    }
