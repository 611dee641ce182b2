"""Fault-tolerant checkpoints, held against ``repro/train/checkpoint.py``:
the same file layout and semantics, the port's own key names.

  * **Atomicity** -- written to ``<dir>/tmp.<step>.*``, fsynced ``DONE``
    marker, then renamed to ``<dir>/step_<step:010d>``; a crash mid-write
    never surfaces as a step (``all_steps`` lists only directories with
    ``DONE``).
  * **GC** -- the newest ``keep`` checkpoints stay; orphaned ``tmp.*``
    directories of crashed writers are swept.
  * **Format** -- ``arrays.npz`` (flattened key -> array, gathered to the
    host) and ``meta.json`` (``step``, sorted ``keys``, optional ``extra``,
    and the torch dtype of every array whose numpy dtype cannot say it:
    bf16 is stored as its raw 16-bit pattern).

Keys: ``params/<parameter name>``, ``opt/step``, ``opt/m/<name>``,
``opt/v/<name>``, ``opt/master/<name>`` and ``ef/<name>`` (the int8
error-feedback residuals, one per pod, stacked) for a ``TrainState``; the
parameter names of an ``nn.Module``; ``a/b`` paths of nested dicts.
``restore`` copies into the tensors of the state it is given (in place, on
their devices) and returns it.  Reading the reference's checkpoints is not
supported.

Under a mesh (a ``TrainState`` with a ``layout``) every rank calls
``save``: each leaf is gathered whole from its pieces (a ``DTensor`` of
its spec's placements) and rank 0 writes the same files as without a mesh.
``restore(..., mesh=, specs=)`` lays every leaf out as the reference's
``device_put`` under ``NamedSharding(mesh, spec)`` does: each rank copies
its piece under the spec into the state it is given, which may sit on
another mesh than the one that saved (an elastic shrink from 4 ranks to 2).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.optim.adamw import AdamWState
from repro_torch.train import sharding
from repro_torch.train.trainer import TrainState


def _leaves(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """key -> tensor (or, for the optimizer step, an int) of ``tree``."""
    if isinstance(tree, TrainState):
        out = {**_leaves(tree.model, "params/"), **_leaves(tree.opt, "opt/")}
        if tree.ef_residual is not None:
            out.update(_leaves(tree.ef_residual, "ef/"))
        return out
    if isinstance(tree, AdamWState):
        out = {prefix + "step": tree.step}
        out.update(_leaves(tree.m, prefix + "m/"))
        out.update(_leaves(tree.v, prefix + "v/"))
        if tree.master is not None:
            out.update(_leaves(tree.master, prefix + "master/"))
        return out
    if isinstance(tree, nn.Module):
        return {prefix + n: p for n, p in tree.named_parameters()}
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/") if isinstance(
                v, (Mapping, nn.Module)) else {prefix + str(k): v})
        return out
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _to_numpy(x) -> Tuple[np.ndarray, Optional[str]]:
    if not torch.is_tensor(x):
        return np.asarray(x, dtype=np.int64), None
    t = x.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), None


def whole_leaves(tree: Any) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) of ``tree`` one at a time, each leaf whole: under a mesh
    gathered from the ranks' pieces (every rank calls it and gets every
    leaf; the int8 residuals stacked over the pods)."""
    layout = getattr(tree, "layout", None)
    specs = layout.leaf_specs(tree) if layout is not None else {}
    for k, x in _leaves(tree).items():
        if k in specs:
            ef = k.startswith("ef/")
            x = sharding.full_tensor(x.unsqueeze(0) if ef else x, specs[k],
                                     layout.mesh)
        yield k, x


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
         extra: Optional[Mapping[str, Any]] = None) -> str:
    """Atomically persist ``tree`` (gathered to the host) as step ``step``.
    Under a mesh every rank calls it, and rank 0 writes."""
    layout = getattr(tree, "layout", None)
    writer = layout is None or dist.get_rank() == 0
    flat, dtypes = {}, {}
    for k, x in whole_leaves(tree):
        if writer:
            flat[k], dt = _to_numpy(x)
            if dt is not None:
                dtypes[k] = dt
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if writer:
        _write(ckpt_dir, step, flat, dtypes, extra, final, keep)
    if layout is not None:
        dist.barrier()
    return final


def _write(ckpt_dir, step, flat, dtypes, extra, final, keep) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"tmp.{step}.", dir=ckpt_dir)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        meta = {"step": int(step), "keys": sorted(flat)}
        if dtypes:
            meta["dtypes"] = dtypes
        if extra:
            meta["extra"] = dict(extra)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "DONE"), "w") as f:
            f.write("ok")
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)
    for name in os.listdir(ckpt_dir):           # crashed writers
        if name.startswith("tmp."):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.match(r"step_(\d+)$", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "DONE")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


@torch.no_grad()
def restore(ckpt_dir: str, like: Any, *, step: Optional[int] = None,
            mesh=None, specs: Optional[Mapping[str, Any]] = None
            ) -> Tuple[Any, int]:
    """Load a checkpoint into ``like`` (a ``TrainState``, module or dict of
    tensors), in place; returns (like, step).  Raises ``ValueError`` when a
    stored array's shape differs from the tensor it would fill.

    ``mesh`` / ``specs`` (checkpoint key -> spec, as ``trainer.state_specs``
    gives them): each rank fills ``like`` with its piece of every leaf; a
    laid-out ``TrainState`` defaults to its own layout's."""
    layout = getattr(like, "layout", None)
    if layout is not None:
        mesh = layout.mesh if mesh is None else mesh
        specs = layout.leaf_specs(like) if specs is None else specs
    if specs is not None and mesh is None:
        raise ValueError("specs without a mesh")
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    dtypes = meta(ckpt_dir, step).get("dtypes", {})
    data = np.load(os.path.join(path, "arrays.npz"))
    for key, leaf in _leaves(like).items():
        arr = data[key]
        if not torch.is_tensor(leaf):
            _set_step(like, int(arr))
            continue
        if specs is not None:
            arr = sharding.piece(arr, specs.get(key, ()), mesh)
            if key.startswith("ef/") and arr.ndim == leaf.ndim + 1:
                arr = arr[0]                # this rank's pod
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if dtypes.get(key) == "bfloat16":
            t = t.view(torch.bfloat16)
        leaf.copy_(t)
    return like, step


def _set_step(like: Any, step: int) -> None:
    opt = like if isinstance(like, AdamWState) else getattr(like, "opt", None)
    if opt is None:
        raise TypeError("a checkpointed optimizer step needs an AdamWState")
    opt.step = step


def meta(ckpt_dir: str, step: int) -> Dict[str, Any]:
    with open(os.path.join(ckpt_dir, f"step_{step:010d}", "meta.json")) as f:
        return json.load(f)
