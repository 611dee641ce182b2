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
``opt/v/<name>`` and ``opt/master/<name>`` for a ``TrainState``; the
parameter names of an ``nn.Module``; ``a/b`` paths of nested dicts.
``restore`` copies into the tensors of the state it is given (in place, on
their devices) and returns it.  Reading the reference's checkpoints is not
supported.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.optim.adamw import AdamWState
from repro_torch.train.trainer import TrainState


def _leaves(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """key -> tensor (or, for the optimizer step, an int) of ``tree``."""
    if isinstance(tree, TrainState):
        return {**_leaves(tree.model, "params/"), **_leaves(tree.opt, "opt/")}
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


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
         extra: Optional[Mapping[str, Any]] = None) -> str:
    """Atomically persist ``tree`` (gathered to the host) as step ``step``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat, dtypes = {}, {}
    for k, x in _leaves(tree).items():
        flat[k], dt = _to_numpy(x)
        if dt is not None:
            dtypes[k] = dt
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
        final = os.path.join(ckpt_dir, f"step_{step:010d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


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
def restore(ckpt_dir: str, like: Any, *, step: Optional[int] = None
            ) -> Tuple[Any, int]:
    """Load a checkpoint into ``like`` (a ``TrainState``, module or dict of
    tensors), in place; returns (like, step).  Raises ``ValueError`` when a
    stored array's shape differs from the tensor it would fill."""
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
