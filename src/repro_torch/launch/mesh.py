"""Device meshes, held against ``repro/launch/mesh.py``.

The reference lays a ``jax.sharding.Mesh`` over the devices of one process.
The port's mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of
an initialised process group: one rank a device.  Neither function starts a
group: the launcher (``launch/train.py``, or ``torchrun``) does, so a
program never finds itself in a group it did not ask for.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Sequence

import torch.distributed as dist

AXIS_ORDER = ("pod", "data", "model")    # outermost first, as the reference's


def parse_mesh(text: str) -> Dict[str, int]:
    """``"model=2,data=4"`` -> ``{"data": 4, "model": 2}``: the launchers'
    ``--mesh``, axes in ``AXIS_ORDER`` (outermost first)."""
    if not text:
        return {}
    sizes = {}
    for part in text.split(","):
        name, _, n = part.partition("=")
        if name not in AXIS_ORDER or not n.isdigit() or int(n) < 1:
            raise ValueError(f"--mesh {text!r}: want axis=N of {AXIS_ORDER}")
        sizes[name] = int(n)
    return {a: sizes[a] for a in AXIS_ORDER if a in sizes}


def start_group(device: str) -> None:
    """Join ``torchrun``'s group (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` / ``MASTER_PORT``), or start a one-rank group: NCCL on
    the card, ``gloo`` on the CPU.  A failed NCCL start raises."""
    import torch
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def _world(what: str) -> int:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"{what} needs an initialised process group "
            "(torch.distributed.init_process_group, torchrun, or "
            "repro_torch.launch.train --mesh)")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """Single-pod (16,16) ("data","model") or multi-pod (2,16,16)
    ("pod","data","model") mesh over the group's ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    have = _world("a production mesh")
    if have < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {have} -- run on "
            "real hardware")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the group's first
    ``prod(shape)`` ranks (rank r at the row-major position r), on
    ``device`` ("cuda", or "cpu" for a ``gloo`` group).  Every rank of the
    group calls it; a rank past the mesh gets one without a coordinate
    (``get_coordinate()`` is None), as a job's survivors go on after an
    elastic shrink while the others stop."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    n = 1
    for s in shape:
        n *= s
    have = _world("a device mesh")
    if have < n:
        raise RuntimeError(f"need {n} devices, have {have}")
    if have == n:
        return init_device_mesh(device, shape, mesh_dim_names=axes)
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


@contextlib.contextmanager
def one_rank(shape: Sequence[int] = (1, 1),
             axes: Sequence[str] = ("data", "model"), device: str = "cuda"):
    """A one-rank group (NCCL on the card, ``gloo`` on the CPU) and a mesh
    of ``shape`` (every size 1) over it, destroyed on leaving: the mesh on
    which one card (or one test process) runs every collective, shard and
    gather of a wider mesh's program."""
    import torch
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_mesh(shape, axes, device=torch.device(device).type)
    finally:
        dist.destroy_process_group()
