"""Device meshes, held against ``repro/launch/mesh.py``.

The reference lays a ``jax.sharding.Mesh`` over the devices of one process.
The port's mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of
an initialised process group: one rank a device.  Neither function starts a
group: the launcher (``launch/train.py``, or ``torchrun``) does, so a
program never finds itself in a group it did not ask for.
"""
from __future__ import annotations

from typing import Sequence

import torch.distributed as dist


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
