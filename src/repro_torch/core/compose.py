"""Composition layer: DevicePool -> ComposedSystem (logical mesh + fabric),
held against ``repro/core/compose.py``.

A ``ComposedSystem`` is the paper's "host configuration" (Table III): a
selection of pool devices arranged into a named-axis logical mesh, plus the
link class each axis rides on and the storage tier feeding the input
pipeline.  The same model program runs unmodified on any composition; only
the fabric pricing (and thus the roofline collective term) changes — which
is exactly the experiment the paper runs on its Falcon chassis.

Composable operations:
  * ``compose(...)``           — build a system from the pool
  * ``recompose(...)``         — swap fabric/axes after failure or resize
  * ``PRESETS``                — the paper's five Table III configurations

``ComposedSystem.mesh()`` makes the composition's ``torch`` ``DeviceMesh``
over an initialised process group (``launch/mesh.make_mesh``), where the
reference makes a ``jax.Mesh``; ``abstract_mesh()`` is the ``{axis: size}``
mapping the policy engine takes (the reference's ``AbstractMesh``), and
needs no group.  The pricing needs no mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.topology import (
    LOCAL_NVME, SWITCH_NVME, ChipSpec, DevicePool, FabricSpec, LeaseError,
    LinkClass, StorageSpec, make_pool)


@dataclasses.dataclass(frozen=True)
class ComposedSystem:
    """A logical machine composed from the pool.

    ``axis_names``/``axis_sizes`` define the logical mesh; ``fabric`` prices
    every axis; ``device_uids`` records which pool devices were claimed (for
    elastic recomposition and failure handling).
    """
    name: str
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    fabric: FabricSpec
    device_uids: Tuple[int, ...] = ()
    chip: ChipSpec = dataclasses.field(default_factory=ChipSpec)
    # storage tranche leased with this composition (None = legacy static
    # tier pricing only; see ``data.storage``)
    tranche: Optional[str] = None

    # ------------------------------------------------------------ derived --
    @property
    def n_devices(self) -> int:
        return int(np.prod(self.axis_sizes))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    # --------------------------------------------------------------- mesh --
    def mesh(self, device: str = "cuda"):
        """The composition's ``DeviceMesh`` over the initialised process
        group, one rank a device (``launch/mesh.make_mesh``)."""
        from repro_torch.launch.mesh import make_mesh
        return make_mesh(self.axis_sizes, self.axis_names, device=device)

    def abstract_mesh(self) -> Dict[str, int]:
        """The mesh's ``{axis: size}``, what ``core/policy`` takes."""
        return dict(self.shape)

    # ----------------------------------------------------------- pricing --
    def axis_bandwidth(self, axis: str) -> float:
        return self.fabric.bandwidth(axis)

    def collective_time(self, axis: str, nbytes: float,
                        kind: str = "all-reduce") -> float:
        """Ring-collective time for ``nbytes`` (per-device payload) on
        ``axis``. Standard ring costs on n participants; each of the
        n-1 ring steps pays the axis's full hop count of link latency
        (1 hop on the flat fabric — the legacy price)."""
        n = self.axis_size(axis)
        if n <= 1:
            return 0.0
        link = self.fabric.link(axis)
        factor = {
            "all-reduce": 2.0 * (n - 1) / n,
            "all-gather": (n - 1) / n,
            "reduce-scatter": (n - 1) / n,
            "all-to-all": (n - 1) / n,
            "collective-permute": 1.0,
        }[kind]
        return (factor * nbytes / link.bandwidth
                + (n - 1) * self.fabric.hops(axis) * link.latency)


# ---------------------------------------------------------------------------
# composition / recomposition
# ---------------------------------------------------------------------------
class CompositionError(RuntimeError):
    pass


def compose(pool: DevicePool, name: str,
            axis_names: Sequence[str], axis_sizes: Sequence[int],
            axis_links: Mapping[str, LinkClass],
            storage: StorageSpec = LOCAL_NVME,
            prefer_fabric: Optional[LinkClass] = None,
            uids: Optional[Sequence[int]] = None,
            storage_pool=None, tranche: Optional[str] = None,
            storage_capacity: float = 0.0,
            axis_hops: Optional[Mapping[str, int]] = None,
            axis_bw_scale: Optional[Mapping[str, float]] = None
            ) -> ComposedSystem:
    """Claim devices from the pool and build a ComposedSystem.

    Devices are taken domain-major so that the *innermost* (fastest-varying)
    axes land inside a single locality domain — mirroring how the paper
    keeps NVLink cliques intact and spans the falcon switch only on the
    outer axis.

    Claims are *exclusive*: the chosen devices are leased in the pool under
    the composition's name, so an overlapping ``compose()`` raises
    ``CompositionError`` instead of silently double-claiming chips.  Free
    them with ``release()`` (or ``recompose()``, which re-leases).

    ``uids``: explicit device selection (e.g. from the cluster plane's
    placement) — claimed verbatim, so the
    caller's placement decision is exactly what the lease records.

    ``storage_pool``/``tranche``: a composition is devices **plus**
    storage.  When given, the named NVMe tranche (``data.storage``)
    is leased under the composition's name — atomically with the device
    claim: a storage conflict rolls the device lease back — and the
    fabric's storage tier is priced from that tranche.

    ``axis_hops``/``axis_bw_scale``: per-axis path resolution from the
    pool's topology (the cluster plane derives them); omitted
    axes ride one full-speed hop, the flat-fabric default.
    """
    n = int(np.prod(list(axis_sizes)))
    free = pool.available()
    if uids is not None:
        if len(uids) != n:
            raise CompositionError(
                f"explicit selection has {len(uids)} uids; composition "
                f"{name!r} needs {n}")
        free_uids = {d.uid for d in free}
        missing = [u for u in uids if u not in free_uids]
        if missing:
            raise CompositionError(
                f"{len(missing)} of the selected devices are failed, "
                f"leased, or absent: {sorted(missing)[:8]}")
        ordered = list(uids)
        claimed = tuple(uids)
    else:
        if prefer_fabric is not None:
            ordered = ([d for d in free if d.fabric == prefer_fabric]
                       + [d for d in free if d.fabric != prefer_fabric])
        else:
            ordered = sorted(free, key=lambda d: (d.domain, d.fabric.value,
                                                  d.uid))
        if len(ordered) < n:
            n_leased = sum(1 for d in pool.healthy() if d.uid in pool.leases)
            raise CompositionError(
                f"pool has {len(ordered)} available devices "
                f"({n_leased} healthy but leased); composition "
                f"{name!r} needs {n}")
        claimed = tuple(d.uid for d in ordered[:n])
    try:
        pool.lease(claimed, name)
    except LeaseError as e:              # e.g. duplicate uids in `uids`
        raise CompositionError(str(e)) from e
    if storage_pool is not None and tranche is not None:
        try:
            storage_pool.lease(tranche, name,
                               capacity_bytes=storage_capacity)
        except CompositionError:
            pool.release(claimed)        # atomic: no half-composition
            raise
        storage = storage_pool.tranches[tranche].spec()
    fabric = FabricSpec(dict(axis_links), dict(pool.links), storage,
                        dict(axis_hops or {}), dict(axis_bw_scale or {}))
    return ComposedSystem(name, tuple(axis_names), tuple(axis_sizes),
                          fabric, claimed, tranche=tranche)


def release(pool: DevicePool, system: ComposedSystem,
            storage_pool=None) -> None:
    """Return ``system``'s devices (and, when ``storage_pool`` is given,
    its storage tranche) to the pool (job finished / preempted)."""
    pool.release(system.device_uids)
    if storage_pool is not None:
        storage_pool.release(system.name)


def recompose(pool: DevicePool, system: ComposedSystem, *,
              axis_sizes: Optional[Sequence[int]] = None,
              axis_links: Optional[Mapping[str, LinkClass]] = None,
              storage: Optional[StorageSpec] = None) -> ComposedSystem:
    """Re-build ``system`` after pool change (failure, attach, resize).

    This is the paper's dynamic re-allocation: the logical machine is
    re-formed from whatever healthy devices remain; training resumes from
    the latest checkpoint.  The storage
    tranche lease (held by name) survives the recompose untouched.
    """
    sizes = tuple(axis_sizes or system.axis_sizes)
    links = dict(axis_links or system.fabric.axis_links)
    st = storage or system.fabric.storage
    # release the old claim first (the new composition may reuse surviving
    # devices); restore it if the re-compose fails, so a failed recompose
    # leaves the pool exactly as it was.
    old = [u for u in system.device_uids if pool.leases.get(u) == system.name]
    pool.release(old)
    try:
        return compose(pool, system.name, system.axis_names, sizes, links,
                       st, tranche=system.tranche)
    except CompositionError:
        present = {d.uid for d in pool.devices}
        pool.lease([u for u in old if u in present], system.name)
        raise


def shrink_to_pool(pool: DevicePool, system: ComposedSystem,
                   shrink_axis: str) -> ComposedSystem:
    """Elastic downsize: halve ``shrink_axis`` until the composition fits
    the devices this system can draw on — the unleased healthy pool plus
    its own surviving claim (other tenants' leases are off-limits)."""
    sizes = dict(zip(system.axis_names, system.axis_sizes))
    own = set(system.device_uids)
    n_capacity = len(pool.available()) + sum(
        1 for d in pool.devices
        if d.healthy and d.uid in own and pool.leases.get(d.uid) == system.name)
    while int(np.prod(list(sizes.values()))) > n_capacity:
        if sizes[shrink_axis] <= 1:
            raise CompositionError("cannot shrink further")
        sizes[shrink_axis] //= 2
    return recompose(pool, system,
                     axis_sizes=[sizes[a] for a in system.axis_names])


# ---------------------------------------------------------------------------
# Table III presets (the paper's five host configurations)
# ---------------------------------------------------------------------------
def preset(label: str, *, data: int = 16, model: int = 16,
           pods: int = 1) -> ComposedSystem:
    """The paper's Table III configurations on the production mesh.

    | paper label  | rendering                                             |
    |--------------|-------------------------------------------------------|
    | localGPUs    | both axes on LOCAL (NVLink), local NVMe               |
    | hybridGPUs   | model axis LOCAL, data axis SWITCH (half the machine  |
    |              | behind the composed fabric), local NVMe               |
    | falconGPUs   | both axes SWITCH (whole machine composed), local NVMe |
    | localNVMe    | localGPUs + explicit local NVMe tier                  |
    | falconNVMe   | localGPUs + switch-attached NVMe tier                 |

    ``pods=2`` adds the "pod" axis on DCN (the multi-pod production mesh).
    """
    configs: Dict[str, Tuple[Dict[str, LinkClass], StorageSpec]] = {
        "localGPUs": ({"data": LinkClass.LOCAL, "model": LinkClass.LOCAL},
                      LOCAL_NVME),
        "hybridGPUs": ({"data": LinkClass.SWITCH, "model": LinkClass.LOCAL},
                       LOCAL_NVME),
        "falconGPUs": ({"data": LinkClass.SWITCH, "model": LinkClass.SWITCH},
                       LOCAL_NVME),
        "localNVMe": ({"data": LinkClass.LOCAL, "model": LinkClass.LOCAL},
                      LOCAL_NVME),
        "falconNVMe": ({"data": LinkClass.LOCAL, "model": LinkClass.LOCAL},
                       SWITCH_NVME),
    }
    if label not in configs:
        raise KeyError(f"unknown preset {label!r}; known: {sorted(configs)}")
    axis_links, storage = configs[label]
    names: Tuple[str, ...] = ("data", "model")
    sizes: Tuple[int, ...] = (data, model)
    if pods > 1:
        names = ("pod",) + names
        sizes = (pods,) + sizes
        axis_links = dict(axis_links, pod=LinkClass.DCN)
    pool = make_pool(n_local=pods * data * model,
                     n_switch=pods * data * model, pods=max(pods, 1))
    want = (LinkClass.SWITCH if all(
        v == LinkClass.SWITCH for k, v in axis_links.items() if k != "pod")
        else LinkClass.LOCAL)
    sys_ = compose(pool, label, names, sizes, axis_links, storage,
                   prefer_fabric=want)
    return sys_


PRESET_LABELS = ("localGPUs", "hybridGPUs", "falconGPUs", "localNVMe",
                 "falconNVMe")


def production_system(multi_pod: bool = False,
                      label: str = "localGPUs") -> ComposedSystem:
    """The production mesh: 16x16 single-pod or 2x16x16 multi-pod."""
    return preset(label, data=16, model=16, pods=2 if multi_pod else 1)
