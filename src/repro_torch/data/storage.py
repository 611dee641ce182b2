"""NVMe tranches: storage as a first-class composable resource, held
against ``repro/data/storage.py``.

The paper's §V-3 experiment (Fig 15/16) composes the *storage* side of a
workload — the same NVMe device attached either host-local or behind the
Falcon switch — and measures the input-path impact.  The cluster control
plane so far leased only GPU pools; this module gives storage the same
treatment, following the disaggregated-resource model (Takano & Suzaki's
accelerator manager, MLPerf-Storage's AU accounting):

  * ``StorageTranche``  — one leasable slice of pooled NVMe: capacity,
    sustained read/write bandwidth, and the fabric it attaches through
    (``LinkClass.LOCAL`` = host NVMe, ``LinkClass.SWITCH`` = the paper's
    falcon-attached drawer).
  * ``StoragePool``     — the chassis storage inventory.  Unlike device
    leases (exclusive: one chip, one tenant), tranches are *shared* by
    default — the composable switch is exactly what lets N hosts attach
    one drawer — and the tranche's bandwidth is partitioned equally
    across its concurrent lessees.  The invariants are: a holder never
    claims the same tranche twice, an ``exclusive`` claim tolerates no
    co-tenants, and capacity is never oversubscribed; violations raise
    ``CompositionError`` just like a device double-claim.

A composition is then *devices + storage*: ``core.compose.compose()``
accepts a ``(storage_pool, tranche)`` pair and leases the tranche under
the composition's name (the cluster plane's admission also requires a
storage lease before a job may start: ``cluster.scheduler``).

Invariants:

  * **Atomic claims** — ``StoragePool.lease`` either records the lease
    or raises ``CompositionError`` leaving the pool untouched; inside
    ``compose(..., storage_pool=, tranche=)`` a storage conflict rolls
    the device claim back too, so a composition is never half-formed.
  * **CompositionError conditions** — unknown tranche; a double claim
    by the same holder (storage leases don't stack); an exclusive
    claim meeting existing lessees, or any claim meeting an exclusive
    lease; capacity oversubscription.
  * **Equal partitioning** — a tranche's read/write bandwidth divides
    equally across its current lessees after the attach fabric's
    ceiling (``topology.partitioned_bw``); there is no QoS weighting
    yet (ROADMAP follow-up).
  * **Stall re-derivation** — consumers must re-derive input stalls
    whenever ``n_lessees`` changes on a tranche (the reference's cluster
    scheduler does this on every start/complete/preempt/shrink), and
    checkpoint *restores* are priced at the same contended per-lessee
    bandwidth, not the uncontended tier rate.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.core.compose import CompositionError
from repro_torch.core.topology import (DEFAULT_LINKS, LinkClass, LinkSpec,
                                 StorageSpec, partitioned_bw)

# NVMe constants (the paper's Intel SSDPEDKX040T7-class device, as in
# core.topology):
# 4 TB, ~3.2 GB/s sustained sequential read, ~1.9 GB/s sequential write.
NVME_CAPACITY = 4e12
NVME_READ_BW = 3.2e9
NVME_WRITE_BW = 1.9e9


@dataclasses.dataclass(frozen=True)
class StorageTranche:
    """One leasable slice of pooled NVMe."""
    name: str
    capacity_bytes: float = NVME_CAPACITY
    read_bw: float = NVME_READ_BW          # bytes/s sustained sequential
    write_bw: float = NVME_WRITE_BW
    attach: LinkClass = LinkClass.LOCAL    # fabric between device and hosts
    domain: int = 0                        # locality domain of the drawer

    def spec(self) -> StorageSpec:
        """The legacy single-tenant view (``FabricSpec.storage``)."""
        return StorageSpec(self.name, self.read_bw, self.attach)

    def effective_read_bw(self, links: Mapping[LinkClass, LinkSpec],
                          n_lessees: int = 1) -> float:
        """Per-lessee read bandwidth (see ``topology.partitioned_bw``)."""
        return partitioned_bw(self.read_bw, links[self.attach], n_lessees)

    def effective_write_bw(self, links: Mapping[LinkClass, LinkSpec],
                           n_lessees: int = 1) -> float:
        return partitioned_bw(self.write_bw, links[self.attach], n_lessees)


@dataclasses.dataclass(frozen=True)
class StorageLease:
    """One holder's claim on one tranche."""
    tranche: str
    holder: str
    capacity_bytes: float = 0.0
    exclusive: bool = False
    t_acquired: float = 0.0


class StoragePool:
    """Shared tranche inventory with per-tranche lessee accounting."""

    def __init__(self, tranches: List[StorageTranche],
                 links: Optional[Dict[LinkClass, LinkSpec]] = None):
        names = [t.name for t in tranches]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tranche names: {sorted(names)}")
        self.tranches: Dict[str, StorageTranche] = {t.name: t
                                                    for t in tranches}
        self.links = dict(links or DEFAULT_LINKS)
        # tranche -> holder -> lease (insertion-ordered: deterministic)
        self._leases: Dict[str, Dict[str, StorageLease]] = {
            t.name: {} for t in tranches}

    # ------------------------------------------------------------- claims --
    def lease(self, tranche: str, holder: str, *,
              capacity_bytes: float = 0.0, exclusive: bool = False,
              now: float = 0.0) -> StorageLease:
        """Attach ``holder`` to ``tranche``.

        Raises ``CompositionError`` on: unknown tranche, a double claim by
        the same holder (one job, one mount), an exclusive conflict in
        either direction, or capacity oversubscription.  Atomic: a raised
        claim leaves the pool untouched.
        """
        tr = self.tranches.get(tranche)
        if tr is None:
            raise CompositionError(
                f"unknown tranche {tranche!r}; pool has "
                f"{sorted(self.tranches)}")
        held = self._leases[tranche]
        if holder in held:
            raise CompositionError(
                f"holder {holder!r} already holds tranche {tranche!r} "
                "(storage leases don't stack)")
        if any(l.exclusive for l in held.values()):
            owner = next(h for h, l in held.items() if l.exclusive)
            raise CompositionError(
                f"tranche {tranche!r} is exclusively held by {owner!r}")
        if exclusive and held:
            raise CompositionError(
                f"exclusive claim on {tranche!r} conflicts with "
                f"{len(held)} existing lessee(s): {sorted(held)}")
        used = sum(l.capacity_bytes for l in held.values())
        if used + capacity_bytes > tr.capacity_bytes:
            raise CompositionError(
                f"tranche {tranche!r} capacity exceeded: "
                f"{(used + capacity_bytes) / 1e12:.2f} TB requested of "
                f"{tr.capacity_bytes / 1e12:.2f} TB")
        lease = StorageLease(tranche, holder, capacity_bytes, exclusive, now)
        held[holder] = lease
        return lease

    def release(self, holder: str) -> List[str]:
        """Release every tranche ``holder`` is attached to (idempotent);
        returns the tranche names freed."""
        freed = []
        for name, held in self._leases.items():
            if held.pop(holder, None) is not None:
                freed.append(name)
        return freed

    def release_tranche(self, holder: str, tranche: str) -> bool:
        """Release ``holder``'s claim on one tranche only — a live
        migrate detaches the old drawer while keeping the new lease it
        just took (``release`` would drop both).  Idempotent; returns
        whether a lease was actually dropped."""
        return self._leases[tranche].pop(holder, None) is not None

    # ------------------------------------------------------------ queries --
    def n_lessees(self, tranche: str) -> int:
        return len(self._leases[tranche])

    def lessees(self, tranche: str) -> Tuple[str, ...]:
        return tuple(self._leases[tranche])

    def tranches_of(self, holder: str) -> List[str]:
        return [name for name, held in self._leases.items()
                if holder in held]

    def capacity_used(self, tranche: str) -> float:
        return sum(l.capacity_bytes
                   for l in self._leases[tranche].values())

    def exclusively_held(self, tranche: str) -> bool:
        return any(l.exclusive for l in self._leases[tranche].values())

    def read_bw(self, tranche: str) -> float:
        """Current per-lessee read bandwidth under the live contention."""
        return self.tranches[tranche].effective_read_bw(
            self.links, max(1, self.n_lessees(tranche)))

    def write_bw(self, tranche: str) -> float:
        return self.tranches[tranche].effective_write_bw(
            self.links, max(1, self.n_lessees(tranche)))

    def by_attach(self, cls: LinkClass) -> List[StorageTranche]:
        return [t for t in self.tranches.values() if t.attach == cls]

    def check_invariants(self) -> None:
        """No holder twice on a tranche (structural), no oversubscription,
        no shared tenancy under an exclusive lease."""
        for name, held in self._leases.items():
            tr = self.tranches[name]
            used = sum(l.capacity_bytes for l in held.values())
            if used > tr.capacity_bytes:
                raise CompositionError(
                    f"tranche {name!r} oversubscribed: {used:.3g} > "
                    f"{tr.capacity_bytes:.3g}")
            if any(l.exclusive for l in held.values()) and len(held) > 1:
                raise CompositionError(
                    f"tranche {name!r} shared under an exclusive lease")

    def stats(self) -> Dict[str, Dict[str, object]]:
        return {
            name: {
                "attach": tr.attach.value,
                "n_lessees": self.n_lessees(name),
                "capacity_used_frac": (self.capacity_used(name)
                                       / max(tr.capacity_bytes, 1.0)),
                "per_lessee_read_bw": self.read_bw(name),
            }
            for name, tr in self.tranches.items()}


def make_storage_pool(n_local: int = 4, n_switch: int = 2, *,
                      domains: int = 2,
                      capacity_bytes: float = NVME_CAPACITY,
                      read_bw: float = NVME_READ_BW,
                      write_bw: float = NVME_WRITE_BW,
                      links: Optional[Dict[LinkClass, LinkSpec]] = None
                      ) -> StoragePool:
    """The production storage inventory: ``n_local`` host-local tranches
    spread round-robin over ``domains`` plus ``n_switch`` switch-attached
    (composable) tranches — mirroring ``core.topology.make_pool``."""
    tranches = [
        StorageTranche(f"local-nvme-{i}", capacity_bytes, read_bw, write_bw,
                       LinkClass.LOCAL, domain=i % max(domains, 1))
        for i in range(n_local)]
    tranches += [
        StorageTranche(f"falcon-nvme-{i}", capacity_bytes, read_bw,
                       write_bw, LinkClass.SWITCH,
                       domain=i % max(domains, 1))
        for i in range(n_switch)]
    return StoragePool(tranches, links)
