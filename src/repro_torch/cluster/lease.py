"""Pool leasing: exclusive device claims with domain-aware placement,
held against ``repro/cluster/lease.py``.

``DevicePool`` enforces the raw invariant (no uid is leased twice);
this module adds the *placement policy* on top: which devices a job
should claim, and which link class each mesh axis consequently rides
on.  The rule mirrors how ``compose()`` lays out axes — the innermost
(model/tp) axis is kept inside a single locality clique whenever the
pool allows it, so tensor-parallel collectives ride the fast fabric
and only the data axis spans the composed switch:

  * every tp-group inside one (domain, LOCAL) clique  -> model on LOCAL
  * tp-groups intact but on switch-attached devices   -> model on SWITCH
  * data axis within one clique                       -> data on LOCAL
  * data axis spanning domains or fabrics             -> data on SWITCH

This is the paper's Table III spectrum (localGPUs / hybridGPUs /
falconGPUs) derived from *where the free devices actually are* instead
of fixed by hand.

Multi-pod **gang** placement extends the same policy over the DCN axis:
``plan_gang`` co-selects ``n_pods`` pod-sized chip cliques — each member
mesh confined to a single locality domain — choosing the set of domains
that minimizes the DCN hop span, and ``LeaseManager.acquire_gang``
claims them all-or-nothing.

Invariants (enforced here and in ``DevicePool`` / ``StoragePool``):

  * **Exclusive device claims** — a uid is never leased twice; an
    overlapping claim raises ``LeaseError`` / ``CompositionError`` and
    leaves the pool untouched (``DevicePool.lease`` is atomic).
  * **All-or-nothing gang claims** — ``acquire_gang`` claims member
    cliques one at a time but rolls back every already-claimed member
    if any later member conflicts, so a failed gang acquisition leaves
    the pool exactly as it was.
  * **Plans never mutate the pool** — ``plan_placement`` / ``plan_gang``
    / ``plan_tranche`` only read pool state; a plan that cannot be
    covered raises ``CompositionError`` without side effects.
  * **Release is symmetric** — ``LeaseManager.release(holder)`` frees
    the holder's devices *and* storage tranches in one call.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.compose import CompositionError, ComposedSystem
from repro_torch.core.topology import (AxisPath, Device, DevicePool,
                                       LeaseError, LinkClass)
from repro_torch.data.storage import StoragePool, StorageTranche

# bandwidth ordering used to pick the "worst" link a span needs
_LINK_RANK = {LinkClass.LOCAL: 0, LinkClass.SWITCH: 1, LinkClass.HOST: 2,
              LinkClass.DCN: 3}

# worst-first ordering over resolved paths: link class, then extra hops,
# then deeper bandwidth derate (all equal under the flat topology, so the
# class alone decides — the legacy rule)
_PATH_RANK = (lambda p: (_LINK_RANK[p.link], p.hops, -p.bw_scale))


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """A concrete device selection for a (dp, tp) mesh, plus the link
    class each axis must be priced on given that selection."""
    uids: Tuple[int, ...]
    axis_links: Dict[str, LinkClass]
    n_domains: int
    fabrics: Tuple[LinkClass, ...]        # distinct device fabrics used
    note: str = ""
    # hop counts / bandwidth derates the pool topology adds per axis
    axis_paths: Dict[str, AxisPath] = dataclasses.field(default_factory=dict)

    @property
    def label(self) -> str:
        return "+".join(sorted(f.value for f in set(self.fabrics)))


def _span_link(pool: DevicePool, c: Sequence[Device]) -> LinkClass:
    """Worst link a set of devices needs to talk (Table IV semantics):
    one clique -> its own fabric; mixed fabrics -> host root complex;
    same fabric across domains -> the composable switch spans drawers,
    but local ICI does not, so cross-domain LOCAL rides the DCN.  Mixed
    fabrics *across* domains traverse the host complex and the pod
    network in series: priced at the slower of the two, so a cross-pod
    span never beats the DCN."""
    fabrics = {x.fabric for x in c}
    cross_domain = len({x.domain for x in c}) > 1
    if len(fabrics) > 1:
        if cross_domain:
            return min((LinkClass.HOST, LinkClass.DCN),
                       key=lambda k: pool.links[k].bandwidth)
        return LinkClass.HOST
    f = next(iter(fabrics))
    if not cross_domain:
        return f
    return f if f == LinkClass.SWITCH else LinkClass.DCN


def _span_path(pool: DevicePool, c: Sequence[Device]) -> AxisPath:
    """``_span_link`` plus the hop count and bandwidth derate the pool's
    topology assigns that span.  ``flows`` is the worst per-drawer
    concurrency: every chip of the span's densest domain drives its
    cross-drawer link at once during a collective."""
    cls = _span_link(pool, c)
    doms = [x.domain for x in c]
    span = max(doms) - min(doms)
    flows = max(doms.count(d) for d in set(doms)) if span else 1
    topo = pool.topo
    return AxisPath(cls, topo.hops(cls, span),
                    topo.bw_scale(cls, span, flows))


def derive_axis_paths(pool: DevicePool, uids: Sequence[int], tp: int
                      ) -> Dict[str, AxisPath]:
    """Resolved path per mesh axis implied by an *actual* device
    selection: the link class (exactly ``derive_axis_links``) plus the
    hop count and bandwidth derate the pool's topology adds."""
    dev = {d.uid: d for d in pool.devices}
    chosen = [dev[u] for u in uids]
    chunks = [chosen[i:i + tp] for i in range(0, len(chosen), tp)]
    model = max((_span_path(pool, c) for c in chunks), key=_PATH_RANK)
    data = model if len(chunks) == 1 else _span_path(pool, chosen)
    return {"data": data, "model": model}


def path_maps(paths: Dict[str, AxisPath]
              ) -> Tuple[Dict[str, LinkClass], Dict[str, int],
                         Dict[str, float]]:
    """``(axis_links, axis_hops, axis_bw_scale)`` for ``FabricSpec``.
    Default entries (1 hop, full speed) are elided so a flat topology
    builds the exact legacy spec."""
    links = {a: p.link for a, p in paths.items()}
    hops = {a: p.hops for a, p in paths.items() if p.hops != 1}
    scale = {a: p.bw_scale for a, p in paths.items() if p.bw_scale != 1.0}
    return links, hops, scale


def derive_axis_links(pool: DevicePool, uids: Sequence[int], tp: int
                      ) -> Dict[str, LinkClass]:
    """Link class per mesh axis implied by an *actual* device selection.

    ``compose()`` reshapes the claim row-major, so consecutive runs of
    ``tp`` uids form the tensor-parallel groups.  Used both when planning
    a placement and after an elastic recompose, whose spare devices may
    sit on a different fabric than the original claim.
    """
    return {a: p.link
            for a, p in derive_axis_paths(pool, uids, tp).items()}


def _cliques(free: Sequence[Device]) -> List[List[Device]]:
    """Free devices grouped into locality cliques (same domain + fabric),
    LOCAL-fabric cliques first, largest first within a fabric class."""
    by_key: Dict[Tuple[int, LinkClass], List[Device]] = {}
    for d in free:
        by_key.setdefault((d.domain, d.fabric), []).append(d)
    groups = sorted(by_key.values(),
                    key=lambda g: (_LINK_RANK[g[0].fabric], -len(g),
                                   g[0].domain))
    return groups


def plan_placement(pool: DevicePool, dp: int, tp: int,
                   prefer_fabric: Optional[LinkClass] = None
                   ) -> PlacementPlan:
    """Choose ``dp*tp`` available devices and derive per-axis link classes.

    Selection is clique-major in whole tp-sized chunks: each tp-group is
    carved from a single clique while any clique has room, so the model
    axis stays on the clique's fabric; the data axis degrades to SWITCH
    as soon as the selection spans cliques.  Under a multi-tier topology
    the cliques after the first are re-ordered by hop distance from the
    anchor clique's drawer, so a spanning selection prefers the nearest
    drawers (a no-op on the flat fabric, where every cross-drawer path
    is one hop).  Raises ``CompositionError`` when the available pool
    cannot cover the request.
    """
    n = dp * tp
    free = pool.available()
    if len(free) < n:
        raise CompositionError(
            f"placement needs {n} devices; only {len(free)} available "
            f"({len(pool.healthy())} healthy, "
            f"{len(pool.leases)} leased)")
    groups = _cliques(free)
    if prefer_fabric is not None:
        groups.sort(key=lambda g: (g[0].fabric != prefer_fabric,
                                   _LINK_RANK[g[0].fabric], -len(g)))
    if len(groups) > 1:
        topo = pool.topo
        anchor = groups[0][0].domain
        groups[1:] = sorted(groups[1:], key=lambda g: (
            (g[0].fabric != prefer_fabric) if prefer_fabric is not None
            else False,
            _LINK_RANK[g[0].fabric],
            topo.hops(g[0].fabric, abs(g[0].domain - anchor)),
            -len(g), g[0].domain))

    picked: List[Device] = []
    gi = 0
    while len(picked) < n and gi < len(groups):
        g = groups[gi]
        # carve whole tp-groups out of this clique while it has room
        while len(g) >= tp and len(picked) < n:
            picked.extend(g[:tp])
            g = g[tp:]
        groups[gi] = g
        gi += 1
    if len(picked) < n:
        # remainder: tp-groups must straddle cliques (model axis degrades)
        rest = [d for g in groups for d in g]
        picked.extend(rest[:n - len(picked)])

    uids = tuple(d.uid for d in picked)
    axis_paths = derive_axis_paths(pool, uids, tp)
    domains = {d.domain for d in picked}
    fabrics = {d.fabric for d in picked}
    note = (f"{len(domains)} domain(s), "
            f"{'+'.join(sorted(f.value for f in fabrics))}")
    return PlacementPlan(uids, {a: p.link for a, p in axis_paths.items()},
                         len(domains),
                         tuple(sorted(fabrics, key=_LINK_RANK.get)), note,
                         axis_paths)


# ---------------------------------------------------------------------------
# multi-pod gang placement (the DCN axis)
# ---------------------------------------------------------------------------
def domain_counts(devices: Sequence[Device]) -> Dict[int, int]:
    """Device count per locality domain over any device iterable."""
    out: Dict[int, int] = {}
    for d in devices:
        out[d.domain] = out.get(d.domain, 0) + 1
    return out


def hosting_domains(devices: Sequence[Device], n_member: int) -> List[int]:
    """Domains (sorted) with at least ``n_member`` of ``devices`` — THE
    gang-member eligibility rule, shared by planning (``plan_gang``),
    fit-checking (``Scheduler._fits_now``), admission
    (``Scheduler._gang_impossible``), and policy preemption, so the
    four views of "can this domain host a member clique?" cannot
    desync."""
    return sorted(dom for dom, n in domain_counts(devices).items()
                  if n >= n_member)


@dataclasses.dataclass(frozen=True)
class GangPlan:
    """A co-selected placement for an ``n_pods``-member gang.

    Each member is a full ``(dp, tp)`` mesh confined to one locality
    domain; members talk to each other over the DCN ("pod") axis.
    ``uids`` concatenates the members pod-major, which is exactly the
    row-major order ``compose()`` expects for a ``(pod, data, model)``
    mesh.
    """
    members: Tuple[PlacementPlan, ...]
    domains: Tuple[int, ...]             # one locality domain per member
    axis_links: Dict[str, LinkClass]     # pod -> DCN + worst member links
    dcn_hops: int                        # domain-id span of the gang
    # topology-resolved path per axis (worst member path + the pod span)
    axis_paths: Dict[str, AxisPath] = dataclasses.field(default_factory=dict)

    @property
    def uids(self) -> Tuple[int, ...]:
        return tuple(u for m in self.members for u in m.uids)

    @property
    def n_pods(self) -> int:
        return len(self.members)


def plan_gang(pool: DevicePool, n_pods: int, dp: int, tp: int,
              prefer_fabric: Optional[LinkClass] = None) -> GangPlan:
    """Co-select ``n_pods`` pod-sized chip cliques for one gang job.

    Each member mesh (``dp * tp`` chips) is carved from a single
    locality domain with ``plan_placement``'s clique-major rule, so the
    intra-member axes ride the member's own fabric and only the gang's
    "pod" axis crosses the DCN.  The member domains are chosen to
    minimize the DCN hop span (``max(domain) - min(domain)`` over the
    eligible domains, ties to the lowest ids — deterministic), i.e. the
    gang lands on the closest set of pods that can each host a member.

    Pure planning: the pool is only read.  Raises ``CompositionError``
    when fewer than ``n_pods`` domains can host a member.
    """
    if n_pods < 2:
        raise CompositionError(f"a gang needs n_pods >= 2; got {n_pods}")
    n_member = dp * tp
    free = pool.available()
    eligible = hosting_domains(free, n_member)
    if len(eligible) < n_pods:
        raise CompositionError(
            f"gang needs {n_pods} domains with {n_member} free devices "
            f"each; only {len(eligible)} of "
            f"{len(domain_counts(free))} qualify")
    # minimal-span window over the sorted eligible domain ids: the DCN
    # hop distance between domains a and b is |a - b| (pods are laid out
    # linearly on the inter-pod network), so the contiguous window with
    # the smallest id span is the closest co-selection
    windows = [eligible[i:i + n_pods]
               for i in range(len(eligible) - n_pods + 1)]
    chosen = min(windows, key=lambda w: (w[-1] - w[0], w[0]))
    members = []
    for dom in chosen:
        sub = DevicePool(
            devices=[d for d in pool.devices if d.domain == dom],
            links=pool.links, leases=pool.leases, topology=pool.topology)
        members.append(plan_placement(sub, dp, tp, prefer_fabric))
    span = chosen[-1] - chosen[0]
    topo = pool.topo
    paths: Dict[str, AxisPath] = {
        # every member's dp*tp chips cross the pod boundary at once
        "pod": AxisPath(LinkClass.DCN, topo.hops(LinkClass.DCN, span),
                        topo.bw_scale(LinkClass.DCN, span, dp * tp))}
    for axis in ("data", "model"):
        paths[axis] = max((m.axis_paths[axis] for m in members),
                          key=_PATH_RANK)
    links = {a: p.link for a, p in paths.items()}
    return GangPlan(tuple(members), tuple(chosen), links, span, paths)


def plan_tranche(storage: StoragePool, *, capacity_bytes: float = 0.0,
                 prefer_domain: Optional[int] = None) -> StorageTranche:
    """Choose the NVMe tranche a new tenant should attach.

    Mirrors ``plan_placement``'s locality preference on the storage axis:
    an *idle* local tranche in the placement's domain first (the paper's
    localNVMe), then any idle local, then an idle switch-attached one,
    and only then the least-contended shared tranche — co-location splits
    bandwidth, so it is the placement of last resort.  Raises
    ``CompositionError`` when no tranche has the capacity headroom.
    """
    def fits(t: StorageTranche) -> bool:
        return (not storage.exclusively_held(t.name)
                and storage.capacity_used(t.name) + capacity_bytes
                <= t.capacity_bytes)

    candidates = [t for t in storage.tranches.values() if fits(t)]
    if not candidates:
        raise CompositionError(
            f"no tranche can host {capacity_bytes / 1e9:.1f} GB "
            f"({len(storage.tranches)} tranches, all full or "
            "exclusively held)")
    return min(candidates, key=lambda t: (
        storage.n_lessees(t.name),                       # idle first
        _LINK_RANK[t.attach],                            # local fabric
        t.domain != prefer_domain if prefer_domain is not None else False,
        t.name))                                         # deterministic


# ---------------------------------------------------------------------------
# lease lifecycle bookkeeping (job-facing view over DevicePool.leases)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Lease:
    lease_id: int
    holder: str
    uids: Tuple[int, ...]
    t_acquired: float


class LeaseManager:
    """Tracks the pool's active leases as first-class objects.

    ``compose()`` performs the actual claim inside the pool; the manager
    records who holds what since when, counts conflicts (claims that
    raised), and answers utilization queries for telemetry.  When built
    with a ``StoragePool``, NVMe tranches are pooled alongside devices:
    ``acquire_tranche`` attaches a holder, and ``release`` frees the
    holder's devices *and* storage in one call.
    """

    def __init__(self, pool: DevicePool,
                 storage: Optional[StoragePool] = None):
        self.pool = pool
        self.storage = storage
        self._leases: Dict[int, Lease] = {}      # lease_id -> Lease; a
        self._next_id = 0                        # holder may hold several
        self.conflicts = 0

    def _record(self, holder: str, uids: Tuple[int, ...],
                now: float) -> Lease:
        lease = Lease(self._next_id, holder, uids, now)
        self._next_id += 1
        self._leases[lease.lease_id] = lease
        return lease

    # ------------------------------------------------------------ claims --
    def adopt(self, system: ComposedSystem, now: float = 0.0) -> Lease:
        """Record a lease for a system ``compose()`` already claimed."""
        for u in system.device_uids:
            if self.pool.leases.get(u) != system.name:
                raise LeaseError(
                    f"device {u} is not leased to {system.name!r}; "
                    "adopt() requires a composed (claimed) system")
        return self._record(system.name, system.device_uids, now)

    def acquire(self, holder: str, uids: Sequence[int],
                now: float = 0.0) -> Lease:
        """Directly claim explicit uids (storage tiers, spare tranches)."""
        self.pool.lease(uids, holder)
        return self._record(holder, tuple(uids), now)

    def acquire_gang(self, holder: str, gang: GangPlan,
                     now: float = 0.0) -> Lease:
        """All-or-nothing claim of every member clique in ``gang``.

        Members are claimed one at a time (each member claim is itself
        atomic inside the pool); if any member conflicts, every member
        already claimed for this gang is released before raising, so a
        failed acquisition leaves the pool bit-identical to before the
        call.  Raises ``CompositionError`` on any conflict.
        """
        claimed: List[int] = []
        try:
            for m in gang.members:
                self.pool.lease(m.uids, holder)
                claimed.extend(m.uids)
        except LeaseError as e:
            self.pool.release(claimed)           # roll back partial claim
            self.conflicts += 1
            raise CompositionError(
                f"gang claim for {holder!r} rolled back "
                f"({len(claimed)} device(s) released): {e}") from e
        return self._record(holder, gang.uids, now)

    def acquire_tranche(self, holder: str, tranche: str, *,
                        capacity_bytes: float = 0.0,
                        now: float = 0.0):
        """Attach ``holder`` to an NVMe tranche (requires a storage pool);
        double-claims raise ``CompositionError`` inside the pool."""
        if self.storage is None:
            raise CompositionError(
                "LeaseManager has no StoragePool; cannot lease tranche "
                f"{tranche!r}")
        return self.storage.lease(tranche, holder,
                                  capacity_bytes=capacity_bytes, now=now)

    def release(self, holder: str) -> List[int]:
        self.forget(holder)
        if self.storage is not None:
            self.storage.release(holder)
        return self.pool.release_holder(holder)

    def forget(self, holder: str) -> None:
        """Drop the manager's records only — pool leases stay intact (used
        when a recompose already re-leased under the same holder)."""
        for lid in [l.lease_id for l in self._leases.values()
                    if l.holder == holder]:
            del self._leases[lid]

    # ----------------------------------------------------------- queries --
    def active(self) -> List[Lease]:
        return sorted(self._leases.values(), key=lambda l: l.lease_id)

    def holder_of(self, uid: int) -> Optional[str]:
        return self.pool.leases.get(uid)

    def n_leased(self) -> int:
        return len(self.pool.leases)

    def utilization(self) -> float:
        """Leased fraction of the healthy pool (instantaneous)."""
        healthy = len(self.pool.healthy())
        if healthy == 0:
            return 0.0
        leased_healthy = sum(1 for d in self.pool.devices
                             if d.healthy and d.uid in self.pool.leases)
        return leased_healthy / healthy

    def check_exclusive(self) -> None:
        """Invariant: every lease's uids are disjoint and pool-backed;
        the storage pool (when present) is never oversubscribed."""
        seen: Dict[int, str] = {}
        for lease in self._leases.values():
            for u in lease.uids:
                if u in seen and self.pool.leases.get(u) is not None:
                    raise LeaseError(
                        f"uid {u} held by both {seen[u]!r} and "
                        f"{lease.holder!r}")
                seen[u] = lease.holder
        if self.storage is not None:
            self.storage.check_invariants()
