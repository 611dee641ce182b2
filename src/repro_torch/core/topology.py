"""Composable-fabric topology model, held against ``repro/core/topology.py``.

The paper's object of study is a *pool* of devices behind a switching fabric
with heterogeneous link classes (NVLink local vs PCIe-switch "falcon" links,
Table IV).  The port prices the same object on NVIDIA H100 SXM5 cards, the
paper's own class of hardware:

  * ``LOCAL``    -- NVLink 4 between the cards of one node (paper: L-L)
  * ``SWITCH``   -- a PCIe Gen5 x16 switch path, the composable drawer
                   (paper: the Falcon F-F path)
  * ``HOST``     -- card <-> host staging over the card's host link
                   (paper: F-L)
  * ``DCN``      -- the network between nodes

Pure data + arithmetic, as in the reference: the link classes, the device
pool and the ``FabricSpec`` that ``compose.py`` turns into logical meshes.
Semantics are the reference's line for line; only the constants differ.
Each is a figure of NVIDIA's "H100 Tensor Core GPU" data sheet (the SXM5
column of its specifications table), a measurement from the paper's Table
IV, or the card's own measurement by ``chip_smoke.py``'s ``composable``
phase, and says which.

The dataclass defaults read the module's constants when an object is made
(``default_factory``), not when the class is defined, so that the reference's
constants can be fed to the port by patching the module (the parity tests).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Hardware constants (one NVIDIA H100 SXM5 80GB)
# ---------------------------------------------------------------------------
CHIP_NAME = "NVIDIA H100 80GB HBM3"   # torch.cuda.get_device_name() there
# data sheet: BF16 Tensor Core 1,979 TFLOPS *with sparsity*; dense is half
PEAK_FLOPS_BF16 = 989e12          # FLOP/s per chip
HBM_BW = 3.35e12                  # bytes/s per chip (data sheet: 3.35 TB/s)
# data sheet: "80GB".  The card reports 85,017,493,504 bytes of total
# memory (``composable`` phase), more than 80e9 and less than 80 GiB
HBM_BYTES = 80 * 2 ** 30
# the counterpart of the TPU's VMEM (the software-managed on-chip scratch):
# the shared memory of one SM, 228 KiB (Hopper tuning guide).  No pricing
# reads it.
VMEM_BYTES = 228 * 2 ** 10
# NVLink 4: 900 GB/s per card, both directions together (data sheet)
NVLINK_BW = 450e9                 # bytes/s per card, per direction
ICI_BW = NVLINK_BW                # the reference's name for the LOCAL rate
# PCIe Gen5 x16: 128 GB/s, both directions together (data sheet)
PCIE_SWITCH_BW = 64e9             # bytes/s per card, per direction
# The card's own host link, measured as the paper measured its Table IV:
# pinned host->device and device->host copies of 256 MiB gave medians of
# 51.6-55.25 GB/s (``chip_smoke.py``'s ``composable`` phase and
# ``scripts/probe_variant.py card_figures``, NVIDIA H100 80GB HBM3 at
# 700 W; PERF.md section 5); the constant is the fastest median of the
# first runs, which the card beats by no more than the phase's 5 %
HOST_BW = 55.0e9                  # bytes/s per card, per direction
# Between nodes: one ConnectX-7 at 400 Gb/s per card = 50 GB/s.  The
# reference orders DCN below HOST; 50 GB/s under the measured 55 GB/s host
# link keeps that order, so ``link_class_between`` prices a cross-pod pair
# of mixed fabrics on the network, as the reference does
DCN_BW = 50e9

# Paper Table IV (GB/s bidirectional): L-L 72.37, F-L 19.64, F-F 24.47,
# measured on the paper's Falcon chassis.
PAPER_LL_BW = 72.37
PAPER_FL_BW = 19.64
PAPER_FF_BW = 24.47

SWITCH_RATIO = PAPER_FF_BW / PAPER_LL_BW       # ~0.338
HOST_RATIO = PAPER_FL_BW / PAPER_LL_BW         # ~0.271

# Paper Table IV P2P write latency (us): L-L 1.85, F-L 2.66, F-F 2.08, as
# measured on that chassis (kept: the data sheet gives no latency)
PAPER_LL_LAT = 1.85e-6
PAPER_FL_LAT = 2.66e-6
PAPER_FF_LAT = 2.08e-6
# one network hop between nodes: the reference's DCN latency, a model
# figure (neither the data sheet nor the paper gives one)
DCN_LAT = 10e-6


class LinkClass(str, enum.Enum):
    """A class of interconnect with fixed bandwidth/latency character."""
    LOCAL = "local"        # NVLink within a node     (paper: NVLink L-L)
    SWITCH = "switch"      # PCIe switch / composed   (paper: Falcon F-F)
    HOST = "host"          # card<->host staging      (paper: F-L)
    DCN = "dcn"            # network between nodes


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Bandwidth/latency of one link class (per chip, per direction)."""
    cls: LinkClass
    bandwidth: float               # bytes/s per chip on this fabric
    latency: float                 # seconds, per hop

    def time(self, nbytes: float, hops: int = 1) -> float:
        return nbytes / self.bandwidth + hops * self.latency


# Default link table: NVLink, the PCIe switch path, the card's measured host
# link and the network, each with the paper's measured latency of its class.
# The ordering LOCAL > SWITCH > HOST > DCN is the reference's.
DEFAULT_LINKS: Dict[LinkClass, LinkSpec] = {
    LinkClass.LOCAL: LinkSpec(LinkClass.LOCAL, ICI_BW, PAPER_LL_LAT),
    LinkClass.SWITCH: LinkSpec(LinkClass.SWITCH, PCIE_SWITCH_BW,
                               PAPER_FF_LAT),
    LinkClass.HOST: LinkSpec(LinkClass.HOST, HOST_BW, PAPER_FL_LAT),
    LinkClass.DCN: LinkSpec(LinkClass.DCN, DCN_BW, DCN_LAT),
}


def _const(name: str):
    """A dataclass default read from this module when an object is made."""
    return dataclasses.field(default_factory=lambda: globals()[name])


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Compute/memory character of one accelerator chip."""
    name: str = _const("CHIP_NAME")
    peak_flops_bf16: float = _const("PEAK_FLOPS_BF16")
    hbm_bytes: float = _const("HBM_BYTES")
    hbm_bw: float = _const("HBM_BW")
    vmem_bytes: float = _const("VMEM_BYTES")


def partitioned_bw(device_bw: float, link: LinkSpec,
                   n_lessees: int = 1) -> float:
    """Per-lessee storage bandwidth: the device's sustained rate, capped
    by its attach fabric, split equally across concurrent lessees.  The
    single sharing formula used by ``StorageSpec``, ``StorageTranche``
    (``data.storage``) and ``StorageModel`` (``data.pipeline``)."""
    return min(device_bw, link.bandwidth) / max(1, n_lessees)


@dataclasses.dataclass(frozen=True)
class StorageSpec:
    """A storage tier (the paper's local vs falcon-attached NVMe)."""
    name: str
    read_bw: float                 # bytes/s sustained sequential read
    attach: LinkClass              # which fabric it sits behind

    def effective_read_bw(self, links: Mapping[LinkClass, LinkSpec]) -> float:
        """Read bandwidth after the attach fabric's ceiling."""
        return partitioned_bw(self.read_bw, links[self.attach])


# NVMe constants: 4TB enterprise NVMe ~3.2 GB/s sequential read (the paper's
# Intel SSDPEDKX040T7 class device).
LOCAL_NVME = StorageSpec("local-nvme", 3.2e9, LinkClass.LOCAL)
SWITCH_NVME = StorageSpec("falcon-nvme", 3.2e9, LinkClass.SWITCH)


# ---------------------------------------------------------------------------
# Device pool (what the management plane owns)
# ---------------------------------------------------------------------------
class LeaseError(RuntimeError):
    """A device was claimed while already leased (exclusive-claim violation)."""


@dataclasses.dataclass(frozen=True)
class Device:
    """One poolable accelerator.

    ``fabric``: which link class connects it to its neighbours in the same
    domain.  ``domain``: failure/locality domain id (a "drawer" / pod slice);
    devices in the same domain talk over ``fabric``; devices in different
    domains talk over the slower of the two fabrics (or DCN across pods).
    """
    uid: int
    fabric: LinkClass
    domain: int
    healthy: bool = True
    chip: ChipSpec = dataclasses.field(default_factory=ChipSpec)


# ---------------------------------------------------------------------------
# Topology: how the link classes are physically wired
# ---------------------------------------------------------------------------
def link_class_between(a: Device, b: Device,
                       links: Optional[Mapping[LinkClass, LinkSpec]] = None
                       ) -> LinkClass:
    """Canonical Table IV link-class lookup for one device pair.

    Same domain + same fabric rides the fabric itself; mixed fabrics
    within a domain cross the host root complex (F-L).  The composable
    switch physically spans drawers, so cross-domain SWITCH stays on the
    switch fabric; NVLink does not span drawers, so cross-domain
    LOCAL rides the DCN.  A pair that crosses *both* the host complex
    and the pod boundary traverses the two paths in series and is priced
    at the slower of HOST and DCN — cross-domain traffic that leaves the
    composed fabric can never be priced faster than the inter-pod
    network.
    """
    tbl = links if links is not None else DEFAULT_LINKS
    if a.domain == b.domain:
        return a.fabric if a.fabric == b.fabric else LinkClass.HOST
    if a.fabric != b.fabric:
        return min((LinkClass.HOST, LinkClass.DCN),
                   key=lambda c: tbl[c].bandwidth)
    return a.fabric if a.fabric == LinkClass.SWITCH else LinkClass.DCN


@dataclasses.dataclass(frozen=True)
class Topology:
    """How the pool's link classes are physically wired.

    The base class *is* the flat ``single_switch`` fabric this model has
    always priced: every path is one traversal of the link class the
    Table IV lookup assigns, at that link's full bandwidth.  Subclasses
    (``core.fabrics``) override the two wiring hooks to model
    multi-tier fabrics:

      * ``hops(cls, span)``      — switch traversals for a path whose
        endpoints are ``span`` domain ids apart (0 = same drawer);
        pricing charges ``(hops - 1)`` *extra* hops of link latency so a
        1-hop path is exactly the legacy cost.
      * ``bw_scale(cls, span, flows)`` — bandwidth derate (<= 1.0) for
        that path when ``flows`` chips in one drawer drive it
        concurrently (oversubscribed uplinks, cascade taper).
    """
    name: str = "single_switch"

    # ------------------------------------------------- wiring hooks ------
    def hops(self, cls: LinkClass, span: int) -> int:
        return 1

    def bw_scale(self, cls: LinkClass, span: int, flows: int = 1) -> float:
        return 1.0

    # ---------------------------------------------- path resolution ------
    @staticmethod
    def effective(link: LinkSpec, scale: float) -> LinkSpec:
        """``link`` derated to ``scale`` of its bandwidth (1.0 = as-is)."""
        if scale >= 1.0:
            return link
        return dataclasses.replace(link, bandwidth=link.bandwidth * scale)

    def path(self, links: Mapping[LinkClass, LinkSpec], a: Device,
             b: Device) -> Tuple[LinkSpec, int]:
        """Effective ``(link, hops)`` for traffic a<->b; feed the hop
        count to ``LinkSpec.time(nbytes, hops)``."""
        cls = link_class_between(a, b, links)
        span = abs(a.domain - b.domain)
        link = self.effective(links[cls], self.bw_scale(cls, span))
        return link, self.hops(cls, span)


SINGLE_SWITCH = Topology()


@dataclasses.dataclass
class DevicePool:
    """The pool of composable devices + storage (the chassis inventory).

    The pool is mutable: devices can fail (``mark_failed``), be repaired,
    attached or detached — ``compose.py`` snapshots the healthy set when
    building a ``ComposedSystem``.

    Leases make composition *exclusive*: ``compose()`` claims its devices
    under the composition's name, so two concurrent systems can never hold
    the same chip (the control plane's invariant).
    ``leases`` maps device uid -> holder name.
    """
    devices: List[Device]
    storage: List[StorageSpec] = dataclasses.field(
        default_factory=lambda: [LOCAL_NVME, SWITCH_NVME])
    links: Dict[LinkClass, LinkSpec] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_LINKS))
    leases: Dict[int, str] = dataclasses.field(default_factory=dict)
    # how the link classes are wired (None = the flat single-switch model)
    topology: Optional[Topology] = None

    @property
    def topo(self) -> Topology:
        return self.topology if self.topology is not None else SINGLE_SWITCH

    # ------------------------------------------------------------- query --
    def healthy(self) -> List[Device]:
        return [d for d in self.devices if d.healthy]

    def available(self) -> List[Device]:
        """Healthy devices not claimed by any lease (composable right now)."""
        return [d for d in self.devices
                if d.healthy and d.uid not in self.leases]

    # ------------------------------------------------------------- lease --
    def lease(self, uids: Sequence[int], holder: str) -> None:
        """Exclusively claim ``uids`` for ``holder``.

        Atomic: either every uid is claimed or none is.  A uid already held
        (by anyone, including ``holder`` itself — leases don't stack) raises
        ``LeaseError``, as does a duplicated uid within the claim (one chip
        cannot back two mesh slots).
        """
        if len(set(uids)) != len(uids):
            dups = sorted({u for u in uids if list(uids).count(u) > 1})
            raise LeaseError(
                f"holder {holder!r} claims duplicate uid(s) {dups[:8]}")
        taken = [u for u in uids if u in self.leases]
        if taken:
            owners = sorted({self.leases[u] for u in taken})
            raise LeaseError(
                f"{len(taken)} device(s) already leased (by {owners}); "
                f"holder {holder!r} cannot claim {sorted(taken)[:8]}...")
        for u in uids:
            self.leases[u] = holder

    def release(self, uids: Sequence[int]) -> None:
        """Release leases on ``uids`` (idempotent)."""
        for u in uids:
            self.leases.pop(u, None)

    def release_holder(self, holder: str) -> List[int]:
        """Release every lease held by ``holder``; returns the freed uids."""
        freed = [u for u, h in self.leases.items() if h == holder]
        for u in freed:
            del self.leases[u]
        return freed

    def leased_by(self, holder: str) -> List[int]:
        return [u for u, h in self.leases.items() if h == holder]

    def by_fabric(self, cls: LinkClass) -> List[Device]:
        return [d for d in self.healthy() if d.fabric == cls]

    def domains(self) -> Dict[int, List[Device]]:
        out: Dict[int, List[Device]] = {}
        for d in self.healthy():
            out.setdefault(d.domain, []).append(d)
        return out

    # ----------------------------------------------------------- mutate ---
    def mark_failed(self, uids: Sequence[int]) -> None:
        bad = set(uids)
        self.devices = [
            dataclasses.replace(d, healthy=False) if d.uid in bad else d
            for d in self.devices]

    def repair(self, uids: Sequence[int]) -> None:
        good = set(uids)
        self.devices = [
            dataclasses.replace(d, healthy=True) if d.uid in good else d
            for d in self.devices]

    def attach(self, n: int, fabric: LinkClass, domain: int) -> List[int]:
        """Hot-add ``n`` devices on ``fabric`` (paper: attach resource)."""
        start = max((d.uid for d in self.devices), default=-1) + 1
        new = [Device(start + i, fabric, domain) for i in range(n)]
        self.devices.extend(new)
        return [d.uid for d in new]

    def detach(self, uids: Sequence[int]) -> None:
        drop = set(uids)
        self.devices = [d for d in self.devices if d.uid not in drop]
        for u in drop:
            self.leases.pop(u, None)

    # ------------------------------------------------------------ fabric --
    def path(self, a: Device, b: Device) -> Tuple[LinkSpec, int]:
        """Effective ``(link, hops)`` for traffic a<->b under the pool's
        topology — the hop-count-aware form of ``link_between``."""
        return self.topo.path(self.links, a, b)

    def link_between(self, a: Device, b: Device) -> LinkSpec:
        """Effective link for traffic a<->b (the Table IV lookup)."""
        return self.path(a, b)[0]


def _split_across(n: int, pods: int) -> List[int]:
    """``n`` devices over ``pods`` domains, remainder on the leading pods
    (so every device the caller asked for is actually built)."""
    base, extra = divmod(n, pods)
    return [base + (1 if p < extra else 0) for p in range(pods)]


def make_pool(n_local: int = 256, n_switch: int = 256,
              pods: int = 2,
              topology: Optional[Topology] = None) -> DevicePool:
    """Build the production pool: ``pods`` domains of local-fabric chips plus
    an equal tranche of switch-attached (composable) chips.

    The single-pod production mesh (16x16=256) draws from one local domain;
    the multi-pod mesh (2x16x16=512) spans two domains over the DCN/pod axis
    -- "host + falcon drawers" as domains.  Counts that do not divide over
    ``pods`` spread the remainder across the leading pods.
    """
    devs: List[Device] = []
    uid = itertools.count()
    for p, cnt in enumerate(_split_across(n_local, pods)):
        devs += [Device(next(uid), LinkClass.LOCAL, p) for _ in range(cnt)]
    for p, cnt in enumerate(_split_across(n_switch, pods)):
        devs += [Device(next(uid), LinkClass.SWITCH, p) for _ in range(cnt)]
    assert len(devs) == n_local + n_switch, \
        f"pool built {len(devs)} devices; requested {n_local + n_switch}"
    return DevicePool(devs, topology=topology)


# ---------------------------------------------------------------------------
# FabricSpec: the axis -> link-class map of a composed mesh
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AxisPath:
    """Resolved path for one mesh axis: the link class it rides, the
    switch traversals one message crosses, and the bandwidth derate the
    pool's topology imposes on that span (1.0 = full link speed)."""
    link: LinkClass
    hops: int = 1
    bw_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    """Which link class each logical mesh axis rides on.

    This is the heart of the paper's experiment: the *same* program priced
    on different fabrics.  ``axis_links["data"] = LinkClass.SWITCH`` is the
    falconGPUs configuration; ``LOCAL`` everywhere is localGPUs.

    ``axis_hops``/``axis_bw_scale`` carry the pool topology's path
    resolution (``core.fabrics``): axes absent from either map ride
    one full-speed hop, so a spec built without them prices exactly the
    flat single-switch fabric.
    """
    axis_links: Mapping[str, LinkClass]
    links: Mapping[LinkClass, LinkSpec] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_LINKS))
    storage: StorageSpec = LOCAL_NVME
    axis_hops: Mapping[str, int] = dataclasses.field(default_factory=dict)
    axis_bw_scale: Mapping[str, float] = dataclasses.field(
        default_factory=dict)

    def bandwidth(self, axis: str) -> float:
        return (self.links[self.axis_links[axis]].bandwidth
                * self.axis_bw_scale.get(axis, 1.0))

    def latency(self, axis: str) -> float:
        return self.links[self.axis_links[axis]].latency

    def hops(self, axis: str) -> int:
        return self.axis_hops.get(axis, 1)

    def link(self, axis: str) -> LinkSpec:
        return Topology.effective(self.links[self.axis_links[axis]],
                                  self.axis_bw_scale.get(axis, 1.0))

    def axis_time(self, axis: str, nbytes: float) -> float:
        """Wire time for ``nbytes`` on ``axis``: derated bandwidth plus
        one link latency per hop *beyond the first*, so a 1-hop
        full-speed axis prices exactly ``nbytes / bandwidth``."""
        return (nbytes / self.bandwidth(axis)
                + (self.hops(axis) - 1) * self.latency(axis))

    def with_axis(self, axis: str, cls: LinkClass) -> "FabricSpec":
        m = dict(self.axis_links)
        m[axis] = cls
        return dataclasses.replace(self, axis_links=m)

    def slowest(self) -> LinkSpec:
        return min((self.link(a) for a in self.axis_links),
                   key=lambda l: l.bandwidth)

    def slowest_path(self) -> Tuple[LinkSpec, int]:
        """Worst axis's effective ``(link, hops)`` — the conservative
        price for traffic not attributed to a specific axis."""
        axis = min(self.axis_links, key=lambda a: self.bandwidth(a))
        return self.link(axis), self.hops(axis)
