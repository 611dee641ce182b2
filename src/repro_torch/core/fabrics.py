"""Parameterized fabric topologies, held against ``repro/core/fabrics.py``.

The paper's thesis is that a composable system lets you evaluate
system-level topologies *before* committing to hardware.  The base
``Topology`` (``core.topology``) prices the flat single-switch chassis
the paper measures; this module adds the two wiring models its
scaling-focused successors study:

  * ``pcie_cascade`` — a k-tier switch chain (GigaIO's "Scaling to 32
    GPUs" architecture): reaching a drawer ``d`` domain ids away
    traverses ``tiers * d`` extra switch stages, each adding one hop of
    link latency and tapering bandwidth by ``bw_taper``.
  * ``oversubscribed_spine`` — a two-level leaf/spine (the passive
    optical backplane rendering): each drawer's leaf switch reaches the
    spine through an uplink provisioned at ``leaf_ports /
    oversubscription`` chip-links, so per-chip bandwidth collapses once
    concurrent cross-drawer flows share the uplink.

Path-resolution invariants (as in the reference):

  * symmetry — ``path(a, b) == path(b, a)``;
  * the link *class* is always the canonical Table IV lookup
    (``link_class_between``); topologies only add hops and derate
    bandwidth, so cross-domain traffic that leaves the composed fabric
    is never priced faster than the DCN;
  * a same-domain path is never slower than the same pair split across
    domains;
  * ``single_switch`` is bit-identical to the legacy flat lookup
    (1 hop, full speed, everywhere).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Type

from repro_torch.core.topology import (  # noqa: F401  (re-exported surface)
    SINGLE_SWITCH, AxisPath, LinkClass, Topology, link_class_between)


@dataclasses.dataclass(frozen=True)
class PCIeCascade(Topology):
    """k-tier switch cascade: drawers daisy-chained through ``tiers``
    switch stages per domain-id of distance.

    Only the switched fabrics cascade (SWITCH, and HOST paths that ride
    the switch complex); NVLink never leaves its drawer and the DCN
    is its own network, so both keep the flat 1-hop model.
    """
    name: str = "pcie_cascade"
    tiers: int = 1
    bw_taper: float = 0.85            # per extra stage

    def hops(self, cls: LinkClass, span: int) -> int:
        if span > 0 and cls in (LinkClass.SWITCH, LinkClass.HOST):
            return 1 + self.tiers * span
        return 1

    def bw_scale(self, cls: LinkClass, span: int, flows: int = 1) -> float:
        return self.bw_taper ** (self.hops(cls, span) - 1)


@dataclasses.dataclass(frozen=True)
class OversubscribedSpine(Topology):
    """Two-level leaf/spine over the composed switch fabric.

    Every cross-drawer SWITCH path is leaf -> spine -> leaf (3 hops).
    The uplink of each leaf carries ``leaf_ports / oversubscription``
    chip-links of capacity; with ``flows`` chips of one drawer crossing
    concurrently, each gets ``min(1, uplink / flows)`` of its link — the
    knee of scaling efficiency.
    """
    name: str = "oversubscribed_spine"
    oversubscription: float = 4.0
    leaf_ports: int = 8

    def hops(self, cls: LinkClass, span: int) -> int:
        if span > 0 and cls == LinkClass.SWITCH:
            return 3                  # leaf -> spine -> leaf
        return 1

    def bw_scale(self, cls: LinkClass, span: int, flows: int = 1) -> float:
        if span > 0 and cls == LinkClass.SWITCH:
            uplink = self.leaf_ports / self.oversubscription
            return min(1.0, uplink / max(1, flows))
        return 1.0


TOPOLOGIES: Dict[str, Type[Topology]] = {
    "single_switch": Topology,
    "pcie_cascade": PCIeCascade,
    "oversubscribed_spine": OversubscribedSpine,
}


def make_topology(name: str, **params) -> Topology:
    """Build a registered topology by name (``params`` override the
    model's defaults, e.g. ``make_topology("pcie_cascade", tiers=2)``)."""
    if name not in TOPOLOGIES:
        raise KeyError(
            f"unknown topology {name!r}; known: {sorted(TOPOLOGIES)}")
    return TOPOLOGIES[name](**params)
