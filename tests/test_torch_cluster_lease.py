"""Port vs reference: pool leasing (``repro_torch/cluster/lease.py``
against ``repro/cluster/lease.py``), the cluster package's surface, and the
cluster telemetry.

Under ``ref_constants`` the plans must be byte-identical to the
reference's (``canon``: ``json.dumps(..., sort_keys=True)`` of the
dataclasses, link classes by value): placements, gang plans and tranche
plans over seeded pools, with devices failed and leased at random, on the
flat fabric and on the multi-tier topologies of ``core.fabrics``.  Where
the reference raises, the port raises with the same message.
"""
import numpy as np
import pytest
import torch

import repro.cluster as ref_cluster
from repro.cluster import lease as ref_lease
from repro.cluster import telemetry as ref_telemetry
from repro.core import fabrics as ref_fabrics
from repro.core import topology as ref_topology
from repro.data import storage as ref_storage

import repro_torch.cluster as cluster
from repro_torch.cluster import lease, telemetry
from repro_torch.core import fabrics, topology
from repro_torch.data import storage

from test_torch_topology import canon, ref_constants  # noqa: F401

REF = (ref_lease, ref_topology, ref_fabrics, ref_storage)
PORT = (lease, topology, fabrics, storage)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port on one CPU thread, as in ``tests/test_torch_moe.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(fn):
    """``fn(lease, topology, fabrics, storage)`` on each side; a side that
    raises gives ``("raises", type name, message)``."""
    out = []
    for side in (REF, PORT):
        try:
            out.append(fn(*side))
        except Exception as e:                  # noqa: BLE001
            out.append(("raises", type(e).__name__, str(e)))
    return out


def same(fn):
    ref, port = both(fn)
    assert canon(port) == canon(ref)
    return port


# ---------------------------------------------------------------------------
# the package's surface
# ---------------------------------------------------------------------------
def test_cluster_exports_what_the_reference_exports():
    assert cluster.__all__ == ref_cluster.__all__
    for name in cluster.__all__:
        assert hasattr(cluster, name), name
    assert cluster.POLICIES == ref_cluster.POLICIES
    assert cluster.FAULT_KINDS == ref_cluster.FAULT_KINDS
    assert telemetry.EVENT_KINDS == ref_telemetry.EVENT_KINDS


# ---------------------------------------------------------------------------
# seeded pools
# ---------------------------------------------------------------------------
POOLS = [  # (n_local, n_switch, pods, topology)
    (64, 64, 2, None), (48, 16, 3, None), (0, 40, 2, None),
    (64, 64, 4, ("pcie_cascade", {"tiers": 2})),
    (96, 32, 3, ("oversubscribed_spine", {"oversubscription": 2.0})),
]


def _pool(seed, n_local, n_switch, pods, topo, lease_, topology_, fabrics_):
    """A pool with a seeded share of its devices failed and leased."""
    t = fabrics_.make_topology(*topo[:1], **topo[1]) if topo else None
    pool = topology_.make_pool(n_local, n_switch, pods, topology=t)
    rng = np.random.default_rng(seed)
    uids = [d.uid for d in pool.devices]
    perm = rng.permutation(len(uids))
    n_fail = int(rng.integers(0, len(uids) // 6 + 1))
    n_held = int(rng.integers(0, len(uids) // 3 + 1))
    pool.mark_failed([uids[i] for i in perm[:n_fail]])
    held = [uids[i] for i in perm[n_fail:n_fail + n_held]]
    for k in range(0, len(held), 7):
        pool.lease(held[k:k + 7], f"tenant-{k // 7}")
    return pool


MESHES = [(1, 1), (2, 1), (4, 2), (2, 4), (8, 1), (4, 4), (8, 8), (16, 4),
          (3, 2)]


@pytest.mark.parametrize("pool_case", range(len(POOLS)))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_placements_match_the_reference(ref_constants, pool_case, seed):
    spec = POOLS[pool_case]

    def plans(lease_, topology_, fabrics_, storage_):
        pool = _pool(seed, *spec, lease_, topology_, fabrics_)
        out = []
        for dp, tp in MESHES:
            for prefer in (None, topology_.LinkClass.LOCAL,
                           topology_.LinkClass.SWITCH):
                try:
                    p = lease_.plan_placement(pool, dp, tp, prefer)
                except Exception as e:          # noqa: BLE001
                    out.append(["raises", type(e).__name__, str(e)])
                    continue
                out.append([p, p.label,
                            lease_.derive_axis_links(pool, p.uids, tp),
                            lease_.path_maps(
                                lease_.derive_axis_paths(pool, p.uids, tp))])
        out.append(lease_.domain_counts(pool.available()))
        out.append([lease_.hosting_domains(pool.available(), n)
                    for n in (1, 8, 16, 40)])
        return out
    port = same(plans)
    assert sum(p[0] != "raises" for p in port[:-2]) >= 6


@pytest.mark.parametrize("pool_case", range(len(POOLS)))
@pytest.mark.parametrize("seed", [0, 3])
def test_gang_plans_match_the_reference(ref_constants, pool_case, seed):
    spec = POOLS[pool_case]

    def gangs(lease_, topology_, fabrics_, storage_):
        pool = _pool(seed, *spec, lease_, topology_, fabrics_)
        out = []
        for n_pods, dp, tp in [(2, 2, 2), (2, 4, 2), (3, 2, 1), (2, 8, 2),
                               (4, 1, 4), (1, 2, 2), (2, 32, 2)]:
            try:
                g = lease_.plan_gang(pool, n_pods, dp, tp)
                out.append([g, g.uids, g.n_pods])
            except Exception as e:              # noqa: BLE001
                out.append(["raises", type(e).__name__, str(e)])
        return out
    port = same(gangs)
    assert sum(p[0] != "raises" for p in port) >= 2


def _storage(storage_, seed):
    sp = storage_.make_storage_pool(4, 3, domains=3)
    rng = np.random.default_rng(seed)
    names = sorted(sp.tranches)
    for i in range(int(rng.integers(0, 9))):
        name = names[int(rng.integers(len(names)))]
        try:
            sp.lease(name, f"job-{i}", capacity_bytes=float(
                rng.uniform(0.0, 2.5e12)), exclusive=bool(rng.random() < .2))
        except Exception:                       # noqa: BLE001
            pass
    return sp


@pytest.mark.parametrize("seed", range(6))
def test_tranche_plans_match_the_reference(ref_constants, seed):
    def plans(lease_, topology_, fabrics_, storage_):
        sp = _storage(storage_, seed)
        out = [sp.stats()]
        for cap in (0.0, 5e11, 2e12, 3.9e12, 5e12):
            for dom in (None, 0, 1, 2):
                try:
                    out.append(lease_.plan_tranche(
                        sp, capacity_bytes=cap, prefer_domain=dom).name)
                except Exception as e:          # noqa: BLE001
                    out.append(["raises", type(e).__name__, str(e)])
        return out
    same(plans)


def test_lease_manager_matches_the_reference(ref_constants):
    """Claims, an all-or-nothing gang that must roll back, tranches,
    release and the queries, step by step."""
    def run(lease_, topology_, fabrics_, storage_):
        pool = topology_.make_pool(32, 32, 2)
        sp = storage_.make_storage_pool(2, 1)
        mgr = lease_.LeaseManager(pool, sp)
        out = []

        def record(x):
            out.append([x, [l for l in mgr.active()], mgr.n_leased(),
                        mgr.utilization(), dict(pool.leases)])

        def attempt(fn):
            try:
                record(fn())
            except Exception as e:              # noqa: BLE001
                record(["raises", type(e).__name__, str(e)])
        attempt(lambda: mgr.acquire("a", [0, 1, 2, 3], now=1.0))
        gang = lease_.plan_gang(pool, 2, 4, 2)
        attempt(lambda: mgr.acquire_gang("g", gang, now=2.0))
        gang2 = lease_.plan_gang(pool, 2, 2, 2)
        pool.lease([gang2.members[1].uids[0]], "intruder")
        attempt(lambda: mgr.acquire_gang("h", gang2, now=3.0))
        attempt(lambda: mgr.acquire("b", [0], now=4.0))
        attempt(lambda: mgr.acquire_tranche("a", "local-nvme-0",
                                            capacity_bytes=1e12))
        attempt(lambda: mgr.acquire_tranche("a", "local-nvme-0"))
        pool.mark_failed([5, 6])
        attempt(lambda: mgr.release("a"))
        attempt(lambda: mgr.release("g"))
        mgr.check_exclusive()
        out.append(mgr.conflicts)
        return out
    same(run)


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------
def test_telemetry_report_matches_the_reference():
    """A seeded run of events, occupancy samples and counters: the same
    report, and an unknown event kind raises on both sides."""
    def run(mod):
        rng = np.random.default_rng(5)
        tel = mod.Telemetry(64)
        tel.recompose_enabled = True
        t = 0.0
        for i in range(200):
            t += float(rng.exponential(3.0))
            kind = mod.EVENT_KINDS[int(rng.integers(len(mod.EVENT_KINDS)))]
            tel.log(t, kind, f"job-{i % 7}", f"detail {i}")
            tel.observe(t, n_leased=int(rng.integers(0, 64)),
                        busy_equiv=float(rng.uniform(0, 40)),
                        n_healthy=int(rng.integers(40, 65)))
            tel.job_waited(float(rng.exponential(10.0)),
                           ["", "blue", "green"][i % 3])
            if i % 11 == 0:
                tel.gang_started(int(rng.integers(0, 4)))
            if i % 13 == 0:
                tel.add_recomposition(float(rng.uniform(0, 2)))
            link = list(mod.LinkClass)[i % 4]
            tel.add_link_traffic(link, float(rng.uniform(0, 1e10)))
            st = tel.tranche_stats(f"nvme-{i % 3}", "local")
            st.observe(t, int(rng.integers(0, 4)))
            st.add_io(float(rng.uniform(0, 1e9)), float(rng.uniform(0, 1e8)),
                      float(rng.uniform(0, 0.1)))
            tel.recovery_s.append(float(rng.uniform(0, 30)))
        rep = tel.report()
        with pytest.raises(AssertionError):
            tel.log(t, "explode")
        return [rep, tel.events]

    assert canon(run(telemetry)) == canon(run(ref_telemetry))
