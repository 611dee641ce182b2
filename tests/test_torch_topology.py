"""Port vs reference: the composable-fabric topology, the fabrics and the
compositions (``repro_torch/core/{topology,fabrics,compose}.py`` against
``repro/core/...``), and the port's own H100 link table.

With the reference's constants fed to the port (``ref_constants`` patches
the port's module-level constants: the chip's figures and the link table),
every deterministic output must be byte-identical to the reference's:
``canon`` is ``json.dumps(..., sort_keys=True)`` of the dataclasses, with a
``LinkClass`` compared by value.  Floats come from the same arithmetic in
the same order and compare exactly.  With the port's own defaults the H100
table is pinned: its cited figures, the reference's ordering of the link
classes, and ``chip_smoke.py``'s peaks read from it.
"""
import ast
import dataclasses
import enum
import itertools
import json
import os

import pytest
import torch

from repro.core import compose as ref_compose
from repro.core import fabrics as ref_fabrics
from repro.core import topology as ref_topology

from repro_torch.cluster import (faults, lease, recomposer, scheduler,
                                 simulator, telemetry)
from repro_torch.core import (compose, costmodel, fabrics, recommend,
                               topology)
from repro_torch.core.topology import LinkClass
from repro_torch.data import pipeline, storage
from repro_torch.train import elastic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def plain(x):
    """JSON-ready form: dataclasses as dicts, enums by value, tuples as
    lists, mapping keys by value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {(k.value if isinstance(k, enum.Enum) else k): plain(v)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def canon(x) -> str:
    return json.dumps(plain(x), sort_keys=True)


REF_CHIP = ref_topology.ChipSpec()
REF_VALUES = {
    "CHIP_NAME": REF_CHIP.name, "PEAK_FLOPS_BF16": REF_CHIP.peak_flops_bf16,
    "HBM_BYTES": REF_CHIP.hbm_bytes, "HBM_BW": REF_CHIP.hbm_bw,
    "VMEM_BYTES": REF_CHIP.vmem_bytes, "ICI_BW": ref_topology.ICI_BW,
    "DEFAULT_LINKS": {
        LinkClass(c.value): topology.LinkSpec(LinkClass(c.value),
                                              l.bandwidth, l.latency)
        for c, l in ref_topology.DEFAULT_LINKS.items()}}


# every port module that prices through the chip or the link table: the
# analytics, the data plane, and the cluster plane above them
# (``test_ref_constants_reach_every_module_that_names_one`` fails when a
# module binds one of the constants by name and is missing here)
PATCHED = (topology, compose, fabrics, costmodel, recommend, storage,
           pipeline, telemetry, lease, scheduler, faults, recomposer,
           simulator, elastic)


@pytest.fixture
def ref_constants(monkeypatch):
    """The reference's chip and link table fed to every port module that
    names them (``recommend`` reads ``ICI_BW`` and ``DEFAULT_LINKS`` by
    name; the others through the dataclass defaults)."""
    for mod in PATCHED:
        for name, value in REF_VALUES.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, value)


def both(fn):
    """``fn(module)`` on the reference's module set and the port's."""
    ref = fn(ref_topology, ref_fabrics, ref_compose)
    port = fn(topology, fabrics, compose)
    return ref, port


def same(fn):
    ref, port = both(fn)
    assert canon(port) == canon(ref)
    return port


def raises_same(fn, ref_exc, port_exc):
    """Both sides raise, with the same message."""
    with pytest.raises(ref_exc) as r:
        fn(ref_topology, ref_fabrics, ref_compose)
    with pytest.raises(port_exc) as p:
        fn(topology, fabrics, compose)
    assert str(p.value) == str(r.value)


# ---------------------------------------------------------------------------
# the H100 table (the port's own defaults)
# ---------------------------------------------------------------------------
def test_h100_table_holds_the_cited_figures_in_the_reference_order():
    chip = topology.ChipSpec()
    assert chip.name == "NVIDIA H100 80GB HBM3"
    assert chip.peak_flops_bf16 == 989e12          # 1,979 sparse / 2
    assert chip.hbm_bw == 3.35e12
    assert chip.hbm_bytes == 80 * 2 ** 30          # the card: 85.02e9 < this
    assert chip.vmem_bytes == 228 * 2 ** 10        # shared memory of an SM
    links = topology.DEFAULT_LINKS
    bw = {c: links[c].bandwidth for c in LinkClass}
    assert bw == {LinkClass.LOCAL: 450e9, LinkClass.SWITCH: 64e9,
                  LinkClass.HOST: 55.0e9, LinkClass.DCN: 50e9}
    assert topology.ICI_BW == bw[LinkClass.LOCAL]
    assert bw[LinkClass.LOCAL] > bw[LinkClass.SWITCH] > bw[LinkClass.HOST] \
        > bw[LinkClass.DCN] > 0
    # the paper's Table IV latencies, measured on its chassis
    assert [links[c].latency for c in (LinkClass.LOCAL, LinkClass.SWITCH,
                                       LinkClass.HOST)] == \
        [1.85e-6, 2.08e-6, 2.66e-6]
    for c in LinkClass:
        assert links[c].cls is c


def test_no_tpu_figure_is_left_in_the_port():
    chip, ref = topology.ChipSpec(), ref_topology.ChipSpec()
    for f in dataclasses.fields(chip):
        assert getattr(chip, f.name) != getattr(ref, f.name), f.name
    for c in LinkClass:
        assert topology.DEFAULT_LINKS[c].bandwidth != \
            ref_topology.DEFAULT_LINKS[ref_topology.LinkClass(c.value)
                                       ].bandwidth, c
    # the objects that default to a chip or a link table take the H100's
    assert topology.Device(0, LinkClass.LOCAL, 0).chip == chip
    assert topology.make_pool(2, 2).links == topology.DEFAULT_LINKS
    assert compose.preset("localGPUs", data=2, model=2).chip == chip


def test_chip_smoke_reads_its_peaks_from_the_chip_spec():
    import torch
    import sys
    sys.path.insert(0, ROOT)
    import chip_smoke
    chip = topology.ChipSpec()
    assert chip_smoke.HBM_BYTES_PER_S == chip.hbm_bw
    assert chip_smoke.PEAK_FLOPS[torch.bfloat16] == chip.peak_flops_bf16
    # no literal of the two left in the script
    lits = {n.value for n in ast.walk(ast.parse(open(
        os.path.join(ROOT, "chip_smoke.py")).read()))
        if isinstance(n, ast.Constant) and isinstance(n.value, float)}
    assert not lits & {989e12, 3.35e12}


# the chip's and the link table's figures, and what they are built from
CONSTANTS = set(REF_VALUES) | {"NVLINK_BW", "PCIE_SWITCH_BW", "HOST_BW",
                               "DCN_BW", "DCN_LAT", "PAPER_LL_LAT",
                               "PAPER_FL_LAT", "PAPER_FF_LAT"}


def _binds_a_constant(src: str) -> set:
    """Constants a module binds when it is imported: module-level
    ``from ... import`` of one, and one read in a function default or a
    class-level default (not a ``default_factory``), or a ``ChipSpec()``
    there, which would be bound when the function is defined."""
    tree = ast.parse(src)
    found = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            found |= {a.asname or a.name for a in node.names} & CONSTANTS
    defaults = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            defaults += node.args.defaults + [
                d for d in node.args.kw_defaults if d is not None]
        elif isinstance(node, ast.ClassDef):
            defaults += [s.value for s in node.body
                         if isinstance(s, ast.AnnAssign) and s.value
                         is not None and not (
                             isinstance(s.value, ast.Call)
                             and getattr(s.value.func, "attr",
                                         getattr(s.value.func, "id", ""))
                             in ("field", "_const"))]
    for d in defaults:
        for n in ast.walk(d):
            name = n.id if isinstance(n, ast.Name) else \
                n.attr if isinstance(n, ast.Attribute) else None
            if name in CONSTANTS or name == "ChipSpec":
                found.add(name)
    return found


def test_ref_constants_reach_every_module_that_names_one():
    """A module that binds a chip or link constant when it is imported
    would keep the H100's figure under ``ref_constants`` unless the fixture
    patches it: every such module of the port is in ``PATCHED``, and no
    default binds one at definition.  The check itself must see a planted
    import and a planted default."""
    assert _binds_a_constant(
        "from repro_torch.core.topology import ICI_BW, LinkClass\n") == \
        {"ICI_BW"}
    assert _binds_a_constant(
        "def f(bw=topology.HBM_BW, chip=ChipSpec()):\n    pass\n") == \
        {"HBM_BW", "ChipSpec"}
    assert _binds_a_constant(
        "class A:\n    x: float = _const('HBM_BW')\n") == set()
    patched = {m.__name__ for m in PATCHED}
    pkg = os.path.join(ROOT, "src", "repro_torch")
    seen = 0
    for dirpath, _, files in os.walk(pkg):
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            mod = os.path.relpath(path, os.path.join(ROOT, "src"))[:-3] \
                .replace(os.sep, ".").removesuffix(".__init__")
            found = _binds_a_constant(open(path).read())
            seen += 1
            if mod == "repro_torch.core.topology":
                continue                     # where they are defined
            assert "ChipSpec" not in found, mod
            assert not found or mod in patched, (mod, found)
    assert seen > 50
    # the new cluster plane is patched too
    assert {"repro_torch.cluster.scheduler", "repro_torch.cluster.simulator",
            "repro_torch.train.elastic"} <= patched


# ---------------------------------------------------------------------------
# pools and link classes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_local,n_switch,pods",
                         [(256, 256, 2), (7, 5, 3), (0, 4, 1), (9, 0, 4)])
def test_make_pool_matches_reference(ref_constants, n_local, n_switch, pods):
    pool = same(lambda t, f, c: t.make_pool(n_local, n_switch, pods))
    assert len(pool.devices) == n_local + n_switch
    same(lambda t, f, c: t.make_pool(n_local, n_switch, pods).domains())


def _mixed_pool(t):
    pool = t.make_pool(3, 3, pods=2)
    pool.attach(2, t.LinkClass.SWITCH, 2)
    pool.attach(1, t.LinkClass.LOCAL, 2)
    return pool


@pytest.mark.parametrize("fed", ["reference", "h100"])
def test_link_class_between_over_a_mixed_pool(request, fed):
    """Every ordered pair: the Table IV lookup, with the reference's table
    and (the order being the reference's) with the H100's own."""
    if fed == "reference":
        request.getfixturevalue("ref_constants")
    ref, port = both(lambda t, f, c: [
        t.link_class_between(a, b)
        for a, b in itertools.product(_mixed_pool(t).devices, repeat=2)])
    assert [c.value for c in port] == [c.value for c in ref]
    assert {c.value for c in port} == {"local", "switch", "host", "dcn"}


TOPOLOGY_CASES = [("single_switch", {}), ("pcie_cascade", {}),
                  ("pcie_cascade", {"tiers": 2, "bw_taper": 0.7}),
                  ("oversubscribed_spine", {}),
                  ("oversubscribed_spine", {"oversubscription": 2.0,
                                            "leaf_ports": 4})]


@pytest.mark.parametrize("name,params", TOPOLOGY_CASES)
def test_every_topology_prices_every_pair_as_the_reference(
        ref_constants, name, params):
    def paths(t, f, c):
        topo = f.make_topology(name, **params)
        pool = _mixed_pool(t)
        pool.topology = topo
        pairs = list(itertools.product(pool.devices, repeat=2))
        return {"topology": topo, "paths": [pool.path(a, b)
                                            for a, b in pairs],
                "links": [pool.link_between(a, b) for a, b in pairs],
                "hooks": [[topo.hops(cls, span), topo.bw_scale(cls, span,
                                                               flows)]
                          for cls in t.LinkClass for span in range(4)
                          for flows in (1, 3, 16)]}
    same(paths)


def test_unknown_topology_raises_as_the_reference():
    raises_same(lambda t, f, c: f.make_topology("torus"), KeyError,
                KeyError)


def test_fabric_spec_axis_time(ref_constants):
    def spec(t, f, c):
        fs = t.FabricSpec(
            {"data": t.LinkClass.SWITCH, "model": t.LinkClass.LOCAL,
             "pod": t.LinkClass.DCN}, storage=t.SWITCH_NVME,
            axis_hops={"data": 3}, axis_bw_scale={"data": 0.5, "pod": 0.85})
        axes = ("data", "model", "pod")
        return {"spec": fs,
                "time": [fs.axis_time(a, n) for a in axes
                         for n in (0.0, 1.0, 3e6, 7.5e9)],
                "bw": [fs.bandwidth(a) for a in axes],
                "lat": [fs.latency(a) for a in axes],
                "hops": [fs.hops(a) for a in axes],
                "link": [fs.link(a) for a in axes],
                "slowest": fs.slowest(), "slowest_path": fs.slowest_path(),
                "with": fs.with_axis("model", t.LinkClass.HOST),
                "storage": fs.storage.effective_read_bw(fs.links)}
    same(spec)


def test_leases_release_and_double_claims(ref_constants):
    def pool_ops(t, f, c):
        pool = t.make_pool(4, 4, pods=2)
        pool.lease([0, 1, 5], "a")
        pool.lease([2], "b")
        pool.mark_failed([3, 6])
        snap = [pool.available(), pool.leased_by("a"), dict(pool.leases)]
        freed = pool.release_holder("a")
        pool.release([2, 2, 99])
        pool.repair([3])
        new = pool.attach(2, t.LinkClass.SWITCH, 1)
        pool.detach([0, new[0]])
        return snap + [freed, pool, pool.by_fabric(t.LinkClass.SWITCH)]
    same(pool_ops)

    def taken(t, f, c):
        pool = t.make_pool(4, 4)
        pool.lease([1, 2], "a")
        pool.lease([2, 3], "b")
    raises_same(taken, ref_topology.LeaseError, topology.LeaseError)
    raises_same(lambda t, f, c: t.make_pool(4, 4).lease([1, 1, 2], "a"),
                ref_topology.LeaseError, topology.LeaseError)


# ---------------------------------------------------------------------------
# compositions
# ---------------------------------------------------------------------------
def test_compose_recompose_shrink(ref_constants):
    def run(t, f, c):
        pool = t.make_pool(8, 8, pods=2)
        a = c.compose(pool, "a", ("data", "model"), (2, 2),
                      {"data": t.LinkClass.SWITCH,
                       "model": t.LinkClass.LOCAL})
        b = c.compose(pool, "b", ("data",), (4,),
                      {"data": t.LinkClass.SWITCH},
                      prefer_fabric=t.LinkClass.SWITCH,
                      axis_hops={"data": 2}, axis_bw_scale={"data": 0.5})
        e = c.compose(pool, "e", ("model",), (2,),
                      {"model": t.LinkClass.LOCAL}, uids=[14, 15])
        pool.mark_failed([a.device_uids[0]])
        a2 = c.recompose(pool, a, axis_links={"data": t.LinkClass.HOST,
                                              "model": t.LinkClass.LOCAL})
        pool.mark_failed(list(range(9)))
        a3 = c.shrink_to_pool(pool, a2, "data")
        c.release(pool, b)
        return [a, b, e, a2, a3, dict(pool.leases),
                [s.collective_time(ax, 1e6, k) for s in (a, b, a3)
                 for ax in s.axis_names for k in ("all-reduce",
                                                  "all-gather",
                                                  "reduce-scatter",
                                                  "all-to-all",
                                                  "collective-permute")],
                [a.n_devices, a.shape, a.axis_size("model"),
                 a.axis_bandwidth("data")]]
    same(run)


@pytest.mark.parametrize("case", ["overlap", "explicit", "too_big",
                                  "shrink", "recompose"])
def test_composition_errors_as_the_reference(ref_constants, case):
    def run(t, f, c):
        pool = t.make_pool(4, 4, pods=1)
        links = {"data": t.LinkClass.LOCAL}
        s = c.compose(pool, "a", ("data",), (4,), links)
        if case == "overlap":
            c.compose(pool, "b", ("data",), (8,), links)
        elif case == "explicit":
            c.compose(pool, "b", ("data",), (2,), links, uids=[0, 4])
        elif case == "too_big":
            c.compose(pool, "b", ("data",), (2,), links, uids=[4, 5, 6])
        elif case == "shrink":
            pool.mark_failed(list(range(8)))
            c.shrink_to_pool(pool, s, "data")
        else:
            c.compose(pool, "b", ("data",), (4,), links)
            try:
                c.recompose(pool, s, axis_sizes=(8,))
            finally:               # a failed recompose leaves the pool
                assert sorted(pool.leased_by("a")) == list(s.device_uids)
    raises_same(run, ref_compose.CompositionError, compose.CompositionError)


@pytest.mark.parametrize("label", ["localGPUs", "hybridGPUs", "falconGPUs",
                                   "localNVMe", "falconNVMe"])
def test_presets_and_collective_time(ref_constants, label):
    assert compose.PRESET_LABELS == ref_compose.PRESET_LABELS

    def run(t, f, c):
        out = []
        for pods, data, model in ((1, 4, 4), (2, 2, 4)):
            s = c.preset(label, data=data, model=model, pods=pods)
            out += [s, [s.collective_time(ax, nb, kind)
                        for ax in s.axis_names for nb in (1.0, 2.5e8)
                        for kind in ("all-reduce", "all-gather",
                                     "collective-permute")]]
        return out + [c.production_system(multi_pod=True, label=label)
                      .fabric]
    same(run)
    raises_same(lambda t, f, c: c.preset("nvlinkGPUs"), KeyError, KeyError)


def test_meshes_wait_for_the_parallel_layer():
    """``abstract_mesh()`` is the policy engine's ``{axis: size}``;
    ``mesh()`` waits for a process group (``launch/mesh``) and never starts
    one itself."""
    s = compose.preset("localGPUs", data=2, model=2)
    assert s.abstract_mesh() == {"data": 2, "model": 2}
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialised process group"):
        s.mesh(device="cpu")
    assert not torch.distributed.is_initialized()
